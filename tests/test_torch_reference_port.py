"""The port's loader of the reference's PyTorch VQ-VAE state dicts
(``utils/torch_port.py``) against the JAX package's.

No reference checkpoint is in the repository, so the state dict is made
from a numpy seed under the reference's names, with the shapes the JAX
package's loader expects: each name and shape comes from the JAX model's
variables through the inverse of its ``port_conv2d`` /
``port_conv_transpose2d``. The JAX loader followed by the port's
``from_flax_params`` must give the port's direct load tensor for tensor,
exactly. Codes of an encode are compared where the two best scores differ
by more than 1e-4; reconstructions within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu.utils import torch_port as jport
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram import (
    get_spectrograms_helper)
from interactive_spectrogram_inpainting_tpu_torch.utils import torch_port
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)
from tests.test_torch_encode import (assert_codes_equal_above_margin,
                                     harmonic_note, lookup_inputs_port)

WIDTH = dict(in_channel=2, num_hidden_channels=16, n_res_block=2,
             num_residual_channels=8, embed_dim=8, num_embeddings=32)
FACTORS = ((4, 2), (16, 2))  # (bottom, top)


class Recording(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_state_dict(bottom, top, seed):
    """(JAX config, JAX model, skeleton, a seeded state dict under the
    reference's names). The skeleton is zeros of the JAX variables' shapes:
    the JAX loader replaces every leaf."""
    factors = {"bottom": bottom, "top": top}
    config = jv.VQVAEConfig(resolution_factors=factors, **WIDTH)
    model = jv.VQVAE(config)
    f = config.total_resolution_factor
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 2, 2 * f, f), jnp.float32))
    skeleton = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = skeleton["params"]
    rng = np.random.default_rng(seed)

    def node(path):
        out = params
        for part in path.split("/"):
            out = out[part]
        return out

    sd = {}

    def conv(ref, path, transpose=False):
        kh, kw, i, o = node(path)["kernel"].shape
        shape = (i, o, kh, kw) if transpose else (o, i, kh, kw)
        scale = 1.0 / np.sqrt(i * kh * kw)
        sd[f"{ref}.weight"] = rng.normal(0.0, scale, shape).astype(np.float32)
        sd[f"{ref}.bias"] = rng.normal(0.0, 0.1, o).astype(np.float32)

    n_b = jport._n_down(bottom)
    n_t = jport._n_down(top)
    for module, maps in (
            ("enc_b", jport._encoder_map(n_b, config.n_res_block)),
            ("enc_t", jport._encoder_map(n_t, config.n_res_block)),
            ("dec_t", jport._decoder_map(n_t, config.n_res_block)),
            ("dec", jport._decoder_map(n_b, config.n_res_block))):
        for ref, path, kind in maps:
            conv(f"{module}.{ref}", f"{module}/{path}", kind == "convT")
    conv("quantize_conv_t", "quantize_conv_t")
    conv("quantize_conv_b", "quantize_conv_b")
    for i in range(n_t):
        conv(f"upsample_top_to_bottom.{i}",
             f"upsample_top_to_bottom/ConvTranspose_{i}", transpose=True)
    for level in ("quantize_t", "quantize_b"):
        dim, n_embed = skeleton["codebook"][level]["embed"].shape
        embed = rng.normal(0.0, 1.0, (dim, n_embed)).astype(np.float32)
        sd[f"{level}.embed"] = embed
        sd[f"{level}.cluster_size"] = rng.uniform(
            0.0, 4.0, n_embed).astype(np.float32)
        sd[f"{level}.embed_avg"] = (embed * rng.uniform(
            0.5, 2.0, n_embed)).astype(np.float32)
    return config, model, skeleton, sd


def port_model(config, sd):
    tconfig = tv.VQVAEConfig.from_json(config.to_json())
    model = tv.VQVAE(tconfig)
    model.load_state_dict(torch_port.port_vqvae_state_dict(sd, tconfig),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("factors", FACTORS, ids=["4-2", "16-2"])
def test_port_equals_jax_loader_then_from_flax_params(factors):
    config, _, skeleton, sd = reference_state_dict(*factors, seed=1)
    jax_sd = Recording(sd)
    via_jax = from_flax_params(to_numpy(
        jport.port_vqvae_state_dict(jax_sd, skeleton, config)))
    port_sd = Recording(sd)
    tconfig = tv.VQVAEConfig.from_json(config.to_json())
    direct = torch_port.port_vqvae_state_dict(port_sd, tconfig)
    assert port_sd.read == set(sd), "a reference key was not read"
    assert jax_sd.read == set(sd)
    assert set(direct) == set(via_jax) == set(tv.VQVAE(tconfig).state_dict())
    for key, value in via_jax.items():
        assert direct[key].dtype == torch.float32
        assert torch.equal(direct[key], value), key
    # torch tensors load like numpy arrays
    as_torch = torch_port.port_vqvae_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tconfig)
    assert all(torch.equal(as_torch[k], direct[k]) for k in direct)
    assert len(torch_port.reference_names(tconfig)) == len(sd)


@pytest.mark.parametrize("factors", FACTORS, ids=["4-2", "16-2"])
def test_ported_models_encode_and_decode_alike(factors):
    config, jmodel, skeleton, sd = reference_state_dict(*factors, seed=1)
    variables = jport.port_vqvae_state_dict(sd, skeleton, config)
    tmodel = port_model(config, sd)
    f = config.total_resolution_factor
    helper = get_spectrograms_helper(fs_hz=16000, n_fft=256,
                                     window_length=256, hop_length=64)
    rng = np.random.default_rng(f)
    # 8 x f frames of a note over a noise floor (every band above it)
    audio = np.stack([harmonic_note(rng, helper.num_samples(8 * f))
                      for _ in range(2)])
    spec = helper.to_spectrogram(torch.from_numpy(audio))[..., :8 * f]
    x = spec.numpy()
    with torch.no_grad():
        out = tmodel.encode(spec)
        dec = tmodel.decode_code(out[3], out[4])

    def jax_pass(m, inp):
        encoded = m.encode(inp)
        return encoded, m.decode_code(encoded[3], encoded[4])

    ref, dec_j = jax.jit(functools.partial(jmodel.apply, method=jax_pass))(
        variables, jnp.asarray(x))
    qt_in, qb_in = lookup_inputs_port(tmodel, x)
    assert assert_codes_equal_above_margin(
        "top", out[3], ref[3], qt_in, tmodel.quantize_t.embed)
    assert assert_codes_equal_above_margin(
        "bottom", out[4], ref[4], qb_in, tmodel.quantize_b.embed)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=1e-5)


def test_missing_unused_keys_and_resnet_raise():
    config, _, _, sd = reference_state_dict(*FACTORS[0], seed=1)
    tconfig = tv.VQVAEConfig.from_json(config.to_json())
    missing = dict(sd)
    del missing["dec.blocks.4.weight"]
    with pytest.raises(KeyError, match=r"dec\.blocks\.4\.weight"):
        torch_port.port_vqvae_state_dict(missing, tconfig)
    extra = dict(sd, **{"output_activation.weight": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match=r"output_activation\.weight"):
        torch_port.port_vqvae_state_dict(extra, tconfig)
    resnet = tv.VQVAEConfig.from_json(dict(tconfig.__dict__, use_resnet=True))
    with pytest.raises(ValueError, match="ResNet"):
        torch_port.port_vqvae_state_dict(sd, resnet)
