"""PyTorch port vs the JAX package: the ResNet variant of the VQ-VAE.

``get_xresnet_unet``'s encoders and decoders, ``pixel_shuffle`` and a whole
ResNet VQ-VAE (factors top 2 / bottom 16, two layers per stage, the narrow
widths of ``test_torch_train_vqvae.py``) against the JAX package in float32
(atol 1e-5; codes exact), its weights both ways through
``from_flax_params`` / ``to_flax_params``, and one training step."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train_vqvae import (leaves, model_pair, notes,
                                          port_step, to_numpy)
from interactive_spectrogram_inpainting_tpu.models.vqvae import (
    resnet as jres)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    resnet as tres)
from interactive_spectrogram_inpainting_tpu_torch.train import losses as tl
from interactive_spectrogram_inpainting_tpu_torch.utils import weights


def test_resnet_encoders_and_decoders_equal_jax():
    rng = np.random.default_rng(2)
    factors = {"top": 2, "bottom": 4}  # bottom 16: the whole model below
    j_enc, j_dec = jres.get_xresnet_unet(2, factors, 16, 8, 2, 1)
    t_enc, t_dec = tres.get_xresnet_unet(2, factors, 16, 8, 2, 1)
    shapes = {"enc_bottom": (2, 2, 8, 12), "enc_top": (2, 16, 4, 6),
              "dec_top": (2, 8, 3, 2), "dec_bottom": (2, 16, 3, 2)}
    for kind, jmods, tmods in (("enc", j_enc, t_enc), ("dec", j_dec, t_dec)):
        for level in ("top", "bottom"):
            x = rng.standard_normal(shapes[f"{kind}_{level}"]).astype(
                np.float32)
            xh = jnp.asarray(x.transpose(0, 2, 3, 1))
            ref, variables = jax.jit(jmods[level].init_with_output)(
                jax.random.PRNGKey(1), xh)
            ref = np.asarray(ref).transpose(0, 3, 1, 2)
            sd = {}
            (weights._resnet_encoder_state_dict if kind == "enc"
             else weights._resnet_decoder_state_dict)(
                sd, "m", to_numpy(variables["params"]))
            module = tmods[level]
            module.load_state_dict({k[2:]: v for k, v in sd.items()})
            with torch.no_grad():
                out = module(torch.as_tensor(x)).numpy()
            assert out.shape == ref.shape, (kind, level)
            np.testing.assert_allclose(out, ref, atol=1e-5,
                                       err_msg=f"{kind} {level}")
    x = rng.standard_normal((2, 12, 3, 5)).astype(np.float32)
    want = np.asarray(jres.pixel_shuffle(jnp.asarray(
        x.transpose(0, 2, 3, 1)), 2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(
        tres.pixel_shuffle(torch.as_tensor(x), 2).numpy(), want)


def test_resnet_vqvae_forward_and_weights_round_trip():
    jmodel, variables, tmodel = model_pair(
        use_resnet=True, resnet_layers_per_downsampling_block=2,
        resolution_factors={"top": 2, "bottom": 16})
    x = np.random.default_rng(9).normal(
        -2.0, 1.0, (2, 2, 64, 32)).astype(np.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel.eval()(torch.as_tensor(x))
    for i, name in enumerate(("dec", "diff", "perp_t", "perp_b")):
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(ref[i]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for i in (4, 5):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    back = weights.to_flax_params(tmodel)
    want = leaves(to_numpy(variables))
    got = leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # one train step of the variant
    model, metrics = port_step(tmodel.train(), tl.mse_loss,
                               notes(12, batch=1))
    assert np.isfinite(float(metrics["vqvae_loss"]))
    assert not torch.equal(model.enc_b.blocks[0].conv1.weight,
                           tmodel.enc_b.blocks[0].conv1.weight)
    assert model.enc_b.blocks[0].norm1.weight.grad is not None
