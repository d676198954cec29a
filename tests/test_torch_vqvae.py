"""PyTorch port vs the JAX package: VQ-VAE decode and mel/linear playback.

Weights come from the JAX variables through ``from_flax_params``. The
decoded spectrogram is held to atol 1e-4; audio to 1e-4 of its peak (the
scale-relative form ``tests/test_spectrogram.py`` uses for the fused mel
inverse)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu.signal import (
    spectrogram as jspec)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)


def port_vqvae(cfg, variables):
    model = tv.VQVAE(tv.VQVAEConfig.from_json(cfg.to_json()))
    model.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, variables)))
    return model.eval()


# the tiny server state's VQ-VAE is held by tests/test_torch_server.py
VARIANTS = {
    "local_grouped_normalized": dict(
        num_hidden_channels=16, num_residual_channels=8, embed_dim=8,
        num_embeddings=[32, 16], groups=2, use_local_kernels=True,
        resolution_factors={"bottom": 8, "top": 4},
        normalizer_statistics={"min_logmag": -12.0, "max_logmag": 3.0,
                               "min_IF": -1.0, "max_IF": 1.0},
        output_spectrogram_min_magnitude=0.5),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_code_matches_jax(variant):
    cfg = jv.VQVAEConfig(**VARIANTS[variant])
    model = jv.VQVAE(cfg)
    f = cfg.total_resolution_factor
    probe = jnp.zeros((1, 2, 2 * f, 2 * f), jnp.float32)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, probe)
    tm = port_vqvae(cfg, variables)
    shapes = cfg.codemap_shapes((4 * f, 2 * f))
    rng = np.random.default_rng(1)
    code_t = rng.integers(0, cfg.n_embed_t, (2,) + shapes["top"])
    code_b = rng.integers(0, cfg.n_embed_b, (2,) + shapes["bottom"])
    ref = np.asarray(jax.jit(functools.partial(
        model.apply, method=jv.VQVAE.decode_code))(
            variables, jnp.asarray(code_t), jnp.asarray(code_b)))
    with torch.no_grad():
        out = tm.decode_code(torch.as_tensor(code_t),
                             torch.as_tensor(code_b)).numpy()
    assert out.shape == ref.shape == (2, 2, 4 * f, 2 * f)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kwargs", [
    dict(fs_hz=16000, n_fft=256, window_length=256, hop_length=64),
    dict(fs_hz=16000, n_fft=256, window_length=192, hop_length=64),
    dict(fs_hz=16000, n_fft=2048, window_length=2048, hop_length=512,
         use_mel_scale=True),
])
def test_to_audio_matches_jax(kwargs):
    jh = jspec.get_spectrograms_helper(**kwargs)
    th = tspec.get_spectrograms_helper(**kwargs)
    assert type(jh).__name__ == type(th).__name__
    rng = np.random.default_rng(2)
    frames = 128 if kwargs["n_fft"] == 2048 else 32
    spec = np.stack([rng.normal(-3.0, 1.0, (jh.num_freq_bins, frames)),
                     rng.uniform(-1.0, 1.0, (jh.num_freq_bins, frames))]
                    )[None].astype(np.float32)
    ref = np.asarray(jh.to_audio(jnp.asarray(spec)))
    out = th.to_audio(torch.as_tensor(spec)).numpy()
    assert out.shape == ref.shape == (1, jh.num_samples(frames))
    np.testing.assert_allclose(out, ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    if hasattr(jh, "_matrices"):
        for a, b in zip(jh._matrices(), th._matrices()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
