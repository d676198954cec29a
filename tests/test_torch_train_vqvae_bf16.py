"""PyTorch port vs the JAX package: one bfloat16 VQ-VAE train step.

Under ``--bf16`` the JAX step casts the float32 parameters and the input
spectrogram to bfloat16, and flax computes each layer in the promoted
dtype of its input and parameters: bfloat16 where both are bfloat16,
float32 on the bfloat16-rounded parameters where a float32 tensor reaches
the layer. The normalizer's float32 constants promote the input, so with
``--input_normalization`` (the flagship's) every layer computes in
float32; without it the encoder half runs in bfloat16 and the float32
codebooks promote the decoder half. The port's step
(``bfloat16_parameters(model, promote=True)``) follows the same flow.

The model, the notes and the JAX step are those of
``test_torch_train_vqvae.py`` (mse criterion, batch 2). Tolerances: where
every layer computes in float32 the loss and metrics 1e-5 relative and
the gradients (bfloat16 values in both packages) atol 2e-4 / rtol 8e-3,
one bfloat16 rounding step. Where the encoder half computes in bfloat16
the two packages' bfloat16 convolutions round their sums differently:
metrics 4e-3 relative (one bfloat16 rounding), the gradients of the
layers that compute in bfloat16 (``enc_b``, ``enc_t``,
``quantize_conv_t``) 1e-1 x their own largest |grad| (their biases' sums
of bfloat16 terms are measured 6.2 % apart at most), every other layer
as above, the EMA buffers (fed by bfloat16 encoder outputs) atol 2e-3 /
rtol 4e-3.
"""

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.train import losses as jl
from interactive_spectrogram_inpainting_tpu_torch.train import losses as tl
from interactive_spectrogram_inpainting_tpu_torch.train.train_prior import (
    bfloat16_parameters)
from tests.test_torch_train_vqvae import (assert_codes_clear,
                                          assert_step_equal, helpers,
                                          jax_step, model_pair, notes,
                                          port_step)

STATS = {"min_logmag": -14.0, "max_logmag": 3.0, "min_IF": -1.0,
         "max_IF": 1.0}
BF16_LAYERS = ("['enc_b']", "['enc_t']", "['quantize_conv_t']")


@pytest.mark.parametrize("normalized", [True, False])
def test_bf16_step_equals_jax(normalized):
    _, thelper = helpers()
    jmodel, variables, tmodel = model_pair(
        normalizer_statistics=STATS if normalized else None)
    audio = notes(5)
    spec = thelper.to_spectrogram(torch.as_tensor(audio)).to(torch.bfloat16)
    with bfloat16_parameters(tmodel, promote=True):
        assert_codes_clear(tmodel, spec)
    p_j, c_j, g_j, m_j = jax_step(jmodel, variables, jl.mse_loss, audio,
                                  bf16=True)
    model, m_t = port_step(tmodel, tl.mse_loss, audio, bf16=True)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=1e-5 if normalized else 4e-3,
                                   atol=1e-6, err_msg=k)

    def grad_tol(key, g):
        if not normalized and key.startswith(BF16_LAYERS):
            return 1e-1 * float(np.abs(g).max()), 0.0
        return 2e-4, 8e-3
    assert_step_equal(model, p_j, g_j, grad_tol)
    atol, rtol = (1e-5, 1e-5) if normalized else (2e-3, 4e-3)
    for level in ("quantize_t", "quantize_b"):
        np.testing.assert_array_equal(
            getattr(model, level).cluster_size.numpy(),
            np.asarray(c_j[level]["cluster_size"]))
        for buf in ("embed", "embed_avg"):
            np.testing.assert_allclose(
                getattr(model, level).__getattr__(buf).numpy(),
                np.asarray(c_j[level][buf]), atol=atol, rtol=rtol,
                err_msg=f"{level}.{buf}")
