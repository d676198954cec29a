"""The spectral-loss kernel's FFT route, held on the CPU through its oracle.

``reference_scale_loss_fft`` / ``reference_scale_loss_fft_backward`` take the
FFT route's steps in ``torch.fft`` (pred and target packed as one complex
signal, the two spectra split apart, the sine's sign flipped; the backward
an inverse real FFT of U with DC and Nyquist doubled, then the overlap-add).
They are held against the DFT plain version, which stays the CPU path and
the oracle of the JAX parity tests, at every Jukebox and DDSP scale
(Jukebox's windows are shorter than n_fft), and against the JAX package's
own ``jnp.fft.rfft`` path (``ISI_FFT_DFT=0``). The float64 evaluation
``reference_scale_loss_float64`` is held to the plain version's
conventions, and the packing is shown to cost no accuracy against it.

Tolerances: rows rtol 1e-5 (the float32 rounding of two algorithms, ~1e-7,
and the L1 terms' bins where the two magnitudes are nearly equal); U within
one bfloat16 step of the larger of the two values, plus 1e-5 x max|U| for
the values set by a difference of nearly equal magnitudes (the squared
distance's factor) and for the Nyquist bin's imaginary part (a 1e-16
sine in the DFT basis, exactly 0 in the FFT); the backward of one U atol
1e-5 x max. Against the JAX package the multiscale loss is held at the
tolerances ``tests/test_torch_spectral_loss.py`` states: value rtol 2e-5;
gradient atol 2e-3 x max|grad| (U is bfloat16), and for DDSP 3e-3 x max,
the distance that file gives between the JAX package's own rfft and DFT
paths on DDSP. Here DDSP's gradient sits 2.1e-3 x max from the rfft path,
with no L1 sign that differs from a float64 evaluation, and the gap goes
with U left in float32: it is U's bfloat16 rounding, which the JAX path,
differentiated in float32, does not have."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.train import losses as jl
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    spectral_loss_kernel as sk)
from interactive_spectrogram_inpainting_tpu_torch.train import losses as tl

LENGTH = 8000
SCALES = ([("jukebox", i) for i in range(3)]
          + [("ddsp", i) for i in range(6)])
PRESETS = {"jukebox": (jl.make_jukebox_loss, tl.make_jukebox_loss),
           "ddsp": (jl.make_ddsp_loss, tl.make_ddsp_loss)}


def audio_pair(seed, batch=2, length=LENGTH):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((batch, length)) * 0.3).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return a, b


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def test_fft_route_is_fixed_by_shape_and_precision():
    for make in (tl.make_jukebox_loss, tl.make_ddsp_loss):
        for cfg in make().scale_configs(4, 65536):
            assert sk.fft_route(cfg), cfg
            assert not sk.fft_route(cfg._replace(precision="default"))
    cfg = sk.ScaleConfig(2048, 240, 1200, True, 1.0, 0.0, 1e-6)
    for n_fft, route in ((32, False), (64, True), (4096, True),
                         (8192, False), (1536, False), (1000, False)):
        assert sk.fft_route(cfg._replace(n_fft=n_fft)) == route, n_fft
    assert [sk.fft_frames_per_block(n) for n in (64, 512, 2048, 4096)] == [
        32, 4, 1, 1]


@pytest.mark.parametrize("preset,scale", SCALES)
def test_fft_oracle_matches_the_dft_plain_version(preset, scale):
    a, b = audio_pair(10 + scale)
    pred, target = torch.as_tensor(a), torch.as_tensor(b)
    cfg = PRESETS[preset][1]().scale_configs(*pred.shape)[scale]
    assert sk.fft_route(cfg)
    rows, u = sk.reference_scale_loss_fft(pred, target, cfg)
    ref_rows, ref_u = sk.reference_scale_loss(pred, target, cfg)
    torch.testing.assert_close(rows, ref_rows, atol=0, rtol=1e-5)
    assert u.dtype == torch.bfloat16 and u.shape == ref_u.shape
    u, ref_u = u.float(), ref_u.float()
    slack = bf16_step(torch.maximum(u.abs(), ref_u.abs())) + (
        1e-5 * float(ref_u.abs().max()))
    assert bool(((u - ref_u).abs() <= slack).all())
    grad = torch.tensor(0.7)
    for same_u in (u, ref_u):
        same_u = same_u.to(torch.bfloat16)
        d = sk.reference_scale_loss_fft_backward(same_u, grad, cfg, LENGTH)
        ref_d = sk.reference_scale_loss_backward(same_u, grad, cfg, LENGTH)
        torch.testing.assert_close(d, ref_d, rtol=0,
                                   atol=1e-5 * float(ref_d.abs().max()))


@pytest.mark.parametrize("preset,scale", SCALES)
def test_float64_reference_matches_the_plain_version(preset, scale):
    """``reference_scale_loss_float64`` (the accuracy reference of the card
    tests and ``chip_smoke.py``) keeps the kernel's conventions: its rows
    within rtol 1e-5 of the float32 plain version's, the plain bfloat16 U
    within one bfloat16 step (plus 1e-5 x max|U|) of its float64 U, and the
    float64 backward of one U within atol 1e-5 x max of the plain
    backward."""
    a, b = audio_pair(30 + scale)
    pred, target = torch.as_tensor(a), torch.as_tensor(b)
    cfg = PRESETS[preset][1]().scale_configs(*pred.shape)[scale]
    rows, u = sk.reference_scale_loss_float64(pred, target, cfg)
    ref_rows, ref_u = sk.reference_scale_loss(pred, target, cfg)
    assert rows.dtype == u.dtype == torch.float64
    torch.testing.assert_close(rows.float(), ref_rows, atol=0, rtol=1e-5)
    ref_u = ref_u.float().double()
    slack = bf16_step(torch.maximum(u.abs(), ref_u.abs())) + (
        1e-5 * float(ref_u.abs().max()))
    assert bool(((u - ref_u).abs() <= slack).all())
    grad = torch.tensor(0.7)
    d = sk.reference_scale_loss_fft_backward(ref_u, grad, cfg, LENGTH)
    ref_d = sk.reference_scale_loss_backward(ref_u.to(torch.bfloat16), grad,
                                             cfg, LENGTH)
    assert d.dtype == torch.float64
    torch.testing.assert_close(d.float(), ref_d, rtol=0,
                               atol=1e-5 * float(ref_d.abs().max()))


@pytest.mark.parametrize("preset,scale", SCALES)
def test_fft_packing_costs_no_accuracy(preset, scale):
    """Packing pred and target as one complex signal costs the FFT route no
    accuracy: the packed oracle's magnitudes lie as close to float64 (RMS
    error over each frame's largest magnitude) as an unpacked float32
    rfft's, within 5 %, and closer than the float32 DFT plain version's."""
    a, b = audio_pair(40 + scale)
    pred, target = torch.as_tensor(a), torch.as_tensor(b)
    cfg = PRESETS[preset][1]().scale_configs(*pred.shape)[scale]
    exact = sk.magnitude(*sk.reference_spectrum_float64(pred, cfg))

    def rms(re, im):
        err = (sk.magnitude(re, im).double() - exact) / exact.amax(
            -1, keepdim=True)
        return float((err ** 2).mean().sqrt())

    spec = torch.fft.rfft(sk._frames(pred, cfg)
                          * sk.hann_window(cfg.win, "cpu"), n=cfg.n_fft)
    packed = rms(*sk.reference_spectra_fft(pred, target, cfg)[:2])
    unpacked = rms(spec.real, spec.imag)
    dft = rms(*sk.reference_spectrum(pred, cfg))
    assert packed <= 1.05 * unpacked, (packed, unpacked)
    assert packed < dft, (packed, dft)


def oracle_value_and_grad(loss, a, b):
    """The multiscale loss through the FFT oracle: the scales' rows summed,
    the gradient as the oracle backward of each scale's U."""
    pred, target = torch.as_tensor(a), torch.as_tensor(b)
    value, grad = 0.0, torch.zeros_like(pred)
    one = torch.ones(())
    for cfg in loss.scale_configs(*pred.shape):
        rows, u = sk.reference_scale_loss_fft(pred, target, cfg)
        value += float(rows.sum())
        grad += sk.reference_scale_loss_fft_backward(u, one, cfg,
                                                     pred.shape[-1])
    return value, grad.numpy()


@pytest.mark.parametrize("preset", ["jukebox", "ddsp"])
def test_fft_oracle_matches_the_jax_rfft_path(preset, monkeypatch):
    a, b = audio_pair(20)
    make_j, make_t = PRESETS[preset]
    monkeypatch.setenv("ISI_FFT_DFT", "0")
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    want_v, want_g = jax.jit(jax.value_and_grad(make_j()))(jnp.asarray(a),
                                                           jnp.asarray(b))
    got_v, got_g = oracle_value_and_grad(make_t(), a, b)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_v, float(want_v), rtol=2e-5)
    grad_atol = {"jukebox": 2e-3, "ddsp": 3e-3}[preset]
    np.testing.assert_allclose(got_g, want_g,
                               atol=grad_atol * np.abs(want_g).max())
