"""PyTorch port vs the JAX package: the spectral reconstruction losses.

The same numpy audio goes through both packages. The port runs every scale
whose window is a whole number of hops through ``fused_scale_loss``, whose
plain version serves CPU tensors (U rounded to bfloat16 as the kernel rounds
it); the JAX package runs its XLA path (``ISI_FUSED_SPECTRAL=0``) or its
fused Pallas kernel in interpret mode (``ISI_FUSED_SPECTRAL=1``), as its own
tests do. Tolerances are those of the JAX package's kernel tests: value
rtol 2e-5 (the JAX kernel's 3-pass bfloat16 product is ~1e-6 from float32);
gradient atol 2e-3 x max|grad| (U is bfloat16), 5e-3 x max|grad| through
the mel ``to_audio``.

The JAX side's loss STFTs run as DFT products (``ISI_FFT_DFT=1``, the path
the JAX package takes on its accelerator), the port's algorithm. On the CPU
the JAX package otherwise takes ``jnp.fft.rfft``, whose float32 rounding
differs: the L1 and log terms of DDSP's 64- and 128-sample scales (a bin
far below its frame's energy, a distance near 0) turn that into gradients
3.0e-3 x max|grad| apart between the JAX package's own two paths, above
the tolerance. The Jukebox criterion's squared distance is smooth: there
the two paths agree to 1.5e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.signal import (
    spectrogram as jspec)
from interactive_spectrogram_inpainting_tpu.train import losses as jl
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    spectral_loss_kernel as sk)
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.train import losses as tl

PRESETS = {"jukebox": (jl.make_jukebox_loss, tl.make_jukebox_loss),
           "ddsp": (jl.make_ddsp_loss, tl.make_ddsp_loss)}


def audio_pair(seed, batch=2, length=8000):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((batch, length)) * 0.3).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return a, b


def jax_value_and_grad(loss, a, b):
    v, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(a), jnp.asarray(b))
    return float(v), np.asarray(g)


def port_value_and_grad(loss, a, b):
    x = torch.as_tensor(a).requires_grad_()
    v = loss(x, torch.as_tensor(b))
    v.backward()
    return float(v.detach()), x.grad.numpy()


def assert_close(got, want, grad_atol):
    (v, g), (rv, rg) = got, want
    np.testing.assert_allclose(v, rv, rtol=2e-5)
    np.testing.assert_allclose(g, rg, atol=grad_atol * np.abs(rg).max())


@pytest.mark.parametrize("fused", ["0", "1"], ids=["xla", "pallas"])
@pytest.mark.parametrize("preset", ["jukebox", "ddsp"])
def test_multiscale_loss_value_and_grad_match_jax(preset, fused,
                                                  monkeypatch):
    a, b = audio_pair(0)
    make_j, make_t = PRESETS[preset]
    monkeypatch.setenv("ISI_FFT_DFT", "1")
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", fused)
    want = jax_value_and_grad(make_j(), a, b)
    assert_close(port_value_and_grad(make_t(), a, b), want, 2e-3)
    assert sk.scale_loss_forward.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_each_jukebox_scale_matches_the_jax_xla_path(scale, monkeypatch):
    import dataclasses
    a, b = audio_pair(1)
    one = {k: [v[scale]] for k, v in (("n_ffts", [2048, 1024, 512]),
                                      ("hop_lengths", [240, 120, 48]),
                                      ("window_lengths", [1200, 600, 240]))}
    monkeypatch.setenv("ISI_FFT_DFT", "1")
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    want = jax_value_and_grad(
        dataclasses.replace(jl.make_jukebox_loss(), **one), a, b)
    got = port_value_and_grad(
        dataclasses.replace(tl.make_jukebox_loss(), **one), a, b)
    assert_close(got, want, 2e-3)


def test_target_gets_no_gradient_and_1d_audio(monkeypatch):
    a, b = audio_pair(3, batch=1)
    x = torch.as_tensor(a).requires_grad_()
    y = torch.as_tensor(b).requires_grad_()
    tl.make_jukebox_loss()(x, y).backward()
    assert y.grad is None and float(x.grad.abs().max()) > 0
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    loss = jl.make_jukebox_loss()
    want = float(jax.jit(lambda x, y: loss(x, y))(jnp.asarray(a[0]),
                                                  jnp.asarray(b[0])))
    got = float(tl.make_jukebox_loss()(torch.as_tensor(a[0]),
                                       torch.as_tensor(b[0])))
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("precision,fused", [("default", "1"),
                                             ("highest", "0")])
def test_precisions_match_jax(precision, fused, monkeypatch):
    """'default' rounds audio and basis to bfloat16 in both packages (the
    JAX kernel's 1-pass product, in interpret mode); 'highest' is float32
    (the port's ``reference_scale_loss``, which autograd differentiates,
    against XLA's)."""
    import dataclasses
    a, b = audio_pair(4)
    monkeypatch.setenv("ISI_FFT_DFT", "1")
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", fused)
    want = jax_value_and_grad(dataclasses.replace(
        jl.make_jukebox_loss(), precision=precision), a, b)
    got = port_value_and_grad(dataclasses.replace(
        tl.make_jukebox_loss(), precision=precision), a, b)
    assert_close(got, want, 2e-3 if precision == "default" else 2e-4)


def test_from_spectrogram_criterion_matches_jax(monkeypatch):
    kw = dict(use_mel_scale=True, n_fft=512, hop_length=128,
              window_length=512)
    jhelper = jspec.get_spectrograms_helper(**kw)
    thelper = tspec.get_spectrograms_helper(**kw)
    a, b = audio_pair(2)
    spec = np.asarray(jhelper.to_spectrogram(jnp.asarray(a)))
    target = np.asarray(jhelper.to_spectrogram(jnp.asarray(b)))
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    jcrit = jl.make_spectral_loss_from_spectrogram(jl.make_jukebox_loss(),
                                                   jhelper)
    want = jax_value_and_grad(jcrit, spec, target)
    tcrit = tl.get_reconstruction_criterion("spectral_jukebox", thelper)
    got = port_value_and_grad(tcrit, spec, target)
    assert_close(got, want, 5e-3)
    assert tcrit.loss == tl.make_jukebox_loss()
    assert tcrit.spectrograms_helper is thelper


def test_per_row_losses_are_each_row_alone():
    a, b = audio_pair(5, batch=3)
    for loss in (tl.make_jukebox_loss(), tl.make_ddsp_loss()):
        rows = loss(torch.as_tensor(a), torch.as_tensor(b), "none")
        assert rows.shape == (3,)
        for i in range(3):
            alone = loss(torch.as_tensor(a[i:i + 1]),
                         torch.as_tensor(b[i:i + 1]))
            np.testing.assert_allclose(float(rows[i]), float(alone),
                                       rtol=1e-6)
        np.testing.assert_allclose(
            float(rows.mean()),
            float(loss(torch.as_tensor(a), torch.as_tensor(b))), rtol=1e-6)


def test_reconstruction_metrics_and_criterion_names():
    kw = dict(n_fft=256, hop_length=64, window_length=256)
    jhelper = jspec.get_spectrograms_helper(**kw)
    thelper = tspec.get_spectrograms_helper(**kw)
    rng = np.random.default_rng(6)
    spec = np.asarray(jhelper.to_spectrogram(jnp.asarray(
        rng.standard_normal((2, 4000)).astype(np.float32) * 0.1)))
    dec = (spec + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    want = jax.jit(jl.make_reconstruction_metrics(jhelper))(
        jnp.asarray(dec), jnp.asarray(spec))
    got = tl.make_reconstruction_metrics(thelper)(torch.as_tensor(dec),
                                                  torch.as_tensor(spec))
    assert set(got) == set(want) == {"metric_MSE", "metric_DDSP",
                                     "metric_Jukebox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5,
                                   err_msg=k)
    assert set(tl.make_reconstruction_metrics(None)(
        torch.as_tensor(dec), torch.as_tensor(spec))) == {"metric_MSE"}
    for name in ("mse", "MSE", "L2"):
        assert tl.get_reconstruction_criterion(name) is tl.mse_loss
    for name, n_scales in (("spectral_ddsp", 6), ("DDSP", 6),
                           ("spectral_jukebox", 3), ("Jukebox", 3)):
        crit = tl.get_reconstruction_criterion(name, thelper,
                                               precision="default")
        assert len(crit.loss.n_ffts) == n_scales
        assert crit.loss.precision == "default"
    with pytest.raises(ValueError):
        tl.get_reconstruction_criterion("spectral_other", thelper)


def test_scale_eligibility_and_plain_backward_geometry():
    ok = sk.scale_eligible
    assert ok(2048, 240, 1200, "high") and ok(512, 48, 240, "default")
    # DDSP's small scales run in the kernel too (no 128-lane padding rule)
    assert ok(64, 16, 64, "high") and ok(128, 32, 128, "high")
    assert not ok(2048, 240, 1200, "highest")
    assert not ok(2048, 241, 1200, "high")
    # the backward writes the chunks' span only: samples before `start`
    # and past the last chunk get zero gradient
    cfg = sk.ScaleConfig(2048, 240, 1200, True, 1.0, 0.0, 1e-6)
    a, b = audio_pair(7, batch=1, length=5000)
    x = torch.as_tensor(a).requires_grad_()
    sk.fused_scale_loss(x, torch.as_tensor(b), cfg).backward()
    frames, start = sk.frame_geometry(5000, 2048, 240, 1200)
    end = start + (frames - 1) * 240 + 1200
    g = x.grad[0]
    assert float(g[:start].abs().max()) == 0.0
    assert float(g[end:].abs().max()) == 0.0
    assert float(g[start:end].abs().min()) >= 0 and float(
        g[start:start + 240].abs().max()) > 0
    # an all-zero pair stays finite (the 1e-12 floor; sign(0) = 0)
    z = torch.zeros(1, 5000, requires_grad=True)
    v = sk.fused_scale_loss(z, torch.zeros(1, 5000), cfg._replace(
        mse=False, log_w=1.0))
    v.backward()
    assert float(v.detach()) == 0.0 and float(z.grad.abs().max()) == 0.0
