"""PyTorch port vs the JAX package: the VQ-VAE trainer.

A narrow VQ-VAE (hidden 16, residual 8, one residual block, codebooks of 32
codes of dimension 8, factors top 2 / bottom 4) on mel spectrograms (n_fft 512, hop 128) of 4096-sample
notes, batch 2, the JAX package's weights carried over by
``from_flax_params`` (the ResNet variant and ``main``:
``test_torch_train_vqvae_main.py``). No corruption and no restarts, so no random draw
enters a step.

Tolerances. One train step: loss and metrics rtol 1e-5 (mse) / 2e-5
(spectral, the JAX kernel tests' value tolerance). Parameter gradients:
atol 2e-4 / rtol 2e-3 (mse); the spectral criterion holds each parameter
to a tolerance scaled by its own largest |grad|. With the kernel's
formula (precision 'high': U rounded to bfloat16) against the JAX
package's fused kernel in interpret mode, which rounds U at the same
point: 5e-3 x its own largest (measured: 4.0e-4 at most). The output
layer's bias is the one exception, 1e-1 x its own: each of its two
numbers is the sum of the gradient over every output cell, with so much
cancellation that the two float32 paths below already put it 3.2e-4 of
its size apart (every other parameter 2.1e-6 or less), and the bfloat16
rounding of U moves it by 2.0 % in the port and 2.8 % in the JAX package
(from their float32 paths; 5.0 % from each other; the JAX backward also
multiplies by a bfloat16 basis, the port's by a float32 one). With the
float32 formula (precision 'highest': the port's plain formula under
autograd against XLA's): 1e-3 x its own largest, the bias included. The
EMA buffers after the step atol 1e-5; the parameters after one Adam step
atol 1e-6, or 2 lr where a gradient is within its tolerance of 0 (the
first Adam step moves every weight by lr sign(g)). The codes of the
step's batch are checked equal first, where the two best scores differ by
more than 1e-4 (the bfloat16 step against the JAX package's:
``test_torch_train_vqvae_bf16.py``). Eval sums 1e-5 relative;
normalization statistics 1e-3 (the forward transform's log near its
floor).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.models.vqvae import vqvae as jv
from interactive_spectrogram_inpainting_tpu.signal import (
    spectrogram as jspec)
from interactive_spectrogram_inpainting_tpu.train import (
    losses as jl, scheduler as jsched, train_vqvae as jt)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.train import (
    losses as tl, scheduler, train_vqvae as tt)
from interactive_spectrogram_inpainting_tpu_torch.utils import weights

SPEC = dict(use_mel_scale=True, n_fft=512, hop_length=128, window_length=512)
MODEL = dict(num_hidden_channels=16, num_residual_channels=8, n_res_block=1,
             embed_dim=8, num_embeddings=32,
             resolution_factors={"top": 2, "bottom": 4})
LENGTH = 4096
LR = 1e-3
MARGIN = 1e-4


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def notes(seed, batch=2, length=LENGTH):
    """Harmonic notes over a noise floor: every band has energy."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    out = []
    for _ in range(batch):
        f0 = rng.uniform(110.0, 440.0)
        x = sum(rng.uniform(0.1, 0.3) / h * np.sin(2 * np.pi * h * f0 * t)
                for h in range(1, 6))
        out.append(x + 1e-3 * rng.standard_normal(length))
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=None)
def helpers():
    return (jspec.get_spectrograms_helper(**SPEC),
            tspec.get_spectrograms_helper(**SPEC))


def model_pair(**extra):
    jcfg = jv.VQVAEConfig(**{**MODEL, **extra})
    jmodel = jv.VQVAE(jcfg)
    probe = jnp.zeros((1, 2, 256, 32), jnp.float32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                     probe)
    tmodel = tv.VQVAE(tv.VQVAEConfig.from_json(jcfg.to_json()))
    tmodel.load_state_dict(weights.from_flax_params(to_numpy(variables)))
    return jmodel, variables, tmodel


def keep_grads():
    """An optax transformation whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def port_tree(model, grads=False):
    holder = copy.deepcopy(model)
    if grads:
        holder.load_state_dict({**holder.state_dict(), **{
            k: p.grad for k, p in model.named_parameters()}})
    return to_numpy(weights.to_flax_params(holder))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_codes_clear(tmodel, spec):
    """The step's codes are not near a tie (else the two packages may pick
    different codes and nothing after the lookups is comparable)."""
    with torch.no_grad():
        x = torch.as_tensor(spec)
        if tmodel.normalizer is not None:
            x = tmodel.normalizer.normalize(x)
        enc_b = tmodel.enc_b(x)
        qt_in = tmodel.quantize_conv_t(tmodel.enc_t(enc_b))
        quant_t = tmodel.quantize_t(qt_in)[0]
        qb_in = tmodel.quantize_conv_b(torch.cat([tmodel.dec_t(quant_t),
                                                  enc_b], dim=1))
    for lookup_in, level in ((qt_in, tmodel.quantize_t),
                             (qb_in, tmodel.quantize_b)):
        embed = level.embed
        flat = lookup_in.permute(0, 2, 3, 1).reshape(-1, embed.shape[0])
        flat = flat.float()
        scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
        best2 = torch.topk(scores, 2, dim=1, largest=False).values
        assert float((best2[:, 1] - best2[:, 0]).min()) > MARGIN


def jax_step(jmodel, variables, criterion, audio, **kw):
    jhelper, _ = helpers()
    opt = optax.chain(keep_grads(), jsched.get_optimizer("adam", None, LR,
                                                         10))
    params = variables["params"]
    step = jt.make_train_step(jmodel, opt, criterion, 0.25, jhelper,
                              needs_rng=False, **kw)
    p, c, state, metrics = step(params, variables["codebook"],
                                opt.init(params), jnp.asarray(audio),
                                jax.random.PRNGKey(0))
    return p, c, state[0], metrics


def port_step(tmodel, criterion, audio, **kw):
    _, thelper = helpers()
    model = copy.deepcopy(tmodel)
    opt = scheduler.get_optimizer(model.parameters(), "adam", None, LR, 10)
    step = tt.make_train_step(model, opt, criterion, 0.25, thelper, **kw)
    return model, step(torch.as_tensor(audio), torch.Generator())


# the output layer's bias: a sum over every output cell (module docstring)
OUTPUT_BIAS = "['dec']['ConvTranspose_1']['bias']"


def assert_step_equal(model, p_j, g_j, grad_tol):
    """The gradients (``grad_tol(key, jax_grad) -> (atol, rtol)``) and the
    parameters after Adam's first step against the JAX step's."""
    grads_t = leaves(port_tree(model, grads=True)["params"])
    grads_j = leaves(g_j)
    params_t = leaves(port_tree(model)["params"])
    params_j = leaves(p_j)
    assert set(grads_t) == set(grads_j)
    for k, g in grads_j.items():
        atol, rtol = grad_tol(k, g)
        np.testing.assert_allclose(grads_t[k], g, atol=atol, rtol=rtol,
                                   err_msg=k)
        # Adam's first step: lr sign(g) wherever g is clear of its tolerance
        clear = np.abs(g) > atol + 2 * rtol * np.abs(g) + 2e-3 * np.abs(g)
        np.testing.assert_allclose(params_t[k][clear], params_j[k][clear],
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(params_t[k], params_j[k],
                                   atol=2 * LR + 1e-6, err_msg=k)


def own_scale(rel, output_bias_rel):
    def tol(key, g):
        scale = output_bias_rel if key == OUTPUT_BIAS else rel
        return scale * float(np.abs(g).max()), 0.0
    return tol


@pytest.mark.parametrize("name,precision,fused", [
    ("mse", None, "0"), ("spectral_jukebox", "high", "1"),
    ("spectral_jukebox", "highest", "0")])
def test_train_step_equals_jax(name, precision, fused, monkeypatch):
    """One step; the mse step is the logged one (with the metric trio) in
    both packages. 'high' runs the kernel's formula (its plain version on
    the CPU) against the JAX package's fused kernel (``fused`` '1', in
    interpret mode); 'highest' the float32 formula against XLA's."""
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", fused)
    jhelper, thelper = helpers()
    jmodel, variables, tmodel = model_pair()
    audio = notes(3)
    assert_codes_clear(tmodel, thelper.to_spectrogram(torch.as_tensor(audio)))
    spectral = name != "mse"
    trio = {} if spectral else {
        "jax": dict(reconstruction_metrics=jl.make_reconstruction_metrics(
            jhelper)),
        "port": dict(reconstruction_metrics=tl.make_reconstruction_metrics(
            thelper))}
    p_j, c_j, g_j, m_j = jax_step(
        jmodel, variables, jl.get_reconstruction_criterion(
            name, jhelper, precision=precision), audio,
        **trio.get("jax", {}))
    model, m_t = port_step(tmodel, tl.get_reconstruction_criterion(
        name, thelper, precision=precision), audio, **trio.get("port", {}))
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(
            float(m_t[k]), float(m_j[k]),
            rtol=2e-5 if spectral or k.startswith("metric") else 1e-5,
            atol=1e-6, err_msg=k)
    if not spectral:
        grad_tol = lambda key, g: (2e-4, 2e-3)  # noqa: E731
    elif precision == "high":
        grad_tol = own_scale(5e-3, 1e-1)
    else:
        grad_tol = own_scale(1e-3, 1e-3)
    assert_step_equal(model, p_j, g_j, grad_tol)
    for level in ("quantize_t", "quantize_b"):
        for buf in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                getattr(model, level).__getattr__(buf).numpy(),
                np.asarray(c_j[level][buf]), atol=1e-5, rtol=1e-5,
                err_msg=f"{level}.{buf}")


class Precomputed:
    """A helper whose 'audio' is already the spectrogram."""

    @staticmethod
    def to_spectrogram(spec):
        return spec


def test_masked_phase_input_and_metric_trio(monkeypatch):
    """With the masked-phase input transform the step is invariant to the
    IF of sub-threshold bins (model input and loss target both see the
    masked view) and equals the JAX step; the logged step adds the metric
    trio without changing the update."""
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    min_magnitude = 0.1
    jmodel, variables, tmodel = model_pair(
        output_spectrogram_min_magnitude=min_magnitude)
    rng = np.random.default_rng(7)
    spec = rng.standard_normal((2, 2, 256, 32)).astype(np.float32)
    sub = spec[:, 0] <= np.log(min_magnitude)
    assert sub.any() and not sub.all()
    transform = tspec.make_masked_phase_transform(min_magnitude)
    model = copy.deepcopy(tmodel)
    opt = scheduler.get_optimizer(model.parameters(), "adam", None, LR, 10)
    step = tt.make_train_step(model, opt, tl.mse_loss, 0.25, Precomputed,
                              input_transform=transform)
    m1 = step(torch.as_tensor(spec))
    p1 = copy.deepcopy(model.state_dict())
    spec2 = spec.copy()
    spec2[:, 1][sub] = rng.standard_normal(int(sub.sum())) * 10.0
    model.load_state_dict(tmodel.state_dict())
    opt = scheduler.get_optimizer(model.parameters(), "adam", None, LR, 10)
    step = tt.make_train_step(model, opt, tl.mse_loss, 0.25, Precomputed,
                              input_transform=transform)
    m2 = step(torch.as_tensor(spec2))
    assert torch.equal(m1["vqvae_loss"], m2["vqvae_loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, p1[k]), k
    jstep = jt.make_train_step(
        jmodel, optax.adam(LR), jl.mse_loss, 0.25, None, needs_rng=False,
        spec_precomputed=True,
        input_transform=jspec.make_masked_phase_transform(min_magnitude))
    params = variables["params"]
    _, _, _, m_j = jstep(params, variables["codebook"],
                         optax.adam(LR).init(params), jnp.asarray(spec),
                         jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(m1["vqvae_loss"]),
                               float(m_j["vqvae_loss"]), rtol=1e-5)

    # the metric trio (its values against JAX: test_train_step_equals_jax)
    _, thelper = helpers()
    audio = notes(4)
    trio = tl.make_reconstruction_metrics(thelper)
    plain_model, plain = port_step(tmodel, tl.mse_loss, audio)
    logged_model, logged = port_step(tmodel, tl.mse_loss, audio,
                                     reconstruction_metrics=trio)
    names = {"metric_MSE", "metric_DDSP", "metric_Jukebox"}
    assert names <= set(logged) and not names & set(plain)
    np.testing.assert_allclose(float(logged["metric_MSE"]),
                               float(logged["reconstruction_loss"]),
                               rtol=1e-6)
    for (k, a), b in zip(plain_model.state_dict().items(),
                         logged_model.state_dict().values()):
        assert torch.equal(a, b), k


def test_bf16_step_is_finite_on_float32_masters():
    _, thelper = helpers()
    _, _, tmodel = model_pair(normalizer_statistics={
        "min_logmag": -14.0, "max_logmag": 3.0, "min_IF": -1.0,
        "max_IF": 1.0})
    model, metrics = port_step(tmodel, tl.mse_loss, notes(5, batch=1),
                               bf16=True)
    assert np.isfinite(float(metrics["vqvae_loss"]))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in model.parameters())
    assert model.quantize_b.embed.dtype == torch.float32
    assert not torch.equal(model.quantize_b.embed, tmodel.quantize_b.embed)


def test_eval_step_is_the_exact_count_of_jax(monkeypatch):
    monkeypatch.setenv("ISI_FUSED_SPECTRAL", "0")
    jhelper, thelper = helpers()
    jmodel, variables, tmodel = model_pair()
    audio = notes(6, batch=3)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    audio[2] = 0.0  # the padded remainder row
    j_eval = jt.make_eval_step(
        jmodel, jl.get_reconstruction_criterion("spectral_jukebox", jhelper),
        0.25, jhelper,
        reconstruction_metrics=jl.make_reconstruction_metrics(jhelper))
    sums_j, count_j = j_eval(variables["params"], variables["codebook"],
                             jnp.asarray(audio), jnp.asarray(w))
    t_eval = tt.make_eval_step(
        tmodel, tl.get_reconstruction_criterion("spectral_jukebox", thelper),
        0.25, thelper,
        reconstruction_metrics=tl.make_reconstruction_metrics(thelper))
    sums, count = t_eval(torch.as_tensor(audio), torch.as_tensor(w))
    assert float(count) == float(count_j) == 2.0
    assert set(sums) == set(sums_j)
    for k in sums_j:
        np.testing.assert_allclose(float(sums[k]), float(sums_j[k]),
                                   rtol=1e-5, err_msg=k)
    # garbage in the weight-0 row changes nothing
    audio[2] = notes(7, batch=1)[0]
    sums2, _ = t_eval(torch.as_tensor(audio), torch.as_tensor(w))
    for k in sums:
        np.testing.assert_allclose(float(sums2[k]), float(sums[k]),
                                   rtol=1e-6, err_msg=k)


def test_normalization_statistics_equal_jax():
    jhelper, thelper = helpers()
    batches = [notes(8 + i) for i in range(3)]
    want = jt.compute_normalization_statistics(jhelper, batches)
    got = tt.compute_normalization_statistics(thelper, batches)
    for k in ("min_logmag", "max_logmag", "min_IF", "max_IF"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   atol=1e-3, err_msg=k)
    masked = tt.compute_normalization_statistics(
        thelper, batches, max_batches=2,
        input_transform=tspec.make_masked_phase_transform(0.1))
    assert masked.min_logmag == pytest.approx(
        tt.compute_normalization_statistics(thelper, batches[:2]).min_logmag)
