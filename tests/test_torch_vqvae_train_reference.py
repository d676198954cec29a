"""The port's VQ-VAE training step against the benchmark's plain reference
(``benchmark/reference/vqvae_train.py``), and the trainer's per-batch
function and spans.

A narrow VQ-VAE (hidden 8, residual 2, one residual block, codebooks of 8
codes of dimension 4, factors top 2 / bottom 4) on mel spectrograms (n_fft
512, hop 128) of 4096-sample notes, batch 4, the Jukebox criterion, three
steps from the same ``init_like_flax`` weights and normalizer. The port
runs its plain versions here (the spectral loss's and the VQ lookup's),
the reference plain ``torch`` under autograd with a hand-written Adam.

Tolerances (the gaps measured here in parentheses): losses rtol 1e-6
(8e-8); the metric trio of each step (MSE, DDSP, Jukebox) rtol 1e-5
(2.7e-6); the normalizer's statistics, each within 1e-6 of its
channel's range (0: the same bits here). Each leaf's first gradient
within 2e-3 of its own largest value (4.3e-4, the output layer's bias, a
sum over every output cell with much cancellation; every other leaf
1.6e-4 or less): the port's spectral loss rounds its residual U to
bfloat16 before the backward, as its kernel does, where the reference
differentiates in float32. The codes of every
step equal wherever the port's two best scores differ by more than 1e-4
(every code here). The codebooks' EMA state after the three steps within
1e-5 of each tensor's largest value (8.8e-7); the parameters within lr
(0.12 lr: Adam's first steps move a weight by lr times the sign of its
gradient, which rounding can flip where the gradient is near nought).
"""

import itertools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu_torch.data.wav import write_wav
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae import (
    VQVAE, VQVAEConfig)
from interactive_spectrogram_inpainting_tpu_torch.signal.normalizer import (
    DataNormalizer)
from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram import (
    get_spectrograms_helper)
from interactive_spectrogram_inpainting_tpu_torch.train import (
    losses, scheduler, train_vqvae as tt)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import trace  # noqa: E402
from reference import vqvae_train as ref  # noqa: E402

SPEC = dict(use_mel_scale=True, fs_hz=16000, n_fft=512, hop_length=128,
            window_length=512)
MODEL = dict(in_channel=2, num_hidden_channels=8, num_residual_channels=2,
             n_res_block=1, embed_dim=4, num_embeddings=8,
             resolution_factors={"top": 2, "bottom": 4},
             use_pallas_lookup=True)
LENGTH = 4096
BATCH = 4
STEPS = 3
LR = 1e-3
MARGIN = 1e-4


def notes(seed: int, batch: int = BATCH) -> np.ndarray:
    """Harmonic notes over a -60 dB noise floor: every bin has a phase."""
    rng = np.random.default_rng(seed)
    t = np.arange(LENGTH) / 16000.0
    out = []
    for _ in range(batch):
        f0 = rng.uniform(110.0, 440.0)
        x = sum(rng.uniform(0.1, 0.3) / h * np.sin(2 * np.pi * h * f0 * t)
                for h in range(1, 9))
        out.append(x * np.exp(-t / 0.2) + 1e-3 * rng.standard_normal(LENGTH))
    return np.asarray(out, np.float32)


def port_model(helper, batches):
    stats = DataNormalizer.compute_statistics(
        helper.to_spectrogram(b) for b in batches)
    model = VQVAE(VQVAEConfig(**MODEL, normalizer_statistics=vars(stats)))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model, vars(stats)


def watch_codes(model):
    """Each lookup's codes and the port's margin between its two best
    scores, recorded at every training call."""
    seen = []

    def before(module, args, kwargs):
        embed = module.embed
        flat = args[0].permute(0, 2, 3, 1).reshape(-1, embed.shape[0])
        scores = (embed * embed).sum(0)[None] - 2.0 * (flat.detach() @ embed)
        best = torch.topk(scores, 2, dim=1, largest=False).values
        seen.append({"margin": best[:, 1] - best[:, 0]})

    def after(module, args, kwargs, out):
        seen[-1]["ids"] = out[2].reshape(-1).long()

    for q in (model.quantize_t, model.quantize_b):
        q.register_forward_pre_hook(before, with_kwargs=True)
        q.register_forward_hook(after, with_kwargs=True)
    return seen


@pytest.fixture(scope="module")
def both():
    """Three steps of the port and of the reference from the same state."""
    helper = get_spectrograms_helper(**SPEC)
    batches = [torch.as_tensor(notes(10 + i)) for i in range(STEPS)]
    model, stats = port_model(helper, batches)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None, LR,
                                        10)
    grads = []
    step_optimizer = optimizer.step

    def keep_grads(*args, **kwargs):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return step_optimizer(*args, **kwargs)

    optimizer.step = keep_grads
    criterion = losses.get_reconstruction_criterion("spectral_jukebox",
                                                    helper)
    step = tt.make_train_step(
        model, optimizer, criterion, 0.25, helper,
        reconstruction_metrics=losses.make_reconstruction_metrics(helper))
    codes = watch_codes(model)
    metrics = [step(audio) for audio in batches]
    port_losses = [float(m["vqvae_loss"]) for m in metrics]
    trios = [{k: float(v) for k, v in m.items() if k.startswith("metric_")}
             for m in metrics]

    p = {k: v.clone() for k, v in initial.items()}
    cfg = {k: v for k, v in MODEL.items() if k != "use_pallas_lookup"}
    out = ref.train(p, cfg, SPEC, stats, batches, lr=LR, eps=1e-8,
                    latent_weight=0.25)
    return {"model": model, "loss": port_losses, "grads": grads,
            "codes": codes, "ref": out, "p": p, "trio": trios}


def test_losses_match(both):
    np.testing.assert_allclose(both["loss"], both["ref"]["loss"], rtol=1e-6)


def test_metric_trio_of_every_step(both):
    assert len(both["trio"]) == len(both["ref"]["trio"]) == STEPS
    for port, reference in zip(both["trio"], both["ref"]["trio"]):
        assert set(port) == set(reference) == {
            "metric_MSE", "metric_DDSP", "metric_Jukebox"}
        for name, value in reference.items():
            np.testing.assert_allclose(port[name], value, rtol=1e-5,
                                       err_msg=name)


def test_normalizer_statistics_match():
    helper = get_spectrograms_helper(**SPEC)
    batches = [torch.as_tensor(notes(30 + i)) for i in range(2)]
    port = vars(DataNormalizer.compute_statistics(
        helper.to_spectrogram(b) for b in batches))
    reference = ref.statistics(batches, SPEC)
    assert set(port) == set(reference)
    for channel in ("logmag", "IF"):
        span = reference[f"max_{channel}"] - reference[f"min_{channel}"]
        for end in ("min", "max"):
            key = f"{end}_{channel}"
            assert abs(port[key] - reference[key]) <= 1e-6 * span, key


def test_codes_match_where_clear(both):
    ref_ids = [ids.reshape(-1) for pair in both["ref"]["ids"]
               for ids in pair]
    assert len(ref_ids) == len(both["codes"]) == 2 * STEPS
    for seen, ids in zip(both["codes"], ref_ids):
        clear = seen["margin"] > MARGIN
        assert int(clear.sum()) > 0.9 * len(ids)
        assert torch.equal(seen["ids"][clear], ids[clear])


def test_first_gradient_of_every_leaf(both):
    port = both["grads"][0]
    assert set(port) == set(both["ref"]["grad"])
    for name, g in both["ref"]["grad"].items():
        scale = float(g.abs().max())
        assert float((port[name] - g).abs().max()) <= 2e-3 * scale, name


def test_codebooks_and_parameters_after_three_steps(both):
    state = both["model"].state_dict()
    for name, value in both["p"].items():
        if name.split(".")[-1] in ("embed", "cluster_size", "embed_avg"):
            scale = max(float(value.abs().max()), 1e-30)
            assert float((state[name] - value).abs().max()) <= 1e-5 * scale, \
                name
        else:
            assert float((state[name] - value).abs().max()) <= LR, name


# -- the per-batch function and the spans -------------------------------------

def test_train_batch_copies_then_picks_the_step_by_the_log_cadence():
    calls = []

    def plain(audio, generator):
        calls.append(("plain", audio.dtype, tuple(audio.shape)))
        return {"loss": torch.zeros(())}

    def logged(audio, generator):
        calls.append(("logged", audio.dtype, tuple(audio.shape)))
        return {"loss": torch.ones(())}

    batches = iter([(notes(1, 2), np.zeros(2)), notes(2, 2), notes(3, 2)])
    out = [tt.train_batch(batches, torch.device("cpu"), step, 2, plain,
                          logged) for step in range(3)]
    assert [o[2] for o in out] == [True, False, True]
    assert [c[0] for c in calls] == ["logged", "plain", "logged"]
    assert all(c[1:] == (torch.float32, (2, LENGTH)) for c in calls)
    assert torch.equal(out[0][0], torch.as_tensor(notes(1, 2)))


@pytest.fixture
def nsynth_dir(tmp_path):
    (tmp_path / "audio").mkdir()
    meta = {}
    for i, audio in enumerate(notes(20, 4)):
        name = f"keyboard_synthetic_{i:03d}-{48 + i:03d}-100"
        write_wav(tmp_path / "audio" / f"{name}.wav", audio, 16000)
        meta[name] = {"pitch": 48 + i, "note_str": name,
                      "instrument_family_str": "keyboard"}
    (tmp_path / "train.json").write_text(json.dumps(meta))
    return tmp_path


def test_main_dry_run_trains_one_step_through_train_batch(nsynth_dir,
                                                          monkeypatch):
    calls = []
    real = tt.train_batch

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(tt, "train_batch", counted)
    model = tt.main([
        "--dataset_audio_directory_paths", str(nsynth_dir / "audio"),
        "--train_dataset_json_data_path", str(nsynth_dir / "train.json"),
        "--dataset_duration_seconds", str(LENGTH / 16000),
        "--use_mel_scale", "--n_fft", "512", "--hop_length", "128",
        "--window_length", "512", "--num_hidden_channels", "8",
        "--num_residual_channels", "2", "--num_residual_blocks", "1",
        "--embeddings_dimension", "4", "--num_embeddings", "8",
        "--resolution_factors", "top=2,bottom=4", "--batch_size", "2",
        "--reconstruction_criterion", "spectral_jukebox", "--pallas_vq",
        "--input_normalization", "--device", "cpu", "--dry_run",
        "--runs_directory", str(nsynth_dir / "runs")])
    assert len(calls) == 1
    audio, metrics, is_log_step = calls[0]
    assert audio.shape == (2, LENGTH) and is_log_step
    assert {"metric_MSE", "metric_DDSP", "metric_Jukebox"} <= set(metrics)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_two_steps_write_each_span_once_a_step_and_the_trio_at_log_steps():
    helper = get_spectrograms_helper(**SPEC)
    batches = [torch.as_tensor(notes(30 + i, 2)) for i in range(2)]
    model, _ = port_model(helper, batches)
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None, LR,
                                        10)
    criterion = losses.get_reconstruction_criterion("spectral_jukebox",
                                                    helper)
    step = tt.make_train_step(model, optimizer, criterion, 0.25, helper)
    logged = tt.make_train_step(
        model, optimizer, criterion, 0.25, helper,
        reconstruction_metrics=losses.make_reconstruction_metrics(helper))
    feed = iter(b.numpy() for b in batches)
    cpu = torch.device("cpu")
    prof, window = trace.start(cpu, all_threads=False)
    try:
        for i in range(2):
            tt.train_batch(feed, cpu, i, 2, step, logged)
    finally:
        window.__exit__(None, None, None)
        prof.stop()
    summary = trace.summarize(prof)
    counts = {n: s["count"] for n, s in summary["spans"].items()
              if n.startswith("train.")}
    assert counts == {"train.batch": 2, "train.spectrogram": 2,
                      "train.forward": 2, "train.criterion": 2,
                      "train.backward": 2, "train.optimizer": 2,
                      "train.trio": 1}
    spans = sorted(s for s in trace.raw_events(prof)[2]
                   if s[2].startswith("train."))
    phases = ["train.batch", "train.spectrogram", "train.forward",
              "train.criterion", "train.backward", "train.optimizer"]
    assert [n for _, _, n in spans] == phases + ["train.trio"] + phases
    assert all(a[1] <= b[0] for a, b in itertools.pairwise(spans))
