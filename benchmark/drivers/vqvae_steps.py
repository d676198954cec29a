"""Driver of VQ-VAE training: the trainer's own steps
(``train_vqvae.make_train_step``, the plain and the logged one) through its
own per-batch function (``train_vqvae.train_batch``: the loader's batch,
its copy to the card, the step the log cadence picks), fed by its own
loader (``BatchLoader``, the trainer's epoch order from the seed, with the
mix's ``prefetch``: 0 is the loader's serial path) from seeded notes held
decoded in host memory, for the whole window.

The notes: ``mix['notes']`` of ``mix['note_samples']`` samples, each a
harmonic tone at a pitch drawn uniformly from ``mix['pitch_range']``
(MIDI), ``mix['partials']`` partials at amplitudes falling as one over
their number, a 5 ms attack and an exponential decay, over a noise floor
``mix['noise_floor_db']`` below full scale (so that every bin's phase, and
its instantaneous frequency, is defined). They are made on the card from
the seed and copied to the host at set-up: decoding WAVs stays out of the
training process, as the reference trainer's loader workers keep it.

Set-up follows ``train_vqvae.main`` at the configuration's flags (its
parser, ``build_config``, ``compute_normalization_statistics`` over the
loader's first batches, ``init_like_flax`` from the seed, Adam, the
criterion and the metric trio), then runs the first ``reference_steps``
steps, which the comparison reads, and ``warmup_steps`` more. The window
runs steps until ``--seconds`` have passed and synchronizes once at its
end. Traced (``--trace 1``), ``traced_steps`` more steps run under the
profiler after the window, after ``traced_warmup_steps`` that it leaves
out.

After the window the program is freed and the plain reference
(``reference/vqvae_train.py``) works out the normalizer's statistics
itself, over the notes the program's statistics read (the rows the loader
asked the harness's notes for), and trains the same initial tensors
(weights and codebooks) with them on the program's first batches:

- ``stats_gap``: the largest gap of one of the four statistics (each
  channel's least and largest value) from the reference's, over the
  reference's range of that channel;
- ``loss_gap``: the largest relative gap of a step's total loss;
- ``trio_gap``: the largest relative gap of one of the metric trio's
  values (MSE, DDSP and Jukebox of the step's reconstruction) in one of the
  steps; a step without the trio has no reading;
- ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as Adam got it (its first moment over ``1 - beta1`` after one
  step) and the reference's, over the larger of the reference's norm and
  the median leaf's;
- ``update_gap``: the same for each leaf's change after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's;
- ``codebook_gap``: after the steps, the worst of each codebook's
  ``cluster_size`` gap (the sum of the absolute differences over the
  reference's sum) and its ``embed`` gap weighted by the reference's
  cluster sizes (the norm of the difference of ``embed * cluster_size``
  over the reference's), so that a code that few rows chose, whose
  ``embed`` the first steps scale by the inverse of its count, weighs what
  its count weighs;
- ``feed_rows``: rows of the program's first batches that are no notes
  the harness made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from harness import trace, vqvae_faults, vqvae_flops
from harness.checks import norm_gap
from harness.seeds import derive
from reference import vqvae_train as ref_train

ATTACK_S = 0.005
CHUNK_NOTES = 256
CONV_OP = "convolution"  # the host operations of cuDNN's kernels
BUFFERS = ("embed", "cluster_size", "embed_avg")


def log(ctx, message: str) -> None:
    print(f"vqvae_steps {time.perf_counter() - ctx.t_start:.3f}s {message}",
          file=sys.stderr, flush=True)


def make_notes(mix: dict, fs: int, seed: int, device) -> np.ndarray:
    """[notes, note_samples] float32 on the host (see the module's
    docstring)."""
    n, length = int(mix["notes"]), int(mix["note_samples"])
    n_partials = int(mix["partials"])
    lo, hi = mix["pitch_range"]
    rng = np.random.default_rng(derive(seed, "notes"))
    pitch = rng.integers(lo, hi + 1, n)
    f0 = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
    number = np.arange(1, n_partials + 1)
    freq = f0[:, None] * number[None]
    amps = rng.uniform(0.2, 1.0, (n, n_partials)) / number[None]
    amps = np.where(freq < fs / 2.0, amps, 0.0)
    amps = amps / amps.sum(1, keepdims=True)
    phases = rng.uniform(0.0, 2.0 * np.pi, (n, n_partials))
    decay_s = rng.uniform(0.5, 3.0, n)
    gain = rng.uniform(0.3, 0.8, n)
    floor = 10.0 ** (float(mix["noise_floor_db"]) / 20.0)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "noise"))
    t = torch.arange(length, device=device, dtype=torch.float64) / fs
    out = np.empty((n, length), np.float32)

    def tensor(x):
        return torch.as_tensor(x, device=device, dtype=torch.float64)

    for a in range(0, n, CHUNK_NOTES):
        b = min(a + CHUNK_NOTES, n)
        cycles = tensor(freq[a:b])[..., None] * t
        tone = (tensor(amps[a:b])[..., None] * torch.sin(
            2.0 * math.pi * torch.frac(cycles)
            + tensor(phases[a:b])[..., None])).sum(1)
        env = (torch.exp(-t[None] / tensor(decay_s[a:b])[:, None])
               * (1.0 - torch.exp(-t / ATTACK_S))[None])
        noise = torch.randn(b - a, length, generator=gen, device=device,
                            dtype=torch.float64)
        out[a:b] = (tensor(gain[a:b])[:, None] * tone * env
                    + floor * noise).float().cpu().numpy()
    return out


class Notes:
    """The notes as the loader's dataset: item ``i`` is note ``i``. While
    ``requested`` is a list, it records each item the loader asks for."""

    def __init__(self, audio: np.ndarray):
        self.audio = audio
        self.requested = None

    def __len__(self) -> int:
        return len(self.audio)

    def __getitem__(self, index: int) -> np.ndarray:
        if self.requested is not None:
            self.requested.append(index)
        return self.audio[index]


def epochs(loader):
    """The loader's batches epoch after epoch, as ``main`` sets them."""
    for epoch in itertools.count():
        loader.set_epoch(epoch)
        yield from loader


def batch_of(tv):
    """The program's per-batch function; a trainer without one does the
    same work inline in ``main``, which this copies."""
    if hasattr(tv, "train_batch"):
        return tv.train_batch

    def train_batch(batches, device, global_step, log_frequency,
                    train_step, train_step_logged, generator=None):
        batch = next(batches)
        audio = torch.as_tensor(
            batch[0] if isinstance(batch, tuple) else batch
        ).to(device, non_blocking=True)
        is_log_step = global_step % log_frequency == 0
        metrics = (train_step_logged if is_log_step else train_step)(
            audio, generator)
        return audio, metrics, is_log_step
    return train_batch


def check_config(config, cfg: dict) -> None:
    """The trainer's configuration from the flags against the file's
    widths, which the reference and the counts read."""
    for key, value in cfg["vqvae"].items():
        if getattr(config, key) != value:
            raise ValueError(f"the flags give {key} = "
                             f"{getattr(config, key)!r}, the configuration "
                             f"{value!r}")


def run(ctx) -> dict:
    from interactive_spectrogram_inpainting_tpu_torch.data.loader import (
        BatchLoader)
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae \
        import VQVAE
    from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram \
        import get_spectrograms_helper
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        losses, scheduler, train_vqvae as tv)
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
        init_like_flax)
    ctx.ready()
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    args = tv.make_parser().parse_args(cfg["flags"])
    if args.output_spectrogram_threshold or args.bf16:
        raise ValueError("the reference covers float32 without the masked "
                         "phase")
    batch = int(args.batch_size)
    n_ref = int(mix["reference_steps"])
    log_frequency = int(args.train_logs_frequency_batches)
    set_float32_precision()
    torch.zeros(1, device=dev)
    log(ctx, "device ready")
    notes = make_notes(mix, args.fs_hz, ctx.seed, dev)
    dataset = Notes(notes)
    loader = BatchLoader(dataset, batch, shuffle=True,
                         seed=derive(ctx.seed, "order") % 2 ** 32,
                         prefetch=int(mix["prefetch"]))
    log(ctx, f"{len(notes)} notes made")
    helper = get_spectrograms_helper(**vars(args))
    dataset.requested = []
    stats = tv.compute_normalization_statistics(
        helper, loader, max_batches=int(mix["statistics_batches"]),
        device=dev)
    stats_rows = dataset.requested[:int(mix["statistics_batches"]) * batch]
    dataset.requested = None
    config = dataclasses.replace(
        tv.build_config(args),
        normalizer_statistics=dataclasses.asdict(stats))
    check_config(config, cfg)
    model = VQVAE(config)
    init_like_flax(model, torch.Generator().manual_seed(
        derive(ctx.seed, "weights", "vqvae")))
    model.to(dev)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer = scheduler.get_optimizer(
        model.parameters(), "adam", args.sched, args.lr,
        len(loader) * args.num_training_epochs,
        clip_grad_norm=args.clip_grad_norm)
    parts = {"model": model, "latent_loss_weight": args.latent_loss_weight,
             "criterion": losses.get_reconstruction_criterion(
                 args.reconstruction_criterion, helper,
                 precision=args.spectral_precision),
             "metrics": losses.make_reconstruction_metrics(helper)}
    if ctx.plant:
        vqvae_faults.resolve(ctx.plant)(parts)
    common = dict(optimizer=optimizer,
                  reconstruction_criterion=parts["criterion"],
                  latent_loss_weight=parts["latent_loss_weight"],
                  spectrograms_helper=helper, bf16=args.bf16)
    train_step = tv.make_train_step(model, **common)
    train_step_logged = tv.make_train_step(
        model, reconstruction_metrics=parts["metrics"], **common)
    train_batch = batch_of(tv)
    log(ctx, f"statistics, model and steps built ({stats})")
    # the corruption and restart draws, seeded as ``main`` seeds them
    generator = torch.Generator(device=dev).manual_seed(20200117)
    feed = epochs(loader)
    global_step = 0

    def one_step():
        nonlocal global_step
        out = train_batch(feed, dev, global_step, log_frequency, train_step,
                          train_step_logged, generator)
        global_step += 1
        return out

    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    seen, losses_seen, trios, grad_norms = [], [], [], None
    for i in range(n_ref):
        audio, metrics, _ = one_step()
        seen.append(audio.cpu())
        losses_seen.append(float(metrics["vqvae_loss"]))
        trios.append({k: float(v) for k, v in metrics.items()
                      if k.startswith("metric_")})
        log(ctx, f"step {i + 1}")
        if i == 0:
            beta1 = optimizer.optimizer.param_groups[0]["betas"][0]
            state = optimizer.optimizer.state
            grad_norms = torch.stack([
                torch.linalg.vector_norm(state[p]["exp_avg"])
                if p in state else torch.zeros((), device=dev)
                for p in params]) / (1.0 - beta1)
    change_norms = torch.stack([
        torch.linalg.vector_norm(p.detach() - initial[n])
        for n, p in zip(names, params)])
    program = {"loss": losses_seen, "trio": trios,
               "stats": dataclasses.asdict(stats),
               "grad": dict(zip(names, grad_norms.tolist())),
               "change": dict(zip(names, change_norms.tolist())),
               "codebooks": {k: v.detach().clone() for k, v in
                             model.state_dict().items()
                             if k.split(".")[-1] in BUFFERS}}
    for _ in range(int(mix["warmup_steps"])):
        one_step()
    synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start
    log(ctx, "warm")

    t0 = time.perf_counter()
    steps = logged = 0
    while time.perf_counter() - t0 < ctx.seconds:
        logged += one_step()[2]
        steps += 1
    synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    log(ctx, f"window: {steps} steps in {window_s:.3f}s")
    summary, traced_s, traced, traced_logged, conv_s = None, None, 0, 0, None
    if ctx.trace:
        def run_steps(n):
            count = 0
            for _ in range(n):
                with torch.profiler.record_function("train step"):
                    count += one_step()[2]
            synchronize(dev)
            return count

        traced = int(mix["traced_steps"])
        tracing = trace.start(dev, all_threads=False, warmup=lambda: (
            run_steps(int(mix["traced_warmup_steps"]))))
        t1 = time.perf_counter()
        traced_logged = run_steps(traced)
        traced_s = time.perf_counter() - t1
        summary = trace.stop(tracing)
        conv_s = device_seconds_under(tracing[0], CONV_OP)
        del tracing
    del model, optimizer, train_step, train_step_logged, feed, params, parts
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    vq, spec = cfg["vqvae"], cfg["spectrogram"]
    shape = (int(spec["n_fft"]) // 2, helper.num_frames(notes.shape[1]))
    length = shape[1] * int(spec["hop_length"])
    out = {
        "attempted": steps, "failed": 0,
        "end_to_end": {"setup_s": setup_s,
                       "train_notes_per_s": steps * batch / window_s},
        "device": {"kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "memory_peak_bytes": peak},
        "trace": summary,
        "layer_data": {
            "steps": steps, "window_s": window_s,
            "window_ops": (
                logged * vqvae_flops.step_ops(vq, spec, batch, shape)
                + (steps - logged) * vqvae_flops.step_ops(
                    vq, spec, batch, shape, trio=False)),
            "traced_steps": traced, "traced_logged_steps": traced_logged,
            "traced_s": traced_s, "trace": summary,
            "conv_device_s": conv_s,
            "spectral_bound_s": (
                traced_logged * vqvae_flops.spectral_bound_s(batch, length)
                + (traced - traced_logged) * vqvae_flops.spectral_bound_s(
                    batch, length, trio=False)),
            "vq_bound_s": traced * vqvae_flops.vq_bound_s(vq, batch, shape)},
        "checks": {"window_logged_steps": logged},
    }
    if traced and steps:
        out["checks"]["traced_slowdown"] = (traced_s / traced) / (
            window_s / steps)
        counts = {n: s["count"] for n, s in summary["spans"].items()
                  if n.startswith("train.")}
        out["checks"]["traced_span_counts"] = counts
        # on a program with spans: one a step, the trio's one a logged step
        if counts:
            out["checks"]["span_counts_match"] = (
                counts.get("train.batch") == traced
                and counts.get("train.trio", 0) == traced_logged)
    readings, control, details = reference_readings(
        ctx, notes, stats_rows, seen, initial, program, args)
    out["checks"].update(details)
    out["readings"] = readings
    out["control"] = control
    return out


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_seconds_under(prof, op_part: str):
    """Device seconds, inside the traced window, of the operations whose
    launching host operation (the profiler's link from a kernel to the
    operator it ran under) has ``op_part`` in its name; None where the
    trace links no device operation to a host one."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    ops, window, device = {}, None, []
    for e in events:
        if e.device_type() == cuda:
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if kind in trace.DEVICE_ACTIVITIES or (
                    not kind and not e.is_user_annotation()):
                device.append(e)
        elif e.is_user_annotation():
            if e.name() == trace.WINDOW:
                window = (e.start_ns(), e.end_ns())
        else:
            ops[e.correlation_id()] = e.name()
    if window is None:
        return None
    w0, w1 = window
    total, linked = 0, 0
    for e in device:
        name = ops.get(e.linked_correlation_id())
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if name is None or b <= a:
            continue
        linked += 1
        if op_part in name:
            total += b - a
    return total / 1e9 if linked else None


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def locate_rows(notes: np.ndarray, seen) -> int:
    """Rows of the program's batches that are none of the notes."""
    index = {}
    for i in range(len(notes)):
        index.setdefault(notes[i, :64].tobytes(), []).append(i)
    missing = 0
    for audio in seen:
        rows = audio.numpy()
        for row in rows:
            found = any(np.array_equal(notes[i], row)
                        for i in index.get(row[:64].tobytes(), ()))
            missing += int(not found)
    return missing


def reference_run(ctx, notes, stats_rows, seen, initial, args,
                  on_tf32: bool):
    dev, spec = ctx.device, ctx.config["spectrogram"]
    batch = len(seen[0])
    p = {k: v.clone() for k, v in initial.items()}
    with tf32(on_tf32):
        stats = ref_train.statistics(
            (torch.as_tensor(notes[stats_rows[i:i + batch]]).to(dev)
             for i in range(0, len(stats_rows), batch)), spec)
        out = ref_train.train(
            p, ctx.config["vqvae"], spec, stats, [a.to(dev) for a in seen],
            lr=args.lr, eps=1e-8, latent_weight=args.latent_loss_weight)
    names = ref_train.leaves(p)
    return {"loss": out["loss"], "trio": out["trio"], "stats": stats,
            "grad": {k: float(torch.linalg.vector_norm(out["grad"][k]))
                     for k in names},
            "change": {k: float(torch.linalg.vector_norm(p[k] - initial[k]))
                       for k in names},
            "codebooks": {k: p[k] for k in p
                          if k.split(".")[-1] in BUFFERS}}


def codebook_gap(program: Dict, ref: Dict):
    """(gap, which): the worst of each codebook's cluster-size gap and its
    count-weighted embedding gap (see the module's docstring)."""
    worst, which = 0.0, None
    for pre in ("quantize_t", "quantize_b"):
        size_p = program[f"{pre}.cluster_size"]
        size_r = ref[f"{pre}.cluster_size"]
        embed_p, embed_r = program[f"{pre}.embed"], ref[f"{pre}.embed"]
        sizes = float((size_p - size_r).abs().sum()
                      / size_r.abs().sum().clamp_min(1e-30))
        weighted = float(torch.linalg.vector_norm(
            (embed_p - embed_r) * size_r[None]) / torch.linalg.vector_norm(
            embed_r * size_r[None]).clamp_min(1e-30))
        for gap, name in ((sizes, f"{pre}.cluster_size"),
                          (weighted, f"{pre}.embed")):
            if not gap <= worst:
                worst, which = gap, name
    return worst, which


def stats_gap(program: Dict, ref: Dict) -> float:
    """The worst statistic's gap over the reference's range of its
    channel (see the module's docstring)."""
    worst = 0.0
    for channel in ("logmag", "IF"):
        span = max(abs(ref[f"max_{channel}"] - ref[f"min_{channel}"]), 1e-30)
        for end in ("min", "max"):
            key = f"{end}_{channel}"
            worst = max(worst, abs(program[key] - ref[key]) / span)
    return worst


def trio_gap(program, ref):
    """(gap, which): the worst relative gap of a trio value over the steps;
    (None, the value) where a step lacks one."""
    worst, which = 0.0, None
    for step, (mine, theirs) in enumerate(zip(program, ref)):
        for name, value in theirs.items():
            if name not in mine:
                return None, f"{name} of step {step}"
            gap = abs(mine[name] - value) / max(abs(value), 1e-30)
            if not gap <= worst:
                worst, which = gap, f"{name} of step {step}"
    return worst, which


def readings_of(program: Dict, ref: Dict):
    """-> (readings, where each worst gap came from)."""
    median = float(np.median(list(ref["grad"].values())))
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * median}
    grad_gap, grad_leaf = norm_gap(program["grad"], ref["grad"])
    update_gap, update_leaf = norm_gap(program["change"], ref["change"],
                                       moving)
    book_gap, book = codebook_gap(program["codebooks"], ref["codebooks"])
    metric_gap, metric = trio_gap(program["trio"], ref["trio"])
    return ({"stats_gap": stats_gap(program["stats"], ref["stats"]),
             "loss_gap": max(abs(a - b) / abs(b) for a, b in
                             zip(program["loss"], ref["loss"])),
             "trio_gap": metric_gap,
             "grad_gap": grad_gap, "update_gap": update_gap,
             "codebook_gap": book_gap},
            {"grad_gap_leaf": grad_leaf, "update_gap_leaf": update_leaf,
             "codebook_gap_of": book, "trio_gap_of": metric,
             "leaves_left_out": len(ref["grad"]) - len(moving)})


def reference_readings(ctx, notes, stats_rows, seen, initial, program,
                       args):
    ref = reference_run(ctx, notes, stats_rows, seen, initial, args, False)
    readings, details = readings_of(program, ref)
    readings["feed_rows"] = float(locate_rows(notes, seen))
    control = None
    if ctx.control:
        control = readings_of(reference_run(
            ctx, notes, stats_rows, seen, initial, args, True), ref)[0]
    return readings, control, details
