"""Driver of prior training: the trainer's own step (``train_prior.
make_steps``) fed by its own reader (``train_prior.iterate_batches``) from a
codemap store of seeded random codes, for the whole window.

Set-up builds one training step (model, Adam, step function) with the
parameters drawn from the seed, and runs its first ``reference_steps``
steps through the same call and feed as the window, on batches whose rows
all differ: those steps are the warm-up, and the comparison reads them. The
window then runs more steps of the same object until ``--seconds`` have
passed, and synchronizes once at its end. Traced (``--trace 1``), the
mix's ``traced_steps`` more steps then run under the profiler, after the
window and after ``traced_warmup_steps`` that the trace leaves out, so that
its cost stays out of the window and is the same in every run.

After the window the program is freed and the plain reference
(``reference/prior.py`` with a hand-written Adam) follows the first steps
on the same rows, with the same dropout masks (drawn from a generator
seeded as the program's), from the same seeded parameters:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as Adam got it (its first moment over ``1 - beta1`` after one
  step) and the reference's, over the larger of the reference's norm of
  that leaf and the median leaf's;
- ``update_gap``: the same for each leaf's change after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a key's bias, a gradient of nought but rounding under
  softmax, moves under Adam by round-off alone);
- ``feed_rows``: rows of the program's first batches that are not rows
  of the store the harness wrote.
"""

from __future__ import annotations

import itertools
import math
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from harness import faults, flops, trace
from harness.checks import norm_gap
from harness.program import build_prior
from harness.seeds import derive
from harness.weights import make_parameters
from reference import prior as ref_prior


def log(ctx, message: str) -> None:
    print(f"train_steps {time.perf_counter() - ctx.t_start:.3f}s {message}",
          file=sys.stderr, flush=True)


def write_store(cfg: dict, mix: dict, seed: int, directory: str):
    """``mix['records']`` records of seeded random codes at the
    configuration's geometry, with seeded labels; -> the raw arrays."""
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapStoreWriter
    from harness.program import label_encoders
    rng = np.random.default_rng(derive(seed, "store"))
    n = int(mix["records"])
    prior = cfg["bottom_prior"]
    top_shape, bottom_shape = prior["condition_shape"], prior["shape"]
    raw = {"tops": rng.integers(0, prior["n_class"], (n, *top_shape)),
           "bottoms": rng.integers(0, prior["n_class"], (n, *bottom_shape))}
    for name, classes in cfg["labels"].items():
        raw[name] = rng.integers(0, len(classes), n)
    with CodemapStoreWriter(directory, top_shape, bottom_shape,
                            list(cfg["labels"]),
                            label_encoders=label_encoders(cfg),
                            n_class=prior["n_class"]) as writer:
        writer.append_batch(raw["tops"], raw["bottoms"],
                            {k: raw[k] for k in cfg["labels"]},
                            [f"record_{i}" for i in range(n)])
    return raw


def batches(dataset, batch: int, seed: int, device):
    from interactive_spectrogram_inpainting_tpu_torch.train.train_prior \
        import iterate_batches
    for epoch in itertools.count():
        yield from iterate_batches(dataset, batch, True, epoch, seed=seed,
                                   device=device)


def run(ctx) -> dict:
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapDataset
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        scheduler, train_prior)
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    ctx.ready()
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    train = cfg["training"]
    batch = int(train["batch_size"])
    n_ref = int(mix["reference_steps"])
    set_float32_precision()
    torch.zeros(1, device=dev)
    log(ctx, "device ready")
    with tempfile.TemporaryDirectory() as store:
        raw = write_store(cfg, mix, ctx.seed, store)
        dataset = CodemapDataset(store, list(cfg["labels"]))
        log(ctx, "store written")
        model = build_prior(cfg, "bottom_prior", ctx.seed, dev,
                            fused_attention=dev.type == "cuda")
        log(ctx, "model built")
        optimizer = scheduler.get_optimizer(
            model.parameters(), train["optimizer"], train["scheduler"],
            train["lr"], 1, eps=train["optimizer_eps"])
        step, _ = train_prior.make_steps(
            model, optimizer, "bottom", None, train["label_smoothing"])
        log(ctx, "optimizer and step built")
        if ctx.plant:
            step = faults.resolve(ctx.plant)(step, model, optimizer)
        feed = batches(dataset, batch, derive(ctx.seed, "order") % 2 ** 32,
                       dev)
        generator = torch.Generator().manual_seed(
            derive(ctx.seed, "dropout"))
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        initial = [p.detach().clone() for p in params]
        seen, losses = [], []
        grad_norms = None
        for i in range(n_ref):
            tops, bottoms, cc, _ = next(feed)
            seen.append((tops.cpu().numpy(), bottoms.cpu().numpy(),
                         {k: v.cpu().numpy() for k, v in cc.items()}))
            metrics = step(tops, bottoms, cc, generator)
            losses.append(metrics["loss"])
            synchronize(dev)
            log(ctx, f"step {i + 1}")
            if i == 0:
                beta1 = optimizer.optimizer.param_groups[0]["betas"][0]
                state = optimizer.optimizer.state
                grad_norms = torch.stack([
                    torch.linalg.vector_norm(state[p]["exp_avg"])
                    if p in state else torch.zeros((), device=dev)
                    for p in params]) / (1.0 - beta1)
        change_norms = torch.stack([torch.linalg.vector_norm(p.detach() - q)
                                    for p, q in zip(params, initial)])
        del initial
        program = {"loss": [float(x) for x in losses],
                   "grad": dict(zip(names, grad_norms.tolist())),
                   "change": dict(zip(names, change_norms.tolist()))}
        synchronize(dev)
        setup_s = time.perf_counter() - ctx.t_start

        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < ctx.seconds:
            tops, bottoms, cc, _ = next(feed)
            step(tops, bottoms, cc, generator)
            steps += 1
        synchronize(dev)
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        summary, traced_s, traced = None, None, 0
        if ctx.trace:
            # a fixed number of steps after the window, under the profiler,
            # after a few that it warms up on and the trace leaves out
            def run_steps(n):
                for _ in range(n):
                    tops, bottoms, cc, _ = next(feed)
                    with torch.profiler.record_function("train step"):
                        step(tops, bottoms, cc, generator)
                synchronize(dev)

            traced = int(mix["traced_steps"])
            tracing = trace.start(dev, all_threads=False, warmup=lambda: (
                run_steps(int(mix["traced_warmup_steps"]))))
            t1 = time.perf_counter()
            run_steps(traced)
            traced_s = time.perf_counter() - t1
            summary = trace.stop(tracing)
            del tracing
        del model, optimizer, step, feed, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    g = ref_prior.Geometry(cfg["bottom_prior"])
    notes = steps * batch
    out = {
        "attempted": steps, "failed": 0,
        "end_to_end": {"setup_s": setup_s,
                       "train_notes_per_s": notes / window_s},
        "device": {"kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "memory_peak_bytes": peak},
        "trace": summary,
        "layer_data": {"steps": steps, "window_s": window_s,
                       "traced_steps": traced, "traced_s": traced_s,
                       "trace": summary,
                       "step_ops": flops.training_step_ops(g, batch),
                       "attention_bound_s": attention_bound_s(g, batch)},
        "checks": {},
    }
    if traced and steps:
        # the profiler's cost: a traced step's time over a window step's
        out["checks"]["traced_slowdown"] = (traced_s / traced) / (
            window_s / steps)
    readings, control, leaves = reference_readings(ctx, raw, seen, program)
    out["checks"].update(leaves)
    out["readings"] = readings
    out["control"] = control
    return out


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def attention_bound_s(g: ref_prior.Geometry, batch: int) -> float:
    """The least time of one step's training-attention calls, forward and
    backward: the encoder's self attention, the decoder's causal self
    attention and aligned cross attention, float32."""
    from harness.frozen import train_attention_bound_pairs
    from harness.peaks import least_seconds
    dh = g.d // g.heads
    n_src = g.l_s + 1
    n_tgt = g.l_t + g.channels
    calls = ([(n_src, n_src, flops.attention_pairs(
        n_src, n_src, "anti_causal" if g.self_conditional else "full"))]
        * g.n_enc
        + [(n_tgt, n_tgt, flops.attention_pairs(n_tgt, n_tgt, "causal"))]
        * g.n_dec
        + [(n_tgt, n_src, flops.attention_pairs(
            n_tgt, n_src, "aligned" if g.aligned else "full"))] * g.n_dec)
    total = 0.0
    for lq, lk, pairs in calls:
        for nbytes, ops in train_attention_bound_pairs(
                batch, lq, lk, g.heads, dh, 4, pairs):
            total += least_seconds(nbytes, ops, "float32")
    return total


def locate_rows(raw: dict, seen, names) -> tuple:
    """The store's row of each row of the program's batches (-1 where the
    program's row is none of the store's)."""
    index = {raw["bottoms"][i].tobytes(): i
             for i in range(len(raw["bottoms"]))}
    rows, missing = [], 0
    for tops, bottoms, cc in seen:
        found = []
        for j in range(len(bottoms)):
            i = index.get(bottoms[j].astype(raw["bottoms"].dtype).tobytes(),
                          -1)
            ok = (i >= 0 and np.array_equal(raw["tops"][i], tops[j])
                  and all(int(raw[n][i]) == int(cc[n][j]) for n in names))
            missing += int(not ok)
            found.append(i if ok else 0)
        rows.append(np.asarray(found))
    return rows, missing


def reference_steps(ctx, raw, rows, precision_tf32: bool) -> Dict:
    """The reference's first steps: losses, the first gradient's leaf norms
    and each leaf's change."""
    cfg, dev = ctx.config, ctx.device
    train = cfg["training"]
    g = ref_prior.Geometry(cfg["bottom_prior"])
    spec = ref_prior.parameter_spec(g)
    p = make_parameters(spec, derive(ctx.seed, "weights", "bottom_prior"),
                        dev)
    initial = {k: v.clone() for k, v in p.items()}
    for v in p.values():
        v.requires_grad_(True)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    beta1, beta2 = 0.9, 0.999
    lr, eps = float(train["lr"]), float(train["optimizer_eps"])
    generator = torch.Generator().manual_seed(derive(ctx.seed, "dropout"))
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = precision_tf32
    torch.backends.cudnn.allow_tf32 = precision_tf32
    losses, grads = [], None
    try:
        for t, idx in enumerate(rows, start=1):
            tops = torch.as_tensor(raw["tops"][idx], device=dev)
            bottoms = torch.as_tensor(raw["bottoms"][idx], device=dev)
            labels = {n: torch.as_tensor(raw[n][idx], device=dev)
                      for n in cfg["labels"]}
            gens = ref_prior.dropout_generators(generator, g, dev)
            logits = ref_prior.forward(p, g, tops, bottoms, labels,
                                       gens=gens)
            targets = ref_prior.to_sequence(bottoms,
                                            ref_prior.target_order(g))
            loss = F.cross_entropy(logits.reshape(-1, g.n_class),
                                   targets.reshape(-1))
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if t == 1:
                    grads = {k: float(torch.linalg.vector_norm(v.grad))
                             for k, v in p.items()}
                for k, v in p.items():
                    gk = v.grad
                    m[k].mul_(beta1).add_(gk, alpha=1 - beta1)
                    s[k].mul_(beta2).addcmul_(gk, gk, value=1 - beta2)
                    denom = (s[k].sqrt() / math.sqrt(1 - beta2 ** t)).add_(
                        eps)
                    v.addcdiv_(m[k], denom, value=-lr / (1 - beta1 ** t))
                    v.grad = None
            del logits, loss
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    change = {k: float(torch.linalg.vector_norm(p[k].detach() - initial[k]))
              for k in p}
    return {"loss": losses, "grad": grads, "change": change}


def readings_of(program: Dict, ref: Dict):
    """-> (readings, the leaf each worst gap came from)."""
    median = float(np.median(list(ref["grad"].values())))
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * median}
    grad_gap, grad_leaf = norm_gap(program["grad"], ref["grad"])
    update_gap, update_leaf = norm_gap(program["change"], ref["change"],
                                       moving)
    return ({"loss_gap": max(abs(a - b) / abs(b) for a, b in
                             zip(program["loss"], ref["loss"])),
             "grad_gap": grad_gap, "update_gap": update_gap},
            {"grad_gap_leaf": grad_leaf, "update_gap_leaf": update_leaf,
             "leaves_left_out": len(ref["grad"]) - len(moving)})


def reference_readings(ctx, raw, seen, program):
    rows, missing = locate_rows(raw, seen, list(ctx.config["labels"]))
    ref = reference_steps(ctx, raw, rows, precision_tf32=False)
    readings, leaves = readings_of(program, ref)
    readings["feed_rows"] = float(missing)
    control = None
    if ctx.control:
        control = readings_of(reference_steps(ctx, raw, rows, True), ref)[0]
    return readings, control, leaves
