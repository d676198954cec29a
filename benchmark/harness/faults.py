"""Faults planted in the program on purpose, to show that the comparison
deciding ``correct`` catches each fault a cell can have. The benchmark's own
runs plant none; the CPU tests (``tests/test_bench_faults.py``) and
``calibrate.py --fault`` do.

Serving faults take the server's state in its process
(``serve_child.py``'s ``plant``, given as ``harness.faults:<name>``);
training faults wrap the program's step: ``fault(step, model, optimizer)``
returns the broken step. Neither cell runs on several cards, so there is
no exchange between cards to leave out; the serving cell samples one
sequence at a time, so there is no half of a batch to leave out there.
"""

from __future__ import annotations

import importlib

import torch


def _scan_module():
    return importlib.import_module(
        "interactive_spectrogram_inpainting_tpu_torch.sampling.sample")


def scan_unchanged(state) -> None:
    """A step that returns its state unchanged: the scan samples nothing."""
    sample = _scan_module()
    orig = sample.fused_decode_scan

    def broken(params, bias, posfull, mem, kv, tokens, *args, **kwargs):
        _, kv = orig(params, bias, posfull, mem, kv, tokens, *args, **kwargs)
        return tokens.clone(), kv
    sample.fused_decode_scan = broken


def token_altered(state) -> None:
    """A token altered where it is produced: the scan's last masked
    token."""
    sample = _scan_module()
    orig = sample.fused_decode_scan

    def broken(params, bias, posfull, mem, kv, tokens, mask, *args,
               **kwargs):
        out, kv = orig(params, bias, posfull, mem, kv, tokens, mask, *args,
                       **kwargs)
        i = int(mask.nonzero()[-1])
        out = out.clone()
        out[i] = (out[i] + 1) % kwargs["n_class"]
        return out, kv
    sample.fused_decode_scan = broken


def audio_altered(state) -> None:
    """An answer altered where it is produced: the playback's audio."""
    orig = state.decode_audio_fn

    def decode_audio_fn():
        fn = orig()
        return lambda top, bottom: fn(top, bottom) + 0.01
    state.decode_audio_fn = decode_audio_fn


SERVING = ("scan_unchanged", "token_altered", "audio_altered")


def unchanged(step, model, optimizer):
    """A step that leaves the parameters as they were."""
    def broken(tops, bottoms, cc, generator):
        saved = [p.detach().clone() for p in model.parameters()]
        metrics = step(tops, bottoms, cc, generator)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return metrics
    return broken


def half_batch(step, model, optimizer):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(tops, bottoms, cc, generator):
        h = tops.shape[0] // 2
        return step(tops[:h], bottoms[:h], {k: v[:h] for k, v in cc.items()},
                    generator)
    return broken


def loss_altered(step, model, optimizer):
    """An answer altered where it is produced: the step's loss."""
    def broken(tops, bottoms, cc, generator):
        metrics = step(tops, bottoms, cc, generator)
        metrics["loss"] = metrics["loss"] * 1.01
        return metrics
    return broken


TRAINING = ("unchanged", "half_batch", "loss_altered")


def resolve(spec):
    """``harness.faults:<name>`` (or a callable) -> the fault."""
    if callable(spec):
        return spec
    module, name = str(spec).split(":")
    return getattr(importlib.import_module(module), name)
