"""Spans of the port's layers in ``torch.profiler``'s trace.

``span(name)`` marks a piece of work (a request's handling, the sampler's
set-up, a training step's backward) as a user annotation of the profiler,
on the same clock as the device's activity, so a trace names each idle gap
of the device by the layer the host was in. Whoever runs a profiler over
the program reads the spans: a trainer's ``--profile`` export, a
benchmark's trace, an operator's own ``torch.profiler.profile``. Nothing
else stores or exports them.

With no profiler running in the process, ``span`` returns one shared null
context and costs one read of the profiler's process-wide flag, which is
true on every thread while a profiler runs, those started before it
included. A span is opened once for each piece of work it names, so its
count in the trace is that work's count.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
