"""Reading a trace: the device's busy time in the window, device time by
operation and family, and idle gaps named by the host's span and
operation, on a hand-made event list."""

import types

import pytest
import torch

from bench_support import ROOT  # noqa: F401  (puts the benchmark on sys.path)
from harness import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def event(name, start, end, device=CPU, kind="cpu_op", annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
        device_type=lambda: device, activity_type=lambda: kind,
        is_user_annotation=lambda: annotation)


def fake_profiler(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_summarize_by_hand():
    s = 10 ** 9
    events = [
        event(trace.WINDOW, 0, 10 * s, annotation=True),
        event("handle /timerange-change", 0, 6 * s, annotation=True),
        event(trace.KERNEL_SPAN + "scan", 1 * s, 3 * s, annotation=True),
        event("aten::linear", 0, 1 * s),
        event("aten::mm", int(0.2 * s), int(0.8 * s)),
        event("decode_scan_kernel", 1 * s, 3 * s, CUDA, "kernel"),
        event("gemm", int(2.5 * s), 4 * s, CUDA, "kernel"),
        event("annotation on the card", 0, 10 * s, CUDA,
              "gpu_user_annotation"),
        event("gemm", 11 * s, 12 * s, CUDA, "kernel"),  # after the window
    ]
    out = trace.summarize(fake_profiler(events))
    assert out["window_s"] == pytest.approx(10.0)
    assert out["busy_s"] == pytest.approx(3.0)
    assert dict(out["device_ops"]) == pytest.approx(
        {"decode_scan_kernel": 2.0, "gemm": 1.5})
    assert out["family_s"]["cuBLAS products"] == pytest.approx(1.5)
    # a gap is named by what the host ran at its middle: [0, 1] inside the
    # handler's span and aten::mm, [4, 10] after the span
    assert dict(out["idle_gaps"]) == pytest.approx({
        "handle /timerange-change: aten::mm": 1.0,
        "(no span): (no host op)": 6.0})
    assert out["kernel_counts"] == {"decode_scan_kernel": 1, "gemm": 1}


def test_innermost_at():
    events = [(0, 10, "outer"), (2, 4, "inner"), (6, 7, "other")]
    assert trace.innermost_at([1, 3, 5, 6, 11], events) == [
        "outer", "inner", "outer", "other", None]
