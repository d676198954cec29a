"""Reading a ``torch.profiler`` trace: the device's busy time in a window,
device time by operation and by kernel family, and the longest idle gaps
named by what the host was doing.

Spans: the harness marks its traced window with a user annotation
(``WINDOW``) and the calls into a layer with annotations of their own
(``record_function`` in the drivers). The traced window is a fixed amount
of work after the measured window (``traced_steps``, ``traced_decks`` in
a mix), so the profiler's cost is the same in every run and touches
neither the measured window nor the host-clock metrics read from it. The raw Kineto events are read directly
(``prof.profiler.kineto_results``): building the profiler's Python event
list for a window of several hundred thousand events takes minutes.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from .frozen import kernel_family, union_ms

WINDOW = "bench:window"
KERNEL_SPAN = "kernel "  # spans the harness puts around a kernel's entry
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def start(device, all_threads: bool = True, warmup=None):
    """Start ``torch.profiler`` on the host and the device, call ``warmup``
    (work under the profiler that the window leaves out), and open the
    ``WINDOW`` span; -> the handle ``stop`` takes. ``all_threads``: record
    the operations of every host thread (a server's handler thread, which
    was started before the profiler), not only this one's and those it
    hands work to (autograd's)."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kwargs = {}
    if all_threads:
        kwargs["experimental_config"] = \
            torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=activities, **kwargs)
    prof.start()
    if warmup is not None:
        warmup()
    span = torch.profiler.record_function(WINDOW)
    span.__enter__()
    return prof, span


def stop(handle) -> Dict:
    """Close the window's span, stop the profiler; -> ``summarize``."""
    prof, span = handle
    span.__exit__(None, None, None)
    prof.stop()
    return summarize(prof)


def raw_events(prof):
    """(cpu, device, annotations) lists of (start_ns, end_ns, name) from a
    stopped profiler; user annotations on the host are kept apart."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    cpu_events, device_events, annotations = [], [], []
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == cuda:
            if kind in DEVICE_ACTIVITIES or (
                    not kind and not e.is_user_annotation()):
                device_events.append((start, end, name))
        elif e.is_user_annotation():
            annotations.append((start, end, name))
        else:
            cpu_events.append((start, end, name))
    return cpu_events, device_events, annotations


def window_of(annotations) -> Tuple[int, int]:
    spans = [(a, b) for a, b, name in annotations if name == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return spans[0]


def merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost_at(points, events) -> List[Optional[str]]:
    """For each of the sorted ``points``, the name of the latest-started
    event of ``events`` [(start, end, name)] that contains it."""
    events = sorted(events)
    heap: list = []
    i = 0
    out = []
    for m in points:
        while i < len(events) and events[i][0] <= m:
            a, b, name = events[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        # an event that ended before m contains no later point either
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(prof) -> Dict:
    """The window's device busy time and the breakdown, from a profiler
    whose window carried a ``WINDOW`` span, with what a per-layer metric
    may read besides: every device operation's seconds (``device_s``) and
    count (``kernel_counts``), by name; the seconds by kernel family
    (``family_s``); and every host span's seconds and count inside the
    window (``spans``: the drivers' ``record_function`` names)."""
    cpu_events, device_events, annotations = raw_events(prof)
    w0, w1 = window_of(annotations)
    inside = [(max(a, w0), min(b, w1), name) for a, b, name in device_events
              if b > w0 and a < w1]
    busy = merged((a, b) for a, b, _ in inside)
    by_name: Dict[str, float] = {}
    by_family: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for a, b, name in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        fam = kernel_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + (b - a) / 1e9
        counts[name] = counts.get(name, 0) + 1
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    # the layer a gap falls in: the drivers' spans, not the kernel spans
    # nested in them
    spans = [ev for ev in annotations
             if ev[2] != WINDOW and not ev[2].startswith(KERNEL_SPAN)]
    inner = innermost_at([m for m, _ in mids], cpu_events)
    outer = innermost_at([m for m, _ in mids], spans)
    span_s: Dict[str, List[float]] = {}
    for a, b, name in annotations:
        if name != WINDOW and b > w0 and a < w1:
            entry = span_s.setdefault(name, [0.0, 0])
            entry[0] += (min(b, w1) - max(a, w0)) / 1e9
            entry[1] += 1
    by_gap: Dict[str, float] = {}
    for (_, length), op, span in zip(mids, inner, outer):
        label = f"{span or '(no span)'}: {op or '(no host op)'}"
        by_gap[label] = by_gap.get(label, 0.0) + length / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": union_ms((a, b) for a, b, _ in inside) / 1e6,
        "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n[:120], s] for n, s in by_gap.items()),
                            key=lambda x: -x[1])[:TOP],
        "device_s": by_name,
        "family_s": by_family,
        "kernel_counts": counts,
        "spans": {name: {"seconds": sec, "count": n}
                  for name, (sec, n) in span_s.items()},
    }
