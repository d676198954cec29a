"""``fused_prefix_prime``'s share of its roofline: the least time of all the
window's calls (each input byte read once, each output byte written once,
or the operations at the bfloat16 peak, whichever is longer:
``harness/frozen.py::prime_bound``) over their device time (CUDA events
around each call), in %."""

from harness.peaks import least_seconds


def read(data):
    calls = data.get("prime_calls")
    if not calls:
        return None
    device = sum(c[0] for c in calls)
    least = sum(least_seconds(c[1], c[2], "bf16") for c in calls)
    return 100.0 * least / device if device > 0 else None
