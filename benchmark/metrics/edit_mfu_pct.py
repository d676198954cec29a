"""The edit loop's share of the card's peak: the model operations of every
interaction of the window (both priors' prime and sampled tokens at the
bfloat16 peak; their encoders and memory projections, the VQ-VAE decode
and the mel inverse at the float32 peak: ``harness/flops.py``), over the
window's wall time, in %."""

from harness.peaks import PEAK_OPS


def read(data):
    ops, window = data.get("ops"), data.get("window_s")
    if not ops or not window or not (ops["bf16"] or ops["float32"]):
        return None
    seconds = (ops["bf16"] / PEAK_OPS["bf16"]
               + ops["float32"] / PEAK_OPS["float32"])
    return 100.0 * seconds / window
