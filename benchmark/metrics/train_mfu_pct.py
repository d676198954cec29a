"""The training window's share of the card's peak: the model operations of
a step (forward and backward, each attention over the pairs its mask
keeps: ``harness/flops.py::training_step_ops``) times the steps, at the
float32 peak, over the window's wall time, in %."""

from harness.peaks import PEAK_OPS


def read(data):
    if not data.get("steps") or not data.get("window_s"):
        return None
    seconds = data["step_ops"] * data["steps"] / PEAK_OPS["float32"]
    return 100.0 * seconds / data["window_s"]
