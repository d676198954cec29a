"""The VQ-VAE training window's share of the card's peak: the model
operations of its steps (convolutions forward and backward, the VQ
lookups' scores, the mel products, the FFTs and the spectral losses:
``harness/vqvae_flops.py::step_ops``) at the float32 peak, over the
window's wall time, in %."""

from harness.peaks import PEAK_OPS


def read(data):
    if not data.get("window_ops") or not data.get("window_s"):
        return None
    seconds = data["window_ops"] / PEAK_OPS["float32"]
    return 100.0 * seconds / data["window_s"]
