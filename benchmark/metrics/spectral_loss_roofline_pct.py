"""The spectral-loss kernels' share of their roofline over the traced
steps: the least time of each step's calls (the criterion's Jukebox scales
forward and backward, the trio's DDSP and Jukebox scales forward; their
bytes read and written once, or their FFTs' operations at the float32
peak: ``harness/vqvae_flops.py``) over the device time of every kernel
named ``spectral_*``, in %."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("spectral_bound_s"):
        return None
    seconds = sum(s for name, s in trace["device_s"].items()
                  if "spectral_" in name and "_kernel" in name)
    if seconds <= 0:
        return None
    return 100.0 * data["spectral_bound_s"] / seconds
