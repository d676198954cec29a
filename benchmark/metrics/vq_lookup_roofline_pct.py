"""The VQ-lookup kernels' share of their roofline over the traced steps:
the least time of each step's two lookups (rows and codebooks read once,
ids, quantized rows, counts and sums written once, or the scores' product
at the float32 peak: ``harness/vqvae_flops.py``) over the device time of
the ``vq_assign*`` and ``vq_stats`` kernels, in %."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("vq_bound_s"):
        return None
    seconds = sum(s for name, s in trace["device_s"].items()
                  if "vq_assign" in name or "vq_stats" in name)
    if seconds <= 0:
        return None
    return 100.0 * data["vq_bound_s"] / seconds
