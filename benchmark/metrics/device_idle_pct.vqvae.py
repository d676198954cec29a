"""The device's idle share of the traced window of the VQ-VAE training
steps: no operation ran on the device (the union of the profiler's device
intervals), in %."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
