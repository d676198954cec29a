"""VQ-VAE training step: the host ms a logged step spends in its metric
trio (``train.trio``: MSE, DDSP and Jukebox of the reconstruction, each
spectrogram inverted again), from the program's spans over the traced
logged steps. None where the program has no such span or the trace saw no
device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    span = trace.get("spans", {}).get("train.trio")
    if span is None or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]
