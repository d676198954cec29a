"""Playback: the median ``App.handle`` time of ``/get-audio`` in the window
(VQ-VAE decode, mel inverse, inverse STFT, WAV), in ms."""

import numpy as np


def read(data):
    if not data.get("playback_s"):
        return None
    return float(np.median(data["playback_s"])) * 1e3
