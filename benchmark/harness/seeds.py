"""Seeds of the inputs, the weights and the noise, derived from ``--seed``
and a tag, without importing torch (a driver derives its inputs before the
card is checked)."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``tags`` (strings or integers) under ``seed``."""
    words = [int(seed) % (1 << 64)]
    for tag in tags:
        words.append(zlib.crc32(tag.encode()) if isinstance(tag, str)
                     else int(tag) % (1 << 64))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
