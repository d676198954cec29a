"""Dataset-level channel normalization (GANSynth DataNormalizer).

Port of ``interactive_spectrogram_inpainting_tpu/signal/normalizer.py``,
decode side: the decoder's output is mapped back through the inverse of
the per-channel affine rescaling ``a * x + b`` of the (log-magnitude, IF)
channels. Normalizing (the encode side) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import numpy as np
import torch


@dataclasses.dataclass
class DataNormalizerStatistics:
    min_logmag: float
    max_logmag: float
    min_IF: float
    max_IF: float


class DataNormalizer:
    """logmag and IF channels: a = 2/(max-min), b = -(max+min)/(max-min)."""

    def __init__(self, statistics: Union[DataNormalizerStatistics,
                                         Mapping[str, float]]):
        if isinstance(statistics, Mapping):
            statistics = DataNormalizerStatistics(**statistics)
        self.statistics = s = statistics
        mag_range = max(s.max_logmag - s.min_logmag, 1e-8)
        if_range = max(s.max_IF - s.min_IF, 1e-8)
        self._a = np.asarray([2.0 / mag_range, 2.0 / if_range], np.float32)
        self._b = np.asarray(
            [-(s.max_logmag + s.min_logmag) / mag_range,
             -(s.max_IF + s.min_IF) / if_range], np.float32)

    def _ab(self, like: torch.Tensor):
        a = torch.as_tensor(self._a, device=like.device).reshape(2, 1, 1)
        b = torch.as_tensor(self._b, device=like.device).reshape(2, 1, 1)
        return a, b

    def denormalize(self, spec_and_IF: torch.Tensor) -> torch.Tensor:
        a, b = self._ab(spec_and_IF)
        return (spec_and_IF - b) / a
