"""Dataset-level channel normalization (GANSynth DataNormalizer).

Port of ``interactive_spectrogram_inpainting_tpu/signal/normalizer.py``:
the per-channel affine rescaling ``a * x + b`` of the (log-magnitude, IF)
channels computed from dataset statistics, its exact inverse (the decoder's
output is denormalized before the inverse spectrogram transform), and the
statistics' computation and JSON file.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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

    def normalize(self, spec_and_IF: torch.Tensor) -> torch.Tensor:
        """[..., 2, F, T] -> normalized."""
        a, b = self._ab(spec_and_IF)
        return spec_and_IF * a + b

    def denormalize(self, spec_and_IF: torch.Tensor) -> torch.Tensor:
        a, b = self._ab(spec_and_IF)
        return (spec_and_IF - b) / a

    @staticmethod
    def compute_statistics(spectrogram_batches) -> DataNormalizerStatistics:
        """Scan an iterable of [B, 2, F, T] batches for channel ranges."""
        min_logmag, max_logmag = np.inf, -np.inf
        min_if, max_if = np.inf, -np.inf
        for batch in spectrogram_batches:
            if isinstance(batch, torch.Tensor):
                batch = batch.detach().cpu().numpy()
            batch = np.asarray(batch)
            min_logmag = min(min_logmag, float(batch[:, 0].min()))
            max_logmag = max(max_logmag, float(batch[:, 0].max()))
            min_if = min(min_if, float(batch[:, 1].min()))
            max_if = max(max_if, float(batch[:, 1].max()))
        return DataNormalizerStatistics(min_logmag, max_logmag, min_if,
                                        max_if)

    def dump_statistics(self, path: Union[str, pathlib.Path]) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self.statistics), f, indent=4)

    @classmethod
    def load_statistics(cls, path: Union[str, pathlib.Path]
                        ) -> "DataNormalizer":
        with open(path) as f:
            return cls(DataNormalizerStatistics(**json.load(f)))
