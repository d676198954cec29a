"""Metrics of the trainers: scalars to a JSONL file always, TensorBoard too
when ``torch.utils.tensorboard`` imports; audio as wav files and images as
``.npy`` arrays under ``<directory>/media``.

Port of ``interactive_spectrogram_inpainting_tpu/utils/metrics.py`` (the
metric names are the same, so dashboards carry over). Only process 0
writes: the rank of an initialized ``torch.distributed`` group, else the
one process.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Mapping, Union

import numpy as np
import torch


def process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return v


def _float(v) -> float:
    return float(np.asarray(_numpy(v)))


class MetricsWriter:
    def __init__(self, directory: Union[str, pathlib.Path],
                 enabled: bool = True):
        self.enabled = enabled and process_index() == 0
        self.directory = pathlib.Path(directory)
        self._tb = None
        if self.enabled:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._file = open(self.directory / "metrics.jsonl", "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(self.directory))
            except ImportError:
                self._tb = None

    def scalars(self, tag_prefix: str, values: Mapping[str, float],
                step: int) -> None:
        if not self.enabled:
            return
        values = {k: _float(v) for k, v in values.items()}
        record = {"step": int(step), "time": time.time(),
                  **{f"{tag_prefix}/{k}": v for k, v in values.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag_prefix}/{k}", v, step)

    def audio(self, tag: str, audio, step: int,
              sample_rate: int = 16000) -> None:
        if not self.enabled:
            return
        from ..data.wav import write_wav
        audio = np.asarray(_numpy(audio), np.float32)
        media = self.directory / "media"
        media.mkdir(exist_ok=True)
        write_wav(media / f"{tag.replace('/', '_')}-{step}.wav", audio,
                  sample_rate)
        if self._tb is not None:
            self._tb.add_audio(tag, torch.from_numpy(audio.reshape(1, -1)),
                               step, sample_rate=sample_rate)

    def image(self, tag: str, image, step: int) -> None:
        if not self.enabled:
            return
        media = self.directory / "media"
        media.mkdir(exist_ok=True)
        np.save(media / f"{tag.replace('/', '_')}-{step}.npy",
                np.asarray(_numpy(image)))

    def close(self) -> None:
        if self.enabled:
            self._file.close()
            if self._tb is not None:
                self._tb.close()
