"""Per-modality label encoders (the server's conditioning labels).

The port's copy of ``LabelEncoder`` from
``interactive_spectrogram_inpainting_tpu/data/label_encoders.py``: each
conditioning modality (``pitch``, ``instrument_family_str``, ...) maps
class values to contiguous integer indices, as sklearn's ``classes_``; the
full mapping set is dumped to and read from ``label_encoders.json`` (one
class list per modality).
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Mapping, Sequence, Union

import numpy as np


class LabelEncoder:
    """sklearn-compatible minimal label encoder (sorted unique classes)."""

    def __init__(self, classes: Sequence = ()):  # noqa: D401
        self.classes_ = list(classes)
        self._index = {c: i for i, c in enumerate(self.classes_)}

    def fit(self, values: Iterable) -> "LabelEncoder":
        self.classes_ = sorted(set(values), key=lambda v: (str(type(v)), v))
        try:
            self.classes_ = sorted(set(values))
        except TypeError:
            pass
        self._index = {c: i for i, c in enumerate(self.classes_)}
        return self

    def transform(self, values: Iterable) -> np.ndarray:
        try:
            return np.asarray([self._index[v] for v in values], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"unseen label {e.args[0]!r}") from e

    def inverse_transform(self, indices: Iterable[int]) -> List:
        return [self.classes_[int(i)] for i in indices]

    def fit_transform(self, values: Iterable) -> np.ndarray:
        return self.fit(values).transform(values)

    def __len__(self) -> int:
        return len(self.classes_)


def dump_label_encoders(label_encoders: Mapping[str, LabelEncoder],
                        path: Union[str, pathlib.Path]) -> None:
    payload = {name: list(encoder.classes_)
               for name, encoder in label_encoders.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)


def load_label_encoders(path: Union[str, pathlib.Path]
                        ) -> Dict[str, LabelEncoder]:
    with open(path) as f:
        payload = json.load(f)
    return {name: LabelEncoder(classes) for name, classes in payload.items()}
