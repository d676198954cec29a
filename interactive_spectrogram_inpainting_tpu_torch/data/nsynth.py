"""NSynth dataset reader (pytorch_nsynth equivalent, torch-free).

Behavior replicated from the reference's call sites
(``train_vqvae.py:591-600``, ``extract_code.py:184-192``,
``create_nsynth_dataset_split.py:39-43``): wav directories + an
``examples.json`` metadata file; pitch-range filtering (default [24, 84]);
per-field label encoders; items are (audio [num_samples] float32,
*categorical labels, metadata dict).

Host-side on purpose: wav decode happens on CPU; the spectrogram
transform runs on the device per batch (the reference's
``WavToSpectrogramDataLoader`` semantics). The port's own copy of the JAX
package's module.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .label_encoders import LabelEncoder
from .wav import read_wav


class NSynth:
    def __init__(self,
                 audio_directory_paths: Union[str, Sequence[Union[str, pathlib.Path]]],
                 json_data_path: Union[str, pathlib.Path],
                 valid_pitch_range: Optional[Tuple[int, int]] = (24, 84),
                 categorical_field_list: Sequence[str] = (
                     "instrument_family_str",),
                 squeeze_mono_channel: bool = True,
                 return_full_metadata: bool = False,
                 sample_rate: int = 16000,
                 duration_seconds: float = 4.0):
        if isinstance(audio_directory_paths, (str, pathlib.Path)):
            audio_directory_paths = [audio_directory_paths]
        self.audio_directories = [pathlib.Path(p)
                                  for p in audio_directory_paths]
        self.json_data_path = pathlib.Path(json_data_path)
        with open(self.json_data_path) as f:
            self.json_data: Dict[str, dict] = json.load(f)
        if valid_pitch_range is not None:
            lo, hi = valid_pitch_range
            self.json_data = {k: v for k, v in self.json_data.items()
                              if lo <= v.get("pitch", lo) <= hi}
        self.names: List[str] = sorted(self.json_data.keys())
        self.categorical_field_list = list(categorical_field_list)
        self.squeeze_mono_channel = squeeze_mono_channel
        self.return_full_metadata = return_full_metadata
        self.sample_rate = int(sample_rate)
        self.num_samples = int(round(sample_rate * duration_seconds))

        # per-field label encoders over the *filtered* dataset, plus pitch,
        # in the fields' order (not a set's, which follows the process's
        # string hashing): a store's label_encoders.json is then the same
        # bytes whichever process writes it
        self.label_encoders: Dict[str, LabelEncoder] = {}
        for field in dict.fromkeys([*self.categorical_field_list, "pitch",
                                    "instrument_family_str"]):
            values = sorted({meta[field] for meta in self.json_data.values()
                             if field in meta})
            if values:
                self.label_encoders[field] = LabelEncoder(values)

    def __len__(self) -> int:
        return len(self.names)

    def _wav_path(self, name: str) -> pathlib.Path:
        for directory in self.audio_directories:
            for candidate in (directory / f"{name}.wav",
                              directory / "audio" / f"{name}.wav"):
                if candidate.exists():
                    return candidate
        raise FileNotFoundError(f"wav for {name} not found in "
                                f"{self.audio_directories}")

    def load_audio(self, name: str) -> np.ndarray:
        audio, sr = read_wav(str(self._wav_path(name)))
        if sr != self.sample_rate:
            from .wav import resample
            audio = resample(audio, sr, self.sample_rate)
        if self.squeeze_mono_channel:
            audio = audio.mean(axis=0) if audio.shape[0] > 1 else audio[0]
        n = self.num_samples
        if audio.shape[-1] < n:
            pad = [(0, 0)] * (audio.ndim - 1) + [(0, n - audio.shape[-1])]
            audio = np.pad(audio, pad)
        return audio[..., :n].astype(np.float32)

    def labels(self, index: int) -> List[int]:
        """The encoded ``categorical_field_list`` labels of one note, read
        from its metadata alone."""
        meta = self.json_data[self.names[index]]
        return [int(self.label_encoders[field].transform([meta[field]])[0])
                for field in self.categorical_field_list]

    def __getitem__(self, index: int):
        name = self.names[index]
        audio = self.load_audio(name)
        labels = self.labels(index)
        if self.return_full_metadata:
            return (audio, *labels, self.json_data[name])
        return (audio, *labels)

    def metadata(self, index: int) -> Mapping:
        return self.json_data[self.names[index]]
