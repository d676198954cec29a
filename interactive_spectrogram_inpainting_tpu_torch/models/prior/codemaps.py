"""Codemap <-> sequence flattening orders, as static index permutations.

Port of ``interactive_spectrogram_inpainting_tpu/models/prior/codemaps.py``.
Each scan order is a precomputed numpy permutation, applied to tensors as
one ``index_select``.

Scan orders (frequency-first, low frequencies first):
- ``Simple``: sequence position ``j`` holds codemap cell
  ``(f = j % F, t = j // F)``.
- ``ZigZag`` (upsampling prior): the target codemap is cut into
  ``(pf, pt)`` patches, one per source cell; patches follow the source's
  scan order and cells within a patch are again frequency-first:
  ``j = ((t_s * F_src + f_s) * pt + pt_i) * pf + pf_i`` holds cell
  ``(f_s * pf + pf_i, t_s * pt + pt_i)``.
"""

from __future__ import annotations

import numpy as np
import torch


class CodemapsHelper:
    """Flatten [B, F, T(, E)] codemaps to [B, F*T(, E)] sequences and back."""

    def __init__(self, frequencies: int, duration: int):
        self.frequencies = int(frequencies)
        self.duration = int(duration)
        self.sequence_length = self.frequencies * self.duration
        self.predict_frequencies_first = True
        self.predict_low_frequencies_first = True
        # flat codemap index (f * T + t) of each sequence position
        self._gather = self._build_gather()
        self._scatter = np.argsort(self._gather)

    def _build_gather(self) -> np.ndarray:
        raise NotImplementedError

    def to_sequence(self, codemap: torch.Tensor) -> torch.Tensor:
        """[B, F, T] or [B, F, T, E] -> [B, L] or [B, L, E]."""
        batch = codemap.shape[0]
        trailing = tuple(codemap.shape[3:])
        flat = codemap.reshape((batch, self.sequence_length) + trailing)
        index = torch.as_tensor(self._gather, device=codemap.device)
        return flat.index_select(1, index)

    def to_time_frequency_map(self, sequence: torch.Tensor,
                              permute_output_as_logits: bool = False
                              ) -> torch.Tensor:
        """[B, L(, E)] -> [B, F, T(, E)]; with logits flag -> [B, E, F, T]."""
        batch = sequence.shape[0]
        trailing = tuple(sequence.shape[2:])
        index = torch.as_tensor(self._scatter, device=sequence.device)
        unperm = sequence.index_select(1, index)
        out = unperm.reshape(
            (batch, self.frequencies, self.duration) + trailing)
        if trailing and permute_output_as_logits:
            out = torch.movedim(out, -1, 1)
        return out

    @property
    def flatten_permutation(self) -> np.ndarray:
        """[L] flat codemap index (``f * T + t``) of each sequence position:
        ``seq = codemap.reshape(-1)[perm]`` on the host."""
        return self._gather

    def positions(self) -> np.ndarray:
        """[L, 2] (f, t) cell of each sequence position (host-side)."""
        return np.stack([self._gather // self.duration,
                         self._gather % self.duration], axis=1)


class SimpleCodemapsHelper(CodemapsHelper):
    def _build_gather(self) -> np.ndarray:
        j = np.arange(self.sequence_length)
        f = j % self.frequencies
        t = j // self.frequencies
        return f * self.duration + t


class ZigZagCodemapsHelper(CodemapsHelper):
    def __init__(self, frequencies: int, duration: int,
                 patch_frequencies: int, patch_duration: int):
        self.patch_frequencies = int(patch_frequencies)
        self.patch_duration = int(patch_duration)
        if frequencies % patch_frequencies or duration % patch_duration:
            raise ValueError("patch sizes must divide the codemap shape")
        super().__init__(frequencies, duration)

    def _build_gather(self) -> np.ndarray:
        pf, pt = self.patch_frequencies, self.patch_duration
        f_src = self.frequencies // pf
        j = np.arange(self.sequence_length)
        pf_i = j % pf
        rest = j // pf
        pt_i = rest % pt
        rest = rest // pt
        f_s = rest % f_src
        t_s = rest // f_src
        f = f_s * pf + pf_i
        t = t_s * pt + pt_i
        return f * self.duration + t
