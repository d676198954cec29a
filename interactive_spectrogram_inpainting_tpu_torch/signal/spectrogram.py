"""GANSynth-style spectrogram resynthesis (the playback path).

Port of the inverse half of
``interactive_spectrogram_inpainting_tpu/signal/spectrogram.py``:
``[B, 2, F, T]`` (log magnitude, instantaneous frequency) -> phase
integration -> iSTFT -> audio, for the linear helper and the fused mel
inverse (``MelSpectrogramsHelper._to_audio_impl``), plus the expanded mel
filterbank matrices. The iSTFT runs through ``torch.fft.irfft``; the JAX
package's DFT-matmul STFT core existed only for a TPU backend without a
complex FFT and is not carried over. The forward transform (the encode
path) is not ported yet.

Canonical NSynth geometry (fs 16 kHz, n_fft 2048, hop 512, 4 s) gives
``[2, 1024, 128]`` spectrograms.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz,
                 break_frequency_hertz: float = _MEL_BREAK_FREQUENCY_HERTZ):
    """HTK-style mel scale with configurable break frequency (GANSynth)."""
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(
        np.asarray(frequencies_hertz, dtype=np.float64)
        / break_frequency_hertz)


def mel_to_hertz(mels,
                 break_frequency_hertz: float = _MEL_BREAK_FREQUENCY_HERTZ):
    return break_frequency_hertz * np.expm1(
        np.asarray(mels, dtype=np.float64) / _MEL_HIGH_FREQUENCY_Q)


def _hann_window(window_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default)."""
    n = np.arange(window_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)
            ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SpectrogramsHelper:
    """Invertible linear-frequency log-magnitude + IF transform."""

    fs_hz: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    window_length: int = 2048
    safelog_eps: float = 1e-6

    @property
    def num_freq_bins(self) -> int:
        return self.n_fft // 2  # the DC bin is discarded

    @property
    def _pad_left(self) -> int:
        return (self.window_length - self.hop_length) // 2

    def num_samples(self, num_frames: int) -> int:
        """Audio length decoded from a spectrogram with ``num_frames``."""
        return num_frames * self.hop_length

    def _istft_ri(self, re: torch.Tensor, im: torch.Tensor,
                  num_samples: int) -> torch.Tensor:
        """Least-squares overlap-add inverse of (re, im) [..., T, n_fft//2+1]
        (``torch.istft``'s normalization)."""
        frames = re.shape[-2]
        framed = torch.fft.irfft(torch.complex(re.float(), im.float()),
                                 n=self.n_fft, dim=-1)
        window = torch.as_tensor(_hann_window(self.window_length),
                                 device=re.device)
        framed = framed[..., :self.window_length] * window
        total = (frames - 1) * self.hop_length + self.window_length
        batch_shape = tuple(framed.shape[:-2])
        if self.window_length % self.hop_length == 0:
            # chunk c of frame f lands on output chunk f + c
            m = self.window_length // self.hop_length
            k = frames + m - 1
            z = framed.reshape(batch_shape + (frames, m, self.hop_length))
            out = torch.zeros(batch_shape + (k, self.hop_length),
                              device=re.device)
            for c in range(m):
                out[..., c:c + frames, :] += z[..., :, c, :]
            out = out.reshape(batch_shape + (total,))
        else:
            idx = (np.arange(frames)[:, None] * self.hop_length
                   + np.arange(self.window_length)[None, :]).reshape(-1)
            out = torch.zeros(batch_shape + (total,), device=re.device)
            out.index_add_(-1, torch.as_tensor(idx, device=re.device),
                           framed.reshape(batch_shape + (-1,)))
        win_sq = np.zeros(total, dtype=np.float64)
        w = _hann_window(self.window_length).astype(np.float64) ** 2
        for f in range(frames):
            start = f * self.hop_length
            win_sq[start: start + self.window_length] += w
        win_sq = np.maximum(win_sq, 1e-11).astype(np.float32)
        out = out / torch.as_tensor(win_sq, device=re.device)
        pad_l = self._pad_left
        return out[..., pad_l: pad_l + num_samples]

    def _resynth_ri(self, mag: torch.Tensor, phase: torch.Tensor,
                    num_samples: Optional[int]) -> torch.Tensor:
        """[B, T, F] magnitude + unwrapped phase -> [B, num_samples]."""
        re = mag * torch.cos(phase)
        im = mag * torch.sin(phase)
        dc = torch.zeros(re.shape[:-1] + (1,), device=re.device)
        re = torch.cat([dc, re], dim=-1)  # restore the discarded DC bin
        im = torch.cat([dc, im], dim=-1)
        if num_samples is None:
            num_samples = self.num_samples(re.shape[-2])
        return self._istft_ri(re, im, num_samples)

    def to_audio(self, spec_and_IF: torch.Tensor,
                 num_samples: Optional[int] = None) -> torch.Tensor:
        """[B, 2, F, T] (or [2, F, T]) -> [B, num_samples]."""
        squeeze = spec_and_IF.dim() == 3
        if squeeze:
            spec_and_IF = spec_and_IF[None]
        audio = self._to_audio_impl(spec_and_IF, num_samples)
        return audio[0] if squeeze else audio

    def _to_audio_impl(self, spec_and_IF: torch.Tensor,
                       num_samples: Optional[int] = None) -> torch.Tensor:
        x = spec_and_IF.transpose(-1, -2)  # [B, 2, T, F]
        phase = torch.cumsum(x[:, 1] * math.pi, dim=-2)
        return self._resynth_ri(torch.exp(x[:, 0]), phase, num_samples)


def _expanded_mel_edges(num_mel_bins: int, num_linear_bins: int,
                        fs_hz: float, lower_edge_hertz: float,
                        upper_edge_hertz: float,
                        break_frequency_hertz: float,
                        bin_width_threshold_factor: float) -> np.ndarray:
    """Band edges (num_mel_bins + 2) of an expanded-resolution mel scale:
    the lowest ``k`` bands are linearly spaced at ``linear_bin_width /
    factor``, the rest mel-spaced, with ``k`` minimal such that the mel
    spacing starts no narrower than that minimum width."""
    linear_bin_width = (fs_hz / 2.0) / num_linear_bins
    min_width = linear_bin_width / bin_width_threshold_factor
    num_edges = num_mel_bins + 2

    def edges_with_k(k: int) -> Optional[np.ndarray]:
        linear_top = lower_edge_hertz + k * min_width
        if linear_top >= upper_edge_hertz:
            return None
        lin_part = lower_edge_hertz + min_width * np.arange(
            k, dtype=np.float64)
        mel_lo = hertz_to_mel(linear_top, break_frequency_hertz)
        mel_hi = hertz_to_mel(upper_edge_hertz, break_frequency_hertz)
        mel_part = mel_to_hertz(
            np.linspace(mel_lo, mel_hi, num_edges - k), break_frequency_hertz)
        first_mel_width = (mel_part[1] - mel_part[0] if len(mel_part) > 1
                           else np.inf)
        edges = np.concatenate([lin_part, mel_part])
        return edges if first_mel_width >= min_width else None

    lo, hi = 0, num_edges - 2
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        e = edges_with_k(mid)
        if e is not None:
            best = e
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        best = edges_with_k(0)
        if best is None:
            best = np.linspace(lower_edge_hertz, upper_edge_hertz, num_edges)
    return best


def linear_to_mel_weight_matrix(
        num_mel_bins: int, num_linear_bins: int, fs_hz: float,
        lower_edge_hertz: float, upper_edge_hertz: float,
        break_frequency_hertz: float = _MEL_BREAK_FREQUENCY_HERTZ,
        bin_width_threshold_factor: float = 1.5) -> np.ndarray:
    """[num_linear_bins, num_mel_bins] triangular filterbank (no DC bin)."""
    edges = _expanded_mel_edges(
        num_mel_bins, num_linear_bins, fs_hz, lower_edge_hertz,
        upper_edge_hertz, break_frequency_hertz, bin_width_threshold_factor)
    linear_freqs = (np.arange(1, num_linear_bins + 1, dtype=np.float64)
                    * (fs_hz / 2.0) / num_linear_bins)
    lower = edges[:-2][None, :]
    center = edges[1:-1][None, :]
    upper = edges[2:][None, :]
    f = linear_freqs[:, None]
    up_slope = (f - lower) / np.maximum(center - lower, 1e-12)
    down_slope = (upper - f) / np.maximum(upper - center, 1e-12)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    empty = weights.sum(axis=0) < 1e-8
    if np.any(empty):
        nearest = np.abs(linear_freqs[:, None]
                         - center[0][None, :]).argmin(axis=0)
        for m in np.nonzero(empty)[0]:
            weights[nearest[m], m] = 1.0
    return weights.astype(np.float32)


def mel_to_linear_matrix(l2m: np.ndarray) -> np.ndarray:
    """Pseudo-inverse as in GANSynth: m2l = l2m^T diag(1/colsums(l2m l2m^T))."""
    m = l2m.astype(np.float64)
    mt = m.T
    d = (m @ mt).sum(axis=0)
    d = np.where(np.abs(d) > 1e-8, 1.0 / np.maximum(d, 1e-12), d)
    return (mt * d[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_matrices(num_bins: int, fs_hz: float, lower: float, upper: float,
                  break_hz: float, factor: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    l2m = linear_to_mel_weight_matrix(num_bins, num_bins, fs_hz, lower,
                                      upper, break_hz, factor)
    return l2m, mel_to_linear_matrix(l2m)


@dataclasses.dataclass(frozen=True)
class MelSpectrogramsHelper(SpectrogramsHelper):
    """Mel-warped variant; shape-preserving (mel bins == linear bins)."""

    lower_edge_hertz: float = 0.0
    upper_edge_hertz: float = 8000.0
    mel_break_frequency_hertz: float = _MEL_BREAK_FREQUENCY_HERTZ
    mel_bin_width_threshold_factor: float = 1.5

    def _matrices(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        l2m, m2l = _mel_matrices(
            self.num_freq_bins, self.fs_hz, self.lower_edge_hertz,
            self.upper_edge_hertz, self.mel_break_frequency_hertz,
            self.mel_bin_width_threshold_factor)
        return (torch.as_tensor(l2m, device=device),
                torch.as_tensor(m2l, device=device))

    def _to_audio_impl(self, spec_and_IF: torch.Tensor,
                       num_samples: Optional[int] = None) -> torch.Tensor:
        """Fused mel inverse + resynthesis: skips the exact inverse pairs
        ``phase -> IF -> cumsum`` and ``0.5 * safelog(mag_sq) -> exp`` of
        the composite ``mel_to_linear`` + linear inverse."""
        _, m2l = self._matrices(spec_and_IF.device)
        x = spec_and_IF.transpose(-1, -2)  # [B, 2, T, F]
        mag_sq = torch.exp(2.0 * x[:, 0]) @ m2l
        mag = torch.sqrt(torch.clamp(mag_sq, min=0.0) + self.safelog_eps)
        phase = torch.cumsum(x[:, 1] * math.pi, dim=-2) @ m2l
        return self._resynth_ri(mag, phase, num_samples)


def get_spectrograms_helper(**kwargs) -> SpectrogramsHelper:
    """Linear or mel helper from a flat kwargs dict (e.g. a stored training
    parameters JSON). Unknown keys are ignored."""
    base = dict(
        fs_hz=kwargs.get("fs_hz", 16000),
        n_fft=kwargs.get("n_fft", 2048),
        hop_length=kwargs.get("hop_length", 512),
        window_length=kwargs.get("window_length", 2048),
    )
    if kwargs.get("use_mel_scale", False):
        return MelSpectrogramsHelper(
            **base,
            lower_edge_hertz=kwargs.get("mel_scale_lower_edge_hertz", 0.0),
            upper_edge_hertz=kwargs.get(
                "mel_scale_upper_edge_hertz", base["fs_hz"] / 2.0),
            mel_break_frequency_hertz=kwargs.get(
                "mel_scale_break_frequency_hertz",
                _MEL_BREAK_FREQUENCY_HERTZ),
            mel_bin_width_threshold_factor=kwargs.get(
                "mel_scale_expand_resolution_factor", 1.5),
        )
    return SpectrogramsHelper(**base)


def make_masked_phase_transform(min_magnitude: float):
    """Zero the IF channel wherever log-magnitude is below
    ``log(min_magnitude)``."""
    log_threshold = float(np.log(min_magnitude))

    def transform(spec_and_IF: torch.Tensor) -> torch.Tensor:
        logmag = spec_and_IF[..., 0:1, :, :]
        if_ = spec_and_IF[..., 1:2, :, :]
        return torch.cat([logmag, torch.where(logmag > log_threshold, if_,
                                              torch.zeros_like(if_))],
                         dim=-3)

    return transform
