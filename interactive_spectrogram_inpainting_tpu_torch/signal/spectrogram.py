"""GANSynth-style invertible spectrogram transforms.

Port of ``interactive_spectrogram_inpainting_tpu/signal/spectrogram.py``:

    audio -> STFT -> (log magnitude, instantaneous frequency)   [B, 2, F, T]
    [B, 2, F, T] -> phase integration -> iSTFT -> audio

for the linear helper and the mel-warped one (forward ``linear_to_mel``,
inverse ``mel_to_linear`` and the fused mel inverse
``MelSpectrogramsHelper._to_audio_impl``), plus the expanded mel filterbank
matrices. The STFT and iSTFT run through ``torch.fft``; the JAX package's
DFT-matmul STFT core and its FFT fallback device existed only for a TPU
backend without a complex FFT and are not carried over. The time axis is
padded up to a multiple of ``time_frames_multiple`` (32) so the VQ-VAE's
total downsampling divides it evenly.

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


def instantaneous_frequency(phase_angle: torch.Tensor,
                            time_axis: int = -1) -> torch.Tensor:
    """Finite difference of the unwrapped phase, in units of pi. The first
    frame keeps the raw initial phase (GANSynth convention), so that
    ``cumsum(IF * pi)`` recovers a phase equal to the original modulo 2 pi."""
    dphase = torch.diff(phase_angle, dim=time_axis)
    # wrap the finite difference into (-pi, pi]
    dphase = dphase - 2.0 * math.pi * torch.round(dphase / (2.0 * math.pi))
    first = phase_angle.narrow(time_axis, 0, 1)
    return torch.cat([first, dphase], dim=time_axis) / math.pi


@dataclasses.dataclass(frozen=True)
class SpectrogramsHelper:
    """Invertible linear-frequency log-magnitude + IF transform."""

    fs_hz: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    window_length: int = 2048
    safelog_eps: float = 1e-6
    # the frame count is padded up to a multiple of this (125 -> 128 frames
    # for 4 s at hop 512)
    time_frames_multiple: int = 32

    @property
    def num_freq_bins(self) -> int:
        return self.n_fft // 2  # the DC bin is discarded

    @property
    def _pad_left(self) -> int:
        return (self.window_length - self.hop_length) // 2

    def num_frames(self, num_samples: int) -> int:
        frames = int(math.ceil(num_samples / self.hop_length))
        m = self.time_frames_multiple
        return ((frames + m - 1) // m) * m

    def num_samples(self, num_frames: int) -> int:
        """Audio length decoded from a spectrogram with ``num_frames``."""
        return num_frames * self.hop_length

    def _pad_right(self, num_samples: int) -> int:
        total = ((self.num_frames(num_samples) - 1) * self.hop_length
                 + self.window_length)
        return total - self._pad_left - num_samples

    def safelog(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(x + self.safelog_eps)

    def _frame(self, audio: torch.Tensor) -> torch.Tensor:
        """[..., num_samples] -> windowed frames [..., T, n_fft]."""
        num_samples = audio.shape[-1]
        padded = torch.nn.functional.pad(
            audio, (self._pad_left, self._pad_right(num_samples)))
        frames = self.num_frames(num_samples)
        framed = padded.unfold(-1, self.window_length,
                               self.hop_length)[..., :frames, :]
        window = torch.as_tensor(_hann_window(self.window_length),
                                 device=audio.device)
        framed = framed * window
        if self.n_fft > self.window_length:
            framed = torch.nn.functional.pad(
                framed, (0, self.n_fft - self.window_length))
        return framed

    def stft(self, audio: torch.Tensor) -> torch.Tensor:
        """[..., num_samples] -> complex [..., T, n_fft // 2 + 1]."""
        return torch.fft.rfft(self._frame(audio.float()), n=self.n_fft,
                              dim=-1)

    def istft(self, stfts: torch.Tensor, num_samples: int) -> torch.Tensor:
        """complex [..., T, n_fft // 2 + 1] -> [..., num_samples]."""
        return self._istft_ri(stfts.real, stfts.imag, num_samples)

    def to_spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, num_samples] (or [num_samples]) -> [B, 2, F, T] mag + IF."""
        squeeze = audio.dim() == 1
        if squeeze:
            audio = audio[None]
        spec = self._to_spectrogram_impl(audio)
        return spec[0] if squeeze else spec

    def _to_spectrogram_impl(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.stft(audio)[..., 1:]  # discard DC -> [B, T, F]
        re, im = x.real, x.imag
        logmag = self.safelog(torch.sqrt(re * re + im * im))
        if_ = instantaneous_frequency(torch.atan2(im, re), time_axis=-2)
        return torch.stack([logmag, if_], dim=1).transpose(-1, -2)

    def from_wavfile(self, path, duration_n: Optional[int] = None,
                     device=None) -> torch.Tensor:
        """Load a wav file (resampled to fs_hz) and return [1, 2, F, T]."""
        from ..data.wav import read_wav, resample

        audio, fs = read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=0)
        if fs != self.fs_hz:
            audio = resample(audio, fs, self.fs_hz)
        if duration_n is not None:
            if audio.shape[-1] < duration_n:
                audio = np.pad(audio, (0, duration_n - audio.shape[-1]))
            audio = audio[:duration_n]
        return self.to_spectrogram(torch.as_tensor(
            np.ascontiguousarray(audio, np.float32), device=device)[None])

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


@functools.lru_cache(maxsize=8)
def _mel_tensors(device: torch.device, *key
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two matrices as tensors on ``device``, uploaded once."""
    l2m, m2l = _mel_matrices(*key)
    return (torch.as_tensor(l2m, device=device),
            torch.as_tensor(m2l, device=device))


@dataclasses.dataclass(frozen=True)
class MelSpectrogramsHelper(SpectrogramsHelper):
    """Mel-warped variant; shape-preserving (mel bins == linear bins)."""

    lower_edge_hertz: float = 0.0
    upper_edge_hertz: float = 8000.0
    mel_break_frequency_hertz: float = _MEL_BREAK_FREQUENCY_HERTZ
    mel_bin_width_threshold_factor: float = 1.5

    def _matrices(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return _mel_tensors(
            torch.device("cpu" if device is None else device),
            self.num_freq_bins, self.fs_hz, self.lower_edge_hertz,
            self.upper_edge_hertz, self.mel_break_frequency_hertz,
            self.mel_bin_width_threshold_factor)

    def _to_spectrogram_impl(self, audio: torch.Tensor) -> torch.Tensor:
        return self.linear_to_mel(
            SpectrogramsHelper._to_spectrogram_impl(self, audio))

    def linear_to_mel(self, spec_and_IF: torch.Tensor) -> torch.Tensor:
        """[..., 2, F, T] linear logmag + IF -> mel logmag + IF."""
        l2m, _ = self._matrices(spec_and_IF.device)
        logmag = spec_and_IF[..., 0, :, :].transpose(-1, -2)  # [..., T, F]
        if_ = spec_and_IF[..., 1, :, :].transpose(-1, -2)
        logmelmag = 0.5 * self.safelog(torch.exp(2.0 * logmag) @ l2m)
        mel_phase = torch.cumsum(if_ * math.pi, dim=-2) @ l2m
        mel_if = instantaneous_frequency(mel_phase, time_axis=-2)
        return torch.stack([logmelmag, mel_if], dim=-3).transpose(-1, -2)

    def mel_to_linear(self, mel_spec_and_IF: torch.Tensor) -> torch.Tensor:
        _, m2l = self._matrices(mel_spec_and_IF.device)
        logmelmag = mel_spec_and_IF[..., 0, :, :].transpose(-1, -2)
        mel_if = mel_spec_and_IF[..., 1, :, :].transpose(-1, -2)
        mag_sq = torch.exp(2.0 * logmelmag) @ m2l
        logmag = 0.5 * self.safelog(torch.clamp(mag_sq, min=0.0))
        phase = torch.cumsum(mel_if * math.pi, dim=-2) @ m2l
        if_ = instantaneous_frequency(phase, time_axis=-2)
        return torch.stack([logmag, if_], dim=-3).transpose(-1, -2)

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
