"""Plain reference of playback: the VQ-VAE-2 decode of two codemaps and the
mel inverse with the inverse STFT, in plain PyTorch and NumPy.

Decode: each code is its codebook column; the top map is lifted to the
bottom resolution by stride-2 transposed convolutions (kernel 4, padding
1) and concatenated with the bottom map; the decoder is a 3x3 convolution,
residual blocks ``relu(x) + conv1x1(relu(conv3x3(relu(x))))``, a ReLU and
stride-2 transposed convolutions with ReLUs between them, down to the two
channels (log magnitude, instantaneous frequency) of a mel spectrogram.

Inverse: magnitudes ``sqrt(exp(2 logmag) @ M + eps)`` and phases
``cumsum(pi IF) @ M`` with ``M`` the GANSynth pseudo-inverse of the
expanded mel filterbank (built here by ``mel_matrices``), a zero DC bin,
then the least-squares overlap-add inverse STFT with a periodic Hann window,
centred by ``(window - hop) / 2`` samples. The served WAV is 16-bit PCM:
``round(clip(audio, -1, 1) * 32767)``.

The filterbank functions are frozen copies of the program's
``signal/spectrogram.py`` (``_expanded_mel_edges``,
``linear_to_mel_weight_matrix``, ``mel_to_linear_matrix``); the rest is
written anew.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def _down_channels(channel: int, factor: int) -> Tuple[int, ...]:
    return {16: (channel // 4, channel // 2, 3 * channel // 4, channel),
            8: (channel // 2, channel // 2, channel),
            4: (channel // 2, channel),
            2: (channel // 2,)}[factor]


def parameter_spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter and buffer of the VQ-VAE
    (encoders too: the server loads the whole model), in the names of the
    program's ``state_dict``; lecun-normal kernels, zero biases, unit
    codebooks (``embed_avg`` a copy of ``embed``, zero cluster sizes)."""
    ch = int(cfg["num_hidden_channels"])
    res = int(cfg["num_residual_channels"])
    n_res = int(cfg["n_res_block"])
    dim = int(cfg["embed_dim"])
    n_embed = int(cfg["num_embeddings"])
    f_b = int(cfg["resolution_factors"]["bottom"])
    f_t = int(cfg["resolution_factors"]["top"])
    in_ch = int(cfg["in_channel"])
    var = float(cfg.get("embeddings_initial_variance", 1.0))
    spec = []

    def conv(name, i, o, k):
        spec.append((f"{name}.weight", (o, i, k, k),
                     ("normal", 1.0 / math.sqrt(i * k * k))))
        spec.append((f"{name}.bias", (o,), ("zeros",)))

    def conv_t(name, i, o, k):
        spec.append((f"{name}.weight", (i, o, k, k),
                     ("normal", 1.0 / math.sqrt(i * k * k))))
        spec.append((f"{name}.bias", (o,), ("zeros",)))

    def res_blocks(pre):
        for j in range(n_res):
            conv(f"{pre}.res_blocks.{j}.conv1", ch, res, 3)
            conv(f"{pre}.res_blocks.{j}.conv2", res, ch, 1)

    def encoder(pre, i, factor):
        sched = _down_channels(ch, factor)
        for n, (a, b) in enumerate(zip((i,) + sched[:-1], sched)):
            conv(f"{pre}.downsample.{n}", a, b, 4)
        conv(f"{pre}.conv_out", sched[-1], ch, 3)
        res_blocks(pre)

    def decoder(pre, i, o, factor):
        conv(f"{pre}.conv_in", i, ch, 3)
        res_blocks(pre)
        up = tuple(reversed((o,) + _down_channels(ch, factor)[:-1]))
        for n, (a, b) in enumerate(zip((ch,) + up[:-1], up)):
            conv_t(f"{pre}.upsample.{n}", a, b, 4)

    def codebook(pre):
        spec.append((f"{pre}.embed", (dim, n_embed), ("normal", var ** 0.5)))
        spec.append((f"{pre}.cluster_size", (n_embed,), ("zeros",)))
        spec.append((f"{pre}.embed_avg", (dim, n_embed),
                     ("copy", f"{pre}.embed")))

    encoder("enc_b", in_ch, f_b)
    encoder("enc_t", ch, f_t)
    conv("quantize_conv_t", ch, dim, 1)
    codebook("quantize_t")
    decoder("dec_t", dim, dim, f_t)
    conv("quantize_conv_b", dim + ch, dim, 1)
    codebook("quantize_b")
    for n in range(int(math.log2(f_t))):
        conv_t(f"upsample_top_to_bottom.layers.{n}", dim, dim, 4)
    decoder("dec", 2 * dim, in_ch, f_b)
    return spec


def decode(p, cfg: dict, code_t: torch.Tensor, code_b: torch.Tensor
           ) -> torch.Tensor:
    """Codemaps [B, f, t] -> spectrogram [B, 2, F, T] (float32)."""
    def lookup(name, code):
        return p[f"{name}.embed"].t()[code.long()].permute(0, 3, 1, 2)

    def conv(x, name, padding):
        return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"],
                        padding=padding)

    def up(x, name):
        return F.conv_transpose2d(x, p[f"{name}.weight"], p[f"{name}.bias"],
                                  stride=2, padding=1)

    top = lookup("quantize_t", code_t)
    for n in range(int(math.log2(int(cfg["resolution_factors"]["top"])))):
        top = up(top, f"upsample_top_to_bottom.layers.{n}")
    h = conv(torch.cat([top, lookup("quantize_b", code_b)], dim=1),
             "dec.conv_in", 1)
    for j in range(int(cfg["n_res_block"])):
        y = torch.relu(h)
        h = y + conv(torch.relu(conv(y, f"dec.res_blocks.{j}.conv1", 1)),
                     f"dec.res_blocks.{j}.conv2", 0)
    h = torch.relu(h)
    n_up = len(_down_channels(int(cfg["num_hidden_channels"]),
                              int(cfg["resolution_factors"]["bottom"])))
    for n in range(n_up):
        h = up(h, f"dec.upsample.{n}")
        if n != n_up - 1:
            h = torch.relu(h)
    return h


# -- the mel filterbank (frozen copies) ----------------------------------------

def hertz_to_mel(frequencies_hertz, break_frequency_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(
        np.asarray(frequencies_hertz, dtype=np.float64)
        / break_frequency_hertz)


def mel_to_hertz(mels, break_frequency_hertz):
    return break_frequency_hertz * np.expm1(
        np.asarray(mels, dtype=np.float64) / _MEL_HIGH_FREQUENCY_Q)


def _expanded_mel_edges(num_mel_bins, num_linear_bins, fs_hz,
                        lower_edge_hertz, upper_edge_hertz,
                        break_frequency_hertz, bin_width_threshold_factor):
    linear_bin_width = (fs_hz / 2.0) / num_linear_bins
    min_width = linear_bin_width / bin_width_threshold_factor
    num_edges = num_mel_bins + 2

    def edges_with_k(k):
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


def linear_to_mel_weight_matrix(num_mel_bins, num_linear_bins, fs_hz,
                                lower_edge_hertz, upper_edge_hertz,
                                break_frequency_hertz,
                                bin_width_threshold_factor):
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


def mel_to_linear_matrix(l2m):
    m = l2m.astype(np.float64)
    mt = m.T
    d = (m @ mt).sum(axis=0)
    d = np.where(np.abs(d) > 1e-8, 1.0 / np.maximum(d, 1e-12), d)
    return (mt * d[None, :]).astype(np.float32)


def mel_to_linear(spec: dict) -> np.ndarray:
    """The [F, F] mel -> linear matrix of the configuration's front end."""
    bins = int(spec["n_fft"]) // 2
    fs = float(spec["fs_hz"])
    l2m = linear_to_mel_weight_matrix(
        bins, bins, fs, float(spec.get("mel_scale_lower_edge_hertz", 0.0)),
        float(spec.get("mel_scale_upper_edge_hertz", fs / 2.0)),
        float(spec.get("mel_scale_break_frequency_hertz",
                       _MEL_BREAK_FREQUENCY_HERTZ)),
        float(spec.get("mel_scale_expand_resolution_factor", 1.5)))
    return mel_to_linear_matrix(l2m)


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()


def to_audio(spec_and_if: torch.Tensor, spec: dict) -> torch.Tensor:
    """[B, 2, F, T] mel log magnitude + IF -> [B, T * hop] audio."""
    n_fft = int(spec["n_fft"])
    hop = int(spec["hop_length"])
    win = int(spec["window_length"])
    eps = 1e-6
    if not spec.get("use_mel_scale", False):
        raise ValueError("the reference covers the mel front end")
    m2l = torch.as_tensor(mel_to_linear(spec), device=spec_and_if.device)
    logmag = spec_and_if[:, 0].transpose(-1, -2)  # [B, T, F]
    inst_f = spec_and_if[:, 1].transpose(-1, -2)
    mag = torch.sqrt((torch.exp(2.0 * logmag) @ m2l).clamp_min(0.0) + eps)
    phase = torch.cumsum(inst_f * math.pi, dim=-2) @ m2l
    stft = torch.polar(mag, phase)
    stft = F.pad(stft, (1, 0))  # the DC bin
    frames = stft.shape[-2]
    window = hann(win, stft.device)
    framed = torch.fft.irfft(stft, n=n_fft, dim=-1)[..., :win] * window
    total = (frames - 1) * hop + win
    out = F.fold(framed.transpose(1, 2), (1, total), (1, win),
                 stride=(1, hop))[:, 0, 0]
    norm = F.fold((window ** 2)[None, :, None].expand(1, win, frames),
                  (1, total), (1, win), stride=(1, hop))[:, 0, 0]
    out = out / norm.clamp_min(1e-11)
    start = (win - hop) // 2
    return out[:, start: start + frames * hop]


def pcm16(audio: np.ndarray) -> np.ndarray:
    """The 16-bit samples a WAV of ``audio`` holds."""
    safe = np.nan_to_num(np.asarray(audio, np.float32), nan=0.0,
                         posinf=1.0, neginf=-1.0)
    return np.round(np.clip(safe, -1.0, 1.0) * 32767.0).astype(np.int16)
