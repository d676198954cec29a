"""Plain reference of a VQ-VAE-2 training step at the flagship flags, in
plain PyTorch, float32 with TF32 off.

One step, on a batch of audio ``[B, L]``:

1. the mel spectrogram of the audio (log magnitude and instantaneous
   frequency, ``[B, 2, F, T]``): frames of ``window_length`` samples every
   ``hop_length``, the audio padded by ``(window - hop) / 2`` on the left
   and on the right up to a frame count that is a multiple of 32, a
   periodic Hann window, the real FFT without its DC bin; ``log(|X| +
   1e-6)`` and the frame-to-frame phase difference wrapped into (-pi, pi]
   over pi (the first frame keeps its phase), then both warped to the
   expanded mel scale: ``0.5 log(|X|^2 M + 1e-6)`` and the phase
   difference of ``cumsum(pi IF) M``;
2. the normalizer ``a x + b`` per channel, ``a = 2 / (max - min)``,
   ``b = -(max + min) / (max - min)`` from the dataset's ranges;
3. the encoder: stride-2 4x4 convolutions with ReLUs (down to a sixteenth
   for the bottom map, then a half for the top), a 3x3 convolution,
   residual blocks ``relu(x) + conv1x1(relu(conv3x3(relu(x))))`` and a
   ReLU; a 1x1 convolution to the code dimension;
4. the EMA quantizer: each row's nearest code, the codebook's usage
   perplexity, the commitment term ``mean((q - z)^2)`` with ``q`` held
   constant, the straight-through output ``z + (q - z)`` (the difference
   held constant), and the EMA update of the cluster sizes and code sums
   (decay 0.99, Laplace smoothing 1e-5); the top map is decoded to the
   bottom resolution and concatenated with the bottom encoding before the
   bottom quantizer;
5. the decoder (a 3x3 convolution, the residual blocks, a ReLU and stride-2
   4x4 transposed convolutions with ReLUs between them) on the top map
   lifted to the bottom resolution by transposed convolutions and
   concatenated with the bottom map, then the inverse of the normalizer;
6. the Jukebox loss on audio: both spectrograms inverted by
   ``reference/vqvae.py::to_audio`` (the mel inverse and the inverse STFT;
   the target's without gradient), then at each of three scales (windows
   1200 / 600 / 240 samples in FFTs of 2048 / 1024 / 512, hops 240 / 120 /
   48) the mean squared distance of the STFT magnitudes, averaged over the
   scales; plus 0.25 times the two quantizers' commitment terms;
7. the gradient by autograd, then Adam written out by hand (beta 0.9 /
   0.999, eps 1e-8, the bias corrections of ``torch.optim.Adam``);
8. the metric trio of the step's reconstruction, without gradient: the
   mean squared error of the output spectrogram against the input's, the
   DDSP loss (FFTs of 64 to 2048 points, each its own window, hops of a
   quarter of it, the L1 distance of the magnitudes plus that of their
   logarithms ``log(|X| + 1e-6)``, each averaged over the scales) and the
   Jukebox loss of step 6, both on the audio of step 6.

``statistics`` gives the normalizer's ranges (step 2) of a dataset's
spectrograms: each channel's smallest and largest value.

Departures from the published descriptions (VQ-VAE-2, Razavi et al. 2019;
the Jukebox spectral loss, Dhariwal et al. 2020), each the reference
repository's or the port's choice that this reference follows:

- the nearest code drops ``||z||^2``, constant in the code;
- the EMA counts start at zero, so a code no row took in the first steps
  grows by ``1 / 1e-5`` (no dead-code restarts: usage threshold 1.0);
- Jukebox's distance is the squared one, averaged over every (frame,
  frequency) cell and over the scales, linear magnitudes only; the
  magnitude is ``sqrt(re^2 + im^2 + 1e-12)``; each frame is the window's
  samples at ``(n_fft - window) / 2 + f hop`` without centring, zero-padded
  at its end to ``n_fft``;
- the loss compares audio that the mel inverse gives for both spectrograms,
  not the note's own audio;
- the gradient of the Jukebox loss is taken in float32 throughout, where
  the program's spectral-loss kernel (``--spectral_precision high``) keeps
  its one intermediate, ``dL/d|X| X / |X|`` a frame and frequency, in
  bfloat16 between its forward and its backward, as the TPU kernel it
  ports does: the comparison's gradient gap holds that rounding too.

It imports nothing of the program: the decoder's lift to audio, the mel
matrices and the window come from ``reference/vqvae.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import vqvae as ref_vqvae

JUKEBOX = ((2048, 240, 1200), (1024, 120, 600), (512, 48, 240))
DDSP = tuple((n, n // 4, n) for n in (64, 128, 256, 512, 1024, 2048))
LOG_EPS = 1e-6
DECAY = 0.99
EMA_EPS = 1e-5
SAFELOG_EPS = 1e-6
FRAMES_MULTIPLE = 32
BETAS = (0.9, 0.999)


# -- the input ----------------------------------------------------------------

def instantaneous_frequency(phase: torch.Tensor) -> torch.Tensor:
    """[..., T, F] phase -> its wrapped difference over frames, over pi;
    the first frame keeps its phase."""
    d = torch.diff(phase, dim=-2)
    d = d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))
    return torch.cat([phase[..., :1, :], d], dim=-2) / math.pi


def mel_matrix(spec: dict) -> np.ndarray:
    """The [F, F] linear -> mel filterbank of the configuration."""
    bins = int(spec["n_fft"]) // 2
    fs = float(spec["fs_hz"])
    return ref_vqvae.linear_to_mel_weight_matrix(
        bins, bins, fs, float(spec.get("mel_scale_lower_edge_hertz", 0.0)),
        float(spec.get("mel_scale_upper_edge_hertz", fs / 2.0)),
        float(spec.get("mel_scale_break_frequency_hertz", 700.0)),
        float(spec.get("mel_scale_expand_resolution_factor", 1.5)))


def spectrogram(audio: torch.Tensor, spec: dict) -> torch.Tensor:
    """[B, L] audio -> [B, 2, F, T] mel log magnitude and IF."""
    n_fft = int(spec["n_fft"])
    hop = int(spec["hop_length"])
    win = int(spec["window_length"])
    length = audio.shape[-1]
    frames = -(-length // hop)
    frames = -(-frames // FRAMES_MULTIPLE) * FRAMES_MULTIPLE
    left = (win - hop) // 2
    right = (frames - 1) * hop + win - left - length
    x = F.pad(audio.float(), (left, right)).unfold(-1, win, hop)[
        ..., :frames, :] * ref_vqvae.hann(win, audio.device)
    stft = torch.fft.rfft(x, n=n_fft, dim=-1)[..., 1:]  # [B, T, F]
    re, im = stft.real, stft.imag
    logmag = torch.log(torch.sqrt(re * re + im * im) + SAFELOG_EPS)
    inst_f = instantaneous_frequency(torch.atan2(im, re))
    l2m = torch.as_tensor(mel_matrix(spec), device=audio.device)
    logmel = 0.5 * torch.log(torch.exp(2.0 * logmag) @ l2m + SAFELOG_EPS)
    mel_if = instantaneous_frequency(
        torch.cumsum(inst_f * math.pi, dim=-2) @ l2m)
    return torch.stack([logmel, mel_if], dim=1).transpose(-1, -2)


def statistics(batches, spec: dict) -> Dict[str, float]:
    """The ranges of each channel of the spectrograms of the audio batches
    ``[B, L]``, under the normalizer's names."""
    lo = hi = None
    for audio in batches:
        s = spectrogram(audio, spec)
        s_lo, s_hi = s.amin(dim=(0, 2, 3)), s.amax(dim=(0, 2, 3))
        lo = s_lo if lo is None else torch.minimum(lo, s_lo)
        hi = s_hi if hi is None else torch.maximum(hi, s_hi)
    (lo_mag, lo_if), (hi_mag, hi_if) = lo.tolist(), hi.tolist()
    return {"min_logmag": lo_mag, "max_logmag": hi_mag,
            "min_IF": lo_if, "max_IF": hi_if}


def normalizer(stats: Dict[str, float], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) [2, 1, 1] of the per-channel map ``a x + b``."""
    mag = max(stats["max_logmag"] - stats["min_logmag"], 1e-8)
    inst = max(stats["max_IF"] - stats["min_IF"], 1e-8)
    a = torch.tensor([2.0 / mag, 2.0 / inst], device=device)
    b = torch.tensor([-(stats["max_logmag"] + stats["min_logmag"]) / mag,
                      -(stats["max_IF"] + stats["min_IF"]) / inst],
                     device=device)
    return a.reshape(2, 1, 1), b.reshape(2, 1, 1)


# -- the model ----------------------------------------------------------------

def _conv(p, x, name, stride=1, padding=0):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"],
                    stride=stride, padding=padding)


def _up(p, x, name):
    return F.conv_transpose2d(x, p[f"{name}.weight"], p[f"{name}.bias"],
                              stride=2, padding=1)


def _res_blocks(p, h, pre, n_res):
    for j in range(n_res):
        y = torch.relu(h)
        h = y + _conv(p, torch.relu(_conv(p, y, f"{pre}.res_blocks.{j}.conv1",
                                          padding=1)),
                      f"{pre}.res_blocks.{j}.conv2")
    return h


def encoder(p, cfg: dict, x, pre: str, factor: int):
    h = x
    for n in range(len(ref_vqvae._down_channels(
            int(cfg["num_hidden_channels"]), factor))):
        h = torch.relu(_conv(p, h, f"{pre}.downsample.{n}", 2, 1))
    h = _conv(p, h, f"{pre}.conv_out", padding=1)
    return torch.relu(_res_blocks(p, h, pre, int(cfg["n_res_block"])))


def decoder(p, cfg: dict, x, pre: str, factor: int):
    h = _conv(p, x, f"{pre}.conv_in", padding=1)
    h = torch.relu(_res_blocks(p, h, pre, int(cfg["n_res_block"])))
    n_up = len(ref_vqvae._down_channels(int(cfg["num_hidden_channels"]),
                                        factor))
    for n in range(n_up):
        h = _up(p, h, f"{pre}.upsample.{n}")
        if n != n_up - 1:
            h = torch.relu(h)
    return h


def quantize(p, z: torch.Tensor, pre: str, train: bool = True):
    """EMA quantizer of ``z`` [B, dim, h, w] with the codebook of ``pre``;
    -> (straight-through output, commitment term, ids [B, h, w],
    perplexity). With ``train`` it updates ``p``'s codebook tensors in
    place from the codes it chose, after choosing them."""
    embed = p[f"{pre}.embed"]
    dim, n_embed = embed.shape
    z_last = z.permute(0, 2, 3, 1)
    flat = z_last.reshape(-1, dim).detach()
    scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
    ids = torch.argmin(scores, dim=1)
    onehot = F.one_hot(ids, n_embed).float()
    counts = onehot.sum(0)
    q = embed.t()[ids].reshape(z_last.shape).permute(0, 3, 1, 2)
    if train:
        with torch.no_grad():
            size = p[f"{pre}.cluster_size"]
            avg = p[f"{pre}.embed_avg"]
            size.mul_(DECAY).add_(counts, alpha=1.0 - DECAY)
            avg.mul_(DECAY).add_(flat.t() @ onehot, alpha=1.0 - DECAY)
            n = size.sum()
            smoothed = (size + EMA_EPS) / (n + n_embed * EMA_EPS) * n
            embed.copy_(avg / smoothed[None])
    commitment = ((q.detach() - z) ** 2).mean()
    probs = counts / flat.shape[0]
    perplexity = torch.exp(-(probs * torch.log(probs.clamp(min=1e-7))).sum())
    return (z + (q - z).detach(), commitment,
            ids.reshape(z_last.shape[:-1]), perplexity)


def forward(p, cfg: dict, spec: torch.Tensor, norm, train: bool = True):
    """Normalized input -> (output spectrogram [B, 2, F, T], the summed
    commitment terms, (top ids, bottom ids), (top, bottom) perplexity)."""
    a, b = norm
    f_b = int(cfg["resolution_factors"]["bottom"])
    f_t = int(cfg["resolution_factors"]["top"])
    enc_b = encoder(p, cfg, spec * a + b, "enc_b", f_b)
    enc_t = encoder(p, cfg, enc_b, "enc_t", f_t)
    q_t, diff_t, id_t, perp_t = quantize(
        p, _conv(p, enc_t, "quantize_conv_t"), "quantize_t", train)
    dec_t = decoder(p, cfg, q_t, "dec_t", f_t)
    q_b, diff_b, id_b, perp_b = quantize(
        p, _conv(p, torch.cat([dec_t, enc_b], 1), "quantize_conv_b"),
        "quantize_b", train)
    up = q_t
    for n in range(int(math.log2(f_t))):
        up = _up(p, up, f"upsample_top_to_bottom.layers.{n}")
    dec = decoder(p, cfg, torch.cat([up, q_b], 1), "dec", f_b)
    return (dec - b) / a, diff_t + diff_b, (id_t, id_b), (perp_t, perp_b)


# -- the loss -----------------------------------------------------------------

def stft_magnitude(audio: torch.Tensor, n_fft: int, hop: int, win: int
                   ) -> torch.Tensor:
    frames = 1 + (audio.shape[-1] - n_fft) // hop
    start = (n_fft - win) // 2
    x = audio[:, start:start + (frames - 1) * hop + win].unfold(-1, win, hop)
    stft = torch.fft.rfft(x * ref_vqvae.hann(win, audio.device), n=n_fft,
                          dim=-1)
    return torch.sqrt(stft.real ** 2 + stft.imag ** 2 + 1e-12)


def jukebox_loss(pred: torch.Tensor, target: torch.Tensor,
                 scales: Sequence[Tuple[int, int, int]] = JUKEBOX
                 ) -> torch.Tensor:
    total = 0.0
    for n_fft, hop, win in scales:
        d = (stft_magnitude(pred, n_fft, hop, win)
             - stft_magnitude(target, n_fft, hop, win))
        total = total + (d * d).mean()
    return total / len(scales)


def ddsp_loss(pred: torch.Tensor, target: torch.Tensor,
              scales: Sequence[Tuple[int, int, int]] = DDSP) -> torch.Tensor:
    total = 0.0
    for n_fft, hop, win in scales:
        mag_p = stft_magnitude(pred, n_fft, hop, win)
        mag_t = stft_magnitude(target, n_fft, hop, win)
        total = total + (mag_p - mag_t).abs().mean() + (
            torch.log(mag_p + LOG_EPS) - torch.log(mag_t + LOG_EPS)
        ).abs().mean()
    return total / len(scales)


def trio(dec: torch.Tensor, target: torch.Tensor, pred_audio: torch.Tensor,
         target_audio: torch.Tensor) -> Dict[str, float]:
    """The metric trio of a reconstruction, under the program's names."""
    with torch.no_grad():
        dec, pred_audio = dec.detach(), pred_audio.detach()
        return {"metric_MSE": float(((dec - target) ** 2).mean()),
                "metric_DDSP": float(ddsp_loss(pred_audio, target_audio)),
                "metric_Jukebox": float(jukebox_loss(pred_audio,
                                                     target_audio))}


# -- training -----------------------------------------------------------------

def leaves(p: Dict[str, torch.Tensor]) -> List[str]:
    """The trained tensors: every one but the codebooks' state."""
    return [k for k in p if k.split(".")[-1] not in
            ("embed", "cluster_size", "embed_avg")]


def train(p: Dict[str, torch.Tensor], cfg: dict, spec: dict,
          stats: Dict[str, float], batches: Sequence[torch.Tensor],
          lr: float, eps: float, latent_weight: float,
          scales: Sequence[Tuple[int, int, int]] = JUKEBOX) -> Dict:
    """Train ``p`` (updated in place) on each audio batch in turn; -> each
    step's loss, the first step's gradients, each step's ids and each
    step's metric trio."""
    names = leaves(p)
    for k in names:
        p[k].requires_grad_(True)
    m = {k: torch.zeros_like(p[k]) for k in names}
    s = {k: torch.zeros_like(p[k]) for k in names}
    beta1, beta2 = BETAS
    norm = normalizer(stats, batches[0].device)
    losses, ids, trios, first = [], [], [], None
    for t, audio in enumerate(batches, start=1):
        with torch.no_grad():
            target = spectrogram(audio, spec)
        dec, commitment, codes, _ = forward(p, cfg, target, norm)
        pred_audio = ref_vqvae.to_audio(dec, spec)
        with torch.no_grad():
            target_audio = ref_vqvae.to_audio(target, spec)
        loss = (jukebox_loss(pred_audio, target_audio, scales)
                + latent_weight * commitment)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        ids.append(codes)
        trios.append(trio(dec, target, pred_audio, target_audio))
        with torch.no_grad():
            if t == 1:
                first = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                s[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (s[k].sqrt() / math.sqrt(1 - beta2 ** t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - beta1 ** t))
        del dec, loss, grads, pred_audio
    for k in names:
        p[k].requires_grad_(False)
    return {"loss": losses, "grad": first, "ids": ids, "trio": trios}
