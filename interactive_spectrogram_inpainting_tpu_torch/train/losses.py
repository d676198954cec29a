"""Reconstruction and prediction losses of the trainers.

Port of ``interactive_spectrogram_inpainting_tpu/train/losses.py``:

- the multiscale STFT magnitude loss on audio (``MultiscaleSpectralLoss``,
  linear + log terms, averaged over scales) with the DDSP and Jukebox
  presets, and its ``*_fromSpectrogram`` form, which first inverts both
  spectrograms through ``SpectrogramsHelper.to_audio`` and backpropagates
  through the inverse transform;
- ``make_reconstruction_metrics`` (MSE, DDSP and Jukebox as metrics) and
  ``get_reconstruction_criterion``;
- the label-smoothed cross-entropy of the priors and ``mse_loss``.

Every scale whose window is a whole number of hops runs through
``ops/spectral_loss_kernel.py::fused_scale_loss``: the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor. There is no switch
that turns the kernel off on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.spectral_loss_kernel import (ScaleConfig, fused_scale_loss,
                                        reference_scale_loss, scale_eligible)
from ..signal.spectrogram import SpectrogramsHelper

# rows of logits cast to float32 at a time: the loss never holds a float32
# copy of a whole [B, L, n_class] bfloat16 tensor
_CHUNK_ROWS = 4096


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    """Mean squared error; ``reduction="none"`` gives one value per sample
    (the mean over every axis but the first)."""
    sq = (pred - target) ** 2
    if reduction == "none":
        return sq.reshape(sq.shape[0], -1).mean(1)
    return torch.mean(sq)


def _smoothing_weights(n_class: int, smoothing: float):
    sm = smoothing / (n_class - 1) if n_class > 1 else 0.0
    return 1.0 - smoothing - sm, sm


class _SmoothedCrossEntropy(torch.autograd.Function):
    """Per-token smoothed cross-entropy from three float32 reductions over
    the class axis. With ``sm = smoothing / (n_class - 1)`` the target
    distribution is ``one_hot * (1 - smoothing - sm) + sm``, and

        loss = logsumexp(x) - (1 - smoothing - sm) x[target] - sm sum(x)

    The backward recomputes the softmax from the saved logits and the
    log-sum-exp, ``g (softmax(x) - target_dist)`` in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, smoothing):
        n_class = logits.shape[-1]
        x2 = logits.reshape(-1, n_class)
        t = targets.reshape(-1, 1)
        on, sm = _smoothing_weights(n_class, smoothing)
        lse = torch.empty(x2.shape[0], device=logits.device,
                          dtype=torch.float32)
        out = torch.empty_like(lse)
        for s in range(0, x2.shape[0], _CHUNK_ROWS):
            x = x2[s:s + _CHUNK_ROWS].float()
            m = x.max(dim=-1).values
            lse_c = m + torch.log(torch.exp(x - m[:, None]).sum(-1))
            tgt = torch.gather(x, 1, t[s:s + _CHUNK_ROWS])[:, 0]
            lse[s:s + _CHUNK_ROWS] = lse_c
            out[s:s + _CHUNK_ROWS] = lse_c - on * tgt - sm * x.sum(-1)
        ctx.save_for_backward(logits, targets, lse)
        ctx.smoothing = smoothing
        return out.reshape(targets.shape)

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        n_class = logits.shape[-1]
        on, sm = _smoothing_weights(n_class, ctx.smoothing)
        x2 = logits.reshape(-1, n_class)
        t = targets.reshape(-1, 1)
        g = g.reshape(-1)
        dlogits = torch.empty_like(x2)
        for s in range(0, x2.shape[0], _CHUNK_ROWS):
            rows = slice(s, s + _CHUNK_ROWS)
            p = torch.exp(x2[rows].float() - lse[rows, None])
            dist = torch.full_like(p, sm).scatter_(1, t[rows], on + sm)
            dlogits[rows] = (g[rows, None] * (p - dist)).to(logits.dtype)
        return dlogits.reshape(logits.shape), None, None


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.0, class_axis: int = -1,
                         reduction: str = "mean") -> torch.Tensor:
    """Label-smoothed cross-entropy. logits ``[..., n_class]`` (or the class
    axis at ``class_axis``), integer targets shaped like the other axes.
    ``reduction``: 'mean' (a scalar) or 'none' (shaped like ``targets``).
    bfloat16 logits go in as they are: the reductions run in float32 a
    chunk of rows at a time."""
    if class_axis != -1:
        logits = torch.movedim(logits, class_axis, -1)
    per_token = _SmoothedCrossEntropy.apply(
        logits.contiguous(), targets.long(), float(smoothing))
    if reduction == "none":
        return per_token
    return per_token.mean()


# -- spectral reconstruction losses -------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiscaleSpectralLoss:
    """lin_alpha * mean_i d(|S_i|, |S_i|) + log_alpha * mean_i d(log, log):
    the per-scale linear and log losses are averaged over the scales and
    each family weighted by its alpha."""

    n_ffts: Sequence[int]
    hop_lengths: Sequence[int]
    window_lengths: Sequence[int]
    distance: str = "l1"  # 'l1' | 'mse'
    lin_alpha: float = 1.0
    log_alpha: float = 1.0
    log_eps: float = 1e-6
    precision: str = "high"

    def __call__(self, audio_pred: torch.Tensor, audio_target: torch.Tensor,
                 reduction: str = "mean") -> torch.Tensor:
        """[B, L] (or [L]) pred and target -> the loss, a 0-dim tensor
        differentiable in ``audio_pred``; ``reduction="none"`` gives each
        row's loss as if it were a batch of its own, ``[B]``."""
        if audio_pred.dim() == 1:
            audio_pred, audio_target = audio_pred[None], audio_target[None]
        audio_target = audio_target.detach()
        per_row = reduction == "none"
        total = 0.0
        for cfg in self.scale_configs(*audio_pred.shape, per_row=per_row):
            if scale_eligible(cfg.n_fft, cfg.hop, cfg.win, cfg.precision):
                total = total + fused_scale_loss(audio_pred, audio_target,
                                                 cfg, reduction)
            else:
                # the plain formula, differentiated by autograd
                rows = reference_scale_loss(audio_pred, audio_target, cfg,
                                            need_u=False)[0]
                total = total + (rows if per_row else rows.sum())
        return total

    def scale_configs(self, batch: int, length: int, per_row: bool = False
                      ) -> List[ScaleConfig]:
        """Each scale as ``fused_scale_loss`` takes it, with the per-element
        weights ``alpha / (n_scales B frames F)`` (``B`` taken as 1 for
        ``per_row``) that make the sum of the scales' sums the loss."""
        out = []
        for n_fft, hop, win in zip(self.n_ffts, self.hop_lengths,
                                   self.window_lengths):
            frames = 1 + (length - n_fft) // hop
            cells = frames * (n_fft // 2 + 1) * (1 if per_row else batch)
            norm = 1.0 / (len(self.n_ffts) * cells)
            out.append(ScaleConfig(
                n_fft, hop, win, self.distance != "l1",
                float(self.lin_alpha) * norm if self.lin_alpha > 0 else 0.0,
                float(self.log_alpha) * norm if self.log_alpha > 0 else 0.0,
                float(self.log_eps), self.precision))
        return out


def _overlap_hops(window_lengths: Sequence[int],
                  overlap_ratio: float) -> list:
    """``hop = ceil((1 - overlap_ratio) * window)``."""
    return [math.ceil((1.0 - overlap_ratio) * w) for w in window_lengths]


def make_ddsp_loss() -> MultiscaleSpectralLoss:
    """DDSP preset: windows = n_ffts of 64 to 2048, overlap 0.75, L1,
    linear and log terms."""
    n_ffts = [64, 128, 256, 512, 1024, 2048]
    return MultiscaleSpectralLoss(
        n_ffts=n_ffts, hop_lengths=_overlap_hops(n_ffts, 0.75),
        window_lengths=list(n_ffts), distance="l1", lin_alpha=1.0,
        log_alpha=1.0)


def make_jukebox_loss() -> MultiscaleSpectralLoss:
    """Jukebox preset: windows 1200 / 600 / 240 in n_ffts 2048 / 1024 /
    512, overlap 0.8 (hops 240 / 120 / 48), squared distance, linear term
    only."""
    windows = [1200, 600, 240]
    return MultiscaleSpectralLoss(
        n_ffts=[2048, 1024, 512], hop_lengths=_overlap_hops(windows, 0.80),
        window_lengths=windows, distance="mse", lin_alpha=1.0,
        log_alpha=0.0)


def make_spectral_loss_from_spectrogram(
        loss: MultiscaleSpectralLoss, spectrograms_helper: SpectrogramsHelper
) -> Callable[..., torch.Tensor]:
    """The spectral loss on [B, 2, F, T] mel or linear spectrograms: both
    are inverted by ``spectrograms_helper.to_audio`` (``torch.fft``, whose
    backward the loss's gradient runs through) and compared as audio. The
    JAX package also sets the helper's ``dft_precision`` to the loss's
    precision; the port's helper always inverts in float32 through
    ``torch.fft`` and has no such setting."""
    helper = spectrograms_helper

    def fn(spec_pred: torch.Tensor, spec_target: torch.Tensor,
           reduction: str = "mean") -> torch.Tensor:
        audio_pred = helper.to_audio(spec_pred)
        with torch.no_grad():
            audio_target = helper.to_audio(spec_target)
        return loss(audio_pred, audio_target, reduction)

    fn.loss = loss
    fn.spectrograms_helper = helper
    return fn


def make_reconstruction_metrics(
        spectrograms_helper: Optional[SpectrogramsHelper] = None):
    """The per-log-step metric trio: MSE, DDSP and Jukebox of
    (reconstruction, input), whatever the training criterion. Returns
    ``fn(dec, spec, reduction="mean") -> {"metric_MSE": ..., ...}``; without
    a helper only MSE."""
    names = ["MSE"] + (["DDSP", "Jukebox"]
                       if spectrograms_helper is not None else [])
    fns = {name: get_reconstruction_criterion(name, spectrograms_helper)
           for name in names}

    def compute(dec: torch.Tensor, spec: torch.Tensor,
                reduction: str = "mean") -> Dict[str, torch.Tensor]:
        dec = dec.float()
        return {f"metric_{n}": fn(dec, spec, reduction)
                for n, fn in fns.items()}

    return compute


def get_reconstruction_criterion(name: str,
                                 spectrograms_helper: Optional[
                                     SpectrogramsHelper] = None,
                                 precision: Optional[str] = None):
    """'mse' | 'spectral_ddsp' | 'spectral_jukebox' (or the metric names
    'MSE', 'DDSP', 'Jukebox'). ``precision`` sets the spectral losses' DFT
    precision (``--spectral_precision``): 'high' (float32, the default),
    'default' (bfloat16 operands) or 'highest' (float32, through the plain
    ``reference_scale_loss`` under autograd instead of the kernel)."""
    if name in ("mse", "MSE", "L2"):
        return mse_loss
    if name in ("spectral_ddsp", "DDSP"):
        make = make_ddsp_loss
    elif name in ("spectral_jukebox", "Jukebox"):
        make = make_jukebox_loss
    else:
        raise ValueError(f"unknown reconstruction criterion {name}")
    if spectrograms_helper is None:
        raise ValueError(f"the {name} criterion needs a spectrograms helper")
    loss = make()
    if precision is not None:
        loss = dataclasses.replace(loss, precision=precision)
    return make_spectral_loss_from_spectrogram(loss, spectrograms_helper)
