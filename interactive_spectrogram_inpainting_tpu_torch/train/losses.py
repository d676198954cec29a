"""Training losses of the priors.

Port of the prior half of ``interactive_spectrogram_inpainting_tpu/train/losses.py``
(the spectral reconstruction losses of the VQ-VAE trainer are not ported
yet).
"""

from __future__ import annotations

import torch

# rows of logits cast to float32 at a time: the loss never holds a float32
# copy of a whole [B, L, n_class] bfloat16 tensor
_CHUNK_ROWS = 4096


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


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
