"""One scale of the multiscale STFT loss and its gradient (hand-written CUDA
for sm_90a).

Replaces the Pallas kernels of
``interactive_spectrogram_inpainting_tpu/ops/spectral_loss_kernel.py``
(``fused_scale_loss``, summed over scales by ``fused_multiscale_loss``): for
pred and target audio ``[B, L]`` float32 and a static ``ScaleConfig``
``(n_fft, hop, win, mse, lin_w, log_w, log_eps, precision)``,

    frames = 1 + (L - n_fft) // hop,   start = (n_fft - win) // 2
    ri[b, f, k] = sum_{n < win} x[b, start + f hop + n] wb[n, k]
    mag = sqrt(re^2 + im^2 + 1e-12)
    loss = sum lin_w d(mag_p, mag_t) + log_w d(log(mag_p + eps), log(mag_t + eps))

(``center=False``, no boundary padding; ``wb [win, 2F]`` is the rDFT basis
of ``F = n_fft // 2 + 1`` frequencies with the periodic Hann window folded
into its rows, built from exact integer angles ``(n k) mod n_fft``; ``d`` the
L1 or the squared distance; ``lin_w``, ``log_w`` per-element weights). The
forward also writes the bfloat16 residual ``U = dL/dmag_p (re_p, im_p) /
mag_p [B, frames, 2F]``, the one intermediate that reaches device memory,
and only when a gradient is wanted; the backward is the transposed STFT of
``U`` (needs ``win % hop == 0``). The target gets no gradient.

``fused_scale_loss`` is a ``torch.autograd.Function`` over the two halves
``scale_loss_forward`` / ``scale_loss_backward``, which launch
``csrc/spectral_loss.cu`` for CUDA tensors and run ``reference_scale_loss``
/ ``reference_scale_loss_backward`` (the same formula in plain PyTorch, U
rounded to bfloat16 where the kernel rounds it) for CPU tensors, never
falling back from one to the other. The kernel's sums are taken in a fixed
order without float atomics: two calls give the same bits. Each half's
``launches`` counts its calls that reached the GPU.

Two routes, fixed by the shape and the precision alone (``fft_route``):
``"high"`` with ``n_fft`` a power of two from 64 to 4096 (every scale of
the DDSP and Jukebox presets) runs as an FFT in shared memory, pred and
target packed as one complex signal; the backward is an inverse real FFT
of U per frame (two frames a complex transform) and an overlap-add.
``reference_scale_loss_fft`` / ``reference_scale_loss_fft_backward`` take
the same steps in ``torch.fft`` (the tests' and ``chip_smoke.py``'s oracle
of that route); ``reference_scale_loss_float64`` evaluates the formula in
float64 (their accuracy reference). Every other eligible scale runs the
DFT product.

Precision: ``"high"`` computes in float32 (an FFT, or float32 FMA on the
DFT route: tighter than the 3-pass bfloat16 product it stands for);
``"default"`` rounds the audio and the basis to bfloat16 first (the 1-pass
product, DFT route only: an FFT cannot round its basis). ``scale_eligible``
says which scales the kernel takes: ``win % hop == 0`` and one of those two
precisions. The others (``"highest"``, or a window that is not a whole
number of hops) go through ``reference_scale_loss`` under autograd in
``train/losses.py``, as the JAX package sends them to XLA. The JAX kernel's
floor of hop >= 48 was its 128-lane padding rule and is not carried over:
DDSP's 64- and 128-sample scales run in the kernel too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .common import check_cuda, ptr, raise_on_error, struct_type

# frames and frequencies of a DFT-route forward block (kFrames, kFreqs in
# the source)
FWD_FRAMES = 64
FWD_FREQS = 64
# complex values of an FFT-route block, at least (kBlockValues)
FFT_BLOCK_VALUES = 2048
FFT_SIZES = tuple(2 ** n for n in range(6, 13))


class ScaleConfig(NamedTuple):
    n_fft: int
    hop: int
    win: int
    mse: bool
    lin_w: float
    log_w: float
    log_eps: float
    precision: str = "high"


_SpectralParams = struct_type(
    "SpectralParams",
    pointers=("pred", "target", "basis", "grad", "u_in", "u", "partial",
              "rows", "total", "d_pred", "window", "twiddle", "frame_grad"),
    ints=("batch", "length", "hop", "win", "frames", "n_freq", "start",
          "mse", "round_bf16", "n_fft"),
    floats=("lin_w", "log_w", "log_eps"))


def scale_eligible(n_fft: int, hop: int, win: int, precision: str) -> bool:
    """Whether one (n_fft, hop, win) scale runs through ``fused_scale_loss``."""
    return (0 < win <= n_fft and hop > 0 and win % hop == 0
            and precision in ("high", "default"))


def fft_route(cfg: ScaleConfig) -> bool:
    """Whether an eligible scale runs as an FFT (else as the DFT product):
    precision 'high' and n_fft a power of two from 64 to 4096."""
    return cfg.precision == "high" and cfg.n_fft in FFT_SIZES


def fft_frames_per_block(n_fft: int) -> int:
    """Frames of an FFT-route forward block (two per transform backward)."""
    return max(n_fft, FFT_BLOCK_VALUES) // n_fft


def frame_geometry(length: int, n_fft: int, hop: int, win: int
                   ) -> Tuple[int, int]:
    """(frames, start) of a ``center=False`` STFT of ``length`` samples."""
    frames = 1 + (length - n_fft) // hop
    if length < n_fft or frames < 1:
        raise ValueError(f"audio too short for center=False STFT: {length} "
                         f"samples < n_fft={n_fft}")
    return frames, (n_fft - win) // 2


@functools.lru_cache(maxsize=None)
def _basis_numpy(n_fft: int, win: int, round_bf16: bool) -> np.ndarray:
    from ..signal.spectrogram import _hann_window
    f = n_fft // 2 + 1
    n = np.arange(win, dtype=np.int64)[:, None]
    k = np.arange(f, dtype=np.int64)[None, :]
    ang = ((n * k) % n_fft).astype(np.float64) * (2.0 * np.pi / n_fft)
    window = _hann_window(win).astype(np.float64)[:, None]
    wb = np.concatenate([window * np.cos(ang), window * np.sin(ang)],
                        axis=1).astype(np.float32)
    if round_bf16:
        wb = torch.from_numpy(wb).to(torch.bfloat16).float().numpy()
    return np.ascontiguousarray(wb)


@functools.lru_cache(maxsize=None)
def _twiddle_numpy(n_fft: int) -> np.ndarray:
    """exp(-2 pi i t / n_fft) for t < n_fft as float32 (re, im) pairs, from
    float64 cos and sin of the exact angles."""
    ang = np.arange(n_fft, dtype=np.float64) * (2.0 * np.pi / n_fft)
    return np.ascontiguousarray(
        np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32))


_TABLES = {}


def _cached(key, make) -> torch.Tensor:
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(make()).to(key[-1])
    return _TABLES[key]


def window_basis(n_fft: int, win: int, precision: str,
                 device) -> torch.Tensor:
    """The window-folded basis ``wb [win, 2F]`` float32 (bf16-rounded values
    for ``precision="default"``), built once per device and cached."""
    rounded = precision == "default"
    return _cached(("basis", n_fft, win, rounded, torch.device(device)),
                   lambda: _basis_numpy(n_fft, win, rounded))


def hann_window(win: int, device) -> torch.Tensor:
    """The periodic Hann window [win] float32, cached per device."""
    from ..signal.spectrogram import _hann_window
    return _cached(("window", win, torch.device(device)),
                   lambda: _hann_window(win))


def twiddles(n_fft: int, device) -> torch.Tensor:
    """The FFT route's twiddle table [n_fft, 2] float32, cached per
    device."""
    return _cached(("twiddle", n_fft, torch.device(device)),
                   lambda: _twiddle_numpy(n_fft))


def _hann_float64(win: int, device) -> torch.Tensor:
    n = torch.arange(win, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win)


def _frames(audio: torch.Tensor, cfg: ScaleConfig) -> torch.Tensor:
    """[B, L] -> [B, frames, win] sliding frames in audio's dtype (a
    view)."""
    frames, start = frame_geometry(audio.shape[-1], cfg.n_fft, cfg.hop,
                                   cfg.win)
    span = audio[:, start:start + (frames - 1) * cfg.hop + cfg.win]
    return span.unfold(-1, cfg.win, cfg.hop)


def reference_spectrum(audio: torch.Tensor, cfg: ScaleConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) [B, frames, F] of one scale's STFT as the DFT plain version
    computes it: float32 frames (bf16-rounded for 'default') times the
    window-folded basis."""
    x = _frames(audio.float(), cfg)
    if cfg.precision == "default":
        x = x.to(torch.bfloat16).float()
    ri = x @ window_basis(cfg.n_fft, cfg.win, cfg.precision, audio.device)
    f = cfg.n_fft // 2 + 1
    return ri[..., :f], ri[..., f:]


def reference_scale_loss(pred: torch.Tensor, target: torch.Tensor,
                         cfg: ScaleConfig, need_u: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the forward: (per-row loss sums [B] float32, U
    [B, frames, 2F] bfloat16 or None)."""
    return _loss_terms(*reference_spectrum(pred, cfg),
                       *reference_spectrum(target, cfg), cfg, need_u)


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im + 1e-12)


def _loss_terms(re_p, im_p, re_t, im_t, cfg: ScaleConfig, need_u: bool,
                u_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Both spectra -> (per-row loss sums [B], U in ``u_dtype`` or None),
    in the spectra's dtype."""
    mag_p, mag_t = magnitude(re_p, im_p), magnitude(re_t, im_t)
    total = torch.zeros_like(mag_p)
    dmag = torch.zeros_like(mag_p)
    if cfg.lin_w:
        d = mag_p - mag_t
        if cfg.mse:
            total = total + cfg.lin_w * (d * d)
            dmag = dmag + (2.0 * cfg.lin_w) * d
        else:
            total = total + cfg.lin_w * d.abs()
            dmag = dmag + cfg.lin_w * torch.sign(d)
    if cfg.log_w:
        lp = mag_p + cfg.log_eps
        d = torch.log(lp) - torch.log(mag_t + cfg.log_eps)
        if cfg.mse:
            total = total + cfg.log_w * (d * d)
            dmag = dmag + (2.0 * cfg.log_w) * d / lp
        else:
            total = total + cfg.log_w * d.abs()
            dmag = dmag + cfg.log_w * torch.sign(d) / lp
    u = None
    if need_u:
        scale = dmag / mag_p
        u = torch.cat([scale * re_p, scale * im_p], dim=-1).to(u_dtype)
    return total.sum((1, 2)), u


def reference_scale_loss_backward(u: torch.Tensor, grad: torch.Tensor,
                                  cfg: ScaleConfig, length: int
                                  ) -> torch.Tensor:
    """Plain version of the backward: the transposed STFT of U times the
    loss's cotangent ``grad`` -> d_pred [B, L] float32."""
    wb = window_basis(cfg.n_fft, cfg.win, cfg.precision, u.device)
    return _overlap_add(u.float() @ wb.T, grad, cfg, length)


def _overlap_add(d_frames: torch.Tensor, grad: torch.Tensor,
                 cfg: ScaleConfig, length: int) -> torch.Tensor:
    """[B, frames, win] frame gradients -> d_pred [B, L] in their dtype:
    each chunk of hop samples sums the frames over it, in the order of c."""
    batch, frames, _ = d_frames.shape
    _, start = frame_geometry(length, cfg.n_fft, cfg.hop, cfg.win)
    m = cfg.win // cfg.hop
    d_frames = d_frames.reshape(batch, frames, m, cfg.hop)
    chunks = d_frames.new_zeros(batch, frames + m - 1, cfg.hop)
    for c in range(m):
        chunks[:, c:c + frames] += d_frames[:, :, c]
    out = d_frames.new_zeros(batch, length)
    out[:, start:start + chunks.shape[1] * cfg.hop] = (
        grad * chunks.reshape(batch, -1))
    return out


def reference_spectra_fft(pred: torch.Tensor, target: torch.Tensor,
                          cfg: ScaleConfig) -> Tuple[torch.Tensor, ...]:
    """The FFT route's spectra in ``torch.fft``, step by step as the kernel
    takes them: z = w pred + i w target per frame, zero-padded at the end to
    n_fft; Z = FFT(z); P = (Z[k] + conj Z[N-k]) / 2, T = (Z[k] - conj
    Z[N-k]) / 2i; re = Re, im = -Im (the basis's +sin) -> (re_p, im_p,
    re_t, im_t) [B, frames, F] float32."""
    window = hann_window(cfg.win, pred.device)
    z = torch.complex(_frames(pred.float(), cfg) * window,
                      _frames(target.float(), cfg) * window)
    spec = torch.fft.fft(z, n=cfg.n_fft)
    f = cfg.n_fft // 2 + 1
    zk = spec[..., :f]
    zn = torch.roll(torch.flip(spec, [-1]), 1, -1)[..., :f]  # Z[(N-k) % N]
    return (0.5 * (zk.real + zn.real), 0.5 * (zn.imag - zk.imag),
            0.5 * (zk.imag + zn.imag), 0.5 * (zk.real - zn.real))


def reference_scale_loss_fft(pred: torch.Tensor, target: torch.Tensor,
                             cfg: ScaleConfig, need_u: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFT route's forward in ``torch.fft``: ``reference_spectra_fft``,
    then the loss terms and U of ``reference_scale_loss``."""
    return _loss_terms(*reference_spectra_fft(pred, target, cfg), cfg,
                       need_u)


def reference_scale_loss_fft_backward(u: torch.Tensor, grad: torch.Tensor,
                                      cfg: ScaleConfig, length: int
                                      ) -> torch.Tensor:
    """The FFT route's backward in ``torch.fft``: each frame's transposed
    STFT is w[n] (N/2) irfft(X, N)[n] for n < win, X[k] = U_re[k] - i
    U_im[k] with X[0] and X[N/2] doubled; then the overlap-add. In float32,
    or in float64 (and the float64 window) for a float64 U."""
    f = cfg.n_fft // 2 + 1
    wide = u.dtype == torch.float64
    uf = u if wide else u.float()
    x = torch.complex(uf[..., :f], -uf[..., f:])
    x[..., 0] *= 2
    x[..., f - 1] *= 2
    frames = torch.fft.irfft(x, n=cfg.n_fft)[..., :cfg.win] * (cfg.n_fft / 2)
    window = (_hann_float64 if wide else hann_window)(cfg.win, u.device)
    return _overlap_add(frames * window, grad, cfg, length)


def reference_spectrum_float64(audio: torch.Tensor, cfg: ScaleConfig
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) [B, frames, F] of one scale's STFT in float64: the frames
    times the float64 periodic Hann window, zero-padded at the end to n_fft,
    ``torch.fft.rfft``, im = -Im (the basis's +sin)."""
    spec = torch.fft.rfft(_frames(audio.double(), cfg)
                          * _hann_float64(cfg.win, audio.device), n=cfg.n_fft)
    return spec.real, -spec.imag


def reference_scale_loss_float64(pred: torch.Tensor, target: torch.Tensor,
                                 cfg: ScaleConfig
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The formula evaluated in float64, the accuracy reference of the
    tests and ``chip_smoke.py``: (per-row loss sums [B], U [B, frames, 2F]
    unrounded), both float64."""
    return _loss_terms(*reference_spectrum_float64(pred, cfg),
                       *reference_spectrum_float64(target, cfg), cfg, True,
                       u_dtype=torch.float64)


def _check(pred: torch.Tensor, target: torch.Tensor,
           cfg: ScaleConfig) -> None:
    if pred.dim() != 2 or pred.shape != target.shape:
        raise ValueError(f"expected pred and target [B, L], got "
                         f"{tuple(pred.shape)} and {tuple(target.shape)}")
    if not scale_eligible(cfg.n_fft, cfg.hop, cfg.win, cfg.precision):
        raise ValueError(f"the kernel does not take the scale {cfg}")
    frame_geometry(pred.shape[-1], cfg.n_fft, cfg.hop, cfg.win)


def _params(cfg: ScaleConfig, batch: int, length: int, device,
            **pointers):
    """The kernel's parameters; the route's tables (basis, or window and
    twiddles) are added here."""
    frames, start = frame_geometry(length, cfg.n_fft, cfg.hop, cfg.win)
    if fft_route(cfg):
        pointers.update(window=hann_window(cfg.win, device),
                        twiddle=twiddles(cfg.n_fft, device))
    else:
        pointers["basis"] = window_basis(cfg.n_fft, cfg.win, cfg.precision,
                                         device)
    return _SpectralParams(
        **{key: ptr(t) for key, t in pointers.items()},
        batch=batch, length=length, hop=cfg.hop, win=cfg.win, frames=frames,
        n_freq=cfg.n_fft // 2 + 1, start=start, mse=int(bool(cfg.mse)),
        round_bf16=int(cfg.precision == "default"), n_fft=cfg.n_fft,
        lin_w=float(cfg.lin_w), log_w=float(cfg.log_w),
        log_eps=float(cfg.log_eps))


def _launch(symbol: str, args, device: torch.device, name: str) -> None:
    from .build import load
    lib = load("spectral_loss")
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, symbol)(ctypes.byref(args), ctypes.c_void_p(stream))
    raise_on_error(lib, code, name)


def scale_loss_forward(pred: torch.Tensor, target: torch.Tensor,
                       cfg: ScaleConfig, need_u: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """-> (per-row loss sums [B], their total (0-dim), U or None); no
    autograd (see ``fused_scale_loss``)."""
    _check(pred, target, cfg)
    if pred.device.type != "cuda":
        with torch.no_grad():
            rows, u = reference_scale_loss(pred, target, cfg, need_u)
        return rows, rows.sum(), u
    check_cuda({"pred": pred, "target": target},
               {"pred": (torch.float32,), "target": (torch.float32,)})
    batch, length = pred.shape
    frames, _ = frame_geometry(length, cfg.n_fft, cfg.hop, cfg.win)
    n_freq = cfg.n_fft // 2 + 1
    if fft_route(cfg):
        symbol = "isi_spectral_fft_forward"
        tiles = -(-frames // fft_frames_per_block(cfg.n_fft))
    else:
        symbol = "isi_spectral_loss_forward"
        tiles = -(-frames // FWD_FRAMES) * -(-n_freq // FWD_FREQS)
    device = pred.device
    partial = torch.empty(batch, tiles, device=device)
    rows = torch.empty(batch, device=device)
    total = torch.empty((), device=device)
    u = (torch.empty(batch, frames, 2 * n_freq, device=device,
                     dtype=torch.bfloat16) if need_u else None)
    _launch(symbol,
            _params(cfg, batch, length, device, pred=pred, target=target,
                    u=u, partial=partial, rows=rows, total=total),
            device, "fused_scale_loss (forward)")
    scale_loss_forward.launches += 1
    return rows, total, u


scale_loss_forward.launches = 0


def scale_loss_backward(u: torch.Tensor, grad: torch.Tensor,
                        cfg: ScaleConfig, length: int) -> torch.Tensor:
    """d_pred [B, L] float32 for the loss's cotangent ``grad`` (0-dim)."""
    if u.dim() != 3 or u.dtype != torch.bfloat16:
        raise ValueError(f"expected U [B, frames, 2F] bfloat16, got "
                         f"{tuple(u.shape)} {u.dtype}")
    frames, _ = frame_geometry(length, cfg.n_fft, cfg.hop, cfg.win)
    if u.shape[1:] != (frames, 2 * (cfg.n_fft // 2 + 1)):
        raise ValueError(f"U {tuple(u.shape)} does not match {cfg} at "
                         f"{length} samples")
    if u.device.type != "cuda":
        with torch.no_grad():
            return reference_scale_loss_backward(u, grad, cfg, length)
    grad = grad.reshape(1).float().contiguous()
    check_cuda({"u": u, "grad": grad}, {"grad": (torch.float32,)})
    batch = u.shape[0]
    d_pred = torch.zeros(batch, length, device=u.device)
    pointers = dict(grad=grad, u_in=u, d_pred=d_pred)
    symbol = "isi_spectral_loss_backward"
    if fft_route(cfg):
        symbol = "isi_spectral_fft_backward"
        pointers["frame_grad"] = torch.empty(batch, frames, cfg.win,
                                             device=u.device)
    _launch(symbol, _params(cfg, batch, length, u.device, **pointers),
            u.device, "fused_scale_loss (backward)")
    scale_loss_backward.launches += 1
    return d_pred


scale_loss_backward.launches = 0


class ScaleLoss(torch.autograd.Function):
    """One scale's loss (0-dim) with the transposed-STFT backward; saves U
    only. The target is data: its gradient is None."""

    @staticmethod
    def forward(ctx, pred, target, cfg):
        _, total, u = scale_loss_forward(pred, target, cfg, need_u=True)
        ctx.save_for_backward(u)
        ctx.cfg, ctx.length = cfg, pred.shape[-1]
        return total

    @staticmethod
    def backward(ctx, grad):
        (u,) = ctx.saved_tensors
        return (scale_loss_backward(u, grad, ctx.cfg, ctx.length), None,
                None)


def fused_scale_loss(pred: torch.Tensor, target: torch.Tensor,
                     cfg: ScaleConfig, reduction: str = "mean"
                     ) -> torch.Tensor:
    """One scale's weighted loss: the sum over every element (a 0-dim
    tensor, differentiable in ``pred``), or with ``reduction="none"`` the
    per-row sums ``[B]`` (no gradient). The value-only calls skip U."""
    pred, target = pred.contiguous(), target.detach().contiguous()
    if reduction == "none":
        return scale_loss_forward(pred.detach(), target, cfg,
                                  need_u=False)[0]
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    if torch.is_grad_enabled() and pred.requires_grad:
        return ScaleLoss.apply(pred, target, cfg)
    return scale_loss_forward(pred, target, cfg, need_u=False)[1]
