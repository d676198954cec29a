"""Training attention of the priors and its gradient (hand-written CUDA for
sm_90a).

Replaces the Pallas kernels of
``interactive_spectrogram_inpainting_tpu/ops/train_attention.py::fused_train_attention``:
for q ``[B, Lq, H, Dh]``, k, v ``[B, Lk, H, Dh]`` (float32 or bfloat16)
and the batch-shared additive term ab ``[H, Lq, Lk]`` (float32: relative
bias plus the finite -1e9 masks),

    o = softmax(q k^T / sqrt(Dh) + ab) v

in q's dtype, and its gradient in all four arguments, ``dab`` being the sum
over the batch of the score gradients, in float32. The ``[B, H, Lq, Lk]``
probabilities never reach device memory: the backward recomputes them.
``MultiHeadAttention`` reaches it when a prior is built with
``fused_attention`` (the trainer's default on the GPU).

``fused_train_attention`` is a ``torch.autograd.Function`` that saves q, k,
v, ab and what the forward kernel leaves for the backward (the output, the
row statistics and the map of live tiles). Its two halves,
``train_attention_forward`` and ``train_attention_backward``, launch
``csrc/train_attention.cu`` for CUDA tensors (one launch forward; backward a
dq/dab kernel whose blocks walk groups of batch rows in order, a launch
adding the groups' partial dab sums in order when there is more than one
group, so that ``dab`` is the same bits on every run, and a dk/dv kernel)
and run ``reference_train_attention`` / ``reference_train_attention_backward``
for CPU tensors, never falling back from one to the other. The kernels run
their products on the tensor cores (float32 as split TF32) and skip the
64 x 64 tiles in which ``ab`` masks every entry (``live_tiles``). Each
half's ``launches`` counts its calls that reached the GPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .common import (DTYPE_CODES, check_cuda, check_shape, ptr,
                     raise_on_error, struct_type)

NEG_INF = -1e9
# an ab entry at or below this is a mask: it contributes exactly 0
DEAD = -1e8
# widest head the kernels take (heads are padded to 64 or 128 columns in
# shared memory, their products to the next multiple of 16)
MAX_HEAD_DIM = 128
# query rows and keys of a kernel tile (kTile in the source), the unit of
# ``live_tiles``; and the grid the dq/dab kernel's batch split aims for:
# about eight blocks per SM of a 132-SM card, two at a time (on the H100,
# 11 groups of 3 rows at B 32, 516 x 516 beat 4, 8, 16 and 32 groups). The
# groups depend on the shapes alone, so dab's bits do too.
TILE = 64
DQ_TARGET_BLOCKS = 1056

_TrainAttnParams = struct_type(
    "TrainAttnParams",
    pointers=("q", "k", "v", "ab", "dout", "out", "out_f", "dq", "dk", "dv",
              "dab", "dab_parts", "stats", "live"),
    ints=("batch", "lq", "lk", "heads", "dh", "groups", "vec"),
    floats=("scale",))

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(float(q.shape[-1]))


def reference_train_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, ab: torch.Tensor
                              ) -> torch.Tensor:
    """Dense plain version (differentiable by autograd; ``ab``'s gradient
    is summed over the broadcast batch)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(float(q.shape[-1])) + ab[None].float()
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v).to(q.dtype)


def reference_train_attention_backward(q, k, v, ab, dout) -> Grads:
    """The gradient as the kernels compute it, written out in plain
    PyTorch: P recomputed, ``dS = P (dP - rowsum(P dP))``, dS rounded to
    the inputs' dtype before the dq / dk products and P before the dv
    product, float32 accumulation; -> (dq, dk, dv, dab)."""
    scale = _scale(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(logits + ab[None].float(), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds_k = ds.to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_k, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(0)


def _check(q, k, v, ab, dout=None) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q [B, Lq, H, Dh] and k, v [B, Lk, H, Dh], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    batch, lq, heads, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (batch, heads, dh):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    check_shape(ab, "ab", (heads, lq, k.shape[1]))
    if not (q.dtype == k.dtype == v.dtype) or ab.dtype != torch.float32:
        raise ValueError(f"q, k, v must share a dtype and ab must be float32, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}, {ab.dtype}")
    if dout is not None:
        check_shape(dout, "dout", q.shape)


def _launch(symbol: str, args, dtype: torch.dtype, device: torch.device,
            name: str) -> None:
    from .build import load
    lib = load("train_attention")
    fn = getattr(lib, symbol)
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(ctypes.byref(args), ctypes.c_int(DTYPE_CODES[dtype]),
              ctypes.c_void_p(stream))
    raise_on_error(lib, code, name)


def dq_groups(batch: int, lq: int, heads: int) -> int:
    """Groups of batch rows the dq/dab kernel splits the batch into: each
    takes ceil(batch / groups) rows, and none is empty."""
    blocks = -(-lq // TILE) * heads
    groups = max(1, min(batch, -(-DQ_TARGET_BLOCKS // blocks)))
    per = -(-batch // groups)
    return -(-batch // per)


def live_tiles(ab: torch.Tensor) -> torch.Tensor:
    """The plain version of the map the forward kernel builds first
    (``attn_live``) and the backward reuses:
    uint8 [H, ceil(Lq / 64), ceil(Lk / 64)], 1 where the 64 x 64 tile of
    ``ab`` [H, Lq, Lk] holds an entry above ``DEAD`` (a masked score adds
    exactly 0 to a row that has a key, and its gradient is 0), and on every
    tile of a query tile holding a row with no such entry (that row keeps
    the dense softmax over its masked scores)."""
    heads, lq, lk = ab.shape
    nq, nk = -(-lq // TILE), -(-lk // TILE)
    keep = ab > DEAD
    padded = torch.zeros(heads, nq * TILE, nk * TILE, dtype=torch.bool,
                         device=ab.device)
    padded[:, :lq, :lk] = keep
    live = padded.view(heads, nq, TILE, nk, TILE).any(4).any(2)
    no_key = torch.zeros(heads, nq * TILE, dtype=torch.bool, device=ab.device)
    no_key[:, :lq] = ~keep.any(2)
    live |= no_key.view(heads, nq, TILE).any(2)[:, :, None]
    return live.to(torch.uint8)


class ForwardState(NamedTuple):
    """What the forward kernel leaves for the backward: its output, the row
    statistics ``[3, B, H, Lq]`` float32 (row max and 1 / row sum; the
    backward writes delta into the third plane), ``live_tiles(ab)`` and,
    for bfloat16 inputs, the output in float32 before P was rounded
    (``out_f``: the backward's delta = rowsum(dO * out_f) is then
    rowsum(P * dP) as the plain version takes it; None for float32)."""
    out: torch.Tensor
    stats: torch.Tensor
    live: torch.Tensor
    out_f: Optional[torch.Tensor] = None


def _params(q, k, v, ab, groups=1, **pointers):
    batch, lq, heads, dh = q.shape
    fields = dict.fromkeys(("dout", "out", "out_f", "dq", "dk", "dv", "dab",
                            "dab_parts", "stats", "live"))
    fields.update(pointers)
    tensors = [q, k, v] + [t for key, t in pointers.items()
                           if key in ("dout", "out", "dq", "dk", "dv")
                           and t is not None]
    vec = (dh * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return _TrainAttnParams(
        q=ptr(q), k=ptr(k), v=ptr(v), ab=ptr(ab),
        **{key: ptr(t) for key, t in fields.items()},
        batch=batch, lq=lq, lk=k.shape[1], heads=heads, dh=dh,
        groups=groups, vec=int(vec), scale=_scale(q))


def _check_cuda(q, k, v, ab, dout=None) -> None:
    types = (torch.float32, torch.bfloat16)
    check_cuda({"q": q, "k": k, "v": v, "ab": ab, "dout": dout},
               {"q": types, "k": types, "v": types, "dout": (q.dtype,),
                "ab": (torch.float32,)})
    if q.shape[-1] > MAX_HEAD_DIM or q.numel() == 0 or k.shape[1] == 0:
        raise ValueError(f"the kernels take 0 < Dh <= {MAX_HEAD_DIM} and "
                         f"non-empty sequences, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _forward_kernel(q, k, v, ab) -> ForwardState:
    batch, lq, heads, _ = q.shape
    out = torch.empty_like(q)
    stats = torch.empty(3, batch, heads, lq, device=q.device,
                        dtype=torch.float32)
    live = torch.empty(heads, -(-lq // TILE), -(-k.shape[1] // TILE),
                       device=q.device, dtype=torch.uint8)
    out_f = (torch.empty(q.shape, device=q.device, dtype=torch.float32)
             if q.dtype == torch.bfloat16 else None)
    _launch("isi_train_attention_forward",
            _params(q, k, v, ab, out=out, out_f=out_f, stats=stats,
                    live=live),
            q.dtype, q.device, "fused_train_attention (forward)")
    return ForwardState(out, stats, live, out_f)


def train_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, ab: torch.Tensor,
                            keep_state: bool = False):
    """o [B, Lq, H, Dh] in q's dtype (no autograd: see
    ``fused_train_attention``). With ``keep_state``, the ``ForwardState``
    instead (None as the statistics and live tiles on the CPU), for
    ``train_attention_backward``."""
    _check(q, k, v, ab)
    if q.device.type != "cuda":
        with torch.no_grad():
            out = reference_train_attention(q, k, v, ab)
        return ForwardState(out, None, None) if keep_state else out
    _check_cuda(q, k, v, ab)
    state = _forward_kernel(q, k, v, ab)
    train_attention_forward.launches += 1
    return state if keep_state else state.out


train_attention_forward.launches = 0


def train_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, ab: torch.Tensor,
                             dout: torch.Tensor,
                             state: Optional[ForwardState] = None) -> Grads:
    """(dq, dk, dv in the inputs' dtype, dab [H, Lq, Lk] float32) for the
    output cotangent ``dout``. ``state``: the forward's
    (``train_attention_forward(..., keep_state=True)``); without it the
    backward runs the forward kernel first, uncounted."""
    _check(q, k, v, ab, dout)
    if q.device.type != "cuda":
        with torch.no_grad():
            return reference_train_attention_backward(q, k, v, ab, dout)
    _check_cuda(q, k, v, ab, dout)
    if state is None:
        state = _forward_kernel(q, k, v, ab)
    batch, lq, heads, _ = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dab = torch.empty_like(ab)
    groups = dq_groups(batch, lq, heads)
    parts = (torch.empty((groups,) + tuple(ab.shape), device=q.device,
                         dtype=torch.float32) if groups > 1 else None)
    _launch("isi_train_attention_backward",
            _params(q, k, v, ab, groups, dout=dout, out=state.out,
                    out_f=state.out_f, dq=dq, dk=dk, dv=dv, dab=dab,
                    dab_parts=parts, stats=state.stats, live=state.live),
            q.dtype, q.device, "fused_train_attention (backward)")
    train_attention_backward.launches += 1
    return dq, dk, dv, dab


train_attention_backward.launches = 0


class TrainAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(Dh) + ab) v with the kernels' backward; saves
    q, k, v, ab and the forward's state, never the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, ab):
        state = train_attention_forward(q, k, v, ab, keep_state=True)
        ctx.save_for_backward(q, k, v, ab, *state)
        return state.out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ab, *saved = ctx.saved_tensors
        state = None if saved[1] is None else ForwardState(*saved)
        return train_attention_backward(q, k, v, ab, dout.contiguous(),
                                        state)


def fused_train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ab: torch.Tensor) -> torch.Tensor:
    """q [B, Lq, H, Dh]; k, v [B, Lk, H, Dh]; ab [H, Lq, Lk] float32 ->
    [B, Lq, H, Dh] in q's dtype, differentiable in all four arguments."""
    return TrainAttention.apply(q, k, v, ab)
