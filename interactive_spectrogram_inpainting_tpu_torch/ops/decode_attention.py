"""Single-query attention over the causal prefix of a KV cache
(hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/decode_attention.py::
flash_decode_attention``: softmax(q . K^T / sqrt(Dh) + bias_row +
causal(pos)) . V for one query per sequence, reading only the 128-key chunks
of the cache up to ``pos`` (the cache already holds row ``pos``). The dense
sampling scan reaches it with ``use_flash=True``.

``flash_decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA
tensors and runs ``reference_decode_attention`` (the dense plain version)
for CPU tensors, never falling back from one to the other.
``flash_decode_attention.launches`` counts its kernel launches (one per call
that reaches the GPU).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .common import (DTYPE_CODES, NEG_INF, check_cuda, check_shape, ptr,
                     raise_on_error, struct_type)
from .decode_step_kernel import ATTN_CHUNK


_DecodeAttnParams = struct_type(
    "DecodeAttnParams", pointers=("q", "k", "v", "bias", "out", "part"),
    ints=("batch", "n_heads", "head_dim", "length", "pos"),
    floats=("scale",))


def reference_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: int,
                               bias_row: Optional[torch.Tensor]
                               ) -> torch.Tensor:
    """Dense plain version. q [B, H, Dh], caches [B, L, H, Dh], bias_row
    [H, L] or None -> [B, H, Dh] in q's dtype (float32 arithmetic)."""
    head_dim = q.shape[-1]
    length = k_cache.shape[1]
    logits = torch.einsum("bhd,bkhd->bhk", q.float(),
                          k_cache.float()) / (head_dim ** 0.5)
    if bias_row is not None:
        logits = logits + bias_row[None].float()
    keep = torch.arange(length, device=q.device) <= pos
    logits = torch.where(keep, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", weights, v_cache.float())
    return out.to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int,
                           bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, H, Dh], caches [B, Lp, H, Dh] (Lp a multiple of 128), pos: the
    query's position (a host integer), bias_row [H, Lp] or None ->
    [B, H, Dh] in q's dtype."""
    pos = int(pos)
    if q.device.type != "cuda":
        return reference_decode_attention(q, k_cache, v_cache, pos, bias_row)
    from .build import load
    batch, num_heads, head_dim = q.shape
    length = k_cache.shape[1]
    dtype = q.dtype
    if bias_row is not None:
        bias_row = bias_row.float().contiguous()
    check_cuda({"q": q, "k_cache": k_cache, "v_cache": v_cache,
                "bias_row": bias_row},
               {"q": tuple(DTYPE_CODES), "k_cache": (dtype,),
                "v_cache": (dtype,)})
    check_shape(k_cache, "k_cache", (batch, length, num_heads, head_dim))
    check_shape(v_cache, "v_cache", (batch, length, num_heads, head_dim))
    if bias_row is not None:
        check_shape(bias_row, "bias_row", (num_heads, length))
    if length % ATTN_CHUNK or head_dim % 2 or head_dim > 64 \
            or not 0 <= pos < length:
        raise ValueError("the cache length must be a multiple of 128, "
                         "head_dim even and <= 64, and 0 <= pos < length")
    n_chunks = pos // ATTN_CHUNK + 1
    out = torch.empty_like(q)
    part = torch.empty(batch, num_heads, n_chunks, head_dim + 2,
                       device=q.device, dtype=torch.float32)
    args = _DecodeAttnParams(
        q=ptr(q), k=ptr(k_cache), v=ptr(v_cache), bias=ptr(bias_row),
        out=ptr(out), part=ptr(part), batch=batch, n_heads=num_heads,
        head_dim=head_dim, length=length, pos=pos,
        scale=1.0 / (head_dim ** 0.5))
    lib = load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.isi_decode_attention(ctypes.byref(args),
                                    ctypes.c_int(DTYPE_CODES[dtype]),
                                    ctypes.c_void_p(stream))
    raise_on_error(lib, code, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
