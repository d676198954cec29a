"""Single-query attention over the causal prefix of a KV cache
(hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/decode_attention.py::
flash_decode_attention``: softmax(q . K^T / sqrt(Dh) + bias_row +
causal(pos)) . V for one query per sequence, reading only the keys up to
``pos`` (the cache already holds row ``pos``). The dense sampling scan
reaches it with ``use_flash=True``.

``flash_decode_attention`` launches ``csrc/decode_attention.cu`` (one
launch a call: a cluster of ``SPLIT`` blocks per head and sequence, each
taking a contiguous ``SPLIT``-th of the keys, merged through distributed
shared memory) for CUDA tensors and runs ``reference_decode_attention``
(the dense plain version) for CPU tensors, never falling back from one to
the other. ``decode_attention_plain`` follows the kernel's split and the
order of its combine. ``flash_decode_attention.launches`` counts its
kernel launches (one per call that reaches the GPU).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .common import DTYPE_CODES, NEG_INF, raise_on_error
from .decode_step_kernel import ATTN_CHUNK

SPLIT = 8          # blocks of a cluster (kSplit in the source)
STAGE_KEYS = 80    # keys a block stages a pass (kStageKeys)

_FN = None


# csrc/decode_attention.cu's widest head
FLASH_DH_MAX = 128


def flash_refusal(head_dim: int, length: int) -> Optional[str]:
    """None when ``flash_decode_attention`` takes this shape on the card,
    else why not, naming the shape."""
    if head_dim % 2 or not 0 < head_dim <= FLASH_DH_MAX:
        return (f"flash_decode_attention: head_dim {head_dim} is not even "
                f"up to {FLASH_DH_MAX}")
    if length % ATTN_CHUNK:
        return (f"flash_decode_attention: cache length {length} is not a "
                f"multiple of {ATTN_CHUNK}")
    return None


def _kernel():
    """The C entry point with its argument types, set once."""
    global _FN
    if _FN is None:
        from .build import load
        fn = load("decode_attention").isi_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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


def stage_keys(head_dim: int, element_size: int) -> int:
    """Keys the kernel stages a pass: STAGE_KEYS, fewer for rows wider
    than a float32 head_dim 64 (its staging buffers hold STAGE_KEYS of
    those, each row 16 bytes apart from the next beyond its length)."""
    stride = -(-head_dim * element_size // 16) * 16 + 16
    return min(STAGE_KEYS, STAGE_KEYS * (64 * 4 + 16) // stride)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int,
                           bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's order in plain PyTorch: the pos + 1 keys cut into
    ``SPLIT`` contiguous parts, each a running softmax over passes of
    ``stage_keys`` keys (max, exp sum, exp-weighted V), the parts merged in
    order. Same arguments and result as ``reference_decode_attention``."""
    n_keys = int(pos) + 1
    per_pass = stage_keys(q.shape[-1], q.element_size())
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    parts = []
    for r in range(SPLIT):
        j0, j1 = r * n_keys // SPLIT, (r + 1) * n_keys // SPLIT
        m = torch.full(q.shape[:2], float("-inf"), device=q.device)
        l_sum = torch.zeros(q.shape[:2], device=q.device)
        acc = torch.zeros(q.shape, device=q.device)
        for js in range(j0, j1, per_pass):
            je = min(j1, js + per_pass)
            s = torch.einsum("bhd,bkhd->bhk", qf,
                             k_cache[:, js:je].float()) * scale
            if bias_row is not None:
                s = s + bias_row[None, :, js:je].float()
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_sum = l_sum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhk,bkhd->bhd", p, v_cache[:, js:je].float())
            m = m_new
        parts.append((m, l_sum, acc))
    mm = parts[0][0]
    for m, _, _ in parts[1:]:
        mm = torch.maximum(mm, m)
    den = torch.zeros_like(mm)
    num = torch.zeros(q.shape, device=q.device)
    for m, l_sum, acc in parts:
        w = torch.where(m == float("-inf"), torch.zeros_like(m),
                        torch.exp(m - mm))
        den = den + l_sum * w
        num = num + acc * w[..., None]
    return (num / den.clamp_min(1e-20)[..., None]).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: int,
                           bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, H, Dh], caches [B, Lp, H, Dh] (Lp a multiple of 128), pos: the
    query's position (a host integer), bias_row [H, Lp] or None (float32 or
    bfloat16 as it is, any other dtype as float32) -> [B, H, Dh] in q's
    dtype."""
    pos = int(pos)
    if q.device.type != "cuda":
        return reference_decode_attention(q, k_cache, v_cache, pos, bias_row)
    batch, num_heads, head_dim = q.shape
    length = k_cache.shape[1]
    dtype = q.dtype
    shape = (batch, length, num_heads, head_dim)
    device = q.device
    if dtype not in DTYPE_CODES or k_cache.dtype != dtype \
            or v_cache.dtype != dtype:
        raise ValueError(f"q, k_cache and v_cache must share a float32 or "
                         f"bfloat16 dtype, got {q.dtype}, {k_cache.dtype} "
                         f"and {v_cache.dtype}")
    if k_cache.shape != shape or v_cache.shape != shape:
        raise ValueError(f"k_cache and v_cache must have shape {shape}, got "
                         f"{tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    if k_cache.device != device or v_cache.device != device:
        raise ValueError("q, k_cache and v_cache must lie on one CUDA "
                         "device")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("q, k_cache and v_cache must be contiguous")
    if bias_row is not None:
        if bias_row.device != device:
            raise ValueError(f"bias_row is on {bias_row.device}, expected "
                             f"{device}")
        if bias_row.shape != (num_heads, length):
            raise ValueError(f"bias_row has shape {tuple(bias_row.shape)}, "
                             f"expected {(num_heads, length)}")
        if bias_row.dtype not in DTYPE_CODES:
            bias_row = bias_row.float()
        bias_row = bias_row.contiguous()
    reason = flash_refusal(head_dim, length)
    if reason is not None:
        raise ValueError(reason)
    if not 0 <= pos < length:
        raise ValueError(f"pos {pos} outside the cache of length {length}")
    out = torch.empty_like(q)
    code = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if bias_row is None else bias_row.data_ptr(), out.data_ptr(),
        batch, num_heads, head_dim, length, pos, 1.0 / (head_dim ** 0.5),
        DTYPE_CODES[dtype],
        0 if bias_row is None else DTYPE_CODES[bias_row.dtype],
        torch._C._cuda_getCurrentRawStream(device.index))
    if code:
        from .build import load
        raise_on_error(load("decode_attention"), code,
                       "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def decode_attention_info(batch: int, num_heads: int, head_dim: int,
                          length: int, pos: int, dtype: torch.dtype) -> dict:
    """The launch shape of one call on the current CUDA device: grid
    blocks, cluster size, threads a block, shared memory, registers and
    spilled bytes a thread."""
    from .build import load
    lib = load("decode_attention")
    out = (ctypes.c_int * 6)()
    code = lib.isi_decode_attention_info(
        ctypes.c_int(batch), ctypes.c_int(num_heads), ctypes.c_int(head_dim),
        ctypes.c_int(length), ctypes.c_int(pos),
        ctypes.c_int(DTYPE_CODES[dtype]), out)
    raise_on_error(lib, code, "decode_attention_info")
    keys = ("grid_blocks", "cluster", "threads", "shared_bytes",
            "registers", "spilled_bytes")
    return dict(zip(keys, list(out)))
