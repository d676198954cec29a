"""Prefix priming of the decoder KV cache (hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/prefix_prime_kernel.py::
fused_prefix_prime``: inpainting with a concrete mask knows every token
before the first masked position, so one parallel decoder forward over that
prefix fills rows ``[0, p0)`` of every layer's self-attention cache and the
sequential scan starts at ``p0``. Per layer: LN, causal self attention with
the relative-bias table, cross attention (aligned gather, or attention with
the cross-bias table over the ``E_src`` real source keys), MLP. A batch of
sequences (``kv [n_layers, 2, B, l_pad, d]``) is primed in one call; the
one-sequence form (``kv [n_layers, 2, l_pad, d]``) is the same call at B = 1.

``fused_prefix_prime`` launches ``csrc/prefix_prime.cu`` (one persistent
cooperative launch per call: every layer's products on the tensor cores,
phases separated by grid barriers) for CUDA tensors and runs
``prefix_prime_plain`` (the same arithmetic, step by step, in PyTorch) for
CPU tensors. It never falls back from one to the other.
``fused_prefix_prime.launches`` counts its kernel launches (one per call
that reaches the GPU); ``prefix_prime_info`` reads the launch's shape.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .common import (DTYPE_CODES, NEG_INF, check_cuda, check_shape,
                     layer_norm, ptr, raise_on_error, round_to, struct_type)
from .decode_step_kernel import _round_up

_PrimeParams = struct_type(
    "PrimeParams",
    pointers=("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
              "w1", "b1", "w2", "b2", "ln", "x_prefix", "mem_k", "mem_v",
              "bias_hm", "cross_hm", "kv", "x", "h", "qkv", "qc", "a",
              "mid", "part", "ws"),
    ints=("n_layers", "d", "d_ff", "n_heads", "m", "p_pad", "l_pad",
          "e_pad", "steps_pad", "channels", "e_src", "aligned", "batch",
          "x_rows"),
    floats=("scale",))

_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
            "w1", "b1", "w2", "b2")
# csrc/prefix_prime.cu's limits
PRIME_DH_MAX = 128
PRIME_D_MAX = 2048


def prime_refusal(d_model: int, n_heads: int, d_ff: int) -> Optional[str]:
    """None when ``fused_prefix_prime`` takes this geometry on the card,
    else why not, naming the shape (csrc/prefix_prime.cu::shape_ok)."""
    shape = f"d_model {d_model}, {n_heads} heads, d_ff {d_ff}"
    if n_heads < 1 or d_model % n_heads:
        return (f"fused_prefix_prime: {n_heads} heads do not divide d_model "
                f"({shape})")
    dh = d_model // n_heads
    if dh % 8 or dh > PRIME_DH_MAX:
        return (f"fused_prefix_prime: head_dim {dh} is not a multiple of 8 "
                f"up to {PRIME_DH_MAX} ({shape})")
    if d_model % 32 or d_ff % 32 or d_model > PRIME_D_MAX:
        return (f"fused_prefix_prime: d_model and d_ff must be multiples of "
                f"32, d_model at most {PRIME_D_MAX} ({shape})")
    return None


INFO_KEYS = ("grid", "threads", "smem_bytes", "registers", "local_bytes",
             "grid_barriers")


def _batched(x_prefix, mem_kv, kv):
    """The arguments with a batch dimension: views of the one-sequence form
    (x_prefix [P, d], mem [n_layers, E_pad, d], kv [n_layers, 2, l_pad, d])
    or the batched tensors as they are."""
    if kv.dim() == 4:
        return (x_prefix[None], tuple(m[:, None] for m in mem_kv),
                kv[:, :, None])
    if kv.dim() != 5 or x_prefix.dim() != 3 or mem_kv[1].dim() != 4:
        raise ValueError(
            "expected kv [n_layers, 2, B, l_pad, d], x_prefix [B, P, d] and "
            "mem [n_layers, B, E_pad, d] (or all three without B)")
    return x_prefix, tuple(mem_kv), kv


def _geometry(bias_hm, mem_kv, kv, p0, e_src_real):
    n_layers, _, _, l_pad, d = kv.shape
    num_heads = bias_hm.shape[2]
    e_pad = mem_kv[1].shape[2]
    e_src = int(e_src_real) if e_src_real is not None else e_pad
    p_pad = min(_round_up(p0, 128), l_pad)
    if not 0 < p0 <= p_pad <= l_pad:
        raise ValueError(f"p0={p0} outside (0, l_pad={l_pad}]")
    return n_layers, l_pad, d, num_heads, e_pad, e_src, p_pad


def prefix_prime_plain(params: Dict[str, torch.Tensor],
                       bias_hm: torch.Tensor, x_prefix: torch.Tensor,
                       mem_kv: Tuple[torch.Tensor, torch.Tensor],
                       kv: torch.Tensor, *, p0: int, channels: int,
                       cross_hm: Optional[torch.Tensor] = None,
                       e_src_real: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    x_prefix, (mem_k, mem_v), kv_b = _batched(x_prefix, mem_kv, kv)
    n_layers, l_pad, d, nh, e_pad, e_src, p_pad = _geometry(
        bias_hm, (mem_k, mem_v), kv_b, p0, e_src_real)
    dtype = kv.dtype
    batch = kv_b.shape[2]
    dh = d // nh
    scale = 1.0 / (dh ** 0.5)
    m = p0
    dev = kv.device
    rows = torch.arange(m, device=dev)
    causal = rows[:, None] >= rows[None, :]

    def w(name, l):
        return params[name][l].float()

    x = x_prefix[:, :m].float()
    for l in range(n_layers):
        ln = params["ln"][l]
        h1 = round_to(layer_norm(x, ln[0], ln[1]), dtype)
        qkv = h1 @ w("wqkv", l).T + w("bqkv", l)
        q, k, v = qkv.split(d, dim=-1)
        kv_b[l, :, :, :p_pad] = 0
        kv_b[l, 0, :, :m] = k.to(dtype)
        kv_b[l, 1, :, :m] = v.to(dtype)
        logits = torch.einsum("bihd,bjhd->bhij", q.reshape(batch, m, nh, dh),
                              k.reshape(batch, m, nh, dh)) * scale
        logits = logits + bias_hm[l, :m, :, :m].permute(1, 0, 2)
        logits = torch.where(causal, logits, NEG_INF)
        a = torch.einsum("bhij,bjhd->bihd", torch.softmax(logits, -1),
                         v.reshape(batch, m, nh, dh)).reshape(batch, m, d)
        x = x + (round_to(a, dtype) @ w("wo", l).T + w("bo", l))
        if cross_hm is None:
            ev = rows // channels
            mv = mem_v[l][:, ev.clamp(max=e_pad - 1)].float()
            mv = torch.where((ev < e_pad)[:, None], mv, 0.0)
        else:
            h2 = round_to(layer_norm(x, ln[2], ln[3]), dtype)
            qc = h2 @ w("wq_c", l).T + w("bq_c", l)
            mk = mem_k[l, :, :e_src].float().reshape(batch, e_src, nh, dh)
            logits = torch.einsum("bihd,behd->bhie",
                                  qc.reshape(batch, m, nh, dh), mk) * scale
            logits = logits + cross_hm[l, :m, :, :e_src].permute(1, 0, 2)
            mv = torch.einsum(
                "bhie,behd->bihd", torch.softmax(logits, -1),
                mem_v[l, :, :e_src].float().reshape(batch, e_src, nh, dh)
            ).reshape(batch, m, d)
        x = x + (round_to(mv, dtype) @ w("wo_c", l).T + w("bo_c", l))
        h3 = round_to(layer_norm(x, ln[4], ln[5]), dtype)
        mid = torch.relu(h3 @ w("w1", l).T + w("b1", l))
        x = x + (round_to(mid, dtype) @ w("w2", l).T + w("b2", l))
    return kv


def fused_prefix_prime(params: Dict[str, torch.Tensor],
                       bias_hm: torch.Tensor, x_prefix: torch.Tensor,
                       mem_kv: Tuple[torch.Tensor, torch.Tensor],
                       kv: torch.Tensor, *, p0: int, channels: int,
                       cross_hm: Optional[torch.Tensor] = None,
                       e_src_real: Optional[int] = None) -> torch.Tensor:
    """Prime rows [0, p0) of ``kv`` from the known prefix; rows
    [p0, P_pad) become zeros (P_pad = p0 rounded up to 128, at most l_pad).

    params: ``pack_decode_params`` tables (weights ``[n, out, in]``);
    bias_hm [n_layers, steps_pad, H, l_pad] float32 (head-major
    ``precompute_bias_rows``); x_prefix [B, P >= p0, d]: embedded with-start
    prefix rows (``emb_padded[tok] + posfull`` in the cache dtype);
    mem_kv (mem_k, mem_v) [n_layers, B, E_pad, d]; kv [n_layers, 2, B,
    l_pad, d], updated in place and returned; cross_hm [n_layers, steps_pad,
    H, E_pad] float32 or None for aligned decoders; e_src_real: real source
    length. All three of x_prefix, mem_kv and kv may come without the B
    dimension (one sequence)."""
    if kv.device.type != "cuda":
        return prefix_prime_plain(params, bias_hm, x_prefix, mem_kv, kv,
                                  p0=p0, channels=channels,
                                  cross_hm=cross_hm, e_src_real=e_src_real)
    kv_out = kv
    args, dtype = _launch_args(params, bias_hm, x_prefix, mem_kv, kv, p0=p0,
                               channels=channels, cross_hm=cross_hm,
                               e_src_real=e_src_real)
    from .build import load
    lib = load("prefix_prime")
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    code = lib.isi_prefix_prime(ctypes.byref(args[0]),
                                ctypes.c_int(DTYPE_CODES[dtype]),
                                ctypes.c_void_p(stream))
    raise_on_error(lib, code, "fused_prefix_prime")
    fused_prefix_prime.launches += 1
    return kv_out


def _launch_args(params, bias_hm, x_prefix, mem_kv, kv, *, p0, channels,
                 cross_hm, e_src_real):
    """The checked ``PrimeParams`` of one launch (its scratch kept alive by
    the returned tuple) and the cache dtype."""
    x_prefix, (mem_k, mem_v), kv = _batched(x_prefix, mem_kv, kv)
    n_layers, l_pad, d, nh, e_pad, e_src, p_pad = _geometry(
        bias_hm, (mem_k, mem_v), kv, p0, e_src_real)
    batch = kv.shape[2]
    dtype = kv.dtype
    d_ff = params["b1"].shape[-1]
    steps_pad = bias_hm.shape[1]
    check_cuda(
        {**{k: params[k] for k in _WEIGHTS}, "ln": params["ln"],
         "bias_hm": bias_hm, "x_prefix": x_prefix, "mem_k": mem_k,
         "mem_v": mem_v, "kv": kv, "cross_hm": cross_hm},
        {**{k: (dtype,) for k in _WEIGHTS}, "ln": (torch.float32,),
         "bias_hm": (torch.float32,), "x_prefix": (dtype,),
         "mem_k": (dtype,), "mem_v": (dtype,), "kv": tuple(DTYPE_CODES),
         "cross_hm": (torch.float32,)})
    check_shape(params["wqkv"], "wqkv", (n_layers, 3 * d, d))
    check_shape(params["w1"], "w1", (n_layers, d_ff, d))
    check_shape(params["w2"], "w2", (n_layers, d, d_ff))
    check_shape(bias_hm, "bias_hm", (n_layers, steps_pad, nh, l_pad))
    check_shape(mem_v, "mem_v", (n_layers, batch, e_pad, d))
    check_shape(mem_k, "mem_k", (n_layers, batch, e_pad, d))
    if cross_hm is not None:
        check_shape(cross_hm, "cross_hm", (n_layers, steps_pad, nh, e_pad))
    if x_prefix.shape[0] != batch or x_prefix.shape[1] < p0 \
            or x_prefix.shape[2] != d:
        raise ValueError(f"x_prefix must be [{batch}, >= {p0}, {d}], "
                         f"got {tuple(x_prefix.shape)}")
    reason = prime_refusal(d, nh, d_ff)
    if reason is not None:
        raise ValueError(reason)
    m = p0
    rows = batch * m

    def f32(*shape):
        return torch.empty(shape, device=kv.device, dtype=torch.float32)

    def tdt(*shape):
        return torch.empty(shape, device=kv.device, dtype=dtype)

    # attention partials: an item per (sequence, head, 64 query rows, 64
    # keys at or below them | of the e_src source keys)
    nq = -(-m // 64)
    items = max(nq * (nq + 1) // 2,
                0 if cross_hm is None else nq * -(-e_src // 64))
    scratch = {"x": f32(rows, d), "h": tdt(rows, d),
               "qkv": f32(rows, 3 * d), "qc": f32(rows, d),
               "a": tdt(rows, d), "mid": tdt(rows, d_ff),
               "part": f32(batch * nh * items, 64, d // nh + 2),
               # a product split over K: two operands' partials, splits x
               # rows at most 64 x SMs / (d / 64 column tiles)
               "ws": f32(2 * 64 * 64 * torch.cuda.get_device_properties(
                   kv.device).multi_processor_count)}
    args = _PrimeParams(
        **{k: ptr(params[k]) for k in _WEIGHTS}, ln=ptr(params["ln"]),
        x_prefix=ptr(x_prefix), mem_k=ptr(mem_k), mem_v=ptr(mem_v),
        bias_hm=ptr(bias_hm), cross_hm=ptr(cross_hm), kv=ptr(kv),
        **{k: ptr(v) for k, v in scratch.items()},
        n_layers=n_layers, d=d, d_ff=d_ff, n_heads=nh, m=m, p_pad=p_pad,
        l_pad=l_pad, e_pad=e_pad, steps_pad=steps_pad, channels=channels,
        e_src=e_src, aligned=int(cross_hm is None), batch=batch,
        x_rows=x_prefix.shape[1], scale=1.0 / ((d // nh) ** 0.5))
    return (args, scratch), dtype


def prefix_prime_info(params: Dict[str, torch.Tensor],
                      bias_hm: torch.Tensor, x_prefix: torch.Tensor,
                      mem_kv: Tuple[torch.Tensor, torch.Tensor],
                      kv: torch.Tensor, **kwargs) -> Dict[str, int]:
    """The shape of the launch ``fused_prefix_prime`` makes for these
    arguments (CUDA tensors): INFO_KEYS, from the kernel's own attributes."""
    from .build import load
    (args, _), dtype = _launch_args(params, bias_hm, x_prefix, mem_kv, kv,
                                    **kwargs)
    lib = load("prefix_prime")
    out = (ctypes.c_int * len(INFO_KEYS))()
    code = lib.isi_prefix_prime_info(ctypes.byref(args),
                                     ctypes.c_int(DTYPE_CODES[dtype]), out)
    raise_on_error(lib, code, "prefix_prime_info")
    return dict(zip(INFO_KEYS, out))


fused_prefix_prime.launches = 0
