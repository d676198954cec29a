"""Whole-scan B=1 decode (hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/decode_scan_kernel.py::
fused_decode_scan``: the entire autoregressive sampling loop over
``[p0, steps)`` for one sequence. Each step embeds the input token (the
all-zeros row ``n_class`` for start positions) plus its positional row,
runs every decoder layer against the KV cache (self attention over rows
``< p`` plus the fresh key with the relative-bias row of ``p``, cross
attention, MLP), takes the final LN and logits, divides by the temperature,
adds the step's Gumbel noise and writes the argmax where ``mask[i]`` and
``i >= 0`` (``i = p - (c - 1)``); unmasked cells keep their token.

Tokens and the mask are int32 / bool vectors; the Gumbel noise is an input
``[steps - p0, n_class]`` float32, so the JAX package's noise can be fed in
and the token streams compared one for one.

``fused_decode_scan`` launches ``csrc/decode_scan.cu`` (one cooperative
launch per call, in thread-block clusters) for CUDA tensors and runs
``decode_scan_plain`` for CPU tensors, never falling back from one to the
other. ``fused_decode_scan.launches`` counts its kernel launches,
``fused_decode_scan.grouped_launches`` those that ran heads side by side;
``decode_scan_info`` reads the launch's shape (grid, clusters, shared
memory, registers, grid barriers a step, heads side by side).

Up to ``CLUSTERS`` heads, each cluster takes one head. Above, where the
group of ``heads_side_by_side`` adjacent heads is at most ``SCAN_DH_MAX``
wide and its regions fit shared memory (the reference's 16 heads of 32:
8 clusters of 2), a cluster takes the group's heads side by side in one
segment; otherwise (16 heads of 128, say) the general kernel runs a
cluster's heads one after the other.

The kernel adds its products' partial sums in a fixed order: the attention
output projections a partial per head (heads in order), fc2 a partial per
block over its slice of d_ff, the blocks of a cluster in rank order, then
the clusters in order; each phase adds the partials first, then the
bias, then the residual. ``decode_scan_plain`` adds them in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .common import (DTYPE_CODES, check_cuda, check_shape, layer_norm, ptr,
                     raise_on_error, round_to, struct_type)

# the launch of csrc/decode_scan.cu: CLUSTERS clusters of CLUSTER blocks;
# fc1 / fc2 split over the blocks in units of UNIT rows of d_ff; cluster c
# takes head c; above CLUSTERS heads, the G = heads_side_by_side(...) heads
# c G, ..., c G + G - 1 side by side, or (the general kernel, where the
# group does not fit) the heads c, c + CLUSTERS, ... one after the other
CLUSTER = 8
CLUSTERS = 15
UNIT = 8
SCAN_DH_MAX = 128
INFO_KEYS = ("grid", "cluster", "threads", "smem_bytes", "registers",
             "local_bytes", "grid_barriers_per_step", "clusters_resident",
             "heads_per_cluster", "staged_regions", "general_kernel",
             "heads_side_by_side")


def heads_side_by_side(n_heads: int, head_dim: int) -> int:
    """The heads a cluster takes side by side in one segment: ceil(n_heads
    / CLUSTERS) above CLUSTERS heads where the group is at most
    SCAN_DH_MAX wide, else 1 (csrc/decode_scan.cu::side_by_side, which
    also needs the grouped layout's regions to fit shared memory, and
    otherwise runs the heads in series)."""
    group = -(-n_heads // CLUSTERS)
    if n_heads <= CLUSTERS or group * head_dim > SCAN_DH_MAX:
        return 1
    return group


def scan_refusal(d_model: int, n_heads: int, d_ff: int) -> Optional[str]:
    """None when ``fused_decode_scan`` takes this geometry on the card,
    else why not, naming the shape (csrc/decode_scan.cu::shape_ok; the
    shared memory adapts: regions that do not fit are read from device
    memory)."""
    shape = f"d_model {d_model}, {n_heads} heads, d_ff {d_ff}"
    if n_heads < 1 or d_model % n_heads:
        return f"fused_decode_scan: {n_heads} heads do not divide d_model " \
               f"({shape})"
    dh = d_model // n_heads
    if dh % CLUSTER or dh > SCAN_DH_MAX or d_ff % UNIT:
        return (f"fused_decode_scan: head_dim {dh} must be a multiple of "
                f"{CLUSTER} up to {SCAN_DH_MAX} and d_ff a multiple of "
                f"{UNIT} ({shape})")
    return None

_ScanParams = struct_type(
    "ScanParams",
    pointers=("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
              "w1", "b1", "w2", "b2", "w_logits", "b_logits", "ln",
              "ln_final", "emb", "posfull", "mem_k", "mem_v", "bias_hm",
              "cross_hm", "gumbel", "mask", "tokens", "kv", "xbuf",
              "part_att", "part_cross", "part_mlp", "logits"),
    ints=("n_layers", "d", "d_ff", "n_heads", "n_class", "l_pad", "e_pad",
          "steps_pad", "length", "channels", "p0", "steps", "e_src",
          "aligned"),
    floats=("scale", "temperature"))

_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
            "w1", "b1", "w2", "b2", "w_logits")


def in_order(parts: torch.Tensor) -> torch.Tensor:
    """parts [n, ...] added in index order, as the kernel adds them."""
    total = parts[0]
    for k in range(1, parts.shape[0]):
        total = total + parts[k]
    return total


def head_partials(a: torch.Tensor, w: torch.Tensor, nh: int) -> torch.Tensor:
    """[nh, d_out]: head h's share of ``a @ w.T`` (a's dims of head h times
    w's columns of head h)."""
    d_out, d = w.shape
    return torch.einsum("hk,rhk->hr", a.reshape(nh, d // nh),
                        w.reshape(d_out, nh, d // nh))


@functools.lru_cache(maxsize=None)
def fc2_slices(d_ff: int) -> Tuple[Tuple[int, ...], ...]:
    """The d_ff columns of each block of the kernel, padded with d_ff (a
    zero column) to one length: block j takes units [j U / n, (j + 1) U / n)
    of U = d_ff / UNIT units, n = CLUSTER * CLUSTERS."""
    n, units = CLUSTER * CLUSTERS, d_ff // UNIT
    cols = [list(range(j * units // n * UNIT, (j + 1) * units // n * UNIT))
            for j in range(n)]
    width = max(len(c) for c in cols)
    return tuple(tuple(c + [d_ff] * (width - len(c))) for c in cols)


def fc2_in_kernel_order(mid: torch.Tensor, w2_blocks: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """mid @ w2.T added as the kernel adds it: a partial per block over its
    d_ff columns (``w2_blocks`` [d, blocks, width] = w2 with a zero column
    appended, gathered at ``idx``), the blocks of a cluster in rank order,
    then the clusters in order."""
    mid_pad = torch.cat([mid, mid.new_zeros(1)])
    parts = torch.einsum("rbk,bk->br", w2_blocks, mid_pad[idx])
    return in_order(in_order(parts.reshape(CLUSTERS, CLUSTER, -1)
                             .transpose(0, 1)))


def decode_scan_plain(params: Dict[str, torch.Tensor],
                      bias_hm: torch.Tensor, posfull: torch.Tensor,
                      mem_kv: Tuple[torch.Tensor, torch.Tensor],
                      kv: Optional[torch.Tensor], tokens: torch.Tensor,
                      mask: torch.Tensor, gumbel: torch.Tensor,
                      temperature: float, *, p0: int, steps: int,
                      n_class: int, channels: int,
                      cross_hm: Optional[torch.Tensor] = None,
                      e_src_real: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same arguments, same result,
    its partial sums added in the kernel's order). The token loop stays on
    the device: no value is read back per step."""
    mem_k, mem_v = mem_kv
    dtype = params["wqkv"].dtype
    n_layers, _, d = params["wo"].shape
    nh = bias_hm.shape[2]
    l_pad = bias_hm.shape[3]
    dh = d // nh
    scale = 1.0 / (dh ** 0.5)
    e_pad = mem_v.shape[1]
    e_src = int(e_src_real) if e_src_real is not None else e_pad
    c = channels
    length = tokens.shape[0]
    dev = tokens.device
    if kv is None:
        kv = torch.zeros(n_layers, 2, l_pad, d, dtype=dtype, device=dev)
    tokens = tokens.clone()
    mask = mask.to(torch.bool)
    emb = params["emb_padded"]
    start_token = torch.tensor(n_class, device=dev)
    w = {k: params[k].float() for k in _WEIGHTS}
    idx = torch.tensor(fc2_slices(params["b1"].shape[-1]), device=dev)
    w2_blocks = [torch.cat([w2, w2.new_zeros(d, 1)], 1)[:, idx]
                 for w2 in w["w2"]]
    b_logits = params["b_logits"]
    for p in range(p0, steps):
        i = p - (c - 1)
        tok = start_token if p < c else tokens[p - c]
        x = emb[tok].float() + posfull[p].float()
        for l in range(n_layers):
            ln = params["ln"][l]
            h1 = round_to(layer_norm(x, ln[0], ln[1]), dtype)
            qkv = h1 @ w["wqkv"][l].T + w["bqkv"][l]
            q, k_i, v_i = (t.reshape(nh, dh) for t in qkv.split(d))
            kc = kv[l, 0, :p].float().reshape(p, nh, dh)
            vc = kv[l, 1, :p].float().reshape(p, nh, dh)
            logits = torch.einsum("hd,jhd->hj", q, kc) * scale \
                + bias_hm[l, p, :, :p]
            lp = (q * k_i).sum(-1) * scale + bias_hm[l, p, :, p]
            m = torch.maximum(logits.max(-1).values if p else lp, lp)
            p_cache = torch.exp(logits - m[:, None])
            p_fresh = torch.exp(lp - m)
            denom = p_cache.sum(-1) + p_fresh
            acc = torch.einsum("hj,jhd->hd", p_cache, vc) \
                + p_fresh[:, None] * v_i
            a = (acc / denom.clamp_min(1e-20)[:, None]).reshape(d)
            heads = head_partials(round_to(a, dtype), w["wo"][l], nh)
            kv[l, 0, p] = k_i.reshape(d).to(dtype)
            kv[l, 1, p] = v_i.reshape(d).to(dtype)
            if cross_hm is None:
                e_q = p // c
                mv = (mem_v[l, e_q].float() if e_q < e_pad
                      else torch.zeros(d, device=dev))
                heads = heads + head_partials(mv, w["wo_c"][l], nh)
                x = x + (in_order(heads) + (w["bo"][l] + w["bo_c"][l]))
            else:
                x = x + (in_order(heads) + w["bo"][l])
                h2 = round_to(layer_norm(x, ln[2], ln[3]), dtype)
                q_c = (h2 @ w["wq_c"][l].T + w["bq_c"][l]).reshape(nh, dh)
                mk = mem_k[l, :e_src].float().reshape(e_src, nh, dh)
                lq = torch.einsum("hd,ehd->he", q_c, mk) * scale \
                    + cross_hm[l, p, :, :e_src]
                mv = torch.einsum(
                    "he,ehd->hd", torch.softmax(lq, -1),
                    mem_v[l, :e_src].float().reshape(e_src, nh, dh)
                ).reshape(d)
                x = x + (in_order(head_partials(round_to(mv, dtype),
                                                w["wo_c"][l], nh))
                         + w["bo_c"][l])
            h3 = round_to(layer_norm(x, ln[4], ln[5]), dtype)
            mid = torch.relu(h3 @ w["w1"][l].T + w["b1"][l])
            x = x + (fc2_in_kernel_order(round_to(mid, dtype), w2_blocks[l],
                                         idx) + w["b2"][l])
        hf = round_to(layer_norm(x, params["ln_final"][0],
                                 params["ln_final"][1]), dtype)
        logit = (hf @ w["w_logits"].T + b_logits) / temperature
        winner = torch.argmax(logit + gumbel[p - p0]).to(tokens.dtype)
        if i >= 0:
            tokens[i] = torch.where(mask[i], winner, tokens[i])
    return tokens, kv


def fused_decode_scan(params: Dict[str, torch.Tensor],
                      bias_hm: torch.Tensor, posfull: torch.Tensor,
                      mem_kv: Tuple[torch.Tensor, torch.Tensor],
                      kv: Optional[torch.Tensor], tokens: torch.Tensor,
                      mask: torch.Tensor, gumbel: torch.Tensor,
                      temperature: float, *, p0: int, steps: int,
                      n_class: int, channels: int,
                      cross_hm: Optional[torch.Tensor] = None,
                      e_src_real: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the sampling loop over [p0, steps) for one sequence.

    params: ``pack_decode_params`` tables; bias_hm [n_layers, steps_pad, H,
    l_pad] float32; posfull [steps_pad, d] (row 0 of
    ``precompute_position_features``); mem_kv (mem_k, mem_v) [n_layers,
    E_pad, d]; kv [n_layers, 2, l_pad, d] (a primed cache, updated in
    place) or None (zeros); tokens [L] int32; mask [L] bool;
    gumbel [steps - p0, n_class] float32 (row r: noise of step p0 + r);
    cross_hm [n_layers, steps_pad, H, E_pad] float32 or None (aligned).
    Returns (tokens [L], final KV cache)."""
    if tokens.device.type != "cuda":
        return decode_scan_plain(
            params, bias_hm, posfull, mem_kv, kv, tokens, mask, gumbel,
            temperature, p0=p0, steps=steps, n_class=n_class,
            channels=channels, cross_hm=cross_hm, e_src_real=e_src_real)
    tokens = tokens.clone()
    if kv is None:
        kv = torch.zeros(params["wo"].shape[0], 2, bias_hm.shape[3],
                         params["wo"].shape[2], dtype=params["wqkv"].dtype,
                         device=tokens.device)
    if steps <= p0:
        return tokens, kv
    args, dtype, _ = _launch_args(
        params, bias_hm, posfull, mem_kv, kv, tokens, mask, gumbel,
        temperature, p0=p0, steps=steps, n_class=n_class, channels=channels,
        cross_hm=cross_hm, e_src_real=e_src_real)
    from .build import load
    lib = load("decode_scan")
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    code = lib.isi_decode_scan(ctypes.byref(args[0]),
                               ctypes.c_int(DTYPE_CODES[dtype]),
                               ctypes.c_void_p(stream))
    raise_on_error(lib, code, "fused_decode_scan")
    fused_decode_scan.launches += 1
    if lib.isi_decode_scan_heads(ctypes.byref(args[0]),
                                 ctypes.c_int(DTYPE_CODES[dtype])) > 1:
        fused_decode_scan.grouped_launches += 1
    return tokens, kv


def _launch_args(params, bias_hm, posfull, mem_kv, kv, tokens, mask, gumbel,
                 temperature, *, p0, steps, n_class, channels, cross_hm,
                 e_src_real):
    """The checked ``ScanParams`` of one launch (its scratch kept alive by
    the returned tuple) and the dtype."""
    mem_k, mem_v = mem_kv
    dtype = params["wqkv"].dtype
    n_layers, _, d = params["wo"].shape
    d_ff = params["b1"].shape[-1]
    _, steps_pad, nh, l_pad = bias_hm.shape
    e_pad = mem_v.shape[1]
    e_src = int(e_src_real) if e_src_real is not None else e_pad
    length = tokens.shape[0]
    dev = tokens.device
    check_cuda(
        {**{k: params[k] for k in _WEIGHTS}, "b_logits": params["b_logits"],
         "ln": params["ln"], "ln_final": params["ln_final"],
         "emb": params["emb_padded"], "posfull": posfull, "mem_k": mem_k,
         "mem_v": mem_v, "bias_hm": bias_hm, "cross_hm": cross_hm,
         "gumbel": gumbel, "mask": mask, "tokens": tokens, "kv": kv},
        {**{k: (dtype,) for k in _WEIGHTS}, "emb": (dtype,),
         "posfull": (dtype,), "mem_k": (dtype,), "mem_v": (dtype,),
         "kv": (dtype,), "b_logits": (torch.float32,),
         "ln": (torch.float32,), "ln_final": (torch.float32,),
         "bias_hm": (torch.float32,), "cross_hm": (torch.float32,),
         "gumbel": (torch.float32,), "mask": (torch.bool,),
         "tokens": (torch.int32,)})
    check_shape(params["wqkv"], "wqkv", (n_layers, 3 * d, d))
    check_shape(params["w1"], "w1", (n_layers, d_ff, d))
    check_shape(params["w_logits"], "w_logits", (n_class, d))
    check_shape(kv, "kv", (n_layers, 2, l_pad, d))
    check_shape(mem_v, "mem_v", (n_layers, e_pad, d))
    check_shape(gumbel, "gumbel", (steps - p0, n_class))
    check_shape(mask, "mask", (length,))
    if cross_hm is not None:
        check_shape(cross_hm, "cross_hm", (n_layers, steps_pad, nh, e_pad))
    if params["emb_padded"].shape[0] <= n_class:
        raise ValueError("emb_padded needs the all-zeros row n_class")
    if not (0 <= p0 < steps <= min(steps_pad, l_pad)
            and steps - channels < length):
        raise ValueError(f"bad scan range [{p0}, {steps})")
    reason = scan_refusal(d, nh, d_ff)
    if reason is not None:
        raise ValueError(reason)

    def f32(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    scratch = {"xbuf": f32(2, d), "part_att": f32(nh, d),
               "part_cross": f32(nh, d), "part_mlp": f32(CLUSTERS, d),
               "logits": f32(n_class)}
    args = _ScanParams(
        **{k: ptr(params[k]) for k in _WEIGHTS},
        b_logits=ptr(params["b_logits"]), ln=ptr(params["ln"]),
        ln_final=ptr(params["ln_final"]), emb=ptr(params["emb_padded"]),
        posfull=ptr(posfull), mem_k=ptr(mem_k), mem_v=ptr(mem_v),
        bias_hm=ptr(bias_hm), cross_hm=ptr(cross_hm), gumbel=ptr(gumbel),
        mask=ptr(mask), tokens=ptr(tokens), kv=ptr(kv),
        **{k: ptr(v) for k, v in scratch.items()},
        n_layers=n_layers, d=d, d_ff=d_ff, n_heads=nh, n_class=n_class,
        l_pad=l_pad, e_pad=e_pad, steps_pad=steps_pad, length=length,
        channels=channels, p0=p0, steps=steps, e_src=e_src,
        aligned=int(cross_hm is None), scale=1.0 / ((d // nh) ** 0.5),
        temperature=float(temperature))
    return (args, scratch), dtype, dev


def decode_scan_info(params: Dict[str, torch.Tensor], bias_hm: torch.Tensor,
                     posfull: torch.Tensor,
                     mem_kv: Tuple[torch.Tensor, torch.Tensor],
                     kv: Optional[torch.Tensor], tokens: torch.Tensor,
                     mask: torch.Tensor, gumbel: torch.Tensor,
                     temperature: float, **kwargs) -> Dict[str, int]:
    """The shape of the launch ``fused_decode_scan`` makes for these
    arguments (CUDA tensors): INFO_KEYS, from the kernel's own attributes
    (registers and spills as the compiler left them)."""
    from .build import load
    if kv is None:
        kv = torch.zeros(params["wo"].shape[0], 2, bias_hm.shape[3],
                         params["wo"].shape[2], dtype=params["wqkv"].dtype,
                         device=tokens.device)
    (args, _), dtype, _ = _launch_args(
        params, bias_hm, posfull, mem_kv, kv, tokens, mask, gumbel,
        temperature, **kwargs)
    lib = load("decode_scan")
    out = (ctypes.c_int * len(INFO_KEYS))()
    code = lib.isi_decode_scan_info(ctypes.byref(args),
                                    ctypes.c_int(DTYPE_CODES[dtype]), out)
    raise_on_error(lib, code, "decode_scan_info")
    return dict(zip(INFO_KEYS, out))


fused_decode_scan.launches = 0
fused_decode_scan.grouped_launches = 0
