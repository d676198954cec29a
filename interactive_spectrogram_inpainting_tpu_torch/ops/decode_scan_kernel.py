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
launch per call) for CUDA tensors and runs ``decode_scan_plain`` for CPU
tensors, never falling back from one to the other.
``fused_decode_scan.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .common import (DTYPE_CODES, check_cuda, check_shape, layer_norm, ptr,
                     raise_on_error, round_to, struct_type)

CHUNK = 64  # keys per attention partial in csrc/decode_scan.cu

_ScanParams = struct_type(
    "ScanParams",
    pointers=("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
              "w1", "b1", "w2", "b2", "w_logits", "b_logits", "ln",
              "ln_final", "emb", "posfull", "mem_k", "mem_v", "bias_hm",
              "cross_hm", "gumbel", "mask", "tokens", "kv", "x", "qkv",
              "qc", "mid", "logits", "part"),
    ints=("n_layers", "d", "d_ff", "n_heads", "n_class", "l_pad", "e_pad",
          "steps_pad", "length", "channels", "p0", "steps", "e_src",
          "aligned", "max_chunks"),
    floats=("scale", "temperature"))

_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
            "w1", "b1", "w2", "b2", "w_logits")


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
    """Plain PyTorch version of the kernel (same arguments, same result).
    The token loop stays on the device: no value is read back per step."""
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
            x = x + (round_to(a, dtype) @ w["wo"][l].T + w["bo"][l])
            kv[l, 0, p] = k_i.reshape(d).to(dtype)
            kv[l, 1, p] = v_i.reshape(d).to(dtype)
            if cross_hm is None:
                e_q = p // c
                mv = (mem_v[l, e_q].float() if e_q < e_pad
                      else torch.zeros(d, device=dev))
            else:
                h2 = round_to(layer_norm(x, ln[2], ln[3]), dtype)
                q_c = (h2 @ w["wq_c"][l].T + w["bq_c"][l]).reshape(nh, dh)
                mk = mem_k[l, :e_src].float().reshape(e_src, nh, dh)
                lq = torch.einsum("hd,ehd->he", q_c, mk) * scale \
                    + cross_hm[l, p, :, :e_src]
                mv = torch.einsum(
                    "he,ehd->hd", torch.softmax(lq, -1),
                    mem_v[l, :e_src].float().reshape(e_src, nh, dh)
                ).reshape(d)
            x = x + (round_to(mv, dtype) @ w["wo_c"][l].T + w["bo_c"][l])
            h3 = round_to(layer_norm(x, ln[4], ln[5]), dtype)
            mid = torch.relu(h3 @ w["w1"][l].T + w["b1"][l])
            x = x + (round_to(mid, dtype) @ w["w2"][l].T + w["b2"][l])
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
    from .build import load
    mem_k, mem_v = mem_kv
    dtype = params["wqkv"].dtype
    n_layers, _, d = params["wo"].shape
    d_ff = params["b1"].shape[-1]
    _, steps_pad, nh, l_pad = bias_hm.shape
    e_pad = mem_v.shape[1]
    e_src = int(e_src_real) if e_src_real is not None else e_pad
    length = tokens.shape[0]
    dev = tokens.device
    if kv is None:
        kv = torch.zeros(n_layers, 2, l_pad, d, dtype=dtype, device=dev)
    tokens = tokens.clone()
    if steps <= p0:
        return tokens, kv
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
    max_chunks = (max(l_pad, e_pad) + CHUNK - 1) // CHUNK
    if d % nh or (d // nh) % 8 or d // nh > 64 or d_ff % 8 \
            or max_chunks > 32:
        raise ValueError("head_dim must be a multiple of 8 and <= 64, d_ff "
                         "a multiple of 8, and caches at most 2048 rows")

    def f32(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    scratch = {"x": f32(d), "qkv": f32(3 * d), "qc": f32(d),
               "mid": f32(d_ff), "logits": f32(n_class),
               "part": f32(nh * max_chunks * (d // nh + 4))}
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
        aligned=int(cross_hm is None), max_chunks=max_chunks,
        scale=1.0 / ((d // nh) ** 0.5), temperature=float(temperature))
    lib = load("decode_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.isi_decode_scan(ctypes.byref(args),
                               ctypes.c_int(DTYPE_CODES[dtype]),
                               ctypes.c_void_p(stream))
    raise_on_error(lib, code, "fused_decode_scan")
    fused_decode_scan.launches += 1
    return tokens, kv


fused_decode_scan.launches = 0
