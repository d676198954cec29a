"""Decode tables and the small-batch fused decode step.

Port of ``interactive_spectrogram_inpainting_tpu/ops/decode_step_kernel.py``:
the decode tables (``pack_decode_params``, ``precompute_mem_values``,
``precompute_cross_bias_rows``, ``precompute_position_features``,
``precompute_bias_rows``) as plain PyTorch, and ``fused_decode_step``, which
replaces the Pallas kernel of the same name: one token step for a small
batch (hand-written CUDA for sm_90a, ``csrc/decode_step.cu``).

One layout differs on purpose: the packed weight matrices are stored
``[out, in]`` (``nn.Linear``'s layout), the transpose of the JAX tables'
``[in, out]``, so that one warp of the CUDA kernels reads one output row
as contiguous 16-byte vectors. ``posfull`` has a batch dimension, so that
each sequence starts from its own class labels (the JAX table is row 0's:
``posfull[0]``). Every other table is elementwise the JAX one. The step
kernels take the head-major bias tables
(``bias_hm [n_layers, steps_pad, H, l_pad]``) whole and index them by
``pos``, where the JAX step is handed a ``[n_layers, l_pad, H]`` slice.

``fused_decode_step`` launches the kernel for CUDA tensors and runs
``decode_step_plain`` for CPU tensors, never falling back from one to the
other. Both step kernels go through a ``StepPlan``, built by the first step
of a generation and reused by the others (``step_plan``): the fixed
tensors are checked and the scratch allocated once, and a step is one
cooperative launch. ``fused_decode_step.launches`` counts its kernel
launches (one per step that reaches the GPU).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Tuple

import torch

from .common import (DTYPE_CODES, NEG_INF, check_shape, check_tensors,
                     layer_norm, ptr, raise_on_error, round_to, struct_type)

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_decode_params(model, dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-layer decoder weights: ``wqkv [n, 3d, d]``, ``wo``,
    ``wo_c``, ``wq_c [n, d, d]``, ``w1 [n, d_ff, d]``, ``w2 [n, d, d_ff]``,
    ``w_logits [n_class, d]`` and biases in ``dtype``; LayerNorm tables
    ``ln [n, 6, d]``, ``ln_final [2, d]`` and ``b_logits`` in float32;
    ``emb_padded [rows, d]``: the effective target embedding (embed @
    linear + bias) zero-padded to d lanes, with an all-zeros row at
    ``n_class`` for the start positions."""
    cfg = model.config
    d = cfg.d_model
    layers = model.decoder_layers

    def stack(fn):
        return torch.stack([fn(layer) for layer in layers])

    with torch.no_grad():
        out = {
            "wqkv": stack(lambda L: torch.cat(
                [L.self_attn.q.weight, L.self_attn.k.weight,
                 L.self_attn.v.weight], dim=0)),
            "bqkv": stack(lambda L: torch.cat(
                [L.self_attn.q.bias, L.self_attn.k.bias,
                 L.self_attn.v.bias])),
            "wo": stack(lambda L: L.self_attn.o.weight),
            "bo": stack(lambda L: L.self_attn.o.bias),
            "wo_c": stack(lambda L: L.cross_attn.o.weight),
            "bo_c": stack(lambda L: L.cross_attn.o.bias),
            "wq_c": stack(lambda L: L.cross_attn.q.weight),
            "bq_c": stack(lambda L: L.cross_attn.q.bias),
            "w1": stack(lambda L: L.mlp.fc1.weight),
            "b1": stack(lambda L: L.mlp.fc1.bias),
            "w2": stack(lambda L: L.mlp.fc2.weight),
            "b2": stack(lambda L: L.mlp.fc2.bias),
            "w_logits": model.project_logits.weight,
        }
        out = {k: v.to(dtype).contiguous() for k, v in out.items()}
        out["ln"] = stack(lambda L: torch.stack(
            [L.ln1.weight, L.ln1.bias, L.ln2.weight, L.ln2.bias,
             L.ln3.weight, L.ln3.bias])).float().contiguous()
        out["ln_final"] = torch.stack(
            [model.decoder_norm.weight,
             model.decoder_norm.bias]).float().contiguous()
        out["b_logits"] = model.project_logits.bias.float().contiguous()
        emb = (model.target_embed.weight
               @ model.target_embeddings_linear.weight.T
               + model.target_embeddings_linear.bias)
        n_class = emb.shape[0]
        emb_padded = torch.zeros(_round_up(n_class + 1, LANE), d,
                                 device=emb.device)
        emb_padded[:n_class, :cfg.embeddings_effective_dim] = emb
        out["emb_padded"] = emb_padded.to(dtype)
    return {k: v.detach() for k, v in out.items()}


def precompute_mem_values(model, memory: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K and V projections of the encoder memory, stacked
    per layer: two [n_layers, B, E_src, d] tensors in ``memory``'s dtype
    (projected in float32)."""
    ks, vs = [], []
    mem32 = memory.float()
    with torch.no_grad():
        for layer in model.decoder_layers:
            ca = layer.cross_attn
            ks.append(mem32 @ ca.k.weight.float().T + ca.k.bias.float())
            vs.append(mem32 @ ca.v.weight.float().T + ca.v.bias.float())
    return (torch.stack(ks).to(memory.dtype),
            torch.stack(vs).to(memory.dtype))


def precompute_cross_bias_rows(model, e_pad: int) -> Optional[torch.Tensor]:
    """cross rows [n_layers, steps_pad, e_pad, H] float32 (None when the
    decoder is aligned or has no cross bias)."""
    cfg = model.config
    if cfg.use_aligned_decoder or cfg.use_identity_memory_mask:
        return None
    c = cfg.target_num_channels
    steps = _round_up(c + cfg.target_sequence_length, LANE)
    h = cfg.conditional_model_nhead
    dev = model.device
    rows = []
    with torch.no_grad():
        for layer in model.decoder_layers:
            if layer.cross_bias is None:
                return None
            table = layer.cross_bias.rel_bias  # [H, Cq, 1, R]
            _, _, n_ck, max_rel = table.shape
            positions = torch.arange(steps, device=dev)
            e_q = positions // c
            c_q = positions % c
            keys = torch.arange(e_pad, device=dev)
            n_events_src = cfg.source_sequence_length + 1
            rel = torch.clamp(e_q[:, None] - keys[None, :]
                              + (n_events_src - 1), 0, max_rel - 1)
            flat_idx = c_q[:, None] * n_ck * max_rel + rel
            flat_table = table.reshape(h, -1)
            flat_idx = torch.clamp(flat_idx, 0, flat_table.shape[1] - 1)
            rows.append(flat_table[:, flat_idx].permute(1, 2, 0))
    return torch.stack(rows).float()


def precompute_position_features(model, start_block: torch.Tensor,
                                 pos_features: torch.Tensor,
                                 dtype: torch.dtype = torch.bfloat16
                                 ) -> torch.Tensor:
    """posfull [B, steps_pad, d]: each batch row's own start rows (from
    ``start_block [B, c, d]``, which carries that row's class labels), then
    the shared positional rows (the token embedding is added separately by
    the kernels). The JAX package builds one [steps_pad, d] table from row
    0's start rows; that table is ``posfull[0]``."""
    cfg = model.config
    d = cfg.d_model
    c = cfg.target_num_channels
    length = cfg.target_sequence_length
    eff = cfg.embeddings_effective_dim
    steps = _round_up(c + length, LANE)
    batch = start_block.shape[0]
    posfull = torch.zeros(batch, steps, d, device=pos_features.device)
    posfull[:, :c] = start_block.float()
    posfull[:, c:c + length, eff:eff + pos_features.shape[-1]] = \
        pos_features.float()
    return posfull.to(dtype)


def precompute_bias_rows(model, l_pad: int) -> torch.Tensor:
    """self rows [n_layers, steps_pad, l_pad, H] float32: the relative
    attention bias row of every query position, per layer."""
    cfg = model.config
    c = cfg.target_num_channels
    steps = _round_up(c + cfg.target_sequence_length, LANE)
    h = cfg.conditional_model_nhead
    dev = model.device
    rows = []
    with torch.no_grad():
        for layer in model.decoder_layers:
            table = layer.self_bias.rel_bias  # [H, C, C, R]
            _, _, n_ck, max_rel = table.shape
            positions = torch.arange(steps, device=dev)
            e_q = positions // c
            c_q = positions % c
            keys = torch.arange(l_pad, device=dev)
            e_k = keys // c
            c_k = keys % c
            rel = torch.clamp(e_q[:, None] - e_k[None, :]
                              + cfg.target_num_events, 0, max_rel - 1)
            flat_idx = (c_q[:, None] * n_ck + c_k[None, :]) * max_rel + rel
            row = table.reshape(h, -1)[:, flat_idx]  # [H, steps, l_pad]
            rows.append(row.permute(1, 2, 0))
    return torch.stack(rows).float()


# -- one decode step ----------------------------------------------------------

# keys per chunk of the plain batched version's running softmax (the JAX
# batched kernel's block_k); the flash decode attention's caches are whole
# chunks long
ATTN_CHUNK = 128
# the sampler hands batches above this size of an aligned decoder to the
# batched kernel (csrc/decode_step_batched.cu)
MAX_SMALL_BATCH = 4

_STEP_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "wq_c", "bq_c",
                 "w1", "b1", "w2", "b2", "w_logits")

_StepParams = struct_type(
    "StepParams",
    pointers=_STEP_WEIGHTS + (
        "b_logits", "ln", "ln_final", "emb", "posfull", "mem_k", "mem_v",
        "bias_hm", "cross_hm", "gumbel", "token_in", "cur_token",
        "token_out", "kv", "x", "qkv", "qc", "a", "mid", "logits"),
    ints=("n_layers", "d", "d_ff", "n_heads", "n_class", "batch", "l_pad",
          "e_pad", "steps_pad", "channels", "e_src", "aligned", "pos",
          "take", "grid"),
    floats=("scale", "inv_temperature"))


def _inv_temperature(temperature: float) -> float:
    """1 / temperature rounded to float32, as the kernels multiply by it."""
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.tensor(float(temperature), dtype=torch.float32))


def step_plain(params, bias_hm, posfull, mem_kv, kv, token_in, cur_token,
               pos, i_index, is_masked, gumbel, temperature, *, n_class,
               channels, cross_hm=None, e_src_real=None, chunk=None):
    """The arithmetic of one decode step in plain PyTorch, shared by the
    plain versions of both step kernels. ``chunk=None`` takes the softmax
    over the cache rows ``< pos`` in one shot (the small-batch kernel);
    an integer streams them in chunks of that many rows with a running
    softmax whose heavy intermediates (the query, the q.k products, the
    weights that multiply V and those products) are rounded to the cache
    dtype, as the batched kernel of the JAX package does. The fresh
    position enters last, as its own term; K/V of ``pos`` are written into
    ``kv`` in place."""
    mem_k, mem_v = mem_kv
    dtype = kv.dtype
    n_layers, _, batch, l_pad, d = kv.shape
    nh = bias_hm.shape[2]
    dh = d // nh
    scale = 1.0 / (dh ** 0.5)
    e_pad = mem_v.shape[2]
    e_src = int(e_src_real) if e_src_real is not None else e_pad
    pos, c = int(pos), channels

    def w(name, l=None):
        t = params[name] if l is None else params[name][l]
        return t.float()

    x = (params["emb_padded"][token_in[:, 0].long()].float()
         + posfull[:, pos].float())
    for l in range(n_layers):
        ln = params["ln"][l]
        h1 = round_to(layer_norm(x, ln[0], ln[1]), dtype)
        qkv = h1 @ w("wqkv", l).T + w("bqkv", l)
        q, k_i, v_i = (t.reshape(batch, nh, dh) for t in qkv.split(d, -1))
        bias_row = bias_hm[l, pos]  # [H, l_pad]
        lp = (q * k_i).sum(-1) * scale + bias_row[:, pos]  # [B, H]
        m = torch.full_like(lp, NEG_INF)
        denom = torch.zeros_like(lp)
        acc = torch.zeros_like(v_i)
        step_rows = pos if chunk is None else chunk
        inter = torch.float32 if chunk is None else dtype
        q_i = q.to(inter)
        for j0 in range(0, pos, max(step_rows, 1)):
            j1 = min(j0 + step_rows, pos)
            kc = kv[l, 0, :, j0:j1].to(inter).reshape(batch, j1 - j0, nh, dh)
            vc = kv[l, 1, :, j0:j1].to(inter).reshape(batch, j1 - j0, nh, dh)
            logits = (kc * q_i[:, None]).float().sum(-1).transpose(1, 2) \
                * scale + bias_row[None, :, j0:j1]  # [B, H, rows]
            m_new = torch.maximum(m, logits.max(-1).values)
            alpha = torch.exp(m - m_new)
            p_c = torch.exp(logits - m_new[..., None])
            denom = denom * alpha + p_c.sum(-1)
            pv = p_c.to(inter).transpose(1, 2)[..., None] * vc
            acc = acc * alpha[..., None] + pv.float().sum(1)
            m = m_new
        m_new = torch.maximum(m, lp)
        alpha = torch.exp(m - m_new)
        p_fresh = torch.exp(lp - m_new)
        denom = denom * alpha + p_fresh
        acc = acc * alpha[..., None] + p_fresh[..., None] * v_i
        a = (acc / denom.clamp_min(1e-20)[..., None]).reshape(batch, d)
        x = x + (round_to(a, dtype) @ w("wo", l).T + w("bo", l))
        if cross_hm is None:
            e_q = pos // c
            mv = (mem_v[l, :, e_q].float() if e_q < e_pad
                  else torch.zeros(batch, d, device=x.device))
        else:
            h2 = round_to(layer_norm(x, ln[2], ln[3]), dtype)
            q_c = (h2 @ w("wq_c", l).T + w("bq_c", l)).reshape(batch, nh, dh)
            mk = mem_k[l, :, :e_src].float().reshape(batch, e_src, nh, dh)
            lq = torch.einsum("bhd,behd->bhe", q_c, mk) * scale \
                + cross_hm[l, pos, :, :e_src][None]
            mv = torch.einsum(
                "bhe,behd->bhd", torch.softmax(lq, -1),
                mem_v[l, :, :e_src].float().reshape(batch, e_src, nh, dh)
            ).reshape(batch, d)
        x = x + (round_to(mv, dtype) @ w("wo_c", l).T + w("bo_c", l))
        h3 = round_to(layer_norm(x, ln[4], ln[5]), dtype)
        mid = torch.relu(h3 @ w("w1", l).T + w("b1", l))
        x = x + (round_to(mid, dtype) @ w("w2", l).T + w("b2", l))
        kv[l, 0, :, pos] = k_i.reshape(batch, d).to(dtype)
        kv[l, 1, :, pos] = v_i.reshape(batch, d).to(dtype)
    hf = round_to(layer_norm(x, params["ln_final"][0],
                             params["ln_final"][1]), dtype)
    logits = (hf @ w("w_logits").T + params["b_logits"]) \
        * _inv_temperature(temperature)
    winner = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
    if is_masked and i_index >= 0:
        return winner[:, None], kv
    return cur_token.to(torch.int32).clone(), kv


def decode_step_plain(params, bias_hm, posfull, mem_kv, kv, token_in,
                      cur_token, pos, i_index, is_masked, gumbel,
                      temperature, *, n_class, channels, cross_hm=None,
                      e_src_real=None, out=None):
    """Plain PyTorch version of ``fused_decode_step`` (same arguments, same
    result)."""
    new_tok, kv = step_plain(
        params, bias_hm, posfull, mem_kv, kv, token_in, cur_token, pos,
        i_index, is_masked, gumbel, temperature, n_class=n_class,
        channels=channels, cross_hm=cross_hm, e_src_real=e_src_real)
    if out is not None:
        out.copy_(new_tok)
        new_tok = out
    return new_tok, kv


PLANS_KEPT = 4  # plans cached per step kernel (most recent first)

# kernel -> (library, launch symbol, info symbol)
_STEP_LIBRARIES = {
    "fused_decode_step": ("decode_step", "isi_decode_step",
                          "isi_decode_step_info"),
    "fused_decode_step_batched": ("decode_step_batched",
                                  "isi_decode_step_batched",
                                  "isi_decode_step_batched_info"),
}
_INFO_KEYS = ("grid_blocks", "threads", "smem_bytes", "registers",
              "local_bytes", "barriers_per_step", "wide_kernel")

# The step kernels' limits and shared-memory plan, as in
# csrc/decode_step_persistent.cuh (step_shape_ok, operand_bytes, ff_tile).
STEP_DH_MAX = 128
_STEP_WARPS, _GROUP, _TILE_ROWS, _MAX_ITEMS = 16, 16, 8, 128
_PART_FLOATS = _MAX_ITEMS * (64 + 2)
_QS_FLOATS = _STEP_WARPS * 64
SMEM_BUDGET = 232448  # bytes of shared memory a block can have on the H100
H100_SMS = 132


def _step_layout(d: int, n_heads: int, d_ff: int, batch: int, es: int):
    """(shared bytes, fc2's column tile, rows of an fc2 pass, wide kernel)
    of a step kernel launch, as the kernel computes them."""
    dh = d // n_heads
    max_groups = 4 if es == 2 else 1
    fixed = 4 * (_PART_FLOATS + _STEP_WARPS * max(max_groups, 2) * 128
                 + _QS_FLOATS)
    kc = 32 if es == 2 else 16

    def a_stride(k):
        return ((k + 63) // 64) * 64 + 32 if es == 2 else k

    def region(kt, groups, wide):
        ops = max(_GROUP * (a_stride(max(d, kt)) + a_stride(d)),
                  groups * _GROUP * a_stride(d))
        warps = _STEP_WARPS // 2 if wide else _STEP_WARPS
        keys = warps * 2 * kc * ((128 if wide else 64) + 16 // es)
        return max(ops, keys) * es

    cw = 4 * (16 // es)
    all_groups = min(-(-batch // _GROUP), max_groups)
    wide = (dh > 64 or d > 32 * 32
            or region(d_ff, all_groups, False) + fixed > SMEM_BUDGET)
    kt, groups = d_ff, all_groups
    while wide and kt % (2 * cw) == 0 \
            and region(kt, 1, True) + fixed > SMEM_BUDGET:
        kt //= 2
    while wide and groups > 1 \
            and region(kt, groups, True) + fixed > SMEM_BUDGET:
        groups -= 1
    operand = region(kt, groups, wide)
    fit = operand // (_GROUP * a_stride(kt) * es)
    rows_ff = max(min(all_groups, max_groups, fit), 1) * _GROUP
    return operand + fixed, kt, rows_ff, wide


def step_refusal(d_model: int, n_heads: int, d_ff: int, dtype: torch.dtype,
                 l_pad: int, e_src: Optional[int] = None, batch: int = 64,
                 sms: int = H100_SMS) -> Optional[str]:
    """None when the step kernels (``fused_decode_step``,
    ``fused_decode_step_batched``) take this geometry on the card, else
    why not, naming the shape. ``e_src``: the source length of a
    relative-bias cross attention (None: aligned); ``batch``: the largest
    batch (the default covers every bucket)."""
    shape = (f"d_model {d_model}, {n_heads} heads, d_ff {d_ff}, "
             f"{str(dtype).replace('torch.', '')}")
    if n_heads < 1 or d_model % n_heads:
        return f"step kernels: {n_heads} heads do not divide d_model ({shape})"
    dh = d_model // n_heads
    es = 2 if dtype == torch.bfloat16 else 4
    cw = 4 * (16 // es)
    if dh % 8 or dh > STEP_DH_MAX:
        return (f"step kernels: head_dim {dh} is not a multiple of 8 up to "
                f"{STEP_DH_MAX} ({shape})")
    if d_model % cw or d_ff % cw:
        return (f"step kernels: d_model and d_ff must be multiples of {cw} "
                f"({shape})")
    kc = 32 if es == 2 else 16
    smem, kt, rows_ff, wide = _step_layout(d_model, n_heads, d_ff, batch, es)
    items = _PART_FLOATS // (dh + 2) if wide else _MAX_ITEMS
    for name, n in (("cache length", l_pad), ("source length", e_src)):
        if n is not None and -(-n // kc) > items:
            return (f"step kernels: {name} {n} exceeds {items * kc} keys "
                    f"({shape})")
    if smem > SMEM_BUDGET:
        return (f"step kernels: {smem} bytes of shared memory exceed "
                f"{SMEM_BUDGET} ({shape})")
    tile_rows = _TILE_ROWS * -(-(d_model // _TILE_ROWS) // sms)
    if kt < d_ff and rows_ff * tile_rows > _PART_FLOATS:
        return f"step kernels: fc2's column tiles do not fit ({shape})"
    return None


def _fixed_tensors(params, bias_hm, posfull, mem_kv, kv, cross_hm):
    """The tensors that stay the same across the steps of a generation."""
    return (tuple(params[k] for k in _STEP_WEIGHTS)
            + (params["b_logits"], params["ln"], params["ln_final"],
               params["emb_padded"], bias_hm, posfull, mem_kv[0], mem_kv[1],
               kv, cross_hm))


class StepPlan:
    """The per-generation state of a step kernel: its fixed tensors checked
    once, its scratch allocated once and its ``StepParams`` built once, so
    that a step only sets ``pos``, ``take`` and the token and noise
    pointers (``bind``) and launches.

    A plan holds weak references to its fixed tensors (params, bias_hm,
    posfull, the memory, kv, cross_hm) and matches a call whose tensors are
    the same objects at the same addresses, with the same scalars; any
    other call builds a new plan (``step_plan``). On the CPU a plan holds
    no scratch and launches nothing: the wrappers run the plain version
    there. On CUDA the build checks ``step_refusal``, asks the kernel for
    its grid and refuses
    (raises) a shape it does not take. ``StepPlan.builds`` counts the plans
    built in this process."""

    builds = 0

    def __init__(self, kernel: str, params, bias_hm, posfull, mem_kv, kv, *,
                 n_class: int, channels: int, cross_hm=None,
                 e_src_real=None, temperature: float = 1.0):
        self.kernel = kernel
        mem_k, mem_v = mem_kv
        dtype = kv.dtype
        if kv.dim() != 5:
            raise ValueError("kv must be [n_layers, 2, B, l_pad, d], got "
                             f"{tuple(kv.shape)}")
        n_layers, _, batch, l_pad, d = kv.shape
        d_ff = params["b1"].shape[-1]
        _, steps_pad, nh, _ = bias_hm.shape
        e_pad = mem_v.shape[2]
        e_src = int(e_src_real) if e_src_real is not None else e_pad
        check_tensors(
            {**{k: params[k] for k in _STEP_WEIGHTS},
             "b_logits": params["b_logits"], "ln": params["ln"],
             "ln_final": params["ln_final"], "emb": params["emb_padded"],
             "posfull": posfull, "mem_k": mem_k, "mem_v": mem_v,
             "bias_hm": bias_hm, "cross_hm": cross_hm, "kv": kv},
            {**{k: (dtype,) for k in _STEP_WEIGHTS}, "emb": (dtype,),
             "posfull": (dtype,), "mem_k": (dtype,), "mem_v": (dtype,),
             "kv": tuple(DTYPE_CODES), "b_logits": (torch.float32,),
             "ln": (torch.float32,), "ln_final": (torch.float32,),
             "bias_hm": (torch.float32,), "cross_hm": (torch.float32,)})
        check_shape(params["wqkv"], "wqkv", (n_layers, 3 * d, d))
        check_shape(params["w1"], "w1", (n_layers, d_ff, d))
        check_shape(params["w_logits"], "w_logits", (n_class, d))
        check_shape(bias_hm, "bias_hm", (n_layers, steps_pad, nh, l_pad))
        check_shape(mem_k, "mem_k", (n_layers, batch, e_pad, d))
        check_shape(mem_v, "mem_v", (n_layers, batch, e_pad, d))
        check_shape(posfull, "posfull", (batch, steps_pad, d))
        if cross_hm is not None:
            check_shape(cross_hm, "cross_hm",
                        (n_layers, steps_pad, nh, e_pad))
        if params["emb_padded"].shape[0] <= n_class:
            raise ValueError("emb_padded needs the all-zeros row n_class")
        fixed = _fixed_tensors(params, bias_hm, posfull, mem_kv, kv,
                               cross_hm)
        self._refs = tuple(None if t is None else (weakref.ref(t),
                                                   t.data_ptr())
                           for t in fixed)
        self.scalars = (n_class, channels, e_src_real, float(temperature))
        self.device, self.dtype = kv.device, dtype
        self.batch, self.n_class = batch, n_class
        self.pos_limit = min(steps_pad, l_pad)
        self.scratch = {}
        self.info = None
        if kv.device.type == "cuda":
            reason = step_refusal(
                d, nh, d_ff, dtype, l_pad,
                None if cross_hm is None else e_src, batch,
                torch.cuda.get_device_properties(
                    kv.device).multi_processor_count)
            if reason is not None:
                raise ValueError(reason)

            def f32(*shape):
                return torch.empty(shape, device=kv.device,
                                   dtype=torch.float32)

            def tdt(*shape):
                return torch.empty(shape, device=kv.device, dtype=dtype)

            self.scratch = {
                "x": f32(batch, d), "qkv": f32(batch, 3 * d),
                "qc": f32(batch, d), "a": tdt(batch, d),
                "mid": tdt(batch, d_ff), "logits": f32(batch, n_class)}
        self.args = _StepParams(
            **{k: ptr(params[k]) for k in _STEP_WEIGHTS},
            b_logits=ptr(params["b_logits"]), ln=ptr(params["ln"]),
            ln_final=ptr(params["ln_final"]),
            emb=ptr(params["emb_padded"]), posfull=ptr(posfull),
            mem_k=ptr(mem_k), mem_v=ptr(mem_v), bias_hm=ptr(bias_hm),
            cross_hm=ptr(cross_hm), kv=ptr(kv),
            **{k: ptr(v) for k, v in self.scratch.items()},
            n_layers=n_layers, d=d, d_ff=d_ff, n_heads=nh, n_class=n_class,
            batch=batch, l_pad=l_pad, e_pad=e_pad, steps_pad=steps_pad,
            channels=channels, e_src=e_src, aligned=int(cross_hm is None),
            pos=0, take=0, grid=0,
            scale=1.0 / ((d // nh) ** 0.5),
            inv_temperature=_inv_temperature(temperature))
        self._dtype_code = ctypes.c_int(DTYPE_CODES[dtype])
        self._launch = None
        if kv.device.type == "cuda":
            library, symbol, info_symbol = _STEP_LIBRARIES[kernel]
            from .build import load
            lib = load(library)
            info = (ctypes.c_int * len(_INFO_KEYS))()
            code = getattr(lib, info_symbol)(ctypes.byref(self.args),
                                             self._dtype_code, info)
            if code != 0:
                lib.isi_error_string.restype = ctypes.c_char_p
                raise RuntimeError(
                    f"{kernel} does not take this shape (B {batch}, d {d}, "
                    f"d_ff {d_ff}, {nh} heads, {dtype}): CUDA error {code} "
                    f"({lib.isi_error_string(code).decode()})")
            self.info = dict(zip(_INFO_KEYS, info))
            self.args.grid = self.info["grid_blocks"]
            self._lib = lib
            self._launch = getattr(lib, symbol)
            self._launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
            self._launch.restype = ctypes.c_int
        StepPlan.builds += 1

    def matches(self, fixed, scalars) -> bool:
        if scalars != self.scalars:
            return False
        for ref, t in zip(self._refs, fixed):
            if ref is None or t is None:
                if ref is not t:
                    return False
            elif ref[0]() is not t or ref[1] != t.data_ptr():
                return False
        return True

    def bind(self, token_in, cur_token, pos, i_index, is_masked, gumbel,
             out=None):
        """Check one step's own arguments and set them in the params:
        ``pos``, ``take`` and the token_in / cur_token / out / gumbel
        pointers. -> ``out`` (allocated when None)."""
        if out is None:
            out = torch.empty(self.batch, 1, dtype=torch.int32,
                              device=self.device)
        for name, t, dt, shape in (
                ("token_in", token_in, torch.int32, (self.batch, 1)),
                ("cur_token", cur_token, torch.int32, (self.batch, 1)),
                ("out", out, torch.int32, (self.batch, 1)),
                ("gumbel", gumbel, torch.float32,
                 (self.batch, self.n_class))):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, expected "
                                 f"{self.device}")
            if t.dtype != dt:
                raise ValueError(f"{name} has dtype {t.dtype}, expected "
                                 f"{dt}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            check_shape(t, name, shape)
        pos = int(pos)
        if not 0 <= pos < self.pos_limit:
            raise ValueError(f"pos={pos} outside the tables")
        args = self.args
        args.pos = pos
        args.take = int(bool(is_masked) and int(i_index) >= 0)
        args.token_in = token_in.data_ptr()
        args.cur_token = cur_token.data_ptr()
        args.token_out = out.data_ptr()
        args.gumbel = gumbel.data_ptr()
        return out

    def launch(self) -> None:
        """One step on the current stream: a single cooperative launch."""
        if self._launch is None:
            raise ValueError(f"{self.kernel} launches only on CUDA tensors")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        code = self._launch(ctypes.addressof(self.args), self._dtype_code,
                            stream)
        raise_on_error(self._lib, code, self.kernel)


_PLANS: Dict[str, list] = {}


def step_plan(kernel: str, params, bias_hm, posfull, mem_kv, kv, *,
              n_class: int, channels: int, cross_hm=None, e_src_real=None,
              temperature: float = 1.0) -> StepPlan:
    """The plan of step kernel ``kernel`` for these fixed tensors: a cached
    one when they are the same objects, else a new one (the
    ``PLANS_KEPT`` most recent are kept)."""
    fixed = _fixed_tensors(params, bias_hm, posfull, mem_kv, kv, cross_hm)
    scalars = (n_class, channels, e_src_real, float(temperature))
    plans = _PLANS.setdefault(kernel, [])
    for i, plan in enumerate(plans):
        if plan.matches(fixed, scalars):
            if i:
                plans.insert(0, plans.pop(i))
            return plan
    plan = StepPlan(kernel, params, bias_hm, posfull, mem_kv, kv,
                    n_class=n_class, channels=channels, cross_hm=cross_hm,
                    e_src_real=e_src_real, temperature=temperature)
    plans.insert(0, plan)
    del plans[PLANS_KEPT:]
    return plan


def fused_decode_step(params: Dict[str, torch.Tensor],
                      bias_hm: torch.Tensor, posfull: torch.Tensor,
                      mem_kv: Tuple[torch.Tensor, torch.Tensor],
                      kv: torch.Tensor, token_in: torch.Tensor,
                      cur_token: torch.Tensor, pos: int, i_index: int,
                      is_masked: bool, gumbel: torch.Tensor,
                      temperature: float, *, n_class: int, channels: int,
                      cross_hm: Optional[torch.Tensor] = None,
                      e_src_real: Optional[int] = None,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused decode step for a small batch (2 to 4 sequences, and the
    relative-bias top prior at any batch, in groups of 16).

    params: ``pack_decode_params`` tables; bias_hm [n_layers, steps_pad, H,
    l_pad] float32 (row ``pos`` is read); posfull [B, steps_pad, d] (each
    row's start rows, then the positional rows); mem_kv
    (mem_k, mem_v) [n_layers, B, E_pad, d]; kv [n_layers, 2, B, l_pad, d],
    updated in place (row ``pos`` of every layer); token_in / cur_token
    [B, 1] int32 (``n_class`` in token_in selects the all-zeros start row);
    pos, i_index, is_masked: scalars of the launch, known on the host;
    gumbel [B, n_class] float32; cross_hm [n_layers, steps_pad, H, E_pad]
    float32 or None (aligned decoders); e_src_real: real source length;
    out: optional [B, 1] int32 tensor to write the tokens into (it may be
    ``cur_token`` itself). Returns (new_token [B, 1], kv): the sampled token
    where ``is_masked and i_index >= 0``, else ``cur_token``."""
    plan = step_plan("fused_decode_step", params, bias_hm, posfull, mem_kv,
                     kv, n_class=n_class, channels=channels,
                     cross_hm=cross_hm, e_src_real=e_src_real,
                     temperature=temperature)
    out = plan.bind(token_in, cur_token, pos, i_index, is_masked, gumbel,
                    out)
    if kv.device.type != "cuda":
        return decode_step_plain(
            params, bias_hm, posfull, mem_kv, kv, token_in, cur_token, pos,
            i_index, is_masked, gumbel, temperature, n_class=n_class,
            channels=channels, cross_hm=cross_hm, e_src_real=e_src_real,
            out=out)
    plan.launch()
    fused_decode_step.launches += 1
    return out, kv


fused_decode_step.launches = 0
