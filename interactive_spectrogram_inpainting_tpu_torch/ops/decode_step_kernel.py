"""Decode tables for the fused sampling kernels, as plain PyTorch.

Port of the table builders of
``interactive_spectrogram_inpainting_tpu/ops/decode_step_kernel.py``
(``pack_decode_params``, ``precompute_mem_values``,
``precompute_cross_bias_rows``, ``precompute_position_features``,
``precompute_bias_rows``). The per-step kernel of that module
(``fused_decode_step``, batch 2-4) is not ported yet.

One layout differs on purpose: the packed weight matrices are stored
``[out, in]`` (``nn.Linear``'s layout), the transpose of the JAX tables'
``[in, out]``, so that one warp of the CUDA kernels reads one output row
as contiguous 16-byte vectors. Every other table is elementwise the JAX
one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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
    """posfull [steps_pad, d]: start rows then positional rows (the token
    embedding is added separately by the kernels)."""
    cfg = model.config
    d = cfg.d_model
    c = cfg.target_num_channels
    length = cfg.target_sequence_length
    eff = cfg.embeddings_effective_dim
    steps = _round_up(c + length, LANE)
    posfull = torch.zeros(steps, d, device=pos_features.device)
    posfull[:c] = start_block[0].float()
    posfull[c:c + length, eff:eff + pos_features.shape[-1]] = \
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
