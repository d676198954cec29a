"""Relative attention over (events x channels) codemap grids.

Port of ``interactive_spectrogram_inpainting_tpu/models/prior/attention.py``.
A sequence position ``i`` sits on the grid at event ``e_i = i // C`` and
channel ``c_i = i % C``; the learned bias is

    bias[h, i, j] = table[h, c_i, c_j, clip(e_i - e_j + (E_k - 1))]

Layers are pre-LN. LayerNorm epsilon is flax's 1e-6 (PyTorch's default is
1e-5). Projections are ``nn.Linear`` over the flattened ``H * Dh`` head
axis; ``utils/weights.py`` maps the flax ``DenseGeneral`` kernels onto
them.

Dropout sits where the JAX layers have it: after the feed-forward ``relu``
and on the self- and cross-attention outputs. A layer's forward takes a
``dropout_seed``: ``None`` is the deterministic (evaluation) forward; an
integer seeds a generator of the layer's own on the activations' device,
so that a forward recomputed under ``torch.utils.checkpoint`` draws the
same masks.

On a mesh (``parallel/mesh.py::shard_prior_parameters``) the layers hold
this rank's shard: ``MultiHeadAttention`` and ``RelativeAttentionBias`` its
``H / n_model`` heads, ``FeedForward`` its ``d_ff / n_model`` columns, with
the Megatron collectives of ``parallel/collectives.py`` around them. Each
layer draws its dropout masks for the whole batch (and every d_ff column)
and applies this rank's block, so a step computes what one process
computes on the global batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.decode_attention import flash_decode_attention
from ...ops.train_attention import fused_train_attention
from ...parallel.collectives import copy_to_model, reduce_from_model

NEG_INF = -1e9
LN_EPS = 1e-6


def grid_coords(length: int, num_channels: int,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(length, device=device)
    return idx // num_channels, idx % num_channels  # events, channels


def layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=LN_EPS)


def dropout_generator(seed: Optional[int], device: torch.device
                      ) -> Optional[torch.Generator]:
    """The generator of one layer's dropout masks (``None``: no dropout)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


NO_SPLIT = (1, 0)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            rows: Tuple[int, int] = NO_SPLIT,
            cols: Tuple[int, int] = NO_SPLIT) -> torch.Tensor:
    """flax ``Dropout``: keep each element with probability ``1 - rate`` and
    scale it by ``1 / (1 - rate)``; the identity without a generator or at
    rate 0.

    ``rows`` / ``cols`` = (blocks, this block): ``x`` is one block of a
    tensor split into equal blocks along its first / last axis. The mask is
    drawn for the whole tensor and this block of it applied, so the bits do
    not depend on the split."""
    if generator is None or rate == 0.0:
        return x
    (n_rows, row), (n_cols, col) = rows, cols
    b, d = x.shape[0], x.shape[-1]
    keep = torch.empty((b * n_rows,) + tuple(x.shape[1:-1]) + (d * n_cols,),
                       dtype=x.dtype, device=x.device).bernoulli_(
                           1.0 - rate, generator=generator)
    keep = keep[row * b:(row + 1) * b, ..., col * d:(col + 1) * d]
    return x * keep / (1.0 - rate)


class RelativeAttentionBias(nn.Module):
    """Learned bias table indexed by (head, q-channel, k-channel, rel event)."""

    def __init__(self, num_heads: int, num_channels_q: int,
                 num_events_q: int, num_channels_k: int, num_events_k: int):
        super().__init__()
        self.num_heads = num_heads
        self.num_channels_q = num_channels_q
        self.num_events_q = num_events_q
        self.num_channels_k = num_channels_k
        self.num_events_k = num_events_k
        max_rel = num_events_q + num_events_k - 1
        self.rel_bias = nn.Parameter(0.02 * torch.randn(
            num_heads, num_channels_q, num_channels_k, max_rel))

    def full(self, len_q: int, len_k: int) -> torch.Tensor:
        """[H, len_q, len_k] dense bias."""
        dev = self.rel_bias.device
        e_q, c_q = grid_coords(len_q, self.num_channels_q, dev)
        e_k, c_k = grid_coords(len_k, self.num_channels_k, dev)
        max_rel = self.rel_bias.shape[-1]
        # clamp: padded positions produce out-of-range offsets
        rel = torch.clamp(e_q[:, None] - e_k[None, :]
                          + (self.num_events_k - 1), 0, max_rel - 1)
        flat_idx = ((c_q[:, None] * self.num_channels_k + c_k[None, :])
                    * max_rel + rel)
        flat_table = self.rel_bias.reshape(self.rel_bias.shape[0], -1)
        flat_idx = torch.clamp(flat_idx, 0, flat_table.shape[1] - 1)
        return flat_table[:, flat_idx]

    def row(self, pos: int, len_k: int) -> torch.Tensor:
        """[H, len_k] bias for a single query position ``pos``."""
        dev = self.rel_bias.device
        e_q = pos // self.num_channels_q
        c_q = min(max(pos % self.num_channels_q, 0),
                  self.num_channels_q - 1)
        e_k, c_k = grid_coords(len_k, self.num_channels_k, dev)
        max_rel = self.rel_bias.shape[-1]
        rel = torch.clamp(e_q - e_k + (self.num_events_k - 1),
                          0, max_rel - 1)
        t = self.rel_bias[:, c_q][:, c_k, :]  # [H, len_k, max_rel]
        index = rel[None, :, None].expand(t.shape[0], -1, 1)
        return torch.gather(t, -1, index)[..., 0]


class MultiHeadAttention(nn.Module):
    """MHA with additive bias/mask and a cached single-query step.

    ``use_fused=True`` routes the batched forward through
    ``ops/train_attention.py`` (the training kernels on the GPU): the bias
    and the mask are folded into one float32 ``ab [H, Lq, Lk]`` and the
    probabilities never reach device memory. Parameters and outputs are the
    same either way (up to bf16 rounding).

    ``model_group`` (set by ``shard_prior_parameters``): the projections
    hold this rank's heads; the replicated inputs enter through
    ``copy_to_model``, ``o``'s partial products leave through
    ``reduce_from_model`` and its bias is added once, after it."""

    model_group = None

    def __init__(self, d_model: int, num_heads: int, use_fused: bool = False):
        super().__init__()
        assert d_model % num_heads == 0
        self.d_model = d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.use_fused = use_fused
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.o = nn.Linear(d_model, d_model)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[:-1] + (-1, self.head_dim))

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """[..., H, Dh] heads -> the ``o`` projection [..., d]."""
        out = out.reshape(out.shape[:-2] + (-1,))
        if self.model_group is None:
            return self.o(out)
        return (reduce_from_model(F.linear(out, self.o.weight),
                                  self.model_group) + self.o.bias)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_in [B, Lq, d], kv_in [B, Lk, d]; bias [H, Lq, Lk];
        mask additive [Lq, Lk] (0 = keep, NEG_INF = drop)."""
        if self.model_group is not None:
            same = kv_in is q_in
            q_in = copy_to_model(q_in, self.model_group)
            kv_in = q_in if same else copy_to_model(kv_in, self.model_group)
        q = self._heads(self.q(q_in))
        k = self._heads(self.k(kv_in))
        v = self._heads(self.v(kv_in))
        if self.use_fused:
            ab = torch.zeros(q.shape[2], q.shape[1], k.shape[1],
                             device=q.device, dtype=torch.float32)
            if bias is not None:
                ab = ab + bias.float()
            if mask is not None:
                ab = ab + mask[None].float()
            return self._out(fused_train_attention(q, k, v, ab))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits / math.sqrt(float(self.head_dim))
        if bias is not None:
            logits = logits + bias[None].to(logits.dtype)
        if mask is not None:
            logits = logits + mask[None, None].to(logits.dtype)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
        return self._out(out)

    def project_kv(self, kv_in: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V for caching ([B, Lk, H, Dh] each)."""
        return self._heads(self.k(kv_in)), self._heads(self.v(kv_in))

    def step(self, q_in: torch.Tensor, k_cache: torch.Tensor,
             v_cache: torch.Tensor,
             bias_row: Optional[torch.Tensor] = None,
             mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_in [B, d]; k_cache/v_cache [B, Lk, H, Dh];
        bias_row [H, Lk]; mask_row additive [Lk]. -> [B, d]"""
        q = self._heads(self.q(q_in))  # [B, H, Dh]
        logits = torch.einsum("bhd,bkhd->bhk", q.float(), k_cache.float())
        logits = logits / math.sqrt(float(self.head_dim))
        if bias_row is not None:
            logits = logits + bias_row[None].to(logits.dtype)
        if mask_row is not None:
            logits = logits + mask_row[None, None].to(logits.dtype)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", weights.to(v_cache.dtype),
                           v_cache)
        return self.o(out.reshape(out.shape[0], self.d_model))


class FeedForward(nn.Module):
    """``fc2(dropout(relu(fc1(x))))``. With ``model_group`` (set by
    ``shard_prior_parameters``) ``fc1`` holds this rank's d_ff rows and
    ``fc2`` its d_ff columns (block ``cols``); ``rows`` is this rank's block
    of the batch, for the dropout mask."""

    model_group = None
    rows = cols = NO_SPLIT

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.model_group is None:
            return self.fc2(dropout(F.relu(self.fc1(x)), self.dropout,
                                    generator, self.rows))
        h = F.relu(self.fc1(copy_to_model(x, self.model_group)))
        h = dropout(h, self.dropout, generator, self.rows, self.cols)
        return (reduce_from_model(F.linear(h, self.fc2.weight),
                                  self.model_group) + self.fc2.bias)


class EncoderLayer(nn.Module):
    rows = NO_SPLIT  # this rank's block of the batch (dropout masks)

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_channels: int, num_events: int, dropout: float = 0.0,
                 fused_attention: bool = False):
        super().__init__()
        self.self_bias = RelativeAttentionBias(
            num_heads, num_channels, num_events, num_channels, num_events)
        self.self_attn = MultiHeadAttention(d_model, num_heads,
                                            use_fused=fused_attention)
        self.ln1 = layer_norm(d_model)
        self.ln2 = layer_norm(d_model)
        self.mlp = FeedForward(d_model, d_ff, dropout)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        gen = dropout_generator(dropout_seed, x.device)
        length = x.shape[1]
        bias = self.self_bias.full(length, length)
        h = self.ln1(x)
        x = x + dropout(self.self_attn(h, h, bias=bias, mask=mask),
                        self.dropout, gen, self.rows)
        return x + self.mlp(self.ln2(x), gen)


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer with relative self bias and configurable cross
    bias; ``aligned=True`` restricts cross attention to the source token
    whose patch contains the query."""

    rows = NO_SPLIT  # this rank's block of the batch (dropout masks)

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_channels_encoder: int, num_events_encoder: int,
                 num_channels_decoder: int, num_events_decoder: int,
                 cross_bias_type: str = "relative_attention_target_source",
                 aligned: bool = False, dropout: float = 0.0,
                 fused_attention: bool = False):
        super().__init__()
        self.num_channels_decoder = num_channels_decoder
        self.aligned = aligned
        self.dropout = dropout
        self.self_bias = RelativeAttentionBias(
            num_heads, num_channels_decoder, num_events_decoder,
            num_channels_decoder, num_events_decoder)
        if cross_bias_type == "relative_attention_target_source":
            self.cross_bias = RelativeAttentionBias(
                num_heads, num_channels_decoder, num_events_decoder,
                num_channels_encoder, num_events_encoder)
        elif cross_bias_type == "no_bias":
            self.cross_bias = None
        else:
            raise ValueError(cross_bias_type)
        self.self_attn = MultiHeadAttention(d_model, num_heads,
                                            use_fused=fused_attention)
        self.cross_attn = MultiHeadAttention(d_model, num_heads,
                                             use_fused=fused_attention)
        self.ln1 = layer_norm(d_model)
        self.ln2 = layer_norm(d_model)
        self.ln3 = layer_norm(d_model)
        self.mlp = FeedForward(d_model, d_ff, dropout)

    def _aligned_mask(self, len_q: int, len_k: int) -> torch.Tensor:
        """Target event e sees only source position e."""
        dev = self.ln1.weight.device
        e_q, _ = grid_coords(len_q, self.num_channels_decoder, dev)
        j = torch.arange(len_k, device=dev)
        allowed = e_q[:, None] == j[None, :]
        return torch.where(allowed, 0.0, NEG_INF)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        gen = dropout_generator(dropout_seed, x.device)
        len_q = x.shape[1]
        len_k = memory.shape[1]
        self_bias = self.self_bias.full(len_q, len_q)
        h = self.ln1(x)
        x = x + dropout(self.self_attn(h, h, bias=self_bias, mask=tgt_mask),
                        self.dropout, gen, self.rows)
        cross_bias = (self.cross_bias.full(len_q, len_k)
                      if self.cross_bias is not None else None)
        cross_mask = memory_mask
        if self.aligned:
            aligned = self._aligned_mask(len_q, len_k)
            cross_mask = aligned if cross_mask is None else (
                cross_mask + aligned)
        x = x + dropout(self.cross_attn(self.ln2(x), memory,
                                        bias=cross_bias, mask=cross_mask),
                        self.dropout, gen, self.rows)
        return x + self.mlp(self.ln3(x), gen)

    # -- KV-cached decode ---------------------------------------------------
    def init_memory_kv(self, memory: torch.Tensor):
        return self.cross_attn.project_kv(memory)

    def project_self_kv(self, x: torch.Tensor):
        """K/V of the (pre-LN'd) input for priming the self cache."""
        return self.self_attn.project_kv(self.ln1(x))

    def step(self, x_i: torch.Tensor, pos: int, k_self: torch.Tensor,
             v_self: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
             use_flash: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One query position against caches [B, L, H, Dh] (the port keeps
        this one cache layout; the JAX package's L-minor layout serves its
        TPU tiling).

        Writes this position's fresh K/V into ``k_self``/``v_self`` in
        place (entries > pos are ignored through the causal mask) and
        returns (out_i [B, d], k_self, v_self). ``use_flash`` runs the self
        attention through ``ops/decode_attention.py`` (the cache length must
        then be a multiple of 128)."""
        l_tgt = k_self.shape[1]
        l_src = mem_k.shape[1]
        h = self.ln1(x_i)
        k_self[:, pos] = self.self_attn._heads(
            self.self_attn.k(h)).to(k_self.dtype)
        v_self[:, pos] = self.self_attn._heads(
            self.self_attn.v(h)).to(v_self.dtype)
        dev = x_i.device
        self_bias_row = self.self_bias.row(pos, l_tgt)
        if use_flash:
            attn = self.self_attn
            q = attn._heads(attn.q(h)).contiguous()  # [B, H, Dh]
            a = flash_decode_attention(q, k_self, v_self, pos, self_bias_row)
            a = attn.o(a.reshape(a.shape[0], attn.d_model))
        else:
            causal_row = torch.where(torch.arange(l_tgt, device=dev) <= pos,
                                     0.0, NEG_INF)
            a = self.self_attn.step(h, k_self, v_self,
                                    bias_row=self_bias_row,
                                    mask_row=causal_row)
        x_i = x_i + a
        cross_bias_row = (self.cross_bias.row(pos, l_src)
                          if self.cross_bias is not None else None)
        cross_mask_row = None
        if self.aligned:
            e_q = pos // self.num_channels_decoder
            cross_mask_row = torch.where(
                torch.arange(l_src, device=dev) == e_q, 0.0, NEG_INF)
        c = self.cross_attn.step(self.ln2(x_i), mem_k, mem_v,
                                 bias_row=cross_bias_row,
                                 mask_row=cross_mask_row)
        x_i = x_i + c
        x_i = x_i + self.mlp(self.ln3(x_i))
        return x_i, k_self, v_self


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive [L, L] mask allowing j <= i."""
    i = torch.arange(length, device=device)
    return torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)


def anti_causal_mask(length: int, device=None) -> torch.Tensor:
    """Transpose of the causal mask: position i sees j >= i."""
    i = torch.arange(length, device=device)
    return torch.where(i[:, None] <= i[None, :], 0.0, NEG_INF)


def identity_mask(length: int, device=None) -> torch.Tensor:
    i = torch.arange(length, device=device)
    return torch.where(i[:, None] == i[None, :], 0.0, NEG_INF)
