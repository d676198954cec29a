"""Autoregressive relative-attention priors over VQ codemaps.

Port of ``interactive_spectrogram_inpainting_tpu/models/prior/transformer.py``:

- ``SelfAttentiveVQTransformer`` (top prior): an anti-causal encoder reads
  the masked codemap (with an inpainting mask token appended to the
  source vocabulary), a causal decoder regenerates it;
- ``UpsamplingVQTransformer`` (bottom prior): decoder over the zigzag
  patch-aligned flattening of the bottom codemap, conditioned on the top
  codemap, optionally with aligned cross attention;
- learned 2-D positional embeddings, class conditioning in the start
  symbol or at every position, learned start symbols, and ``time_indexes``
  positional re-indexing for sounds longer than the training duration.

``TransformerConfig`` reads and writes the same JSON keys as the JAX
package's config, so one parameters file serves both packages.

Training: ``encode_source`` and ``forward`` take ``deterministic=False``
and a ``torch.Generator`` for dropout (a CPU generator draws one seed per
layer without waiting for the device); ``fused_attention`` routes every
batched attention through the training kernels of
``ops/train_attention.py``, and ``remat`` recomputes each encoder and
decoder layer in the backward pass (``torch.utils.checkpoint``; the layer's
dropout seed is drawn outside it, so the recomputation draws the same
masks).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (DecoderLayer, EncoderLayer, anti_causal_mask,
                        causal_mask, identity_mask, layer_norm)
from .codemaps import CodemapsHelper, SimpleCodemapsHelper, ZigZagCodemapsHelper


@dataclasses.dataclass
class TransformerConfig:
    """Constructor kwargs, JSON-compatible with the JAX package's config
    (unknown keys are ignored by ``from_json``)."""

    shape: Tuple[int, int] = (64, 8)  # (frequencies, duration)
    n_class: int = 512
    d_model: int = 512
    embeddings_dim: int = 32
    positional_embeddings_dim: int = 16
    dropout: float = 0.1
    conditional_model: bool = True
    self_conditional_model: bool = False
    condition_shape: Optional[Tuple[int, int]] = None
    use_relative_transformer: bool = True
    predict_frequencies_first: bool = True
    predict_low_frequencies_first: bool = True
    class_conditioning_num_classes_per_modality: Optional[
        Mapping[str, int]] = None
    class_conditioning_embedding_dim_per_modality: Optional[
        Mapping[str, int]] = None
    class_conditioning_prepend_to_dummy_input: bool = False
    positional_class_conditioning: bool = False
    use_aligned_decoder: bool = False
    conditional_model_num_encoder_layers: int = 6
    conditional_model_num_decoder_layers: int = 8
    conditional_model_nhead: int = 8
    unconditional_model_num_encoder_layers: int = 6
    unconditional_model_nhead: int = 8
    use_identity_memory_mask: bool = False
    d_ff: int = 2048
    # training-only switches: per-layer recomputation in the backward pass
    # and the training-attention kernels (inference loaders turn both off)
    remat: bool = False
    fused_attention: bool = False

    def __post_init__(self):
        self.shape = tuple(self.shape)
        if self.self_conditional_model:
            self.condition_shape = self.shape
        if self.condition_shape is not None:
            self.condition_shape = tuple(self.condition_shape)
        if self.conditional_model and self.condition_shape is None:
            raise ValueError("conditional model requires condition_shape")
        if not self.conditional_model:
            raise NotImplementedError(
                "only the conditional/self-conditional paths are exercised "
                "by the reference pipeline")
        self.positional_embeddings_dim = 2 * (
            self.positional_embeddings_dim // 2)
        dims = self.class_conditioning_embedding_dim_per_modality
        class_total = sum(dims.values()) if dims else 0
        if self.embeddings_effective_dim <= 0:
            raise ValueError(
                f"d_model={self.d_model} leaves no room for token "
                f"embeddings after positional_embeddings_dim="
                f"{self.positional_embeddings_dim}")
        if class_total > self.start_symbol_dim:
            raise ValueError(
                f"total class-conditioning embedding dim {class_total} "
                f"exceeds the start-symbol dim {self.start_symbol_dim}")

    # -- derived geometry ---------------------------------------------------
    @property
    def use_inpainting_mask_on_source(self) -> bool:
        return self.self_conditional_model

    @property
    def n_class_source(self) -> int:
        return self.n_class + (1 if self.use_inpainting_mask_on_source else 0)

    @property
    def n_class_target(self) -> int:
        return self.n_class

    @property
    def mask_token_index(self) -> int:
        return self.n_class

    @property
    def source_frequencies(self) -> int:
        return self.condition_shape[0]

    @property
    def source_duration(self) -> int:
        return self.condition_shape[1]

    @property
    def target_frequencies(self) -> int:
        return self.shape[0]

    @property
    def target_duration(self) -> int:
        return self.shape[1]

    @property
    def source_sequence_length(self) -> int:
        return self.source_frequencies * self.source_duration

    @property
    def target_sequence_length(self) -> int:
        return self.target_frequencies * self.target_duration

    @property
    def patch_frequencies(self) -> int:
        return self.target_frequencies // self.source_frequencies

    @property
    def patch_duration(self) -> int:
        return self.target_duration // self.source_duration

    @property
    def target_num_channels(self) -> int:
        """Tokens per source patch = target start-symbol length."""
        return self.patch_frequencies * self.patch_duration

    @property
    def target_num_events(self) -> int:
        return self.target_sequence_length // self.target_num_channels

    @property
    def class_conditioning_total_dim(self) -> int:
        dims = self.class_conditioning_embedding_dim_per_modality
        return sum(dims.values()) if dims else 0

    @property
    def embeddings_effective_dim(self) -> int:
        dim = self.d_model - self.positional_embeddings_dim
        if self.positional_class_conditioning:
            dim -= self.class_conditioning_total_dim
        return dim

    @property
    def start_symbol_dim(self) -> int:
        dim = self.d_model
        if self.positional_class_conditioning:
            dim -= self.class_conditioning_total_dim
        return dim

    def source_codemaps_helper(self) -> CodemapsHelper:
        return SimpleCodemapsHelper(self.source_frequencies,
                                    self.source_duration)

    def target_codemaps_helper(self) -> CodemapsHelper:
        if self.self_conditional_model:
            return SimpleCodemapsHelper(self.target_frequencies,
                                        self.target_duration)
        return ZigZagCodemapsHelper(
            self.target_frequencies, self.target_duration,
            self.patch_frequencies, self.patch_duration)

    def to_json(self) -> str:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        return json.dumps(d, indent=4)

    @classmethod
    def from_json(cls, blob: Union[str, Mapping[str, Any]]
                  ) -> "TransformerConfig":
        d = dict(json.loads(blob) if isinstance(blob, str) else blob)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class VQNSynthTransformer(nn.Module):
    """Seq2seq prior. ``forward(target_seq, source_seq, memory=None)`` ->
    (logits [B, L_tgt, n_class], memory); ``encode_source``;
    ``prefix_kv``; ``init_decode_caches`` / ``decode_step``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        d = cfg.d_model
        self.source_embed = nn.Embedding(cfg.n_class_source,
                                         cfg.embeddings_dim)
        self.source_embeddings_linear = nn.Linear(
            cfg.embeddings_dim, cfg.embeddings_effective_dim)
        self.target_embed = nn.Embedding(cfg.n_class_target,
                                         cfg.embeddings_dim)
        self.target_embeddings_linear = nn.Linear(
            cfg.embeddings_dim, cfg.embeddings_effective_dim)
        self.project_logits = nn.Linear(d, cfg.n_class_target)

        p_half = cfg.positional_embeddings_dim // 2
        self.source_pos_frequency = nn.Parameter(
            torch.randn(cfg.source_frequencies, p_half))
        self.target_pos_frequency = nn.Parameter(
            torch.randn(cfg.target_frequencies, p_half))
        self.target_pos_patch = nn.Parameter(
            torch.randn(cfg.patch_frequencies, cfg.patch_duration, p_half))
        self.source_start_symbol = nn.Parameter(
            torch.randn(1, cfg.start_symbol_dim))
        self.target_start_symbol = nn.Parameter(
            torch.randn(cfg.target_num_channels, cfg.start_symbol_dim))

        modalities = cfg.class_conditioning_num_classes_per_modality or {}
        dims = cfg.class_conditioning_embedding_dim_per_modality or {}
        self.class_embeds = nn.ModuleDict({
            name: nn.Embedding(num, dims[name])
            for name, num in modalities.items()})

        src_events_ws = cfg.source_sequence_length + 1
        tgt_events_ws = cfg.target_num_events + 1
        self.encoder_layers = nn.ModuleList([
            EncoderLayer(d, cfg.conditional_model_nhead, cfg.d_ff,
                         num_channels=1, num_events=src_events_ws,
                         dropout=cfg.dropout,
                         fused_attention=cfg.fused_attention)
            for _ in range(cfg.conditional_model_num_encoder_layers)])
        self.encoder_norm = layer_norm(d)
        cross_bias_type = ("no_bias" if cfg.use_identity_memory_mask
                           else "relative_attention_target_source")
        self.decoder_layers = nn.ModuleList([
            DecoderLayer(d, cfg.conditional_model_nhead, cfg.d_ff,
                         num_channels_encoder=1,
                         num_events_encoder=src_events_ws,
                         num_channels_decoder=cfg.target_num_channels,
                         num_events_decoder=tgt_events_ws,
                         cross_bias_type=cross_bias_type,
                         aligned=cfg.use_aligned_decoder,
                         dropout=cfg.dropout,
                         fused_attention=cfg.fused_attention)
            for _ in range(cfg.conditional_model_num_decoder_layers)])
        self.decoder_norm = layer_norm(d)

    @property
    def device(self) -> torch.device:
        return self.project_logits.weight.device

    # -- embedding / sequence preparation -----------------------------------
    def _class_block(self, class_conditioning: Mapping[str, torch.Tensor],
                     batch: int) -> Optional[torch.Tensor]:
        """[B, total_dim] concatenated modality embeddings (config order)."""
        cfg = self.config
        if len(self.class_embeds) == 0:
            return None
        parts = []
        for name in cfg.class_conditioning_num_classes_per_modality:
            if name in class_conditioning:
                labels = torch.as_tensor(class_conditioning[name],
                                         device=self.device).reshape(batch)
                parts.append(self.class_embeds[name](labels))
            else:
                dim = cfg.class_conditioning_embedding_dim_per_modality[name]
                parts.append(torch.zeros(
                    batch, dim, device=self.device,
                    dtype=self.project_logits.weight.dtype))
        return torch.cat(parts, dim=-1)

    def _positional_sequence(self, kind: str,
                             time_indexes: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """[L, P] positional features in the kind's scan order."""
        cfg = self.config
        if kind == "source":
            freq = self.source_pos_frequency  # [F_s, P/2]
            rep = freq[:, None, :].expand(-1, cfg.source_duration, -1)
            grid = torch.cat([rep, rep], dim=-1)  # [F_s, T_s, P]
            helper = cfg.source_codemaps_helper()
        else:
            freq = self.target_pos_frequency  # [F_t, P/2]
            patch = self.target_pos_patch.repeat(
                cfg.source_frequencies, cfg.source_duration, 1)
            grid = torch.cat([
                freq[:, None, :].expand(-1, cfg.target_duration, -1),
                patch], dim=-1)
            helper = cfg.target_codemaps_helper()
        if time_indexes is not None:
            index = torch.as_tensor(time_indexes, device=grid.device)
            grid = grid.index_select(1, index.long())
        return helper.to_sequence(grid[None])[0]  # [L, P]

    def _start_block(self, kind: str,
                     class_conditioning: Mapping[str, torch.Tensor],
                     batch: int) -> torch.Tensor:
        """[B, n_start, d_model] start symbol with class conditioning."""
        cfg = self.config
        start = (self.source_start_symbol if kind == "source"
                 else self.target_start_symbol)
        start = start[None].expand((batch,) + tuple(start.shape))
        block = self._class_block(class_conditioning, batch)
        if block is None:
            if cfg.positional_class_conditioning:
                raise ValueError("positional class conditioning requires "
                                 "configured modalities")
            return start
        block_rep = block[:, None, :].expand(-1, start.shape[1], -1)
        if cfg.positional_class_conditioning:
            return torch.cat([start, block_rep], dim=-1)
        # prepend-to-dummy-input: overwrite the leading dims
        return torch.cat([block_rep, start[..., block.shape[-1]:]], dim=-1)

    def _embed_tokens(self, tokens: torch.Tensor, kind: str) -> torch.Tensor:
        if kind == "source":
            return self.source_embeddings_linear(self.source_embed(tokens))
        return self.target_embeddings_linear(self.target_embed(tokens))

    def prepare_sequence(self, tokens: torch.Tensor, kind: str,
                         class_conditioning: Mapping[str, torch.Tensor] = {},
                         mask: Optional[torch.Tensor] = None,
                         time_indexes: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """[B, L] flattened token sequence -> [B, n_start + L, d_model].

        ``mask`` (source only): boolean [B, L], True = replace with the
        inpainting mask token before embedding."""
        cfg = self.config
        batch = tokens.shape[0]
        tokens = tokens.long()
        if mask is not None and kind == "source" \
                and cfg.use_inpainting_mask_on_source:
            tokens = torch.where(mask, cfg.mask_token_index, tokens)
        emb = self._embed_tokens(tokens, kind)  # [B, L, eff]
        pos = self._positional_sequence(kind, time_indexes)  # [L, P]
        pos = pos[None].expand((batch,) + tuple(pos.shape))
        seq = torch.cat([emb, pos], dim=-1)
        if cfg.positional_class_conditioning:
            block = self._class_block(class_conditioning, batch)
            block_rep = block[:, None, :].expand(-1, seq.shape[1], -1)
            seq = torch.cat([seq, block_rep], dim=-1)
        start = self._start_block(kind, class_conditioning, batch)
        return torch.cat([start, seq], dim=1)

    def to_sequences(self, input: torch.Tensor,
                     condition: Optional[torch.Tensor] = None,
                     class_conditioning: Mapping[str, torch.Tensor] = {},
                     mask: Optional[torch.Tensor] = None,
                     time_indexes_source: Optional[torch.Tensor] = None,
                     time_indexes_target: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Codemaps -> embedded (source_sequence, target_sequence)."""
        cfg = self.config
        src_helper = cfg.source_codemaps_helper()
        tgt_helper = cfg.target_codemaps_helper()
        mask_seq = (src_helper.to_sequence(mask)
                    if mask is not None else None)
        source_sequence = self.prepare_sequence(
            src_helper.to_sequence(condition), "source",
            class_conditioning=class_conditioning, mask=mask_seq,
            time_indexes=time_indexes_source)
        target_sequence = self.prepare_sequence(
            tgt_helper.to_sequence(input), "target",
            class_conditioning=class_conditioning,
            time_indexes=time_indexes_target)
        return source_sequence, target_sequence

    # -- full forward -------------------------------------------------------
    def _dropout_seeds(self, n: int, deterministic: bool,
                       generator: Optional[torch.Generator]) -> List:
        """One dropout seed per layer (``None``: no dropout)."""
        if deterministic or self.config.dropout == 0.0:
            return [None] * n
        if generator is None:
            raise ValueError("a training forward with dropout needs a "
                             "torch.Generator")
        draws = torch.randint(0, 2 ** 62, (n,), generator=generator,
                              device=generator.device)
        return [int(x) for x in draws.tolist()]

    def _run_layer(self, layer: nn.Module, seed: Optional[int], *args):
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(lambda *a: layer(*a, dropout_seed=seed), *args,
                              use_reentrant=False, preserve_rng_state=False)
        return layer(*args, dropout_seed=seed)

    def encode_source(self, source_sequence: torch.Tensor,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        cfg = self.config
        mask = (anti_causal_mask(source_sequence.shape[1],
                                 source_sequence.device)
                if cfg.self_conditional_model else None)
        seeds = self._dropout_seeds(len(self.encoder_layers), deterministic,
                                    generator)
        h = source_sequence
        for layer, seed in zip(self.encoder_layers, seeds):
            h = self._run_layer(layer, seed, h, mask)
        return self.encoder_norm(h)

    def forward(self, input: torch.Tensor, condition: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embedded sequences -> (logits [B, L_tgt, n_class_target], memory).
        ``deterministic=False`` applies dropout, drawn from ``generator``."""
        cfg = self.config
        if memory is None:
            memory = self.encode_source(condition, deterministic, generator)
        tgt_mask = causal_mask(input.shape[1], input.device)
        memory_mask = (identity_mask(memory.shape[1], input.device)
                       if cfg.use_identity_memory_mask else None)
        seeds = self._dropout_seeds(len(self.decoder_layers), deterministic,
                                    generator)
        h = input
        for layer, seed in zip(self.decoder_layers, seeds):
            h = self._run_layer(layer, seed, h, memory, tgt_mask, memory_mask)
        h = self.decoder_norm(h)
        # keep the start symbol's last position (it predicts token 0) and
        # drop the last position
        c = cfg.target_num_channels
        h = h[:, c - 1: c - 1 + cfg.target_sequence_length]
        return self.project_logits(h), memory

    def prefix_kv(self, target_prefix: torch.Tensor, memory: torch.Tensor
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer self-attention K/V [B, P, H, Dh] for a KNOWN embedded
        with-start prefix [B, P, d], from one parallel forward."""
        cfg = self.config
        dev = target_prefix.device
        tgt_mask = causal_mask(target_prefix.shape[1], dev)
        memory_mask = (identity_mask(memory.shape[1], dev)[
            : target_prefix.shape[1]]
            if cfg.use_identity_memory_mask else None)
        h = target_prefix
        kvs = []
        for layer in self.decoder_layers:
            kvs.append(layer.project_self_kv(h))
            h = layer(h, memory, tgt_mask, memory_mask)
        return kvs

    # -- KV-cached decode path ----------------------------------------------
    def init_decode_caches(self, memory: torch.Tensor, batch: int,
                           pad_multiple: int = 1) -> Dict[str, List]:
        """Per-layer memory K/V plus zeroed self caches [B, L, H, Dh]
        (dtype follows ``memory``). ``pad_multiple`` rounds the cache length
        up (the flash decode attention reads 128-row chunks)."""
        cfg = self.config
        l_tgt = cfg.target_sequence_length + cfg.target_num_channels
        l_tgt = ((l_tgt + pad_multiple - 1) // pad_multiple) * pad_multiple
        n_heads = cfg.conditional_model_nhead
        head_dim = cfg.d_model // n_heads
        mem_kv = [layer.init_memory_kv(memory)
                  for layer in self.decoder_layers]
        shape = (batch, l_tgt, n_heads, head_dim)
        self_kv = [(torch.zeros(shape, dtype=memory.dtype,
                                device=memory.device),
                    torch.zeros(shape, dtype=memory.dtype,
                                device=memory.device))
                   for _ in self.decoder_layers]
        return {"mem": mem_kv, "self": self_kv}

    def decode_step(self, x_p: torch.Tensor, pos: int,
                    caches: Dict[str, List], use_flash: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, List]]:
        """Input embedding at with-start position ``pos`` -> (logits for the
        token predicted at this position, caches updated in place)."""
        h = x_p
        for layer, (k_s, v_s), (m_k, m_v) in zip(
                self.decoder_layers, caches["self"], caches["mem"]):
            h, _, _ = layer.step(h, pos, k_s, v_s, m_k, m_v,
                                 use_flash=use_flash)
        h = self.decoder_norm(h)
        return self.project_logits(h), caches

    def target_input_embedding(self, token: torch.Tensor, pos: int,
                               pos_features: torch.Tensor,
                               start_block: torch.Tensor,
                               class_block: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """Input embedding at with-start position ``pos``: a start-symbol
        row for pos < C, else the embedding of ``token`` (= target token
        ``pos - C``) plus positional features."""
        cfg = self.config
        c = cfg.target_num_channels
        if pos < c:
            return start_block[:, pos]
        emb = self._embed_tokens(token.long(), "target")  # [B, eff]
        feat = pos_features[min(pos - c, cfg.target_sequence_length - 1)]
        x_tok = torch.cat([emb, feat[None].expand(emb.shape[0], -1)],
                          dim=-1)
        if cfg.positional_class_conditioning:
            x_tok = torch.cat([x_tok, class_block], dim=-1)
        return x_tok


def SelfAttentiveVQTransformer(config: TransformerConfig
                               ) -> VQNSynthTransformer:
    """Top prior factory: self-conditional, inpainting mask on source."""
    config = dataclasses.replace(
        config, conditional_model=True, self_conditional_model=True,
        condition_shape=config.shape)
    return VQNSynthTransformer(config)


def UpsamplingVQTransformer(config: TransformerConfig
                            ) -> VQNSynthTransformer:
    """Bottom prior factory: conditioned on top, zigzag target flattening."""
    if config.self_conditional_model:
        raise ValueError("bottom prior is not self-conditional")
    return VQNSynthTransformer(config)
