"""Two-level hierarchical VQ-VAE-2 (top/bottom codemaps).

Port of ``interactive_spectrogram_inpainting_tpu/models/vqvae/vqvae.py``.
Encode: ``enc_b -> enc_t -> 1x1 -> quantize_t -> dec_t -> concat(enc_b) ->
1x1 -> quantize_b``. Decode: the top quantized map is upsampled to the
bottom resolution, concatenated with the bottom quantized map and decoded to
a ``[B, C, F, T]`` spectrogram, then post-processed (denormalized,
optionally phase-masked). ``use_resnet`` swaps the encoders and decoders
for those of ``resnet.py``. All tensors are channel-first. ``VQVAEConfig``
reads and writes the JAX package's JSON keys; saving and loading the
two-file checkpoints is in ``utils/checkpoint_io.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ...signal.normalizer import DataNormalizer
from ...signal.spectrogram import make_masked_phase_transform
from .bottleneck import QuantizedBottleneck, UnquantizedBottleneck
from .encoder_decoder import Decoder, Encoder, UpsampleStack
from .resnet import get_xresnet_unet


def _log2_int(x: int) -> int:
    n = int(x)
    if n <= 0 or n & (n - 1):
        raise ValueError(f"resolution factor {x} must be a power of two")
    return n.bit_length() - 1


@dataclasses.dataclass
class VQVAEConfig:
    """Constructor kwargs, JSON-compatible with the JAX package's config."""

    in_channel: int = 2
    num_hidden_channels: int = 128
    n_res_block: int = 2
    num_residual_channels: int = 32
    embed_dim: int = 64
    num_embeddings: Union[int, List[int]] = 512
    decay: float = 0.99
    groups: int = 1
    use_local_kernels: bool = False
    output_spectrogram_min_magnitude: Optional[float] = None
    resolution_factors: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"bottom": 4, "top": 2})
    embeddings_initial_variance: float = 1.0
    normalizer_statistics: Optional[Mapping[str, float]] = None
    corruption_weights: Mapping[str, Optional[List[float]]] = (
        dataclasses.field(default_factory=lambda: {"top": None,
                                                   "bottom": None}))
    adapt_quantized_durations: bool = True
    disable_quantization: bool = False
    restarts_usage_threshold: float = 1.0
    use_resnet: bool = False
    resnet_layers_per_downsampling_block: int = 4
    resnet_expansion: int = 1
    use_pallas_lookup: bool = False

    @property
    def n_embed_t(self) -> int:
        n = self.num_embeddings
        return int(n if isinstance(n, int) else n[0])

    @property
    def n_embed_b(self) -> int:
        n = self.num_embeddings
        return int(n if isinstance(n, int) else n[1])

    @property
    def total_resolution_factor(self) -> int:
        return (int(self.resolution_factors["bottom"])
                * int(self.resolution_factors["top"]))

    def codemap_shapes(self, spec_shape: Tuple[int, int]
                       ) -> Dict[str, Tuple[int, int]]:
        """(F, T) spectrogram -> {'top': (f, t), 'bottom': (f, t)}."""
        f, t = spec_shape
        rb = int(self.resolution_factors["bottom"])
        rt = int(self.resolution_factors["top"])
        return {"bottom": (f // rb, t // rb),
                "top": (f // (rb * rt), t // (rb * rt))}

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4)

    @classmethod
    def from_json(cls, blob: Union[str, Mapping[str, Any]]) -> "VQVAEConfig":
        d = dict(json.loads(blob) if isinstance(blob, str) else blob)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class VQVAE(nn.Module):
    """``forward`` is the training path; ``encode``, ``encode_codes_only``,
    ``decode`` and ``decode_code`` are the serving and extraction paths."""

    def __init__(self, config: VQVAEConfig):
        super().__init__()
        cfg = self.config = config
        bottleneck_cls = (UnquantizedBottleneck if cfg.disable_quantization
                          else QuantizedBottleneck)
        bottleneck_kwargs = dict(
            dim=cfg.embed_dim, decay=cfg.decay,
            embeddings_initial_variance=cfg.embeddings_initial_variance,
            restart_threshold=cfg.restarts_usage_threshold,
            use_pallas_lookup=cfg.use_pallas_lookup)
        corruption = dict(cfg.corruption_weights or {})
        stack_kwargs = dict(
            channel=cfg.num_hidden_channels, n_res_block=cfg.n_res_block,
            res_channel=cfg.num_residual_channels, groups=cfg.groups,
            use_local_kernels=cfg.use_local_kernels)
        factor_b = int(cfg.resolution_factors["bottom"])
        factor_t = int(cfg.resolution_factors["top"])

        if cfg.use_resnet:
            encoders, decoders = get_xresnet_unet(
                cfg.in_channel, cfg.resolution_factors,
                cfg.num_hidden_channels, cfg.embed_dim,
                cfg.resnet_layers_per_downsampling_block,
                cfg.resnet_expansion)
            self.enc_b, self.enc_t = encoders["bottom"], encoders["top"]
        else:
            self.enc_b = Encoder(in_channel=cfg.in_channel,
                                 resolution_factor=factor_b, **stack_kwargs)
            self.enc_t = Encoder(in_channel=cfg.num_hidden_channels,
                                 resolution_factor=factor_t, **stack_kwargs)
        self.quantize_conv_t = nn.Conv2d(cfg.num_hidden_channels,
                                         cfg.embed_dim, 1)
        self.quantize_t = bottleneck_cls(
            n_embed=cfg.n_embed_t,
            corruption_weights=corruption.get("top"), **bottleneck_kwargs)
        self.dec_t = (decoders["top"] if cfg.use_resnet else Decoder(
            in_channel=cfg.embed_dim, out_channel=cfg.embed_dim,
            resolution_factor=factor_t, **stack_kwargs))
        self.quantize_conv_b = nn.Conv2d(
            cfg.embed_dim + cfg.num_hidden_channels, cfg.embed_dim, 1)
        self.quantize_b = bottleneck_cls(
            n_embed=cfg.n_embed_b,
            corruption_weights=corruption.get("bottom"), **bottleneck_kwargs)
        self.upsample_top_to_bottom = UpsampleStack(
            cfg.embed_dim, _log2_int(factor_t),
            use_local_kernels=cfg.use_local_kernels)
        self.dec = (decoders["bottom"] if cfg.use_resnet else Decoder(
            in_channel=2 * cfg.embed_dim, out_channel=cfg.in_channel,
            resolution_factor=factor_b, **stack_kwargs))
        self.normalizer = (DataNormalizer(cfg.normalizer_statistics)
                           if cfg.normalizer_statistics else None)
        self.output_transform = (
            make_masked_phase_transform(cfg.output_spectrogram_min_magnitude)
            if cfg.output_spectrogram_min_magnitude is not None else None)

    def forward(self, input: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                per_sample: bool = False):
        """[B, C, F, T] -> (dec, diff, perplexity_t, perplexity_b, id_t,
        id_b). ``per_sample``: ``diff`` and the perplexities of each row
        alone, ``[B]`` (what a forward of each row by itself gives; the
        trainer's exact-count evaluation)."""
        (quant_t, quant_b, diff, id_t, id_b,
         perplexity_t, perplexity_b) = self.encode(input, train=train,
                                                   generator=generator,
                                                   per_sample=per_sample)
        dec = self.decode(quant_t, quant_b)
        return dec, diff, perplexity_t, perplexity_b, id_t, id_b

    def encode(self, input: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None,
               per_sample: bool = False):
        """[B, C, F, T] -> (quant_t, quant_b, diff, id_t, id_b, perp_t,
        perp_b); quantized maps [B, D, f, t]. ``generator`` feeds the
        bottlenecks' training-time draws (corruption, restarts)."""
        if self.normalizer is not None:
            input = self.normalizer.normalize(input)
        enc_b = self.enc_b(input)
        enc_t = self.enc_t(enc_b)
        quant_t, diff_t, id_t, perplexity_t = self.quantize_t(
            self.quantize_conv_t(enc_t), train=train, generator=generator,
            per_sample=per_sample)
        dec_t = self.dec_t(quant_t)
        qb_in = self.quantize_conv_b(torch.cat([dec_t, enc_b], dim=1))
        quant_b, diff_b, id_b, perplexity_b = self.quantize_b(
            qb_in, train=train, generator=generator, per_sample=per_sample)
        return (quant_t, quant_b, diff_t + diff_b, id_t, id_b,
                perplexity_t, perplexity_b)

    def encode_codes_only(self, input: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, C, F, T] -> (id_t, id_b): the extraction hot path."""
        _, _, _, id_t, id_b, _, _ = self.encode(input, train=False)
        return id_t, id_b

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor
               ) -> torch.Tensor:
        """Channel-first quantized maps -> [B, C, F, T] spectrogram."""
        upsampled = self.upsample_top_to_bottom(quant_t)
        dec = self.dec(torch.cat([upsampled, quant_b], dim=1))
        return self.post_process(dec)

    def decode_code(self, code_t: torch.Tensor, code_b: torch.Tensor
                    ) -> torch.Tensor:
        """Integer codemaps [B, f, t] -> decoded spectrogram [B, C, F, T]."""
        quant_t = self.quantize_t.embed_code(code_t).permute(0, 3, 1, 2)
        quant_b = self.quantize_b.embed_code(code_b).permute(0, 3, 1, 2)
        return self.decode(quant_t, quant_b)

    def post_process(self, dec: torch.Tensor) -> torch.Tensor:
        if self.normalizer is not None:
            dec = self.normalizer.denormalize(dec)
        if self.output_transform is not None:
            dec = self.output_transform(dec)
        return dec
