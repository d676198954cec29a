"""Masked autoregressive codemap sampling (the inpainting engine).

Port of the fused B=1 path of
``interactive_spectrogram_inpainting_tpu/sampling/sample.py``: the encoder
memory is computed once per call, the known prefix of the inpaint primes
the KV cache in one parallel forward (``ops/prefix_prime_kernel.py``) and
the whole token loop then runs in one call (``ops/decode_scan_kernel.py``).
Unmasked (known) positions keep their tokens; only masked cells are
regenerated.

Sampling is temperature + Gumbel-argmax. The Gumbel noise is an input of
the scan, ``[steps - p0, n_class]`` float32: by default it is drawn on the
model's device from a ``torch.Generator``; a caller can pass it instead
(the tests feed the JAX package's noise and compare tokens one for one).

Not ported yet, and refused with ``NotImplementedError`` rather than
rerouted: the dense scan (``use_fused_step=False``), top-k/top-p
filtering, predictive sampling and batches other than 1.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.prior.transformer import VQNSynthTransformer
from ..ops.decode_scan_kernel import fused_decode_scan
from ..ops.decode_step_kernel import (
    _round_up, pack_decode_params, precompute_bias_rows,
    precompute_cross_bias_rows, precompute_mem_values,
    precompute_position_features)
from ..ops.prefix_prime_kernel import fused_prefix_prime
from ..utils.device import DeviceLike, resolve_device


def precompute_decode_state(model: VQNSynthTransformer,
                            compute_dtype: Optional[torch.dtype] = None
                            ) -> dict:
    """Model-constant decode tables: packed weights, and the relative-bias
    rows head-major (``bias_hm [n_layers, steps_pad, H, l_pad]``,
    ``cross_hm [n_layers, steps_pad, H, e_pad]`` or None) as both kernels
    read them. Build once per model (the bottom prior's bias table is about
    105 MB) and pass as ``decode_state=``."""
    cfg = model.config
    dtype = compute_dtype or torch.float32
    l_pad = _round_up(cfg.target_sequence_length + cfg.target_num_channels,
                      128)
    e_pad = _round_up(cfg.source_sequence_length + 1, 128)
    cross_rows = precompute_cross_bias_rows(model, e_pad)
    return {
        "params": pack_decode_params(model, dtype=dtype),
        "bias_hm": precompute_bias_rows(model, l_pad).transpose(
            2, 3).contiguous(),
        "cross_hm": (cross_rows.transpose(2, 3).contiguous()
                     if cross_rows is not None else None),
    }


def gumbel_noise(shape: Tuple[int, ...], device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1), float32, drawn on ``device``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def scan_range(model: VQNSynthTransformer, scan_from: Optional[int],
               scan_until: Optional[int]) -> Tuple[int, int]:
    """(p0, steps): the with-start positions the fused scan runs."""
    cfg = model.config
    c = cfg.target_num_channels
    steps = cfg.target_sequence_length + c - 1
    if scan_until is not None:
        steps = min(steps, scan_until + c - 1)
    p0 = c - 1 + scan_from if scan_from else 0
    return p0, steps


def _fused_scan_sample(model: VQNSynthTransformer, memory: torch.Tensor,
                       initial_tokens: torch.Tensor, mask_seq: torch.Tensor,
                       pos_features: torch.Tensor,
                       start_block: torch.Tensor, temperature: float,
                       compute_dtype: Optional[torch.dtype] = None,
                       scan_until: Optional[int] = None,
                       scan_from: Optional[int] = None,
                       decode_state: Optional[dict] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """B=1: prefix priming plus the whole-scan kernel. -> tokens [1, L]."""
    cfg = model.config
    c = cfg.target_num_channels
    n_class = cfg.n_class_target
    dev = memory.device
    if initial_tokens.shape[0] != 1:
        raise NotImplementedError(
            "the fused sampler is ported for batch 1 only")
    dtype = compute_dtype or torch.float32
    p0, steps = scan_range(model, scan_from, scan_until)
    if decode_state is None:
        decode_state = precompute_decode_state(model, compute_dtype=dtype)
    params = decode_state["params"]
    if params["wqkv"].dtype != dtype:
        raise ValueError("decode_state was built with a different "
                         "compute_dtype")
    bias_hm = decode_state["bias_hm"]
    cross_hm = decode_state["cross_hm"]
    posfull = precompute_position_features(model, start_block, pos_features,
                                           dtype=dtype)
    mem_k, mem_v = precompute_mem_values(model, memory.to(dtype))
    e_src_real = mem_v.shape[2]
    e_pad = _round_up(e_src_real, 128)
    mem_k = F.pad(mem_k[:, 0], (0, 0, 0, e_pad - e_src_real))
    mem_v = F.pad(mem_v[:, 0], (0, 0, 0, e_pad - e_src_real))

    tokens = initial_tokens[0].to(torch.int32).contiguous()
    kv = None
    if p0:
        l_pad = bias_hm.shape[3]
        kv = torch.zeros(cfg.conditional_model_num_decoder_layers, 2,
                         l_pad, cfg.d_model, dtype=dtype, device=dev)
        with_start = torch.cat([
            torch.full((c,), n_class, dtype=torch.long, device=dev),
            tokens.long()])
        x_prefix = (params["emb_padded"][with_start[:p0]].float()
                    + posfull[:p0].float()).to(dtype)
        fused_prefix_prime(params, bias_hm, x_prefix, (mem_k, mem_v), kv,
                           p0=p0, channels=c, cross_hm=cross_hm,
                           e_src_real=e_src_real)
    if gumbel is None:
        gumbel = gumbel_noise((max(steps - p0, 0), n_class), dev, generator)
    tokens, _ = fused_decode_scan(
        params, bias_hm, posfull, (mem_k, mem_v), kv, tokens,
        mask_seq.to(torch.bool).contiguous(),
        gumbel.to(device=dev, dtype=torch.float32).contiguous(),
        temperature, p0=p0, steps=steps, n_class=n_class, channels=c,
        cross_hm=cross_hm, e_src_real=e_src_real)
    return tokens.to(initial_tokens.dtype)[None]


def derive_scan_bounds(mask_seq, has_initial_code: bool
                       ) -> Tuple[Optional[int], Optional[int]]:
    """(scan_from, scan_until) from a concrete mask: [first masked, last
    masked + 1] in flattened target order; priming needs known tokens."""
    nz = np.nonzero(np.asarray(mask_seq))[0]
    scan_until = int(nz.max()) + 1 if len(nz) else 0
    scan_from = int(nz.min()) if len(nz) and has_initial_code else None
    return scan_from, scan_until


@torch.no_grad()
def sample_model(model: VQNSynthTransformer,
                 generator: Optional[torch.Generator], batch_size: int,
                 codemap_size: Optional[Tuple[int, int]] = None,
                 temperature: float = 1.0,
                 condition=None,
                 class_conditioning: Mapping = {},
                 initial_code=None,
                 mask=None,
                 time_indexes_source=None,
                 time_indexes_target=None,
                 top_k_sampling_k: int = 0,
                 top_p_sampling_p: float = 0.0,
                 use_predictive_sampling: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused_step: bool = True,
                 scan_from: Optional[int] = None,
                 scan_until: Optional[int] = None,
                 decode_state: Optional[dict] = None,
                 gumbel: Optional[torch.Tensor] = None,
                 bounds_from_mask: bool = True,
                 device: DeviceLike = None) -> torch.Tensor:
    """Generate/inpaint a codemap; returns [batch, F, T] int32.

    Mirrors the JAX package's ``sample_model`` with ``use_fused_step=True``
    (``generator`` takes the place of the JAX key):

    - ``condition``: top codemap for the bottom prior (ignored for the
      self-conditional top prior, whose condition is the codemap itself);
    - ``initial_code``: known cells; masked cells are regenerated,
      unmasked cells pass through untouched;
    - ``mask``: boolean [F, T] (or [B, F, T], row 0 is used) over the
      target codemap; None = regenerate everything;
    - ``scan_from`` / ``scan_until``: token-index bounds of the scan,
      derived from the mask when not given and ``bounds_from_mask`` (the
      server passes its bucketed bounds with ``bounds_from_mask=False``,
      as the JAX server's traced mask derives nothing);
    - ``gumbel``: optional noise [steps - p0, n_class] (see
      ``scan_range``) instead of drawing it from ``generator``;
    - ``device``: where the model lives (CUDA unless ``'cpu'``).
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, expected {dev}")
    if not use_fused_step:
        raise NotImplementedError("the dense scan sampler is not ported; "
                                  "use use_fused_step=True")
    if top_k_sampling_k or top_p_sampling_p:
        raise NotImplementedError("top-k/top-p sampling is not ported")
    if use_predictive_sampling:
        raise NotImplementedError("predictive sampling is not ported")
    if batch_size != 1:
        raise NotImplementedError("the fused sampler is ported for batch 1")
    cfg = model.config
    if cfg.positional_class_conditioning or not (
            cfg.use_aligned_decoder or not cfg.use_identity_memory_mask):
        raise NotImplementedError(
            "the fused sampler covers aligned or relative-bias cross "
            "attention without positional class conditioning")
    shape = tuple(codemap_size or cfg.shape)
    if shape != tuple(cfg.shape):
        raise ValueError(f"codemap_size {shape} != model shape {cfg.shape}")
    helper = cfg.target_codemaps_helper()
    src_helper = cfg.source_codemaps_helper()

    def tensor(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev).to(dtype)

    if initial_code is None:
        fill = cfg.mask_token_index if cfg.self_conditional_model else 0
        codemap = torch.full((batch_size,) + shape, fill, dtype=torch.int32,
                             device=dev)
    else:
        codemap = tensor(initial_code, torch.int32).expand(
            (batch_size,) + shape)

    cc = {}
    for k, v in class_conditioning.items():
        v = tensor(v, torch.long).reshape(-1)
        cc[k] = v[:1].expand(batch_size) if v.numel() == 1 else v

    if cfg.self_conditional_model:
        condition = codemap
    if condition is None:
        raise ValueError("conditional model requires a condition")
    condition = tensor(condition, torch.long)
    if condition.dim() == 2:
        condition = condition[None].expand((batch_size,) + condition.shape)

    length = cfg.target_sequence_length
    if mask is not None:
        mask_map = tensor(mask, torch.bool)
        if mask_map.dim() == 3:
            mask_map = mask_map[0]
        mask_seq = helper.to_sequence(mask_map[None])[0]  # [L]
        if scan_until is None and bounds_from_mask:
            derived_from, scan_until = derive_scan_bounds(
                mask_seq.cpu().numpy(), initial_code is not None)
            if scan_from is None:
                scan_from = derived_from
        if initial_code is None:
            scan_from = None  # nothing known to prime from
        source_mask = (mask_map[None].expand((batch_size,) + shape)
                       if cfg.use_inpainting_mask_on_source else None)
    else:
        mask_seq = torch.ones(length, dtype=torch.bool, device=dev)
        source_mask = (torch.full((batch_size,) + shape,
                                  initial_code is None, device=dev)
                       if cfg.use_inpainting_mask_on_source else None)

    ti_src = (None if time_indexes_source is None
              else tensor(time_indexes_source, torch.long))
    ti_tgt = (None if time_indexes_target is None
              else tensor(time_indexes_target, torch.long))
    src_mask_seq = (src_helper.to_sequence(source_mask)
                    if source_mask is not None else None)
    source_sequence = model.prepare_sequence(
        src_helper.to_sequence(condition), "source",
        class_conditioning=cc, mask=src_mask_seq, time_indexes=ti_src)
    memory = model.encode_source(source_sequence)
    initial_tokens = helper.to_sequence(codemap)  # [B, L]
    pos_features = model._positional_sequence("target", ti_tgt)
    start_block = model._start_block("target", cc, batch_size)
    tokens = _fused_scan_sample(
        model, memory, initial_tokens, mask_seq, pos_features, start_block,
        temperature, compute_dtype=compute_dtype, scan_until=scan_until,
        scan_from=scan_from, decode_state=decode_state, gumbel=gumbel,
        generator=generator)
    return helper.to_time_frequency_map(tokens)
