"""Masked autoregressive codemap sampling (the inpainting engine).

Port of ``interactive_spectrogram_inpainting_tpu/sampling/sample.py``. The
encoder memory is computed once per call; unmasked (known) positions keep
their tokens and only masked cells are regenerated. Three samplers:

- the fused path (``use_fused_step=True``): the known prefix of an inpaint
  primes the KV cache in one parallel forward
  (``ops/prefix_prime_kernel.py``), then the token loop runs in one call at
  batch 1 (``ops/decode_scan_kernel.py``), or as one kernel call per
  position for a batch (``ops/decode_step_batched.py`` above 4 sequences
  on aligned decoders, else ``ops/decode_step_kernel.py``);
- the dense KV-cached scan (``_scan_sample``) through the model's own
  ``decode_step``, with temperature and top-k / top-p filtering and,
  with ``use_flash=True``, ``ops/decode_attention.py`` for its self
  attention;
- Gumbel predictive sampling (``_predictive_sample``, arXiv:2002.09928):
  full forwards, skipped where the last forward's prediction still holds.

Sampling is Gumbel-argmax, and the noise is an input: by default it is
drawn on the model's device from a ``torch.Generator``; a caller can pass
it instead (the tests feed the JAX package's noise and compare tokens one
for one). Its shape is ``[steps - p0, n_class]`` for the fused batch-1 scan,
``[steps - p0, B, n_class]`` for the fused batch loop and the dense scan
(``jax.random.categorical(k, l)`` is ``argmax(l + gumbel(k, l.shape))``),
and ``[B, L, n_class]`` for predictive sampling.

``make_sharded_sampling_fn`` splits a batch over the data ranks of a mesh
(``parallel/mesh.py``): each rank samples its rows with its own noise, and
one all-gather at the end hands every rank the whole batch.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.prior.transformer import VQNSynthTransformer
from ..ops.decode_scan_kernel import fused_decode_scan, scan_refusal
from ..ops.decode_step_batched import fused_decode_step_batched
from ..ops.decode_step_kernel import (
    MAX_SMALL_BATCH, _round_up, fused_decode_step, pack_decode_params,
    precompute_bias_rows, precompute_cross_bias_rows, precompute_mem_values,
    precompute_position_features, step_refusal)
from ..ops.prefix_prime_kernel import fused_prefix_prime, prime_refusal
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import Mesh
from ..utils.device import DeviceLike, resolve_device

NEG_INF = -1e9


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 0.0) -> torch.Tensor:
    """Filter [..., V] logits: keep the ``top_k`` largest and / or the
    smallest set of largest logits whose probabilities sum past ``top_p``;
    the rest become ``NEG_INF``. Ties with a kept value are kept."""
    vocab = logits.shape[-1]
    if top_k > 0:
        k = min(top_k, vocab)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1),
                                 dim=-1)
        # shift right so the first token above the threshold is kept
        to_remove = cum_probs > top_p
        to_remove = torch.cat([torch.zeros_like(to_remove[..., :1]),
                               to_remove[..., :-1]], dim=-1)
        # per-row logit threshold: the smallest kept sorted logit
        kept_min = torch.where(to_remove, float("inf"), sorted_logits).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < kept_min, NEG_INF, logits)
    return logits


def precompute_decode_state(model: VQNSynthTransformer,
                            compute_dtype: Optional[torch.dtype] = None
                            ) -> dict:
    """Model-constant decode tables: packed weights, and the relative-bias
    rows head-major (``bias_hm [n_layers, steps_pad, H, l_pad]``,
    ``cross_hm [n_layers, steps_pad, H, e_pad]`` or None) as the kernels
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


def fused_unsupported(model: VQNSynthTransformer, top_k_sampling_k: int = 0,
                      top_p_sampling_p: float = 0.0) -> Optional[str]:
    """Why the fused sampler cannot serve this prior with these options
    (None when it can): it covers aligned or relative-bias cross attention,
    without filtering and without positional class conditioning."""
    cfg = model.config
    if not (cfg.use_aligned_decoder or not cfg.use_identity_memory_mask):
        return "the fused step covers aligned or relative-bias cross attention"
    if top_k_sampling_k != 0 or top_p_sampling_p != 0.0:
        return "the fused step does not support top-k/top-p filtering"
    if cfg.positional_class_conditioning:
        return ("the fused step does not support positional class "
                "conditioning")
    return None


def fused_refusal(model: VQNSynthTransformer,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> Optional[str]:
    """None when every kernel the fused sampler can launch for this prior
    takes its geometry on the card (the B = 1 scan and its prefix prime,
    the step kernels at B > 1), else the first refusal, naming the kernel
    and the shape. The kernels' own checks are the same predicates."""
    cfg = model.config
    d, nh, d_ff = cfg.d_model, cfg.conditional_model_nhead, cfg.d_ff
    l_pad = _round_up(cfg.target_sequence_length + cfg.target_num_channels,
                      128)
    e_pad = _round_up(cfg.source_sequence_length + 1, 128)
    return (scan_refusal(d, nh, d_ff) or prime_refusal(d, nh, d_ff)
            or step_refusal(d, nh, d_ff, compute_dtype or torch.float32,
                            l_pad, None if cfg.use_aligned_decoder
                            else e_pad))


def gumbel_noise(shape: Tuple[int, ...], device: torch.device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """-log(-log(U)), U uniform in [tiny, 1), float32, drawn on ``device``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def scan_range(model: VQNSynthTransformer, scan_from: Optional[int],
               scan_until: Optional[int]) -> Tuple[int, int]:
    """(p0, steps): the with-start positions a sampling scan runs."""
    cfg = model.config
    c = cfg.target_num_channels
    steps = cfg.target_sequence_length + c - 1
    if scan_until is not None:
        steps = min(steps, scan_until + c - 1)
    p0 = c - 1 + scan_from if scan_from else 0
    return p0, steps


def _cast_model(model: VQNSynthTransformer,
                dtype: Optional[torch.dtype]) -> VQNSynthTransformer:
    """The model with its floating-point parameters in ``dtype`` (a copy;
    the model itself when nothing changes)."""
    if dtype is None or all(p.dtype == dtype for p in model.parameters()):
        return model
    return copy.deepcopy(model).to(dtype)


def _noise(gumbel: Optional[torch.Tensor], shape: Tuple[int, ...],
           device: torch.device, generator: Optional[torch.Generator]
           ) -> torch.Tensor:
    """The caller's noise (checked) or noise drawn from ``generator``."""
    if gumbel is None:
        return gumbel_noise(shape, device, generator)
    if tuple(gumbel.shape) != tuple(shape):
        raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, "
                         f"expected {tuple(shape)}")
    return gumbel.to(device=device, dtype=torch.float32).contiguous()


def _scan_sample(model: VQNSynthTransformer, memory: torch.Tensor,
                 initial_tokens: torch.Tensor, mask_seq: torch.Tensor,
                 pos_features: torch.Tensor, start_block: torch.Tensor,
                 class_block: Optional[torch.Tensor], temperature: float,
                 top_k: int, top_p: float,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_flash: bool = False, scan_until: Optional[int] = None,
                 scan_from: Optional[int] = None,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """The dense KV-cached scan: tokens [B, L] -> sampled tokens [B, L].

    ``scan_from``: known-prefix length in token indices; the caches of
    positions [0, C - 1 + scan_from) are primed with one parallel
    ``prefix_kv`` forward and the loop starts at the first masked token.
    The loop is a Python ``for`` over positions; tokens, mask and noise stay
    on the device and nothing is read back per step."""
    cfg = model.config
    c = cfg.target_num_channels
    length = cfg.target_sequence_length
    batch = initial_tokens.shape[0]
    dev = memory.device
    p0, num_steps = scan_range(model, scan_from, scan_until)
    if compute_dtype is not None:
        model = _cast_model(model, compute_dtype)
        memory = memory.to(compute_dtype)
        pos_features = pos_features.to(compute_dtype)
        start_block = start_block.to(compute_dtype)
        if class_block is not None:
            class_block = class_block.to(compute_dtype)

    caches = model.init_decode_caches(
        memory, batch, pad_multiple=128 if use_flash else 1)
    tokens = initial_tokens.clone()
    if p0:
        x_prefix = torch.stack([
            model.target_input_embedding(
                tokens[:, min(max(p - c, 0), length - 1)], p, pos_features,
                start_block, class_block) for p in range(p0)], dim=1)
        if compute_dtype is not None:
            x_prefix = x_prefix.to(compute_dtype)
        for (k_s, v_s), (k_p, v_p) in zip(caches["self"],
                                          model.prefix_kv(x_prefix, memory)):
            k_s[:, :p0] = k_p.to(k_s.dtype)
            v_s[:, :p0] = v_p.to(v_s.dtype)
    gumbel = _noise(gumbel, (max(num_steps - p0, 0), batch,
                             cfg.n_class_target), dev, generator)
    mask_host = mask_seq.to(torch.bool).cpu().tolist()

    for p in range(p0, num_steps):
        token_in = tokens[:, min(max(p - c, 0), length - 1)]
        x_p = model.target_input_embedding(token_in, p, pos_features,
                                           start_block, class_block)
        if compute_dtype is not None:
            x_p = x_p.to(compute_dtype)
        logits_p, caches = model.decode_step(x_p, p, caches,
                                             use_flash=use_flash)
        i = p - (c - 1)  # token index predicted at this position
        if i < 0 or not mask_host[i]:
            continue  # the known token stays
        filtered = top_k_top_p_filtering(logits_p.float() / temperature,
                                         top_k=top_k, top_p=top_p)
        tokens[:, i] = torch.argmax(filtered + gumbel[p - p0], dim=-1).to(
            tokens.dtype)
    return tokens


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
    """The fused samplers: prefix priming, then the whole-scan kernel at
    batch 1 or one step kernel call per position for a batch.
    -> tokens [B, L]."""
    cfg = model.config
    c = cfg.target_num_channels
    n_class = cfg.n_class_target
    length = cfg.target_sequence_length
    batch = initial_tokens.shape[0]
    n_layers = cfg.conditional_model_num_decoder_layers
    dev = memory.device
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
    l_pad = bias_hm.shape[3]
    # posfull [B, steps_pad, d]: each batch row's own start rows (its class
    # labels), as the dense sampler embeds them
    posfull = precompute_position_features(model, start_block, pos_features,
                                           dtype=dtype)
    mem_k, mem_v = precompute_mem_values(model, memory.to(dtype))
    e_src_real = mem_v.shape[2]
    e_pad = _round_up(e_src_real, 128)
    mem_k = F.pad(mem_k, (0, 0, 0, e_pad - e_src_real))
    mem_v = F.pad(mem_v, (0, 0, 0, e_pad - e_src_real))
    # the batched step kernel above this batch size; aligned models only
    use_batched = (batch > MAX_SMALL_BATCH and cfg.use_aligned_decoder
                   and cross_hm is None)

    tokens32 = initial_tokens.to(torch.int32)
    kv = None
    if p0 or batch > 1:
        kv = torch.zeros(n_layers, 2, batch, l_pad, cfg.d_model, dtype=dtype,
                         device=dev)
    if p0:
        with_start = torch.cat([
            torch.full((batch, c), n_class, dtype=torch.long, device=dev),
            tokens32.long()], dim=1)
        x_prefix = (params["emb_padded"][with_start[:, :p0]].float()
                    + posfull[:, :p0].float()).to(dtype)
        if not use_batched:
            fused_prefix_prime(params, bias_hm, x_prefix, (mem_k, mem_v), kv,
                               p0=p0, channels=c, cross_hm=cross_hm,
                               e_src_real=e_src_real)
        else:
            # large batches prime through the model's own parallel forward,
            # as the JAX package does
            kvs = _cast_model(model, dtype).prefix_kv(x_prefix,
                                                      memory.to(dtype))
            for li, (k_p, v_p) in enumerate(kvs):
                kv[li, 0, :, :p0] = k_p.reshape(batch, p0, -1).to(dtype)
                kv[li, 1, :, :p0] = v_p.reshape(batch, p0, -1).to(dtype)

    if batch == 1:
        gumbel = _noise(gumbel, (max(steps - p0, 0), n_class), dev,
                        generator)
        tokens, _ = fused_decode_scan(
            params, bias_hm, posfull[0], (mem_k[:, 0], mem_v[:, 0]),
            None if kv is None else kv[:, :, 0], tokens32[0].contiguous(),
            mask_seq.to(torch.bool).contiguous(), gumbel, temperature,
            p0=p0, steps=steps, n_class=n_class, channels=c,
            cross_hm=cross_hm, e_src_real=e_src_real)
        return tokens.to(initial_tokens.dtype)[None]

    gumbel = _noise(gumbel, (max(steps - p0, 0), batch, n_class), dev,
                    generator)
    tokens_t = tokens32.t().contiguous()  # [L, B], position-major
    if use_batched:
        def step(token_in, cur, p, i, is_masked, noise):
            fused_decode_step_batched(
                params, bias_hm, posfull, mem_v, kv, token_in, cur, p, i,
                is_masked, noise, temperature, n_class=n_class, channels=c,
                out=cur)
    else:
        def step(token_in, cur, p, i, is_masked, noise):
            fused_decode_step(
                params, bias_hm, posfull, (mem_k, mem_v), kv, token_in, cur,
                p, i, is_masked, noise, temperature, n_class=n_class,
                channels=c, cross_hm=cross_hm, e_src_real=e_src_real,
                out=cur)
    step_loop(step, tokens_t, mask_seq.to(torch.bool).cpu().tolist(), gumbel,
              p0, steps, c, n_class)
    return tokens_t.t().to(initial_tokens.dtype)


def step_loop(step, tokens_t: torch.Tensor, mask_host, gumbel: torch.Tensor,
              p0: int, steps: int, channels: int, n_class: int) -> None:
    """The token loop of the batch samplers over positions [p0, steps):
    ``step(token_in, cur, p, i, is_masked, noise)`` runs one step kernel
    call and writes the new tokens into ``cur``.

    ``tokens_t`` [L, B] int32 is position-major, so the tokens of one
    position are a contiguous [B, 1] view which the kernel reads and
    writes in place; ``mask_host`` is the mask as a host list, known before
    the loop; ``gumbel`` [steps - p0, B, n_class]. Nothing is read back
    from the device inside the loop. A step kernel builds its per-generation
    plan at the first step and reuses it at the others
    (``ops/decode_step_kernel.py::step_plan``)."""
    length, batch = tokens_t.shape
    c = channels
    start_tokens = torch.full((batch, 1), n_class, dtype=torch.int32,
                              device=tokens_t.device)
    for p in range(p0, steps):
        i = p - (c - 1)
        i_clipped = min(max(i, 0), length - 1)
        token_in = start_tokens if p < c else tokens_t[p - c][:, None]
        step(token_in, tokens_t[i_clipped][:, None], p, i,
             mask_host[i_clipped], gumbel[p - p0])


def _predictive_sample(model: VQNSynthTransformer, memory: torch.Tensor,
                       source_sequence: torch.Tensor,
                       initial_tokens: torch.Tensor, mask_seq: torch.Tensor,
                       class_conditioning: Mapping[str, torch.Tensor],
                       time_indexes_target, temperature: float, top_k: int,
                       top_p: float,
                       compute_dtype: Optional[torch.dtype] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, int]:
    """Gumbel predictive sampling: full forwards, but a step whose
    prediction already matched is skipped. Returns (tokens, num_forwards).

    Whether a position can reuse the last forward depends on the tokens
    sampled so far, so the loop reads that one decision back per position:
    the read-back is the algorithm's own data dependence."""
    cfg = model.config
    length = cfg.target_sequence_length
    helper = cfg.target_codemaps_helper()
    dev = memory.device
    if compute_dtype is not None:
        model = _cast_model(model, compute_dtype)
        memory = memory.to(compute_dtype)
        source_sequence = source_sequence.to(compute_dtype)
    gumbel = _noise(gumbel, tuple(initial_tokens.shape)
                    + (cfg.n_class_target,), dev, generator)
    mask_seq = mask_seq.to(torch.bool)
    mask_host = mask_seq.cpu().tolist()
    positions = torch.arange(length, device=dev)

    def forward_tokens(tokens):
        # a codemap sampled from scratch still holds the mask token
        # (``n_class``, outside the target embedding) at the cells not
        # sampled yet: give the target side token 0 there. Position i's
        # logits see only the tokens before i, so no sample depends on it
        # (the JAX package embeds NaN there and forces token 0 at i = 0).
        tokens = torch.where(tokens == cfg.mask_token_index, 0, tokens)
        codemap = helper.to_time_frequency_map(tokens)
        tgt_seq = model.prepare_sequence(
            helper.to_sequence(codemap), "target",
            class_conditioning=class_conditioning,
            time_indexes=time_indexes_target)
        logits, _ = model(tgt_seq, source_sequence, memory=memory)
        return logits

    tokens = initial_tokens.clone()
    prev_input = last_sample = initial_tokens
    chain_ok = has_sample = False
    num_forwards = 0
    for i in range(length):
        if not mask_host[i]:
            continue
        # a step can reuse the last forward iff every masked step since it
        # (chain_ok), this one included, sampled the value the forward saw
        # in its input
        can_skip = has_sample and chain_ok and bool(
            (last_sample[:, i] == prev_input[:, i]).all())
        if can_skip:
            continue
        logits = forward_tokens(tokens).float() / temperature
        logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p)
        log_probs = torch.log_softmax(logits, dim=-1)
        sample_all = torch.argmax(log_probs + gumbel, dim=-1).to(
            tokens.dtype)
        chain_ok = bool((sample_all[:, i] == tokens[:, i]).all())
        # overwrite masked positions >= i (causal and inpainting mask)
        write = (positions >= i) & mask_seq
        prev_input = tokens
        tokens = torch.where(write[None], sample_all, tokens)
        last_sample = sample_all
        has_sample = True
        num_forwards += 1
    return tokens, num_forwards


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
                 use_flash: bool = False,
                 use_fused_step: bool = True,
                 scan_from: Optional[int] = None,
                 scan_until: Optional[int] = None,
                 decode_state: Optional[dict] = None,
                 return_diagnostics: bool = False,
                 gumbel: Optional[torch.Tensor] = None,
                 bounds_from_mask: bool = True,
                 device: DeviceLike = None):
    """Generate/inpaint a codemap; returns [batch, F, T] int32.

    Mirrors the JAX package's ``sample_model`` (``generator`` takes the
    place of the JAX key; ``use_fused_step`` defaults to True here):

    - ``condition``: top codemap for the bottom prior (ignored for the
      self-conditional top prior, whose condition is the codemap itself);
    - ``initial_code``: known cells; masked cells are regenerated,
      unmasked cells pass through untouched;
    - ``mask``: boolean [F, T] (or [B, F, T], row 0 is used) over the
      target codemap; None = regenerate everything;
    - ``use_predictive_sampling``, else ``use_fused_step``, else the dense
      scan (``use_flash`` picks its attention kernel); top-k / top-p
      filtering is served by the dense and predictive samplers only;
    - ``scan_from`` / ``scan_until``: token-index bounds of the scan,
      derived from the mask when not given and ``bounds_from_mask`` (the
      server passes its bucketed bounds with ``bounds_from_mask=False``,
      as the JAX server's traced mask derives nothing);
    - ``gumbel``: optional noise instead of drawing it from ``generator``
      (shapes in the module docstring; see ``scan_range``);
    - ``return_diagnostics``: also return ``{"num_forwards", "num_steps"}``
      (decoder forwards run: data-dependent for predictive sampling);
    - ``device``: where the model lives (CUDA unless ``'cpu'``).
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, expected {dev}")
    cfg = model.config
    if use_fused_step and not use_predictive_sampling:
        reason = fused_unsupported(model, top_k_sampling_k, top_p_sampling_p)
        if reason is not None:
            raise ValueError(reason)
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

    num_forwards = None
    if use_predictive_sampling:
        tokens, num_forwards = _predictive_sample(
            model, memory, source_sequence, initial_tokens, mask_seq, cc,
            ti_tgt, temperature, top_k_sampling_k, top_p_sampling_p,
            compute_dtype=compute_dtype, gumbel=gumbel, generator=generator)
    else:
        pos_features = model._positional_sequence("target", ti_tgt)
        start_block = model._start_block("target", cc, batch_size)
        if use_fused_step:
            tokens = _fused_scan_sample(
                model, memory, initial_tokens, mask_seq, pos_features,
                start_block, temperature, compute_dtype=compute_dtype,
                scan_until=scan_until, scan_from=scan_from,
                decode_state=decode_state, gumbel=gumbel,
                generator=generator)
        else:
            class_block = (model._class_block(cc, batch_size)
                           if cfg.positional_class_conditioning else None)
            tokens = _scan_sample(
                model, memory, initial_tokens, mask_seq, pos_features,
                start_block, class_block, temperature, top_k_sampling_k,
                top_p_sampling_p, compute_dtype=compute_dtype,
                use_flash=use_flash, scan_until=scan_until,
                scan_from=scan_from, gumbel=gumbel, generator=generator)

    codemap_out = helper.to_time_frequency_map(tokens)
    if return_diagnostics:
        if num_forwards is None:
            # the scan paths run exactly their bound of steps
            num_forwards = ((scan_until if scan_until is not None else length)
                            - (scan_from if scan_from is not None else 0))
        return codemap_out, {"num_forwards": int(num_forwards),
                             "num_steps": length}
    return codemap_out


def make_sampling_fn(model: VQNSynthTransformer, batch_size: int,
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 0.0, with_mask: bool = True,
                     use_predictive_sampling: bool = False,
                     compute_dtype: Optional[torch.dtype] = None,
                     use_flash: bool = False, use_fused_step: bool = False,
                     scan_from: Optional[int] = None,
                     scan_until: Optional[int] = None,
                     decode_state: Optional[dict] = None,
                     device: DeviceLike = None):
    """Sampling closure: (generator, condition, initial_code, mask,
    class_conditioning) -> codemap, with the JAX package's arguments (the
    model carries its own weights, so the ``variables`` argument is gone;
    nothing is compiled, so the closure only binds the options;
    ``with_mask`` is accepted and unused, as there). Scan bounds given here
    are kept as they are: none is derived from the mask."""
    def fn(generator, condition, initial_code, mask, class_conditioning,
           gumbel=None):
        return sample_model(
            model, generator, batch_size, temperature=temperature,
            condition=condition, initial_code=initial_code,
            mask=mask,
            class_conditioning=class_conditioning,
            top_k_sampling_k=top_k, top_p_sampling_p=top_p,
            use_predictive_sampling=use_predictive_sampling,
            compute_dtype=compute_dtype, use_flash=use_flash,
            use_fused_step=use_fused_step, scan_from=scan_from,
            scan_until=scan_until, decode_state=decode_state, gumbel=gumbel,
            bounds_from_mask=False, device=device)

    return fn


def make_sharded_sampling_fn(model: VQNSynthTransformer, batch_size: int,
                             mesh: Mesh, temperature: float = 1.0,
                             top_k: int = 0, top_p: float = 0.0,
                             compute_dtype: Optional[torch.dtype] = None,
                             use_fused_step: bool = True,
                             decode_state: Optional[dict] = None,
                             device: DeviceLike = None):
    """Data-parallel batched sampling over a mesh's data ranks (the JAX
    package's ``make_sharded_sampling_fn``; the reference drove its batches
    through ``nn.DataParallel``).

    Returns ``fn(generators, condition, initial_code, mask,
    class_conditioning, gumbels=None)``, which every rank calls with the
    same arguments: ``condition``, ``initial_code`` and the class labels
    are ``[batch_size, ...]`` and each rank samples its block of
    ``batch_size / n_data`` rows with ``sample_model``, with no collective
    on the way; ``mask`` is shared. ``generators`` (or ``gumbels``, the
    noise of each shard in ``sample_model``'s layout) hold one entry per
    data rank, as the JAX function takes one key per shard. The fused
    kernels run at the per-shard batch: the scan and the prime at 1, the
    step kernel at 2-4, the batched one above. One all-gather of the
    codemaps at the end: every rank returns the ``[batch_size, F, T]``
    result, each block exactly what one process sampling that block alone
    with that rank's noise returns."""
    if batch_size % mesh.n_data:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{mesh.n_data} data ranks")
    per_shard = batch_size // mesh.n_data
    rows = mesh.rows(batch_size)
    shard = mesh.data_index

    def mine(x):
        return None if x is None else x[rows]

    def fn(generators, condition, initial_code, mask, class_conditioning,
           gumbels=None):
        out = sample_model(
            model, None if generators is None else generators[shard],
            per_shard, temperature=temperature, condition=mine(condition),
            initial_code=mine(initial_code), mask=mask,
            class_conditioning={k: mine(v)
                                for k, v in class_conditioning.items()},
            top_k_sampling_k=top_k, top_p_sampling_p=top_p,
            compute_dtype=compute_dtype, use_fused_step=use_fused_step,
            decode_state=decode_state,
            gumbel=None if gumbels is None else gumbels[shard],
            device=device)
        return all_gather_rows(out.contiguous(), mesh.data_group)

    return fn


def sample_hierarchical(model_top: VQNSynthTransformer,
                        model_bottom: VQNSynthTransformer,
                        generator: Optional[torch.Generator],
                        batch_size: int, temperature: float = 1.0,
                        class_conditioning_top: Mapping = {},
                        class_conditioning_bottom: Mapping = {},
                        initial_code_top=None, initial_code_bottom=None,
                        mask_top=None, mask_bottom=None,
                        top_k: int = 0, top_p: float = 0.0,
                        gumbel_top: Optional[torch.Tensor] = None,
                        gumbel_bottom: Optional[torch.Tensor] = None,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top -> bottom cascade through the dense sampler: sample/inpaint the
    top codemap, upsample the top mask to the bottom resolution, sample
    the bottom conditioned on the new top.
    Returns (top_codemap, bottom_codemap)."""
    top_code = sample_model(
        model_top, generator, batch_size, temperature=temperature,
        class_conditioning=class_conditioning_top,
        initial_code=initial_code_top, mask=mask_top,
        top_k_sampling_k=top_k, top_p_sampling_p=top_p,
        use_fused_step=False, gumbel=gumbel_top, device=device)
    if mask_top is not None and mask_bottom is None:
        cfg_b = model_bottom.config
        mask_map = np.asarray(mask_top.cpu() if isinstance(
            mask_top, torch.Tensor) else mask_top, bool)
        if mask_map.ndim == 3:
            mask_map = mask_map[0]
        mask_bottom = np.repeat(
            np.repeat(mask_map, cfg_b.patch_frequencies, axis=0),
            cfg_b.patch_duration, axis=1)
    bottom_code = sample_model(
        model_bottom, generator, batch_size, temperature=temperature,
        condition=top_code, class_conditioning=class_conditioning_bottom,
        initial_code=initial_code_bottom, mask=mask_bottom,
        top_k_sampling_k=top_k, top_p_sampling_p=top_p,
        use_fused_step=False, gumbel=gumbel_bottom, device=device)
    return top_code, bottom_code
