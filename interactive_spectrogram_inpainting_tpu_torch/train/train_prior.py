"""Prior trainer CLI.

Port of ``interactive_spectrogram_inpainting_tpu/train/train_prior.py``:
trains the top (self-conditional, masked-source) or bottom
(top-conditioned) prior on stored codemaps with label-smoothed
cross-entropy, token accuracy and, for the top prior, the share of kept
tokens predicted back (``satisfied_constraints``). The GPU unless
``--device cpu``. On the GPU ``--fused_attention auto`` (the default) runs
every attention of the step through the training kernels of
``ops/train_attention.py``.

    python -m interactive_spectrogram_inpainting_tpu_torch.train.train_prior \\
        --hier bottom --use_aligned_decoder --database_path CODES_DIR

Several processes, one per device (``torchrun --nproc_per_node N -m
...train.train_prior --num_devices_data D --num_devices_model M``, D x M =
N), train over a ``('data', 'model')`` mesh (``parallel/mesh.py``): each
data rank takes its rows of every global batch, the priors' heads and d_ff
are split over the model ranks, the gradients and metrics are averaged over
the data ranks and the eval sums added, so the update is the one-process
update of the global batch. Rank 0 writes the logs and the files.

Each epoch ends with a rolling checkpoint (``train/checkpoint.py``) and the
trained prior written as ``<hier>-model_parameters.json`` +
``<hier>-weights.msgpack``, the files the server and the JAX package load.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from contextlib import ExitStack, contextmanager, nullcontext
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.lmdb_compat import open_codes_dataset
from ..models.prior.masks import (BernoulliSequenceMask,
                                  ContiguousZonesSequenceMask, SequenceMask,
                                  UniformMaskedAmountSequenceMask,
                                  UniformProbabilityBernoulliSequenceMask)
from ..models.prior.transformer import (SelfAttentiveVQTransformer,
                                        TransformerConfig,
                                        UpsamplingVQTransformer,
                                        VQNSynthTransformer)
from ..parallel.collectives import (mean_of_gradients, mean_of_metrics,
                                    optional_group, sum_of_eval)
from ..parallel.distributed import initialize_multihost, maybe_watchdog
from ..parallel.mesh import (Mesh, gather_prior_parameters,
                             is_master_process, shard_batch,
                             shard_prior_parameters, trainer_mesh)
from ..utils.checkpoint_io import load_variables, save_model
from ..utils.device import resolve_device, set_float32_precision
from ..utils.metrics import MetricsWriter
from ..utils.tracing import span
from ..utils.weights import from_flax_params, init_like_flax
from .checkpoint import Checkpointer, gather_optimizer_state, \
    shard_optimizer_state
from .losses import label_smoothing_loss
from .scheduler import Optimizer, get_optimizer


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_type", type=str, default="transformer",
                   choices=["transformer"])
    p.add_argument("--hier", type=str, required=True,
                   choices=["top", "bottom"])
    p.add_argument("--database_path", type=str, required=True,
                   help="codemap store directory (or LMDB environment)")
    p.add_argument("--validation_database_path", type=str, default=None)
    p.add_argument("--num_training_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "radam"])
    p.add_argument("--optimizer_eps", type=float, default=1e-8,
                   help="Adam/RAdam epsilon")
    p.add_argument("--scheduler", type=str, default=None,
                   choices=[None, "cycle", "warmup-cosine"])
    p.add_argument("--num_warmup_steps", type=int, default=None,
                   help="warmup-cosine warmup length (default: 2%% of the "
                        "total step count)")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--clip_grad_norm", type=float, default=None)
    p.add_argument("--n_class", type=int, default=None,
                   help="codebook vocabulary; default: read from the codes "
                        "store (512 if it records none)")
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--embeddings_dim", type=int, default=32)
    p.add_argument("--positional_embeddings_dim", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--num_decoder_layers", type=int, default=8)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--use_aligned_decoder", action="store_true")
    p.add_argument("--use_identity_memory_mask", action="store_true")
    p.add_argument("--classes_for_conditioning", type=str, nargs="*",
                   default=["pitch", "instrument_family_str"])
    p.add_argument("--class_conditioning_embedding_dim", type=int,
                   default=64)
    p.add_argument("--class_conditioning_prepend_to_dummy_input",
                   action="store_true", default=True)
    p.add_argument("--positional_class_conditioning", action="store_true")
    p.add_argument("--mask_sampler", type=str, default="uniform-probability",
                   choices=["bernoulli", "uniform-probability",
                            "uniform-amount", "contiguous-zones"])
    p.add_argument("--mask_probability", type=float, default=0.5)
    p.add_argument("--mask_probability_range", type=float, nargs=2,
                   default=[0.0, 1.0],
                   help="p ~ U[low, high] for the uniform-probability "
                        "sampler")
    p.add_argument("--mask_min_masking_ratio", type=float, default=0.0)
    p.add_argument("--num_training_samples", type=int, default=None)
    p.add_argument("--evaluate_only", action="store_true")
    # debug restrictions of the loss; see make_steps
    p.add_argument("--drop_loss_half_DEBUG", action="store_true")
    p.add_argument("--train_num_steps_sequences_DEBUG", type=int,
                   default=None)
    p.add_argument("--initial_weights_path", type=str, default=None,
                   help="warm start from a flax msgpack {'params': ...} blob "
                        "(the JAX package's weights file)")
    p.add_argument("--initial_model_parameters_path", type=str, default=None)
    p.add_argument("--resume_training_from", type=str, default=None,
                   help="run directory whose latest checkpoint to resume")
    p.add_argument("--validation_frequency", type=int, default=1)
    p.add_argument("--save_frequency", type=int, default=1)
    p.add_argument("--train_logs_frequency_batches", type=int, default=10)
    p.add_argument("--disable_writes_to_disk", action="store_true")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--runs_directory", type=str, default="runs")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder/decoder layer in the "
                        "backward pass (torch.utils.checkpoint): about a "
                        "third more work for the memory of one layer's "
                        "activations")
    p.add_argument("--bf16", action="store_true",
                   help="forward and backward on bfloat16 casts of the "
                        "float32 master parameters")
    p.add_argument("--fused_attention", choices=["auto", "on", "off"],
                   default="auto",
                   help="training-attention kernels (the [B, H, L, L] "
                        "probabilities never reach device memory). 'auto' "
                        "runs them on the GPU and the dense composition on "
                        "the CPU; 'on' takes the autograd function on any "
                        "device (its plain version on the CPU); 'off' is "
                        "the dense composition")
    p.add_argument("--dropout_rng", choices=["auto", "threefry", "rbg"],
                   default="auto",
                   help="accepted for the JAX trainer's command lines; every "
                        "value draws the dropout masks from the one "
                        "torch.Generator seeded from --seed")
    p.add_argument("--num_devices_data", type=int, default=None,
                   help="data-parallel mesh size (default: WORLD_SIZE // "
                        "--num_devices_model); must divide --batch_size")
    p.add_argument("--num_devices_model", type=int, default=1,
                   help="tensor-parallel mesh size (heads and d_ff split)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch "
                        "into <run>/profile; it holds the step's spans "
                        "train.batch, train.forward, train.backward and "
                        "train.optimizer")
    p.add_argument("--watchdog_timeout_s", type=float, default=0.0,
                   help="abort (exit 42, for a restart from the checkpoint) "
                        "if no training step completes within this many "
                        "seconds; 0 = off")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the parameters, the dropout and mask draws "
                        "and the per-epoch shuffle")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def make_mask_sampler(name: str, sequence_length: int, mask_token: int,
                      probability: float, min_ratio: float,
                      probability_range=(0.0, 1.0)) -> SequenceMask:
    if name == "bernoulli":
        return BernoulliSequenceMask(probability, sequence_length,
                                     mask_token)
    if name == "uniform-probability":
        low, high = probability_range
        return UniformProbabilityBernoulliSequenceMask(
            low, high, sequence_length, mask_token)
    if name == "uniform-amount":
        return UniformMaskedAmountSequenceMask(min_ratio, sequence_length,
                                               mask_token)
    if name == "contiguous-zones":
        return ContiguousZonesSequenceMask(min_ratio, sequence_length,
                                           mask_token)
    raise ValueError(name)


def build_model(args, dataset, fused_attention: bool) -> VQNSynthTransformer:
    top_shape = dataset.top_shape
    bottom_shape = dataset.bottom_shape
    modalities = None
    dims = None
    if args.classes_for_conditioning:
        modalities = {}
        dims = {}
        for name in args.classes_for_conditioning:
            encoder = dataset.label_encoders.get(name)
            modalities[name] = (len(encoder) if encoder else 128)
            dims[name] = args.class_conditioning_embedding_dim
    n_class = args.n_class
    if n_class is None:
        # size the vocabulary from the store (recorded at extraction)
        nt = getattr(dataset, "n_class_top", None)
        nb = getattr(dataset, "n_class_bottom", None)
        if args.hier == "top":
            n_class = nt
        else:
            # the bottom prior's one vocabulary covers the top codes of its
            # source too
            if nt is not None and nb is not None and nt > nb:
                raise SystemExit(
                    f"store has unequal codebooks (top {nt} > bottom "
                    f"{nb}); the bottom prior's single vocabulary "
                    f"cannot cover both: pass --n_class {nt} explicitly")
            n_class = nb
        if n_class is None:
            n_class = 512
            print("store records no n_class; defaulting to 512 "
                  "(pass --n_class to override)")
        else:
            print(f"n_class={n_class} (from the codes store)")
    common = dict(
        n_class=n_class, d_model=args.d_model,
        embeddings_dim=args.embeddings_dim,
        positional_embeddings_dim=args.positional_embeddings_dim,
        dropout=args.dropout,
        class_conditioning_num_classes_per_modality=modalities,
        class_conditioning_embedding_dim_per_modality=dims,
        class_conditioning_prepend_to_dummy_input=(
            args.class_conditioning_prepend_to_dummy_input),
        positional_class_conditioning=args.positional_class_conditioning,
        conditional_model_num_encoder_layers=args.num_encoder_layers,
        conditional_model_num_decoder_layers=args.num_decoder_layers,
        conditional_model_nhead=args.num_heads, d_ff=args.d_ff,
        use_identity_memory_mask=args.use_identity_memory_mask,
        remat=args.remat, fused_attention=fused_attention)
    if args.hier == "top":
        config = TransformerConfig(shape=tuple(top_shape),
                                   condition_shape=tuple(top_shape),
                                   self_conditional_model=True, **common)
        return SelfAttentiveVQTransformer(config)
    config = TransformerConfig(shape=tuple(bottom_shape),
                               condition_shape=tuple(top_shape),
                               use_aligned_decoder=args.use_aligned_decoder,
                               **common)
    return UpsamplingVQTransformer(config)


@contextmanager
def bfloat16_parameters(model: nn.Module, promote: bool = False):
    """Inside the block every floating parameter of ``model`` reads as its
    bfloat16 cast (``p.to(torch.bfloat16)``, differentiable: gradients land
    on the float32 parameter). A backward run inside the block, remat's
    recomputation included, sees the same casts.

    ``promote``: a module whose input is float32 reads that cast taken back
    to float32 instead, and computes in float32 on the bfloat16-rounded
    values: what flax does with a bfloat16 parameter and a float32 input
    (``jnp.result_type`` promotes both)."""
    saved, hooks = [], []
    for module in model.modules():
        casts = {}
        for name, p in list(module._parameters.items()):
            if p is not None and p.is_floating_point():
                saved.append((module, name, p))
                del module._parameters[name]
                half = p.to(torch.bfloat16)
                casts[name] = (half, half.float() if promote else half)
                setattr(module, name, half)
        if promote and casts:
            def pick(mod, args, casts=casts):
                i = 0 if args[0].dtype == torch.bfloat16 else 1
                for name, pair in casts.items():
                    setattr(mod, name, pair[i])
            hooks.append(module.register_forward_pre_hook(pick))
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()
        for module, name, p in saved:
            delattr(module, name)
            module._parameters[name] = p


def make_steps(model: VQNSynthTransformer, optimizer: Optional[Optimizer],
               hier: str, mask_sampler: Optional[SequenceMask],
               label_smoothing: float, bf16: bool = False,
               drop_loss_half: bool = False,
               loss_num_steps: Optional[int] = None,
               mesh: Optional[Mesh] = None):
    """-> (train_step, eval_step).

    ``train_step(tops, bottoms, class_conditioning, generator)`` runs one
    update and returns the batch means of the per-sample metrics (tensors
    on the device; the gradients stay in the parameters' ``.grad``).
    ``eval_step(tops, bottoms, class_conditioning, weights, generator)``
    returns (weighted metric sums, weight sum): padding rows (weight 0)
    count for nothing, so the caller's sums over all batches divided by
    the summed weights are the exact per-sample means.
    ``generator`` (a CPU ``torch.Generator``) draws the top prior's masks
    and the dropout seeds. With ``bf16`` the forward runs on bfloat16 casts
    of the float32 parameters, cast inside the differentiated function, so
    the gradients land on the float32 masters.

    ``drop_loss_half`` / ``loss_num_steps`` restrict the LOSS to the first
    half of the codemap columns in time, or to the first
    ``loss_num_steps`` sequence positions; accuracy and constraints stay
    whole-map.

    ``mesh`` (the model sharded by ``shard_prior_parameters``): the batch
    tensors are this rank's rows; the masks are drawn for the global batch
    and this rank's rows kept, the gradients and metrics are averaged over
    the data group and the eval sums added over it."""
    cfg = model.config
    tgt_helper = cfg.target_codemaps_helper()
    src_helper = cfg.source_codemaps_helper()
    casts = (lambda: bfloat16_parameters(model)) if bf16 else nullcontext
    loss_step_weights = None
    if loss_num_steps is not None:
        loss_step_weights = (np.arange(tgt_helper.sequence_length)
                             < int(loss_num_steps))
    elif drop_loss_half:
        loss_step_weights = (tgt_helper.positions()[:, 1]
                             < tgt_helper.duration // 2)
    if loss_step_weights is not None:
        loss_step_weights = torch.as_tensor(
            loss_step_weights.astype(np.float32), device=model.device)
    data_group = optional_group(mesh, "data")
    n_data = 1 if mesh is None else mesh.n_data

    def forward_loss(tops, bottoms, class_conditioning, generator,
                     deterministic):
        mask = mask_seq = None
        if hier == "top":
            target_map = condition_map = tops
            mask_seq = mask_sampler.sample_mask(
                generator, batch_size=tops.shape[0] * n_data)
            if mesh is not None:
                mask_seq = shard_batch(mesh, mask_seq)
            mask_seq = mask_seq.to(tops.device)
            mask = src_helper.to_time_frequency_map(mask_seq)
        else:
            target_map, condition_map = bottoms, tops
        src_seq, tgt_seq = model.to_sequences(
            target_map, condition_map, class_conditioning=class_conditioning,
            mask=mask)
        logits, _ = model(tgt_seq, src_seq, deterministic=deterministic,
                          generator=generator)
        targets = tgt_helper.to_sequence(target_map).long()
        per_token = label_smoothing_loss(logits, targets,
                                         smoothing=label_smoothing,
                                         reduction="none")
        if loss_step_weights is not None:
            per_sample_loss = ((per_token * loss_step_weights).sum(1)
                               / loss_step_weights.sum())
        else:
            per_sample_loss = per_token.mean(1)
        loss = per_sample_loss.mean()
        predictions = torch.argmax(logits, dim=-1)
        correct = (predictions == targets).float()
        metrics = {"loss": per_sample_loss, "accuracy": correct.mean(1)}
        if hier == "top":
            # kept (unmasked) tokens predicted back
            kept = (~mask_seq).float()
            metrics["satisfied_constraints"] = (
                (correct * kept).sum(1) / kept.sum(1).clamp(min=1.0))
        return loss, metrics

    def train_step(tops, bottoms, class_conditioning, generator):
        # the casts hold from the forward through the backward
        with ExitStack() as cast:
            with span("train.forward"):
                optimizer.zero_grad()
                cast.enter_context(casts())
                loss, metrics = forward_loss(tops, bottoms,
                                             class_conditioning, generator,
                                             False)
            with span("train.backward"):
                loss.backward()
        with span("train.optimizer"):
            mean_of_gradients(model.parameters(), data_group)
            optimizer.step()
            return mean_of_metrics({k: v.detach().mean()
                                    for k, v in metrics.items()}, data_group)

    @torch.no_grad()
    def eval_step(tops, bottoms, class_conditioning, weights, generator):
        with span("train.forward"), casts():
            _, metrics = forward_loss(tops, bottoms, class_conditioning,
                                      generator, True)
        sums = {k: (v * weights).sum() for k, v in metrics.items()}
        return sum_of_eval(sums, weights.sum(), data_group)

    return train_step, eval_step


def iterate_batches(dataset, batch_size: int, shuffle: bool, epoch: int,
                    limit: Optional[int] = None, seed: int = 0,
                    include_remainder: bool = False, device=None,
                    mesh: Optional[Mesh] = None):
    """Yield (tops, bottoms, class_conditioning, weights) batches as tensors
    on ``device``, in the JAX trainer's order (``default_rng([seed,
    epoch])``); with ``mesh``, this rank's rows of each.

    ``weights`` is a float32 [batch_size] validity vector: 1.0 for real
    samples, 0.0 for padding. Training drops the remainder; with
    ``include_remainder=True`` the final partial batch is zero-padded to
    ``batch_size`` and its padding rows carry weight 0. Each batch's
    gathering, padding and copy is one ``train.batch`` span, closed before
    the batch is handed over."""
    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    n = len(dataset) if limit is None else min(limit, len(dataset))
    order = (np.random.default_rng([seed, epoch]).permutation(n) if shuffle
             else np.arange(n))
    stop = n + 1 if include_remainder else n - batch_size + 1
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) == 0:
            break
        with span("train.batch"):
            tops, bottoms, attrs = dataset.read_batch(idx)
            weights = np.ones(batch_size, np.float32)
            if len(idx) < batch_size:
                pad = batch_size - len(idx)
                weights[len(idx):] = 0.0
                tops = np.concatenate(
                    [tops, np.zeros((pad,) + tops.shape[1:], tops.dtype)])
                bottoms = np.concatenate(
                    [bottoms,
                     np.zeros((pad,) + bottoms.shape[1:], bottoms.dtype)])
                attrs = {k: np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in attrs.items()}

            if mesh is not None:
                tops, bottoms, attrs, weights = shard_batch(
                    mesh, (tops, bottoms, attrs, weights))
            batch = (put(tops.astype(np.int64)),
                     put(bottoms.astype(np.int64)),
                     {k: put(v.astype(np.int64)) for k, v in attrs.items()},
                     put(weights))
        yield batch


@torch.no_grad()
def prediction_figure(model: VQNSynthTransformer, dataset, hier: str,
                      batch_size: int, device, path: Optional[pathlib.Path],
                      mesh: Optional[Mesh] = None) -> None:
    """The target-vs-predicted success map of the first codemap of the
    first batch, written to ``path`` (reference
    ``train_autoregressive_model.py:308-346``); one log line instead when
    matplotlib is not installed. On a mesh every rank runs the forward of
    its rows (the model ranks' collectives need them all) and the rank
    holding the first row writes (``path`` None on the others)."""
    from ..utils.visualization import (have_matplotlib,
                                       plot_prediction_success_map,
                                       save_figure)
    if not have_matplotlib():
        if path is not None:
            print("codemap prediction figure skipped: matplotlib is not "
                  "installed")
        return
    tops, bottoms, cc, _ = next(iterate_batches(dataset, batch_size, False,
                                                0, device=device, mesh=mesh))
    target_map = tops if hier == "top" else bottoms
    src_seq, tgt_seq = model.to_sequences(target_map, tops,
                                          class_conditioning=cc)
    logits, _ = model(tgt_seq, src_seq, deterministic=True)
    pred = model.config.target_codemaps_helper().to_time_frequency_map(
        torch.argmax(logits, dim=-1))
    if path is None:
        return
    save_figure(plot_prediction_success_map(
        target_map[0].cpu().numpy(), pred[0].cpu().numpy()), path)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train (or ``--evaluate_only``: evaluate) a prior. Returns the trained
    model (on a mesh: this rank's shard), or the evaluation metrics."""
    args = make_parser().parse_args(argv)
    initialize_multihost(device=args.device)
    mesh = trainer_mesh(args.num_devices_data, args.num_devices_model,
                        args.batch_size)
    master = is_master_process()
    device = resolve_device(args.device)
    set_float32_precision()
    run_id = (datetime.now().strftime("%Y%m%d-%H%M%S")
              + f"-prior-{args.hier}")
    run_dir = pathlib.Path(args.runs_directory) / run_id

    dataset = open_codes_dataset(
        args.database_path,
        classes_for_conditioning=args.classes_for_conditioning)
    valid_dataset = (open_codes_dataset(
        args.validation_database_path,
        classes_for_conditioning=args.classes_for_conditioning)
        if args.validation_database_path else None)

    fused = args.fused_attention == "on" or (
        args.fused_attention == "auto" and device.type == "cuda")
    if args.initial_model_parameters_path:
        # a warm start rebuilds the donor's architecture from its stored
        # config, not from the command line
        cfg = TransformerConfig.from_json(
            pathlib.Path(args.initial_model_parameters_path).read_text())
        cfg = dataclasses.replace(cfg, remat=args.remat,
                                  fused_attention=fused)
        model = (SelfAttentiveVQTransformer(cfg) if args.hier == "top"
                 else UpsamplingVQTransformer(cfg))
    else:
        model = build_model(args, dataset, fused)
    init_like_flax(model, torch.Generator().manual_seed(args.seed))
    if args.initial_weights_path:
        model.load_state_dict(from_flax_params(
            load_variables(args.initial_weights_path)))
    cfg = model.config

    if len(dataset) < args.batch_size:
        raise SystemExit(
            f"dataset has {len(dataset)} records, fewer than "
            f"--batch_size {args.batch_size}: no full batch to train on")
    start_epoch = 0
    resumed = None
    if args.resume_training_from:
        # checkpoints hold the whole model: load it, then shard it
        resumed, start_epoch = Checkpointer(
            args.resume_training_from).restore(map_location="cpu")
        model.load_state_dict(resumed["model"])
        start_epoch += 1
    model.to(device)
    shard_prior_parameters(model, mesh)

    steps_per_epoch = max(1, len(dataset) // args.batch_size)
    total_steps = steps_per_epoch * args.num_training_epochs
    optimizer = get_optimizer(
        model.parameters(), args.optimizer, args.scheduler, args.lr,
        total_steps, warmup_steps=args.num_warmup_steps or 0,
        eps=args.optimizer_eps, clip_grad_norm=args.clip_grad_norm)
    if mesh.n_model > 1:
        optimizer.sharded = [model.param_dims[name] is not None
                             for name, _ in model.named_parameters()]
        optimizer.model_group = mesh.model_group
    if resumed is not None:
        optimizer.load_state_dict(shard_optimizer_state(
            resumed["optimizer"], model))

    mask_sampler = None
    if args.hier == "top":
        mask_sampler = make_mask_sampler(
            args.mask_sampler, cfg.source_sequence_length,
            cfg.mask_token_index, args.mask_probability,
            args.mask_min_masking_ratio,
            probability_range=tuple(args.mask_probability_range))
    train_step, eval_step = make_steps(
        model, optimizer, args.hier, mask_sampler, args.label_smoothing,
        bf16=args.bf16, drop_loss_half=args.drop_loss_half_DEBUG,
        loss_num_steps=args.train_num_steps_sequences_DEBUG, mesh=mesh)

    writes = not (args.disable_writes_to_disk or args.dry_run)
    writer = MetricsWriter(run_dir / "tb", enabled=writes and master)
    checkpointer = None
    if writes and master:
        checkpointer = Checkpointer(run_dir, args.save_frequency)
        checkpointer.store_command_line_parameters(vars(args))
        checkpointer.store_model_parameters(cfg.to_json())

    generator = torch.Generator().manual_seed(args.seed)
    global_step = start_epoch * steps_per_epoch

    def run_eval():
        sums: Dict[str, float] = {}
        count = 0.0
        source = valid_dataset if valid_dataset is not None else dataset
        for tops, bottoms, cc, w in iterate_batches(
                source, args.batch_size, False, 0,
                limit=args.num_training_samples, include_remainder=True,
                device=device, mesh=mesh):
            m, c = eval_step(tops, bottoms, cc, w, generator)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += float(c)
            if args.dry_run:
                break
        return {k: v / max(count, 1e-9) for k, v in sums.items()}

    if args.evaluate_only:
        metrics = run_eval()
        if master:
            print("evaluation:", json.dumps(metrics, indent=2))
        writer.close()
        return metrics

    watchdog = maybe_watchdog(args.watchdog_timeout_s)
    try:
        for epoch in range(start_epoch, args.num_training_epochs):
            profiler = nullcontext()
            profiling = args.profile and epoch == start_epoch and writes \
                and master
            if profiling:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
            _synchronize(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            t_warm, steps = None, 0
            with profiler:
                for tops, bottoms, cc, _ in iterate_batches(
                        dataset, args.batch_size, True, epoch,
                        limit=args.num_training_samples, seed=args.seed,
                        device=device, mesh=mesh):
                    metrics = train_step(tops, bottoms, cc, generator)
                    steps += 1
                    if steps == 1:
                        # the steps after the first are the warm ones
                        _synchronize(device)
                        t_warm = time.perf_counter()
                    if watchdog is not None:
                        watchdog.pet()
                    if global_step % args.train_logs_frequency_batches == 0:
                        writer.scalars(f"{args.hier}/training", metrics,
                                       global_step)
                    global_step += 1
                    if args.dry_run:
                        break
                _synchronize(device)
            t1 = time.perf_counter()
            if profiling:
                (run_dir / "profile").mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(
                    str(run_dir / "profile" / "trace.json"))
            timing = {"epoch_s": t1 - t0, "steps": steps}
            if steps > 1:
                timing["warm_step_ms"] = (t1 - t_warm) * 1e3 / (steps - 1)
                timing["steps_per_s"] = (steps - 1) / (t1 - t_warm)
            if device.type == "cuda":
                timing["max_memory_allocated_gib"] = (
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)
            writer.scalars(f"{args.hier}/epoch", timing, global_step)
            msg = (f"epoch {epoch}: {t1 - t0:.1f}s "
                   f"loss={float(metrics['loss']):.4f} "
                   f"acc={float(metrics['accuracy']):.3f}")
            if "satisfied_constraints" in metrics:
                msg += (f" constraints="
                        f"{float(metrics['satisfied_constraints']):.3f}")
            if "warm_step_ms" in timing:
                msg += f" warm step {timing['warm_step_ms']:.2f} ms"
            if master:
                print(msg, flush=True)

            validation_loss = None
            if epoch % args.validation_frequency == 0:
                val = run_eval()
                validation_loss = val.get("loss")
                writer.scalars(f"{args.hier}/validation", val, global_step)
                if writes:
                    prediction_figure(
                        model, dataset, args.hier, args.batch_size, device,
                        writer.directory / "media"
                        / f"codemap_prediction-{epoch}.png"
                        if master else None, mesh)

            if writes:
                # the single-device format: gathered, written by rank 0
                full = gather_prior_parameters(model)
                opt_state = gather_optimizer_state(optimizer.state_dict(),
                                                   model)
                if checkpointer is not None:
                    checkpointer.save(epoch, {"model": full,
                                              "optimizer": opt_state},
                                      validation_loss)
                    save_model(run_dir, model, prefix=args.hier,
                               state_dict=full)
            if args.dry_run:
                if master:
                    print("dry run complete")
                break
    finally:
        if watchdog is not None:
            watchdog.stop()
        writer.close()
    return model


if __name__ == "__main__":
    main()
