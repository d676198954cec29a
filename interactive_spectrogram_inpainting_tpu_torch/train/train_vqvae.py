"""VQ-VAE trainer CLI.

Port of ``interactive_spectrogram_inpainting_tpu/train/train_vqvae.py``:
trains the two-level VQ-VAE-2 on NSynth-shaped wav data with the EMA
codebooks, a reconstruction criterion (``mse``, or the DDSP / Jukebox
multiscale spectral losses, whose scales run through the spectral-loss
kernel on the GPU) plus ``latent_loss_weight`` times the commitment loss,
and at every log step the MSE / DDSP / Jukebox metric trio. The GPU unless
``--device cpu``.

    python -m interactive_spectrogram_inpainting_tpu_torch.train.train_vqvae \\
        --use_mel_scale --input_normalization \\
        --resolution_factors top=2,bottom=16 --batch_size 64 \\
        --reconstruction_criterion spectral_jukebox \\
        --dataset_audio_directory_paths AUDIO_DIR \\
        --train_dataset_json_data_path examples.json

Each epoch ends with a rolling checkpoint (``train/checkpoint.py``) and the
model written as ``vqvae-model_parameters.json`` + ``vqvae-weights.msgpack``,
the files the server, the extractor and the JAX package load.

Several processes, one per device (``torchrun --nproc_per_node N -m
...train.train_vqvae --num_devices_data N``), split every global batch
into row blocks over a ``('data',)`` mesh (``parallel/mesh.py``): each rank
reads and encodes its rows, the gradients and metrics are averaged, the
codebooks' EMA statistics, the normalizer's ranges and the eval sums are
combined over the ranks, so the update is the one-process update of the
global batch. Rank 0 writes the logs and the files.

Not carried over from the JAX trainer: its host-side spectrogram branch
(a workaround for a TPU backend without complex FFTs; ``torch.fft`` runs
on the card). The reconstruction figure of the media dump needs
matplotlib (without it the run logs one line instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time
from contextlib import nullcontext
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from ..data.loader import BatchLoader
from ..data.nsynth import NSynth
from ..models.vqvae.vqvae import VQVAE, VQVAEConfig
from ..parallel.collectives import (mean_of_gradients, mean_of_metrics,
                                    optional_group, sum_of_eval)
from ..parallel.distributed import initialize_multihost, maybe_watchdog
from ..parallel.mesh import (Mesh, is_master_process, set_data_mesh,
                             shard_batch, trainer_mesh)
from ..signal.normalizer import DataNormalizer, DataNormalizerStatistics
from ..signal.spectrogram import (get_spectrograms_helper,
                                  make_masked_phase_transform)
from ..utils.checkpoint_io import save_model
from ..utils.device import resolve_device, set_float32_precision
from ..utils.metrics import MetricsWriter
from ..utils.weights import init_like_flax
from .checkpoint import Checkpointer
from .losses import (get_reconstruction_criterion,
                     make_reconstruction_metrics, mse_loss)
from .scheduler import Optimizer, get_optimizer
from .train_prior import bfloat16_parameters


class StoreDictKeyPair(argparse.Action):
    """--resolution_factors top=2,bottom=4"""

    def __call__(self, parser, namespace, values, option_string=None):
        d = {}
        for kv in values.split(","):
            k, v = kv.split("=")
            d[k] = int(v)
        setattr(namespace, self.dest, d)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resolution_factors", action=StoreDictKeyPair,
                   default={"top": 2, "bottom": 2})
    p.add_argument("--fs_hz", type=int, default=16000)
    p.add_argument("--window_length", type=int, default=2048)
    p.add_argument("--n_fft", type=int, default=2048)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--use_local_kernels", action="store_true")
    p.add_argument("--num_embeddings", type=int, default=512)
    p.add_argument("--disable_quantization", action="store_true")
    p.add_argument("--restarts_usage_threshold", type=float, default=1.0)
    p.add_argument("--embeddings_dimension", type=int, default=64)
    p.add_argument("--num_hidden_channels", type=int, default=128)
    p.add_argument("--num_residual_channels", type=int, default=32)
    p.add_argument("--num_residual_blocks", type=int, default=2)
    p.add_argument("--num_training_epochs", type=int, default=560)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--latent_loss_weight", type=float, default=0.25)
    p.add_argument("--clip_grad_norm", type=float, default=None)
    p.add_argument("--dataset", type=str, default="nsynth",
                   choices=["nsynth", "imagenet"],
                   help="only the nsynth path is implemented")
    p.add_argument("--dataset_type", type=str, default="wav",
                   choices=["wav", "hdf5"])
    p.add_argument("--use_mel_scale", action="store_true")
    p.add_argument("--mel_scale_lower_edge_hertz", type=float, default=0.0)
    p.add_argument("--mel_scale_upper_edge_hertz", type=float,
                   default=16000 / 2.0)
    p.add_argument("--mel_scale_break_frequency_hertz", type=float,
                   default=700.0)
    p.add_argument("--mel_scale_expand_resolution_factor", type=float,
                   default=1.5)
    p.add_argument("--normalize_input_images", action="store_true")
    p.add_argument("--valid_pitch_range", type=int, nargs=2,
                   default=[24, 84])
    p.add_argument("--dataset_duration_seconds", type=float, default=4.0)
    p.add_argument("--groups", type=int, default=1)
    p.add_argument("--sched", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--output_spectrogram_threshold", action="store_true")
    p.add_argument("--output_spectrogram_min_magnitude", type=float,
                   default=None)
    p.add_argument("--reconstruction_criterion", type=str, default="mse",
                   choices=["mse", "spectral_ddsp", "spectral_jukebox"])
    p.add_argument("--spectral_precision", type=str, default="high",
                   choices=["highest", "high", "default"],
                   help="DFT products of the spectral losses: 'high' "
                        "float32 (the kernel), 'default' bfloat16 operands "
                        "(the kernel), 'highest' float32 through the plain "
                        "PyTorch path")
    p.add_argument("--dataset_audio_directory_paths", type=str, nargs="+",
                   default=[])
    p.add_argument("--train_dataset_json_data_path", type=str, default=None)
    p.add_argument("--validation_dataset_json_data_path", type=str,
                   default=None)
    p.add_argument("--validation_frequency", type=int, default=1)
    p.add_argument("--save_frequency", type=int, default=1)
    p.add_argument("--train_logs_frequency_batches", type=int, default=1)
    p.add_argument("--disable_writes_to_disk", action="store_true")
    p.add_argument("--disable_tensorboard", action="store_true")
    p.add_argument("--enable_image_dumps", action="store_true",
                   help="every 100 train batches, write per-channel PNG "
                        "grids (input | reconstruction | |diff|) under "
                        "<run>/samples")
    p.add_argument("--dry_run", action="store_true",
                   help="one train + eval step, no writes")
    p.add_argument("--input_normalization", action="store_true")
    p.add_argument("--precomputed_normalization_statistics", type=str,
                   default=None)
    p.add_argument("--corrupt_codes", type=str, default=None,
                   choices=["bottom", "top", "both"])
    p.add_argument("--corruption_weights", type=float, nargs=3,
                   default=[0.1, 0.8, 0.1])
    p.add_argument("--embeddings_initial_variance", type=float, default=1.0)
    p.add_argument("--resume_training_from", type=str, default=None)
    p.add_argument("--use_resnet", action="store_true")
    p.add_argument("--resnet_layers_per_downsampling_block", type=int,
                   default=4)
    p.add_argument("--resnet_expansion", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=2,
                   help="accepted for the JAX trainer's command lines; one "
                        "loader thread prefetches the batches")
    p.add_argument("--runs_directory", type=str, default="runs")
    p.add_argument("--num_devices_data", type=int, default=None,
                   help="data-parallel mesh size (default: WORLD_SIZE); "
                        "must divide --batch_size")
    p.add_argument("--bf16", action="store_true",
                   help="forward and backward on bfloat16 casts of the "
                        "float32 master parameters and input, promoted to "
                        "float32 where a float32 tensor meets them, as in "
                        "the JAX trainer (the codebooks stay float32)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch "
                        "into <run>/profile: operators and kernels; this "
                        "trainer marks none of the prior trainer's train.* "
                        "spans")
    p.add_argument("--pallas_vq", action="store_true",
                   help="nearest-code lookup and its EMA statistics through "
                        "the VQ-lookup kernel (the JAX package's flag name)")
    p.add_argument("--num_tensorboard_audio_samples", type=int, default=3)
    p.add_argument("--watchdog_timeout_s", type=float, default=0.0,
                   help="abort (exit 42, for a restart from the checkpoint) "
                        "if no training step completes within this many "
                        "seconds; 0 = off")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def build_config(args) -> VQVAEConfig:
    corruption = {"top": None, "bottom": None}
    if args.corrupt_codes in ("top", "both"):
        corruption["top"] = list(args.corruption_weights)
    if args.corrupt_codes in ("bottom", "both"):
        corruption["bottom"] = list(args.corruption_weights)
    return VQVAEConfig(
        in_channel=2,
        num_hidden_channels=args.num_hidden_channels,
        n_res_block=args.num_residual_blocks,
        num_residual_channels=args.num_residual_channels,
        embed_dim=args.embeddings_dimension,
        num_embeddings=args.num_embeddings,
        groups=args.groups,
        use_local_kernels=args.use_local_kernels,
        output_spectrogram_min_magnitude=(
            args.output_spectrogram_min_magnitude
            if args.output_spectrogram_threshold else None),
        resolution_factors=args.resolution_factors,
        embeddings_initial_variance=args.embeddings_initial_variance,
        corruption_weights=corruption,
        disable_quantization=args.disable_quantization,
        restarts_usage_threshold=args.restarts_usage_threshold,
        use_resnet=args.use_resnet,
        resnet_layers_per_downsampling_block=(
            args.resnet_layers_per_downsampling_block),
        resnet_expansion=args.resnet_expansion,
        use_pallas_lookup=args.pallas_vq,
    )


def reconstruction_figure(spec: torch.Tensor, dec: torch.Tensor,
                          hop_length: int, fs_hz: int,
                          path: pathlib.Path) -> None:
    """The (log-mel magnitude, IF) grid of the input spectrograms and
    their reconstructions, written to ``path`` (reference
    ``train_vqvae.py:373-427``); one log line instead when matplotlib is
    not installed."""
    from ..utils.visualization import (have_matplotlib,
                                       plot_mel_representations_batch,
                                       save_figure)
    if not have_matplotlib():
        print("reconstruction figure skipped: matplotlib is not installed")
        return
    spec, dec = spec.float().cpu().numpy(), dec.float().cpu().numpy()
    save_figure(plot_mel_representations_batch(
        np.concatenate([spec[:, 0], dec[:, 0]]),
        np.concatenate([spec[:, 1], dec[:, 1]]),
        hop_length=hop_length, fs_hz=fs_hz), path)


def _spectrogram(spectrograms_helper, input_transform, audio: torch.Tensor
                 ) -> torch.Tensor:
    with torch.no_grad():
        spec = spectrograms_helper.to_spectrogram(audio)
        return spec if input_transform is None else input_transform(spec)


def make_train_step(model: VQVAE, optimizer: Optimizer,
                    reconstruction_criterion, latent_loss_weight: float,
                    spectrograms_helper, bf16: bool = False,
                    input_transform=None, reconstruction_metrics=None,
                    mesh: Optional[Mesh] = None):
    """-> ``step(audio [B, L], generator=None) -> metrics`` (0-dim tensors
    on the device). With ``mesh`` (the model's codebooks on it through
    ``set_data_mesh``), ``audio`` is this rank's rows of the global batch
    and the gradients and metrics are averaged over the data group.

    One update: the spectrogram (then ``input_transform``, the masked-phase
    view of the input when ``--output_spectrogram_threshold`` is set, which
    is both the model's input and the criterion's target), a training
    forward (which updates the EMA codebooks in place; ``generator`` feeds
    the corruption and restart draws), ``loss = recon + latent_loss_weight
    * diff``, its backward and the optimizer step. With ``bf16`` the input
    and the float32 parameters are cast to bfloat16 and every layer
    computes in the dtype the JAX step gives it: bfloat16 where its input
    is bfloat16, float32 on the bfloat16-rounded parameters where a float32
    tensor reaches it (the normalizer's constants and the float32
    codebooks promote, so with ``--input_normalization`` the whole step
    runs in float32); the codebook buffers stay float32.
    ``reconstruction_metrics`` (see ``losses.make_reconstruction_metrics``)
    adds the metric trio, computed without gradient on the same
    reconstruction."""
    casts = ((lambda: bfloat16_parameters(model, promote=True))
             if bf16 else nullcontext)
    cfg = model.config
    data_group = optional_group(mesh, "data")

    def step(audio: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        spec = _spectrogram(spectrograms_helper, input_transform, audio)
        optimizer.zero_grad()
        with casts():
            spec_in = spec.to(torch.bfloat16) if bf16 else spec
            dec, diff, perp_t, perp_b, _, _ = model(spec_in, train=True,
                                                    generator=generator)
            recon = reconstruction_criterion(dec.float(), spec)
            diff = diff.float()
            loss = recon + latent_loss_weight * diff
            loss.backward()
        mean_of_gradients(model.parameters(), data_group)
        optimizer.step()
        metrics = {"vqvae_loss": loss, "reconstruction_loss": recon,
                   "latent_loss": diff, "perplexity_top": perp_t,
                   "perplexity_bottom": perp_b,
                   "perplexity_top_ratio": perp_t / cfg.n_embed_t,
                   "perplexity_bottom_ratio": perp_b / cfg.n_embed_b}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if reconstruction_metrics is not None:
            with torch.no_grad():
                metrics.update(reconstruction_metrics(dec.detach().float(),
                                                      spec))
        return mean_of_metrics(metrics, data_group)

    return step


def make_eval_step(model: VQVAE, reconstruction_criterion,
                   latent_loss_weight: float, spectrograms_helper,
                   input_transform=None, reconstruction_metrics=None,
                   mesh: Optional[Mesh] = None):
    """-> ``step(audio [B, L], weights [B]) -> (weighted metric sums,
    weight sum)``. Every metric is computed per sample (the perplexities
    from each sample's own codes) and weighted by the validity vector, so
    zero-padded remainder rows (weight 0) count for nothing and the
    caller's sums over all batches divided by the summed weights are exact
    per-sample means. With ``mesh`` the rows are this rank's and the sums
    are added over the data group."""
    data_group = optional_group(mesh, "data")

    @torch.no_grad()
    def step(audio: torch.Tensor, weights: torch.Tensor):
        spec = _spectrogram(spectrograms_helper, input_transform, audio)
        dec, diff, perp_t, perp_b, _, _ = model(spec, per_sample=True)
        recon = reconstruction_criterion(dec, spec, reduction="none")
        loss = recon + latent_loss_weight * diff
        metrics = {"vqvae_loss": loss, "reconstruction_loss": recon,
                   "latent_loss": diff,
                   "mse": mse_loss(dec, spec, reduction="none"),
                   "perplexity_top": perp_t, "perplexity_bottom": perp_b}
        if reconstruction_metrics is not None:
            metrics.update(reconstruction_metrics(dec, spec,
                                                  reduction="none"))
        return sum_of_eval({k: (v * weights).sum()
                            for k, v in metrics.items()}, weights.sum(),
                           data_group)

    return step


def dump_image_samples(directory, epoch: int, batch_index: int,
                       spec, dec, sample_size: int = 25) -> None:
    """Per-channel PNG grids: input row, reconstruction row, |diff| row
    (one file per channel named ``EEEEE_BBBBB_<channel>.png``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    directory.mkdir(parents=True, exist_ok=True)
    spec = spec[:sample_size].detach().float().cpu().numpy()
    dec = dec[:sample_size].detach().float().cpu().numpy()
    rows = [spec, dec, np.abs(spec - dec)]
    for ch, name in enumerate(["spectrogram", "instantaneous_frequency"]):
        fig, axes = plt.subplots(3, len(spec),
                                 figsize=(1.2 * len(spec), 3.6),
                                 squeeze=False)
        for r, row in enumerate(rows):
            for i in range(len(spec)):
                axes[r][i].imshow(row[i, ch], origin="lower",
                                  aspect="auto", cmap="viridis")
                axes[r][i].set_axis_off()
        fig.tight_layout()
        fig.savefig(directory
                    / f"{epoch + 1:05d}_{batch_index:05d}_{name}.png")
        plt.close(fig)


def compute_normalization_statistics(spectrograms_helper, loader,
                                     max_batches: int = 50,
                                     input_transform=None, device=None,
                                     mesh: Optional[Mesh] = None):
    """Channel ranges of the (masked, with ``input_transform``)
    spectrograms of the first ``max_batches`` batches of ``loader``; with
    ``mesh`` (``loader`` reading this rank's rows) the ranges of every
    rank's rows, the same on every rank."""

    def batches():
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            audio = batch[0] if isinstance(batch, tuple) else batch
            yield _spectrogram(spectrograms_helper, input_transform,
                               torch.as_tensor(audio).to(device))

    stats = DataNormalizer.compute_statistics(batches())
    group = optional_group(mesh, "data")
    if group is None:
        return stats
    # minima of (min, -max): one collective gives every range
    signed = torch.tensor([stats.min_logmag, -stats.max_logmag,
                           stats.min_IF, -stats.max_IF],
                          dtype=torch.float64, device=device)
    torch.distributed.all_reduce(signed, torch.distributed.ReduceOp.MIN,
                                 group=group)
    lo_mag, hi_mag, lo_if, hi_if = signed.tolist()
    return DataNormalizerStatistics(lo_mag, -hi_mag, lo_if, -hi_if)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> VQVAE:
    """Train a VQ-VAE; returns the trained model."""
    args = make_parser().parse_args(argv)
    if args.dataset != "nsynth" or args.dataset_type != "wav":
        raise NotImplementedError(
            "only the NSynth wav pipeline is implemented")
    initialize_multihost(device=args.device)
    mesh = trainer_mesh(args.num_devices_data, 1, args.batch_size)
    master = is_master_process()
    device = resolve_device(args.device)
    set_float32_precision()
    run_dir = pathlib.Path(args.runs_directory) / (
        datetime.now().strftime("%Y%m%d-%H%M%S") + "-vqvae")

    helper = get_spectrograms_helper(**vars(args))
    if (args.output_spectrogram_threshold
            and args.output_spectrogram_min_magnitude is None):
        # the flag alone stores the helper's safelog epsilon as threshold
        args.output_spectrogram_min_magnitude = helper.safelog_eps
    input_transform = (
        make_masked_phase_transform(args.output_spectrogram_min_magnitude)
        if args.output_spectrogram_threshold else None)

    def nsynth(json_path):
        return NSynth(args.dataset_audio_directory_paths, json_path,
                      valid_pitch_range=tuple(args.valid_pitch_range),
                      categorical_field_list=["pitch",
                                              "instrument_family_str"],
                      sample_rate=args.fs_hz,
                      duration_seconds=args.dataset_duration_seconds)

    dataset = nsynth(args.train_dataset_json_data_path)
    # each rank reads and decodes its rows of every global batch
    train_loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                               rows=mesh.rows(args.batch_size))
    valid_loader = None
    if args.validation_dataset_json_data_path:
        valid_loader = BatchLoader(
            nsynth(args.validation_dataset_json_data_path), args.batch_size,
            shuffle=False, drop_last=False)

    config = build_config(args)
    if args.precomputed_normalization_statistics:
        normalizer = DataNormalizer.load_statistics(
            args.precomputed_normalization_statistics)
        config = dataclasses.replace(
            config,
            normalizer_statistics=dataclasses.asdict(normalizer.statistics))
    elif args.input_normalization:
        stats = compute_normalization_statistics(
            helper, train_loader, input_transform=input_transform,
            device=device, mesh=mesh)
        config = dataclasses.replace(
            config, normalizer_statistics=dataclasses.asdict(stats))

    model = VQVAE(config)
    init_like_flax(model, torch.Generator().manual_seed(0))
    model.to(device)
    set_data_mesh(model, mesh)

    if len(train_loader) == 0:
        raise SystemExit(
            f"training dataset has {len(dataset)} examples, fewer than "
            f"--batch_size {args.batch_size}: no full batch to train on")
    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * args.num_training_epochs
    # --sched cycle also cycles Adam's b1 inversely to the learning rate
    optimizer = get_optimizer(model.parameters(), "adam", args.sched,
                              args.lr, total_steps,
                              clip_grad_norm=args.clip_grad_norm)

    criterion = get_reconstruction_criterion(
        args.reconstruction_criterion, helper,
        precision=args.spectral_precision)
    metrics_fn = make_reconstruction_metrics(helper)
    common = dict(optimizer=optimizer,
                  reconstruction_criterion=criterion,
                  latent_loss_weight=args.latent_loss_weight,
                  spectrograms_helper=helper, bf16=args.bf16,
                  input_transform=input_transform, mesh=mesh)
    train_step = make_train_step(model, **common)
    # the metric trio rides a second step, taken at log steps only
    train_step_logged = make_train_step(
        model, reconstruction_metrics=metrics_fn, **common)
    eval_step = make_eval_step(model, criterion, args.latent_loss_weight,
                               helper, input_transform=input_transform,
                               reconstruction_metrics=metrics_fn, mesh=mesh)

    writes = not (args.disable_writes_to_disk or args.dry_run)
    writer = MetricsWriter(run_dir / "tb", enabled=writes and master
                           and not args.disable_tensorboard)
    checkpointer = None
    start_epoch = 0
    if writes and master:
        checkpointer = Checkpointer(run_dir, args.save_frequency)
        checkpointer.store_command_line_parameters(vars(args))
        checkpointer.store_model_parameters(config.to_json())
    if args.resume_training_from:
        state, start_epoch = Checkpointer(args.resume_training_from).restore(
            map_location=device)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        start_epoch += 1
        if master:
            print(f"resumed from epoch {start_epoch - 1}")

    # the corruption and restart draws
    generator = torch.Generator(device=device).manual_seed(20200117)
    global_step = start_epoch * steps_per_epoch
    metrics: Dict[str, torch.Tensor] = {}
    watchdog = maybe_watchdog(args.watchdog_timeout_s)
    try:
        for epoch in range(start_epoch, args.num_training_epochs):
            train_loader.set_epoch(epoch)
            profiler = nullcontext()
            profiling = args.profile and epoch == start_epoch and writes \
                and master
            if profiling:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
            _synchronize(device)
            t0 = time.perf_counter()
            t_warm, steps = None, 0
            with profiler:
                for batch_index, batch in enumerate(train_loader):
                    audio = torch.as_tensor(
                        batch[0] if isinstance(batch, tuple) else batch
                    ).to(device, non_blocking=True)
                    is_log_step = (global_step
                                   % args.train_logs_frequency_batches == 0)
                    metrics = (train_step_logged if is_log_step
                               else train_step)(audio, generator)
                    steps += 1
                    if steps == 1:
                        # the steps after the first are the warm ones
                        _synchronize(device)
                        t_warm = time.perf_counter()
                    if watchdog is not None:
                        watchdog.pet()
                    if is_log_step:
                        writer.scalars("training", metrics, global_step)
                    if args.enable_image_dumps and writes and master \
                            and batch_index % 100 == 0:
                        with torch.no_grad():
                            spec = _spectrogram(helper, input_transform,
                                                audio)
                            dec = model(spec)[0]
                        dump_image_samples(run_dir / "samples", epoch,
                                           batch_index, spec, dec)
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
            writer.scalars("epoch", timing, global_step)
            msg = (f"epoch {epoch}: {t1 - t0:.1f}s "
                   f"loss={float(metrics['vqvae_loss']):.4f} "
                   f"perp_t={float(metrics['perplexity_top']):.1f} "
                   f"perp_b={float(metrics['perplexity_bottom']):.1f}")
            if "warm_step_ms" in timing:
                msg += f" warm step {timing['warm_step_ms']:.2f} ms"
            if master:
                print(msg, flush=True)

            if (writes and master and valid_loader is not None
                    and args.num_tensorboard_audio_samples > 0):
                # the first notes, read from the dataset: an iterator of
                # the loader left unfinished would leave its prefetch
                # thread blocked, holding batches, every epoch
                valid = valid_loader.dataset
                n = min(args.num_tensorboard_audio_samples, len(valid))
                audio = torch.as_tensor(np.stack(
                    [valid[i][0] for i in range(n)])).to(device)
                with torch.no_grad():
                    spec = _spectrogram(helper, input_transform, audio)
                    dec = model(spec)[0]
                    rec = helper.to_audio(dec.float())
                for i in range(len(audio)):
                    writer.audio(f"original/{i}", audio[i], global_step,
                                 args.fs_hz)
                    writer.audio(f"reconstruction/{i}", rec[i], global_step,
                                 args.fs_hz)
                reconstruction_figure(
                    spec, dec, args.hop_length, args.fs_hz,
                    writer.directory / "media"
                    / f"reconstructions-{global_step}.png")

            validation_loss = None
            if valid_loader is not None and (
                    epoch % args.validation_frequency == 0):
                val = run_eval(eval_step, valid_loader, args.batch_size,
                               device, args.dry_run, mesh)
                validation_loss = val["vqvae_loss"]
                writer.scalars("validation", val, global_step)
                if master:
                    print(f"  validation: loss={validation_loss:.4f}")

            if checkpointer is not None:
                checkpointer.save(epoch, {"model": model.state_dict(),
                                          "optimizer": optimizer.state_dict()},
                                  validation_loss)
                save_model(run_dir, model, prefix="vqvae")
            if args.dry_run:
                if master:
                    print("dry run complete")
                break
    finally:
        if watchdog is not None:
            watchdog.stop()
        writer.close()
    return model


def run_eval(eval_step, loader, batch_size: int, device,
             first_batch_only: bool = False,
             mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Exact per-sample means over ``loader``: the remainder batch is
    zero-padded to ``batch_size`` with weight-0 rows (``batch_size`` a
    multiple of the data ranks, so the padded batch splits over them, as
    ``mesh.pad_for_eval`` pads); with ``mesh`` each rank evaluates its
    rows."""
    sums: Dict[str, float] = {}
    count = 0.0
    for batch in loader:
        audio = np.asarray(batch[0] if isinstance(batch, tuple) else batch)
        weights = np.ones(batch_size, np.float32)
        if audio.shape[0] < batch_size:
            weights[audio.shape[0]:] = 0.0
            audio = np.concatenate([audio, np.zeros(
                (batch_size - audio.shape[0],) + audio.shape[1:],
                audio.dtype)])
        if mesh is not None:
            audio, weights = shard_batch(mesh, (audio, weights))
        m, c = eval_step(torch.as_tensor(audio).to(device),
                         torch.as_tensor(weights).to(device))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += float(c)
        if first_batch_only:
            break
    return {k: v / max(count, 1e-9) for k, v in sums.items()}


if __name__ == "__main__":
    main()
