#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX.
Phases, each failing the run with a nonzero exit:

1. print the card (``nvidia-smi`` name and power limit), build the kernels
   from ``interactive_spectrogram_inpainting_tpu_torch/ops/csrc``, and count
   the tensor-core instructions (HMMA, HGMMA) in the training attention's
   library with ``cuobjdump -sass`` (none fails the run);
2. prefix-prime: the kernel (one persistent launch a prefix, products on
   the tensor cores) against its plain PyTorch version at the full priors'
   width (top prior: relative-bias cross attention; bottom prior: aligned),
   in float32 and in bfloat16, a second call bit-identical to the first;
   its launch shape (grid, shared memory, registers, grid barriers);
3. decode-scan: the kernel (one cooperative launch in thread-block
   clusters) against its plain version at full width: teacher-forced (mask
   all False: the final caches agree, the bfloat16 rows' distance in bf16
   ulps is logged, the tokens are unchanged), greedy top prior in float32
   (the token streams are equal; the same from an unprimed cache from
   position 0, its cache rows from p0 on within 3e-4), and bfloat16 with
   Gumbel noise (tokens in range, unmasked unchanged, a second run
   bit-identical in tokens and cache, counted as grouped exactly where the
   launch takes heads side by side); its launch shape (grid, cluster,
   grid barriers a step, shared memory, registers, heads side by side);
4. vq-lookup: ``fused_vq_lookup`` against ``reference_vq_lookup`` at dim 64,
   K 512 and N in {128, 512, 700, 8192, 32768, 65536} (the upload's, an odd
   one, the VQ-VAE step's at batch 64 and the extraction batch's): ids
   equal on every row whose two best scores differ by more than 1e-4,
   quantize equal to the codebook rows bit for bit, counts exact,
   embed_sum within atol 1e-3 and rtol 1e-5 of a float64 product, and a
   second call bit-identical to the first; each N's launch shape (both
   kernels' grids, shared memory, registers, sort passes, grid barriers);
5. decode-step: ``fused_decode_step`` at batch 2 (bottom and top prior) and
   3 (top) and ``fused_decode_step_batched`` at batch 5, 16 and 64 (bottom
   prior) against their plain versions over 32 consecutive positions from
   a primed cache:
   teacher-forced caches in bfloat16 and float32, greedy float32 tokens
   equal; ``flash_decode_attention`` against ``reference_decode_attention``
   at batch 1, 2 and 16 with ``pos`` 0, 5, 128, 300 and 639, a second call
   bit-identical, its launch shape (grid, cluster, shared memory,
   registers); the bottom prior sampled fused with one pitch per batch row
   under one top codemap at B = 2 (``fused_decode_step``) and B = 16
   (``fused_decode_step_batched``), float32 and greedy: the tokens equal
   the dense sampler's;
6. server: the port's server with the full-width test models on the card
   (``use_pallas_lookup=True``: the encode runs the VQ lookup kernel),
   on localhost: three ``/timerange-change`` (``layer=top``, the last two
   of the four top columns masked, so both priors are primed), then three
   ``/get-audio`` (prefix-prime and decode-scan counters must grow); one
   ``/generate``, two ``/top-conditioned-sample`` of 10 pitches (batch
   bucket 16: the batched step kernel runs 515 steps per request) and two
   of 60 pitches (bucket 64), and a
   ``/generate`` from scratch as a server started with
   ``--use_predictive_sampling`` serves it (the predictive sampler); then
   ``sample_model`` at batch 2 on the bottom prior (half mask, primed) and
   on the top prior (the small-batch step kernel), and the dense sampler
   with ``top_p=0.9, use_flash=True`` at batch 2 (the flash attention
   kernel). Then the encode path: ``/analyze-audio`` with a 4 s and an 8 s
   harmonic note made from a seed (codemap shapes; codes equal to those of
   the same state with the lookup flag off), ``/erase`` on the returned
   codes, ``/get-spectrogram-image`` (a PNG of the expected size),
   ``/analyze-audio`` of the wav ``/get-audio`` returned; ``warmup`` and,
   after it, a ``/timerange-change`` with scan bounds no request has had
   beside a repeated one; the extraction of 256 four-second notes written
   to a temporary NSynth-shaped directory (``extract_split`` at batch 128,
   ``decode_back_sanity_check``) and ``/sample-from-dataset`` from the
   store it wrote. Every path is driven with its kernels' counters set to 0
   just before and read just after; the first request of each kind is cold
   (it builds the decode tables, plans the FFT and picks the convolution
   algorithms). Beside the three 8-head ``/timerange-change``, three
   (cold, warm, warm) of the same request served by priors at the
   reference's geometry (d_model 512, 16 heads, d_ff 2048, the serving
   state's depth): their latency is logged against the 100 ms limit, not
   held to it;
6b. wide geometries (``phase_wide``, before the server): each widened
   kernel against its plain version by the phases above, with their
   checks and tolerances: the prime, the scan and both step kernels (B 2,
   8 and 16) on the priors the server and the CLI serve at the
   reference's geometry (d_model 512, 16 heads, d_ff 2048) at full depth;
   on priors of two decoder layers, today's shape beside the scan at 24
   heads (d_model 768), the scan, the prime and the step kernels at
   head_dim 128 (d_model 1024, 8 heads, d_ff 4096: regions read from
   device memory), the prime at d_model 2048 (d_ff 8192) and the step
   kernels at d_ff 8192; the flash attention at head_dim 128 and the VQ
   lookup at dim 512. Each one's time beside the same kernel's at today's
   shape and the same depth;
6c. sampling CLI (``phase_cli``, after the server): seeded full-width
   checkpoints written with the port's writer (the serving VQ-VAE, the
   16-head priors), ``sampling.cli.main`` at batch 1 constrained by a
   harmonic note (lookup, prime, scan), at the default batch 8 conditioned
   on it (lookup, batched step kernel) and at batch 8 from scratch (both
   step kernels): the five output files, codes in range, a finite wav,
   each run's kernels launched, its wall time;
6d. reference checkpoint (``phase_reference_load``, after the server): the
   serving VQ-VAE's tensors under the reference's ``.pt`` names
   (``utils/torch_port.reference_names`` inverted) loaded by
   ``port_vqvae_state_dict`` into a fresh ``VQVAE`` with ``strict=True``;
   ``/analyze-audio`` of a 4 s note must give the serving model's codes
   bit for bit, through the VQ lookup kernel;
6e. load (``phase_load``): the same server over HTTP on localhost after a
   warmup with long sounds, driven by the port's ``serve/loadtest.py`` (the
   reference's locust mix: spectrogram image 3, audio 1, inpaint 1; 1-8 s
   think time) at 4 users, and at 32 users started over 8 s with a quarter
   of the inpaints 2x long: each for 60 s without the profiler, then 25 s
   under ``torch.profiler``; any failed request fails the run; the decode
   scan must launch once for each prior of every served inpaint and the
   prefix prime once for each prior whose mask's first masked column is
   past 0; logs each endpoint's requests, p50, p95 (where it served 20
   requests) and rps, the handler thread's busy share and the device's
   busy share (``nvidia-smi`` utilization samples in every window; in the
   traced ones also the union of ``torch.profiler``'s device intervals,
   used where the trace holds every scan launch the counter saw);
7. train-attention: the forward and backward kernels against their plain
   versions at the three attention shapes of the priors' training step
   (decoder self 516 x 516 causal, cross 516 x 129 aligned, encoder self
   129 x 129 anti-causal; B = 32, H = 8, Dh = 64), in float32 and
   bfloat16, a second backward bit-identical to the first (the kernels skip
   the tiles the masks leave empty);
8. spectral loss: the forward and backward kernels against their plain
   versions at the flagship shapes (every Jukebox and DDSP scale, B = 64
   rows of 65 536 samples, precision 'high' and 'default': value rtol 1e-5,
   the backward of one U atol 1e-5 x max, gradient atol 2e-3 x max), a
   second forward and backward bit-identical; every scale at 'high' takes
   the FFT route and at 'default' the DFT route; on the three Jukebox
   scales the FFT route's value (each row and the total) is no farther
   from the formula evaluated in float64 than the float32 DFT plain
   version's. DDSP's gradient at 'high' is not within 2e-3 x max and is
   logged, not held (see ``phase_spectral_loss``);
9. prior training: ``train_prior.main`` at the flagship width (d_model 512, 6 + 8
   layers, batch 32) on a store of 256 seeded random codemaps at the full
   geometry: one epoch of the top and of the bottom prior (aligned), whose
   step must launch 22 forward and 22 backward attention kernels; a few
   bottom steps with ``--bf16`` and with ``--remat``; a resume of one more
   epoch; one step with the kernels against one with the dense attention
   (dropout 0, the same batch: loss and gradients within atol 2e-4, rtol
   2e-3); 20 steps on one batch (the loss must fall); warm ms per step of
   both priors in float32 and bfloat16, and a ``torch.profiler`` split of
   three warm steps of each (device time by kernel family, the device's
   idle share); then the two trained priors, loaded from the files the
   trainer wrote, serve one ``/timerange-change``;
9b. store reads (``phase_store_reads``): a codemap store of NSynth train's
   289 205 records at the full geometry (seeded codes), one epoch of
   ``read_batch`` at batch 32 over a seeded permutation through the C++
   reader and through numpy's memmap (the batches of the two must be
   equal) and of the prior trainer's ``iterate_batches``, in both modes,
   and of ``BatchLoader`` with its prefetch thread (numpy's memmap record
   by record in either mode), timed;
10. VQ-VAE training: ``train_vqvae.main`` at the README's flagship flags
   (mel, input normalization, factors top 2 / bottom 16, batch 64, the
   trainer's width defaults, ``spectral_jukebox``, ``--pallas_vq``, the
   metric trio at every step) on 256 + 64 seeded 4 s harmonic notes
   written as an NSynth-shaped directory: one epoch whose spectral-loss
   launches must equal what its steps imply (12 forward and 3 backward a
   step, 12 forward an evaluation batch) and whose VQ lookups are counted;
   two ``--bf16`` steps, a resume, one ``mse`` epoch; one step with the
   kernels against one with the plain float32 loss (loss rtol 1e-5,
   gradients atol 5e-3 x max); 20 steps on one batch (the loss must fall);
   warm ms per step (mse and spectral_jukebox, float32 and bf16) and a
   ``torch.profiler`` split with the device's idle share; then the trained
   VQ-VAE with the two priors of phase 9, loaded by
   ``load_state_from_checkpoints``, serves ``/analyze-audio``,
   ``/timerange-change`` and ``/get-audio``;
10a. examples (``phase_examples``): ``examples.inference_analysis`` and
   ``examples.process_audio`` on the trained VQ-VAE (its parameters file
   with ``use_pallas_lookup`` set) and two seeded 4 s notes: every file
   written, the metrics finite, the VQ lookup and (for the analysis's DDSP
   and Jukebox metrics) the spectral-loss forward kernels launched, each
   driver's wall time;
10b. parallel (``phase_parallel``): NCCL at world size 1 in this process,
   through the port's ``initialize_multihost``: both trainers' ``main``
   for a few steps at the flagship width (the bottom prior, batch 32, in
   float32 and with ``--bf16``; the VQ-VAE at the flagship flags,
   batch 64, ``spectral_jukebox``, ``--pallas_vq``) with
   ``--num_devices_data 1`` (and ``--num_devices_model 1``), the steps'
   losses and the weights bit for bit those of the same runs with no
   process group (deterministic algorithms on for both), their kernels
   launched; the warm step time of each trainer's step with and without
   the group (the data-parallel machinery's cost on one card). The
   training attention at a model rank's heads (4 of 8 heads of 64, 8 of 16
   of 32) against its plain version, as in phase 7; the device time of a
   bottom step's dropout masks drawn for 16 rows and for the global 32 (a
   rank's draw at data 2). Then two processes share the card over gloo
   with CUDA tensors (NCCL refuses two ranks on one device): one step of
   the bottom prior at data 2, of the top prior at model 2 (4 of 8 heads a
   rank in the training attention) and of the VQ-VAE at data 2 (the
   spectral-loss and VQ-lookup kernels on each rank's 32 rows), each
   against the one-process step of the whole batch on the card (loss rtol
   1e-5; each leaf's gradient within ``PARALLEL_GRAD_RTOL`` of the run,
   as ``||g2 - g1|| / ||g1||``, the five farthest leaves logged with their
   gradient's rms; weights after the Adam step atol 5e-4 for the priors
   and 1e-4 for the VQ-VAE, or 2 lr where the gradient is within atol
   2e-4 / rtol 2e-3 of 0, codebooks atol and rtol 1e-5),
   and ``make_sharded_sampling_fn`` of the bottom prior at 2 and 16 rows,
   float32 and greedy, fused: each rank's tokens equal the one-process run
   of its shard, each rank launched the kernels of its shard's size;
11. a ``{"kernels": [...]}`` line: each kernel's main-path launches, its
   error against the plain version, its time and the plain version's time
   on the main path's shapes, its bound on this card and, where PyTorch
   has one, the library's time on the same inputs
   (``F.scaled_dot_product_attention`` for the flash attention and, forward
   and backward, for the training attention, in float32 and in bfloat16
   (``fused_train_attention_bf16``, the ``--bf16`` run's launches; float32
   is bound by its three TF32 passes at the TF32 rate); for the VQ lookup
   the dense path ``torch.matmul`` + ``argmin`` + ``F.embedding``, a
   composition of calls that gives ids and quantize only (its bound: three
   TF32 passes at the TF32 rate, as the kernel runs them; its detail gives
   each call's ms, the launch shapes and the device kernels a call); for
   the spectral loss
   ``torch.stft`` + magnitudes + distance, forward and backward by
   autograd, on the three Jukebox scales of the main path's first step;
   its row also gives each half's ms and bound). The flash attention's
   ``ms`` is device time: its calls are enqueued behind a sleeping kernel,
   so the card runs them back to back whatever the host's pace (the
   host-paced time and the host enqueue ms are in its detail, with its
   launch shape, device kernels a call and the dense sampler's wall time;
   its launches are the opt-in dense sampler's: no serving path runs it).
   The two step kernels' detail gives, for each plan the timed calls
   used, the grid, the grid barriers a step, the shared memory and the
   registers (also from
   ``-Xptxas -v``), the device kernels ``torch.profiler`` sees in 8 steps
   (one a step), host enqueue ms, and for the batched kernel one whole
   generation of each server batch bucket (16 and 64) with its bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zipfile

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "interactive_spectrogram_inpainting_tpu_torch"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_OPS = 989e12       # H100 SXM dense bf16 tensor-core rate
PEAK_F32_OPS = 67e12         # H100 SXM float32 outside the tensor cores
PEAK_TF32_OPS = 495e12       # H100 SXM dense TF32 tensor-core rate
KERNEL_SOURCES = {
    "fused_prefix_prime": (
        f"{PKG}/ops/csrc/prefix_prime.cu",
        "interactive_spectrogram_inpainting_tpu/ops/prefix_prime_kernel.py:279"),
    "fused_decode_scan": (
        f"{PKG}/ops/csrc/decode_scan.cu",
        "interactive_spectrogram_inpainting_tpu/ops/decode_scan_kernel.py:349"),
    "fused_decode_step": (
        f"{PKG}/ops/csrc/decode_step.cu",
        "interactive_spectrogram_inpainting_tpu/ops/decode_step_kernel.py:534"),
    "fused_decode_step_batched": (
        f"{PKG}/ops/csrc/decode_step_batched.cu",
        "interactive_spectrogram_inpainting_tpu/ops/decode_step_batched.py:351"),
    "flash_decode_attention": (
        f"{PKG}/ops/csrc/decode_attention.cu",
        "interactive_spectrogram_inpainting_tpu/ops/decode_attention.py:174"),
    "fused_vq_lookup": (
        f"{PKG}/ops/csrc/vq_lookup.cu",
        "interactive_spectrogram_inpainting_tpu/ops/vq_lookup.py:94"),
    "fused_train_attention": (
        f"{PKG}/ops/csrc/train_attention.cu",
        "interactive_spectrogram_inpainting_tpu/ops/train_attention.py:309"),
    "fused_train_attention_bf16": (
        f"{PKG}/ops/csrc/train_attention.cu",
        "interactive_spectrogram_inpainting_tpu/ops/train_attention.py:309"),
    "fused_multiscale_loss": (
        f"{PKG}/ops/csrc/spectral_loss.cu",
        "interactive_spectrogram_inpainting_tpu/ops/spectral_loss_kernel.py:264"),
}
STEP_LIBRARIES = ("decode_step", "decode_step_batched")
# libraries whose registers a thread -Xptxas -v reports, by kernel name
PTXAS_KERNELS = {"decode_step": "decode_step_kernel",
                 "decode_step_batched": "decode_step_kernel",
                 "decode_scan": "decode_scan_kernel",
                 "prefix_prime": "prefix_prime_kernel",
                 "decode_attention": "flash_decode_kernel",
                 "vq_lookup": "vq_assign_kernel"}
STEPS_CHECKED = 32   # consecutive positions a step kernel is checked over
STEPS_TIMED = 32     # captured steps (evenly spaced) a step kernel is timed on
VQ_MARGIN = 1e-4     # codes are compared where the two best scores differ more
EXTRACT_NOTES = 256  # notes the extraction phase encodes
NOTE_SECONDS = 4.0   # one note: the full model's four top columns
TRAIN_RECORDS = 256  # codemaps of the training phase's store
TRAIN_BATCH = 32     # the trainer's default batch
# attention calls of one training step of either prior: 6 encoder self,
# 8 decoder self and 8 cross attentions, each one forward and one backward
ATTENTION_CALLS = 22
# width flags of the training phase: none, the trainer's defaults are the
# flagship width (a rehearsal on the CPU narrows them)
TRAIN_MODEL_ARGS: list = []
# the VQ-VAE trainer at the README's flagship flags; its width defaults
# (hidden 128, residual 32, 2 residual blocks, codes 64 x 512) are the
# flagship width (a rehearsal on the CPU narrows them)
VQVAE_TRAIN_NOTES = 256
VQVAE_VALID_NOTES = 64
VQVAE_BATCH = 64
VQVAE_FLAGS = ["--use_mel_scale", "--input_normalization",
               "--resolution_factors", "top=2,bottom=16"]
VQVAE_MODEL_ARGS: list = []
SPECTRAL_BATCH = 64        # the flagship batch of 4 s notes
SPECTRAL_SAMPLES = 65536   # audio decoded from a [2, 1024, 128] spectrogram
SPECTRAL_DRAWS = 8         # audio draws of the float64 readings on DDSP
PARALLEL_STEPS = 3         # prior steps of each main run of phase_parallel
PARALLEL_TIMED = 6         # warm steps timed with and without the group
PARALLEL_TIMEOUT_S = 300   # the two gloo ranks of phase_parallel
# two ranks against one process: each leaf's gradient within this relative
# difference ||g2 - g1|| / ||g1|| of the one-process gradient (about 10x
# the largest leaf of sound runs on the H100: 7.2e-5, 4.2e-4, 3.4e-3;
# parallel_faults.py shows a dropped collective at 0.16-1.07)
PARALLEL_GRAD_RTOL = {"prior data 2": 7e-4, "prior model 2": 4e-3,
                      "vqvae data 2": 3e-2}
DEVICE = "cuda"
TEST_SIZE = "full"  # the test models' size (a rehearsal on the CPU: tiny)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def setup():
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"{PKG}/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    return torch


# -- shapes of one interaction ------------------------------------------------

def full_priors(torch, device):
    from interactive_spectrogram_inpainting_tpu_torch.serve.server import (
        make_test_state)
    return make_test_state("full", device=device, seed=0,
                           use_pallas_lookup=True)


def request_codes(state, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    top_shape = state.top.config.shape
    bottom_shape = state.bottom.config.shape
    top = rng.integers(0, state.top.config.n_class, top_shape)
    bottom = rng.integers(0, state.bottom.config.n_class, bottom_shape)
    mask = np.zeros(top_shape, bool)
    mask[:, top_shape[1] - 2:] = True  # the last two of the top columns
    return top, bottom, mask


def scan_inputs(torch, model, decode_state, codemap, condition, mask,
                scan_from, scan_until, dtype):
    """The kernels' inputs for one prior, as sample_model builds them.
    ``codemap`` [F, T] and ``condition`` give the one-sequence forms of the
    whole-scan kernel; with a leading batch dimension ([B, F, T]) they give
    the batched forms of the step kernels (tokens [B, L], memory
    [n_layers, B, E_pad, d], cache [n_layers, 2, B, l_pad, d])."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_kernel as tables)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        scan_range)
    import torch.nn.functional as F
    cfg = model.config
    dev = model.device
    c = cfg.target_num_channels
    helper = cfg.target_codemaps_helper()
    src_helper = cfg.source_codemaps_helper()
    batched = codemap.ndim == 3
    with torch.no_grad():
        codemap_t = torch.as_tensor(codemap, device=dev)
        cond_t = torch.as_tensor(condition, device=dev)
        if not batched:
            codemap_t, cond_t = codemap_t[None], cond_t[None]
        batch = codemap_t.shape[0]
        mask_t = torch.as_tensor(mask, device=dev)
        src_mask = (mask_t[None].expand(batch, -1, -1)
                    if cfg.self_conditional_model else None)
        src = model.prepare_sequence(
            src_helper.to_sequence(cond_t), "source",
            mask=None if src_mask is None else src_helper.to_sequence(
                src_mask))
        memory = model.encode_source(src)
        tokens = helper.to_sequence(codemap_t).to(torch.int32)
        mask_seq = helper.to_sequence(mask_t[None])[0].contiguous()
        params = decode_state["params"]
        posfull = tables.precompute_position_features(
            model, model._start_block("target", {}, batch),
            model._positional_sequence("target"), dtype=dtype)
        mem_k, mem_v = tables.precompute_mem_values(model, memory.to(dtype))
        e_src = mem_v.shape[2]
        e_pad = tables._round_up(e_src, 128)
        mem = (F.pad(mem_k, (0, 0, 0, e_pad - e_src)),
               F.pad(mem_v, (0, 0, 0, e_pad - e_src)))
        p0, steps = scan_range(model, scan_from, scan_until)
        with_start = torch.cat([torch.full((batch, c), cfg.n_class,
                                           device=dev, dtype=torch.long),
                                tokens.long()], dim=1)
        x_prefix = (params["emb_padded"][with_start[:, :p0]].float()
                    + posfull[:, :p0].float()).to(dtype)
        kv_shape = (cfg.conditional_model_num_decoder_layers, 2, batch,
                    decode_state["bias_hm"].shape[3], cfg.d_model)
        if not batched:
            mem = (mem[0][:, 0], mem[1][:, 0])
            tokens, x_prefix, posfull = tokens[0], x_prefix[0], posfull[0]
            kv_shape = kv_shape[:2] + kv_shape[3:]
    return dict(params=params, bias_hm=decode_state["bias_hm"],
                cross_hm=decode_state["cross_hm"], posfull=posfull, mem=mem,
                e_src=e_src, tokens=tokens, mask=mask_seq, p0=p0,
                steps=steps, x_prefix=x_prefix, c=c,
                n_class=cfg.n_class_target, kv_shape=kv_shape)


def run_prime(torch, fn, inp, dtype):
    kv = torch.zeros(inp["kv_shape"], dtype=dtype, device=inp["tokens"].device)
    return fn(inp["params"], inp["bias_hm"], inp["x_prefix"], inp["mem"],
              kv, p0=inp["p0"], channels=inp["c"], cross_hm=inp["cross_hm"],
              e_src_real=inp["e_src"])


def run_scan(torch, fn, inp, kv, mask, gumbel, temperature=1.0):
    return fn(inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"],
              None if kv is None else kv.clone(), inp["tokens"], mask,
              gumbel, temperature, p0=inp["p0"], steps=inp["steps"],
              n_class=inp["n_class"], channels=inp["c"],
              cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])


def run_steps(torch, fn, inp, kv, gumbel, temperature, n, mask=None):
    """``n`` positions from ``p0`` of the batch samplers' token loop
    through step function ``fn`` (a wrapper or a plain version), from a
    copy of the primed cache ``kv``. -> (tokens [B, L], cache)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        step_loop)
    kv = kv.clone()
    tokens_t = inp["tokens"].t().contiguous()
    mask = inp["mask"] if mask is None else mask
    common = dict(n_class=inp["n_class"], channels=inp["c"])
    if fn in (dsb.fused_decode_step_batched, dsb.decode_step_batched_plain):
        mem = inp["mem"][1]
    else:
        mem = inp["mem"]
        common.update(cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])

    def step(token_in, cur, p, i, is_masked, noise):
        fn(inp["params"], inp["bias_hm"], inp["posfull"], mem, kv, token_in,
           cur, p, i, is_masked, noise, temperature, out=cur, **common)

    with torch.no_grad():
        step_loop(step, tokens_t, mask.cpu().tolist(), gumbel, inp["p0"],
                  inp["p0"] + n, inp["c"], inp["n_class"])
    return tokens_t.t().contiguous(), kv


def batch_setup(torch, state, name, batch, dtype, seed=3):
    """Step-kernel inputs of prior ``name`` for ``batch`` different
    sequences under the server request's mask, in ``dtype``."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        precompute_decode_state)
    _, _, mask = request_codes(state)
    cfg_t, cfg_b = state.top.config, state.bottom.config
    rng = np.random.default_rng(seed)
    tops = rng.integers(0, cfg_t.n_class, (batch,) + tuple(cfg_t.shape))
    if name == "top":
        model, codemaps, m = state.top, tops, mask
    else:
        model = state.bottom
        codemaps = rng.integers(0, cfg_b.n_class,
                                (batch,) + tuple(cfg_b.shape))
        m = np.repeat(np.repeat(mask, cfg_b.shape[0] // cfg_t.shape[0], 0),
                      cfg_b.shape[1] // cfg_t.shape[1], 1)
    sf, su = state.mask_scan_bounds(name, m)
    ds = (state.decode_state(name) if dtype == torch.bfloat16
          else precompute_decode_state(model, compute_dtype=dtype))
    return scan_inputs(torch, model, ds, codemaps, tops, m, sf, su, dtype)


def prior_setups(torch, state, dtype):
    """(name, model, scan inputs) for the top and bottom prior at the
    server request's mask, in ``dtype``."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        precompute_decode_state)
    top, bottom, mask = request_codes(state)
    cfg_t, cfg_b = state.top.config, state.bottom.config
    mask_b = np.repeat(np.repeat(mask, cfg_b.shape[0] // cfg_t.shape[0], 0),
                       cfg_b.shape[1] // cfg_t.shape[1], 1)
    out = []
    for name, model, codemap, cond, m in (
            ("top", state.top, top, top, mask),
            ("bottom", state.bottom, bottom, top, mask_b)):
        sf, su = state.mask_scan_bounds(name, m)
        ds = (state.decode_state(name) if dtype == torch.bfloat16
              else precompute_decode_state(model, compute_dtype=dtype))
        out.append((name, model, scan_inputs(torch, model, ds, codemap, cond,
                                             m, sf, su, dtype)))
    return out


# -- phases -------------------------------------------------------------------

def phase_build():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    if out.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    log(card)
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    t0 = time.perf_counter()
    seconds = build.build(ptxas=PTXAS_KERNELS)
    log(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}"
        f" total {time.perf_counter() - t0:.2f} s")
    log("persistent kernels' registers a thread (-Xptxas -v): "
        + json.dumps({name: ptxas_registers(build.PTXAS_LOGS.get(name, ""),
                                            kernel)
                      for name, kernel in PTXAS_KERNELS.items()}))
    # the training attention runs its products on the tensor cores: its
    # library must hold HMMA (mma.sync) or HGMMA (wgmma) instructions
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
         "-sass", str(build._library_path("train_attention"))],
        capture_output=True, text=True)
    counts = {op: len(re.findall(rf"\b{op}\b", sass.stdout))
              for op in ("HMMA", "HGMMA")}
    log(f"train_attention tensor-core instructions (cuobjdump -sass): "
        f"{json.dumps(counts)}")
    if sass.returncode != 0 or not sum(counts.values()):
        fail("the train_attention library holds no HMMA/HGMMA instruction "
             f"(cuobjdump: {sass.stderr.strip()[:200]})")
    return card


def ptxas_registers(log_text, kernel="decode_step_kernel"):
    """{dtype: registers} of ``kernel``'s instantiations in a ``-Xptxas -v``
    report; an instantiation with bool template arguments after the dtype
    (the wide or general kernel beside the full models' one) is keyed
    ``dtype`` and those flags, as ``float32 01``."""
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and kernel in entry:
            key = "bfloat16" if "bfloat16" in entry else "float32"
            flags = "".join(re.findall(r"Lb([01])E", entry))
            out[key + (f" {flags}" if flags else "")] = int(m.group(1))
            entry = None
    return out


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_prime(torch, state, results=None, tag="", check=True):
    """The prefix prime against its plain version on both priors of
    ``state``, in float32 and bfloat16, a second call bit-identical, its
    launch shape (without ``check``: bfloat16, the time only). ``tag``
    heads the log lines; ``results``, when given, takes the bfloat16
    errors. -> ms of the bottom prior's bfloat16 prime."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime, prefix_prime_plain
    # float32: the algorithm, at the JAX package's decode-step tolerance;
    # bfloat16: the serving dtype, where the two versions round the same
    # values at the same places but sum in other orders
    tol = {torch.float32: (3e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
    ms = None
    for dtype in (torch.float32, torch.bfloat16) if check else (
            torch.bfloat16,):
        for name, model, inp in prior_setups(torch, state, dtype):
            label = f"prefix_prime {tag}{name} {str(dtype)[6:]}"
            if check:
                kv_k = run_prime(torch, fused_prefix_prime, inp, dtype)
                kv_p = run_prime(torch, prefix_prime_plain, inp, dtype)
                torch.cuda.synchronize()
                p0 = inp["p0"]
                p_pad = min(((p0 + 127) // 128) * 128, inp["kv_shape"][2])
                err = max_err(kv_k[:, :, :p0], kv_p[:, :, :p0])
                atol, rtol = tol[dtype]
                ok = torch.allclose(kv_k[:, :, :p0].float(),
                                    kv_p[:, :, :p0].float(), atol=atol,
                                    rtol=rtol)
                zero = bool((kv_k[:, :, p0:p_pad] == 0).all())
                log(f"{label} p0={p0}: max_abs_err {err:.3e} (atol {atol}, "
                    f"rtol {rtol}) rows[p0,P_pad) zero {zero}")
                if not (ok and zero and torch.isfinite(kv_k.float()).all()):
                    fail(f"{label} disagrees with the plain version")
                again = run_prime(torch, fused_prefix_prime, inp, dtype)
                torch.cuda.synchronize()
                if not torch.equal(kv_k, again):
                    fail(f"{label}: a second call differs")
                log(f"{label} launch: " + json.dumps(prime_info(inp, dtype)))
                if dtype == torch.bfloat16 and results is not None:
                    results.setdefault("fused_prefix_prime", []).append(err)
            if dtype == torch.bfloat16 and name == "bottom":
                ms = time_calls(torch, lambda: run_prime(
                    torch, fused_prefix_prime, inp, dtype), [((), {})], 5)
    return ms

def prime_info(inp, dtype):
    """The launch shape of the prefix-prime kernel for ``inp``."""
    import torch
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import prefix_prime_info
    kv = torch.zeros(inp["kv_shape"], dtype=dtype, device="cuda")
    return prefix_prime_info(
        inp["params"], inp["bias_hm"], inp["x_prefix"], inp["mem"], kv,
        p0=inp["p0"], channels=inp["c"], cross_hm=inp["cross_hm"],
        e_src_real=inp["e_src"])


def scan_info(inp, kv, gumbel):
    """The launch shape of the whole-scan kernel for ``inp``."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
        import decode_scan_info
    return decode_scan_info(
        inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"], kv,
        inp["tokens"], inp["mask"], gumbel, 1.0, p0=inp["p0"],
        steps=inp["steps"], n_class=inp["n_class"], channels=inp["c"],
        cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])


def bf16_ulps(torch, a, b):
    """The distance between a and b in units of the last place, in
    bfloat16, of the larger of the two (2^(exponent - 7)): its largest
    value and the share of elements farther apart than one unit."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(ulps.max()), float((ulps > 1).float().mean())


def phase_scan(torch, state, results=None, tag="", check=True):
    """The whole-scan kernel against its plain version on both priors of
    ``state``: bfloat16 teacher-forced (the caches agree), bfloat16 with
    noise (in range, a second run bit-identical), float32 greedy (the token
    streams are equal; the top prior's also from an unprimed cache). Without
    ``check`` only the time. ``tag`` heads the log lines; ``results``, when
    given, takes the teacher-forced errors. -> ms of the two priors'
    bfloat16 sampled scans, summed (one request's)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
        import decode_scan_plain, fused_decode_scan
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        gumbel_noise)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = 0.0
    for dtype in (torch.bfloat16, torch.float32) if check else (
            torch.bfloat16,):
        for name, model, inp in prior_setups(torch, state, dtype):
            dev = inp["tokens"].device
            kv0 = run_prime(torch, fused_prefix_prime, inp, dtype)
            n = inp["steps"] - inp["p0"]
            noise = gumbel_noise((n, inp["n_class"]), dev, gen)
            tag_ = f"{tag}{name} {str(dtype)[6:]} steps [{inp['p0']}, " \
                   f"{inp['steps']})"
            if dtype == torch.bfloat16:
                ms += time_calls(torch, lambda: run_scan(
                    torch, fused_decode_scan, inp, kv0, inp["mask"], noise),
                    [((), {})], 3)
            if not check:
                continue
            if dtype == torch.bfloat16:
                # teacher-forced: nothing masked, the caches must agree
                none = torch.zeros_like(inp["mask"])
                tk, kvk = run_scan(torch, fused_decode_scan, inp, kv0, none,
                                   noise)
                tp, kvp = run_scan(torch, decode_scan_plain, inp, kv0, none,
                                   noise)
                torch.cuda.synchronize()
                rows = slice(inp["p0"], inp["steps"])
                err = max_err(kvk[:, :, rows], kvp[:, :, rows])
                ok = torch.allclose(kvk.float(), kvp.float(), atol=5e-2,
                                    rtol=5e-2)
                same = bool((tk == inp["tokens"]).all()
                            and (tp == inp["tokens"]).all())
                ulps, beyond = bf16_ulps(torch, kvk[:, :, rows],
                                         kvp[:, :, rows])
                log(f"decode_scan {tag_} teacher-forced: cache max_abs_err "
                    f"{err:.3e} (atol 5e-2, rtol 5e-2), bf16 ulps at most "
                    f"{ulps:g}, {beyond:.2e} of the values more than one "
                    f"apart, tokens unchanged {same}")
                info = scan_info(inp, kv0, noise)
                log(f"decode_scan {tag}{name} {str(dtype)[6:]} launch: "
                    + json.dumps(info))
                if not (ok and same):
                    fail(f"decode_scan {tag}{name} teacher-forced disagrees")
                if results is not None:
                    results.setdefault("fused_decode_scan", []).append(err)
                # bf16 with noise: in range, unmasked cells unchanged
                grouped = fused_decode_scan.grouped_launches
                tk, kv1 = run_scan(torch, fused_decode_scan, inp, kv0,
                                   inp["mask"], noise)
                tk2, kv2 = run_scan(torch, fused_decode_scan, inp, kv0,
                                    inp["mask"], noise)
                torch.cuda.synchronize()
                if not (torch.equal(tk, tk2) and torch.equal(kv1, kv2)):
                    fail(f"decode_scan {tag}{name} bf16: a second run "
                         "differs")
                side = info["heads_side_by_side"] > 1
                if fused_decode_scan.grouped_launches - grouped != 2 * side:
                    fail(f"decode_scan {tag}{name} bf16: the grouped "
                         "launches do not follow heads_side_by_side")
                keep = ~inp["mask"]
                in_range = bool(((tk >= 0) & (tk < inp["n_class"])).all())
                kept = bool((tk[keep] == inp["tokens"][keep]).all())
                changed = int((tk != inp["tokens"]).sum())
                log(f"decode_scan {tag_} sampled: in range {in_range}, "
                    f"unmasked unchanged {kept}, {changed} cells changed")
                if not (in_range and kept and changed > 0):
                    fail(f"decode_scan {tag}{name} bf16 sampling is wrong")
                continue
            # greedy float32: the token streams must be equal
            zeros = torch.zeros_like(noise)
            tk, _ = run_scan(torch, fused_decode_scan, inp, kv0,
                             inp["mask"], zeros)
            tp, _ = run_scan(torch, decode_scan_plain, inp, kv0,
                             inp["mask"], zeros)
            torch.cuda.synchronize()
            diff = int((tk != tp).sum())
            log(f"decode_scan {tag_} greedy: {diff} tokens differ")
            if diff:
                fail(f"decode_scan {tag}{name} greedy float32 token streams "
                     "differ")
            if name != "top":
                continue
            # unprimed, from position 0 (the known prefix teacher-forced):
            # the same tokens, the same cache from p0 on
            zeros0 = torch.zeros(inp["steps"], inp["n_class"], device=dev)
            t0, kv_0 = fused_decode_scan(
                inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"],
                None, inp["tokens"], inp["mask"], zeros0, 1.0, p0=0,
                steps=inp["steps"], n_class=inp["n_class"], channels=inp["c"],
                cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])
            _, kv_p = run_scan(torch, fused_decode_scan, inp, kv0,
                               inp["mask"], zeros)
            torch.cuda.synchronize()
            p0 = inp["p0"]
            close = torch.allclose(kv_0.float(), kv_p.float(), atol=3e-4,
                                   rtol=1e-3)
            log(f"decode_scan {tag_} unprimed from 0: tokens equal "
                f"{torch.equal(t0, tk)}, cache max_abs_err "
                f"{max_err(kv_0, kv_p):.3e} (rows < p0 {p0} from the prime)")
            if not (torch.equal(t0, tk) and close):
                fail(f"decode_scan {tag}{name} unprimed and primed runs "
                     "differ")
    return ms

# (kernel, prior, batch) of the step phases. Today's: B 5 is one partial
# group of the batched kernel, B 64 the server's second bucket (four
# groups), top B 3 cross attention in a padded group. The widened
# geometries': B 2 on both priors, the batched kernel at B 16. The
# reference geometry's: those and the sampling CLI's default B 8.
STEP_CASES = (("fused_decode_step", "bottom", 2),
              ("fused_decode_step", "top", 2), ("fused_decode_step", "top", 3),
              ("fused_decode_step_batched", "bottom", 5),
              ("fused_decode_step_batched", "bottom", 16),
              ("fused_decode_step_batched", "bottom", 64))
WIDE_STEP_CASES = (("fused_decode_step", "bottom", 2),
                   ("fused_decode_step", "top", 2),
                   ("fused_decode_step_batched", "bottom", 16))
REF_STEP_CASES = WIDE_STEP_CASES + (("fused_decode_step", "top", 8),
                                    ("fused_decode_step_batched", "bottom", 8))


def phase_step(torch, state, results=None, tag="", cases=STEP_CASES,
               check=True):
    """The two step kernels against their plain versions, over
    STEPS_CHECKED consecutive positions from a primed cache, at each of
    ``cases``: teacher-forced caches in bfloat16 and float32, greedy
    float32 tokens equal (without ``check``: only the time). ``tag`` heads
    the log lines; ``results``, when given, takes the bfloat16 errors. ->
    {"kernel B=b": ms a step} of the bottom prior's bfloat16 cases."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    tol = {torch.float32: (3e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
    n = STEPS_CHECKED
    fns = {"fused_decode_step": (dsk.fused_decode_step,
                                 dsk.decode_step_plain),
           "fused_decode_step_batched": (dsb.fused_decode_step_batched,
                                         dsb.decode_step_batched_plain)}
    ms = {}
    for kernel, prior, batch in cases:
        fn, plain = fns[kernel]
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and prior == "bottom"
            if not (check or timed):
                continue
            inp = batch_setup(torch, state, prior, batch, dtype)
            dev = inp["tokens"].device
            kv0 = run_prime(torch, fused_prefix_prime, inp, dtype)
            rows = slice(inp["p0"], inp["p0"] + n)
            label = (f"{kernel} {tag}{prior} B={batch} {str(dtype)[6:]} "
                     f"steps [{rows.start}, {rows.stop})")
            zeros = torch.zeros(n, batch, inp["n_class"], device=dev)
            if timed:
                ms[f"{kernel} B={batch}"] = time_calls(
                    torch, lambda: run_steps(torch, fn, inp, kv0, zeros, 1.0,
                                             n), [((), {})], 2) / n
                mem = inp["mem"] if fn is dsk.fused_decode_step \
                    else inp["mem"][1]
                log(f"{label} plans: " + json.dumps(step_plans(kernel, [(
                    (inp["params"], inp["bias_hm"], inp["posfull"], mem,
                     kv0.clone(), None, None, 0, 0, True, None, 1.0),
                    dict(n_class=inp["n_class"], channels=inp["c"],
                         cross_hm=(inp["cross_hm"]
                                   if fn is dsk.fused_decode_step else None),
                         e_src_real=inp["e_src"]))])))
            if not check:
                continue
            # teacher-forced: nothing masked, the new cache rows must agree
            none = torch.zeros_like(inp["mask"])
            tk, kvk = run_steps(torch, fn, inp, kv0, zeros, 1.0, n, none)
            tp, kvp = run_steps(torch, plain, inp, kv0, zeros, 1.0, n, none)
            torch.cuda.synchronize()
            err = max_err(kvk[:, :, :, rows], kvp[:, :, :, rows])
            atol, rtol = tol[dtype]
            ok = torch.allclose(kvk.float(), kvp.float(), atol=atol,
                                rtol=rtol)
            same = bool((tk == inp["tokens"]).all()
                        and (tp == inp["tokens"]).all())
            log(f"{label} teacher-forced: cache max_abs_err {err:.3e} (atol "
                f"{atol}, rtol {rtol}), tokens unchanged {same}")
            if not (ok and same and torch.isfinite(kvk.float()).all()):
                fail(f"{label}: teacher-forced run disagrees with the plain "
                     "version")
            if dtype == torch.bfloat16:
                if results is not None:
                    results.setdefault(kernel, []).append(err)
                continue
            # greedy float32: the token streams must be equal
            every = torch.ones_like(inp["mask"])
            tk, _ = run_steps(torch, fn, inp, kv0, zeros, 1.0, n, every)
            tp, _ = run_steps(torch, plain, inp, kv0, zeros, 1.0, n, every)
            torch.cuda.synchronize()
            diff = int((tk != tp).sum())
            changed = int((tk != inp["tokens"]).sum())
            log(f"{label} greedy: {diff} tokens differ, {changed} cells "
                "changed")
            if diff or not changed:
                fail(f"{label}: greedy token streams differ")
    return ms


# the widened geometries beside today's: (label, d_model, heads, d_ff,
# kernels checked), on priors of WIDE_LAYERS decoder layers over one
# encoder layer (depth cut, widths kept); the reference's 16 heads are
# checked at full depth (``ref``)
WIDE_GEOMETRIES = (
    ("today", 512, 8, 2048, ("scan", "prime", "step")),
    ("24 heads", 768, 24, 3072, ("scan",)),
    ("head_dim 128", 1024, 8, 4096, ("scan", "prime", "step")),
    ("d_model 2048", 2048, 16, 8192, ("prime",)),
    ("d_ff 8192", 512, 8, 8192, ("step",)),
)
WIDE_LAYERS = 2
WIDE_FLASH_DH = 128
WIDE_VQ_DIM = 512


def prior_state(torch, d_model, heads, d_ff, layers=None, base=None,
                seed=0, size="full"):
    """A ServerState on the card whose priors have the full test models'
    shapes with ``d_model``, ``heads`` and ``d_ff`` (and ``layers`` decoder
    layers over one encoder layer, when given), weights drawn from
    ``seed``; the VQ-VAE, helper and label encoders of ``base`` when
    given."""
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        SelfAttentiveVQTransformer, UpsamplingVQTransformer)
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae \
        import VQVAE
    from interactive_spectrogram_inpainting_tpu_torch.serve.server import (
        ServerState, make_test_configs)
    from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram \
        import get_spectrograms_helper
    from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
        init_like_flax)
    spec_kwargs, vq_cfg, top_cfg, bottom_cfg = make_test_configs(
        size, use_pallas_lookup=True)
    kw = dict(d_model=d_model, conditional_model_nhead=heads, d_ff=d_ff)
    if layers is not None:
        kw.update(conditional_model_num_decoder_layers=layers,
                  conditional_model_num_encoder_layers=1)
    gen = torch.Generator().manual_seed(seed)
    top = init_like_flax(SelfAttentiveVQTransformer(
        dataclasses.replace(top_cfg, **kw)), gen)
    bottom = init_like_flax(UpsamplingVQTransformer(
        dataclasses.replace(bottom_cfg, **kw)), gen)
    if base is None:
        return ServerState(init_like_flax(VQVAE(vq_cfg), gen), top, bottom,
                           get_spectrograms_helper(**spec_kwargs), {},
                           max_sound_duration_s=8.0, device=DEVICE,
                           seed=seed)
    return ServerState(base.vqvae, top, bottom, base.helper,
                       base.label_encoders, fs_hz=base.fs_hz,
                       max_sound_duration_s=base.max_sound_duration_s,
                       device=DEVICE, seed=seed)


def phase_wide(torch, ref, today):
    """Each widened kernel against its plain version, by the phases above
    and with their tolerances: the scan, the prime and both step kernels
    on ``ref`` (the reference's geometry at the serving state's depth, the
    CLI's and the server's B 1, 2, 8 and 16); at WIDE_LAYERS decoder layers
    the kernels of each of WIDE_GEOMETRIES (today's shape among them); the
    flash attention at head_dim 128 and the VQ lookup at dim 512. Each
    one's bfloat16 time beside the same kernel's at today's shape and the
    same depth (``today``: the full-depth times of the earlier phases)."""
    t0 = time.perf_counter()
    full = {"prime": phase_prime(torch, ref, tag="16 heads "),
            "scan": phase_scan(torch, ref, tag="16 heads "),
            "step": phase_step(torch, ref, tag="16 heads ",
                               cases=REF_STEP_CASES)}
    log(f"phase_wide: the 16-head priors at full depth checked in "
        f"{time.perf_counter() - t0:.1f} s")
    cut = {}
    for label, d_model, heads, d_ff, kernels in WIDE_GEOMETRIES:
        wide = prior_state(torch, d_model, heads, d_ff, layers=WIDE_LAYERS,
                           seed=5)
        tag = f"{label} (d_model {d_model}, {heads} heads, d_ff {d_ff}) "
        if "prime" in kernels:
            cut[f"prime {label}"] = phase_prime(torch, wide, tag=tag)
        if "scan" in kernels:
            cut[f"scan {label}"] = phase_scan(torch, wide, tag=tag)
        if "step" in kernels:
            cut[f"step {label}"] = phase_step(torch, wide, tag=tag,
                                              cases=WIDE_STEP_CASES)
        del wide
        torch.cuda.empty_cache()
    log("wide timings, ms (bfloat16; the scan: a request's two sampled "
        "scans; the prime: the bottom prior's; the steps: a step; the flash "
        "attention: a call at B 2; the VQ lookup: a call at N 8192): "
        + json.dumps({
            "full depth": {
                "today": {k: today[k] for k in ("prime", "scan", "step")},
                "16 heads": full},
            f"{WIDE_LAYERS} decoder layers": cut,
            "flash": {"head_dim 64": today["flash"],
                      f"head_dim {WIDE_FLASH_DH}": phase_flash(
                          torch, head_dim=WIDE_FLASH_DH, batches=(2,))},
            "vq": {"dim 64": today["vq"],
                   f"dim {WIDE_VQ_DIM}": phase_vq(torch, dim=WIDE_VQ_DIM,
                                                  rows=(8192,))}}))
    log(f"phase_wide took {time.perf_counter() - t0:.1f} s")


def phase_cli(torch, state, ref, workdir):
    """The sampling CLI on the card. Seeded full-width checkpoints written
    with the port's writer (the serving state's VQ-VAE; ``ref``'s priors:
    the reference geometry, d_model 512, 16 heads, d_ff 2048, the serving
    state's layer counts), then ``sampling.cli.main`` three times: batch 1
    constrained by a harmonic note (its first two top columns kept: the
    VQ lookup, then the prime and the scan of the top prior, the scan of
    the bottom), the default batch 8 conditioned on the note (the lookup,
    then the batched step kernel) and the default batch 8 from scratch
    (``fused_decode_step`` on the top prior, the batched kernel on the
    bottom). Each run's output files must exist, its codes lie in range
    and its wav be finite; each run's kernels' counters are set to 0 just
    before it and read just after. -> {run: launches}."""
    import pathlib
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        read_wav, write_wav)
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsc, decode_step_batched as dsb,
        decode_step_kernel as dsk, prefix_prime_kernel as ppk,
        vq_lookup as vql)
    from interactive_spectrogram_inpainting_tpu_torch.sampling import cli
    from interactive_spectrogram_inpainting_tpu_torch.serve.server import (
        make_test_configs)
    from interactive_spectrogram_inpainting_tpu_torch.utils.checkpoint_io \
        import save_model
    d = pathlib.Path(workdir) / "cli"
    t0 = time.perf_counter()
    save_model(d, state.vqvae, "vqvae")
    save_model(d, ref.top, "top")
    save_model(d, ref.bottom, "bottom")
    (d / "vqvae-training_parameters.json").write_text(
        json.dumps(make_test_configs(TEST_SIZE)[0]))
    (d / "label_encoders.json").write_text(json.dumps(
        {k: list(v.classes_) for k, v in state.label_encoders.items()}))
    write_wav(d / "note.wav", harmonic_note(4, NOTE_SECONDS, state.fs_hz),
              state.fs_hz)
    log(f"cli checkpoints written in {time.perf_counter() - t0:.1f} s")
    common = [
        "--vqvae_training_parameters_path",
        str(d / "vqvae-training_parameters.json"),
        "--vqvae_model_parameters_path", str(d / "vqvae-model_parameters.json"),
        "--vqvae_weights_path", str(d / "vqvae-weights.msgpack"),
        "--prediction_top_parameters_path", str(d / "top-model_parameters.json"),
        "--prediction_top_weights_path", str(d / "top-weights.msgpack"),
        "--prediction_bottom_parameters_path",
        str(d / "bottom-model_parameters.json"),
        "--prediction_bottom_weights_path", str(d / "bottom-weights.msgpack"),
        "--label_encoders_path", str(d / "label_encoders.json"),
        "--class_conditioning", "pitch,60", "instrument_family_str,keyboard",
        "--seed", "0"]
    runs = {
        "B1 constrained": (["--batch_size", "1",
                            "--constraint_top_audio_path", str(d / "note.wav"),
                            "--constraint_top_num_timesteps", "3"],
                           ("fused_vq_lookup", "fused_prefix_prime",
                            "fused_decode_scan")),
        "B8 conditioned": (["--condition_top_audio_path", str(d / "note.wav")],
                           ("fused_vq_lookup", "fused_decode_step_batched")),
        "B8": ([], ("fused_decode_step", "fused_decode_step_batched")),
    }
    counters = {"fused_vq_lookup": vql.fused_vq_lookup,
                "fused_prefix_prime": ppk.fused_prefix_prime,
                "fused_decode_scan": dsc.fused_decode_scan,
                "fused_decode_step": dsk.fused_decode_step,
                "fused_decode_step_batched": dsb.fused_decode_step_batched}
    codes = []
    wrapped = cli.sample_model

    def recording(model, *args, **kwargs):
        out = wrapped(model, *args, **kwargs)
        codes.append((model.config, out))
        return out

    cli.sample_model = recording
    launches = {}
    try:
        for run, (extra, needed) in runs.items():
            out = d / run.replace(" ", "_")
            codes.clear()
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = cli.main(common + extra + ["--output_directory", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in counters.items()}
            launches[run] = counts
            run_id = pathlib.Path(wav).stem
            names = sorted(p.name for p in out.iterdir())
            expected = sorted(f"{run_id}{s}" for s in (
                ".wav", "-codemaps.png", "-spectrogram.png",
                "-instantaneous_frequency.png",
                "-command_line_parameters.json"))
            audio, sr = read_wav(wav)
            batch = 1 if run.startswith("B1") else 8
            in_range = all(
                int(c.min()) >= 0 and int(c.max()) < cfg.n_class
                and c.shape[0] == batch for cfg, c in codes)
            log(f"cli {run}: {wall:.2f} s wall, files {names == expected}, "
                f"{len(codes)} sample_model calls with codes in range "
                f"{in_range}, wav {audio.shape[-1]} samples at {sr} Hz "
                f"finite {bool(np.isfinite(audio).all())}, launches "
                f"{json.dumps(counts)}")
            if names != expected:
                fail(f"cli {run} wrote {names}, expected {expected}")
            if not (codes and in_range and np.isfinite(audio).all()
                    and audio.shape[-1] > 0):
                fail(f"cli {run}: codes out of range or a bad wav")
            if min(counts[k] for k in needed) <= 0:
                fail(f"cli {run}: a kernel of its path was not launched: "
                     f"{counts}")
    finally:
        cli.sample_model = wrapped
    return launches


def phase_per_row_labels(torch, state):
    """Fused sampling with one pitch per batch row, the bottom prior at full
    width under one top codemap (as ``/top-conditioned-sample`` samples
    it): at B = 2 (``fused_decode_step``) and B = 16
    (``fused_decode_step_batched``), float32 and greedy, the fused tokens
    must equal the dense sampler's, each row decoded from its own start
    rows."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        precompute_decode_state, sample_model, scan_range)
    model = state.bottom
    cfg_t, cfg_b = state.top.config, model.config
    rng = np.random.default_rng(6)
    decode_state = precompute_decode_state(model, torch.float32)
    p0, steps = scan_range(model, None, None)
    for batch, kernel in ((2, dsk.fused_decode_step),
                          (16, dsb.fused_decode_step_batched)):
        tops = np.repeat(rng.integers(0, cfg_t.n_class,
                                      (1,) + tuple(cfg_t.shape)), batch, 0)
        pitches = list(range(60, 60 + batch))
        cc = {"pitch": state.label_encoders["pitch"].transform(pitches),
              "instrument_family_str": state.label_encoders[
                  "instrument_family_str"].transform(["keyboard"] * batch)}
        zeros = torch.zeros(steps - p0, batch, cfg_b.n_class, device=DEVICE)
        before = kernel.launches
        t0 = time.perf_counter()
        fused = sample_model(model, None, batch, condition=tops,
                             class_conditioning=cc, gumbel=zeros,
                             decode_state=decode_state).cpu().numpy()
        fused_s = time.perf_counter() - t0
        launched = kernel.launches - before
        dense = sample_model(model, None, batch, condition=tops,
                             class_conditioning=cc, gumbel=zeros,
                             use_fused_step=False).cpu().numpy()
        diff = int((fused != dense).sum())
        distinct = len({row.tobytes() for row in fused})
        log(f"per-row pitches {pitches[0]}..{pitches[-1]}, bottom prior B="
            f"{batch} float32 greedy: {kernel.__name__} x {launched} "
            f"({fused_s:.2f} s), {diff} of {fused.size} tokens differ from "
            f"the dense sampler, {distinct} distinct rows")
        if diff or launched != steps - p0 or distinct < 2:
            fail(f"fused sampling with per-row pitches at B={batch} "
                 "disagrees with the dense sampler")


def phase_flash(torch, results=None, head_dim=64, batches=(1, 2, 16)):
    """flash_decode_attention against reference_decode_attention at the
    bottom prior's cache shape (8 heads of ``head_dim``, 640 rows), ``pos``
    at the first key, in the first, at the start of the second, in a middle
    and in the last 128-row chunk, at each of ``batches`` (1, the dense
    sampler's 2, 16); a second call bit-identical. ``results``, when given,
    takes the bfloat16 errors. -> device ms of a bfloat16 call at B 2 and
    the last pos."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention \
        import (decode_attention_info, flash_decode_attention,
                reference_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(1)
    heads, length = 8, 640
    tol = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
    for dtype in (torch.float32, torch.bfloat16):
        log(f"flash_decode_attention head_dim {head_dim} {str(dtype)[6:]} "
            "launch at B=2: " + json.dumps(decode_attention_info(
                2, heads, head_dim, length, length - 1, dtype)))
    log("flash_decode_attention registers a thread (-Xptxas -v): "
        + json.dumps(ptxas_registers(build.PTXAS_LOGS.get(
            "decode_attention", ""), "flash_decode_kernel")))
    ms = None
    for dtype in (torch.float32, torch.bfloat16):
        for batch in batches:
            q = torch.randn(batch, heads, head_dim, generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn(batch, length, heads, head_dim, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(batch, length, heads, head_dim, generator=gen,
                            device="cuda").to(dtype)
            bias = torch.randn(heads, length, generator=gen, device="cuda")
            for pos in (0, 5, 128, 300, 639):
                out = flash_decode_attention(q, k, v, pos, bias)
                again = flash_decode_attention(q, k, v, pos, bias)
                ref = reference_decode_attention(q, k, v, pos, bias)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                atol, rtol = tol[dtype]
                same = torch.equal(out, again)
                log(f"flash_decode_attention head_dim {head_dim} B={batch} "
                    f"{str(dtype)[6:]} pos={pos}: max_abs_err {err:.3e} "
                    f"(atol {atol}, rtol {rtol}), second call identical "
                    f"{same}")
                if not torch.allclose(out.float(), ref.float(), atol=atol,
                                      rtol=rtol):
                    fail(f"flash_decode_attention head_dim {head_dim} "
                         "disagrees with the reference")
                if not same:
                    fail("flash_decode_attention: a second call differs")
                if dtype == torch.bfloat16 and results is not None:
                    results.setdefault("flash_decode_attention",
                                       []).append(err)
            if dtype == torch.bfloat16 and batch == 2:
                ms = device_ms(torch, flash_decode_attention,
                               [((q, k, v, length - 1, bias), {})] * 64) / 64
    return ms


def vq_clear_rows(torch, flat, embed):
    """Rows whose two best scores differ by more than VQ_MARGIN: a float32
    sum taken in another order cannot change their code."""
    scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
    best2 = torch.topk(scores, 2, dim=1, largest=False).values
    return (best2[:, 1] - best2[:, 0]) > VQ_MARGIN


VQ_ROWS = (128, 512, 700, 8192, 32768, 65536)


def phase_vq(torch, results=None, dim=64, rows=VQ_ROWS):
    """fused_vq_lookup against reference_vq_lookup at the full model's
    codebook (K 512; rows of ``dim``) and the main path's row counts
    (``rows``: an upload's 128 and 512, the VQ-VAE step's 8 192 and 32 768
    at batch 64, an extraction batch's 65 536; 700: no tile divides it).
    ``results``, when given, takes the embed_sum errors. -> device ms of a
    call at N 8192."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup, reference_vq_lookup, vq_lookup_info)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_embed = 512
    embed = torch.randn(dim, n_embed, generator=gen, device="cuda")
    vq_log = build.PTXAS_LOGS.get("vq_lookup", "")
    log("vq_lookup registers a thread (-Xptxas -v): " + json.dumps({
        kernel: ptxas_registers(vq_log, kernel)
        for kernel in ("vq_assign_kernel", "vq_stats_kernel")}))
    ms = None
    for n in rows:
        flat = torch.randn(n, dim, generator=gen, device="cuda")
        tag = f"vq_lookup dim {dim} N={n}"
        log(f"{tag} launch: " + json.dumps(vq_lookup_info(flat, embed)))
        ids, quant, counts, esum = fused_vq_lookup(flat, embed)
        again = fused_vq_lookup(flat, embed)
        ids_p, quant_p, counts_p, esum_p = reference_vq_lookup(flat, embed)
        torch.cuda.synchronize()
        clear = vq_clear_rows(torch, flat, embed)
        near = int((~clear).sum())
        ids_ok = bool((ids[clear] == ids_p[clear]).all())
        quant_ok = torch.equal(quant, embed.T[ids.long()])
        counts_ok = torch.equal(counts, torch.bincount(
            ids.long(), minlength=n_embed).float())
        if near == 0:
            counts_ok = counts_ok and torch.equal(counts, counts_p)
        # the sums of the kernel's own codes: against the plain float32
        # product, and both against a float64 product (a code that wins
        # thousands of rows sums to thousands, where float32 rounds at 5e-4)
        onehot = torch.nn.functional.one_hot(ids.long(), n_embed)
        plain_sum = esum_p if torch.equal(ids, ids_p) else (
            flat.T @ onehot.float())
        exact = flat.double().T @ onehot.double()
        err = max_err(esum, plain_sum)
        err_exact = float((esum.double() - exact).abs().max())
        plain_exact = float((plain_sum.double() - exact).abs().max())
        sums_ok = torch.allclose(esum.double(), exact, atol=1e-3, rtol=1e-5)
        repeat_ok = all(torch.equal(a, b) for a, b in zip(
            (ids, quant, counts, esum), again))
        log(f"{tag}: ids equal on rows above the margin {ids_ok} "
            f"({near} rows within {VQ_MARGIN} of a tie), quantize bit-exact "
            f"{quant_ok}, counts exact {counts_ok}, embed_sum max_abs_err "
            f"{err:.3e} against the plain version, {err_exact:.3e} against "
            f"float64 (plain: {plain_exact:.3e}; atol 1e-3, rtol 1e-5; "
            f"largest sum {float(exact.abs().max()):.1f}, busiest code "
            f"{int(counts.max())} rows), second call identical {repeat_ok}")
        if not (ids_ok and quant_ok and counts_ok and sums_ok
                and repeat_ok and near <= max(1, n // 1000)):
            fail(f"fused_vq_lookup disagrees with the plain version at "
                 f"dim {dim}, N={n}")
        if results is not None:
            results.setdefault("fused_vq_lookup", []).append(err)
        if n == 8192:
            ms = device_ms(torch, fused_vq_lookup,
                           [((flat, embed), {})] * 8) / 8
    return ms


def post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        status, ctype = r.status, r.headers["Content-Type"]
    return status, ctype, data, (time.perf_counter() - t0) * 1e3


BOUNDARY = "chipsmoke1234boundary"


def multipart_body(wav_bytes):
    return (f"--{BOUNDARY}\r\n"
            'Content-Disposition: form-data; name="audio"; '
            'filename="upload.wav"\r\n'
            "Content-Type: audio/wav\r\n\r\n").encode() \
        + wav_bytes + f"\r\n--{BOUNDARY}--\r\n".encode()


def post_wav(url, wav_bytes):
    """POST a wav as the multipart upload the NOTONO UI sends."""
    req = urllib.request.Request(
        url, data=multipart_body(wav_bytes), method="POST", headers={
            "Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        status = r.status
    return status, data, (time.perf_counter() - t0) * 1e3


def harmonic_note(seed, seconds, fs_hz, pitch=57):
    """A decaying harmonic note over a noise floor, float32 [n]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs_hz)) / fs_hz
    f0 = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
    note = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * t + p)
               for h, (a, p) in enumerate(zip(
                   [0.5, 0.25, 0.12, 0.06, 0.03], rng.uniform(0, 6.28, 5))))
    envelope = np.exp(-1.5 * t) * np.minimum(1.0, t * 50.0)
    return (note * envelope + 1e-3 * rng.standard_normal(t.shape[0])
            ).astype(np.float32)


def phase_server(torch, state, captured, ref):
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        attention)
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
        bottleneck)
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_attention as dat, decode_scan_kernel as dsk,
        decode_step_batched as dsb, decode_step_kernel as dst,
        prefix_prime_kernel as ppk, vq_lookup as vql)
    from interactive_spectrogram_inpainting_tpu_torch.sampling import sample
    from interactive_spectrogram_inpainting_tpu_torch.serve import server

    def capture(name, fn):
        def wrapped(*args, **kwargs):
            captured.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    # record the main paths' kernel calls to time them on the same inputs
    wrappers = {
        "fused_prefix_prime": (sample, ppk.fused_prefix_prime),
        "fused_decode_scan": (sample, dsk.fused_decode_scan),
        "fused_decode_step": (sample, dst.fused_decode_step),
        "fused_decode_step_batched": (sample, dsb.fused_decode_step_batched),
        "flash_decode_attention": (attention, dat.flash_decode_attention),
        "fused_vq_lookup": (bottleneck, vql.fused_vq_lookup)}
    for name, (module, fn) in wrappers.items():
        setattr(module, name, capture(name, fn))

    def reset(*names):
        for name in names:
            wrappers[name][1].launches = 0

    def read(*names):
        return {name: wrappers[name][1].launches for name in names}

    # the handlers' own time (request parsed -> response built), beside the
    # latency the client sees
    handler_ms = {}
    handle = server.app.handle

    def timed_handle(request):
        t0 = time.perf_counter()
        response = handle(request)
        handler_ms.setdefault(request.path, []).append(
            round((time.perf_counter() - t0) * 1e3, 3))
        return response

    server.app.handle = timed_handle
    server.STATE = state
    http = server.app.run(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{http.server_address[1]}"
    top, bottom, mask = request_codes(state, seed=1)
    cfg_t, cfg_b = state.top.config, state.bottom.config
    mask_b = np.repeat(np.repeat(mask, cfg_b.shape[0] // cfg_t.shape[0], 0),
                       cfg_b.shape[1] // cfg_t.shape[1], 1)
    body = {"top_code": top.tolist(), "bottom_code": bottom.tolist(),
            "mask": mask.tolist()}
    query = ("/timerange-change?layer=top&temperature=1.0&start_index_top=0"
             "&pitch=60&instrument_family_str=keyboard")
    latencies = []
    reset("fused_prefix_prime", "fused_decode_scan")
    try:
        for _ in range(3):
            status, _, data, ms = post(base + query, body)
            latencies.append(ms)
            if status != 200:
                fail(f"/timerange-change returned {status}")
            out = json.loads(data)
            new_top = np.asarray(out["top_code"])
            new_bottom = np.asarray(out["bottom_code"])
            if new_top.shape != top.shape or new_bottom.shape != bottom.shape:
                fail("/timerange-change returned codemaps of the wrong shape")
            if not (np.array_equal(new_top[~mask], top[~mask])
                    and np.array_equal(new_bottom[~mask_b],
                                       bottom[~mask_b])):
                fail("/timerange-change changed unmasked cells")
            if not ((new_top >= 0).all() and (new_top < cfg_t.n_class).all()
                    and (new_bottom >= 0).all()
                    and (new_bottom < cfg_b.n_class).all()):
                fail("/timerange-change returned out-of-range codes")
        launches = read("fused_prefix_prime", "fused_decode_scan")
        ref_latencies = serve_reference(state, ref, base, query, body, mask,
                                        reset, read, captured)
        for _ in range(3):
            status, ctype, wav_bytes, ms = post(
                base + "/get-audio", {"top_code": new_top.tolist(),
                                      "bottom_code": new_bottom.tolist()})
            latencies.append(ms)
            if status != 200 or ctype != "audio/wav":
                fail(f"/get-audio returned {status} {ctype}")
        launches.update(serve_generation(
            torch, state, base, reset, read, new_top, latencies, captured))
        launches.update(serve_encode(
            torch, state, base, reset, read, wav_bytes, (query, body),
            captured))
        serve_extraction(torch, state, base, captured)
    finally:
        http.shutdown()
        http.server_close()
        server.app.handle = handle
        for name, (module, fn) in wrappers.items():
            setattr(module, name, fn)
    audio, sr = read_wav(io.BytesIO(wav_bytes))
    expected = state.helper.num_samples(
        cfg_t.shape[1] * state.vqvae.config.total_resolution_factor)
    if sr != state.fs_hz or audio.shape[-1] != expected \
            or not np.isfinite(audio).all():
        fail(f"/get-audio wav: rate {sr}, {audio.shape[-1]} samples "
             f"(expected {expected})")
    log("server latency ms: " + json.dumps({
        "timerange_change": [round(x, 3) for x in latencies[:3]],
        "get_audio": [round(x, 3) for x in latencies[3:6]],
        "generate": [round(x, 3) for x in latencies[6:7]],
        "top_conditioned_sample": [round(x, 3) for x in latencies[7:9]],
        "top_conditioned_sample_64": [round(x, 3) for x in latencies[9:]]}))
    log("server latency ms, /timerange-change with the 16-head priors "
        "(cold, warm, warm) beside the 8-head ones: " + json.dumps({
            "16 heads": [round(x, 3) for x in ref_latencies],
            "8 heads": [round(x, 3) for x in latencies[:3]],
            "warm within the 100 ms limit": max(ref_latencies[1:]) < 100}))
    log("handler ms, server side, in request order (warmup's included): "
        + json.dumps(handler_ms))
    log(f"main-path launches: {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    return launches


def serve_reference(state, ref, base, query, body, mask, reset, read,
                    captured):
    """Three ``/timerange-change`` (one cold, two warm) of the same request
    with the priors of ``ref`` (the reference's 16 heads) served instead of
    the state's; their kernel calls are not kept for the kernels line. ->
    the latencies."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    kept = {k: len(v) for k, v in captured.items()}
    server.STATE = ref
    latencies = []
    reset("fused_prefix_prime", "fused_decode_scan")
    try:
        for _ in range(3):
            status, _, data, ms = post(base + query, body)
            latencies.append(ms)
            if status != 200:
                fail(f"/timerange-change with 16 heads returned {status}")
            out = json.loads(data)
            new_top = np.asarray(out["top_code"])
            top = np.asarray(body["top_code"])
            if new_top.shape != top.shape \
                    or not np.array_equal(new_top[~mask], top[~mask]) \
                    or not ((new_top >= 0).all()
                            and (new_top < ref.top.config.n_class).all()):
                fail("/timerange-change with 16 heads returned a bad codemap")
        launches = read("fused_prefix_prime", "fused_decode_scan")
    finally:
        server.STATE = state
        for k, v in captured.items():
            del v[kept.get(k, 0):]
    log(f"/timerange-change with 16 heads: launches {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        fail(f"the 16-head /timerange-change skipped a kernel: {launches}")
    return latencies


def serve_generation(torch, state, base, reset, read, top_code, latencies,
                     captured):
    """The generation paths: ``/generate`` and ``/top-conditioned-sample``
    over HTTP, then the batch-2 fused and the dense flash sampler through
    ``sample_model``. -> the launches of the kernels each path must run."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        sample_model)
    cfg_t, cfg_b = state.top.config, state.bottom.config
    steps_b = cfg_b.target_sequence_length + cfg_b.target_num_channels - 1
    launches = {}

    status, _, data, ms = post(
        base + "/generate?pitch=60&instrument_family_str=keyboard", {})
    latencies.append(ms)
    out = json.loads(data) if status == 200 else {}
    gen_top = np.asarray(out.get("top_code", []))
    gen_bottom = np.asarray(out.get("bottom_code", []))
    if status != 200 or gen_top.shape != tuple(cfg_t.shape) \
            or gen_bottom.shape != tuple(cfg_b.shape) \
            or not ((gen_top >= 0).all() and (gen_top < cfg_t.n_class).all()
                    and (gen_bottom >= 0).all()
                    and (gen_bottom < cfg_b.n_class).all()):
        fail(f"/generate returned {status} or malformed codemaps")

    # a server started with --use_predictive_sampling: /generate samples
    # both priors from scratch with the predictive sampler (the top prior's
    # codemap starts as the mask token)
    served = state.sampling_options
    state.sampling_options = {"predictive": True}
    try:
        status, _, data, ms = post(
            base + "/generate?pitch=60&instrument_family_str=keyboard", {})
    finally:
        state.sampling_options = served
    out = json.loads(data) if status == 200 else {}
    pred_top = np.asarray(out.get("top_code", []))
    pred_bottom = np.asarray(out.get("bottom_code", []))
    if status != 200 or pred_top.shape != tuple(cfg_t.shape) \
            or pred_bottom.shape != tuple(cfg_b.shape) \
            or not ((pred_top >= 0).all() and (pred_top < cfg_t.n_class).all()
                    and (pred_bottom >= 0).all()
                    and (pred_bottom < cfg_b.n_class).all()):
        fail(f"predictive /generate returned {status} or malformed codemaps")
    log(f"/generate under --use_predictive_sampling: {status} in "
        f"{ms:.1f} ms (cold, full forwards)")

    expected = state.helper.num_samples(
        cfg_t.shape[1] * state.vqvae.config.total_resolution_factor)
    # 10 pitches pad to the batch bucket 16, 60 pitches to 64; the batched
    # step calls of each bucket's last request are kept for the kernels line
    generations = captured.setdefault("batched_generations", {})
    for bucket, lo, hi in ((16, 60, 70), (64, 24, 84)):
        for _ in range(2):
            reset("fused_decode_step_batched")
            first = len(captured.get("fused_decode_step_batched", []))
            status, ctype, blob, ms = post(
                base + "/top-conditioned-sample?instrument_family_str=keyboard"
                f"&min_pitch={lo}&max_pitch={hi}&temperature=1.0",
                {"top_code": top_code.tolist(),
                 "bottom_code": gen_bottom.tolist()})
            latencies.append(ms)
            generations[bucket] = (first,
                                   len(captured["fused_decode_step_batched"]))
            if status != 200 or ctype != "application/zip":
                fail(f"/top-conditioned-sample returned {status} {ctype}")
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                names = zf.namelist()
                if names != [f"keyboard-{p}.wav" for p in range(lo, hi)]:
                    fail(f"/top-conditioned-sample zip holds {names}")
                for name in names:
                    audio, sr = read_wav(io.BytesIO(zf.read(name)))
                    if sr != state.fs_hz or audio.shape[-1] != expected \
                            or not np.isfinite(audio).all():
                        fail(f"/top-conditioned-sample {name}: rate "
                             f"{sr}, {audio.shape[-1]} samples (expected "
                             f"{expected})")
            count = read("fused_decode_step_batched")
            if count["fused_decode_step_batched"] < steps_b:
                fail(f"/top-conditioned-sample ran {count} batched steps, "
                     f"expected at least {steps_b}")
            launches.update(count)

    # batch 2 through sample_model: bottom prior primed by a half mask,
    # then the top prior (relative-bias cross attention)
    rng = np.random.default_rng(5)
    gen = state.next_rng()
    half = np.zeros(cfg_b.shape, bool)
    half[:, cfg_b.shape[1] // 2:] = True
    bottoms = rng.integers(0, cfg_b.n_class, (2,) + tuple(cfg_b.shape))
    tops = rng.integers(0, cfg_t.n_class, (2,) + tuple(cfg_t.shape))
    reset("fused_decode_step", "fused_prefix_prime")
    out_b = sample_model(
        state.bottom, gen, 2, condition=tops, initial_code=bottoms,
        mask=half, compute_dtype=torch.bfloat16,
        decode_state=state.decode_state("bottom")).cpu().numpy()
    out_t = sample_model(
        state.top, gen, 2, compute_dtype=torch.bfloat16,
        decode_state=state.decode_state("top")).cpu().numpy()
    launches.update(read("fused_decode_step"))
    if read("fused_prefix_prime")["fused_prefix_prime"] < 1:
        fail("the batch-2 inpaint was not primed by the kernel")
    if not (np.array_equal(out_b[:, ~half], bottoms[:, ~half])
            and not np.array_equal(out_b[:, half], bottoms[:, half])
            and (out_b >= 0).all() and (out_b < cfg_b.n_class).all()
            and out_t.shape == (2,) + tuple(cfg_t.shape)
            and (out_t >= 0).all() and (out_t < cfg_t.n_class).all()
            and not np.array_equal(out_t[0], out_t[1])):
        fail("the batch-2 fused samplers returned wrong codemaps")

    # the dense sampler with nucleus filtering and the flash attention
    reset("flash_decode_attention")
    t0 = time.perf_counter()
    out_d = sample_model(
        state.bottom, gen, 2, condition=tops, top_p_sampling_p=0.9,
        use_flash=True, use_fused_step=False,
        compute_dtype=torch.bfloat16).cpu().numpy()
    dense_s = time.perf_counter() - t0
    captured["dense_flash_sampler_s"] = round(dense_s, 3)
    launches.update(read("flash_decode_attention"))
    log(f"dense sampler, bottom prior B=2, top_p 0.9, use_flash, bf16: "
        f"{dense_s:.3f} s wall, {launches['flash_decode_attention']} "
        "flash_decode_attention calls")
    n_layers = cfg_b.conditional_model_num_decoder_layers
    if launches["flash_decode_attention"] != steps_b * n_layers \
            or not ((out_d >= 0).all() and (out_d < cfg_b.n_class).all()):
        fail("the dense flash sampler ran "
             f"{launches['flash_decode_attention']} attention calls "
             f"(expected {steps_b * n_layers}) or returned bad codes")
    return launches


def check_codes(np, out, top_shape, bottom_shape, n_class, what):
    top = np.asarray(out.get("top_code", []))
    bottom = np.asarray(out.get("bottom_code", []))
    if top.shape != tuple(top_shape) or bottom.shape != tuple(bottom_shape) \
            or not ((top >= 0).all() and (top < n_class).all()
                    and (bottom >= 0).all() and (bottom < n_class).all()):
        fail(f"{what} returned codemaps {top.shape} / {bottom.shape} "
             f"(expected {tuple(top_shape)} / {tuple(bottom_shape)}) or "
             "out-of-range codes")
    return top, bottom


def serve_encode(torch, state, base, reset, read, played_wav, inpaint,
                 captured):
    """The encode path over HTTP: ``/analyze-audio`` (4 s, 8 s, and the wav
    ``/get-audio`` returned), ``/erase``, ``/get-spectrogram-image``; then
    ``warmup`` and a ``/timerange-change`` with new scan bounds beside a
    repeated one. -> the launches of the VQ lookup kernel."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        read_wav, write_wav)
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    cfg_t, cfg_b = state.top.config, state.bottom.config
    n_class = state.vqvae.config.n_embed_t
    query = "?pitch=57&instrument_family_str=keyboard"
    latencies = {}

    def timed(name, fn, n=3):
        latencies[name] = []
        for _ in range(n):
            result = fn()
            latencies[name].append(round(result[-1], 3))
        return result

    def flag_off_codes(wav_bytes, n_samples):
        """The same upload through the same state with the lookup flag off
        (the dense expression), plus the rows above the margin."""
        decoded, _ = read_wav(io.BytesIO(wav_bytes))
        audio = np.zeros((1, n_samples), np.float32)
        audio[0, :min(n_samples, decoded.shape[-1])] = \
            decoded[0][:n_samples]
        vq = state.vqvae
        with torch.no_grad():
            spec = state.helper.to_spectrogram(
                torch.as_tensor(audio, device=state.device))
            enc_b = vq.enc_b(spec)
            qt_in = vq.quantize_conv_t(vq.enc_t(enc_b))
            qb_in = vq.quantize_conv_b(torch.cat(
                [vq.dec_t(vq.quantize_t(qt_in)[0]), enc_b], dim=1))
            clear = [vq_clear_rows(
                torch, x.permute(0, 2, 3, 1).reshape(-1, level.dim),
                level.embed).reshape(x.shape[2:]).cpu().numpy()
                for x, level in ((qt_in, vq.quantize_t),
                                 (qb_in, vq.quantize_b))]
        for level in (vq.quantize_t, vq.quantize_b):
            level.use_pallas_lookup = False
        try:
            id_t, id_b = state.analyze_fn()(audio)
        finally:
            for level in (vq.quantize_t, vq.quantize_b):
                level.use_pallas_lookup = True
        return id_t[0].cpu().numpy(), id_b[0].cpu().numpy(), clear

    reset("fused_vq_lookup")
    analyzed = {}
    for scale in (1, 2):
        seconds = scale * NOTE_SECONDS
        buf = io.BytesIO()
        write_wav(buf, harmonic_note(scale, seconds, state.fs_hz),
                  state.fs_hz)
        status, data, _ = timed(
            f"analyze_audio_{seconds:g}s",
            lambda: post_wav(base + "/analyze-audio" + query, buf.getvalue()))
        if status != 200:
            fail(f"/analyze-audio ({seconds:g} s) returned {status}")
        analyzed[seconds] = check_codes(
            np, json.loads(data), (cfg_t.shape[0], scale * cfg_t.shape[1]),
            (cfg_b.shape[0], scale * cfg_b.shape[1]), n_class,
            f"/analyze-audio ({seconds:g} s)") + (buf.getvalue(),)

    top, bottom, _ = analyzed[NOTE_SECONDS]
    erase_mask = np.zeros(cfg_t.shape, bool)
    erase_mask[cfg_t.shape[0] // 4:3 * cfg_t.shape[0] // 4, 1:3] = True
    status, _, data, _ = timed("erase", lambda: post(
        base + "/erase?eraser_amplitude=0.5&start_index_top=0",
        {"top_code": top.tolist(), "bottom_code": bottom.tolist(),
         "mask": erase_mask.tolist()}))
    if status != 200:
        fail(f"/erase returned {status}")
    erased_t, erased_b = check_codes(np, json.loads(data), top.shape,
                                     bottom.shape, n_class, "/erase")
    log(f"/erase: {int((erased_t != top).sum())} top and "
        f"{int((erased_b != bottom).sum())} bottom codes changed")
    if np.array_equal(erased_b, bottom):
        fail("/erase changed nothing")

    status, ctype, png, _ = timed("get_spectrogram_image", lambda: post(
        base + "/get-spectrogram-image",
        {"top_code": top.tolist(), "bottom_code": bottom.tolist()}))
    f = state.vqvae.config.total_resolution_factor
    size = struct.unpack(">II", png[16:24]) if len(png) > 24 else None
    expected = (cfg_t.shape[1] * f * state.spectrograms_upsampling_factor,
                cfg_t.shape[0] * f)
    if status != 200 or ctype != "image/png" \
            or png[:8] != b"\x89PNG\r\n\x1a\n" or size != expected:
        fail(f"/get-spectrogram-image returned {status} {ctype}, size "
             f"{size} (expected {expected})")

    status, data, ms = post_wav(base + "/analyze-audio" + query, played_wav)
    if status != 200:
        fail(f"/analyze-audio of the played wav returned {status}")
    check_codes(np, json.loads(data), cfg_t.shape, cfg_b.shape, n_class,
                "/analyze-audio of the played wav")
    latencies["analyze_audio_played_wav"] = [round(ms, 3)]
    launches = read("fused_vq_lookup")
    # what follows is held against the main path, not part of it: its
    # kernel calls are neither counted nor kept for timing
    kept = {name: len(calls) for name, calls in captured.items()
            if isinstance(calls, list)}

    for seconds, (top, bottom, wav_bytes) in analyzed.items():
        ref_t, ref_b, (clear_t, clear_b) = flag_off_codes(
            wav_bytes, state.snap_analyze_duration(
                int(seconds * state.fs_hz)))
        near = int((~clear_t).sum() + (~clear_b).sum())
        differ = int((top != ref_t)[clear_t].sum()
                     + (bottom != ref_b)[clear_b].sum())
        log(f"/analyze-audio {seconds:g} s: codemaps {top.shape} / "
            f"{bottom.shape}; against the flag-off encode {differ} codes "
            f"differ on rows above the margin ({near} rows within "
            f"{VQ_MARGIN} of a tie), {len(np.unique(bottom))} distinct "
            "bottom codes")
        if differ:
            fail("/analyze-audio: the kernel's codes differ from the dense "
                 "lookup's")

    log("/analyze-audio split ms (one warm 4 s upload, in process): "
        + json.dumps(analyze_split(torch, state, analyzed[NOTE_SECONDS][2])))

    # warmup, then: does a request with scan bounds nobody has had cost more
    # than its own repetition? (bounds are arguments of the kernels)
    t0 = time.perf_counter()
    n_warm = server.warmup(state)
    warm_s = time.perf_counter() - t0
    path, body = inpaint
    middle = np.zeros(cfg_t.shape, bool)
    middle[:, 1:3] = True
    new_body = dict(body, mask=middle.tolist())
    ratio = (cfg_b.shape[0] // cfg_t.shape[0], cfg_b.shape[1] // cfg_t.shape[1])
    bounds = {
        "repeated": [state.mask_scan_bounds("top", np.asarray(body["mask"])),
                     state.mask_scan_bounds("bottom", np.repeat(np.repeat(
                         np.asarray(body["mask"]), ratio[0], 0),
                         ratio[1], 1))],
        "new": [state.mask_scan_bounds("top", middle),
                state.mask_scan_bounds("bottom", np.repeat(np.repeat(
                    middle, ratio[0], 0), ratio[1], 1))]}
    # ... and an upload length that only warmup has sent (the 5.12 s bucket)
    late = io.BytesIO()
    write_wav(late, harmonic_note(5, 1.25 * NOTE_SECONDS, state.fs_hz),
              state.fs_hz)
    timed("analyze_audio_new_bucket_after_warmup",
          lambda: post_wav(base + "/analyze-audio" + query, late.getvalue()))
    timed("timerange_change_new_bounds",
          lambda: post(base + path, new_body), n=3)
    timed("timerange_change_repeated", lambda: post(base + path, body), n=3)
    log(f"warmup: {n_warm} requests in {warm_s:.2f} s; scan bounds "
        f"{json.dumps(bounds)}")
    log("encode latency ms (first request cold, before warmup, for all but "
        "the last three rows): " + json.dumps(latencies))
    for name, n in kept.items():
        del captured[name][n:]
    return launches


def analyze_split(torch, state, wav_bytes):
    """ms of each stage of one warm ``/analyze-audio``, run in this process
    in the handler's order, each stage ended by a synchronize (the second of
    two passes is kept)."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    from interactive_spectrogram_inpainting_tpu_torch.serve.http_app import (
        Request)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    def parse():
        request = Request.synthetic("/analyze-audio", "",
                                    multipart_body(wav_bytes))
        request._parse_multipart(
            f"multipart/form-data; boundary={BOUNDARY}")
        return request.files["audio"]

    def pad(upload):
        audio, _ = read_wav(upload)
        n = state.snap_analyze_duration(audio.shape[-1])
        out = np.zeros((1, n), np.float32)
        out[0, :min(n, audio.shape[-1])] = audio[0][:n]
        return out

    for _ in range(2):
        upload = stage("multipart_parse", parse)
        audio = stage("read_wav_snap_pad", lambda: pad(upload))
        with torch.no_grad():
            on_card = stage("to_device", lambda: torch.as_tensor(
                audio, device=state.device))
            spec = stage("to_spectrogram",
                         lambda: state.helper.to_spectrogram(on_card))
            codes = stage("vqvae_encode",
                          lambda: state.vqvae.encode_codes_only(spec))
        stage("to_host_json", lambda: server.make_response(
            codes[0], codes[1],
            *server.conditioning_maps(state, 57, "keyboard")))
    stages["sum"] = round(sum(stages.values()), 3)
    return stages


def serve_extraction(torch, state, base, captured):
    """EXTRACT_NOTES notes of NOTE_SECONDS written as an NSynth-shaped
    directory, encoded by ``extract_split`` at batch 128, decoded back, and
    served by ``/sample-from-dataset``."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.lmdb_compat import (
        open_codes_dataset)
    from interactive_spectrogram_inpainting_tpu_torch.data.nsynth import NSynth
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        read_wav, write_wav)
    from interactive_spectrogram_inpainting_tpu_torch.extract.extract_codes \
        import decode_back_sanity_check, extract_split
    families = ["bass", "flute", "keyboard", "organ"]
    cfg_t, cfg_b = state.top.config, state.bottom.config
    with tempfile.TemporaryDirectory() as tmp:
        os.mkdir(os.path.join(tmp, "audio"))
        t0 = time.perf_counter()
        meta = {}
        for i in range(EXTRACT_NOTES):
            pitch = 36 + i % 48
            name = f"{families[i % 4]}_synthetic_{i:03d}-{pitch:03d}-100"
            write_wav(os.path.join(tmp, "audio", f"{name}.wav"),
                      harmonic_note(100 + i, NOTE_SECONDS, state.fs_hz,
                                    pitch),
                      state.fs_hz)
            meta[name] = {"pitch": pitch, "note_str": name,
                          "instrument_family_str": families[i % 4]}
        with open(os.path.join(tmp, "examples.json"), "w") as f:
            json.dump(meta, f)
        write_s = time.perf_counter() - t0
        dataset = NSynth(tmp, os.path.join(tmp, "examples.json"),
                         categorical_field_list=["pitch",
                                                 "instrument_family_str"],
                         duration_seconds=NOTE_SECONDS)
        store = os.path.join(tmp, "codes")
        before = len(captured.get("fused_vq_lookup", []))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = extract_split(state.vqvae, state.helper, dataset, store,
                              batch_size=128, device=state.device)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        rows = [call[0][0].shape[0]
                for call in captured["fused_vq_lookup"][before:]]
        cells = [cfg_t.shape[0] * cfg_t.shape[1],
                 cfg_b.shape[0] * cfg_b.shape[1]]
        if count != EXTRACT_NOTES or sorted(set(rows)) != sorted(
                cells + [128 * c for c in cells]):
            fail(f"extract_split wrote {count} records through lookups of "
                 f"{sorted(set(rows))} rows")
        wav_path = os.path.join(tmp, "back.wav")
        decode_back_sanity_check(state.vqvae, state.helper, store, wav_path,
                                 audio_samples=dataset.num_samples,
                                 device=state.device)
        audio, sr = read_wav(wav_path)
        if sr != state.fs_hz or audio.shape[-1] != 4 * dataset.num_samples \
                or not np.isfinite(audio).all():
            fail(f"decode_back_sanity_check wrote {audio.shape} at {sr} Hz")
        codes = open_codes_dataset(store)
        tops, bottoms, attrs = codes.read_batch(range(len(codes)))
        if tops.shape != (EXTRACT_NOTES,) + tuple(cfg_t.shape) \
                or bottoms.shape != (EXTRACT_NOTES,) + tuple(cfg_b.shape) \
                or tops.min() < 0 or tops.max() >= cfg_t.n_class:
            fail(f"the store holds codemaps {tops.shape} / {bottoms.shape}")
        log(f"extraction: {count} notes in {extract_s:.3f} s = "
            f"{count / extract_s:.1f} notes/s at batch 128 (wav files read "
            f"on the host included; writing them took {write_s:.2f} s), "
            f"{len(np.unique(bottoms))} distinct bottom codes")
        served_encoders = state.label_encoders
        state.codes_dataset = codes
        state.label_encoders = dict(codes.label_encoders)
        try:
            status, _, data, ms = post(
                base + "/sample-from-dataset?pitch=40"
                "&instrument_family_str=bass", {})
            out = json.loads(data) if status == 200 else {}
            top, _ = check_codes(np, out, cfg_t.shape, cfg_b.shape,
                                 cfg_t.n_class, "/sample-from-dataset")
            stored = [i for i in range(len(codes))
                      if np.array_equal(tops[i], top)]
            if not stored or out["top_conditioning"]["pitch"][0][0] != 40:
                fail("/sample-from-dataset returned a codemap the store "
                     "does not hold, or the wrong pitch")
            log(f"/sample-from-dataset: record {stored[0]} in {ms:.1f} ms")
        finally:
            state.codes_dataset = None
            state.label_encoders = served_encoders


# -- the last ported modules: reference checkpoints, load, store, examples -----

# (users, share of 2x-long inpaints, seconds over which the users start)
LOAD_WINDOWS = ((4, 0.0, 0.0), (32, 0.25, 8.0))
LOAD_TIMED_S = 60.0    # each window's latencies, without the profiler
LOAD_TRACED_S = 25.0   # each window again under torch.profiler: device busy
LOAD_MIN_P95 = 20      # an endpoint with fewer requests reports no p95
STORE_RECORDS = 289205                 # NSynth train's notes
STORE_CHUNK = 32768                    # records the store writer takes at once


def phase_reference_load(torch, state):
    """The server VQ-VAE's tensors under the reference's ``.pt`` names
    (``torch_port.reference_names`` inverted), loaded by
    ``port_vqvae_state_dict`` into a fresh ``VQVAE`` with ``strict=True``:
    ``/analyze-audio`` of a 4 s note gives the server model's codes bit for
    bit, through the VQ lookup kernel."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        write_wav)
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae \
        import VQVAE
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        vq_lookup as vql)
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    from interactive_spectrogram_inpainting_tpu_torch.serve.http_app import (
        Request)
    from interactive_spectrogram_inpainting_tpu_torch.utils.torch_port \
        import port_vqvae_state_dict, reference_names
    config = state.vqvae.config
    ours = state.vqvae.state_dict()
    names = reference_names(config)
    if sorted(port for _, port in names) != sorted(ours):
        fail("reference_names does not name every tensor of the VQ-VAE")
    reference = {ref: ours[port].cpu() for ref, port in names}
    t0 = time.perf_counter()
    loaded = VQVAE(config)
    loaded.load_state_dict(port_vqvae_state_dict(reference, config),
                           strict=True)
    loaded = loaded.to(DEVICE).eval()
    load_ms = (time.perf_counter() - t0) * 1e3
    buf = io.BytesIO()
    write_wav(buf, harmonic_note(21, NOTE_SECONDS, state.fs_hz), state.fs_hz)
    cfg_t, cfg_b = state.top.config, state.bottom.config

    def analyze(what):
        request = Request.synthetic(
            "/analyze-audio", "pitch=57&instrument_family_str=keyboard")
        request.files = {"audio": buf.getvalue()}
        response = server.app.dispatch(request)
        if response.status != 200:
            fail(f"/analyze-audio ({what}) returned {response.status}: "
                 f"{response.body[:200]!r}")
        return check_codes(np, json.loads(response.body), cfg_t.shape,
                           cfg_b.shape, config.n_embed_t,
                           f"/analyze-audio ({what})")

    server.STATE = state
    served = analyze("server VQ-VAE")
    kept, state.vqvae = state.vqvae, loaded
    vql.fused_vq_lookup.launches = 0
    try:
        got = analyze("reference-named VQ-VAE")
        launches = vql.fused_vq_lookup.launches
    finally:
        state.vqvae = kept
    differ = sum(int((a != b).sum()) for a, b in zip(got, served))
    log(f"reference .pt load: {len(names)} reference tensors -> strict "
        f"load in {load_ms:.1f} ms; /analyze-audio {NOTE_SECONDS:g} s: "
        f"{differ} of "
        f"{sum(a.size for a in got)} codes differ from the server VQ-VAE's, "
        f"VQ lookup launches {launches}")
    if differ or launches == 0:
        fail("the reference-named VQ-VAE did not encode like the server's "
             "through the VQ lookup kernel")


def union_ms(intervals):
    """Length of the union of (start, end) intervals, in their unit / 1e3."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def percentiles_ms(seconds):
    import numpy as np
    if not seconds:
        return None
    return {"n": len(seconds),
            "p50": round(float(np.percentile(seconds, 50)) * 1e3, 1),
            "p95": round(float(np.percentile(seconds, 95)) * 1e3, 1),
            "max": round(max(seconds) * 1e3, 1)}


def expected_primes(body, ratio_t):
    """Prefix primes a ``/timerange-change`` of the load payload implies,
    from its mask alone: each prior primes when its mask's first masked
    column is past column 0 (the bottom prior's column is the top's times
    the time ratio; both priors scan column by column)."""
    import numpy as np
    columns = np.flatnonzero(np.asarray(body["mask"], bool).any(0))
    if not columns.size:
        return 0
    return int(columns[0] > 0) + int(ratio_t * columns[0] > 0)


def load_window(torch, state, base, window, seconds, traced, served):
    """One ``run_load`` window -> the log record: latencies per endpoint
    (client side; the p95 only where an endpoint served ``LOAD_MIN_P95``
    requests), the server-side queue wait and handler time, the handler
    thread's busy share, the device's busy share from ``nvidia-smi``
    utilization samples and, when ``traced``, from the union of
    ``torch.profiler``'s device intervals. ``served`` collects, server side,
    each request's arrival (the HTTP thread hands it to the handler
    thread), handler start and end, status and the request itself. Fails on
    any failed request and unless every inpaint launched the scan for both
    priors and the prime for each prior that ``expected_primes`` names."""
    import contextlib
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk, prefix_prime_kernel as ppk)
    from interactive_spectrogram_inpainting_tpu_torch.serve import loadtest
    users, long_fraction, ramp_s = window
    served.clear()
    dsk.fused_decode_scan.launches = ppk.fused_prefix_prime.launches = 0
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    tracer = (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext())
    try:
        with tracer as prof:
            t0 = time.perf_counter()
            report = loadtest.run_load(
                base, users, seconds, tuple(state.top.config.shape),
                tuple(state.bottom.config.shape), state.top.config.n_class,
                long_fraction=long_fraction, ramp_s=ramp_s)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        smi.terminate()
        samples = [float(x) for x in smi.communicate()[0].split()
                   if x.replace(".", "", 1).isdigit()]
    scans = dsk.fused_decode_scan.launches
    primes = ppk.fused_prefix_prime.launches
    cfg_t, cfg_b = state.top.config, state.bottom.config
    inpaints = [r for r in served if r["path"] == "/timerange-change"]
    bodies = [r["request"].get_json() for r in inpaints]
    want_primes = sum(expected_primes(b, cfg_b.shape[1] // cfg_t.shape[1])
                      for b in bodies)
    for stats in report.values():
        if stats.get("requests", 0) < LOAD_MIN_P95:
            stats["p95_ms"] = None
    handler_ms = sum(r["end"] - r["start"] for r in served) * 1e3
    record = {
        "users": users, "long_fraction": long_fraction, "ramp_s": ramp_s,
        "traced": traced, "window_ms": round(wall_ms, 1),
        "endpoints": report,
        "requests_served": len(served),
        "arrived_in_first_s": sum(r["arrived"] - t0 < 1.0 for r in served),
        "server_ms_queue": percentiles_ms(
            [r["start"] - r["arrived"] for r in served]),
        "server_ms_queue_plus_handler": percentiles_ms(
            [r["end"] - r["arrived"] for r in served]),
        "handler_busy_share": round(handler_ms / wall_ms, 4),
        "device_busy_share_nvidia_smi": (
            round(float(np.mean(samples)) / 100.0, 4) if samples else None),
        "nvidia_smi_samples": len(samples),
        "scan_launches": scans, "prime_launches": primes,
        "inpaints": len(inpaints),
        "inpaints_long": sum(len(b["top_code"][0]) > cfg_t.shape[1]
                             for b in bodies)}
    if traced:
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        traced_scans = sum("decode_scan" in e.name for e in device)
        record.update({
            "device_busy_share_profiler": round(union_ms(
                (e.time_range.start, e.time_range.end) for e in device)
                / wall_ms, 4),
            "device_kernels_traced": len(device),
            "scan_launches_traced": traced_scans,
            "device_busy_share_method": (
                "torch.profiler (union of device intervals)"
                if traced_scans >= scans else "nvidia-smi utilization.gpu")})
    errors = sum(v.get("errors", 0) for v in report.values())
    bad = [(r["path"], r["status"]) for r in served if r["status"] != 200]
    log(f"load window: {json.dumps(record)}")
    if errors or bad:
        fail(f"load window of {users} users: {errors} client errors, "
             f"server responses {bad}")
    if scans != 2 * len(inpaints) or primes != want_primes:
        fail(f"load window of {users} users: {len(inpaints)} inpaints "
             f"launched {scans} scans (expected {2 * len(inpaints)}) and "
             f"{primes} primes (expected {want_primes}: one for each prior "
             "whose mask's first masked column is past 0)")
    return record


def phase_load(torch, state):
    """The full-width server over HTTP on localhost under the load driver
    (``serve/loadtest.py``: the reference's locust mix, 1-8 s think time)
    after a warmup with long sounds. Each of ``LOAD_WINDOWS`` runs twice:
    ``LOAD_TIMED_S`` without the profiler (the latencies, the handler
    thread's busy share, ``nvidia-smi``'s device busy share), then
    ``LOAD_TRACED_S`` under ``torch.profiler`` (the device's busy share
    from its device intervals, where the trace holds every scan launch).
    ``load_window`` checks each window."""
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    for modality, value in (("pitch", 60),
                            ("instrument_family_str", "keyboard")):
        try:
            state.label_encoders[modality].transform([value])
        except (KeyError, ValueError) as exc:
            fail(f"the load payload's {modality} {value!r} is not a label "
                 f"of the serving state: {exc!r}")
    server.STATE = state
    t0 = time.perf_counter()
    n_warm = server.warmup(state, long_sounds=True)
    log(f"load: warmup with long sounds, {n_warm} requests in "
        f"{time.perf_counter() - t0:.1f} s")
    served = []
    app = server.app

    def arriving(request):
        request.arrived = time.perf_counter()
        return type(app).dispatch(app, request)

    def recorded(request):
        start = time.perf_counter()
        response = type(app).handle(app, request)
        served.append({"path": request.path, "arrived": request.arrived,
                       "start": start, "end": time.perf_counter(),
                       "status": response.status, "request": request})
        return response

    app.dispatch, app.handle = arriving, recorded
    http = app.run(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{http.server_address[1]}"
    try:
        records = [load_window(torch, state, base, window, seconds, traced,
                               served)
                   for window in LOAD_WINDOWS
                   for seconds, traced in ((LOAD_TIMED_S, False),
                                           (LOAD_TRACED_S, True))]
    finally:
        http.shutdown()
        http.server_close()
        del app.dispatch, app.handle
    if not sum(r["inpaints"] for r in records):
        fail("the load windows served no /timerange-change")


def write_code_store(torch, path, top_shape, bottom_shape, n_class):
    """STORE_RECORDS seeded random codemaps in a codemap store, written in
    blocks of STORE_CHUNK records."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapStoreWriter
    rng = np.random.default_rng(13)
    with CodemapStoreWriter(path, top_shape, bottom_shape,
                            ["pitch", "instrument_family_str"],
                            n_class=n_class) as writer:
        for start in range(0, STORE_RECORDS, STORE_CHUNK):
            n = min(STORE_CHUNK, STORE_RECORDS - start)
            writer.append_batch(
                rng.integers(0, n_class, (n,) + tuple(top_shape)),
                rng.integers(0, n_class, (n,) + tuple(bottom_shape)),
                {"pitch": rng.integers(0, 61, n),
                 "instrument_family_str": rng.integers(0, 11, n)},
                [f"note_{i:06d}" for i in range(start, start + n)])


def phase_store_reads(torch, state, workdir):
    """One epoch of reads from a store of NSynth train's size (289 205
    records at the full geometry), at the prior trainer's batch, through
    the C++ reader (``use_native=True``) and numpy's memmap: ``read_batch``
    over a seeded permutation (both modes must return the same batches),
    the prior trainer's ``iterate_batches`` (reads, int64 tensors on the
    card), and, once, ``BatchLoader`` with its prefetch thread (which reads
    record by record through ``__getitem__``, numpy's memmap in either
    mode)."""
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapDataset
    from interactive_spectrogram_inpainting_tpu_torch.data.loader import (
        BatchLoader)
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.train.train_prior \
        import iterate_batches
    cfg_t, cfg_b = state.top.config, state.bottom.config
    path = os.path.join(workdir, "store-nsynth-size")
    t0 = time.perf_counter()
    write_code_store(torch, path, cfg_t.shape, cfg_b.shape, cfg_t.n_class)
    size = os.path.getsize(os.path.join(path, "codes.bin"))
    log(f"store reads: {STORE_RECORDS} records, {size} bytes written in "
        f"{time.perf_counter() - t0:.1f} s")
    modes = {"native": CodemapDataset(path, use_native=True),
             "numpy": CodemapDataset(path)}
    order = np.random.default_rng(14).permutation(STORE_RECORDS)
    batches = [order[i:i + TRAIN_BATCH]
               for i in range(0, STORE_RECORDS - TRAIN_BATCH + 1, TRAIN_BATCH)]
    differ = 0
    for idx in batches:
        a, b = modes["native"].read_batch(idx), modes["numpy"].read_batch(idx)
        differ += not (np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       and all(np.array_equal(a[2][k], b[2][k]) for k in b[2]))
    if differ:
        fail(f"store reads: {differ} of {len(batches)} batches differ "
             "between the C++ reader and numpy's memmap")

    def read_batches(ds):
        for idx in batches:
            ds.read_batch(idx)

    def trainer_epoch(ds):
        for _ in iterate_batches(ds, TRAIN_BATCH, True, 0, device=DEVICE):
            pass
        synchronize(torch)

    def loader_epoch(ds):
        for _ in BatchLoader(ds, TRAIN_BATCH, shuffle=True, seed=0):
            pass

    timings = {}
    for name, fn, order_ in (("read_batch", read_batches,
                              ("native", "numpy", "numpy", "native")),
                             ("train_prior.iterate_batches", trainer_epoch,
                              ("native", "numpy")),
                             ("BatchLoader(prefetch=2), memmap __getitem__",
                              loader_epoch, ("numpy",))):
        for mode in order_:
            t0 = time.perf_counter()
            fn(modes[mode])
            seconds = time.perf_counter() - t0
            timings.setdefault(name, {}).setdefault(mode, []).append(
                {"epoch_s": round(seconds, 3),
                 "ms_per_batch": round(seconds * 1e3 / len(batches), 4)})
    log(f"store reads, one epoch of {len(batches)} batches of {TRAIN_BATCH} "
        f"(the batches of both modes equal): {json.dumps(timings)}")


def phase_examples(torch, state, captured, workdir):
    """Both example drivers on the VQ-VAE the trainer wrote (the lookup flag
    set in its parameters file) and two seeded 4 s notes, on the card:
    every file written, every metric finite, the VQ lookup and spectral
    loss kernels launched; each driver's wall time."""
    import pathlib
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        read_wav, write_wav)
    from interactive_spectrogram_inpainting_tpu_torch.examples import (
        inference_analysis, process_audio)
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk, vq_lookup as vql)
    from interactive_spectrogram_inpainting_tpu_torch.utils.visualization \
        import have_matplotlib
    run = captured["vqvae_run"]
    out = pathlib.Path(workdir) / "examples"
    out.mkdir()
    params = json.loads((run / "vqvae-model_parameters.json").read_text())
    params["use_pallas_lookup"] = True
    (out / "vqvae-model_parameters.json").write_text(json.dumps(params))
    notes = []
    for i, pitch in enumerate((52, 64)):
        notes.append(str(out / f"note{i}.wav"))
        write_wav(notes[-1], harmonic_note(31 + i, NOTE_SECONDS, state.fs_hz,
                                           pitch), state.fs_hz)
    ckpt = ["--vqvae_model_parameters_path",
            str(out / "vqvae-model_parameters.json"),
            "--vqvae_weights_path", str(run / "vqvae-weights.msgpack"),
            "--vqvae_training_parameters_path",
            str(run / "command_line_parameters.json"), "--device", DEVICE]
    record = {}

    def drive(name, fn, argv, files):
        vql.fused_vq_lookup.launches = sk.scale_loss_forward.launches = 0
        t0 = time.perf_counter()
        result = fn(ckpt + argv)
        synchronize(torch)
        record[name] = {"wall_s": round(time.perf_counter() - t0, 3),
                        "vq_lookup_launches": vql.fused_vq_lookup.launches,
                        "spectral_loss_forward_launches":
                            sk.scale_loss_forward.launches}
        for f in files:
            if not (out / name / f).exists():
                fail(f"{name} wrote no {f}")
            if f.endswith(".wav"):
                audio, sr = read_wav(str(out / name / f))
                if sr != state.fs_hz or not audio.size \
                        or not np.isfinite(audio).all():
                    fail(f"{name}: {f} is empty or not finite")
        return result

    figures = (["reconstructions.png", "code_usage_top.png",
                "code_usage_bottom.png"] if have_matplotlib() else [])
    metrics = drive(
        "inference_analysis", inference_analysis.main,
        ["--audio_paths", *notes, "--output_directory",
         str(out / "inference_analysis")],
        ["reconstruction_metrics.json", "interpolation.wav",
         "corrupted_codes.wav"] + figures
        + [f"note{i}-{kind}.wav" for i in range(2)
           for kind in ("original", "reconstruction")])
    drive("process_audio", process_audio.main,
          ["--input_wavs", *notes, "--output_directory",
           str(out / "process_audio")],
          [f"note{i}-vqvae.wav" for i in range(2)])
    log(f"examples: metrics {json.dumps(metrics)}; "
        f"{json.dumps(record)}; figures "
        f"{'drawn' if figures else 'skipped (no matplotlib)'}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"inference_analysis gave non-finite metrics {metrics}")
    if record["inference_analysis"]["spectral_loss_forward_launches"] == 0 \
            or any(r["vq_lookup_launches"] == 0 for r in record.values()):
        fail(f"an example skipped a kernel: {record}")


def attention_shapes(state):
    """(name, Lq, Lk, additive mask) of the three attentions of a training
    step at the full priors' geometry (with start symbols)."""
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        attention)
    cfg_b = state.bottom.config
    lq = cfg_b.target_sequence_length + cfg_b.target_num_channels
    ls = cfg_b.source_sequence_length + 1
    aligned = state.bottom.decoder_layers[0]._aligned_mask(lq, ls)
    return [("decoder self", lq, lq, attention.causal_mask(lq, DEVICE)),
            ("cross", lq, ls, aligned.to(DEVICE)),
            ("encoder self", ls, ls, attention.anti_causal_mask(ls, DEVICE))]


def phase_train_attention(torch, state, results, heads=8, head_dim=64):
    """The training-attention kernels against their plain versions at the
    three attention shapes of a training step, B = 32, 8 heads of 64 (or
    ``heads`` of ``head_dim``: a model rank's share)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    tol = {torch.float32: ((1e-5, 1e-5), (2e-4, 1e-4)),
           torch.bfloat16: ((3e-2, 3e-2), (3e-2, 3e-2))}
    for name, lq, lk, mask in attention_shapes(state):
        for dtype in (torch.float32, torch.bfloat16):
            q, dout = (torch.randn(TRAIN_BATCH, lq, heads, head_dim,
                                   generator=gen, device=DEVICE).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn(TRAIN_BATCH, lk, heads, head_dim,
                                generator=gen, device=DEVICE).to(dtype)
                    for _ in range(2))
            ab = torch.randn(heads, lq, lk, generator=gen,
                             device=DEVICE) + mask[None]
            out = ta.train_attention_forward(q, k, v, ab)
            grads = ta.train_attention_backward(q, k, v, ab, dout)
            again = ta.train_attention_backward(q, k, v, ab, dout)
            ref = ta.reference_train_attention(q, k, v, ab)
            ref_grads = ta.reference_train_attention_backward(q, k, v, ab,
                                                              dout)
            torch.cuda.synchronize()
            (fa, fr), (ga, gr) = tol[dtype]
            errs = {"o": max_err(out, ref)}
            ok = torch.allclose(out.float(), ref.float(), atol=fa, rtol=fr)
            for key, got, want in zip(("dq", "dk", "dv", "dab"), grads,
                                      ref_grads):
                errs[key] = max_err(got, want)
                ok = ok and torch.allclose(got.float(), want.float(),
                                           atol=ga, rtol=gr)
                ok = ok and bool(torch.isfinite(got.float()).all())
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"train_attention {name} {lq}x{lk} {str(dtype)[6:]}, "
                f"{heads} heads of {head_dim}: "
                "max_abs_err " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items())
                + f" (forward atol {fa} rtol {fr}, gradients atol {ga} "
                f"rtol {gr}), second backward identical {same}")
            if not (ok and same):
                fail(f"train_attention {name} {dtype} disagrees with the "
                     "plain version")
            key = ("fused_train_attention" if dtype == torch.float32
                   else "fused_train_attention_bf16")
            if results is not None:
                results.setdefault(key, []).extend(errs.values())


def write_train_store(torch, state, path):
    """TRAIN_RECORDS seeded random codemaps at the full geometry, labelled
    with the test state's pitches and families."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapStoreWriter
    cfg_t, cfg_b = state.top.config, state.bottom.config
    encoders = state.label_encoders
    rng = np.random.default_rng(12)
    with CodemapStoreWriter(path, cfg_t.shape, cfg_b.shape,
                            ["pitch", "instrument_family_str"],
                            label_encoders=encoders,
                            n_class=cfg_t.n_class) as writer:
        for i in range(TRAIN_RECORDS):
            writer.append(
                rng.integers(0, cfg_t.n_class, cfg_t.shape),
                rng.integers(0, cfg_b.n_class, cfg_b.shape),
                {"pitch": i % len(encoders["pitch"]),
                 "instrument_family_str":
                     i % len(encoders["instrument_family_str"])},
                f"record_{i:03d}")


def train_args(store, runs, hier, *extra):
    out = ["--hier", hier, "--database_path", store, "--runs_directory",
           runs, "--batch_size", str(TRAIN_BATCH), "--num_training_epochs",
           "1", "--train_logs_frequency_batches", "4", "--device", DEVICE]
    if hier == "bottom":
        out.append("--use_aligned_decoder")
    return out + TRAIN_MODEL_ARGS + list(extra)


def step_setup(torch, store, hier, fused=True, bf16=False, dropout=None,
               seed=0, mesh=None):
    """(model, train_step, batches) of the trainer at its defaults; on
    ``mesh`` the model is this rank's shard and the batches its rows."""
    from interactive_spectrogram_inpainting_tpu_torch.data.lmdb_compat import (
        open_codes_dataset)
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        scheduler, train_prior as tp)
    from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
        init_like_flax)
    extra = [] if dropout is None else ["--dropout", str(dropout)]
    args = tp.make_parser().parse_args(train_args(store, "", hier, *extra))
    dataset = open_codes_dataset(store, args.classes_for_conditioning)
    model = tp.build_model(args, dataset, fused)
    init_like_flax(model, torch.Generator().manual_seed(seed)).to(DEVICE)
    if mesh is not None:
        from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh \
            import shard_prior_parameters
        shard_prior_parameters(model, mesh)
    cfg = model.config
    sampler = None if hier == "bottom" else tp.make_mask_sampler(
        args.mask_sampler, cfg.source_sequence_length, cfg.mask_token_index,
        args.mask_probability, args.mask_min_masking_ratio)
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        args.lr, 100)
    step, _ = tp.make_steps(model, optimizer, hier, sampler, 0.0, bf16=bf16,
                            mesh=mesh)
    batches = list(tp.iterate_batches(dataset, TRAIN_BATCH, True, 0,
                                      device=DEVICE, mesh=mesh))
    return model, step, batches


def attention_launches():
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    return (ta.train_attention_forward.launches,
            ta.train_attention_backward.launches)


def reset_attention_launches():
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    ta.train_attention_forward.launches = 0
    ta.train_attention_backward.launches = 0


def time_train_steps(torch, store, hier, bf16, timing):
    """Warm ms of one training step at batch 32 (the kernels on), after a
    first step that must launch ATTENTION_CALLS forward and backward
    attention kernels."""
    model, step, batches = step_setup(torch, store, hier, bf16=bf16)
    gen = torch.Generator().manual_seed(1)
    reset_attention_launches()
    step(*batches[0][:3], gen)
    torch.cuda.synchronize()
    launches = attention_launches()
    if launches != (ATTENTION_CALLS, ATTENTION_CALLS):
        fail(f"one {hier} training step launched {launches} forward and "
             f"backward attention kernels, expected {ATTENTION_CALLS} each")
    step(*batches[1][:3], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = batches[2:]
    t0 = time.perf_counter()
    for batch in timed:
        metrics = step(*batch[:3], gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    if not torch.isfinite(metrics["loss"]):
        fail(f"{hier} training step loss is not finite")
    key = f"{hier} {'bf16' if bf16 else 'f32'}"
    timing[key] = {"warm_step_ms": round(ms, 3),
                   "steps_per_s": round(1e3 / ms, 3),
                   "steps_timed": len(timed),
                   "max_memory_allocated_gib": round(
                       torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    del model, step, batches


def check_fused_against_dense(torch, store, hier):
    """One step with the kernels and one with the dense attention from the
    same weights, on the same batch with dropout 0: loss and every gradient
    close. Then 20 steps on that batch with the kernels: the loss falls."""
    models = {}
    for fused in (True, False):
        model, step, batches = step_setup(torch, store, hier, fused=fused,
                                          dropout=0.0)
        metrics = step(*batches[0][:3], torch.Generator().manual_seed(2))
        models[fused] = (model, step, batches, metrics)
    (m_f, step_f, batches, met_f), (m_d, _, _, met_d) = (models[True],
                                                         models[False])
    torch.cuda.synchronize()
    worst = {"loss": abs(float(met_f["loss"]) - float(met_d["loss"]))}
    ok = worst["loss"] <= 2e-4 + 2e-3 * abs(float(met_d["loss"]))
    for (name, p_f), p_d in zip(m_f.named_parameters(), m_d.parameters()):
        worst[name] = max_err(p_f.grad, p_d.grad)
        ok = ok and torch.allclose(p_f.grad, p_d.grad, atol=2e-4, rtol=2e-3)
    top3 = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"train step {hier}, kernels against dense attention (dropout 0, "
        f"one batch): loss {float(met_f['loss']):.6f} / "
        f"{float(met_d['loss']):.6f}; largest gradient differences "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in top3})} "
        "(atol 2e-4, rtol 2e-3)")
    if not ok:
        fail(f"{hier}: the kernels' training step disagrees with the dense "
             "one")
    del models, m_d
    losses = [float(met_f["loss"])]
    gen = torch.Generator().manual_seed(3)
    for _ in range(19):
        losses.append(float(step_f(*batches[0][:3], gen)["loss"]))
    log(f"train step {hier}, 20 steps on one batch: loss "
        + " ".join(f"{x:.3f}" for x in losses))
    # random codes: the loss falls from the initial model's toward the
    # codes' entropy, ln(512) = 6.24, and below it as the batch is learnt
    if not (losses[-1] < losses[0] - 0.25
            and min(losses[-5:]) < min(losses[:5])):
        fail(f"{hier}: the loss did not fall over 20 steps on one batch")


def profile_kernels(torch, fn, reps=1):
    """Device time by kernel name of ``reps`` calls of ``fn`` under
    ``torch.profiler`` (per call), the host clock's ms per call around them
    (ended by a synchronize) and the share of that wall time in which no
    kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        kernels[evt.key] = (total / 1e3 / reps, evt.count / reps)
    busy = sum(ms for ms, _ in kernels.values())
    return kernels, wall_ms, busy


def kernel_family(name):
    if name.startswith("void") and "attn_" in name:
        return "training attention kernels"
    lowered = name.lower()
    if any(k in lowered for k in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "cuBLAS products"
    if "optimizer" in lowered or "adam" in lowered or "foreach" in lowered:
        return "optimizer (foreach)"
    return "other (elementwise, reductions, copies)"


def profile_train_step(torch, store, hier, bf16):
    """Where one warm training step's device time goes."""
    model, step, batches = step_setup(torch, store, hier, bf16=bf16)
    gen = torch.Generator().manual_seed(5)
    it = iter(batches * 2)
    kernels, wall_ms, busy = profile_kernels(
        torch, lambda: step(*next(it)[:3], gen), reps=3)
    families = {}
    for name, (ms, count) in kernels.items():
        fam = families.setdefault(kernel_family(name), [0.0, 0.0])
        fam[0] += ms
        fam[1] += count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    del model, step, batches
    return {"wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy, 3),
            "device_idle_share": round(1.0 - busy / wall_ms, 4),
            "families_ms_launches": {k: [round(v[0], 3), round(v[1], 1)]
                                     for k, v in families.items()},
            "top_kernels_ms": {k[:90]: round(v[0], 3) for k, v in top}}


def epoch_record(run_dir, hier):
    import pathlib
    path = pathlib.Path(run_dir) / "tb" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    epochs = [r for r in records if f"{hier}/epoch/epoch_s" in r]
    validation = [r for r in records if f"{hier}/validation/loss" in r]
    if not epochs or not validation:
        fail(f"{path} holds no epoch or validation record")
    return {k.split("/")[-1]: round(v, 4) for k, v in
            {**epochs[-1], **validation[-1]}.items()
            if k.startswith(f"{hier}/")}


def phase_train(torch, state, captured, workdir):
    """The prior trainer at the flagship width; see the module docstring.
    Its runs stay in ``workdir`` (``captured["prior_runs"]``: the VQ-VAE
    phase serves from them). -> the attention launches of the main path
    (one epoch of each prior)."""
    import pathlib
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        attention)
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    from interactive_spectrogram_inpainting_tpu_torch.serve.http_app import (
        Request)
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        checkpoint, train_prior as tp)
    from interactive_spectrogram_inpainting_tpu_torch.utils.checkpoint_io \
        import prior_from_parameters_and_weights
    cfg_b = state.bottom.config
    l_self = cfg_b.target_sequence_length + cfg_b.target_num_channels
    steps = TRAIN_RECORDS // TRAIN_BATCH
    calls = captured.setdefault("fused_train_attention", [])
    calls_bf16 = captured.setdefault("fused_train_attention_bf16", [])

    def capture(q, k, v, ab):
        # keep one decoder self-attention of each dtype (forward inputs and
        # the backward's output cotangent) for the kernels line: float32
        # from the main path, bfloat16 from the --bf16 run
        out = ta.fused_train_attention(q, k, v, ab)
        kept_calls = calls if q.dtype == torch.float32 else calls_bf16
        if not kept_calls and q.shape[1] == k.shape[1] == l_self:
            kept = tuple(t.detach() for t in (q, k, v, ab))
            out.register_hook(
                lambda g: kept_calls.append(kept + (g.contiguous(),))
                if not kept_calls else None)
        return out

    store = os.path.join(workdir, "codes")
    write_train_store(torch, state, store)
    runs = {name: os.path.join(workdir, name) for name in
            ("top", "bottom", "bf16", "remat", "resume")}
    # the main path: one epoch of each prior, kernels counted
    attention.fused_train_attention = capture
    reset_attention_launches()
    try:
        results = {}
        for hier in ("top", "bottom"):
            t0 = time.perf_counter()
            before = attention_launches()
            tp.main(train_args(store, runs[hier], hier))
            after = attention_launches()
            (run_dir,) = pathlib.Path(runs[hier]).iterdir()
            results[hier] = dict(epoch_record(run_dir, hier),
                                 wall_s=round(time.perf_counter() - t0, 2))
            # every train step and every evaluation batch of the epoch
            want = (ATTENTION_CALLS * 2 * steps, ATTENTION_CALLS * steps)
            got = (after[0] - before[0], after[1] - before[1])
            if got != want:
                fail(f"{hier} epoch launched {got} forward/backward "
                     f"attention kernels, expected {want}")
            for name in (f"{hier}-model_parameters.json",
                         f"{hier}-weights.msgpack",
                         "checkpoints/0/state.pt"):
                if not (run_dir / name).exists():
                    fail(f"the {hier} run wrote no {name}")
            runs[hier] = run_dir
        launches = attention_launches()
    finally:
        attention.fused_train_attention = ta.fused_train_attention
    log("train epochs (main path, float32, batch 32): "
        + json.dumps(results))
    log(f"train main-path attention launches (forward, backward): "
        f"{launches}")

    # the other switches of the trainer, a few bottom steps each; the bf16
    # run's attention launches are the bf16 kernels' main path
    for name, flag in (("bf16", "--bf16"), ("remat", "--remat")):
        attention.fused_train_attention = capture
        reset_attention_launches()
        try:
            model = tp.main(train_args(
                store, runs[name], "bottom", flag, "--num_training_samples",
                str(3 * TRAIN_BATCH), "--disable_writes_to_disk"))
        finally:
            attention.fused_train_attention = ta.fused_train_attention
        if name == "bf16":
            captured["bf16_attention_launches"] = sum(attention_launches())
        if not all(torch.isfinite(p).all() for p in model.parameters()):
            fail(f"bottom training with {flag} gave non-finite weights")
        log(f"bottom training with {flag}: 3 steps, weights finite, "
            f"attention launches (forward, backward) {attention_launches()}")
    tp.main(train_args(store, runs["resume"], "top",
                       "--resume_training_from", str(runs["top"]),
                       "--num_training_epochs", "2"))
    (resumed,) = pathlib.Path(runs["resume"]).iterdir()
    if checkpoint.Checkpointer(resumed).latest_epoch() != 1:
        fail("the resumed top run did not train epoch 1")
    log(f"top resumed from epoch 0: {json.dumps(epoch_record(resumed, 'top'))}")

    check_fused_against_dense(torch, store, "bottom")
    timing = {}
    for hier in ("top", "bottom"):
        for bf16 in (False, True):
            time_train_steps(torch, store, hier, bf16, timing)
    log("train step timing (batch 32, warm, host clock around "
        "synchronizes): " + json.dumps(timing))
    for hier in ("top", "bottom"):
        for bf16 in (False, True):
            log(f"train step profile, {hier} "
                f"{'bf16' if bf16 else 'f32'} (3 warm steps, "
                "torch.profiler, per step): " + json.dumps(
                    profile_train_step(torch, store, hier, bf16)))

    # the trained priors, from the files the trainer wrote, serve
    priors = {hier: prior_from_parameters_and_weights(
        runs[hier] / f"{hier}-model_parameters.json",
        runs[hier] / f"{hier}-weights.msgpack") for hier in
        ("top", "bottom")}
    trained = server.ServerState(
        state.vqvae, priors["top"], priors["bottom"], state.helper,
        state.label_encoders, fs_hz=state.fs_hz,
        max_sound_duration_s=state.max_sound_duration_s,
        device=state.device, seed=0)
    top, bottom, mask = request_codes(trained, seed=2)
    served, server.STATE = server.STATE, trained
    try:
        t0 = time.perf_counter()
        response = server.app.dispatch(Request.synthetic(
            "/timerange-change", "layer=top&temperature=1.0"
            "&start_index_top=0&pitch=60&instrument_family_str=keyboard",
            json.dumps({"top_code": top.tolist(),
                        "bottom_code": bottom.tolist(),
                        "mask": mask.tolist()}).encode()))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.STATE = served
    if response.status != 200:
        fail(f"/timerange-change from the trained priors returned "
             f"{response.status}: {response.body[:200]!r}")
    out = json.loads(response.body)
    new_top = np.asarray(out["top_code"])
    if new_top.shape != top.shape or not np.array_equal(
            new_top[~mask], top[~mask]):
        fail("/timerange-change from the trained priors returned wrong "
             "codemaps")
    log(f"/timerange-change from the trained priors: "
        f"{int((new_top != top).sum())} top codes changed, "
        f"{ms:.1f} ms (cold)")
    captured["prior_runs"] = {h: runs[h] for h in ("top", "bottom")}
    if not calls or not calls_bf16:
        fail("no float32 or bfloat16 decoder self-attention was captured")
    return launches


def spectral_audio(torch, seed=6):
    """The spectral-loss phase's pred and target [SPECTRAL_BATCH,
    SPECTRAL_SAMPLES]: seeded noise, the target 0.05 away."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    pred = 0.3 * torch.randn(SPECTRAL_BATCH, SPECTRAL_SAMPLES, generator=gen,
                             device=DEVICE)
    return pred, pred + 0.05 * torch.randn(pred.shape, generator=gen,
                                           device=DEVICE)


def spectral_sign_differs(pred, target, cfg, u, ref_u):
    """The bins where the kernel's U and the plain version's take another
    sign of mag_p - mag_t (opposite directions, or zero in one of them),
    and the largest |d64| / bound among them, d64 = mag_p - mag_t in
    float64: each must lie within float32 rounding, |d64| <= max(|d32 -
    d64|, 2^-20 x its frame's largest magnitude), d32 the float32 DFT plain
    version's difference. Above 1 is a real disagreement."""
    import torch
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    f = cfg.n_fft // 2 + 1
    uk, up = u.float(), ref_u.float()

    def nonzero(x):
        return (x[..., :f] != 0) | (x[..., f:] != 0)

    differs = ((uk[..., :f] * up[..., :f] + uk[..., f:] * up[..., f:] < 0)
               | (nonzero(uk) != nonzero(up)))
    if not bool(differs.any()):
        return differs, 0.0
    mag64 = [sk.magnitude(*sk.reference_spectrum_float64(x, cfg))
             for x in (pred, target)]
    d32 = (sk.magnitude(*sk.reference_spectrum(pred, cfg))
           - sk.magnitude(*sk.reference_spectrum(target, cfg)))
    d64 = mag64[0] - mag64[1]
    bound = torch.maximum(
        (d32.double() - d64).abs(),
        2.0 ** -20 * torch.maximum(*mag64).amax(-1, keepdim=True))
    return differs, float((d64.abs() / bound)[differs].max())


def bf16_steps_apart(u, ref_u, keep):
    """(how many values of two bfloat16 U lie farther apart than one
    bfloat16 step of the larger plus 1e-5 x max|U|, the card tests' bound,
    the largest distance in such steps), leaving out the zeros of
    ``keep``."""
    import torch
    uk, up = u.float(), ref_u.float()
    step = torch.exp2(torch.floor(torch.log2(
        torch.maximum(uk.abs(), up.abs()).clamp_min(1e-30))) - 7)
    over = ((uk - up).abs() - 1e-5 * float(up.abs().max())) / step
    if keep is not None:
        over = over * keep
    return int((over > 1).sum()), float(over.max())


def float64_error(rows, total, exact):
    """The larger relative error of the rows (worst row) and of the total
    against the float64 evaluation ``exact``."""
    return max(float(((rows.double() - exact).abs() / exact.abs()).max()),
               float((total.double() - exact.sum()).abs()
                     / exact.sum().abs()))


def spectral_rounding(pred, target, cfg):
    """Readings of one 'high' scale's spectrum of ``pred`` against float64:
    the RMS magnitude error over its frame's largest magnitude of the
    float32 DFT plain version, the packed ``torch.fft`` oracle and an
    unpacked float32 rfft; and, with pred as its own target (L1 of the
    linear magnitudes), the summed |mag P - mag T| over the summed
    magnitude for the kernel and the packed oracle: an algorithm that
    transforms pred and target alike gives 0, so it reads the packed
    transform's rounding at every bin."""
    import torch
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    exact = sk.magnitude(*sk.reference_spectrum_float64(pred, cfg))
    frame_max = exact.amax(-1, keepdim=True)
    spec = torch.fft.rfft(sk._frames(pred, cfg)
                          * sk.hann_window(cfg.win, pred.device), n=cfg.n_fft)
    out = {}
    for key, (re, im) in (
            ("dft", sk.reference_spectrum(pred, cfg)),
            ("packed_fft", sk.reference_spectra_fft(pred, target, cfg)[:2]),
            ("unpacked_fft", (spec.real, spec.imag))):
        out[f"{key}_rms"] = float(
            (((sk.magnitude(re, im).double() - exact) / frame_max) ** 2)
            .mean().sqrt())
    l1 = cfg._replace(mse=False, lin_w=1.0, log_w=0.0)
    total = float(exact.sum())
    out["kernel_self"] = float(sk.scale_loss_forward(
        pred, pred, l1, need_u=False)[1]) / total
    out["packed_fft_self"] = float(sk.reference_scale_loss_fft(
        pred, pred, l1, need_u=False)[0].sum()) / total
    return out


def spectral_float64_draws(torch):
    """DDSP's 'high' scales over SPECTRAL_DRAWS draws of the phase's audio:
    in how many draws the kernel, and the packed ``torch.fft`` oracle, lie
    farther from the float64 evaluation than the float32 DFT plain version
    does, for the value (worst row or total) and for the gradient (max |d -
    d64| / max |d64|), and the median of their distance over the plain
    version's. Near half the draws where chance at the few bins that
    nearly cancel decides which float32 algorithm comes closer."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    from interactive_spectrogram_inpainting_tpu_torch.train import losses
    one = torch.ones((), device=DEVICE)
    n = SPECTRAL_SAMPLES
    for cfg in losses.make_ddsp_loss().scale_configs(SPECTRAL_BATCH, n):
        ratios = {key: [] for key in ("kernel_value", "kernel_gradient",
                                      "oracle_value", "oracle_gradient")}
        for draw in range(SPECTRAL_DRAWS):
            pred, target = spectral_audio(torch, seed=100 + draw)
            exact_rows, exact_u = sk.reference_scale_loss_float64(
                pred, target, cfg)
            exact_d = sk.reference_scale_loss_fft_backward(exact_u, one, cfg,
                                                           n)
            rows, total, u = sk.scale_loss_forward(pred, target, cfg)
            oracle_rows, oracle_u = sk.reference_scale_loss_fft(pred, target,
                                                                cfg)
            plain_rows, plain_u = sk.reference_scale_loss(pred, target, cfg)
            dist = {}
            for key, (r, t, d) in {
                    "kernel": (rows, total, sk.scale_loss_backward(
                        u, one, cfg, n)),
                    "oracle": (oracle_rows, oracle_rows.sum(),
                               sk.reference_scale_loss_fft_backward(
                                   oracle_u, one, cfg, n)),
                    "plain": (plain_rows, plain_rows.sum(),
                              sk.reference_scale_loss_backward(
                                  plain_u, one, cfg, n))}.items():
                dist[key] = (float64_error(r, t, exact_rows),
                             float((d.double() - exact_d).abs().max()
                                   / exact_d.abs().max()))
            for key in ("kernel", "oracle"):
                for i, part in enumerate(("value", "gradient")):
                    ratios[f"{key}_{part}"].append(dist[key][i]
                                                   / dist["plain"][i])
        log(f"spectral loss DDSP {cfg[:3]} over {SPECTRAL_DRAWS} audio "
            f"draws, against float64: " + json.dumps({
                key: {"farther_than_plain": sum(x > 1 for x in v),
                      "median_over_plain": sorted(v)[len(v) // 2]}
                for key, v in ratios.items()}))


def phase_spectral_loss(torch, results):
    """The spectral-loss kernels against their plain versions at the
    flagship shapes: every Jukebox and DDSP scale, B = 64 rows of 65 536
    samples, precision 'high' (the FFT route) and 'default' (the DFT
    route). Checks: the value (the total and each row) within rtol 1e-5;
    the kernel's backward of the kernel's U against the plain backward of
    the same U within atol 1e-5 x max; the gradient (the kernel's backward
    of the kernel's U against the plain backward of the plain U) within
    atol 2e-3 x max|grad|; a second forward and backward give the same
    bits; on Jukebox's scales the value is no farther from the float64
    evaluation than the plain version's.

    On DDSP's L1 scales at 'high', the bins where the two U take another
    sign of mag_p - mag_t are left out of the gradient comparison, each
    shown to lie within float32 rounding of 0 against float64. What is left
    there is not within 2e-3 x max: U carries log_w / (mag_p + eps), so the
    few bins whose pred magnitude nearly cancels set the largest gradient,
    and float32 fixes their U only to about a percent, the DFT plain
    version as the FFT. The phase logs that distance beside each float32
    algorithm's distance from the float64 gradient, and does not fail on
    it. Logged too for every 'high' scale: the U values more than one
    bfloat16 step apart, the value against float64, and
    ``spectral_rounding``; then ``spectral_float64_draws``."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    from interactive_spectrogram_inpainting_tpu_torch.train import losses
    pred, target = spectral_audio(torch)
    one = torch.ones((), device=DEVICE)
    errs = []
    for name, make in (("Jukebox", losses.make_jukebox_loss),
                       ("DDSP", losses.make_ddsp_loss)):
        for precision in ("high", "default"):
            loss = dataclasses.replace(make(), precision=precision)
            worst = {"value_rel": 0.0, "same_u_rel": 0.0, "grad_rel": 0.0}
            same = True
            routes = []
            for cfg in loss.scale_configs(*pred.shape):
                route = "fft" if sk.fft_route(cfg) else "dft"
                routes.append(f"{cfg.n_fft}/{cfg.hop}/{cfg.win} {route}")
                if route != ("fft" if precision == "high" else "dft"):
                    fail(f"spectral loss {name} {precision} scale "
                         f"{cfg[:3]} takes the {route} route")
                runs = []
                for _ in range(2):
                    rows, total, u = sk.scale_loss_forward(pred, target, cfg)
                    runs.append((rows, total, u, sk.scale_loss_backward(
                        u, one, cfg, SPECTRAL_SAMPLES)))
                rows, total, u, d = runs[0]
                ref_rows, ref_u = sk.reference_scale_loss(pred, target, cfg)
                same_d = sk.reference_scale_loss_backward(
                    u, one, cfg, SPECTRAL_SAMPLES)
                torch.cuda.synchronize()
                same = same and all(torch.equal(a, b) for a, b in
                                    zip(runs[0], runs[1]))
                ref_total = ref_rows.sum()
                value_rel = max(float((total - ref_total).abs()
                                      / ref_total.abs()),
                                float(((rows - ref_rows).abs()
                                       / ref_rows.abs()).max()))
                same_u_rel = float((d - same_d).abs().max()
                                   / same_d.abs().max())
                keep = None
                sign_note = ""
                if precision == "high" and not cfg.mse:
                    # the one exclusion: L1 bins whose sign float32
                    # rounding decides
                    differs, ratio = spectral_sign_differs(
                        pred, target, cfg, u, ref_u)
                    if ratio > 1.0:
                        fail(f"spectral loss {name} {cfg[:3]}: an L1 sign "
                             f"differs from the plain version's outside "
                             f"float32 rounding (|d64| / bound {ratio:.3f})")
                    keep = (~differs).repeat(1, 1, 2)
                    sign_note = (f"{int(differs.sum())} of {differs.numel()}"
                                 f" bins left out, their L1 sign within "
                                 f"float32 rounding (largest |d64| / bound "
                                 f"{ratio:.3f}); ")
                grad_d, ref_d = d, sk.reference_scale_loss_backward(
                    ref_u if keep is None else ref_u * keep, one, cfg,
                    SPECTRAL_SAMPLES)
                if keep is not None:
                    grad_d = sk.scale_loss_backward(u * keep, one, cfg,
                                                    SPECTRAL_SAMPLES)
                grad_rel = float((grad_d - ref_d).abs().max()
                                 / ref_d.abs().max())
                held = not (name == "DDSP" and precision == "high")
                worst["value_rel"] = max(worst["value_rel"], value_rel)
                worst["same_u_rel"] = max(worst["same_u_rel"], same_u_rel)
                worst["grad_rel"] = max(worst["grad_rel"], grad_rel)
                if not (value_rel <= 1e-5 and same_u_rel <= 1e-5
                        and (grad_rel <= 2e-3 or not held)
                        and bool(torch.isfinite(d).all())):
                    fail(f"spectral loss {name} {precision} scale "
                         f"{cfg[:3]}: value rel {value_rel:.3e}, backward "
                         f"of one U {same_u_rel:.3e} x max, gradient "
                         f"{grad_rel:.3e} x max against the plain version")
                if precision != "high":
                    continue
                errs += [float((total - ref_total).abs()),
                         float((d - same_d).abs().max())]
                if held:
                    errs.append(float((grad_d - ref_d).abs().max()))
                exact_rows, exact_u = sk.reference_scale_loss_float64(
                    pred, target, cfg)
                kernel_err = float64_error(rows, total, exact_rows)
                plain_err = float64_error(ref_rows, ref_total, exact_rows)
                apart, steps = bf16_steps_apart(u, ref_u, keep)
                note = ""
                if not cfg.mse:
                    exact_d = sk.reference_scale_loss_fft_backward(
                        exact_u, one, cfg, SPECTRAL_SAMPLES)
                    far = [float((x.double() - exact_d).abs().max()
                                 / exact_d.abs().max())
                           for x in (d, sk.reference_scale_loss_backward(
                               ref_u, one, cfg, SPECTRAL_SAMPLES))]
                    note = (f"; gradient against the plain version "
                            f"{grad_rel:.3e} x max ({sign_note}"
                            f"{'within' if grad_rel <= 2e-3 else 'NOT MET:'}"
                            f" 2e-3), from the float64 gradient: kernel "
                            f"{far[0]:.3e}, plain {far[1]:.3e} x max")
                log(f"spectral loss {name} {cfg[:3]}: against float64 "
                    f"(worst row or total, relative) kernel "
                    f"{kernel_err:.3e}, float32 DFT plain version "
                    f"{plain_err:.3e}; {apart} of {u.numel()} U values "
                    f"more than one bf16 step apart (largest {steps:.1f} "
                    f"steps){note}; rounding "
                    f"{json.dumps(spectral_rounding(pred, target, cfg))}")
                if name == "Jukebox" and kernel_err > plain_err:
                    fail(f"spectral loss {name} {cfg[:3]}: the kernel is "
                         f"farther from float64 ({kernel_err:.3e}) than the "
                         f"plain version ({plain_err:.3e})")
            log(f"spectral loss {name} {precision} (B {SPECTRAL_BATCH}, "
                f"{SPECTRAL_SAMPLES} samples, {len(loss.n_ffts)} scales, "
                f"routes {', '.join(routes)}): "
                f"worst value rel err {worst['value_rel']:.3e} (rtol 1e-5), "
                f"backward of one U {worst['same_u_rel']:.3e} x max (atol "
                f"1e-5 x max), gradient {worst['grad_rel']:.3e} x max (atol "
                f"2e-3 x max{'' if held else ', not held: see above'}), "
                f"second forward and backward identical {same}")
            if not same:
                fail(f"spectral loss {name} {precision}: a second call gave "
                     "other bits")
    spectral_float64_draws(torch)
    results["fused_multiscale_loss"] = errs


def write_nsynth_split(torch, root, fs_hz):
    """VQVAE_TRAIN_NOTES + VQVAE_VALID_NOTES seeded 4 s harmonic notes as an
    NSynth-shaped directory: ``audio/*.wav``, ``train.json``,
    ``train_small.json`` (the first two batches) and ``valid.json``."""
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        write_wav)
    families = ["bass", "flute", "keyboard", "organ"]
    os.makedirs(os.path.join(root, "audio"))
    splits = {"train": {}, "valid": {}}
    for i in range(VQVAE_TRAIN_NOTES + VQVAE_VALID_NOTES):
        pitch = 36 + i % 48
        name = f"{families[i % 4]}_synthetic_{i:03d}-{pitch:03d}-100"
        write_wav(os.path.join(root, "audio", f"{name}.wav"),
                  harmonic_note(300 + i, NOTE_SECONDS, fs_hz, pitch), fs_hz)
        split = "train" if i < VQVAE_TRAIN_NOTES else "valid"
        splits[split][name] = {"pitch": pitch, "note_str": name,
                               "instrument_family_str": families[i % 4]}
    small = dict(list(splits["train"].items())[:2 * VQVAE_BATCH])
    for name, meta in (("train", splits["train"]), ("valid", splits["valid"]),
                       ("train_small", small)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(meta, f)


def vqvae_args(data, runs, *extra, split="train"):
    return (["--dataset_audio_directory_paths", os.path.join(data, "audio"),
             "--train_dataset_json_data_path",
             os.path.join(data, f"{split}.json"),
             "--validation_dataset_json_data_path",
             os.path.join(data, "valid.json"), "--runs_directory", runs,
             "--num_training_epochs", "1", "--batch_size", str(VQVAE_BATCH),
             "--reconstruction_criterion", "spectral_jukebox", "--pallas_vq",
             "--train_logs_frequency_batches", "1", "--device", DEVICE]
            + VQVAE_FLAGS + VQVAE_MODEL_ARGS + list(extra))


def vqvae_step_setup(torch, data, *extra, seed=0, mesh=None):
    """(model, train_step, audio batches on the card) of the VQ-VAE trainer
    at the flagship flags, weights from ``seed``, the normalization
    statistics of the first batch; on ``mesh`` the batches are this rank's
    rows and the codebooks' statistics global."""
    from interactive_spectrogram_inpainting_tpu_torch.data.loader import (
        BatchLoader)
    from interactive_spectrogram_inpainting_tpu_torch.data.nsynth import NSynth
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae \
        import VQVAE
    from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram \
        import get_spectrograms_helper
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        losses, scheduler, train_vqvae as tv)
    from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
        init_like_flax)
    args = tv.make_parser().parse_args(vqvae_args(data, "", *extra,
                                                  split="train_small"))
    helper = get_spectrograms_helper(**vars(args))
    loader = BatchLoader(NSynth(
        args.dataset_audio_directory_paths,
        args.train_dataset_json_data_path,
        categorical_field_list=["pitch", "instrument_family_str"],
        duration_seconds=NOTE_SECONDS), VQVAE_BATCH, shuffle=False,
        prefetch=0)
    batches = [torch.as_tensor(b[0] if isinstance(b, tuple) else b).to(DEVICE)
               for b in loader]
    if mesh is not None:
        from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh \
            import shard_batch
        batches = [shard_batch(mesh, b) for b in batches]
    stats = tv.compute_normalization_statistics(helper, [batches[0]],
                                                device=DEVICE, mesh=mesh)
    config = dataclasses.replace(tv.build_config(args),
                                 normalizer_statistics=dataclasses.asdict(
                                     stats))
    model = init_like_flax(VQVAE(config), torch.Generator().manual_seed(
        seed)).to(DEVICE)
    if mesh is not None:
        from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh \
            import set_data_mesh
        set_data_mesh(model, mesh)
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        args.lr, 100)
    criterion = losses.get_reconstruction_criterion(
        args.reconstruction_criterion, helper,
        precision=args.spectral_precision)
    step = tv.make_train_step(model, optimizer, criterion, 0.25, helper,
                              bf16=args.bf16, mesh=mesh)
    return model, step, batches


def spectral_launches():
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    return sk.scale_loss_forward.launches, sk.scale_loss_backward.launches


def check_vqvae_kernel_against_plain(torch, data):
    """One step with the spectral-loss kernels against one with the plain
    float32 loss (``--spectral_precision highest``: the scales through
    ``reference_scale_loss`` and autograd), same weights and batch: loss
    within rtol 1e-5, every gradient within atol 5e-3 x max|grad| (the
    kernel's U is bfloat16). Then 20 steps on that batch with the kernels:
    the loss falls."""
    out = {}
    for precision in ("high", "highest"):
        model, step, batches = vqvae_step_setup(
            torch, data, "--spectral_precision", precision)
        metrics = step(batches[0], torch.Generator(device=DEVICE))
        out[precision] = (model, step, batches, metrics)
    (m_k, step_k, batches, met_k), (m_p, _, _, met_p) = (out["high"],
                                                         out["highest"])
    torch.cuda.synchronize()
    largest = max(float(p.grad.abs().max()) for p in m_p.parameters())
    loss_k, loss_p = float(met_k["vqvae_loss"]), float(met_p["vqvae_loss"])
    worst = max((max_err(a.grad, b.grad), name) for (name, a), b in zip(
        m_k.named_parameters(), m_p.parameters()))
    log(f"VQ-VAE step, spectral-loss kernels against the plain float32 "
        f"loss (one batch of {VQVAE_BATCH}): loss {loss_k:.7f} / "
        f"{loss_p:.7f}; largest gradient difference {worst[0]:.3e} "
        f"({worst[1]}) against max|grad| {largest:.3e} (atol 5e-3 x max)")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or \
            worst[0] > 5e-3 * largest:
        fail("the VQ-VAE step with the spectral-loss kernels disagrees with "
             "the plain loss")
    del out, m_p
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    losses_ = [loss_k] + [float(step_k(batches[0], gen)["vqvae_loss"])
                          for _ in range(19)]
    log("VQ-VAE step, 20 steps on one batch: loss "
        + " ".join(f"{x:.4f}" for x in losses_))
    if not (losses_[-1] < losses_[0]
            and min(losses_[-5:]) < min(losses_[:5])):
        fail("the VQ-VAE loss did not fall over 20 steps on one batch")


def time_vqvae_steps(torch, data, criterion, bf16, timing):
    """Warm ms of one VQ-VAE step at batch 64 (without the metric trio)."""
    extra = ["--reconstruction_criterion", criterion] + (
        ["--bf16"] if bf16 else [])
    model, step, batches = vqvae_step_setup(torch, data, *extra)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for batch in batches:
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = batches * 3
    t0 = time.perf_counter()
    for batch in timed:
        metrics = step(batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    if not torch.isfinite(metrics["vqvae_loss"]):
        fail(f"VQ-VAE {criterion} step loss is not finite")
    timing[f"{criterion} {'bf16' if bf16 else 'f32'}"] = {
        "warm_step_ms": round(ms, 3), "steps_timed": len(timed),
        "max_memory_allocated_gib": round(
            torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    return model, step, batches


def vqvae_kernel_family(name):
    lowered = name.lower()
    if "spectral_" in lowered:
        return "spectral-loss kernels"
    if "vq_" in lowered:
        return "VQ-lookup kernels"
    if "fft" in lowered:
        return "FFT kernels (cuFFT; cuDNN's FFT convolutions)"
    if any(k in lowered for k in ("conv", "cudnn", "implicit", "winograd",
                                  "wgrad", "dgrad", "xmma")):
        return "cuDNN convolutions"
    return kernel_family(name)


def profile_vqvae_step(torch, model, step, batches):
    """Where one warm VQ-VAE step's device time goes."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    it = iter(batches * 3)
    kernels, wall_ms, busy = profile_kernels(
        torch, lambda: step(next(it), gen), reps=3)
    families = {}
    for name, (ms, count) in kernels.items():
        fam = families.setdefault(vqvae_kernel_family(name), [0.0, 0.0])
        fam[0] += ms
        fam[1] += count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy, 3),
            "device_idle_share": round(1.0 - busy / wall_ms, 4),
            "families_ms_launches": {k: [round(v[0], 3), round(v[1], 1)]
                                     for k, v in families.items()},
            "top_kernels_ms": {k[:90]: round(v[0], 3) for k, v in top}}


def vqvae_epoch_record(run_dir):
    import pathlib
    path = pathlib.Path(run_dir) / "tb" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    epochs = [r for r in records if "epoch/epoch_s" in r]
    validation = [r for r in records if "validation/vqvae_loss" in r]
    if not epochs or not validation:
        fail(f"{path} holds no epoch or validation record")
    return {k: round(v, 4) for k, v in {**epochs[-1],
                                         **validation[-1]}.items()
            if k.startswith(("epoch/", "validation/"))}


def phase_train_vqvae(torch, state, captured, workdir):
    """The VQ-VAE trainer at the flagship width; see the module docstring.
    -> (spectral-loss launches of the main path, forward + backward)."""
    import pathlib
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk, vq_lookup as vql)
    from interactive_spectrogram_inpainting_tpu_torch.serve import server
    from interactive_spectrogram_inpainting_tpu_torch.serve.http_app import (
        Request)
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        checkpoint, losses, train_vqvae as tv)
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        write_wav)
    data = os.path.join(workdir, "nsynth")
    t0 = time.perf_counter()
    write_nsynth_split(torch, data, state.fs_hz)
    log(f"VQ-VAE data: {VQVAE_TRAIN_NOTES} + {VQVAE_VALID_NOTES} notes of "
        f"{NOTE_SECONDS:g} s written in {time.perf_counter() - t0:.2f} s")
    runs = {name: os.path.join(workdir, f"vqvae-{name}") for name in
            ("main", "bf16", "resume", "mse")}
    calls = captured.setdefault("fused_multiscale_loss", [])

    def capture(pred, target, cfg, reduction="mean"):
        # keep the three scales of the first Jukebox criterion call of the
        # main path (the inputs a step's kernels get) for the kernels line
        if (reduction == "mean" and pred.requires_grad and cfg.mse
                and cfg.precision == "high" and len(calls) < 3):
            calls.append(((pred.detach().contiguous(),
                           target.detach().contiguous(), cfg), {}))
        return sk.fused_scale_loss(pred, target, cfg, reduction)

    steps = VQVAE_TRAIN_NOTES // VQVAE_BATCH
    valid_batches = -(-VQVAE_VALID_NOTES // VQVAE_BATCH)
    n_jukebox, n_ddsp = 3, 6
    # each train step: the criterion (forward and backward) and the trio's
    # DDSP and Jukebox forwards; each evaluation batch: criterion and trio
    want = ((steps + valid_batches) * (n_jukebox + n_ddsp + n_jukebox),
            steps * n_jukebox)
    sk.scale_loss_forward.launches = sk.scale_loss_backward.launches = 0
    vql.fused_vq_lookup.launches = 0
    losses.fused_scale_loss = capture
    try:
        t0 = time.perf_counter()
        model = tv.main(vqvae_args(data, runs["main"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = spectral_launches()
        vq_launches = vql.fused_vq_lookup.launches
    finally:
        losses.fused_scale_loss = sk.fused_scale_loss
    (main_run,) = pathlib.Path(runs["main"]).iterdir()
    log(f"VQ-VAE epoch (main path, spectral_jukebox, float32, batch "
        f"{VQVAE_BATCH}, {steps} steps + {valid_batches} evaluation batch): "
        + json.dumps(dict(vqvae_epoch_record(main_run),
                          wall_s=round(wall, 2))))
    log(f"VQ-VAE main-path launches: spectral loss forward, backward "
        f"{launches} (expected {want}), VQ lookup {vq_launches}")
    if launches != want or vq_launches == 0:
        fail(f"the VQ-VAE epoch launched {launches} spectral-loss kernels "
             f"(expected {want}) and {vq_launches} VQ lookups")
    captured["spectral_launches_main"] = launches
    captured["vqvae_run"] = main_run
    for name in ("vqvae-model_parameters.json", "vqvae-weights.msgpack",
                 "checkpoints/0/state.pt", f"tb/media/original_0-{steps}.wav"):
        if not (main_run / name).exists():
            fail(f"the VQ-VAE run wrote no {name}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("the VQ-VAE epoch gave non-finite weights")

    # the other switches: bf16, resume, the mse criterion
    model = tv.main(vqvae_args(data, runs["bf16"], "--bf16",
                               "--disable_writes_to_disk",
                               split="train_small"))
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("VQ-VAE training with --bf16 gave non-finite weights")
    log("VQ-VAE training with --bf16: 2 steps, weights finite")
    tv.main(vqvae_args(data, runs["resume"], "--resume_training_from",
                       str(main_run), "--num_training_epochs", "2",
                       split="train_small"))
    (resumed,) = pathlib.Path(runs["resume"]).iterdir()
    if checkpoint.Checkpointer(resumed).latest_epoch() != 1:
        fail("the resumed VQ-VAE run did not train epoch 1")
    log(f"VQ-VAE resumed from epoch 0: "
        f"{json.dumps(vqvae_epoch_record(resumed))}")
    tv.main(vqvae_args(data, runs["mse"], "--reconstruction_criterion",
                       "mse"))
    (mse_run,) = pathlib.Path(runs["mse"]).iterdir()
    log(f"VQ-VAE mse epoch: {json.dumps(vqvae_epoch_record(mse_run))}")

    check_vqvae_kernel_against_plain(torch, data)
    timing = {}
    for criterion in ("mse", "spectral_jukebox"):
        for bf16 in (False, True):
            kept = time_vqvae_steps(torch, data, criterion, bf16, timing)
            if criterion == "spectral_jukebox" and not bf16:
                profiled = kept
            del kept
    log(f"VQ-VAE step timing (batch {VQVAE_BATCH}, warm, without the metric "
        "trio, host clock around synchronizes): " + json.dumps(timing))
    log("VQ-VAE step profile, spectral_jukebox f32 (3 warm steps, "
        "torch.profiler, per step): "
        + json.dumps(profile_vqvae_step(torch, *profiled)))
    del profiled

    # serve: the trained VQ-VAE with the two trained priors
    priors = captured["prior_runs"]
    trained = server.load_state_from_checkpoints(
        main_run / "vqvae-model_parameters.json",
        main_run / "vqvae-weights.msgpack",
        main_run / "command_line_parameters.json",
        priors["top"] / "top-model_parameters.json",
        priors["top"] / "top-weights.msgpack",
        priors["bottom"] / "bottom-model_parameters.json",
        priors["bottom"] / "bottom-weights.msgpack",
        max_sound_duration_s=state.max_sound_duration_s, device=DEVICE)
    trained.label_encoders = state.label_encoders
    cfg_t, cfg_b = trained.top.config, trained.bottom.config
    n_class = trained.vqvae.config.n_embed_t
    served, server.STATE = server.STATE, trained
    try:
        buf = io.BytesIO()
        write_wav(buf, harmonic_note(7, NOTE_SECONDS, state.fs_hz),
                  state.fs_hz)
        request = Request.synthetic(
            "/analyze-audio", "pitch=57&instrument_family_str=keyboard")
        request.files = {"audio": buf.getvalue()}
        t0 = time.perf_counter()
        response = server.app.dispatch(request)
        ms = {"analyze_audio": (time.perf_counter() - t0) * 1e3}
        if response.status != 200:
            fail(f"/analyze-audio from the trained VQ-VAE returned "
                 f"{response.status}: {response.body[:200]!r}")
        top, bottom = check_codes(np, json.loads(response.body), cfg_t.shape,
                                  cfg_b.shape, n_class,
                                  "/analyze-audio (trained VQ-VAE)")
        mask = np.zeros(cfg_t.shape, bool)
        mask[:, cfg_t.shape[1] - 2:] = True
        body = json.dumps({"top_code": top.tolist(),
                           "bottom_code": bottom.tolist(),
                           "mask": mask.tolist()}).encode()
        t0 = time.perf_counter()
        response = server.app.dispatch(Request.synthetic(
            "/timerange-change", "layer=top&temperature=1.0"
            "&start_index_top=0&pitch=57&instrument_family_str=keyboard",
            body))
        ms["timerange_change"] = (time.perf_counter() - t0) * 1e3
        if response.status != 200:
            fail(f"/timerange-change (trained models) returned "
                 f"{response.status}: {response.body[:200]!r}")
        out = json.loads(response.body)
        new_top, new_bottom = check_codes(np, out, cfg_t.shape, cfg_b.shape,
                                          n_class, "/timerange-change "
                                          "(trained models)")
        if not np.array_equal(new_top[~mask], top[~mask]):
            fail("/timerange-change (trained models) changed unmasked codes")
        t0 = time.perf_counter()
        response = server.app.dispatch(Request.synthetic(
            "/get-audio", "", json.dumps({
                "top_code": new_top.tolist(),
                "bottom_code": new_bottom.tolist()}).encode()))
        ms["get_audio"] = (time.perf_counter() - t0) * 1e3
    finally:
        server.STATE = served
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import (
        read_wav)
    audio, sr = read_wav(io.BytesIO(response.body)) if \
        response.status == 200 else (np.zeros(0), 0)
    frames = cfg_b.shape[1] * int(
        trained.vqvae.config.resolution_factors["bottom"])
    if sr != state.fs_hz or audio.shape[-1] != \
            trained.helper.num_samples(frames) \
            or not np.isfinite(audio).all():
        fail(f"/get-audio (trained models) returned {response.status}, "
             f"{audio.shape} at {sr} Hz")
    log(f"trained VQ-VAE + trained priors served: /analyze-audio, "
        f"/timerange-change ({int((new_top != top).sum())} top codes "
        f"changed), /get-audio; ms (cold) "
        + json.dumps({k: round(v, 1) for k, v in ms.items()}))
    if len(calls) != 3:
        fail(f"captured {len(calls)} Jukebox scales of the main path")
    return sum(launches)


def spectral_bound(pred, target, cfg):
    """(bytes, ops) of one scale's forward (pred and target -> the loss
    and U) and backward (U -> the gradient): each half's inputs read once
    and outputs written once; the operations as an FFT needs them, 2.5
    n_fft log2 n_fft a real transform of one frame, two transforms a frame
    forward (pred and target) and one backward (the transposed transform
    of U). The window, the magnitudes and the distances are O(n_fft) a
    frame and left out: a lower bound."""
    batch, length = pred.shape
    frames = 1 + (length - cfg.n_fft) // cfg.hop
    u = batch * frames * 2 * (cfg.n_fft // 2 + 1) * 2
    fft = batch * frames * 2.5 * cfg.n_fft * math.log2(cfg.n_fft)
    fwd = (2 * nbytes(pred) + u + 4 * (batch + 1), 2 * fft)
    bwd = (u + nbytes(pred) + 4, fft)
    return fwd, bwd


def spectral_pair_bound(args, kwargs):
    """The pair as one function of the audio: pred and target read, the
    loss and the gradient written (U is the halves' own intermediate)."""
    fwd, bwd = spectral_bound(*args)
    return 3 * nbytes(args[0]) + 4, fwd[1] + bwd[1]


def spectral_pair(pred, target, cfg):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    _, _, u = sk.scale_loss_forward(pred, target, cfg)
    return sk.scale_loss_backward(u, spectral_one(pred), cfg,
                                  pred.shape[-1])


def plain_spectral_pair(pred, target, cfg):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    _, u = sk.reference_scale_loss(pred, target, cfg)
    return sk.reference_scale_loss_backward(u, spectral_one(pred), cfg,
                                            pred.shape[-1])


def spectral_one(like):
    import torch
    return torch.ones((), device=like.device)


def stft_spectral_pair(pred, target, cfg):
    """The same scale's loss and gradient as library calls: ``torch.stft``
    (cuFFT, ``center=False``, the Hann window centred in n_fft) of pred and
    target, magnitudes, the squared or L1 distance, the backward by
    autograd; timed as ``library_ms``, the port never calls it."""
    import torch
    window = torch.hann_window(cfg.win, device=pred.device)
    leaf = pred.detach().requires_grad_()

    def mag(x):
        s = torch.stft(x, cfg.n_fft, cfg.hop, cfg.win, window=window,
                       center=False, return_complex=True)
        return torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-12)

    mp, mt = mag(leaf), mag(target)
    d = mp - mt
    loss = cfg.lin_w * ((d * d).sum() if cfg.mse else d.abs().sum())
    if cfg.log_w:
        dl = torch.log(mp + cfg.log_eps) - torch.log(mt + cfg.log_eps)
        loss = loss + cfg.log_w * ((dl * dl).sum() if cfg.mse
                                   else dl.abs().sum())
    return torch.autograd.grad(loss, leaf)


def train_attention_bound(q, k, v, ab, dout):
    """(bytes, ops) of one forward and of one backward: inputs read once,
    outputs written once; 4 B H Lq Lk Dh flops forward (two products),
    10 backward (the scores recomputed, dP, dq, dk, dv)."""
    batch, lq, heads, dh = q.shape
    lk = k.shape[1]
    qkv = nbytes(q) + nbytes(k) + nbytes(v)
    work = batch * heads * lq * lk * dh
    fwd = (qkv + nbytes(ab) + nbytes(q), 4 * work)
    bwd = (qkv + nbytes(ab) + nbytes(dout) + qkv + nbytes(ab), 10 * work)
    return fwd, bwd


def sdpa_train_attention(q, k, v, ab, dout):
    """Forward and backward of the same function as library calls
    (``F.scaled_dot_product_attention`` with ``ab`` as a float mask that
    requires grad, broadcast over the batch); timed as ``library_ms``, the
    port never calls it."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_() for t in
              (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), ab)]
    # SDPA takes the mask in the query's dtype
    out = F.scaled_dot_product_attention(
        *leaves[:3], attn_mask=leaves[3][None].to(q.dtype))
    return torch.autograd.grad(out, leaves, dout.transpose(1, 2))


def train_attention_pair(q, k, v, ab, dout):
    """One forward and the backward from its state, as autograd runs them."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    state = ta.train_attention_forward(q, k, v, ab, keep_state=True)
    return ta.train_attention_backward(q, k, v, ab, dout, state)


def plain_train_attention_pair(q, k, v, ab, dout):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    ta.reference_train_attention(q, k, v, ab)
    return ta.reference_train_attention_backward(q, k, v, ab, dout)


def train_attention_pair_bound(args, kwargs):
    """float32 runs as split TF32, three tensor-core products per product:
    its operations count three times at the TF32 rate."""
    fwd, bwd = train_attention_bound(*args)
    passes = 3 if args[0].dtype.itemsize == 4 else 1
    return fwd[0] + bwd[0], passes * (fwd[1] + bwd[1])


def time_calls(torch, fn, calls, reps):
    """Mean ms of running every call once (CUDA events, after a warmup)."""
    def run():
        for args, kwargs in calls:
            fn(*args, **kwargs)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, calls, reps=2):
    """Mean device ms of running every call once: the calls are enqueued
    behind a kernel that sleeps ~50 ms (longer than the host takes to
    enqueue them all), so the card runs them back to back whatever the
    host's pace; CUDA events around them."""
    def run():
        for args, kwargs in calls:
            fn(*args, **kwargs)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, calls):
    """ms the host takes to enqueue every call once: its clock around each
    call, started on an idle card and stopped before any synchronize (one
    call's launches fit the launch queue, so the host never waits for the
    card). A sum near the calls' device time says the host sets the pace."""
    total = 0.0
    for args, kwargs in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3


def step_plans(name, calls):
    """The info (grid, threads, shared memory, registers, spilled bytes,
    barriers a step) of the step plans that ``calls`` of step kernel
    ``name`` use."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_kernel as dst)
    out = {}
    for args, kw in calls:
        mem = args[3] if name == "fused_decode_step" else (args[3], args[3])
        plan = dst.step_plan(
            name, args[0], args[1], args[2], mem, args[4],
            n_class=kw["n_class"], channels=kw["channels"],
            cross_hm=kw.get("cross_hm"), e_src_real=kw.get("e_src_real"),
            temperature=args[11])
        kind = "aligned" if plan.args.aligned else "cross"
        out[f"B{plan.batch} {kind} {str(plan.dtype)[6:]}"] = plan.info
    return out


def kernels_per_call(torch, fn, calls):
    """Per call of ``calls`` (after one warm pass): the launches the
    wrapper counts and the device kernels, by name, in ``torch.profiler``'s
    event list over the same window."""
    from torch.profiler import ProfilerActivity, profile
    for args, kwargs in calls:
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    before = fn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args, kwargs in calls:
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = (re.search(r"\w+<[^>]*>", evt.name)
                   or re.search(r"\w+", evt.name)).group(0)
            counts[key] = counts.get(key, 0) + 1
    return {"launches": (fn.launches - before) / len(calls),
            "profiler_kernels": {key: n / len(calls)
                                 for key, n in counts.items()}}


def nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def prime_bound(args, kwargs):
    """(bytes, ops) one prefix-prime call needs: every input it reads once
    (the bias entries of its causal rows only), the cache rows it writes."""
    params, bias_hm, x_prefix, (mem_k, mem_v), kv = args
    p0, c = kwargs["p0"], kwargs["channels"]
    cross = kwargs["cross_hm"]
    e_src = kwargs["e_src_real"]
    n, l_pad, d = kv.shape[0], kv.shape[-2], kv.shape[-1]
    batch = kv.shape[2] if kv.dim() == 5 else 1
    nh = bias_hm.shape[2]
    d_ff = params["b1"].shape[-1]
    es = params["wqkv"].element_size()
    keys = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "w1", "b1", "w2",
            "b2", "ln") + (("wq_c", "bq_c") if cross is not None else ())
    pairs = p0 * (p0 + 1) // 2
    b = sum(nbytes(params[k]) for k in keys) + batch * p0 * d * es
    b += n * nh * pairs * 4                        # causal bias entries
    b += batch * n * 2 * min(((p0 + 127) // 128) * 128, l_pad) * d * es
    ops = n * (2 * p0 * d * (3 * d + d + d + 2 * d_ff) + 4 * d * pairs)
    if cross is None:
        b += batch * n * ((p0 - 1) // c + 1) * d * es  # mem_v rows gathered
    else:
        b += n * (batch * 2 * e_src * d * es + nh * p0 * e_src * 4)
        ops += n * (2 * p0 * d * d + 4 * p0 * e_src * d)
    return b, batch * ops


def scan_bound(args, kwargs):
    """(bytes, ops) one decode-scan call needs: weights, tables and the
    primed cache read once, the new cache rows and tokens written once, and
    the arithmetic of every step."""
    params, bias_hm, posfull, (mem_k, mem_v), kv, tokens, mask, gumbel = \
        args[:8]
    p0, steps, c = kwargs["p0"], kwargs["steps"], kwargs["channels"]
    cross = kwargs["cross_hm"]
    e_src = kwargs["e_src_real"]
    n, _, d = params["wo"].shape
    nh = bias_hm.shape[2]
    d_ff = params["b1"].shape[-1]
    n_class = params["w_logits"].shape[0]
    es = params["wqkv"].element_size()
    s = steps - p0
    keys = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "w1", "b1", "w2",
            "b2", "ln", "w_logits", "b_logits", "ln_final") + (
        ("wq_c", "bq_c") if cross is not None else ())
    w_bytes = sum(nbytes(params[k]) for k in keys)
    keys_seen = sum(p + 1 for p in range(p0, steps))
    b = w_bytes + 2 * s * d * es                   # emb + posfull rows
    b += n * nh * keys_seen * 4                    # bias entries used
    b += n * 2 * (p0 + s) * d * es                 # cache in (p0) + out (s)
    b += nbytes(gumbel) + nbytes(tokens) * 2 + nbytes(mask)
    per_step = 2 * (n * d * (3 * d + d + d + 2 * d_ff) + d * n_class)
    ops = s * per_step + n * 4 * d * keys_seen
    if cross is None:
        b += n * ((steps - 1) // c - p0 // c + 1) * d * es
    else:
        b += n * (2 * e_src * d * es + nh * s * e_src * 4)
        ops += s * n * (2 * d * d + 4 * e_src * d)
    return b, ops, s * w_bytes


def step_bound(args, kwargs):
    """(bytes, ops) one decode-step call needs: the weights and the bias
    row entries read once, the cache rows < pos of every sequence read
    once, the new K/V rows and tokens written once, and the step's
    arithmetic. Serves both step kernels (the batched one passes mem_v
    alone and has no cross tables)."""
    params, bias_hm, posfull, mem, kv, token_in, cur, pos = args[:8]
    gumbel = args[10]
    cross = kwargs.get("cross_hm")
    n, _, batch, l_pad, d = kv.shape
    nh = bias_hm.shape[2]
    d_ff = params["b1"].shape[-1]
    n_class = params["w_logits"].shape[0]
    es = params["wqkv"].element_size()
    keys = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "w1", "b1", "w2",
            "b2", "ln", "w_logits", "b_logits", "ln_final") + (
        ("wq_c", "bq_c") if cross is not None else ())
    b = sum(nbytes(params[k]) for k in keys)
    b += 2 * batch * d * es                         # emb + posfull rows
    b += n * nh * (pos + 1) * 4                     # bias entries used
    b += n * 2 * batch * (pos + 1) * d * es         # cache in (pos) + out (1)
    b += nbytes(gumbel) + 3 * batch * 4             # noise, tokens in/cur/out
    ops = batch * (2 * (n * d * (3 * d + d + d + 2 * d_ff) + d * n_class)
                   + n * 4 * d * (pos + 1))
    if cross is None:
        b += n * batch * d * es                     # one mem_v row each
    else:
        e_src = kwargs["e_src_real"]
        b += n * (batch * 2 * e_src * d * es + nh * e_src * 4)
        ops += batch * n * (2 * d * d + 4 * e_src * d)
    return b, ops


def flash_bound(args, kwargs):
    """(bytes, ops) one flash-decode call needs: q and the output, the
    pos + 1 K and V rows of every sequence, the bias entries used."""
    q, k_cache, v_cache, pos, bias_row = args
    batch, nh, dh = q.shape
    es = q.element_size()
    b = 2 * batch * nh * dh * es + 2 * batch * (pos + 1) * nh * dh * es
    if bias_row is not None:
        b += nh * (pos + 1) * 4
    return b, 4 * batch * nh * dh * (pos + 1)


def sdpa_decode_attention(q, k_cache, v_cache, pos, bias_row):
    """The same function as one library call (timed as ``library_ms``; the
    port never calls it)."""
    import torch.nn.functional as F
    n = pos + 1
    mask = (None if bias_row is None
            else bias_row[:, :n][None, :, None, :].to(q.dtype))
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k_cache[:, :n].transpose(1, 2),
        v_cache[:, :n].transpose(1, 2), attn_mask=mask)[:, :, 0]


def vq_bound(args, kwargs):
    """(bytes, ops) one VQ lookup needs: flat and embed read once, the four
    outputs written once; the one product, 2 N dim K, three times: the
    kernel runs it as split TF32 on the tensor cores (three passes), held
    against the TF32 rate."""
    flat, embed = args
    n, dim = flat.shape
    k = embed.shape[1]
    return 4 * (2 * n * dim + 2 * dim * k + n + k), 3 * 2 * n * dim * k


def dense_vq_lookup(flat, embed):
    """ids and quantize (not the statistics) as the dense path computes
    them: a composition of library calls, timed as ``library_ms``; the port
    never calls it where the kernel serves."""
    import torch
    import torch.nn.functional as F
    scores = (embed * embed).sum(0)[None] - 2.0 * torch.matmul(flat, embed)
    ids = torch.argmin(scores, dim=1)
    return ids, F.embedding(ids, embed.T)


def spaced(calls, n):
    """``n`` calls evenly spaced over ``calls`` (all when there are fewer)."""
    if len(calls) <= n:
        return list(calls)
    return [calls[(k * len(calls)) // n] for k in range(n)]


# -- the parallel layer ---------------------------------------------------------

# module settings a rehearsal on the CPU changes; the gloo ranks take the
# parent's
SETTINGS = ("DEVICE", "TRAIN_RECORDS", "TRAIN_BATCH", "TRAIN_MODEL_ARGS",
            "VQVAE_TRAIN_NOTES", "VQVAE_VALID_NOTES", "VQVAE_BATCH",
            "NOTE_SECONDS", "VQVAE_FLAGS", "VQVAE_MODEL_ARGS",
            "PARALLEL_STEPS", "PARALLEL_TIMED")


def synchronize(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def kernel_counters():
    """The launch counters of the kernels the parallel paths run."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk, decode_step_batched as dsb,
        decode_step_kernel as dst, prefix_prime_kernel as ppk,
        spectral_loss_kernel as sk, train_attention as ta, vq_lookup as vql)
    return {"train_attention_forward": ta.train_attention_forward,
            "train_attention_backward": ta.train_attention_backward,
            "scale_loss_forward": sk.scale_loss_forward,
            "scale_loss_backward": sk.scale_loss_backward,
            "fused_vq_lookup": vql.fused_vq_lookup,
            "fused_prefix_prime": ppk.fused_prefix_prime,
            "fused_decode_scan": dsk.fused_decode_scan,
            "fused_decode_step": dst.fused_decode_step,
            "fused_decode_step_batched": dsb.fused_decode_step_batched}


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in kernel_counters().items()
            if fn.launches}


def parallel_mains(torch, store, data, flags):
    """Both trainers' ``main`` for a few steps at the flagship width with
    ``flags`` added, deterministic algorithms on: per run the steps' losses
    (kept on the card, read at the end), the weights, the kernels launched
    and the ops PyTorch warned have no deterministic version."""
    import warnings
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        train_prior as tp, train_vqvae as tv)
    runs = {
        "prior f32": (tp, train_args(
            store, "", "bottom", "--num_training_samples",
            str(PARALLEL_STEPS * TRAIN_BATCH), "--disable_writes_to_disk",
            *flags, "--num_devices_model", "1")),
        "prior bf16": (tp, train_args(
            store, "", "bottom", "--num_training_samples",
            str(PARALLEL_STEPS * TRAIN_BATCH), "--disable_writes_to_disk",
            "--bf16", *flags, "--num_devices_model", "1")),
        "vqvae": (tv, vqvae_args(data, "", "--disable_writes_to_disk",
                                 *flags, split="train_small"))}
    losses = []

    def recording(step):
        def wrapped(*args, **kwargs):
            metrics = step(*args, **kwargs)
            losses.append(metrics.get("loss", metrics.get("vqvae_loss"))
                          .detach().clone())
            return metrics
        return wrapped

    make_steps, make_train_step = tp.make_steps, tv.make_train_step
    tp.make_steps = lambda *a, **k: (lambda pair: (
        recording(pair[0]), pair[1]))(make_steps(*a, **k))
    tv.make_train_step = lambda *a, **k: recording(make_train_step(*a, **k))
    deterministic = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, (module, argv) in runs.items():
            losses.clear()
            reset_counters()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                model = module.main(argv)
                synchronize(torch)
            out[name] = {
                "losses": torch.stack(losses).cpu(),
                "state": {k: v.detach().cpu().clone()
                          for k, v in model.state_dict().items()},
                "launches": read_counters(),
                "nondeterministic": sorted({
                    str(w.message).split(" does not have")[0][:80]
                    for w in caught
                    if "deterministic" in str(w.message)})}
            del model
    finally:
        tp.make_steps, tv.make_train_step = make_steps, make_train_step
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
    return out


def parallel_step_times(torch, store, data, mesh):
    """Warm ms of the bottom prior's float32 step and the VQ-VAE step, with
    ``mesh`` (its data group's collectives) or without (None)."""
    out = {}
    gen = torch.Generator().manual_seed(4)
    model, step, batches = step_setup(torch, store, "bottom", mesh=mesh)
    for batch in batches[:2]:
        step(*batch[:3], gen)
    synchronize(torch)
    t0 = time.perf_counter()
    for i in range(PARALLEL_TIMED):
        step(*batches[2 + i % (len(batches) - 2)][:3], gen)
    synchronize(torch)
    out["prior bottom f32"] = (time.perf_counter() - t0) * 1e3 / PARALLEL_TIMED
    del model, step, batches
    model, step, batches = vqvae_step_setup(torch, data, mesh=mesh)
    vgen = torch.Generator(device=DEVICE).manual_seed(4)
    for _ in range(2):
        step(batches[0], vgen)
    synchronize(torch)
    t0 = time.perf_counter()
    for i in range(PARALLEL_TIMED):
        step(batches[i % len(batches)], vgen)
    synchronize(torch)
    out["vqvae spectral_jukebox f32"] = (
        (time.perf_counter() - t0) * 1e3 / PARALLEL_TIMED)
    del model, step, batches
    return out


def whole_grads(model, mesh):
    """Every gradient of a prior, whole (shards gathered), on the host."""
    from interactive_spectrogram_inpainting_tpu_torch.parallel.collectives \
        import all_gather_dim
    dims = getattr(model, "param_dims", {})
    return {name: (all_gather_dim(p.grad, dims[name], mesh.model_group)
                   if mesh is not None and dims.get(name) is not None
                   else p.grad).cpu()
            for name, p in model.named_parameters()}


def parallel_runs(torch, store, data, sampling, mesh_for):
    """The steps and samples ``phase_parallel`` compares: each on the mesh
    ``mesh_for(kind)`` gives (None: one process, the whole batch)."""
    from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh import (
        gather_prior_parameters)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        make_sharded_sampling_fn, sample_model)
    from interactive_spectrogram_inpainting_tpu_torch.utils.checkpoint_io \
        import prior_from_parameters_and_weights
    out = {}
    for name, hier in (("prior data 2", "bottom"), ("prior model 2", "top")):
        mesh = mesh_for(name)
        reset_counters()
        model, step, batches = step_setup(torch, store, hier, mesh=mesh)
        metrics = step(*batches[0][:3], torch.Generator().manual_seed(7))
        synchronize(torch)
        launches = read_counters()
        params = (gather_prior_parameters(model) if mesh is not None
                  else model.state_dict())
        out[name] = {"loss": float(metrics["loss"]),
                     "grads": whole_grads(model, mesh),
                     "params": {k: v.cpu() for k, v in params.items()},
                     "launches": launches,
                     "heads_a_rank": (model.decoder_layers[0].self_attn.q
                                      .weight.shape[0]
                                      // (model.config.d_model
                                          // model.config
                                          .conditional_model_nhead))}
        del model, step, batches
    mesh = mesh_for("vqvae data 2")
    reset_counters()
    model, step, batches = vqvae_step_setup(torch, data, mesh=mesh)
    metrics = step(batches[0], torch.Generator(device=DEVICE).manual_seed(7))
    synchronize(torch)
    out["vqvae data 2"] = {
        "loss": float(metrics["vqvae_loss"]), "launches": read_counters(),
        "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
        "params": {k: v.cpu() for k, v in model.state_dict().items()}}
    del model, step, batches
    model = prior_from_parameters_and_weights(
        sampling["parameters"], sampling["weights"]).to(DEVICE)
    mesh = mesh_for("sampling")
    for rows in (2, 16):
        reset_counters()
        condition = sampling["condition"][:rows]
        initial = sampling["initial"][:rows]
        per = rows // 2
        noise = [torch.zeros(sampling["noise_shape"][per == 1] + (
            model.config.n_class,)) for _ in range(2)]
        if mesh is not None:
            fn = make_sharded_sampling_fn(model, rows, mesh, temperature=1.0,
                                          device=DEVICE)
            codes = fn(None, condition, initial, sampling["mask"], {},
                       gumbels=noise).cpu()
        else:
            codes = torch.cat([sample_model(
                model, None, per, condition=condition[s * per:(s + 1) * per],
                initial_code=initial[s * per:(s + 1) * per],
                mask=sampling["mask"], temperature=1.0, gumbel=noise[s],
                device=DEVICE)
                for s in range(2)]).cpu()
        synchronize(torch)
        out[f"sampling {rows} rows"] = {"codes": codes,
                                        "launches": read_counters()}
    return out


def dropout_draws_ms(torch, batch, reps=10):
    """Device ms of the dropout masks of one bottom prior step at the
    flagship width drawn for ``batch`` rows (float32): 6 encoder layers
    ([B, 129, 512] attention output, [B, 129, 2048] feed-forward) and 8
    decoder layers (two [B, 516, 512], one [B, 516, 2048]). At data 2 a
    rank draws the global batch's (B 32) and keeps its 16 rows."""
    shapes = ([(batch, 129, 512), (batch, 129, 2048)] * 6
              + [(batch, 516, 512)] * 16 + [(batch, 516, 2048)] * 8)
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def draw():
        for shape in shapes:
            torch.empty(shape, device=DEVICE).bernoulli_(0.9, generator=gen)

    draw()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        draw()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gradient_agreement(torch, got, ref, limit):
    """Each leaf's relative gradient difference ``||got - ref|| / ||ref||``
    (float64) -> (ok: every leaf within ``limit``; the largest, and the
    five largest leaves with their one-process gradient's rms and their
    largest absolute difference). A leaf whose gradient is rounding noise
    (the keys' biases: softmax ignores a shift shared by every key) is held
    against a floor instead of its own norm: an rms of 1e-3 of the median
    leaf's."""
    rms = {k: float(v.double().square().mean().sqrt())
           for k, v in ref.items()}
    median = sorted(rms.values())[len(rms) // 2]
    rows = []
    for k, v in ref.items():
        v = v.double()
        diff = got[k].double() - v
        floor = 1e-3 * median * math.sqrt(v.numel())
        rel = float(diff.norm()) / max(float(v.norm()), floor)
        rows.append((rel, k, rms[k], float(diff.abs().max())))
    rows.sort(key=lambda row: row[0], reverse=True)
    return rows[0][0] <= limit, {
        "largest_rel": rows[0][0], "limit": limit, "leaves": len(rows),
        "median_rms": median,
        "worst": [{"leaf": k, "rel": rel, "rms": r, "max_abs_diff": d}
                  for rel, k, r, d in rows[:5]]}


def params_close(torch, got, ref, grads, atol, lr):
    """Weights after one Adam step at two ranks against one process: within
    ``atol``, or within 2 lr where the one-process gradient is within atol
    2e-4 / rtol 2e-3 of 0 (the first Adam step moves a weight by
    lr g / (|g| + eps), about lr sign(g), so a gradient that rounding can
    flip may move it by 2 lr; the gradients themselves are held by
    ``gradient_agreement``); the EMA codebooks within atol 1e-5, rtol
    1e-5. -> (ok, the largest differences and the count of weights that
    took the near-zero allowance)."""
    worst = {"weights": 0.0, "codebooks": 0.0, "codebooks_largest": 0.0}
    near_zero, ok = 0, True
    for k, v in ref.items():
        diff = (got[k].float() - v.float()).abs()
        kind = "weights" if k in grads else "codebooks"
        worst[kind] = max(worst[kind], float(diff.max()))
        if kind == "codebooks":
            # a code's embed_sum adds up to 2 x 16 384 rows at the flagship
            # batch, in another order at two ranks: rtol 1e-5 beside atol
            worst["codebooks_largest"] = max(worst["codebooks_largest"],
                                             float(v.abs().max()))
            ok = ok and torch.allclose(got[k].float(), v.float(), atol=1e-5,
                                       rtol=1e-5)
            continue
        g = grads[k].float().abs()
        flat = g <= 2e-4 + 2e-3 * g
        over = diff > atol
        near_zero += int((over & flat).sum())
        ok = ok and not bool((over & ~flat).any()) and \
            float(diff.max()) <= max(atol, 2 * lr * 1.0001)
    return ok, dict(worst, near_zero_weights_over_atol=near_zero)


def parallel_rank(rank, workdir):
    """One of ``phase_parallel``'s two gloo ranks on the one card."""
    sys.path.insert(0, HERE)
    import torch
    payload = torch.load(os.path.join(workdir, "parallel.pt"),
                         weights_only=False)
    globals().update(payload["settings"])
    from interactive_spectrogram_inpainting_tpu_torch.parallel.distributed \
        import initialize_multihost
    from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh import (
        make_mesh)
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    set_float32_precision()
    initialize_multihost(backend="gloo",
                         init_method=f"file://{workdir}/gloo-rendezvous",
                         world_size=2, rank=rank, device=DEVICE)
    import torch.distributed as dist
    try:
        meshes = {(2, 1): make_mesh(2, 1), (1, 2): make_mesh(1, 2)}
        out = parallel_runs(
            torch, payload["store"], payload["data"], payload["sampling"],
            lambda name: meshes[(1, 2) if "model" in name else (2, 1)])
        if rank:  # rank 0 keeps the whole tensors
            out = {k: {"launches": v["launches"]} for k, v in out.items()}
        torch.save(out, os.path.join(workdir, f"parallel-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_payload(torch, state, workdir):
    """Writes what the two gloo ranks read (``parallel.pt``: the store and
    the notes of ``workdir``, a sampling request of the bottom prior, the
    settings) and returns the sampling request."""
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        scan_range)
    from interactive_spectrogram_inpainting_tpu_torch.utils.checkpoint_io \
        import save_model
    cfg = state.bottom.config
    rng = np.random.default_rng(8)
    mask = np.zeros(cfg.shape, bool)
    mask[:, cfg.shape[1] // 2:] = True
    helper = cfg.target_codemaps_helper()
    masked = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    p0, steps = scan_range(state.bottom, int(masked.min()),
                           int(masked.max()) + 1)
    save_model(workdir, state.bottom, prefix="parallel-bottom")
    sampling = {
        "parameters": os.path.join(workdir,
                                   "parallel-bottom-model_parameters.json"),
        "weights": os.path.join(workdir, "parallel-bottom-weights.msgpack"),
        "condition": rng.integers(0, cfg.n_class,
                                  (16,) + tuple(cfg.condition_shape)),
        "initial": rng.integers(0, cfg.n_class, (16,) + tuple(cfg.shape)),
        "mask": mask,
        "noise_shape": {False: (steps - p0, 8), True: (steps - p0,)}}
    torch.save({"store": os.path.join(workdir, "codes"),
                "data": os.path.join(workdir, "nsynth"), "sampling": sampling,
                "settings": {k: globals()[k] for k in SETTINGS}},
               os.path.join(workdir, "parallel.pt"))
    return sampling


def spawn_ranks(torch, workdir, target=None):
    """Runs ``target`` (``parallel_rank`` by default) as two processes ->
    (both ranks' results, the seconds they took)."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    context = mp.start_processes(target or parallel_rank, args=(workdir,),
                                 nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"the two gloo ranks ran over {PARALLEL_TIMEOUT_S} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
    spawn_s = time.perf_counter() - t0
    return [torch.load(os.path.join(workdir, f"parallel-rank{r}.pt"),
                       weights_only=False) for r in range(2)], spawn_s


def compare_ranks(torch, ranks, one, sampling):
    """The two ranks' steps and tokens against one process's (``one``):
    per run its readings and ``ok``."""
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        train_prior as tp, train_vqvae as tv)
    mask = sampling["mask"]
    report = {}
    for name, ref in one.items():
        got = ranks[0][name]
        launches = [ranks[r][name]["launches"] for r in range(2)]
        entry = {"launches_rank0_rank1": launches}
        if name.startswith("sampling"):
            ok = torch.equal(got["codes"], ref["codes"])
            keep = torch.as_tensor(~mask)
            ok = ok and torch.equal(got["codes"][:, keep],
                                    torch.as_tensor(sampling["initial"][
                                        :got["codes"].shape[0]])[:, keep]
                                    .to(got["codes"].dtype))
            entry["tokens_equal"] = ok
            kernel = ("fused_decode_scan" if "2 rows" in name
                      else "fused_decode_step_batched")
        else:
            vq = name.startswith("vqvae")
            lr = (tv if vq else tp).make_parser().get_default("lr")
            entry["loss"] = (got["loss"], ref["loss"])
            ok = abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
            close, entry["grads"] = gradient_agreement(
                torch, got["grads"], ref["grads"], PARALLEL_GRAD_RTOL[name])
            ok = ok and close
            close, entry["params"] = params_close(
                torch, got["params"], ref["params"], ref["grads"],
                1e-4 if vq else 5e-4, lr)
            ok = ok and close
            kernel = "scale_loss_forward" if vq else "train_attention_forward"
            if name == "prior model 2":
                entry["heads_a_rank"] = got["heads_a_rank"]
                ok = ok and got["heads_a_rank"] == 4
            if vq:
                ok = ok and all(l.get("fused_vq_lookup") for l in launches)
        entry["ok"] = ok and all(l.get(kernel) for l in launches)
        report[name] = entry
    return report


def phase_parallel(torch, state, workdir):
    """The parallel layer on the one card; see the module docstring. Runs
    after the training phases, from the store and the notes they wrote in
    ``workdir``."""
    import torch.distributed as dist
    from interactive_spectrogram_inpainting_tpu_torch.parallel.distributed \
        import initialize_multihost
    from interactive_spectrogram_inpainting_tpu_torch.parallel.mesh import (
        make_mesh)
    t_phase = time.perf_counter()
    store = os.path.join(workdir, "codes")
    data = os.path.join(workdir, "nsynth")
    # a model rank's heads in the training attention: 4 of 8 (d_model 512,
    # the priors' default) and 8 of 16 (the reference's geometry)
    phase_train_attention(torch, state, None, heads=4, head_dim=64)
    phase_train_attention(torch, state, None, heads=8, head_dim=32)

    # NCCL at world size 1, in this process
    plain = parallel_mains(torch, store, data, [])
    if not initialize_multihost(init_method=f"file://{workdir}/nccl",
                                world_size=1, rank=0, device=DEVICE):
        fail("initialize_multihost set up no process group")
    try:
        backend = dist.get_backend()
        grouped = parallel_mains(torch, store, data,
                                 ["--num_devices_data", "1"])
        mesh = make_mesh(1, 1)
        timing = {}
        for label, m in (("none", None), ("nccl", mesh), ("nccl", mesh),
                         ("none", None)):
            for k, ms in parallel_step_times(torch, store, data, m).items():
                timing.setdefault(k, {}).setdefault(label, []).append(
                    round(ms, 3))
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        fail(f"initialize_multihost chose {backend} for CUDA, not nccl")
    for name, run in plain.items():
        other = grouped[name]
        same = torch.equal(run["losses"], other["losses"]) and all(
            torch.equal(v, other["state"][k]) for k, v in run["state"].items())
        log(f"parallel, NCCL world size 1, {name} main ({len(run['losses'])}"
            f" steps): losses {run['losses'].tolist()}; bit for bit against "
            f"no process group: {same}; kernels {other['launches']}; ops "
            f"without a deterministic version: {other['nondeterministic']}")
        if not same:
            fail(f"{name}: the NCCL world-size-1 run differs from the run "
                 "with no process group")
        kernels = (("train_attention_forward", "train_attention_backward")
                   if name.startswith("prior") else
                   ("scale_loss_forward", "scale_loss_backward",
                    "fused_vq_lookup"))
        if not all(other["launches"].get(k) for k in kernels):
            fail(f"{name}: the NCCL run launched {other['launches']}")
    log("parallel, warm step ms with no process group and with the NCCL "
        "world-size-1 data group (gradient and metric all-reduces), "
        f"{PARALLEL_TIMED} steps, none/nccl/nccl/none: " + json.dumps(timing))

    log("parallel, dropout masks of one bottom step (device ms, CUDA "
        "events): drawn for a rank's 16 rows "
        f"{dropout_draws_ms(torch, TRAIN_BATCH // 2):.4f}, for the global "
        f"32 as each rank draws them at data 2 "
        f"{dropout_draws_ms(torch, TRAIN_BATCH):.4f}")

    # two ranks sharing the card over gloo, against one process
    sampling = parallel_payload(torch, state, workdir)
    ranks, spawn_s = spawn_ranks(torch, workdir)
    one = parallel_runs(torch, store, data, sampling, lambda name: None)
    report = compare_ranks(torch, ranks, one, sampling)
    log(f"parallel, two gloo ranks on the card (spawned, {spawn_s:.1f} s) "
        "against one process: " + json.dumps(report, default=float))
    wrong = [name for name, entry in report.items() if not entry["ok"]]
    if wrong:
        fail(f"parallel: {wrong} at two ranks disagree with one process or "
             "launched no kernel")
    log(f"phase_parallel took {time.perf_counter() - t_phase:.1f} s")


def phase_kernels(torch, card, captured, launches, errors, state):
    spectral_launches_main = captured["spectral_launches_main"]
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        build, decode_attention as dat, decode_scan_kernel as dsk,
        decode_step_batched as dsb, decode_step_kernel as dst,
        prefix_prime_kernel as ppk, train_attention as ta, vq_lookup as vql)
    cfg_b = state.bottom.config
    kernels = []
    detail = {}
    # the batched step calls of the last /top-conditioned-sample of each
    # batch bucket (16 and 64): one whole generation each
    generations = {
        bucket: captured["fused_decode_step_batched"][first:end]
        for bucket, (first, end) in captured["batched_generations"].items()}
    # prime and scan: one /timerange-change, its top and bottom call of each
    # kernel. Step kernels: STEPS_TIMED steps evenly spaced over one
    # /top-conditioned-sample generation (batched) and over the two batch-2
    # sample_model calls. Flash attention: 64 calls evenly spaced over the
    # dense sample_model call. VQ lookup: the two lookups of one 4 s
    # /analyze-audio (N = 128, 512) and of one extraction batch (N = 16384,
    # 65536); split TF32 on the tensor cores, so its three passes are held
    # against the TF32 peak. Training attention: one forward
    # and one backward of a float32 decoder self-attention (516 x 516, batch
    # 32) of the bottom prior's epoch, against the same peak.
    vq_calls = captured["fused_vq_lookup"]
    vq_timed = vq_calls[:2] + [
        next(call for call in vq_calls if call[0][0].shape[0] == rows)
        for rows in (128 * state.top.config.shape[0]
                     * state.top.config.shape[1],
                     128 * cfg_b.shape[0] * cfg_b.shape[1])]
    for name, fn, plain, bound, calls, library in (
            ("fused_prefix_prime", ppk.fused_prefix_prime,
             ppk.prefix_prime_plain, prime_bound,
             captured["fused_prefix_prime"][:6][-2:], None),
            ("fused_decode_scan", dsk.fused_decode_scan,
             dsk.decode_scan_plain, scan_bound,
             captured["fused_decode_scan"][:6][-2:], None),
            ("fused_decode_step", dst.fused_decode_step,
             dst.decode_step_plain, step_bound,
             spaced(captured["fused_decode_step"], STEPS_TIMED), None),
            ("fused_decode_step_batched", dsb.fused_decode_step_batched,
             dsb.decode_step_batched_plain, step_bound,
             spaced(generations[16], STEPS_TIMED), None),
            ("flash_decode_attention", dat.flash_decode_attention,
             dat.reference_decode_attention, flash_bound,
             spaced(captured["flash_decode_attention"], 64),
             sdpa_decode_attention),
            ("fused_vq_lookup", vql.fused_vq_lookup, vql.reference_vq_lookup,
             vq_bound, vq_timed, dense_vq_lookup),
            ("fused_train_attention", train_attention_pair,
             plain_train_attention_pair, train_attention_pair_bound,
             [(captured["fused_train_attention"][0], {})],
             sdpa_train_attention),
            ("fused_train_attention_bf16", train_attention_pair,
             plain_train_attention_pair, train_attention_pair_bound,
             [(captured["fused_train_attention_bf16"][0], {})],
             sdpa_train_attention),
            ("fused_multiscale_loss", spectral_pair, plain_spectral_pair,
             spectral_pair_bound, captured["fused_multiscale_loss"],
             stft_spectral_pair)):
        ms = time_calls(torch, fn, calls, reps=10)
        if name == "flash_decode_attention":
            # host-paced (the enqueue takes longer than the kernels): the
            # row's ms is the device's, from a sleeping head start
            host_paced_ms = ms
            ms = device_ms(torch, fn, calls)
        plain_ms = time_calls(torch, plain, calls, reps=1)
        bounds = [bound(*call) for call in calls]
        b = sum(x[0] for x in bounds)
        ops = sum(x[1] for x in bounds)
        # float32 products on the CUDA cores: the spectral loss; the
        # training attention's float32 and the VQ lookup as split TF32 on
        # the tensor cores (their bounds count the three passes)
        peak_ops = (PEAK_F32_OPS if name == "fused_multiscale_loss"
                    else PEAK_TF32_OPS if name in ("fused_train_attention",
                                                   "fused_vq_lookup")
                    else PEAK_BF16_OPS)
        t_bytes, t_ops = b / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
        detail[name] = {"calls_timed": len(calls), "bytes": b, "ops": ops,
                        "host_enqueue_ms": round(host_ms(torch, fn, calls),
                                                 4)}
        if name in ("fused_prefix_prime", "fused_decode_scan"):
            detail[name]["per_call_ms"] = [
                round(time_calls(torch, fn, [call], reps=10), 4)
                for call in calls]
            detail[name]["p0_steps"] = [[kw.get("p0"), kw.get("steps")]
                                        for _, kw in calls]
        if name == "fused_decode_scan":
            stream = sum(x[2] for x in bounds) / PEAK_BYTES_PER_S * 1e3
            detail[name]["weights_streamed_per_step_ms"] = round(stream, 4)
            detail[name]["steps"] = [kw["steps"] - kw["p0"]
                                     for _, kw in calls]
            detail[name]["kernel"] = [
                dsk.decode_scan_info(*args[:9], **kw) for args, kw in calls]
            detail[name]["ptxas_registers"] = ptxas_registers(
                build.PTXAS_LOGS.get("decode_scan", ""), "decode_scan_kernel")
        if name == "fused_prefix_prime":
            detail[name]["kernel"] = [
                ppk.prefix_prime_info(*args, **kw) for args, kw in calls]
            detail[name]["ptxas_registers"] = ptxas_registers(
                build.PTXAS_LOGS.get("prefix_prime", ""),
                "prefix_prime_kernel")
            detail[name]["device_kernels_per_call"] = kernels_per_call(
                torch, fn, calls)
        if name == "flash_decode_attention":
            detail[name]["host_paced_events_ms"] = round(host_paced_ms, 4)
            detail[name]["serving_path_launches"] = 0
            detail[name]["device_kernels_per_call"] = kernels_per_call(
                torch, fn, calls[:8])
            q, k_cache = calls[0][0][:2]
            detail[name]["kernel"] = dat.decode_attention_info(
                q.shape[0], q.shape[1], q.shape[2], k_cache.shape[1],
                k_cache.shape[1] - 1, q.dtype)
            detail[name]["ptxas_registers"] = ptxas_registers(
                build.PTXAS_LOGS.get("decode_attention", ""),
                "flash_decode_kernel")
            detail[name]["dense_flash_sampler_s"] = captured[
                "dense_flash_sampler_s"]
        if name == "fused_decode_step_batched":
            # one whole generation of each bucket: every step of its last
            # request (the keys without a suffix are bucket 16's)
            for bucket, whole in sorted(generations.items()):
                key = "" if bucket == 16 else f"_b{bucket}"
                detail[name][f"generation_steps{key}"] = len(whole)
                detail[name][f"generation_ms{key}"] = round(
                    time_calls(torch, fn, whole, reps=2), 4)
                detail[name][f"generation_bound_ms{key}"] = round(
                    sum(step_bound(*call)[0] for call in whole)
                    / PEAK_BYTES_PER_S * 1e3, 4)
            b64 = spaced(generations[64], STEPS_TIMED)
            detail[name]["ms_b64"] = round(time_calls(torch, fn, b64,
                                                      reps=10), 4)
            detail[name]["host_enqueue_ms_b64"] = round(
                host_ms(torch, fn, b64), 4)
            detail[name]["bound_ms_b64"] = round(
                sum(step_bound(*call)[0] for call in b64)
                / PEAK_BYTES_PER_S * 1e3, 6)
        if name in ("fused_decode_step", "fused_decode_step_batched"):
            # one cooperative launch a step: its grid, barriers, shared
            # memory and registers (the plans of the timed calls), and the
            # device kernels torch.profiler sees in 8 steps
            detail[name]["kernel"] = step_plans(name, calls)
            detail[name]["ptxas_registers"] = ptxas_registers(
                build.PTXAS_LOGS.get(name[6:], ""))
            detail[name]["device_kernels_per_step"] = kernels_per_call(
                torch, fn, calls[:8])
        if name == "fused_decode_step":
            detail[name]["positions"] = [call[0][7] for call in calls]
        if name == "fused_vq_lookup":
            detail[name]["rows"] = [call[0][0].shape[0] for call in calls]
            for key, f in (("per_call_ms", fn), ("per_call_plain_ms", plain),
                           ("per_call_dense_ms", library)):
                detail[name][key] = [
                    round(time_calls(torch, f, [call], reps=10), 4)
                    for call in calls]
            detail[name]["per_call_bound_ms"] = [
                round(max(x[0] / PEAK_BYTES_PER_S, x[1] / peak_ops) * 1e3, 6)
                for x in bounds]
            # the basis before the tensor cores: one float32 pass on the
            # CUDA cores
            detail[name]["cuda_core_bound_ms"] = round(
                sum(max(x[0] / PEAK_BYTES_PER_S, x[1] / 3 / PEAK_F32_OPS)
                    for x in bounds) * 1e3, 6)
            detail[name]["kernel"] = [vql.vq_lookup_info(*call[0])
                                      for call in calls]
            detail[name]["device_kernels_per_call"] = kernels_per_call(
                torch, fn, calls)
        if name.startswith("fused_train_attention"):
            q, k, v, ab, dout = calls[0][0]
            fwd, bwd = train_attention_bound(q, k, v, ab, dout)
            passes = 3 if q.dtype == torch.float32 else 1
            state = ta.train_attention_forward(q, k, v, ab, keep_state=True)
            live = ta.live_tiles(ab)
            detail[name].update({
                "dtype": str(q.dtype)[6:],
                "shape_b_lq_lk_h_dh": [q.shape[0], q.shape[1], k.shape[1],
                                       q.shape[2], q.shape[3]],
                "live_tiles": [int(live.sum()), live.numel()],
                "forward_ms": round(time_calls(
                    torch, ta.train_attention_forward,
                    [((q, k, v, ab), {})], reps=10), 4),
                "backward_ms": round(time_calls(
                    torch, ta.train_attention_backward,
                    [((q, k, v, ab, dout, state), {})], reps=10), 4),
                "forward_bound_ms": round(max(
                    fwd[0] / PEAK_BYTES_PER_S,
                    passes * fwd[1] / peak_ops) * 1e3, 6),
                "backward_bound_ms": round(max(
                    bwd[0] / PEAK_BYTES_PER_S,
                    passes * bwd[1] / peak_ops) * 1e3, 6),
                "launches_per_step_forward_backward": [ATTENTION_CALLS,
                                                       ATTENTION_CALLS]})
            if q.dtype == torch.float32:
                # the same operations on the CUDA cores, the first
                # version's route
                detail[name]["cuda_core_bound_ms"] = round(
                    (fwd[1] + bwd[1]) / PEAK_F32_OPS * 1e3, 6)
            by_kernel, _, _ = profile_kernels(
                torch, lambda: train_attention_pair(q, k, v, ab, dout),
                reps=5)
            detail[name]["profiler_ms_by_kernel"] = {
                (re.search(r"attn_\w+", key) or re.search(r"\w+", key))
                .group(0): round(ms, 4) for key, (ms, _) in by_kernel.items()}
        if name == "fused_multiscale_loss":
            from interactive_spectrogram_inpainting_tpu_torch.ops import (
                spectral_loss_kernel as sk)
            per_scale = []
            for args, _ in calls:
                pred, target, cfg = args
                fwd, bwd = spectral_bound(*args)
                u = sk.scale_loss_forward(pred, target, cfg)[2]
                per_scale.append({
                    "n_fft_hop_win": list(cfg[:3]),
                    "frames": 1 + (pred.shape[1] - cfg.n_fft) // cfg.hop,
                    "forward_ms": round(time_calls(
                        torch, sk.scale_loss_forward, [(args, {})],
                        reps=10), 4),
                    "forward_no_u_ms": round(time_calls(
                        torch, sk.scale_loss_forward,
                        [(args, {"need_u": False})], reps=10), 4),
                    "backward_ms": round(time_calls(
                        torch, sk.scale_loss_backward,
                        [((u, spectral_one(pred), cfg, pred.shape[1]), {})],
                        reps=10), 4),
                    "forward_bound_ms": round(max(
                        fwd[0] / PEAK_BYTES_PER_S, fwd[1] / peak_ops) * 1e3,
                        6),
                    "backward_bound_ms": round(max(
                        bwd[0] / PEAK_BYTES_PER_S, bwd[1] / peak_ops) * 1e3,
                        6),
                    "library_ms": round(time_calls(
                        torch, stft_spectral_pair, [(args, {})], reps=10),
                        4)})
            detail[name]["batch_samples"] = list(calls[0][0][0].shape)
            detail[name]["per_scale"] = per_scale
            detail[name]["launches_forward_backward"] = list(
                spectral_launches_main)
        source, replaces = KERNEL_SOURCES[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errors[name]), "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4),
            "bound_ms": round(max(t_bytes, t_ops), 6),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if library is None else round(
                time_calls(torch, library, calls, reps=10), 4))}
        if name == "fused_multiscale_loss":
            # each half over the timed scales, beside its own bound
            row.update({key: round(sum(x[key] for x in per_scale), 6)
                        for key in ("forward_ms", "backward_ms",
                                    "forward_bound_ms", "backward_bound_ms")})
        kernels.append(row)
    log(f"kernel detail ({card}): " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    torch = setup()
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    set_float32_precision()
    card = phase_build()
    t0 = time.perf_counter()
    state = full_priors(torch, "cuda")
    log(f"full-width test state built in {time.perf_counter() - t0:.1f} s")
    errors = {}
    today = {"prime": phase_prime(torch, state, errors),
             "scan": phase_scan(torch, state, errors),
             "step": phase_step(torch, state, errors)}
    phase_per_row_labels(torch, state)
    today["flash"] = phase_flash(torch, errors)
    today["vq"] = phase_vq(torch, errors)
    phase_train_attention(torch, state, errors)
    phase_spectral_loss(torch, errors)
    ref = prior_state(torch, 512, 16, 2048, base=state, seed=11)
    phase_wide(torch, ref, today)
    captured = {}
    launches = phase_server(torch, state, captured, ref)
    phase_reference_load(torch, state)
    phase_load(torch, state)
    with tempfile.TemporaryDirectory() as workdir:
        phase_cli(torch, state, ref, workdir)
        del ref
        launches["fused_train_attention"] = sum(phase_train(
            torch, state, captured, workdir))
        launches["fused_train_attention_bf16"] = captured[
            "bf16_attention_launches"]
        phase_store_reads(torch, state, workdir)
        launches["fused_multiscale_loss"] = phase_train_vqvae(
            torch, state, captured, workdir)
        phase_examples(torch, state, captured, workdir)
        phase_parallel(torch, state, workdir)
    phase_kernels(torch, card, captured, launches, errors, state)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
