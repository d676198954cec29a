#!/usr/bin/env python3
"""Per-phase device time of the decode kernels on one CUDA GPU.

Run from the root of a checkout: ``python3 step_phases.py``. It copies the
step kernels' sources (``interactive_spectrogram_inpainting_tpu_torch/ops/
csrc``) into ``build/step_phases/``, inserts after every grid barrier of the
kernel body a ``%globaltimer`` stamp (block 0, thread 0, into a device
array), builds the two libraries with ``nvcc`` as ``ops/build.py`` does and
loads them in place of the plain builds. Then, on the full-width test
priors in bf16, for bottom B 2, top B 2, bottom B 16 and bottom B 64 (the
server request's mask, a primed cache), it times 32 consecutive steps with
CUDA events and prints the device time of each phase, summed over the
layers, averaged over 8 of those steps:

    A LN1 + qkv | B self attention | C wo (+ wo_c) | D1 LN2 + wq_c
    | D2 cross attention | D3 wo_c | E LN3 + fc1 | F fc2 | G logits | H argmax

``--double-barriers`` adds a second grid barrier after each one, so the
difference per barrier is the cost of one barrier.

``python3 step_phases.py --scan`` does the same for the whole-scan kernel
(``decode_scan.cu``): a stamp after every grid barrier and, where the
kernel has them, every cluster barrier; on the full-width test priors in
bf16, the server request's mask and a primed cache, it runs the top and the
bottom prior's scan and prints each segment between two stamps, summed over
the layers and averaged over the scan's steps. ``--double-cluster-barriers``
adds a second cluster barrier after each one.

``python3 step_phases.py --prime`` times the prefix-prime kernel of the
same request (top and bottom prior, bf16) with CUDA events and lists its
device kernels with ``torch.profiler``: their launches a prefix and device
time by kernel name.

``python3 step_phases.py --vq-flash`` times the VQ lookup and the flash
decode attention with CUDA events as ``chip_smoke.py``'s kernels line does:
the lookup at dim 64, K 512 and the main path's row counts (one call each:
ms, host enqueue ms, each device kernel's launches and device time by
``torch.profiler``);
the flash attention on 64 calls at the dense sampler's shape (bottom prior,
B 2, 8 heads of 64, 640 cached rows, bf16, ``pos`` spread over the cache:
device ms behind a sleeping kernel, host enqueue ms, the device kernels);
and the wall time of the dense sampler (``sample_model`` at B 2,
``top_p`` 0.9, ``use_flash=True``, bf16) on the full-width bottom prior,
the second of two runs.

``python3 step_phases.py --kernel-times`` times, with CUDA events and the
plain builds (no stamps), each decode and encode kernel at the full-width
test priors' shapes in bf16: each prior's whole scan (greedy, from the
primed cache of the server request) and prefix prime, 32 steps of
``fused_decode_step`` at bottom and top B 2 and of the batched kernel at
bottom B 16, 64 flash attention calls (device time) and the VQ lookup at N
8 192 and 65 536 with K 512 and dim 64, 128, 200, 256 and 512; with a
checkout whose ``chip_smoke.py`` has ``prior_state``, also the scan and
the prime of priors with 16 heads (the reference's geometry, the full
models' depth). One JSON line; run it in two checkouts in turns to compare
them on one card.

The stamps go into the kernel
source found beside this script, so a copy of an earlier checkout with this
script dropped into it times that checkout's kernel. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402

CASES = (("bottom", 2), ("top", 2), ("bottom", 16), ("bottom", 64))
STEPS = 32
STAMP = '''
__device__ unsigned long long g_stamps[STAMPS];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define ISI_STAMP()                                                 \\
  do {                                                              \\
    if (blockIdx.x == 0 && threadIdx.x == 0)                        \\
      g_stamps[stamp_i] = globaltimer();                            \\
    ++stamp_i;                                                      \\
  } while (0)
'''
READ = '''
extern "C" int isi_read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, NS g_stamps, n * 8);
}
'''
STAMPS = 1024
SCAN_STAMPS = 65536
# segments of a scan step between stamps, by kernel: the earlier design (a
# grid barrier after each phase) and the clustered one (grid and cluster
# barriers); per layer, aligned and cross, then once a step
SCAN_SEGMENTS = {
    "grid": ((["A qkv", "B attention", "C wo + wo_c", "E fc1", "F fc2"],
              ["A qkv", "B attention", "C wo", "D1 wq_c", "D2 cross",
               "D3 wo_c", "E fc1", "F fc2"]), ["G logits"]),
    "cluster": ((["ATT qkv", "ATT attend", "ATT wo", "MLP fc1 fc2",
                  "MLP reduce"],
                 ["ATT qkv", "ATT attend", "ATT wo", "CROSS wq_c",
                  "CROSS attend", "CROSS wo_c", "MLP fc1 fc2",
                  "MLP reduce"]), ["LOGITS"])}


def compile_stamped(out, name, source):
    """nvcc the stamped copy of library ``name`` as ops/build.py does."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    target = out / f"lib{name}.so"
    proc = subprocess.run(
        [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
         str(out), "-o", str(target), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers.*?(\d+) bytes cumulative "
                      r"stack", proc.stdout + proc.stderr)
    print(f"{name}: registers, stack bytes {regs}", flush=True)
    lib = ctypes.CDLL(str(target))
    build._LIBS[name] = lib
    return lib


def stamped_libraries(double):
    """Build the stamped step libraries; -> {library name: ctypes.CDLL}."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    out = HERE / "build" / "step_phases"
    out.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cu*"):
        shutil.copy(src, out / src.name)
    header = out / "decode_step_persistent.cuh"
    text = header.read_text()
    text = text.replace("namespace cg = cooperative_groups;",
                        "namespace cg = cooperative_groups;"
                        + STAMP.replace("STAMPS", str(STAMPS)), 1)
    start = text.index("decode_step_kernel(const StepParams P)")
    end = text.index("// What the kernel does not take")
    body = text[start:end]
    body = body.replace("cg::grid_group grid = cg::this_grid();",
                        "cg::grid_group grid = cg::this_grid();\n"
                        "  int stamp_i = 0;\n  ISI_STAMP();", 1)
    extra = " cg::this_grid().sync();" if double else ""
    body = body.replace("grid.sync();", "{ grid.sync();" + extra
                        + " ISI_STAMP(); }")
    body = body[:body.rindex("}")] + "  ISI_STAMP();\n}\n\n"
    header.write_text(text[:start] + body + text[end:])
    libs = {}
    for name in ("decode_step", "decode_step_batched"):
        source = out / f"{name}.cu"
        source.write_text(source.read_text() + READ.replace("NS", "isi::"))
        libs[name] = compile_stamped(out, name, source)
    return libs


def stamped_scan(double, double_cluster):
    """Build the stamped scan library; -> (ctypes.CDLL, kernel kind)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import build
    out = HERE / "build" / "step_phases"
    out.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cu*"):
        shutil.copy(src, out / src.name)
    source = out / "decode_scan.cu"
    text = source.read_text()
    kind = "cluster" if "cluster.sync();" in text else "grid"
    text = text.replace("namespace cg = cooperative_groups;",
                        "namespace cg = cooperative_groups;"
                        + STAMP.replace("STAMPS", str(SCAN_STAMPS)), 1)
    start = text.index("decode_scan_kernel(const ScanParams P)")
    body_end = text.index("\n}\n", start) + 1
    body = text[start:body_end]
    body = body.replace("extern __shared__ float4 smem4[];",
                        "extern __shared__ float4 smem4[];\n"
                        "  int stamp_i = 0;\n  ISI_STAMP();", 1)
    extra = " cg::this_grid().sync();" if double else ""
    body = body.replace("grid.sync();", "{ grid.sync();" + extra
                        + " ISI_STAMP(); }")
    extra = " cluster.sync();" if double_cluster else ""
    body = body.replace("cluster.sync();", "{ cluster.sync();" + extra
                        + " ISI_STAMP(); }")
    text = text[:start] + body + text[body_end:]
    source.write_text(text + READ.replace("NS", ""))
    return compile_stamped(out, "decode_scan", source), kind


def scan_main(args, torch):
    """Segment times of the top and the bottom prior's scan."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    lib, kind = stamped_scan(args.double_barriers,
                             args.double_cluster_barriers)
    state = chip_smoke.full_priors(torch, "cuda")
    stamps = (ctypes.c_ulonglong * SCAN_STAMPS)()
    for name, _, inp in chip_smoke.prior_setups(torch, state,
                                                torch.bfloat16):
        kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                                   torch.bfloat16)
        steps = inp["steps"] - inp["p0"]
        noise = torch.zeros(steps, inp["n_class"], device=kv0.device)
        call = ((inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"],
                 kv0.clone(), inp["tokens"], inp["mask"], noise, 1.0),
                dict(p0=inp["p0"], steps=inp["steps"], n_class=inp["n_class"],
                     channels=inp["c"], cross_hm=inp["cross_hm"],
                     e_src_real=inp["e_src"]))
        ms = chip_smoke.time_calls(torch, dsk.fused_decode_scan, [call],
                                   reps=3)
        layers = inp["params"]["wqkv"].shape[0]
        per_layer, once = SCAN_SEGMENTS[kind]
        labels = per_layer[inp["cross_hm"] is not None] * layers + once
        per_step = len(labels)
        if 1 + steps * per_step > SCAN_STAMPS:
            sys.exit("too many stamps for the stamp array")
        dsk.fused_decode_scan(*call[0], **call[1])
        torch.cuda.synchronize()
        lib.isi_read_stamps(stamps, 1 + steps * per_step)
        sums = dict.fromkeys(dict.fromkeys(labels), 0.0)
        for k in range(steps * per_step):
            sums[labels[k % per_step]] += (stamps[k + 1] - stamps[k]) / 1e3
        print(f"scan {name} ({kind} kernel) steps [{inp['p0']}, "
              f"{inp['steps']}): {ms / steps * 1e3:.1f} us a step (CUDA "
              f"events); by segment (stamps, us a step): "
              + ", ".join(f"{k} {v / steps:.1f}" for k, v in sums.items())
              + f"; sum {sum(sums.values()) / steps:.1f}", flush=True)


def prime_main(torch):
    """CUDA-event ms and the profiler's kernels of one prefix prime."""
    from torch.profiler import ProfilerActivity, profile
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    state = chip_smoke.full_priors(torch, "cuda")
    for name, _, inp in chip_smoke.prior_setups(torch, state,
                                                torch.bfloat16):
        kv = torch.zeros(inp["kv_shape"], dtype=torch.bfloat16,
                         device="cuda")
        call = ((inp["params"], inp["bias_hm"], inp["x_prefix"], inp["mem"],
                 kv), dict(p0=inp["p0"], channels=inp["c"],
                           cross_hm=inp["cross_hm"], e_src_real=inp["e_src"]))
        ms = chip_smoke.time_calls(torch, fused_prefix_prime, [call],
                                   reps=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_prefix_prime(*call[0], **call[1])
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                kernel = re.sub(r"^void |\(anonymous namespace\)::", "",
                                evt.name)
                key = re.match(r"(?:\w+::)*(\w+)", kernel).group(1)
                n, t = kernels.get(key, (0, 0.0))
                kernels[key] = (n + 1, t + evt.device_time_total / 1e3)
        print(f"prime {name} p0={inp['p0']}: {ms:.4f} ms (CUDA events); "
              f"{sum(n for n, _ in kernels.values())} device kernels: "
              + ", ".join(f"{k} x{n} {t:.4f} ms"
                          for k, (n, t) in sorted(kernels.items())),
              flush=True)


VQ_ROWS = (128, 512, 8192, 16384, 32768, 65536)


def kernel_split(torch, fn, calls, reps=10):
    """{kernel: [launches a call recorded, us a launch]} over ``reps``
    passes of ``calls`` by ``torch.profiler`` (which may drop launches:
    the wrapper's count is the one to trust)."""
    from torch.profiler import ProfilerActivity, profile
    for args in calls:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args in calls:
                fn(*args)
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", evt.name)
            key = re.match(r"(?:\w+::)*(\w+(?:<[^>]*>)?)", name).group(1)
            n, t = kernels.get(key, (0, 0.0))
            kernels[key] = (n + 1, t + evt.device_time_total)
    return {k: [round(n / reps / len(calls), 2), round(t / n, 2)]
            for k, (n, t) in kernels.items()}


def vq_flash_main(torch):
    """Device and host ms of the VQ lookup and the flash attention, their
    device kernels a call, and the dense flash sampler's wall time."""
    import time
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention \
        import flash_decode_attention
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        sample_model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    embed = torch.randn(64, 512, generator=gen, device="cuda")
    for n in VQ_ROWS:
        calls = [((torch.randn(n, 64, generator=gen, device="cuda"), embed),
                  {})]
        ms = chip_smoke.time_calls(torch, fused_vq_lookup, calls, reps=20)
        host = chip_smoke.host_ms(torch, fused_vq_lookup, calls)
        split = kernel_split(torch, fused_vq_lookup, [c[0] for c in calls])
        print(f"vq_lookup N={n}: {ms:.4f} ms (CUDA events), host enqueue "
              f"{host:.4f} ms, device kernels [recorded a call, us a "
              f"launch] {split}", flush=True)
    heads, dh, length, batch = 8, 64, 640, 2
    q = torch.randn(batch, heads, dh, generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn(batch, length, heads, dh, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    bias = torch.randn(heads, length, generator=gen, device="cuda")
    calls = [((q, k, v, (j * (length - 1)) // 63, bias), {})
             for j in range(64)]
    ms = chip_smoke.device_ms(torch, flash_decode_attention, calls)
    paced = chip_smoke.time_calls(torch, flash_decode_attention, calls,
                                  reps=10)
    host = chip_smoke.host_ms(torch, flash_decode_attention, calls)
    split = kernel_split(torch, flash_decode_attention,
                         [c[0] for c in calls], reps=2)
    print(f"flash_decode_attention 64 calls: device {ms:.4f} ms, host-paced "
          f"CUDA events {paced:.4f} ms, host enqueue {host:.4f} ms, device "
          f"kernels [recorded a call, us a launch] {split}", flush=True)
    state = chip_smoke.full_priors(torch, "cuda")
    cfg_t = state.top.config
    tops = np.random.default_rng(5).integers(
        0, cfg_t.n_class, (2,) + tuple(cfg_t.shape))
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_model(state.bottom, state.next_rng(), 2, condition=tops,
                     top_p_sampling_p=0.9, use_flash=True,
                     use_fused_step=False,
                     compute_dtype=torch.bfloat16).cpu()
        wall = time.perf_counter() - t0
    print(f"dense sampler, bottom prior B=2, top_p 0.9, use_flash, bf16: "
          f"{wall:.3f} s wall (second run)", flush=True)


def kernel_times(torch, state):
    """{kernel case: ms} of the decode and encode kernels on ``state``'s
    priors (CUDA events, warm)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsc, decode_step_batched as dsb,
        decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    out = {}
    for name, _, inp in chip_smoke.prior_setups(torch, state,
                                                torch.bfloat16):
        kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                                   torch.bfloat16)
        noise = torch.zeros(inp["steps"] - inp["p0"], inp["n_class"],
                            device=kv0.device)
        call = ((inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"],
                 kv0.clone(), inp["tokens"], inp["mask"], noise, 1.0),
                dict(p0=inp["p0"], steps=inp["steps"], n_class=inp["n_class"],
                     channels=inp["c"], cross_hm=inp["cross_hm"],
                     e_src_real=inp["e_src"]))
        out[f"scan {name}"] = chip_smoke.time_calls(
            torch, dsc.fused_decode_scan, [call], reps=5)
        kv = torch.zeros(inp["kv_shape"], dtype=torch.bfloat16,
                         device="cuda")
        call = ((inp["params"], inp["bias_hm"], inp["x_prefix"], inp["mem"],
                 kv), dict(p0=inp["p0"], channels=inp["c"],
                           cross_hm=inp["cross_hm"], e_src_real=inp["e_src"]))
        out[f"prime {name}"] = chip_smoke.time_calls(
            torch, fused_prefix_prime, [call], reps=10)
    return out


# the VQ lookup's widths: the models' 64, the widths between 64 and 256
# (split TF32 from a row tile in shared memory, or 64 dims at a time), 512
VQ_DIMS = (64, 128, 200, 256, 512)


def kernel_times_main(torch):
    """Warm CUDA-event ms of each kernel at today's shapes (and the 16-head
    scan and prime where this checkout builds such priors)."""
    import json
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention \
        import flash_decode_attention
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    state = chip_smoke.full_priors(torch, "cuda")
    out = kernel_times(torch, state)
    for prior, batch in (("bottom", 2), ("top", 2), ("bottom", 16)):
        inp = chip_smoke.batch_setup(torch, state, prior, batch,
                                     torch.bfloat16)
        kv = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                                  torch.bfloat16)
        batched = prior == "bottom" and batch > dsk.MAX_SMALL_BATCH
        fn = dsb.fused_decode_step_batched if batched \
            else dsk.fused_decode_step
        out[f"{fn.__name__} {prior} B={batch}, {STEPS} steps"] = \
            chip_smoke.time_calls(torch, fn, step_calls(inp, kv, batched),
                                  reps=3)
    gen = torch.Generator(device="cuda").manual_seed(2)
    heads, dh, length, batch = 8, 64, 640, 2
    q = torch.randn(batch, heads, dh, generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn(batch, length, heads, dh, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    bias = torch.randn(heads, length, generator=gen, device="cuda")
    out["flash 64 calls (device)"] = chip_smoke.device_ms(
        torch, flash_decode_attention,
        [((q, k, v, (j * (length - 1)) // 63, bias), {}) for j in range(64)])
    for dim in VQ_DIMS:
        embed = torch.randn(dim, 512, generator=gen, device="cuda")
        for n in (8192, 65536):
            out[f"vq dim {dim} N={n}"] = chip_smoke.time_calls(
                torch, fused_vq_lookup,
                [((torch.randn(n, dim, generator=gen, device="cuda"), embed),
                  {})], reps=20)
    if hasattr(chip_smoke, "prior_state"):
        del state
        torch.cuda.empty_cache()
        ref = chip_smoke.prior_state(torch, 512, 16, 2048)
        out.update({f"{k} (16 heads)": v
                    for k, v in kernel_times(torch, ref).items()})
    print("kernel times, ms: " + json.dumps(
        {k: round(v, 4) for k, v in out.items()}), flush=True)


def step_calls(inp, kv, batched):
    """The wrapper calls of STEPS consecutive steps from p0 (greedy noise),
    as the batch samplers' token loop makes them."""
    import torch
    tokens_t = inp["tokens"].t().contiguous()
    c, p0, length = inp["c"], inp["p0"], tokens_t.shape[0]
    batch = tokens_t.shape[1]
    start = torch.full((batch, 1), inp["n_class"], dtype=torch.int32,
                       device=kv.device)
    gumbel = torch.zeros(STEPS, batch, inp["n_class"], device=kv.device)
    mem = inp["mem"][1] if batched else inp["mem"]
    kw = dict(n_class=inp["n_class"], channels=c)
    if not batched:
        kw.update(cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])
    mask = inp["mask"].cpu().tolist()
    calls = []
    for p in range(p0, p0 + STEPS):
        i = p - (c - 1)
        i_clip = min(max(i, 0), length - 1)
        token_in = start if p < c else tokens_t[p - c][:, None]
        cur = tokens_t[i_clip][:, None]
        calls.append(((inp["params"], inp["bias_hm"], inp["posfull"], mem, kv,
                       token_in, cur, p, i, mask[i_clip], gumbel[p - p0],
                       1.0), dict(kw, out=cur)))
    return calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--double-barriers", action="store_true",
                        help="a second grid barrier after each one")
    parser.add_argument("--double-cluster-barriers", action="store_true",
                        help="a second cluster barrier after each one "
                        "(--scan)")
    parser.add_argument("--scan", action="store_true",
                        help="the whole-scan kernel instead of the step "
                        "kernels")
    parser.add_argument("--prime", action="store_true",
                        help="the prefix-prime kernel's launches and time")
    parser.add_argument("--vq-flash", action="store_true",
                        help="the VQ lookup's and the flash attention's "
                        "times and launches")
    parser.add_argument("--kernel-times", action="store_true",
                        help="each kernel's ms at today's shapes, plain "
                        "builds")
    args = parser.parse_args()
    torch = chip_smoke.setup()
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    from interactive_spectrogram_inpainting_tpu_torch.utils.device import (
        set_float32_precision)
    set_float32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    if args.scan:
        scan_main(args, torch)
        return
    if args.prime:
        prime_main(torch)
        return
    if args.vq_flash:
        vq_flash_main(torch)
        return
    if args.kernel_times:
        kernel_times_main(torch)
        return
    libs = stamped_libraries(args.double_barriers)
    state = chip_smoke.full_priors(torch, "cuda")
    for prior, batch in CASES:
        inp = chip_smoke.batch_setup(torch, state, prior, batch,
                                     torch.bfloat16)
        kv = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                                  torch.bfloat16)
        batched = prior == "bottom" and batch > dsk.MAX_SMALL_BATCH
        fn = dsb.fused_decode_step_batched if batched \
            else dsk.fused_decode_step
        lib = libs["decode_step_batched" if batched else "decode_step"]
        calls = step_calls(inp, kv, batched)
        ms = chip_smoke.time_calls(torch, fn, calls, reps=3)
        layers = inp["params"]["wqkv"].shape[0]
        phases = ((["A", "B", "C", "E", "F"] if inp["cross_hm"] is None
                   else ["A", "B", "C", "D1", "D2", "D3", "E", "F"])
                  * layers + ["G", "H"])
        sums = dict.fromkeys(dict.fromkeys(phases), 0.0)
        timed = calls[::4]
        stamps = (ctypes.c_ulonglong * 1024)()
        for call_args, kwargs in timed:
            fn(*call_args, **kwargs)
            torch.cuda.synchronize()
            lib.isi_read_stamps(stamps, len(phases) + 1)
            for k, name in enumerate(phases):
                sums[name] += (stamps[k + 1] - stamps[k]) / 1e3 / len(timed)
        print(f"{prior} B={batch} p0={inp['p0']}: {ms / STEPS * 1e3:.1f} us "
              f"a step (CUDA events, {STEPS} steps); by phase (stamps, us a "
              f"step): " + ", ".join(f"{k} {v:.1f}" for k, v in sums.items())
              + f"; sum {sum(sums.values()):.1f}", flush=True)


if __name__ == "__main__":
    main()
