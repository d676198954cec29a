#!/usr/bin/env python3
"""Per-phase device time of the two decode-step kernels on one CUDA GPU.

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
difference per barrier is the cost of one barrier. Imports nothing of JAX.
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
__device__ unsigned long long g_stamps[1024];
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
  return (int)cudaMemcpyFromSymbol(out, isi::g_stamps, n * 8);
}
'''


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
                        "namespace cg = cooperative_groups;" + STAMP, 1)
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
        source.write_text(source.read_text() + READ)
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
        libs[name] = ctypes.CDLL(str(target))
        build._LIBS[name] = libs[name]
    return libs


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
