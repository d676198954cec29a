#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX.
Phases, each failing the run with a nonzero exit:

1. print the card (``nvidia-smi`` name and power limit), build the kernels
   from ``interactive_spectrogram_inpainting_tpu_torch/ops/csrc``;
2. prefix-prime: the kernel against its plain PyTorch version at the full
   priors' width (top prior: relative-bias cross attention; bottom prior:
   aligned), in float32 and in bfloat16;
3. decode-scan: the kernel against its plain version at full width:
   teacher-forced (mask all False: the final caches agree, the tokens are
   unchanged), greedy top prior in float32 (the token streams are equal),
   and bfloat16 with Gumbel noise (tokens in range, unmasked unchanged);
4. server: the port's server with the full-width test models on the card,
   on localhost: three ``/timerange-change`` (``layer=top``, the last two
   of the four top columns masked, so both priors are primed), then three
   ``/get-audio``; both kernels' launch counters must grow; the first
   request of each kind is cold (it builds the decode tables, plans the
   FFT and picks the convolution algorithms);
5. a ``{"kernels": [...]}`` line: each kernel's main-path launches, its
   error against the plain version, its time and the plain version's time
   on the requests' shapes, and its bound on this card.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "interactive_spectrogram_inpainting_tpu_torch"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_OPS = 989e12       # H100 SXM dense bf16 tensor-core rate
KERNEL_SOURCES = {
    "fused_prefix_prime": (
        f"{PKG}/ops/csrc/prefix_prime.cu",
        "interactive_spectrogram_inpainting_tpu/ops/prefix_prime_kernel.py:279"),
    "fused_decode_scan": (
        f"{PKG}/ops/csrc/decode_scan.cu",
        "interactive_spectrogram_inpainting_tpu/ops/decode_scan_kernel.py:349"),
}


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
    return make_test_state("full", device=device, seed=0)


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
    """The kernels' inputs for one prior, as sample_model builds them."""
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
    with torch.no_grad():
        codemap_t = torch.as_tensor(codemap, device=dev)[None]
        cond_t = torch.as_tensor(condition, device=dev)[None]
        mask_t = torch.as_tensor(mask, device=dev)
        src_mask = (mask_t[None] if cfg.self_conditional_model else None)
        src = model.prepare_sequence(
            src_helper.to_sequence(cond_t), "source",
            mask=None if src_mask is None else src_helper.to_sequence(
                src_mask))
        memory = model.encode_source(src)
        tokens = helper.to_sequence(codemap_t)[0].to(torch.int32)
        mask_seq = helper.to_sequence(mask_t[None])[0].contiguous()
        params = decode_state["params"]
        posfull = tables.precompute_position_features(
            model, model._start_block("target", {}, 1),
            model._positional_sequence("target"), dtype=dtype)
        mem_k, mem_v = tables.precompute_mem_values(model, memory.to(dtype))
        e_src = mem_v.shape[2]
        e_pad = tables._round_up(e_src, 128)
        mem = (F.pad(mem_k[:, 0], (0, 0, 0, e_pad - e_src)),
               F.pad(mem_v[:, 0], (0, 0, 0, e_pad - e_src)))
        p0, steps = scan_range(model, scan_from, scan_until)
        with_start = torch.cat([torch.full((c,), cfg.n_class, device=dev,
                                           dtype=torch.long),
                                tokens.long()])
        x_prefix = (params["emb_padded"][with_start[:p0]].float()
                    + posfull[:p0].float()).to(dtype)
    return dict(params=params, bias_hm=decode_state["bias_hm"],
                cross_hm=decode_state["cross_hm"], posfull=posfull, mem=mem,
                e_src=e_src, tokens=tokens, mask=mask_seq, p0=p0,
                steps=steps, x_prefix=x_prefix, c=c,
                n_class=cfg.n_class_target,
                kv_shape=(cfg.conditional_model_num_decoder_layers, 2,
                          decode_state["bias_hm"].shape[3], cfg.d_model))


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
    seconds = build.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}"
        f" total {time.perf_counter() - t0:.2f} s")
    return card


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_prime(torch, state, results):
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime, prefix_prime_plain
    # float32: the algorithm, at the JAX package's decode-step tolerance;
    # bfloat16: the serving dtype, where the two versions round the same
    # values at the same places but sum in other orders
    tol = {torch.float32: (3e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
    for dtype in (torch.float32, torch.bfloat16):
        for name, model, inp in prior_setups(torch, state, dtype):
            kv_k = run_prime(torch, fused_prefix_prime, inp, dtype)
            kv_p = run_prime(torch, prefix_prime_plain, inp, dtype)
            torch.cuda.synchronize()
            p0 = inp["p0"]
            p_pad = min(((p0 + 127) // 128) * 128, inp["kv_shape"][2])
            err = max_err(kv_k[:, :, :p0], kv_p[:, :, :p0])
            atol, rtol = tol[dtype]
            ok = torch.allclose(kv_k[:, :, :p0].float(),
                                kv_p[:, :, :p0].float(), atol=atol, rtol=rtol)
            zero = bool((kv_k[:, :, p0:p_pad] == 0).all())
            log(f"prefix_prime {name} {str(dtype)[6:]} p0={p0}: max_abs_err "
                f"{err:.3e} (atol {atol}, rtol {rtol}) rows[p0,P_pad) zero "
                f"{zero}")
            if not (ok and zero and torch.isfinite(kv_k).all()):
                fail(f"prefix_prime {name} {dtype} disagrees with the plain "
                     "version")
            if dtype == torch.bfloat16:
                results.setdefault("fused_prefix_prime", []).append(err)


def phase_scan(torch, state, results):
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
        import decode_scan_plain, fused_decode_scan
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import fused_prefix_prime
    from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
        gumbel_noise)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for name, model, inp in prior_setups(torch, state, dtype):
            dev = inp["tokens"].device
            kv0 = run_prime(torch, fused_prefix_prime, inp, dtype)
            n = inp["steps"] - inp["p0"]
            noise = gumbel_noise((n, inp["n_class"]), dev, gen)
            tag = f"{name} {str(dtype)[6:]} steps [{inp['p0']}, " \
                  f"{inp['steps']})"
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
                log(f"decode_scan {tag} teacher-forced: cache max_abs_err "
                    f"{err:.3e} (atol 5e-2, rtol 5e-2), tokens unchanged "
                    f"{same}")
                if not (ok and same):
                    fail(f"decode_scan {name} teacher-forced disagrees")
                results.setdefault("fused_decode_scan", []).append(err)
                # bf16 with noise: in range, unmasked cells unchanged
                tk, _ = run_scan(torch, fused_decode_scan, inp, kv0,
                                 inp["mask"], noise)
                torch.cuda.synchronize()
                keep = ~inp["mask"]
                in_range = bool(((tk >= 0) & (tk < inp["n_class"])).all())
                kept = bool((tk[keep] == inp["tokens"][keep]).all())
                changed = int((tk != inp["tokens"]).sum())
                log(f"decode_scan {tag} sampled: in range {in_range}, "
                    f"unmasked unchanged {kept}, {changed} cells changed")
                if not (in_range and kept and changed > 0):
                    fail(f"decode_scan {name} bf16 sampling is wrong")
            elif name == "top":
                # greedy float32: the token streams must be equal
                zeros = torch.zeros_like(noise)
                tk, _ = run_scan(torch, fused_decode_scan, inp, kv0,
                                 inp["mask"], zeros)
                tp, _ = run_scan(torch, decode_scan_plain, inp, kv0,
                                 inp["mask"], zeros)
                torch.cuda.synchronize()
                diff = int((tk != tp).sum())
                log(f"decode_scan {tag} greedy: {diff} tokens differ")
                if diff:
                    fail("decode_scan greedy float32 token streams differ")


def post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        status, ctype = r.status, r.headers["Content-Type"]
    return status, ctype, data, (time.perf_counter() - t0) * 1e3


def phase_server(torch, state, captured):
    import numpy as np
    from interactive_spectrogram_inpainting_tpu_torch.data.wav import read_wav
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk, prefix_prime_kernel as ppk)
    from interactive_spectrogram_inpainting_tpu_torch.sampling import sample
    from interactive_spectrogram_inpainting_tpu_torch.serve import server

    def capture(name, fn):
        def wrapped(*args, **kwargs):
            captured.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    # record the main path's kernel calls to time them on the same inputs
    sample.fused_prefix_prime = capture("fused_prefix_prime",
                                        ppk.fused_prefix_prime)
    sample.fused_decode_scan = capture("fused_decode_scan",
                                       dsk.fused_decode_scan)
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
    ppk.fused_prefix_prime.launches = 0
    dsk.fused_decode_scan.launches = 0
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
        launches = {"fused_prefix_prime": ppk.fused_prefix_prime.launches,
                    "fused_decode_scan": dsk.fused_decode_scan.launches}
        for _ in range(3):
            status, ctype, wav_bytes, ms = post(
                base + "/get-audio", {"top_code": new_top.tolist(),
                                      "bottom_code": new_bottom.tolist()})
            latencies.append(ms)
            if status != 200 or ctype != "audio/wav":
                fail(f"/get-audio returned {status} {ctype}")
    finally:
        http.shutdown()
        http.server_close()
        sample.fused_prefix_prime = ppk.fused_prefix_prime
        sample.fused_decode_scan = dsk.fused_decode_scan
    audio, sr = read_wav(io.BytesIO(wav_bytes))
    expected = state.helper.num_samples(
        cfg_t.shape[1] * state.vqvae.config.total_resolution_factor)
    if sr != state.fs_hz or audio.shape[-1] != expected \
            or not np.isfinite(audio).all():
        fail(f"/get-audio wav: rate {sr}, {audio.shape[-1]} samples "
             f"(expected {expected})")
    log("server latency ms: " + json.dumps({
        "timerange_change": [round(x, 3) for x in latencies[:3]],
        "get_audio": [round(x, 3) for x in latencies[3:]]}))
    log(f"server launches per 3 requests: {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    return launches


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


def nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def prime_bound(args, kwargs):
    """(bytes, ops) one prefix-prime call needs: every input it reads once
    (the bias entries of its causal rows only), the cache rows it writes."""
    params, bias_hm, x_prefix, (mem_k, mem_v), kv = args
    p0, c = kwargs["p0"], kwargs["channels"]
    cross = kwargs["cross_hm"]
    e_src = kwargs["e_src_real"]
    n, _, l_pad, d = kv.shape
    nh = bias_hm.shape[2]
    d_ff = params["b1"].shape[-1]
    es = params["wqkv"].element_size()
    keys = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "w1", "b1", "w2",
            "b2", "ln") + (("wq_c", "bq_c") if cross is not None else ())
    pairs = p0 * (p0 + 1) // 2
    b = sum(nbytes(params[k]) for k in keys) + p0 * d * es
    b += n * nh * pairs * 4                        # causal bias entries
    b += n * 2 * min(((p0 + 127) // 128) * 128, l_pad) * d * es  # cache out
    ops = n * (2 * p0 * d * (3 * d + d + d + 2 * d_ff) + 4 * d * pairs)
    if cross is None:
        b += n * ((p0 - 1) // c + 1) * d * es      # mem_v rows gathered
    else:
        b += n * (2 * e_src * d * es + nh * p0 * e_src * 4)
        ops += n * (2 * p0 * d * d + 4 * p0 * e_src * d)
    return b, ops


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


def phase_kernels(torch, card, captured, launches, errors):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk, prefix_prime_kernel as ppk)
    # one /timerange-change: its top and bottom call of each kernel
    kernels = []
    detail = {}
    for name, fn, plain, bound in (
            ("fused_prefix_prime", ppk.fused_prefix_prime,
             ppk.prefix_prime_plain, prime_bound),
            ("fused_decode_scan", dsk.fused_decode_scan,
             dsk.decode_scan_plain, scan_bound)):
        calls = captured[name][-2:]
        ms = time_calls(torch, fn, calls, reps=10)
        plain_ms = time_calls(torch, plain, calls, reps=1)
        per_call = [time_calls(torch, fn, [call], reps=10) for call in calls]
        bounds = [bound(*call) for call in calls]
        b = sum(x[0] for x in bounds)
        ops = sum(x[1] for x in bounds)
        t_bytes, t_ops = b / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_OPS * 1e3
        detail[name] = {
            "per_call_ms": [round(x, 4) for x in per_call],
            "p0_steps": [[kw.get("p0"), kw.get("steps")] for _, kw in calls],
            "bytes": b, "ops": ops}
        if name == "fused_decode_scan":
            stream = sum(x[2] for x in bounds) / PEAK_BYTES_PER_S * 1e3
            detail[name]["weights_streamed_per_step_ms"] = round(stream, 4)
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errors[name]), "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4),
            "bound_ms": round(max(t_bytes, t_ops), 6),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    log("kernel detail (one /timerange-change, top then bottom call; "
        f"{card}): " + json.dumps(detail))
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
    phase_prime(torch, state, errors)
    phase_scan(torch, state, errors)
    captured = {}
    launches = phase_server(torch, state, captured)
    phase_kernels(torch, card, captured, launches, errors)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
