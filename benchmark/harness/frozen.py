"""Frozen copies of the measurement arithmetic the repository already had.

Each function notes the file it came from. They are copied, not imported,
so that a change to the program cannot change the yardstick. Two repairs
against the originals, both named where they apply: ``scan_bound`` keeps
the once-read count only (the original also returned a figure that counts
the weights re-read at every step), and the training attention's work is
the pairs its mask keeps (``train_attention_bound_pairs``), where the
original counted every (query, key) pair.
"""

from __future__ import annotations

import numpy as np


def nbytes(t) -> int:
    """Copied from ``chip_smoke.py::nbytes``."""
    return 0 if t is None else t.numel() * t.element_size()


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit / 1e3.
    Copied from ``chip_smoke.py::union_ms``."""
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
    """Copied from ``chip_smoke.py::percentiles_ms``, without the rounding:
    every reading keeps its digits."""
    if not seconds:
        return None
    return {"n": len(seconds),
            "p50": float(np.percentile(seconds, 50)) * 1e3,
            "p95": float(np.percentile(seconds, 95)) * 1e3,
            "max": max(seconds) * 1e3}


def kernel_family(name: str) -> str:
    """Copied from ``chip_smoke.py::kernel_family``."""
    if name.startswith("void") and "attn_" in name:
        return "training attention kernels"
    lowered = name.lower()
    if any(k in lowered for k in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "cuBLAS products"
    if "optimizer" in lowered or "adam" in lowered or "foreach" in lowered:
        return "optimizer (foreach)"
    return "other (elementwise, reductions, copies)"


def expected_primes(body, ratio_t: int) -> int:
    """Prefix primes a ``/timerange-change`` implies, from its mask alone:
    each prior primes when its mask's first masked column is past column 0
    (the bottom prior's column is the top's times the time ratio; both
    priors scan column by column). Copied from
    ``chip_smoke.py::expected_primes``."""
    columns = np.flatnonzero(np.asarray(body["mask"], bool).any(0))
    if not columns.size:
        return 0
    return int(columns[0] > 0) + int(ratio_t * columns[0] > 0)


def prime_bound(args, kwargs):
    """(bytes, ops) one prefix-prime call needs: every input it reads once
    (the bias entries of its causal rows only), the cache rows it writes.
    Copied from ``chip_smoke.py::prime_bound``."""
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
    the arithmetic of every step. Copied from ``chip_smoke.py::scan_bound``
    with its third figure (the weights re-read at every step) left out: a
    roofline counts each input byte once."""
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
    return b, ops


def train_attention_bound(q, k, v, ab, dout):
    """(bytes, ops) of one forward and of one backward: inputs read once,
    outputs written once; 4 B H Lq Lk Dh flops forward (two products),
    10 backward (the scores recomputed, dP, dq, dk, dv). Copied from
    ``chip_smoke.py::train_attention_bound``; the harness reads it through
    ``train_attention_bound_pairs``, which counts the kept pairs."""
    batch, lq, heads, dh = q.shape
    lk = k.shape[1]
    qkv = nbytes(q) + nbytes(k) + nbytes(v)
    work = batch * heads * lq * lk * dh
    fwd = (qkv + nbytes(ab) + nbytes(q), 4 * work)
    bwd = (qkv + nbytes(ab) + nbytes(dout) + qkv + nbytes(ab), 10 * work)
    return fwd, bwd


def train_attention_bound_pairs(batch, lq, lk, heads, dh, itemsize, pairs):
    """``train_attention_bound`` from shapes alone, with the work of the
    (query, key) pairs the mask keeps (``pairs`` of the ``lq * lk``): the
    kernels skip the tiles a mask empties, and a roofline counts the work
    these inputs need (a causal mask keeps about half, the aligned cross
    attention one key a query). Bytes as in the original: q, k, v and the
    float32 ``ab [H, Lq, Lk]`` read once, each output written once."""
    q = batch * lq * heads * dh * itemsize
    kv = batch * lk * heads * dh * itemsize
    ab = heads * lq * lk * 4
    qkv = q + 2 * kv
    work = batch * heads * pairs * dh
    fwd = (qkv + ab + q, 4 * work)
    bwd = (qkv + ab + q + qkv + ab, 10 * work)
    return fwd, bwd


# The reference's locust mix (``serve/loadtest.py::make_payload`` and
# ``TASKS``, from ``locustfile.py:4-17``), kept for the load cell that
# PERF.md lists under Open questions: image 3, audio 1, inpaint 1 (a
# two-column mask at a random start column), 1-8 s think time.
LOAD_TASKS = (("/get-spectrogram-image", "", 3),
              ("/get-audio", "", 1),
              ("/timerange-change",
               "?layer=top&temperature=1.0&start_index_top=0&pitch=60"
               "&instrument_family_str=keyboard", 1))
LOAD_THINK_S = (1.0, 8.0)


def make_payload(rng, top_shape=(32, 4), bottom_shape=(64, 8), vocab=512,
                 long_factor: int = 1):
    """Copied from ``serve/loadtest.py::make_payload``, drawing from ``rng``
    (a ``numpy.random.Generator``) instead of a fresh unseeded one."""
    mask = np.zeros(top_shape, bool)
    t0 = rng.integers(0, top_shape[1] - 1)
    mask[:, t0:t0 + 2] = True
    t_top = top_shape[1] * long_factor
    t_bottom = bottom_shape[1] * long_factor
    cond = {
        "pitch": [[60] * t_top] * top_shape[0],
        "instrument_family_str": [["keyboard"] * t_top] * top_shape[0],
    }
    cond_b = {
        "pitch": [[60] * t_bottom] * bottom_shape[0],
        "instrument_family_str": [["keyboard"] * t_bottom]
        * bottom_shape[0],
    }
    return {
        "top_code": rng.integers(0, vocab, (top_shape[0], t_top)).tolist(),
        "bottom_code": rng.integers(
            0, vocab, (bottom_shape[0], t_bottom)).tolist(),
        "mask": mask.tolist(),
        "top_conditioning": cond,
        "bottom_conditioning": cond_b,
    }
