"""Operations, bytes and shares on hand-worked shapes."""

import json

import pytest
import torch

from bench_support import BENCH, DATA
from drivers import train_steps
from harness import edit_check, flops, frozen, peaks
from reference.prior import Geometry


def load_reader(name):
    import run
    return run.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def decode_params(n, d, d_ff, n_class, dtype=torch.bfloat16):
    return {"wqkv": t(n, 3 * d, d, dtype=dtype), "bqkv": t(n, 3 * d),
            "wo": t(n, d, d, dtype=dtype), "bo": t(n, d),
            "wo_c": t(n, d, d, dtype=dtype), "bo_c": t(n, d),
            "w1": t(n, d_ff, d, dtype=dtype), "b1": t(n, d_ff),
            "w2": t(n, d, d_ff, dtype=dtype), "b2": t(n, d),
            "ln": t(n, 6, d), "w_logits": t(n_class, d, dtype=dtype),
            "b_logits": t(n_class), "ln_final": t(2, d)}


def test_scan_bound_by_hand():
    n, d, d_ff, v, nh = 1, 4, 8, 3, 2
    params = decode_params(n, d, d_ff, v)
    bias = t(n, 8, nh, 8)
    tokens, mask = t(6, dtype=torch.int32), t(6, dtype=torch.bool)
    gumbel = t(2, v)
    args = (params, bias, t(8, d), (t(n, 8, d), t(n, 8, d)), None, tokens,
            mask, gumbel)
    b, ops = frozen.scan_bound(args, {"p0": 3, "steps": 5, "channels": 1,
                                      "cross_hm": None, "e_src_real": 2})
    w = sum(frozen.nbytes(params[k]) for k in params)
    # 2 steps (positions 3 and 4); keys seen 4 + 5; cache rows 3 in + 2
    # out; one mem_v row an event, events 3 and 4
    assert b == (w + 2 * 2 * d * 2 + n * nh * 9 * 4 + n * 2 * 5 * d * 2
                 + 2 * v * 4 + 6 * 4 * 2 + 6 + n * 2 * d * 2)
    assert ops == 2 * 2 * (n * d * (5 * d + 2 * d_ff) + d * v) \
        + n * 4 * d * 9


def test_prime_bound_by_hand():
    n, d, d_ff, nh = 2, 4, 8, 2
    params = decode_params(n, d, d_ff, 3)
    kv = t(n, 2, 128, d, dtype=torch.bfloat16)
    args = (params, t(n, 8, nh, 128), t(1, 3, d), (t(n, 8, d), t(n, 8, d)),
            kv)
    b, ops = frozen.prime_bound(args, {"p0": 3, "channels": 1,
                                       "cross_hm": None, "e_src_real": 2})
    keys = ("wqkv", "bqkv", "wo", "bo", "wo_c", "bo_c", "w1", "b1", "w2",
            "b2", "ln")
    w = sum(frozen.nbytes(params[k]) for k in keys)
    assert b == (w + 3 * d * 2 + n * nh * 6 * 4 + n * 2 * 128 * d * 2
                 + n * 3 * d * 2)
    assert ops == n * (2 * 3 * d * (5 * d + 2 * d_ff) + 4 * d * 6)


def test_train_attention_pairs_matches_the_frozen_bound_when_full():
    q = t(2, 5, 3, 4)
    k = t(2, 7, 3, 4)
    ab = t(3, 5, 7)
    full = frozen.train_attention_bound(q, k, k, ab, q)
    pairs = frozen.train_attention_bound_pairs(2, 5, 7, 3, 4, 4, 35)
    assert full == pairs
    half = frozen.train_attention_bound_pairs(2, 5, 5, 3, 4, 4, 15)
    assert half[0][1] == 4 * 2 * 3 * 15 * 4


def test_pairs_by_mask():
    assert flops.attention_pairs(4, 4, "causal") == 10
    assert flops.attention_pairs(6, 3, "aligned") == 6
    assert flops.attention_pairs(4, 3, "full") == 12


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 989e12, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 165e12, "float32") == pytest.approx(1.0)
    assert peaks.PEAK_OPS["float32"] == pytest.approx(495e12 / 3)


def test_union_and_percentiles():
    assert frozen.union_ms([(0, 2000), (1000, 3000), (5000, 6000)]) == 4.0
    p = frozen.percentiles_ms([0.1] * 19 + [0.3])
    assert p["p50"] == pytest.approx(100.0) and p["max"] == pytest.approx(
        300.0)


def test_expected_primes():
    mask = [[False, True, True, False]] * 2
    assert frozen.expected_primes({"mask": mask}, 2) == 2
    assert frozen.expected_primes({"mask": [[True] * 4] * 2}, 2) == 0


def test_kernel_family():
    assert frozen.kernel_family("void attn_fwd<float, 32>(P)") \
        == "training attention kernels"
    assert frozen.kernel_family("sm90_xmma_gemm_f32f32") == "cuBLAS products"


def test_encoder_ops_by_hand():
    g = Geometry(json.loads((DATA / "tiny-train.json").read_text())
                 ["bottom_prior"])
    n = g.l_s + 1
    per_layer = 2 * n * g.d * (4 * g.d + 2 * g.d_ff) + 4 * g.d * n * n
    assert flops.encoder_ops(g) == g.n_enc * per_layer \
        + 2 * g.l_s * g.emb * g.eff


def test_scan_window_and_edit_ops():
    cfg = json.loads((BENCH / "configs" / "notono-serve-ref16.json")
                     .read_text())
    g = Geometry(cfg["bottom_prior"])
    assert flops.scan_window(g, 0, 511) == (0, 515)
    assert flops.scan_window(g, 128, 255) == (131, 259)
    whole, _ = edit_check.edit_ops(cfg, (0, 4))
    one, _ = edit_check.edit_ops(cfg, (0, 1))
    assert whole > 3 * one


def test_readers_on_hand_worked_data():
    calls = [(1e-3, 3.35e9, 0), (1e-3, 0, 989e9 * 0.5)]
    share = load_reader("scan_roofline_pct").read({"scan_calls": calls})
    assert share == pytest.approx(75.0)
    assert load_reader("prime_roofline_pct").read({"prime_calls": []}) \
        is None
    mfu = load_reader("edit_mfu_pct").read(
        {"ops": {"bf16": 989e12, "float32": 165e12}, "window_s": 4.0})
    assert mfu == pytest.approx(50.0)
    trace = {"window_s": 2.0, "busy_s": 0.5,
             "family_s": {"cuBLAS products": 0.3,
                          "training attention kernels": 0.2}}
    idle = load_reader("device_idle_pct.train").read({"trace": trace})
    assert idle == pytest.approx(75.0)
    # the trace covers 3 steps after the window; the window ran 6 in 2 s
    data = {"trace": trace, "traced_steps": 3, "steps": 6,
            "attention_bound_s": 0.01, "step_ops": 165e12 * 0.1,
            "window_s": 2.0}
    assert load_reader("gemm_ms.train").read(data) == pytest.approx(100.0)
    assert load_reader("train_attention_roofline_pct").read(data) \
        == pytest.approx(15.0)
    assert load_reader("train_mfu_pct").read(data) == pytest.approx(30.0)
    assert load_reader("http_ms.edit").read({"http_s": [0.001, 0.003,
                                                         0.002]}) \
        == pytest.approx(2.0)


def test_attention_bound_counts_every_call():
    g = Geometry(json.loads((BENCH / "configs" / "bottom-prior-train-ref16"
                             ".json").read_text())["bottom_prior"])
    total = train_steps.attention_bound_s(g, 32)
    one_self = sum(peaks.least_seconds(b, o, "float32") for b, o in
                   frozen.train_attention_bound_pairs(
                       32, 516, 516, 16, 32, 4, 516 * 517 // 2))
    assert total > g.n_dec * one_self
