"""Inputs from the seed: the edit loop's mask decks, labels, first codes and
Gumbel noise, and the training store, repeat exactly from a seed."""

import json

import numpy as np
import torch

from bench_support import BENCH, DATA
from drivers import train_steps
from harness import edits, serve_child
from harness.seeds import derive
from harness.weights import make_parameters
from reference import prior as ref_prior

SERVE = json.loads((BENCH / "configs" / "notono-serve-ref16.json")
                   .read_text())
BIG_SEED = 2 ** 31 + 12345


def plan_inputs(seed, n):
    plan = edits.Plan(SERVE, seed)
    return ([plan.cols(k) for k in range(n)],
            [plan.label(k) for k in range(n)], plan.top, plan.bottom)


def test_plan_repeats_from_a_seed():
    a, b = plan_inputs(BIG_SEED, 57), plan_inputs(BIG_SEED, 57)
    assert a[0] == b[0] and a[1] == b[1]
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    c = plan_inputs(BIG_SEED + 1, 57)
    assert a[0] != c[0]


def test_decks_deal_every_range_once():
    cols, _, _, _ = plan_inputs(BIG_SEED, 40)
    ranges = edits.column_ranges(4)
    assert len(ranges) == 10
    for deck in range(4):
        assert sorted(cols[10 * deck:10 * deck + 10]) == sorted(ranges)
    widths = [b - a for a, b in cols]
    assert [widths.count(w) for w in (1, 2, 3, 4)] == [16, 12, 8, 4]
    assert sum(a > 0 for a, _ in ranges) == 6


def test_noise_repeats_and_differs_by_edit_and_prior():
    dev = torch.device("cpu")
    a = serve_child.edit_noise(SERVE, BIG_SEED, "bottom", 7, dev)
    b = serve_child.edit_noise(SERVE, BIG_SEED, "bottom", 7, dev)
    assert a.shape == (64 * 8 + 4 - 1, 512)
    assert torch.equal(a, b)
    assert not torch.equal(a, serve_child.edit_noise(SERVE, BIG_SEED,
                                                     "bottom", 8, dev))
    top = serve_child.edit_noise(SERVE, BIG_SEED, "top", 7, dev)
    assert top.shape == (32 * 4, 512)


def test_parameters_repeat_and_follow_the_spec():
    cfg = json.loads((DATA / "tiny-serve.json").read_text())
    spec = ref_prior.parameter_spec(ref_prior.Geometry(cfg["top_prior"]))
    a = make_parameters(spec, derive(BIG_SEED, "w"), "cpu")
    b = make_parameters(spec, derive(BIG_SEED, "w"), "cpu")
    assert list(a) == [name for name, _, _ in spec]
    assert all(torch.equal(a[k], b[k]) for k in a)
    for name, shape, init in spec:
        assert tuple(a[name].shape) == tuple(shape)
        if init[0] == "zeros":
            assert not a[name].any()
        if init[0] == "normal" and a[name].numel() > 1000:
            assert abs(float(a[name].std()) / init[1] - 1) < 0.1


def test_store_repeats_from_a_seed(tmp_path):
    cfg = json.loads((DATA / "tiny-train.json").read_text())
    mix = {"records": 16}
    a = train_steps.write_store(cfg, mix, BIG_SEED, str(tmp_path / "a"))
    b = train_steps.write_store(cfg, mix, BIG_SEED, str(tmp_path / "b"))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert ((tmp_path / "a" / "codes.bin").read_bytes()
            == (tmp_path / "b" / "codes.bin").read_bytes())


def test_derive_separates_tags_and_takes_large_seeds():
    assert derive(BIG_SEED, "a") != derive(BIG_SEED, "b")
    assert derive(BIG_SEED, "a", 1) != derive(BIG_SEED, "a", 2)
    assert 0 <= derive(2 ** 40, "x") < 2 ** 63
