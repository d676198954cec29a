"""The step kernels' per-generation plan (``ops/decode_step_kernel.py::
StepPlan``) on the CPU: built once per generation and reused by its steps,
rebuilt when a fixed tensor changes, and the per-step fields following each
call's arguments. Torch only; tiny widths."""

import dataclasses

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    transformer as tt)
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    decode_step_batched as dsb, decode_step_kernel as dsk)
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    precompute_decode_state, sample_model, scan_range)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)


def tiny_prior(aligned=True):
    cfg = tt.TransformerConfig(
        shape=(8, 4), n_class=16, d_model=32, embeddings_dim=8,
        positional_embeddings_dim=8, dropout=0.0, condition_shape=(4, 2),
        conditional_model_num_encoder_layers=2,
        conditional_model_num_decoder_layers=2, conditional_model_nhead=4,
        d_ff=64)
    model = (tt.UpsamplingVQTransformer(
        dataclasses.replace(cfg, use_aligned_decoder=True)) if aligned
        else tt.SelfAttentiveVQTransformer(cfg))
    return init_like_flax(model, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def aligned():
    return tiny_prior(True)


def step_args(model, batch, dtype=torch.float32):
    """The step kernels' fixed tensors for ``batch`` sequences."""
    cfg = model.config
    state = precompute_decode_state(model, compute_dtype=dtype)
    params = state["params"]
    posfull = dsk.precompute_position_features(
        model, model._start_block("target", {}, batch),
        model._positional_sequence("target"), dtype=dtype)
    n, d = cfg.conditional_model_num_decoder_layers, cfg.d_model
    l_pad = state["bias_hm"].shape[3]
    mem_v = torch.zeros(n, batch, 128, d, dtype=dtype)
    kv = torch.zeros(n, 2, batch, l_pad, d, dtype=dtype)
    return dict(params=params, bias_hm=state["bias_hm"], posfull=posfull,
                mem_kv=(mem_v, mem_v), kv=kv, n_class=cfg.n_class,
                channels=cfg.target_num_channels)


def plan_for(args, **kw):
    return dsk.step_plan("fused_decode_step", args["params"],
                         args["bias_hm"], args["posfull"], args["mem_kv"],
                         args["kv"], n_class=args["n_class"],
                         channels=args["channels"], **kw)


@pytest.mark.parametrize("batch", [2, 6])
def test_plan_is_built_once_per_generation(aligned, batch):
    """One ``sample_model`` call builds one plan (the small-batch kernel's
    at 2, the batched kernel's at 6) and every step reuses it; a second
    call builds its own."""
    cfg = aligned.config
    rng = np.random.default_rng(0)
    condition = rng.integers(0, cfg.n_class,
                             (batch,) + tuple(cfg.condition_shape))
    p0, steps = scan_range(aligned, None, None)
    gumbel = torch.zeros(steps - p0, batch, cfg.n_class)
    kernel = dsb.fused_decode_step_batched if batch > 4 \
        else dsk.fused_decode_step
    calls = []
    original = dsk.StepPlan.bind

    def bind(self, *args, **kwargs):
        calls.append(self)
        return original(self, *args, **kwargs)

    dsk.StepPlan.bind = bind
    try:
        for _ in range(2):
            before = dsk.StepPlan.builds
            n_calls = len(calls)
            sample_model(aligned, None, batch, condition=condition,
                         gumbel=gumbel, device="cpu")
            assert dsk.StepPlan.builds == before + 1
            mine = calls[n_calls:]
            assert len(mine) == steps - p0 > 1
            assert all(plan is mine[0] for plan in mine)
            assert mine[0].kernel == kernel.__name__
            assert mine[0].device.type == "cpu" and not mine[0].scratch
    finally:
        dsk.StepPlan.bind = original
    assert calls[0] is not calls[-1]


def test_another_kv_dtype_or_temperature_builds_a_new_plan(aligned):
    args = step_args(aligned, 2)
    plan = plan_for(args)
    assert plan_for(args) is plan
    builds = dsk.StepPlan.builds
    other = dict(args, kv=args["kv"].clone())
    assert plan_for(other) is not plan
    assert plan_for(args, temperature=0.5) is not plan
    bf16 = step_args(aligned, 2, torch.bfloat16)
    assert plan_for(bf16).dtype == torch.bfloat16
    assert dsk.StepPlan.builds == builds + 3
    # the cache keeps the most recent plans and finds the first one again
    assert plan_for(args) is plan
    assert dsk.StepPlan.builds == builds + 3


def test_plan_holds_its_fixed_tensors_weakly(aligned):
    args = step_args(aligned, 2)
    plan = plan_for(args)
    ref = plan._refs[-2][0]  # kv
    assert ref() is args["kv"]
    kv_shape = args["kv"].shape
    del args["kv"]
    assert ref() is None
    again = dict(args, kv=torch.zeros(kv_shape))
    assert plan_for(again) is not plan


def test_plan_checks_the_fixed_tensors_once(aligned):
    args = step_args(aligned, 2)
    bad = dict(args, posfull=args["posfull"][:1])
    with pytest.raises(ValueError, match="posfull"):
        plan_for(bad)
    wrong = dict(args, kv=args["kv"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        plan_for(wrong)
    strided = dict(args, bias_hm=args["bias_hm"].transpose(2, 3))
    with pytest.raises(ValueError):
        plan_for(strided)


def test_plan_per_call_fields_follow_the_arguments(aligned):
    args = step_args(aligned, 2)
    plan = plan_for(args)
    n_class = args["n_class"]
    tokens = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    gumbel = torch.zeros(3, 2, n_class)
    for pos, i_index, masked, take in ((5, 2, True, 1), (6, 3, False, 0),
                                       (2, -1, True, 0)):
        token_in, cur = tokens[0][:, None], tokens[pos % 3 + 1][:, None]
        out = plan.bind(token_in, cur, pos, i_index, masked,
                        gumbel[pos % 3], out=cur)
        assert out is cur
        a = plan.args
        assert (a.pos, a.take) == (pos, take)
        assert a.token_in == token_in.data_ptr()
        assert a.cur_token == a.token_out == cur.data_ptr()
        assert a.gumbel == gumbel[pos % 3].data_ptr()
    fresh = plan.bind(tokens[0][:, None], tokens[1][:, None], 1, 0, True,
                      gumbel[0])
    assert fresh.shape == (2, 1) and fresh.dtype == torch.int32
    assert plan.args.token_out == fresh.data_ptr()
    with pytest.raises(ValueError, match="dtype"):
        plan.bind(tokens[0][:, None].long(), tokens[1][:, None], 1, 0, True,
                  gumbel[0])
    with pytest.raises(ValueError, match="shape"):
        plan.bind(torch.zeros(3, 1, dtype=torch.int32), tokens[1][:, None], 1,
                  0, True, gumbel[0])
    with pytest.raises(ValueError, match="contiguous"):
        plan.bind(tokens[0][:, None], tokens[1][:, None], 1, 0, True,
                  torch.zeros(n_class, 2).T)
    with pytest.raises(ValueError, match="outside"):
        plan.bind(tokens[0][:, None], tokens[1][:, None], 10 ** 6, 0, True,
                  gumbel[0])
    with pytest.raises(ValueError, match="only on CUDA"):
        plan.launch()


def test_wrapper_on_the_cpu_runs_the_plain_version(aligned):
    """The CPU path binds the plan and then runs the plain version: the
    same tokens and cache as calling the plain version directly."""
    args = step_args(aligned, 2)
    rng = np.random.default_rng(3)
    gumbel = torch.as_tensor(rng.gumbel(size=(2, args["n_class"]))
                             .astype(np.float32))
    start = torch.full((2, 1), args["n_class"], dtype=torch.int32)
    kw = dict(n_class=args["n_class"], channels=args["channels"])
    launches = dsk.fused_decode_step.launches
    results = []
    for fn in (dsk.fused_decode_step, dsk.decode_step_plain):
        kv = args["kv"].clone()
        cur = torch.full((2, 1), 3, dtype=torch.int32)
        tok, kv = fn(args["params"], args["bias_hm"], args["posfull"],
                     args["mem_kv"], kv, start, cur, args["channels"] - 1, 0,
                     True, gumbel, 0.8, out=cur, **kw)
        assert tok is cur
        results.append((tok.clone(), kv))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])
    assert dsk.fused_decode_step.launches == launches
