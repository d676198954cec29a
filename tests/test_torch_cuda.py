"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a CUDA device and skips
where there is none (as in the CPU test run). They hold the kernels at
small widths (d_model 32, 4 heads of 8, d_ff 64, 16 classes) and at the
widened geometries of ``WIDE`` on the same small codemaps; the full
widths are held by ``chip_smoke.py``. Torch only, so they run on a machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    transformer as tt)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention import (
    flash_decode_attention, reference_decode_attention)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel import (
    decode_scan_plain, fused_decode_scan)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_step_batched \
    import decode_step_batched_plain, fused_decode_step_batched
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_step_kernel \
    import decode_step_plain, fused_decode_step
from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
    import fused_prefix_prime, prefix_prime_plain
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    gumbel_noise, precompute_decode_state, sample_model, scan_range)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tiny_prior(variant, **widths):
    """The small prior (``widths`` override d_model, heads, d_ff)."""
    base = tt.TransformerConfig(
        shape=(8, 4), n_class=16, d_model=32, embeddings_dim=8,
        positional_embeddings_dim=8, dropout=0.0, condition_shape=(4, 2),
        conditional_model_num_encoder_layers=2,
        conditional_model_num_decoder_layers=2, conditional_model_nhead=4,
        d_ff=64)
    base = dataclasses.replace(base, **widths)
    if variant == "aligned":
        model = tt.UpsamplingVQTransformer(
            dataclasses.replace(base, use_aligned_decoder=True))
    else:
        model = tt.SelfAttentiveVQTransformer(base)
    return init_like_flax(model, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module", params=["aligned", "cross"])
def prior(request, device):
    return prior_case(tiny_prior(request.param).to(device))


def prior_case(model):
    """(model, codemap, condition, mask): a two-column inpaint."""
    cfg = model.config
    rng = np.random.default_rng(1)
    codemap = rng.integers(0, cfg.n_class, cfg.shape)
    condition = rng.integers(0, cfg.n_class, cfg.condition_shape)
    mask = np.zeros(cfg.shape, bool)
    mask[:, 1:3] = True
    return model, codemap, condition, mask


def inputs(model, codemap, condition, mask, dtype):
    """The kernels' arguments as sample_model builds them."""
    import chip_smoke
    helper = model.config.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    state = precompute_decode_state(model, compute_dtype=dtype)
    return chip_smoke.scan_inputs(torch, model, state, codemap, condition,
                                  mask, int(nz.min()), int(nz.max()) + 1,
                                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_prime_kernel_matches_plain(prior, dtype):
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, dtype)
    kv_k = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    kv_p = chip_smoke.run_prime(torch, prefix_prime_plain, inp, dtype)
    torch.cuda.synchronize()
    p0 = inp["p0"]
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kv_k[:, :, :p0].float(),
                               kv_p[:, :, :p0].float(), atol=tol, rtol=tol)
    assert (kv_k[:, :, p0:] == 0).all()


def test_decode_scan_kernel_matches_plain(prior):
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, torch.float32)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, torch.float32)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    noise = gumbel_noise((n, inp["n_class"]), kv0.device, gen)
    for gumbel in (noise, torch.zeros_like(noise)):
        tk, kvk = chip_smoke.run_scan(torch, fused_decode_scan, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        torch.cuda.synchronize()
        assert torch.equal(tk, tp)
        torch.testing.assert_close(kvk, kvp, atol=3e-4, rtol=1e-3)
    assert fused_decode_scan.launches > 0


def scan_call(inp, kv, mask, gumbel, temperature=1.0, **over):
    kwargs = dict(p0=inp["p0"], steps=inp["steps"], n_class=inp["n_class"],
                  channels=inp["c"], cross_hm=inp["cross_hm"],
                  e_src_real=inp["e_src"])
    kwargs.update(over)
    return fused_decode_scan(
        inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"],
        None if kv is None else kv.clone(), inp["tokens"], mask, gumbel,
        temperature, **kwargs)


def test_decode_scan_primed_and_bounded_runs_match(prior):
    """float32, greedy: a primed scan equals one from position 0 (the known
    prefix teacher-forced), and a scan bounded by the mask equals one run
    to the end (the rest unmasked, its tokens unchanged)."""
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, torch.float32)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, torch.float32)
    p0, steps, c = inp["p0"], inp["steps"], inp["c"]
    dev = kv0.device
    zeros = torch.zeros(steps - p0, inp["n_class"], device=dev)
    tk, kvk = scan_call(inp, kv0, inp["mask"], zeros)
    t0, kv_0 = scan_call(inp, None, inp["mask"],
                         torch.zeros(steps, inp["n_class"], device=dev), p0=0)
    full = inp["tokens"].shape[0] + c - 1
    tf, kvf = scan_call(inp, kv0, inp["mask"],
                        torch.zeros(full - p0, inp["n_class"], device=dev),
                        steps=full)
    torch.cuda.synchronize()
    assert torch.equal(tk, t0) and torch.equal(tk, tf)
    torch.testing.assert_close(kv_0, kvk, atol=3e-4, rtol=1e-3)
    torch.testing.assert_close(kvf[:, :, :steps], kvk[:, :, :steps],
                               atol=3e-4, rtol=1e-3)


def test_decode_scan_bf16_repeats_and_holds_to_plain(prior):
    """bfloat16: two runs give the same tokens and cache bit for bit; the
    teacher-forced cache is within 5e-2 of the plain version."""
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, torch.bfloat16)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                               torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = gumbel_noise((inp["steps"] - inp["p0"], inp["n_class"]),
                         kv0.device, gen)
    t1, k1 = scan_call(inp, kv0, inp["mask"], noise)
    t2, k2 = scan_call(inp, kv0, inp["mask"], noise)
    none = torch.zeros_like(inp["mask"])
    tk, kvk = scan_call(inp, kv0, none, noise)
    tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0, none,
                                  noise)
    torch.cuda.synchronize()
    assert torch.equal(t1, t2) and torch.equal(k1, k2)
    assert torch.equal(tk, tp) and torch.equal(tk, inp["tokens"])
    torch.testing.assert_close(kvk.float(), kvp.float(), atol=5e-2,
                               rtol=5e-2)


def test_decode_scan_launch_shape(prior):
    """One cooperative launch a scan, in clusters of 8: 2 grid barriers a
    step per aligned layer, 3 per cross layer, plus 1."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
        import decode_scan_info
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, torch.bfloat16)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                               torch.bfloat16)
    noise = torch.zeros(inp["steps"] - inp["p0"], inp["n_class"],
                        device=kv0.device)
    info = decode_scan_info(
        inp["params"], inp["bias_hm"], inp["posfull"], inp["mem"], kv0,
        inp["tokens"], inp["mask"], noise, 1.0, p0=inp["p0"],
        steps=inp["steps"], n_class=inp["n_class"], channels=inp["c"],
        cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])
    layers = inp["params"]["wo"].shape[0]
    per_layer = 2 if inp["cross_hm"] is None else 3
    assert info["grid_barriers_per_step"] == per_layer * layers + 1
    assert info["cluster"] == 8 and info["grid"] == 120
    assert info["clusters_resident"] >= 15
    before = fused_decode_scan.launches
    scan_call(inp, kv0, inp["mask"], noise)
    assert fused_decode_scan.launches == before + 1


def test_decode_scan_one_head_a_cluster_is_not_grouped(prior):
    """Up to 15 heads a cluster takes one head: the 4-head priors report
    one head side by side and leave the grouped counter as it was."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
        import decode_scan_info
    import chip_smoke
    inp = inputs(*prior, torch.bfloat16)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                               torch.bfloat16)
    noise = torch.zeros(inp["steps"] - inp["p0"], inp["n_class"],
                        device=kv0.device)
    info = chip_smoke.scan_info(inp, kv0, noise)
    assert info["heads_side_by_side"] == 1 and info["general_kernel"] == 0
    grouped = fused_decode_scan.grouped_launches
    scan_call(inp, kv0, inp["mask"], noise)
    assert fused_decode_scan.grouped_launches == grouped


# the reference's 16 heads at the small priors' other widths (head_dim 8):
# 8 clusters of 2 heads side by side
@pytest.fixture(scope="module", params=["aligned", "cross"])
def prior16(request, device):
    return prior_case(tiny_prior(request.param, d_model=128,
                                 conditional_model_nhead=16).to(device))


def test_decode_scan_side_by_side_matches_plain(prior16):
    """float32, with noise and greedy: the grouped kernel's tokens equal
    the plain version's, its cache within 3e-4 / 1e-3."""
    import chip_smoke
    inp = inputs(*prior16, torch.float32)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, torch.float32)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    noise = gumbel_noise((n, inp["n_class"]), kv0.device, gen)
    grouped = fused_decode_scan.grouped_launches
    for gumbel in (noise, torch.zeros_like(noise)):
        tk, kvk = chip_smoke.run_scan(torch, fused_decode_scan, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        torch.cuda.synchronize()
        assert torch.equal(tk, tp)
        torch.testing.assert_close(kvk, kvp, atol=3e-4, rtol=1e-3)
    assert fused_decode_scan.grouped_launches == grouped + 2


def test_decode_scan_side_by_side_bf16_repeats_and_holds_to_plain(prior16):
    """bfloat16, grouped: two runs give the same tokens and cache bit for
    bit; the teacher-forced cache is within 5e-2 of the plain version."""
    import chip_smoke
    inp = inputs(*prior16, torch.bfloat16)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                               torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = gumbel_noise((inp["steps"] - inp["p0"], inp["n_class"]),
                         kv0.device, gen)
    t1, k1 = scan_call(inp, kv0, inp["mask"], noise)
    t2, k2 = scan_call(inp, kv0, inp["mask"], noise)
    none = torch.zeros_like(inp["mask"])
    tk, kvk = scan_call(inp, kv0, none, noise)
    tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0, none,
                                  noise)
    torch.cuda.synchronize()
    assert torch.equal(t1, t2) and torch.equal(k1, k2)
    assert torch.equal(tk, tp) and torch.equal(tk, inp["tokens"])
    torch.testing.assert_close(kvk.float(), kvp.float(), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_scan_side_by_side_launch_shape(prior16, dtype):
    """16 heads: 2 heads side by side in a cluster, not the general kernel,
    the launch shape and grid barriers of one head a cluster; each call
    one launch, counted as grouped."""
    import chip_smoke
    inp = inputs(*prior16, dtype)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    noise = torch.zeros(inp["steps"] - inp["p0"], inp["n_class"],
                        device=kv0.device)
    info = chip_smoke.scan_info(inp, kv0, noise)
    layers = inp["params"]["wo"].shape[0]
    per_layer = 2 if inp["cross_hm"] is None else 3
    assert info["heads_side_by_side"] == 2 and info["general_kernel"] == 0
    assert info["grid_barriers_per_step"] == per_layer * layers + 1
    assert info["cluster"] == 8 and info["grid"] == 120
    assert info["clusters_resident"] >= 15
    assert info["staged_regions"] == (3 if per_layer == 2 else 15) | 4
    launches = fused_decode_scan.launches
    grouped = fused_decode_scan.grouped_launches
    for k in range(1, 3):
        scan_call(inp, kv0, inp["mask"], noise)
        assert fused_decode_scan.launches == launches + k
        assert fused_decode_scan.grouped_launches == grouped + k


def test_scan_heads_side_by_side_is_the_kernels_rule(device):
    """Over a sweep of head counts and widths, the kernel's choice
    (``isi_decode_scan_heads``) is ``heads_side_by_side``'s where the
    grouped layout fits shared memory and one head otherwise; at the
    reference's geometry (d_model 512, 16 heads, d_ff 2048) it is 2 in
    both dtypes, aligned at the bottom prior's cache and cross at the
    top prior's."""
    import ctypes
    import itertools
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        build, decode_scan_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.common import (
        DTYPE_CODES)
    lib = build.load("decode_scan")
    grouped = in_series = 0
    for d, heads, d_ff, l_pad, cross, dtype in itertools.product(
            (128, 256, 512, 768, 1024, 2048), (4, 8, 15, 16, 24, 32, 64),
            (64, 2048, 8192), (128, 640), (False, True),
            (torch.float32, torch.bfloat16)):
        if d % heads or (d // heads) % dsk.CLUSTER or \
                d // heads > dsk.SCAN_DH_MAX:
            continue
        params = dsk._ScanParams(
            n_layers=2, d=d, d_ff=d_ff, n_heads=heads, n_class=512,
            l_pad=l_pad, e_pad=256, steps_pad=l_pad, length=l_pad - 1,
            channels=2, p0=0, steps=l_pad, e_src=129 if cross else 256,
            aligned=int(not cross), scale=1.0, temperature=1.0)
        got = lib.isi_decode_scan_heads(ctypes.byref(params),
                                        ctypes.c_int(DTYPE_CODES[dtype]))
        rule = dsk.heads_side_by_side(heads, d // heads)
        shape = (d, heads, d_ff, l_pad, cross, dtype)
        assert got in (1, rule), (shape, got, rule)
        if rule > 1:
            grouped += got > 1
            in_series += got == 1
        if (d, heads, d_ff) == (512, 16, 2048) and cross == (l_pad == 128):
            assert got == 2, shape  # the bottom prior's cache, the top's
    assert grouped and in_series


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_prime_is_one_launch_and_repeats(prior, dtype):
    """One persistent launch a prefix (2 grid barriers, then 8 per aligned
    layer or 13 per cross layer but the last); a second call gives the same
    cache bit for bit."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
        import prefix_prime_info
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, dtype)
    before = fused_prefix_prime.launches
    kv1 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    kv2 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    torch.cuda.synchronize()
    assert fused_prefix_prime.launches == before + 2
    assert torch.equal(kv1, kv2)
    info = prefix_prime_info(
        inp["params"], inp["bias_hm"], inp["x_prefix"], inp["mem"],
        torch.zeros_like(kv1), p0=inp["p0"], channels=inp["c"],
        cross_hm=inp["cross_hm"], e_src_real=inp["e_src"])
    layers = inp["params"]["wo"].shape[0]
    per_layer = 8 if inp["cross_hm"] is None else 13
    assert info["grid_barriers"] == 2 + per_layer * (layers - 1)


def test_sample_model_cuda_matches_cpu(prior):
    model, codemap, condition, mask = prior
    cfg = model.config
    helper = cfg.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    p0, steps = scan_range(model, int(nz.min()), int(nz.max()) + 1)
    gumbel = torch.as_tensor(np.random.default_rng(3).gumbel(
        size=(steps - p0, cfg.n_class)).astype(np.float32))
    cond = None if cfg.self_conditional_model else condition
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = sample_model(m, None, 1, condition=cond,
                                initial_code=codemap, mask=mask,
                                gumbel=gumbel, device=dev).cpu()
    model.to("cuda")
    assert torch.equal(out["cuda"], out["cpu"])
    np.testing.assert_array_equal(out["cpu"].numpy()[0][~mask],
                                  codemap[~mask])


def batch_inputs(model, batch, dtype, seed=5):
    """Step-kernel arguments for ``batch`` different sequences, primed up
    to the first masked position of a two-column mask."""
    import chip_smoke
    cfg = model.config
    rng = np.random.default_rng(seed)
    codemaps = rng.integers(0, cfg.n_class, (batch,) + tuple(cfg.shape))
    conditions = (codemaps if cfg.self_conditional_model else rng.integers(
        0, cfg.n_class, (batch,) + tuple(cfg.condition_shape)))
    mask = np.zeros(cfg.shape, bool)
    mask[:, 1:3] = True
    helper = cfg.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    state = precompute_decode_state(model, compute_dtype=dtype)
    return chip_smoke.scan_inputs(torch, model, state, codemaps, conditions,
                                  mask, int(nz.min()), int(nz.max()) + 1,
                                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_prime_batch_kernel_matches_plain(prior, dtype):
    import chip_smoke
    inp = batch_inputs(prior[0], 3, dtype)
    kv_k = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    kv_p = chip_smoke.run_prime(torch, prefix_prime_plain, inp, dtype)
    torch.cuda.synchronize()
    p0 = inp["p0"]
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kv_k[:, :, :, :p0].float(),
                               kv_p[:, :, :, :p0].float(), atol=tol, rtol=tol)
    assert not torch.equal(kv_k[:, :, 0, :p0], kv_k[:, :, 1, :p0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [2, 3, 6, 17])
def test_decode_step_kernel_matches_plain(prior, dtype, batch):
    import chip_smoke
    inp = batch_inputs(prior[0], batch, dtype)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = gumbel_noise((n, batch, inp["n_class"]), kv0.device, gen)
    tk, kvk = chip_smoke.run_steps(torch, fused_decode_step, inp, kv0, noise,
                                   0.8, n)
    tp, kvp = chip_smoke.run_steps(torch, decode_step_plain, inp, kv0, noise,
                                   0.8, n)
    torch.cuda.synchronize()
    tol = ((3e-4, 1e-3) if dtype == torch.float32 else (5e-2, 5e-2))
    torch.testing.assert_close(kvk.float(), kvp.float(), atol=tol[0],
                               rtol=tol[1])
    if dtype == torch.float32:
        assert torch.equal(tk, tp)
    keep = ~inp["mask"]
    assert torch.equal(tk[:, keep], inp["tokens"][:, keep])
    assert not torch.equal(tk, inp["tokens"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [5, 8, 16, 64])
def test_decode_step_batched_kernel_matches_plain(device, dtype, batch):
    import chip_smoke
    model = tiny_prior("aligned").to(device)
    inp = batch_inputs(model, batch, dtype)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    noise = gumbel_noise((n, batch, inp["n_class"]), kv0.device, gen)
    tk, kvk = chip_smoke.run_steps(torch, fused_decode_step_batched, inp,
                                   kv0, noise, 0.8, n)
    tp, kvp = chip_smoke.run_steps(torch, decode_step_batched_plain, inp,
                                   kv0, noise, 0.8, n)
    torch.cuda.synchronize()
    tol = ((3e-4, 1e-3) if dtype == torch.float32 else (5e-2, 5e-2))
    torch.testing.assert_close(kvk.float(), kvp.float(), atol=tol[0],
                               rtol=tol[1])
    if dtype == torch.float32:
        assert torch.equal(tk, tp)
    assert fused_decode_step_batched.launches >= n


def test_decode_step_is_one_launch_per_step(device):
    """A step is one cooperative launch: the profiler sees one device
    kernel per step and nothing else."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    model = tiny_prior("aligned").to(device)
    for fn, batch in ((fused_decode_step, 2),
                      (fused_decode_step_batched, 16)):
        inp = batch_inputs(model, batch, torch.bfloat16)
        kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp,
                                   torch.bfloat16)
        zeros = torch.zeros(4, batch, inp["n_class"], device=device)
        chip_smoke.run_steps(torch, fn, inp, kv0, zeros, 1.0, 4)
        kv = kv0.clone()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chip_smoke.run_steps(torch, fn, inp, kv, zeros, 1.0, 4)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "decode_step_kernel" in e.name]
        assert len(names) == 4, names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_kernels_refuse_what_they_do_not_take(device, dtype,
                                                   monkeypatch):
    """head_dim 12 (d_model 48, 4 heads) is no multiple of 8: both step
    kernels raise naming the shape, launch nothing and never run the plain
    version."""
    import chip_smoke
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    base = tiny_prior("aligned").config
    model = init_like_flax(
        tt.UpsamplingVQTransformer(dataclasses.replace(base, d_model=48)),
        torch.Generator().manual_seed(0)).eval().to(device)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(dsk, "decode_step_plain", plain)
    monkeypatch.setattr(dsb, "decode_step_batched_plain", plain)
    for fn, batch in ((fused_decode_step, 2),
                      (fused_decode_step_batched, 8)):
        inp = batch_inputs(model, batch, dtype)
        kv0 = torch.zeros(inp["kv_shape"], dtype=dtype, device=device)
        zeros = torch.zeros(1, batch, inp["n_class"], device=device)
        before = fn.launches
        with pytest.raises(ValueError, match="head_dim 12 .*d_model 48"):
            chip_smoke.run_steps(torch, fn, inp, kv0, zeros, 1.0, 1)
        assert fn.launches == before


def test_step_refusal_is_the_kernels_own_decision(device):
    """``step_refusal`` (which the server and the CLI ask when a prior
    loads) mirrors the kernels' shared-memory plan: over a sweep of
    d_model, head_dim, d_ff, batch, cache length, dtype and aligned / cross
    attention, it returns None exactly where the kernel's info call takes
    the shape, and ``_step_layout`` gives the kernel's shared memory and
    choice of the wide instantiation."""
    import ctypes
    import itertools
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        build, decode_step_kernel as dsk)
    from interactive_spectrogram_inpainting_tpu_torch.ops.common import (
        DTYPE_CODES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    e_src = 129
    taken = refused = 0
    for kernel, cross in (("fused_decode_step", False),
                          ("fused_decode_step", True),
                          ("fused_decode_step_batched", False)):
        library, _, info_symbol = dsk._STEP_LIBRARIES[kernel]
        info_fn = getattr(build.load(library), info_symbol)
        for d, dh, d_ff, batch, l_pad, dtype in itertools.product(
                (256, 512, 1024, 1536, 2048), (8, 12, 32, 64, 96, 128, 136),
                (512, 2048, 8192, 32768), (1, 2, 16, 64), (640, 2048),
                (torch.float32, torch.bfloat16)):
            heads = max(d // dh, 1)
            params = dsk._StepParams(
                n_layers=2, d=d, d_ff=d_ff, n_heads=heads, n_class=16,
                batch=batch, l_pad=l_pad, e_pad=256, steps_pad=l_pad,
                channels=1, e_src=e_src if cross else 256,
                aligned=int(not cross), pos=0, take=0, grid=0, scale=1.0,
                inv_temperature=1.0)
            info = (ctypes.c_int * len(dsk._INFO_KEYS))()
            code = info_fn(ctypes.byref(params),
                           ctypes.c_int(DTYPE_CODES[dtype]), info)
            reason = dsk.step_refusal(d, heads, d_ff, dtype, l_pad,
                                      e_src if cross else None, batch, sms)
            shape = (kernel, cross, d, heads, d_ff, batch, l_pad, dtype)
            assert (code == 0) == (reason is None), (shape, code, reason)
            if code:
                refused += 1
                continue
            taken += 1
            got = dict(zip(dsk._INFO_KEYS, info))
            smem, _, _, wide = dsk._step_layout(
                d, heads, d_ff, batch, 2 if dtype == torch.bfloat16 else 4)
            assert (got["smem_bytes"], got["wide_kernel"]) == (
                smem, int(wide)), shape
    assert taken and refused


# prior geometries the kernels take since the full test models' (d_model,
# heads, d_ff): more heads than the scan's 15 clusters, head_dim 128, shared
# memory regions read from device memory (d_model 1024, d_ff 4096), d_model
# 2048, d_ff 8192
WIDE = {"16_heads": (128, 16, 64), "24_heads": (192, 24, 64),
        "head_dim_128": (256, 2, 64), "d_model_1024": (1024, 8, 4096),
        "d_model_2048": (2048, 16, 128), "d_ff_8192": (32, 4, 8192)}


def wide_case(device, variant, geometry):
    d_model, heads, d_ff = WIDE[geometry]
    return prior_case(tiny_prior(variant, d_model=d_model,
                                 conditional_model_nhead=heads,
                                 d_ff=d_ff).to(device))


@pytest.mark.parametrize("geometry", ["16_heads", "24_heads", "head_dim_128",
                                      "d_model_1024", "d_model_2048"])
@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_decode_scan_wide_geometry_matches_plain(device, variant, geometry):
    """float32: the token streams equal (greedy and with noise), the cache
    within 3e-4; bfloat16 teacher-forced: the cache within 5e-2."""
    import chip_smoke
    model, codemap, condition, mask = wide_case(device, variant, geometry)
    for dtype in (torch.float32, torch.bfloat16):
        inp = inputs(model, codemap, condition, mask, dtype)
        kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
        n = inp["steps"] - inp["p0"]
        gen = torch.Generator(device="cuda").manual_seed(2)
        noise = gumbel_noise((n, inp["n_class"]), kv0.device, gen)
        if dtype == torch.float32:
            for gumbel in (noise, torch.zeros_like(noise)):
                tk, kvk = chip_smoke.run_scan(torch, fused_decode_scan, inp,
                                              kv0, inp["mask"], gumbel, 0.8)
                tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp,
                                              kv0, inp["mask"], gumbel, 0.8)
                torch.cuda.synchronize()
                assert torch.equal(tk, tp)
                torch.testing.assert_close(kvk, kvp, atol=3e-4, rtol=1e-3)
        else:
            none = torch.zeros_like(inp["mask"])
            tk, kvk = chip_smoke.run_scan(torch, fused_decode_scan, inp, kv0,
                                          none, noise)
            tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0,
                                          none, noise)
            torch.cuda.synchronize()
            assert torch.equal(tk, inp["tokens"])
            torch.testing.assert_close(kvk.float(), kvp.float(), atol=5e-2,
                                       rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", ["16_heads", "head_dim_128",
                                      "d_model_2048"])
@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_prefix_prime_wide_geometry_matches_plain(device, variant, geometry,
                                                  dtype):
    import chip_smoke
    model = wide_case(device, variant, geometry)[0]
    inp = batch_inputs(model, 2, dtype)
    kv_k = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    kv_p = chip_smoke.run_prime(torch, prefix_prime_plain, inp, dtype)
    torch.cuda.synchronize()
    p0 = inp["p0"]
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kv_k[:, :, :, :p0].float(),
                               kv_p[:, :, :, :p0].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", ["head_dim_128", "d_ff_8192",
                                      "16_heads"])
@pytest.mark.parametrize("kernel,variant,batch", [
    ("fused_decode_step", "aligned", 2), ("fused_decode_step", "cross", 2),
    ("fused_decode_step_batched", "aligned", 16)])
def test_step_kernels_wide_geometry_match_plain(device, kernel, variant,
                                                batch, geometry, dtype):
    """Every position of the two-column inpaint: the caches within the
    step tolerance, float32 tokens equal (d_ff 8192: fc2 in column tiles of
    d_ff)."""
    import chip_smoke
    model = wide_case(device, variant, geometry)[0]
    fn, plain = {"fused_decode_step": (fused_decode_step, decode_step_plain),
                 "fused_decode_step_batched": (fused_decode_step_batched,
                                               decode_step_batched_plain)
                 }[kernel]
    inp = batch_inputs(model, batch, dtype)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = gumbel_noise((n, batch, inp["n_class"]), kv0.device, gen)
    before = fn.launches
    tk, kvk = chip_smoke.run_steps(torch, fn, inp, kv0, noise, 0.8, n)
    tp, kvp = chip_smoke.run_steps(torch, plain, inp, kv0, noise, 0.8, n)
    torch.cuda.synchronize()
    assert fn.launches == before + n
    tol = ((3e-4, 1e-3) if dtype == torch.float32 else (5e-2, 5e-2))
    torch.testing.assert_close(kvk.float(), kvp.float(), atol=tol[0],
                               rtol=tol[1])
    if dtype == torch.float32:
        assert torch.equal(tk, tp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 127, 128, 255])
def test_flash_decode_attention_kernel_matches_plain(device, dtype, pos):
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, L, H, Dh = 3, 256, 4, 8
    q = torch.randn(B, H, Dh, generator=gen, device=device).to(dtype)
    k = torch.randn(B, L, H, Dh, generator=gen, device=device).to(dtype)
    v = torch.randn(B, L, H, Dh, generator=gen, device=device).to(dtype)
    bias = torch.randn(H, L, generator=gen, device=device)
    for bias_row in (bias, None):
        out = flash_decode_attention(q, k, v, pos, bias_row)
        ref = reference_decode_attention(q, k, v, pos, bias_row)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=max(tol, 1e-4))


def device_kernels(fn, *args, calls=8):
    """The device kernels ``torch.profiler`` sees in ``calls`` calls of
    ``fn`` (after a warm call), and the wrapper's launch count over them.
    The profiler may drop an event, never add one."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    before = fn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    kernels = [evt.name for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, fn.launches - before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_flash_decode_attention_at_the_sampler_cache(device, dtype, batch,
                                                     head_dim):
    """The bottom prior's cache (640 rows, 8 heads): pos at the first key,
    the end of the first chunk, the start of the second and the last row,
    with and without the bias row, against the dense plain version and the
    mirror of the kernel's order; a second call bit-identical; one device
    kernel a call."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention \
        import decode_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(batch * head_dim)
    L, H = 640, 8
    q = torch.randn(batch, H, head_dim, generator=gen, device=device)
    k = torch.randn(batch, L, H, head_dim, generator=gen, device=device)
    v = torch.randn(batch, L, H, head_dim, generator=gen, device=device)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    bias = torch.randn(H, L, generator=gen, device=device)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for pos in (0, 127, 128, 639):
        for bias_row in (bias, None):
            out = flash_decode_attention(q, k, v, pos, bias_row)
            again = flash_decode_attention(q, k, v, pos, bias_row)
            ref = reference_decode_attention(q, k, v, pos, bias_row)
            mirror = decode_attention_plain(q, k, v, pos, bias_row)
            torch.cuda.synchronize()
            assert out.dtype == dtype and torch.equal(out, again)
            for want in (ref, mirror):
                torch.testing.assert_close(out.float(), want.float(),
                                           atol=tol, rtol=max(tol, 1e-4))
    # one device kernel a call: every kernel the profiler records over 8
    # calls is the flash kernel, at most 8 of them
    kernels, launched = device_kernels(flash_decode_attention, q, k, v, 639,
                                       bias)
    assert launched == 8 and 1 <= len(kernels) <= 8, kernels
    assert all("flash_decode_kernel" in name for name in kernels), kernels


def test_flash_decode_attention_refuses_what_the_kernel_does_not_take(
        device):
    q = torch.zeros(2, 4, 8, device=device)
    k = torch.zeros(2, 128, 4, 8, device=device)
    bias = torch.zeros(4, 128, device=device)
    before = flash_decode_attention.launches
    bad = [
        (q, k.bfloat16(), k.bfloat16(), 5, bias),     # dtypes differ
        (q.double(), k.double(), k.double(), 5, bias),
        (q, k[:, :64], k[:, :64], 5, bias[:, :64]),   # Lp not 128 k
        (q, k, k[:1], 5, bias),                       # shapes differ
        (q, k, k, 128, bias),                         # pos past the cache
        (q, k, k, -1, bias),
        (q, k, k, 5, bias[:3]),                       # bias shape
        (q, k, k, 5, bias.cpu()),                     # bias on the CPU
        (q, k, k.cpu(), 5, bias),                     # v on the CPU
        (q, k.transpose(0, 1).contiguous().transpose(0, 1), k, 5, bias),
        (q[..., :7], k[..., :7], k[..., :7], 5, bias),          # Dh odd
        (torch.zeros(2, 4, 130, device=device),
         torch.zeros(2, 128, 4, 130, device=device),
         torch.zeros(2, 128, 4, 130, device=device), 5, bias),  # Dh > 128
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_decode_attention(*args)
    assert flash_decode_attention.launches == before


@pytest.mark.parametrize("batch", [2, 8])
def test_sample_model_batch_cuda_matches_cpu(prior, batch):
    """Fused batch sampler (step kernel; batched kernel at 8 on the aligned
    prior) and the dense flash sampler: the card's tokens equal the CPU's."""
    model, codemap, condition, mask = prior
    cfg = model.config
    helper = cfg.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    p0, steps = scan_range(model, int(nz.min()), int(nz.max()) + 1)
    gumbel = torch.as_tensor(np.random.default_rng(8).gumbel(
        size=(steps - p0, batch, cfg.n_class)).astype(np.float32))
    cond = None if cfg.self_conditional_model else condition
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = [
            sample_model(m, None, batch, condition=cond,
                         initial_code=codemap, mask=mask, gumbel=gumbel,
                         use_fused_step=fused, use_flash=not fused,
                         top_k_sampling_k=0 if fused else 4,
                         device=dev).cpu()
            for fused in (True, False)]
    model.to("cuda")
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert flash_decode_attention.launches > 0


@pytest.mark.parametrize("batch", [2, 8])
def test_fused_per_row_class_labels_match_dense_on_the_card(device, batch):
    """One pitch per batch row: the fused sampler (the step kernel at 2,
    the batched kernel at 8) gives the dense sampler's greedy float32
    tokens on the card, every row from its own start rows."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as dsb, decode_step_kernel as dsk)
    base = tiny_prior("aligned").config
    cfg = dataclasses.replace(
        base, class_conditioning_num_classes_per_modality={"pitch": 5},
        class_conditioning_embedding_dim_per_modality={"pitch": 4},
        class_conditioning_prepend_to_dummy_input=True)
    model = init_like_flax(tt.UpsamplingVQTransformer(cfg),
                           torch.Generator().manual_seed(1)).eval().to(device)
    rng = np.random.default_rng(9)
    condition = rng.integers(0, cfg.n_class, (batch,) + cfg.condition_shape)
    pitches = np.array([1, 3, 0, 4, 2, 3, 1, 0])[:batch]
    p0, steps = scan_range(model, None, None)
    gumbel = torch.zeros(steps - p0, batch, cfg.n_class)
    launches = (dsk.fused_decode_step.launches,
                dsb.fused_decode_step_batched.launches)
    fused, dense = (sample_model(
        model, None, batch, condition=condition,
        class_conditioning={"pitch": pitches}, gumbel=gumbel,
        use_fused_step=f, device="cuda").cpu() for f in (True, False))
    assert torch.equal(fused, dense)
    grew = (dsk.fused_decode_step.launches > launches[0],
            dsb.fused_decode_step_batched.launches > launches[1])
    assert grew == ((True, False) if batch == 2 else (False, True))
    assert not torch.equal(fused[0], fused[1])


# -- fused_vq_lookup ----------------------------------------------------------

def vq_margin_rows(flat, embed, margin=1e-4):
    """Rows whose two best scores lie closer than ``margin``: a float32 sum
    taken in another order may pick either code there."""
    scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
    best2 = torch.topk(scores, min(2, scores.shape[1]), dim=1,
                       largest=False).values
    if best2.shape[1] < 2:
        return torch.zeros(flat.shape[0], dtype=torch.bool,
                           device=flat.device)
    return (best2[:, 1] - best2[:, 0]) < margin


@pytest.mark.parametrize("n,dim,n_embed", [
    (128, 64, 512), (700, 64, 512), (1, 64, 512), (33, 8, 32), (257, 5, 7),
    (96, 64, 130), (4096, 200, 64), (5000, 64, 512), (6145, 32, 33),
    (2048, 512, 64), (700, 1024, 130), (300, 300, 33)])
def test_vq_lookup_kernel_matches_plain(device, n, dim, n_embed):
    """ids equal wherever the two best scores differ by more than 1e-4;
    quantize is the codebook row bit for bit; counts exact; embed_sum within
    atol 1e-3 (another summation order); a second call gives the same bits."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup, reference_vq_lookup)
    rng = np.random.default_rng(n * 31 + dim)
    flat = torch.as_tensor(rng.standard_normal((n, dim), np.float32),
                           device=device)
    embed = torch.as_tensor(rng.standard_normal((dim, n_embed), np.float32),
                            device=device)
    before = fused_vq_lookup.launches
    ids, quant, counts, esum = fused_vq_lookup(flat, embed)
    torch.cuda.synchronize()
    assert fused_vq_lookup.launches == before + 1
    ids_p, quant_p, counts_p, esum_p = reference_vq_lookup(flat, embed)
    close = vq_margin_rows(flat, embed)
    assert int(close.sum()) <= max(1, n // 1000)
    assert torch.equal(ids[~close], ids_p[~close])
    assert ids.dtype == torch.int32
    assert torch.equal(quant, embed.T[ids.long()])
    assert torch.equal(counts, torch.bincount(
        ids.long(), minlength=n_embed).float())
    if not bool(close.any()):
        assert torch.equal(counts, counts_p)
        torch.testing.assert_close(esum, esum_p, atol=1e-3, rtol=0)
    again = fused_vq_lookup(flat, embed)
    torch.cuda.synchronize()
    for a, b in zip((ids, quant, counts, esum), again):
        assert torch.equal(a, b)


def test_vq_lookup_kernel_ties_take_the_lowest_code(device):
    """Duplicate codebook columns score equally: the lower index wins, as
    argmin does."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    rng = np.random.default_rng(5)
    base = rng.standard_normal((16, 40), np.float32)
    embed = torch.as_tensor(np.concatenate([base, base, base], axis=1),
                            device=device)  # codes k, k + 40, k + 80 equal
    flat = torch.as_tensor(rng.standard_normal((300, 16), np.float32),
                           device=device)
    ids, _, counts, _ = fused_vq_lookup(flat, embed)
    assert int(ids.max()) < 40
    assert float(counts[40:].sum()) == 0.0
    assert float(counts.sum()) == 300.0


def test_vq_lookup_kernel_when_one_code_takes_every_row(device):
    """An untrained encoder sends every row to one code: the statistics are
    sums over all rows (several 2048-row segments, added in a fixed order)
    and stay exact in counts, within float32 rounding of the float64 sums,
    and bit-identical from call to call."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    rng = np.random.default_rng(9)
    n, dim, n_embed = 10000, 64, 512
    flat = torch.as_tensor(rng.standard_normal((n, dim), np.float32),
                           device=device)
    embed = 50.0 * torch.as_tensor(
        rng.standard_normal((dim, n_embed), np.float32), device=device)
    embed[:, 7] = 0.0
    ids, quant, counts, esum = fused_vq_lookup(flat, embed)
    assert bool((ids == 7).all()) and float(quant.abs().max()) == 0.0
    assert float(counts[7]) == n and float(counts.sum()) == n
    exact = flat.double().sum(0)
    torch.testing.assert_close(esum[:, 7].double(), exact, atol=1e-3,
                               rtol=1e-5)
    assert float(esum[:, :7].abs().max()) == 0.0
    again = fused_vq_lookup(flat, embed)
    assert torch.equal(esum, again[3]) and torch.equal(counts, again[2])


@pytest.mark.parametrize("n,dim,n_embed", [
    (700, 64, 512), (1000, 64, 512), (300, 256, 500), (3000, 16, 5000),
    (2049, 3, 1)])
def test_vq_lookup_kernel_matches_its_mirror(device, n, dim, n_embed):
    """Against ``vq_lookup_plain`` (the kernel's order): ids equal off the
    near ties; where every id agrees, embed_sum equal bit for bit (the same
    float32 sums in the same order). K 500: no staged chunk divides it; dim
    256: the widest; K 5000: the sort by 11-bit digits in two passes; K 1:
    every row one code."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup, vq_lookup_plain)
    rng = np.random.default_rng(n + dim)
    flat = torch.as_tensor(rng.standard_normal((n, dim), np.float32),
                           device=device)
    embed = torch.as_tensor(rng.standard_normal((dim, n_embed), np.float32),
                            device=device)
    ids, quant, counts, esum = fused_vq_lookup(flat, embed)
    m_ids, m_quant, m_counts, m_esum = vq_lookup_plain(flat, embed)
    close = vq_margin_rows(flat, embed).cpu()
    assert int(close.sum()) <= max(1, n // 1000)
    ids = ids.cpu()
    assert torch.equal(ids[~close], m_ids[~close])
    assert torch.equal(quant, embed.T[ids.long().to(device)])
    assert torch.equal(counts.cpu(), torch.bincount(
        ids.long(), minlength=n_embed).float())
    if torch.equal(ids, m_ids):
        assert torch.equal(esum.cpu(), m_esum)
        assert torch.equal(counts.cpu(), m_counts)
    exact = flat.double().T @ torch.nn.functional.one_hot(
        ids.long().to(device), n_embed).double()
    torch.testing.assert_close(esum.double(), exact, atol=1e-3, rtol=1e-5)


def test_vq_lookup_kernel_one_code_takes_65536_rows(device):
    """An extraction batch's rows all to one code: 1 024 pieces of 64
    sorted rows added in order; counts exact, embed_sum within atol 1e-3,
    rtol 1e-5 of the float64 sum, a second call bit-identical."""
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    rng = np.random.default_rng(12)
    n, dim, n_embed = 65536, 64, 512
    flat = torch.as_tensor(rng.standard_normal((n, dim), np.float32),
                           device=device)
    embed = 50.0 * torch.as_tensor(
        rng.standard_normal((dim, n_embed), np.float32), device=device)
    embed[:, 300] = 0.0
    ids, quant, counts, esum = fused_vq_lookup(flat, embed)
    again = fused_vq_lookup(flat, embed)
    assert bool((ids == 300).all()) and float(quant.abs().max()) == 0.0
    assert float(counts[300]) == n and float(counts.sum()) == n
    torch.testing.assert_close(esum[:, 300].double(), flat.double().sum(0),
                               atol=1e-3, rtol=1e-5)
    others = torch.arange(n_embed, device=device) != 300
    assert float(esum[:, others].abs().max()) == 0.0
    for a, b in zip((ids, quant, counts, esum), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [128, 65536])
def test_vq_lookup_two_device_kernels_a_call(device, n):
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    gen = torch.Generator(device="cuda").manual_seed(n)
    flat = torch.randn(n, 64, generator=gen, device=device)
    embed = torch.randn(64, 512, generator=gen, device=device)
    kernels, launched = device_kernels(fused_vq_lookup, flat, embed)
    assert launched == 8 and 1 <= len(kernels) <= 16, kernels
    assert all("vq_assign_kernel" in name or "vq_stats_kernel" in name
               for name in kernels), kernels


def test_vq_lookup_refuses_what_the_kernel_does_not_take(device):
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    flat = torch.zeros(4, 8, device=device)
    embed = torch.zeros(8, 16, device=device)
    with pytest.raises(ValueError):
        fused_vq_lookup(flat.double(), embed)
    with pytest.raises(ValueError):
        fused_vq_lookup(torch.zeros(8, 4, device=device).T, embed)
    with pytest.raises(ValueError):
        fused_vq_lookup(flat.requires_grad_(), embed)
    with pytest.raises(ValueError, match="dim 1100"):
        fused_vq_lookup(torch.zeros(4, 1100, device=device),
                        torch.zeros(1100, 16, device=device))


def test_bottleneck_on_the_card_runs_the_kernel(device):
    """QuantizedBottleneck with the flag on launches the kernel on a CUDA
    tensor, in evaluation and in training, and agrees with the flag off."""
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.bottleneck \
        import QuantizedBottleneck
    from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
        fused_vq_lookup)
    torch.manual_seed(0)
    fused = QuantizedBottleneck(16, 64, use_pallas_lookup=True).to(device)
    dense = QuantizedBottleneck(16, 64).to(device)
    dense.load_state_dict(fused.state_dict())
    x = torch.randn(3, 16, 8, 4, device=device)
    before = fused_vq_lookup.launches
    for train in (False, True, True):
        out_f = fused(x, train=train)
        out_d = dense(x, train=train)
        for a, b in zip(out_f, out_d):
            torch.testing.assert_close(a.float(), b.float(), atol=1e-5,
                                       rtol=1e-5)
    assert fused_vq_lookup.launches == before + 3
    for name in ("embed", "cluster_size", "embed_avg"):
        torch.testing.assert_close(getattr(fused, name),
                                   getattr(dense, name), atol=1e-5,
                                   rtol=1e-5)


# -- training attention -------------------------------------------------------

def attention_inputs(device, batch, lq, lk, heads, dh, dtype, mask=None,
                     seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(batch, n, heads, dh, generator=gen).to(dtype)
               for n in (lq, lk, lk))
    ab = torch.randn(heads, lq, lk, generator=gen)
    if mask is not None:
        ab = ab + mask[None]
    dout = torch.randn(batch, lq, heads, dh, generator=gen).to(dtype)
    return [t.to(device) for t in (q, k, v, ab, dout)]


def aligned_mask(lq, lk, channels):
    e_q = torch.arange(lq) // channels
    return torch.where(e_q[:, None] == torch.arange(lk)[None, :], 0.0, -1e9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,mask", [
    ((3, 37, 21, 2, 8), None),          # ragged everything
    ((2, 129, 129, 3, 24), "anti"),     # odd heads, small Dh
    ((4, 70, 70, 4, 64), "causal"),
    ((2, 66, 17, 2, 64), "aligned"),    # cross attention, one key per row
    ((2, 40, 40, 2, 80), None),         # Dh above 64
    ((2, 600, 50, 16, 8), None),        # two batch groups
    ((2, 33, 19, 3, 6), None),          # rows not 16-byte pieces: element
                                        # loads instead of cp.async
    ((1, 130, 130, 2, 64), "fully_masked_row"),  # one group; row 100 sees
                                                 # no key: its tile stays
    ((32, 516, 516, 8, 64), "causal"),  # the three training attentions with
    ((32, 516, 129, 8, 64), "aligned"),  # their real masks, where most
    ((32, 129, 129, 8, 64), "anti"),     # tiles are skipped
])
def test_train_attention_kernels_match_plain(device, dtype, shape, mask):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    batch, lq, lk, heads, dh = shape
    i = torch.arange(lq)
    masks = {None: None,
             "causal": torch.where(i[:, None] >= i[None, :], 0.0, -1e9),
             "anti": torch.where(i[:, None] <= i[None, :], 0.0, -1e9),
             "aligned": aligned_mask(lq, lk, 4),
             "fully_masked_row": torch.where(
                 (i[:, None] <= i[None, :]) & (i[:, None] != 100), 0.0,
                 -1e9)}
    q, k, v, ab, dout = attention_inputs(device, *shape, dtype,
                                         masks[mask])
    launches = (ta.train_attention_forward.launches,
                ta.train_attention_backward.launches)
    out = ta.train_attention_forward(q, k, v, ab)
    grads = ta.train_attention_backward(q, k, v, ab, dout)
    again = ta.train_attention_backward(q, k, v, ab, dout)
    ref = ta.reference_train_attention(q, k, v, ab)
    ref_grads = ta.reference_train_attention_backward(q, k, v, ab, dout)
    torch.cuda.synchronize()
    assert (ta.train_attention_forward.launches,
            ta.train_attention_backward.launches) == (launches[0] + 1,
                                                      launches[1] + 2)
    fwd_tol = (1e-5, 1e-5) if dtype == torch.float32 else (3e-2, 3e-2)
    grad_tol = (2e-4, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=fwd_tol[0],
                               rtol=fwd_tol[1])
    for name, got, want, rep in zip(("dq", "dk", "dv", "dab"), grads,
                                    ref_grads, again):
        assert got.dtype == want.dtype, name
        assert torch.equal(got, rep), f"{name} differs between two calls"
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=grad_tol[0], rtol=grad_tol[1],
                                   msg=name)


@pytest.mark.parametrize("lq,lk,mask", [
    (516, 516, "causal"), (516, 129, "aligned"), (129, 129, "anti"),
    (130, 130, "fully_masked_row"), (37, 21, None)])
def test_train_attention_live_map_on_the_card(device, lq, lk, mask):
    """The map of live tiles the forward kernel builds equals its plain
    version ``live_tiles``."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    i, j = torch.arange(lq), torch.arange(lk)
    masks = {None: torch.zeros(lq, lk),
             "causal": torch.where(i[:, None] >= j[None, :], 0.0, -1e9),
             "anti": torch.where(i[:, None] <= j[None, :], 0.0, -1e9),
             "aligned": aligned_mask(lq, lk, 4),
             "fully_masked_row": torch.where(
                 (i[:, None] <= j[None, :]) & (i[:, None] != 100), 0.0,
                 -1e9)}
    q, k, v, ab, _ = attention_inputs(device, 2, lq, lk, 3, 64,
                                      torch.float32, masks[mask])
    state = ta.train_attention_forward(q, k, v, ab, keep_state=True)
    assert torch.equal(state.live, ta.live_tiles(ab))


def test_train_attention_autograd_on_the_card(device):
    """The autograd function launches one forward and one backward."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    q, k, v, ab, dout = attention_inputs(device, 2, 20, 12, 2, 16,
                                         torch.float32, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, ab)]
    before = ta.train_attention_backward.launches
    out = ta.fused_train_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    assert ta.train_attention_backward.launches == before + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v, ab)]
    want = torch.autograd.grad(ta.reference_train_attention(*ref), ref, dout)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, atol=2e-4, rtol=1e-4)


def test_train_prior_two_steps_on_the_card(device, tmp_path):
    """``train_prior.main`` on the card: two steps of a tiny bottom prior
    (1 encoder and 2 decoder layers: 5 attention calls a step) through the
    training kernels, then its evaluation, and the trained files."""
    from interactive_spectrogram_inpainting_tpu_torch.data.codemap_store \
        import CodemapStoreWriter
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        train_attention as ta)
    from interactive_spectrogram_inpainting_tpu_torch.train import (
        train_prior)
    rng = np.random.default_rng(0)
    store = tmp_path / "codes"
    with CodemapStoreWriter(store, (4, 2), (8, 4), [], n_class=16) as w:
        for i in range(8):
            w.append(rng.integers(0, 16, (4, 2)), rng.integers(0, 16, (8, 4)),
                     {}, f"note_{i}")
    before = (ta.train_attention_forward.launches,
              ta.train_attention_backward.launches)
    model = train_prior.main([
        "--hier", "bottom", "--use_aligned_decoder", "--database_path",
        str(store), "--runs_directory", str(tmp_path / "runs"),
        "--d_model", "32", "--embeddings_dim", "8",
        "--positional_embeddings_dim", "8", "--num_encoder_layers", "1",
        "--num_decoder_layers", "2", "--num_heads", "4", "--d_ff", "64",
        "--classes_for_conditioning", "--batch_size", "4",
        "--num_training_epochs", "1"])
    torch.cuda.synchronize()
    launches = (ta.train_attention_forward.launches - before[0],
                ta.train_attention_backward.launches - before[1])
    # two train steps, then two evaluation batches
    assert launches == (5 * 4, 5 * 2)
    assert model.config.fused_attention
    assert all(torch.isfinite(p).all() for p in model.parameters())
    (run_dir,) = (tmp_path / "runs").iterdir()
    assert (run_dir / "bottom-weights.msgpack").exists()


# -- spectral loss ------------------------------------------------------------

SPECTRAL_SCALES = [  # (n_fft, hop, win): Jukebox's three, DDSP's extremes,
    # and an n_fft that is not a power of two (the DFT route at 'high')
    (2048, 240, 1200), (1024, 120, 600), (512, 48, 240), (64, 16, 64),
    (2048, 512, 2048), (1536, 256, 1536)]
FFT_SCALES = SPECTRAL_SCALES[:5]


def spectral_inputs(device, scale, mse, precision="high"):
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    n_fft, hop, win = scale
    gen = torch.Generator().manual_seed(n_fft + hop)
    pred = (0.3 * torch.randn(3, 9000, generator=gen)).to(device)
    target = (pred + 0.05 * torch.randn(3, 9000, generator=gen).to(device))
    cfg = sk.ScaleConfig(n_fft, hop, win, mse, 1e-4, 0.0 if mse else 1e-4,
                         1e-6, precision)
    return pred, target, cfg


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("mse", [True, False])
@pytest.mark.parametrize("scale", SPECTRAL_SCALES)
def test_spectral_loss_kernels_match_plain(device, scale, mse, precision):
    """The forward (per-row sums, total, U) and the backward against their
    plain versions on one scale, 3 rows of 9000 samples; a second call
    gives the same bits. 'high' takes the FFT route where n_fft is a power
    of two, 'default' the DFT route."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    pred, target, cfg = spectral_inputs(device, scale, mse, precision)
    assert sk.fft_route(cfg) == (precision == "high"
                                 and scale in FFT_SCALES)
    launches = (sk.scale_loss_forward.launches,
                sk.scale_loss_backward.launches)
    rows, total, u = sk.scale_loss_forward(pred, target, cfg)
    rows2, total2, u2 = sk.scale_loss_forward(pred, target, cfg)
    grad = torch.tensor(0.7, device=device)
    d = sk.scale_loss_backward(u, grad, cfg, 9000)
    d2 = sk.scale_loss_backward(u, grad, cfg, 9000)
    ref_rows, ref_u = sk.reference_scale_loss(pred, target, cfg)
    ref_d = sk.reference_scale_loss_backward(u, grad, cfg, 9000)
    torch.cuda.synchronize()
    assert (sk.scale_loss_forward.launches,
            sk.scale_loss_backward.launches) == (launches[0] + 2,
                                                 launches[1] + 2)
    assert torch.equal(rows, rows2) and torch.equal(total, total2)
    assert torch.equal(u, u2) and torch.equal(d, d2)
    torch.testing.assert_close(rows, ref_rows, atol=0, rtol=1e-5)
    torch.testing.assert_close(total, ref_rows.sum(), atol=0, rtol=1e-5)
    # U: bf16 of float32 values that differ in their last bits (another
    # summation order) rounds at most one bf16 step apart
    scale_u = float(ref_u.float().abs().max())
    torch.testing.assert_close(u.float(), ref_u.float(), rtol=1e-2,
                               atol=1e-2 * scale_u)
    torch.testing.assert_close(d, ref_d, rtol=0,
                               atol=1e-5 * float(ref_d.abs().max()))


@pytest.mark.parametrize("mse", [True, False])
@pytest.mark.parametrize("scale", FFT_SCALES)
def test_spectral_fft_kernels_match_their_oracle(device, scale, mse):
    """The FFT route against ``reference_scale_loss_fft``, the same steps in
    ``torch.fft``: rows rtol 1e-5; U within one bfloat16 step of the larger
    value plus 1e-5 x max|U| (values set by nearly equal magnitudes); the
    backward of the kernel's U atol 1e-5 x max."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    pred, target, cfg = spectral_inputs(device, scale, mse)
    assert sk.fft_route(cfg)
    rows, total, u = sk.scale_loss_forward(pred, target, cfg)
    grad = torch.tensor(0.7, device=device)
    d = sk.scale_loss_backward(u, grad, cfg, 9000)
    ref_rows, ref_u = sk.reference_scale_loss_fft(pred, target, cfg)
    ref_d = sk.reference_scale_loss_fft_backward(u, grad, cfg, 9000)
    torch.cuda.synchronize()
    torch.testing.assert_close(rows, ref_rows, atol=0, rtol=1e-5)
    u, ref_u = u.float(), ref_u.float()
    bigger = torch.maximum(u.abs(), ref_u.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(bigger)) - 7)
    assert bool(((u - ref_u).abs()
                 <= step + 1e-5 * float(ref_u.abs().max())).all())
    torch.testing.assert_close(d, ref_d, rtol=0,
                               atol=1e-5 * float(ref_d.abs().max()))


@pytest.mark.parametrize("scale", range(3))
def test_spectral_fft_kernel_no_farther_from_float64(device, scale):
    """The FFT route's loss (each row and the total) is no farther from the
    plain formula evaluated in float64 (``reference_scale_loss_float64``)
    than the float32 DFT plain version is: Jukebox's three scales at the
    flagship size, 64 rows of 65 536 samples, ``chip_smoke.py``'s audio
    (the differences are ~1e-7, so a smaller batch holds float32 summation
    noise more than either algorithm)."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    from interactive_spectrogram_inpainting_tpu_torch.train import losses
    gen = torch.Generator(device=device).manual_seed(6)
    pred = 0.3 * torch.randn(64, 65536, generator=gen, device=device)
    target = pred + 0.05 * torch.randn(pred.shape, generator=gen,
                                       device=device)
    cfg = losses.make_jukebox_loss().scale_configs(*pred.shape)[scale]
    assert sk.fft_route(cfg)
    rows, total, _ = sk.scale_loss_forward(pred, target, cfg, need_u=False)
    plain, _ = sk.reference_scale_loss(pred, target, cfg, need_u=False)
    exact = sk.reference_scale_loss_float64(pred, target, cfg)[0]

    def error(r, t):  # worst row or total, relative
        return max(float(((r.double() - exact).abs() / exact).max()),
                   float((t.double() - exact.sum()).abs() / exact.sum()))

    kernel_err, plain_err = error(rows, total), error(plain, plain.sum())
    assert kernel_err <= plain_err, (kernel_err, plain_err)


def test_spectral_loss_autograd_on_the_card(device):
    """The multiscale losses on the card: one forward launch per scale,
    one backward per scale, and the CPU values."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        spectral_loss_kernel as sk)
    from interactive_spectrogram_inpainting_tpu_torch.train import losses
    gen = torch.Generator().manual_seed(1)
    a = 0.3 * torch.randn(2, 8000, generator=gen)
    b = a + 0.05 * torch.randn(2, 8000, generator=gen)
    for loss in (losses.make_jukebox_loss(), losses.make_ddsp_loss()):
        n = len(loss.n_ffts)
        before = (sk.scale_loss_forward.launches,
                  sk.scale_loss_backward.launches)
        x = a.to(device).requires_grad_()
        value = loss(x, b.to(device))
        value.backward()
        assert (sk.scale_loss_forward.launches - before[0],
                sk.scale_loss_backward.launches - before[1]) == (n, n)
        xc = a.clone().requires_grad_()
        ref = loss(xc, b)
        ref.backward()
        torch.testing.assert_close(value.detach().cpu(), ref.detach(),
                                   rtol=1e-5, atol=0)
        torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=0,
                                   atol=2e-3 * float(xc.grad.abs().max()))
        rows = loss(a.to(device), b.to(device), "none")
        torch.testing.assert_close(rows.cpu(), loss(a, b, "none"),
                                   rtol=1e-5, atol=0)
