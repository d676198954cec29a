"""PyTorch port vs the JAX package: decode tables, the two kernels' plain
versions against the Pallas kernels (interpret mode, as the JAX tests run
them on the CPU) and the fused B=1 sampler.

Tolerances are the JAX package's own: K/V within atol 3e-4 / rtol 1e-3
(``tests/test_fused_step.py``), sampled tokens exactly equal. Everything
runs in float32 on the CPU: the point is the algorithm."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_prior import jit_method, make_prior
from interactive_spectrogram_inpainting_tpu.models.prior.transformer import (
    VQNSynthTransformer as JT)
from interactive_spectrogram_inpainting_tpu.ops import (
    decode_step_kernel as jdk)
from interactive_spectrogram_inpainting_tpu.ops.decode_scan_kernel import (
    fused_decode_scan as jax_decode_scan)
from interactive_spectrogram_inpainting_tpu.ops.prefix_prime_kernel import (
    fused_prefix_prime as jax_prefix_prime)
from interactive_spectrogram_inpainting_tpu.sampling import (
    sample_model as jax_sample_model)
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    decode_step_kernel as tdk)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel import (
    fused_decode_scan)
from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
    import fused_prefix_prime
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    sample_model, scan_range)

ATOL, RTOL = 3e-4, 1e-3
WEIGHTS = ("wqkv", "wo", "wo_c", "wq_c", "w1", "w2")


@pytest.fixture(scope="module", params=["aligned", "cross"])
def setup(request):
    jm, variables, tm = make_prior(request.param)
    cfg = jm.config
    rng = np.random.default_rng(0)
    condition = rng.integers(0, cfg.n_class, (1,) + cfg.condition_shape)
    src = jit_method(jm, JT.prepare_sequence, kind="source")(
        variables, cfg.source_codemaps_helper().to_sequence(
            jnp.asarray(condition)))
    memory = jit_method(jm, JT.encode_source)(variables, src)
    c = cfg.target_num_channels
    l_pad = jdk._round_up(cfg.target_sequence_length + c, 128)
    e_src = memory.shape[1]
    e_pad = jdk._round_up(e_src, 128)

    # JAX tables, laid out as sampling/sample.py hands them to the kernels
    @jax.jit
    def tables(variables, memory):
        pos = jm.apply(variables, "target", None,
                       method=JT._positional_sequence)
        start = jm.apply(variables, "target", {}, 1, method=JT._start_block)
        return (jdk.pack_decode_params(jm, variables, dtype=jnp.float32),
                jdk.precompute_position_features(
                    jm, variables, start, pos, dtype=jnp.float32),
                jdk.precompute_bias_rows(jm, variables, l_pad),
                jdk.precompute_cross_bias_rows(jm, variables, e_pad),
                jdk.precompute_mem_values(jm, variables, memory))

    j_params, j_posfull, j_bias, j_cross, (j_mem_k, j_mem_v) = tables(
        variables, memory)
    pad = [(0, 0), (0, 0), (0, e_pad - e_src), (0, 0)]
    j_mem = (jnp.pad(j_mem_k, pad), jnp.pad(j_mem_v, pad))

    # the port's tables, from its own module
    with torch.no_grad():
        t_memory = torch.as_tensor(np.array(memory))
        t_params = tdk.pack_decode_params(tm, dtype=torch.float32)
        t_pos = tm._positional_sequence("target")
        t_start = tm._start_block("target", {}, 1)
        # one sequence: row 0 of the port's [B, steps_pad, d] table
        t_posfull = tdk.precompute_position_features(
            tm, t_start, t_pos, dtype=torch.float32)[0]
        t_bias = tdk.precompute_bias_rows(tm, l_pad)
        t_cross = tdk.precompute_cross_bias_rows(tm, e_pad)
        t_mem_k, t_mem_v = tdk.precompute_mem_values(tm, t_memory)
    t_mem = tuple(torch.nn.functional.pad(m[:, 0], (0, 0, 0, e_pad - e_src))
                  for m in (t_mem_k, t_mem_v))
    return dict(
        jm=jm, variables=variables, tm=tm, cfg=cfg, c=c, l_pad=l_pad,
        e_src=e_src, e_pad=e_pad, condition=condition,
        j=dict(params=j_params, posfull=j_posfull, bias=j_bias,
               cross=j_cross, mem_kv=(j_mem_k, j_mem_v), mem=j_mem),
        t=dict(params=t_params, posfull=t_posfull, bias=t_bias,
               cross=t_cross, mem_kv=(t_mem_k, t_mem_v), mem=t_mem,
               bias_hm=t_bias.transpose(2, 3).contiguous(),
               cross_hm=(None if t_cross is None
                         else t_cross.transpose(2, 3).contiguous())))


def test_decode_tables_match(setup):
    j, t = setup["j"], setup["t"]
    for key, jv in j["params"].items():
        tv = t["params"][key]
        if key in WEIGHTS + ("w_logits",):
            tv = tv.transpose(-1, -2)  # the port stores [out, in]
        if key == "emb_padded":  # embed @ linear: a float32 product
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), key)
    np.testing.assert_array_equal(t["posfull"].numpy(),
                                  np.asarray(j["posfull"]))
    np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))
    if j["cross"] is None:
        assert t["cross"] is None
    else:
        np.testing.assert_array_equal(t["cross"].numpy(),
                                      np.asarray(j["cross"]))
    for jm_, tm_ in zip(j["mem_kv"], t["mem_kv"]):
        np.testing.assert_allclose(tm_.numpy(), np.asarray(jm_),
                                   atol=1e-5, rtol=1e-5)


def test_pack_decode_params_bf16_cast_matches(setup):
    jm, variables, tm = setup["jm"], setup["variables"], setup["tm"]
    jp = jdk.pack_decode_params(jm, variables, dtype=jnp.bfloat16)
    tp = tdk.pack_decode_params(tm, dtype=torch.bfloat16)
    for key in WEIGHTS:
        np.testing.assert_array_equal(
            tp[key].transpose(-1, -2).float().numpy(),
            np.asarray(jp[key]).astype(np.float32), key)


def prefix_inputs(setup, p0, seed):
    """Same known prefix through both packages' embedding tables."""
    cfg, c, l_pad = setup["cfg"], setup["c"], setup["l_pad"]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.n_class, cfg.target_sequence_length)
    with_start = np.concatenate([np.full(c, cfg.n_class), tokens])
    p_pad = min(jdk._round_up(p0, 128), l_pad)
    padded = np.pad(with_start, (0, l_pad - len(with_start)))[:p_pad]
    j, t = setup["j"], setup["t"]
    j_x = (jnp.take(j["params"]["emb_padded"], jnp.asarray(padded), axis=0)
           + j["posfull"][:p_pad])[None]
    t_x = (t["params"]["emb_padded"][torch.as_tensor(with_start[:p0])]
           + t["posfull"][:p0])
    return tokens, p_pad, j_x, t_x


def jax_prime(setup, p0, p_pad, j_x):
    j, cfg = setup["j"], setup["cfg"]
    n = cfg.conditional_model_num_decoder_layers
    bias_prefix = jnp.transpose(j["bias"][:, :p_pad, :p_pad, :], (0, 3, 1, 2))
    cross_prefix = (None if j["cross"] is None else
                    jnp.transpose(j["cross"][:, :p_pad], (0, 3, 1, 2)))
    kv = jnp.zeros((n, 2, 1, setup["l_pad"], cfg.d_model), jnp.float32)
    return np.asarray(jax_prefix_prime(
        j["params"], bias_prefix, j_x, j["mem"], kv, p0=p0,
        channels=setup["c"], cross_bias_prefix=cross_prefix,
        e_src_real=setup["e_src"], interpret=True))[:, :, 0]


def torch_prime(setup, p0, t_x):
    t, cfg = setup["t"], setup["cfg"]
    kv = torch.zeros(cfg.conditional_model_num_decoder_layers, 2,
                     setup["l_pad"], cfg.d_model)
    return fused_prefix_prime(
        t["params"], t["bias_hm"], t_x, t["mem"], kv, p0=p0,
        channels=setup["c"], cross_hm=t["cross_hm"],
        e_src_real=setup["e_src"])


def test_prefix_prime_matches_jax_kernel(setup):
    p0 = setup["c"] - 1 + 9
    _, p_pad, j_x, t_x = prefix_inputs(setup, p0, seed=5)
    kv_j = jax_prime(setup, p0, p_pad, j_x)
    with torch.no_grad():
        kv_t = torch_prime(setup, p0, t_x).numpy()
    np.testing.assert_allclose(kv_t[:, :, :p0], kv_j[:, :, :p0],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(kv_t[:, :, p0:p_pad], 0.0)
    np.testing.assert_array_equal(kv_j[:, :, p0:p_pad], 0.0)


@pytest.mark.parametrize("primed", [False, True])
def test_decode_scan_matches_jax_kernel(setup, primed):
    cfg, c, l_pad = setup["cfg"], setup["c"], setup["l_pad"]
    length = cfg.target_sequence_length
    scan_from = 9 if primed else 0
    p0 = c - 1 + scan_from if scan_from else 0
    steps = length + c - 1
    tokens, p_pad, j_x, t_x = prefix_inputs(setup, max(p0, 1), seed=7)
    rng = np.random.default_rng(11)
    mask = rng.random(length) < 0.5
    mask[:scan_from] = False
    gumbel = rng.gumbel(size=(steps - p0, cfg.n_class)).astype(np.float32)
    temperature = 0.7

    j, t = setup["j"], setup["t"]
    kv_j = (jnp.asarray(jax_prime(setup, p0, p_pad, j_x)) if primed
            else None)
    tokens_col = jnp.zeros((l_pad, 128), jnp.float32).at[:length, 0].set(
        tokens.astype(np.float32))
    mask_col = jnp.zeros((l_pad, 128), jnp.float32).at[:length, 0].set(
        mask.astype(np.float32))
    g_pad = np.pad(gumbel, ((0, l_pad - gumbel.shape[0]), (0, 0)))
    j_tokens = np.asarray(jax_decode_scan(
        j["params"], jnp.transpose(j["bias"], (0, 1, 3, 2)), j["posfull"],
        (j["mem"][0][:, 0], j["mem"][1][:, 0]), kv_j, tokens_col, mask_col,
        jnp.asarray(g_pad), temperature, p0=p0, steps=steps,
        n_class=cfg.n_class, channels=c,
        cross_rows=(None if j["cross"] is None
                    else jnp.transpose(j["cross"], (0, 1, 3, 2))),
        e_src_real=setup["e_src"], interpret=True))[:length, 0]

    with torch.no_grad():
        kv_t = torch_prime(setup, p0, t_x) if primed else None
        t_tokens, kv_final = fused_decode_scan(
            t["params"], t["bias_hm"], t["posfull"], t["mem"], kv_t,
            torch.as_tensor(tokens, dtype=torch.int32),
            torch.as_tensor(mask), torch.as_tensor(gumbel), temperature,
            p0=p0, steps=steps, n_class=cfg.n_class, channels=c,
            cross_hm=t["cross_hm"], e_src_real=setup["e_src"])
    np.testing.assert_array_equal(t_tokens.numpy(), j_tokens.astype(int))
    np.testing.assert_array_equal(t_tokens.numpy()[~mask], tokens[~mask])
    assert not np.array_equal(t_tokens.numpy()[mask], tokens[mask])
    assert kv_final.shape == (cfg.conditional_model_num_decoder_layers, 2,
                              l_pad, cfg.d_model)


def jax_gumbel(key, p0, steps, n_class):
    """The noise the JAX fused sampler draws for steps [p0, steps)."""
    keys = jax.random.split(key, steps)[p0:]
    return np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (n_class,)))(keys))


@pytest.mark.parametrize("masked_columns", [(1, 3), (0, 4)])
def test_sample_model_matches_jax(setup, masked_columns):
    jm, variables, tm, cfg = (setup["jm"], setup["variables"], setup["tm"],
                              setup["cfg"])
    rng = np.random.default_rng(13)
    initial = rng.integers(0, cfg.n_class, (1,) + cfg.shape)
    mask = np.zeros(cfg.shape, bool)
    mask[:, masked_columns[0]:masked_columns[1]] = True
    condition = None if cfg.self_conditional_model else setup["condition"]
    key = jax.random.PRNGKey(3)
    j_out = np.asarray(jax_sample_model(
        jm, variables, key, 1, condition=condition, initial_code=initial,
        mask=mask, temperature=1.0, use_fused_step=True))

    helper = tm.config.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    p0, steps = scan_range(tm, int(nz.min()), int(nz.max()) + 1)
    gumbel = torch.as_tensor(jax_gumbel(key, p0, steps, cfg.n_class))
    t_out = sample_model(
        tm, None, 1, condition=condition, initial_code=initial, mask=mask,
        temperature=1.0, gumbel=gumbel, device="cpu").numpy()
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out[0][~mask], initial[0][~mask])


def test_sample_model_refuses_unported_options(setup):
    """What the JAX sampler refuses on the fused path (its assertions), the
    port refuses with ``ValueError``; nothing else of ``sample_model`` is
    left unported."""
    jm, variables, tm = setup["jm"], setup["variables"], setup["tm"]
    cfg = setup["cfg"]
    condition = None if cfg.self_conditional_model else setup["condition"]
    for options in (dict(top_k_sampling_k=5), dict(top_p_sampling_p=0.5)):
        with pytest.raises(AssertionError):
            jax_sample_model(jm, variables, jax.random.PRNGKey(0), 1,
                             condition=condition, use_fused_step=True,
                             **options)
        with pytest.raises(ValueError, match="top-k/top-p"):
            sample_model(tm, None, 1, condition=condition, device="cpu",
                         **options)
    with pytest.raises(ValueError, match="codemap_size"):
        sample_model(tm, None, 1, condition=condition, codemap_size=(2, 2),
                     device="cpu")
    with pytest.raises(ValueError, match="gumbel has shape"):
        sample_model(tm, None, 2, condition=condition,
                     gumbel=torch.zeros(3, cfg.n_class), device="cpu")


# -- the whole-scan kernel's order of partial sums ----------------------------

@pytest.mark.parametrize("d_ff", [64, 2048, 2040])
def test_fc2_slices_cover_d_ff_once(d_ff):
    """Each block of the scan kernel takes a run of whole units of d_ff
    columns; together they take every column once, in order."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk)
    slices = dsk.fc2_slices(d_ff)
    assert len(slices) == dsk.CLUSTER * dsk.CLUSTERS
    real = [c for block in slices for c in block if c != d_ff]
    assert real == list(range(d_ff))
    for block in slices:
        cols = [c for c in block if c != d_ff]
        assert len(cols) % dsk.UNIT == 0
        assert not cols or cols == list(range(cols[0], cols[0] + len(cols)))


def test_scan_partials_add_up_to_the_products():
    """The plain scan's partial sums (a partial per head, per block of
    d_ff, clusters in order) add up to the whole products."""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_scan_kernel as dsk)
    gen = torch.Generator().manual_seed(0)
    d, nh, d_ff = 32, 4, 64
    a = torch.randn(d, generator=gen)
    wo = torch.randn(d, d, generator=gen)
    np.testing.assert_allclose(
        dsk.in_order(dsk.head_partials(a, wo, nh)).numpy(),
        (a @ wo.T).numpy(), atol=1e-5, rtol=1e-5)
    mid = torch.randn(d_ff, generator=gen)
    w2 = torch.randn(d, d_ff, generator=gen)
    idx = torch.tensor(dsk.fc2_slices(d_ff))
    w2_blocks = torch.cat([w2, w2.new_zeros(d, 1)], 1)[:, idx]
    np.testing.assert_allclose(
        dsk.fc2_in_kernel_order(mid, w2_blocks, idx).numpy(),
        (mid @ w2.T).numpy(), atol=1e-4, rtol=1e-5)
