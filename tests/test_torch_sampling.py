"""PyTorch port vs the JAX package: the batched and filtered samplers.

The step kernels' plain versions against the Pallas kernels (interpret mode,
as the JAX tests run them on the CPU), the flash decode attention, batched
prefix priming, and ``sample_model`` token for token with the JAX noise fed
in: fused at batch 2 and 8, the dense scan with top-k / top-p / flash /
bfloat16, predictive sampling, and the hierarchical cascade.

Tolerances are the JAX package's own: K/V within atol 3e-4 / rtol 1e-3
(``tests/test_fused_step.py``), flash attention within atol 2e-5 / rtol 1e-4
in float32 and 3e-2 in bfloat16 (``tests/test_ops.py``), tokens equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_prior import jit_method, make_prior
from interactive_spectrogram_inpainting_tpu.models.prior.transformer import (
    VQNSynthTransformer as JT)
from interactive_spectrogram_inpainting_tpu.ops import (
    decode_attention as jda, decode_step_kernel as jdk)
from interactive_spectrogram_inpainting_tpu.ops.decode_step_batched import (
    fused_decode_step_batched as jax_step_batched)
from interactive_spectrogram_inpainting_tpu.ops.prefix_prime_kernel import (
    fused_prefix_prime as jax_prefix_prime)
from interactive_spectrogram_inpainting_tpu import sampling as jsampling
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    decode_step_kernel as tdk)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention import (
    flash_decode_attention, reference_decode_attention)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_step_batched \
    import fused_decode_step_batched
from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
    import fused_prefix_prime
from interactive_spectrogram_inpainting_tpu_torch.sampling import (
    make_sampling_fn, sample_hierarchical, sample_model,
    top_k_top_p_filtering)
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    scan_range)

ATOL, RTOL = 3e-4, 1e-3


@pytest.fixture(scope="module")
def priors():
    return {variant: make_prior(variant) for variant in ("aligned", "cross")}


def step_tables(jm, variables, tm, batch, seed=0):
    """Both packages' decode tables for a batch of ``batch`` conditions."""
    cfg = jm.config
    rng = np.random.default_rng(seed)
    condition = rng.integers(0, cfg.n_class,
                             (batch,) + tuple(cfg.condition_shape))
    src = jit_method(jm, JT.prepare_sequence, kind="source")(
        variables, cfg.source_codemaps_helper().to_sequence(
            jnp.asarray(condition)))
    memory = jit_method(jm, JT.encode_source)(variables, src)
    c = cfg.target_num_channels
    l_pad = jdk._round_up(cfg.target_sequence_length + c, 128)
    e_src = memory.shape[1]
    e_pad = jdk._round_up(e_src, 128)
    pad = [(0, 0), (0, 0), (0, e_pad - e_src), (0, 0)]
    j_pos = jm.apply(variables, "target", None,
                     method=JT._positional_sequence)
    j_start = jm.apply(variables, "target", {}, batch, method=JT._start_block)
    j_mem = tuple(jnp.pad(m, pad) for m in jdk.precompute_mem_values(
        jm, variables, memory))
    j = dict(params=jdk.pack_decode_params(jm, variables, dtype=jnp.float32),
             posfull=jdk.precompute_position_features(
                 jm, variables, j_start, j_pos, dtype=jnp.float32),
             bias=jdk.precompute_bias_rows(jm, variables, l_pad),
             cross=jdk.precompute_cross_bias_rows(jm, variables, e_pad),
             mem=j_mem)
    with torch.no_grad():
        t_memory = torch.as_tensor(np.array(memory))
        t_mem = tuple(torch.nn.functional.pad(m, (0, 0, 0, e_pad - e_src))
                      for m in tdk.precompute_mem_values(tm, t_memory))
        t_cross = tdk.precompute_cross_bias_rows(tm, e_pad)
        t = dict(params=tdk.pack_decode_params(tm, dtype=torch.float32),
                 posfull=tdk.precompute_position_features(
                     tm, tm._start_block("target", {}, batch),
                     tm._positional_sequence("target"), dtype=torch.float32),
                 bias_hm=tdk.precompute_bias_rows(tm, l_pad).transpose(
                     2, 3).contiguous(),
                 cross_hm=(None if t_cross is None
                           else t_cross.transpose(2, 3).contiguous()),
                 mem=t_mem)
    return dict(cfg=cfg, c=c, l_pad=l_pad, e_src=e_src, j=j, t=t)


def step_inputs(tab, batch, n_steps, seed):
    cfg = tab["cfg"]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.n_class,
                          (batch, cfg.target_sequence_length))
    gumbel = rng.gumbel(size=(n_steps, batch, cfg.n_class)).astype(np.float32)
    # every third position keeps its current token
    masked = [p % 3 != 0 for p in range(n_steps)]
    return tokens, gumbel, masked


def token_at(tokens, p, c, n_class):
    batch = tokens.shape[0]
    col = (np.full(batch, n_class) if p < c else tokens[:, p - c])
    return col.astype(np.int32)[:, None]


@pytest.mark.parametrize("variant,batch", [
    ("aligned", 1), ("aligned", 2), ("cross", 1), ("cross", 2)])
def test_decode_step_matches_jax_kernel(priors, variant, batch):
    jm, variables, tm = priors[variant]
    tab = step_tables(jm, variables, tm, batch)
    cfg, c, l_pad = tab["cfg"], tab["c"], tab["l_pad"]
    n_layers = cfg.conditional_model_num_decoder_layers
    n_steps = 8
    tokens, gumbel, masked = step_inputs(tab, batch, n_steps, seed=21)
    cur = np.full((batch, 1), 7, np.int32)
    temperature = 0.8
    j, t = tab["j"], tab["t"]

    # the JAX loop first, then the port's (the fused step donates its cache)
    kv = jnp.zeros((n_layers, 2, batch, l_pad, cfg.d_model), jnp.float32)
    j_tokens = []
    for p in range(n_steps):
        new_tok, kv = jdk.fused_decode_step(
            j["params"], j["bias"][:, p], j["posfull"], j["mem"], kv,
            jnp.asarray(token_at(tokens, p, c, cfg.n_class)),
            jnp.asarray(cur), jnp.asarray(p), jnp.asarray(p - (c - 1)),
            jnp.asarray(int(masked[p])), jnp.asarray(gumbel[p]), temperature,
            n_class=cfg.n_class, channels=c,
            cross_bias_step=(None if j["cross"] is None
                             else j["cross"][:, p]),
            e_src_real=tab["e_src"], interpret=True)
        j_tokens.append(np.asarray(new_tok))
    kv_j = np.asarray(kv)

    kv_t = torch.zeros(n_layers, 2, batch, l_pad, cfg.d_model)
    with torch.no_grad():
        for p in range(n_steps):
            new_tok, kv_t = tdk.fused_decode_step(
                t["params"], t["bias_hm"], t["posfull"], t["mem"], kv_t,
                torch.as_tensor(token_at(tokens, p, c, cfg.n_class)),
                torch.as_tensor(cur), p, p - (c - 1), masked[p],
                torch.as_tensor(gumbel[p]), temperature,
                n_class=cfg.n_class, channels=c, cross_hm=t["cross_hm"],
                e_src_real=tab["e_src"])
            np.testing.assert_array_equal(new_tok.numpy(), j_tokens[p],
                                          f"step {p}")
            if not masked[p] or p < c - 1:
                np.testing.assert_array_equal(new_tok.numpy(), cur)
    np.testing.assert_allclose(kv_t.numpy()[:, :, :, :n_steps],
                               kv_j[:, :, :, :n_steps], atol=ATOL, rtol=RTOL)


def test_decode_step_batched_matches_jax_kernel(priors):
    jm, variables, tm = priors["aligned"]
    batch = 8
    tab = step_tables(jm, variables, tm, batch)
    cfg, c, l_pad = tab["cfg"], tab["c"], tab["l_pad"]
    n_layers = cfg.conditional_model_num_decoder_layers
    n_steps = 8
    tokens, gumbel, masked = step_inputs(tab, batch, n_steps, seed=22)
    cur = np.full((batch, 1), 7, np.int32)
    temperature = 0.8
    j, t = tab["j"], tab["t"]

    # the JAX kernel's own layouts: cache [l_pad, B, d], memory [E, B, d]
    kv = jnp.zeros((n_layers, 2, l_pad, batch, cfg.d_model), jnp.float32)
    mem_v_t = jnp.transpose(j["mem"][1], (0, 2, 1, 3))
    j_tokens = []
    for p in range(n_steps):
        new_tok, kv = jax_step_batched(
            j["params"], j["bias"][:, p], j["posfull"], mem_v_t, kv,
            jnp.asarray(token_at(tokens, p, c, cfg.n_class)),
            jnp.asarray(cur), jnp.asarray(p), jnp.asarray(p - (c - 1)),
            jnp.asarray(int(masked[p])), jnp.asarray(gumbel[p]), temperature,
            n_class=cfg.n_class, channels=c, block_k=128, interpret=True)
        j_tokens.append(np.asarray(new_tok))
    kv_j = np.transpose(np.asarray(kv), (0, 1, 3, 2, 4))

    kv_t = torch.zeros(n_layers, 2, batch, l_pad, cfg.d_model)
    with torch.no_grad():
        for p in range(n_steps):
            new_tok, kv_t = fused_decode_step_batched(
                t["params"], t["bias_hm"], t["posfull"], t["mem"][1], kv_t,
                torch.as_tensor(token_at(tokens, p, c, cfg.n_class)),
                torch.as_tensor(cur), p, p - (c - 1), masked[p],
                torch.as_tensor(gumbel[p]), temperature,
                n_class=cfg.n_class, channels=c)
            np.testing.assert_array_equal(new_tok.numpy(), j_tokens[p],
                                          f"step {p}")
    np.testing.assert_allclose(kv_t.numpy()[:, :, :, :n_steps],
                               kv_j[:, :, :, :n_steps], atol=ATOL, rtol=RTOL)


def test_decode_step_writes_in_place(priors):
    """``out=`` may be ``cur_token`` itself: the sampler's loop relies on
    it."""
    jm, variables, tm = priors["aligned"]
    tab = step_tables(jm, variables, tm, 2)
    cfg, c, t = tab["cfg"], tab["c"], tab["t"]
    kv = torch.zeros(cfg.conditional_model_num_decoder_layers, 2, 2,
                     tab["l_pad"], cfg.d_model)
    gumbel = torch.zeros(2, cfg.n_class)
    start = torch.full((2, 1), cfg.n_class, dtype=torch.int32)
    results = []
    for masked in (True, False):
        cur = torch.full((2, 1), 5, dtype=torch.int32)
        with torch.no_grad():
            new_tok, _ = tdk.fused_decode_step(
                t["params"], t["bias_hm"], t["posfull"], t["mem"],
                kv.clone(), start, cur, c - 1, 0, masked, gumbel, 1.0,
                n_class=cfg.n_class, channels=c, out=cur)
        assert new_tok is cur
        results.append(cur.clone())
    assert (results[1] == 5).all()
    assert ((results[0] >= 0) & (results[0] < cfg.n_class)).all()


@pytest.mark.parametrize("pos", [0, 5, 127, 128, 300, 511])
def test_flash_decode_attention_matches_jax(pos):
    rng = np.random.default_rng(0)
    B, L, H, Dh = 3, 512, 8, 64  # an odd batch
    q, k, v, bias = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Dh), (B, L, H, Dh), (B, L, H, Dh), (H, L)))
    j_out = np.asarray(jda.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
        jnp.asarray(bias), interpret=True))
    j_ref = np.asarray(jda.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
        jnp.asarray(bias)))
    tq, tk, tv, tb = (torch.as_tensor(a) for a in (q, k, v, bias))
    out = flash_decode_attention(tq, tk, tv, pos, tb).numpy()
    ref = reference_decode_attention(tq, tk, tv, pos, tb).numpy()
    np.testing.assert_allclose(out, j_out, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ref, j_ref, atol=2e-5, rtol=1e-4)


def test_flash_decode_attention_bf16_no_bias():
    rng = np.random.default_rng(1)
    B, L, H, Dh = 2, 256, 4, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Dh), (B, L, H, Dh), (B, L, H, Dh)))
    j_out = np.asarray(jda.flash_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), 100, None,
        interpret=True).astype(jnp.float32))
    out = flash_decode_attention(
        torch.as_tensor(q).bfloat16(), torch.as_tensor(k).bfloat16(),
        torch.as_tensor(v).bfloat16(), 100, None)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), j_out, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_prefix_prime_batch_matches_jax_kernel(priors, variant):
    jm, variables, tm = priors[variant]
    batch = 2
    tab = step_tables(jm, variables, tm, batch)
    cfg, c, l_pad = tab["cfg"], tab["c"], tab["l_pad"]
    n_layers = cfg.conditional_model_num_decoder_layers
    j, t = tab["j"], tab["t"]
    p0 = c - 1 + 9
    p_pad = min(jdk._round_up(p0, 128), l_pad)
    rng = np.random.default_rng(23)
    tokens = rng.integers(0, cfg.n_class,
                          (batch, cfg.target_sequence_length))
    with_start = np.concatenate(
        [np.full((batch, c), cfg.n_class), tokens], axis=1)
    padded = np.pad(with_start,
                    ((0, 0), (0, l_pad - with_start.shape[1])))[:, :p_pad]
    j_x = (jnp.take(j["params"]["emb_padded"], jnp.asarray(padded), axis=0)
           + j["posfull"][:p_pad][None])
    bias_prefix = jnp.transpose(j["bias"][:, :p_pad, :p_pad, :],
                                (0, 3, 1, 2))
    cross_prefix = (None if j["cross"] is None else
                    jnp.transpose(j["cross"][:, :p_pad], (0, 3, 1, 2)))
    kv_j = np.asarray(jax_prefix_prime(
        j["params"], bias_prefix, j_x, j["mem"],
        jnp.zeros((n_layers, 2, batch, l_pad, cfg.d_model), jnp.float32),
        p0=p0, channels=c, cross_bias_prefix=cross_prefix,
        e_src_real=tab["e_src"], interpret=True))

    t_x = (t["params"]["emb_padded"][torch.as_tensor(with_start[:, :p0])]
           + t["posfull"][:, :p0])
    with torch.no_grad():
        kv_t = fused_prefix_prime(
            t["params"], t["bias_hm"], t_x, t["mem"],
            torch.zeros(n_layers, 2, batch, l_pad, cfg.d_model), p0=p0,
            channels=c, cross_hm=t["cross_hm"],
            e_src_real=tab["e_src"]).numpy()
    np.testing.assert_allclose(kv_t[:, :, :, :p0], kv_j[:, :, :, :p0],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(kv_t[:, :, :, p0:p_pad], 0.0)
    assert not np.allclose(kv_t[:, :, 0, :p0], kv_t[:, :, 1, :p0])


# -- sample_model, token for token ---------------------------------------------

def jax_step_gumbel(key, p0, steps, shape):
    """The noise the JAX samplers draw for steps [p0, steps): one key per
    position (split by absolute position), ``shape`` values per key."""
    keys = jax.random.split(key, steps)[p0:]
    return torch.as_tensor(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, shape))(keys)))


def inpaint_case(cfg, batch, columns, seed):
    rng = np.random.default_rng(seed)
    initial = rng.integers(0, cfg.n_class, (batch,) + tuple(cfg.shape))
    mask = np.zeros(cfg.shape, bool)
    mask[:, columns[0]:columns[1]] = True
    condition = (None if cfg.self_conditional_model else rng.integers(
        0, cfg.n_class, (batch,) + tuple(cfg.condition_shape)))
    return initial, mask, condition


def bounds(tm, mask):
    helper = tm.config.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    return int(nz.min()), int(nz.max()) + 1


@pytest.mark.parametrize("variant,batch", [
    ("aligned", 2), ("aligned", 8), ("cross", 2)])
def test_fused_sample_model_batch_matches_jax(priors, variant, batch):
    """Fused sampler at batch 2 (step kernel), 8 (batched kernel) and the
    relative-bias top prior at batch 2: primed and bounded by the mask."""
    jm, variables, tm = priors[variant]
    cfg = jm.config
    initial, mask, condition = inpaint_case(cfg, batch, (1, 2), seed=31)
    key = jax.random.PRNGKey(5)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, use_fused_step=True))
    sf, su = bounds(tm, mask)
    p0, steps = scan_range(tm, sf, su)
    assert 0 < p0 < steps < cfg.target_sequence_length + tm.config.\
        target_num_channels - 1
    gumbel = jax_step_gumbel(key, p0, steps, (batch, cfg.n_class))
    t_out = sample_model(
        tm, None, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, gumbel=gumbel, device="cpu").numpy()
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])
    assert not np.array_equal(t_out[0], t_out[1])


@pytest.fixture(scope="module")
def pitch_prior():
    """The tiny aligned bottom prior with a pitch label prepended to its
    start rows, so that each batch row can start from its own label."""
    from tests.test_transformer import tiny_config
    from interactive_spectrogram_inpainting_tpu.models.prior import (
        UpsamplingVQTransformer)
    from tests.test_torch_prior import port_prior
    import functools
    cfg = tiny_config(
        use_aligned_decoder=True,
        class_conditioning_num_classes_per_modality={"pitch": 5},
        class_conditioning_embedding_dim_per_modality={"pitch": 4},
        class_conditioning_prepend_to_dummy_input=True)
    jm = UpsamplingVQTransformer(cfg)
    cc = {"pitch": jnp.zeros((1,), jnp.int32)}
    variables = jax.jit(functools.partial(jm.init, method=JT.full_init))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1,) + cfg.shape, jnp.int32),
        jnp.zeros((1,) + cfg.condition_shape, jnp.int32),
        class_conditioning=cc)
    return jm, variables, port_prior(jm, variables)


@pytest.mark.parametrize("batch,inpaint", [(2, False), (2, True), (8, True)],
                         ids=["step_b2", "step_b2_primed",
                              "batched_b8_primed"])
def test_fused_sample_model_per_row_pitch_matches_dense(pitch_prior, batch,
                                                        inpaint):
    """With one class label per batch row, the fused sampler's greedy
    tokens equal the JAX package's *dense* sampler's: every row decodes
    from its own start rows, at batch 2 (``fused_decode_step``, primed by
    ``fused_prefix_prime`` when inpainting) and 8
    (``fused_decode_step_batched``, primed through ``prefix_kv``). (The JAX
    fused path builds the start rows of row 0 for the whole batch.)"""
    from interactive_spectrogram_inpainting_tpu_torch.ops import (
        decode_step_batched as tsb)
    jm, variables, tm = pitch_prior
    cfg = jm.config
    rng = np.random.default_rng(41)
    condition = rng.integers(0, cfg.n_class,
                             (batch,) + tuple(cfg.condition_shape))
    pitches = np.array([1, 3, 0, 4, 2, 3, 1, 0])[:batch]
    initial = mask = None
    sf = su = None
    if inpaint:
        initial = rng.integers(0, cfg.n_class, (batch,) + tuple(cfg.shape))
        mask = np.zeros(cfg.shape, bool)
        mask[:, 1:3] = True
        sf, su = bounds(tm, mask)
    key = jax.random.PRNGKey(6)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, class_conditioning={"pitch": jnp.asarray(pitches)},
        temperature=1e-6, use_fused_step=False))
    p0, steps = scan_range(tm, sf, su)
    assert (p0 > 0) == inpaint
    gumbel = jax_step_gumbel(key, p0, steps, (batch, cfg.n_class))
    calls = []
    batched = tsb.decode_step_batched_plain
    tsb.decode_step_batched_plain = lambda *a, **k: (
        calls.append(1), batched(*a, **k))[1]
    try:
        t_out = sample_model(
            tm, None, batch, condition=condition, initial_code=initial,
            mask=mask, class_conditioning={"pitch": pitches},
            temperature=1e-6, gumbel=gumbel, device="cpu").numpy()
    finally:
        tsb.decode_step_batched_plain = batched
    assert bool(calls) == (batch > 4)
    np.testing.assert_array_equal(t_out, j_out)
    if inpaint:
        np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])
    # the rows' labels matter: row 1 alone under row 0's label differs
    alone = sample_model(
        tm, None, 1, condition=condition[1:2],
        initial_code=None if initial is None else initial[1:2], mask=mask,
        class_conditioning={"pitch": pitches[:1]}, temperature=1e-6,
        gumbel=gumbel[:, 1], device="cpu").numpy()
    assert not np.array_equal(alone[0], t_out[1])


@pytest.mark.parametrize("options", [
    dict(top_k_sampling_k=4), dict(top_p_sampling_p=0.8),
    dict(use_flash=True), dict(top_k_sampling_k=3, scan_from=0)],
    ids=["top_k", "top_p", "flash", "top_k_unprimed"])
@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_dense_sample_model_matches_jax(priors, variant, options):
    jm, variables, tm = priors[variant]
    cfg = jm.config
    batch = 2
    initial, mask, condition = inpaint_case(cfg, batch, (1, 3), seed=32)
    key = jax.random.PRNGKey(7)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, **options))
    sf, su = bounds(tm, mask)
    p0, steps = scan_range(tm, options.get("scan_from", sf), su)
    gumbel = jax_step_gumbel(key, p0, steps, (batch, cfg.n_class))
    t_out = sample_model(
        tm, None, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, use_fused_step=False, gumbel=gumbel,
        device="cpu", **options).numpy()
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])


def test_dense_sample_model_bf16_matches_jax(priors):
    """bfloat16 ``compute_dtype``: both packages cast weights, memory and
    activations; the logits and the sampling stay float32. A float32 sum
    taken in another order can flip the rounding of a bfloat16 activation
    and with it a token whose two best noisy logits nearly tie, so up to
    one token in 16 may differ (the float32 cases are held to equality)."""
    jm, variables, tm = priors["aligned"]
    cfg = jm.config
    batch = 2
    initial, mask, condition = inpaint_case(cfg, batch, (1, 3), seed=33)
    key = jax.random.PRNGKey(8)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, compute_dtype=jnp.bfloat16))
    sf, su = bounds(tm, mask)
    p0, steps = scan_range(tm, sf, su)
    gumbel = jax_step_gumbel(key, p0, steps, (batch, cfg.n_class))
    t_out = sample_model(
        tm, None, batch, condition=condition, initial_code=initial,
        mask=mask, use_fused_step=False, compute_dtype=torch.bfloat16,
        gumbel=gumbel, device="cpu").numpy()
    np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])
    assert np.mean(t_out[:, mask] != j_out[:, mask]) <= 1 / 16


@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_predictive_sample_model_matches_jax(priors, variant):
    jm, variables, tm = priors[variant]
    cfg = jm.config
    batch = 1
    initial, mask, condition = inpaint_case(cfg, batch, (1, 3), seed=34)
    key = jax.random.PRNGKey(9)
    j_out, j_diag = jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.5, use_predictive_sampling=True,
        return_diagnostics=True)
    gumbel = torch.as_tensor(np.array(jax.random.gumbel(
        key, (batch, cfg.target_sequence_length, cfg.n_class))))
    t_out, t_diag = sample_model(
        tm, None, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.5, use_predictive_sampling=True,
        return_diagnostics=True, gumbel=gumbel, device="cpu")
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert t_diag["num_forwards"] == int(j_diag["num_forwards"])
    assert t_diag["num_steps"] == int(j_diag["num_steps"])
    assert 0 < t_diag["num_forwards"] <= int(mask.sum())


@pytest.mark.parametrize("batch", [1, 2])
def test_predictive_from_scratch_greedy_matches_dense(priors, batch):
    """Predictive sampling with no initial code on the self-conditional top
    prior, whose codemap then starts as the mask token everywhere: the
    greedy tokens equal the JAX dense sampler's (the JAX package's own
    contract, ``test_predictive_sampling_greedy_matches_scan``). The JAX
    predictive sampler embeds NaN for the mask token and forces token 0 at
    position 0 instead."""
    jm, variables, tm = priors["cross"]
    cfg = jm.config
    assert cfg.self_conditional_model
    key = jax.random.PRNGKey(10)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, temperature=1e-6, use_fused_step=False))
    gumbel = torch.zeros(batch, cfg.target_sequence_length, cfg.n_class)
    t_out, diag = sample_model(
        tm, None, batch, temperature=1e-6, use_predictive_sampling=True,
        return_diagnostics=True, gumbel=gumbel, device="cpu")
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert 0 < diag["num_forwards"] <= cfg.target_sequence_length


def test_top_k_top_p_filtering_matches_jax():
    rng = np.random.default_rng(35)
    logits = rng.standard_normal((3, 5, 16)).astype(np.float32)
    logits[0, 0, :4] = logits[0, 0, 4]  # ties at the threshold
    logits[1, 2] = 0.25  # a constant row
    logits = np.round(logits * 4) / 4  # more ties
    for top_k, top_p in ((0, 0.0), (4, 0.0), (0, 0.8), (3, 0.6), (40, 0.99),
                         (1, 0.0), (0, 1e-3)):
        expected = np.asarray(jsampling.top_k_top_p_filtering(
            jnp.asarray(logits), top_k=top_k, top_p=top_p))
        got = top_k_top_p_filtering(torch.as_tensor(logits), top_k=top_k,
                                    top_p=top_p).numpy()
        np.testing.assert_array_equal(got, expected, f"{top_k} {top_p}")


def test_sample_hierarchical_greedy_matches_jax(priors):
    jm_b, vars_b, tm_b = priors["aligned"]
    # a top prior whose shape is the bottom prior's condition shape
    from tests.test_transformer import tiny_config
    from interactive_spectrogram_inpainting_tpu.models.prior import (
        SelfAttentiveVQTransformer)
    from tests.test_torch_prior import port_prior
    import functools
    cfg_t = tiny_config(shape=(4, 2), condition_shape=(4, 2),
                        conditional_model_num_decoder_layers=2)
    jm_t = SelfAttentiveVQTransformer(cfg_t)
    cfg_t = jm_t.config
    vars_t = jax.jit(functools.partial(jm_t.init, method=JT.full_init))(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + cfg_t.shape, jnp.int32),
        jnp.zeros((1,) + cfg_t.condition_shape, jnp.int32))
    tm_t = port_prior(jm_t, vars_t)
    rng = np.random.default_rng(36)
    top0 = rng.integers(0, 16, (1,) + tuple(cfg_t.shape))
    bottom0 = rng.integers(0, 16, (1,) + tuple(jm_b.config.shape))
    mask_top = np.zeros(cfg_t.shape, bool)
    mask_top[:, 1:] = True
    j_top, j_bottom = jsampling.sample_hierarchical(
        jm_t, vars_t, jm_b, vars_b, jax.random.PRNGKey(2), 1,
        temperature=1e-6, initial_code_top=top0,
        initial_code_bottom=bottom0, mask_top=mask_top)
    t_top, t_bottom = sample_hierarchical(
        tm_t, tm_b, torch.Generator().manual_seed(0), 1, temperature=1e-6,
        initial_code_top=top0, initial_code_bottom=bottom0,
        mask_top=mask_top, device="cpu")
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    np.testing.assert_array_equal(t_bottom.numpy(), np.asarray(j_bottom))
    assert not np.array_equal(t_top.numpy()[0][mask_top], top0[0][mask_top])


def test_make_sampling_fn_binds_options(priors):
    jm, variables, tm = priors["aligned"]
    cfg = jm.config
    initial, mask, condition = inpaint_case(cfg, 1, (1, 3), seed=37)
    sf, su = bounds(tm, mask)
    p0, steps = scan_range(tm, sf, su)
    gumbel = torch.as_tensor(np.random.default_rng(38).gumbel(
        size=(steps - p0, 1, cfg.n_class)).astype(np.float32))
    fn = make_sampling_fn(tm, 1, temperature=0.7, top_k=4, scan_from=sf,
                          scan_until=su, device="cpu")
    out = fn(None, condition, initial, mask, {}, gumbel=gumbel)
    direct = sample_model(
        tm, None, 1, temperature=0.7, condition=condition,
        initial_code=initial, mask=mask, top_k_sampling_k=4,
        use_fused_step=False, gumbel=gumbel, device="cpu")
    assert torch.equal(out, direct)
    np.testing.assert_array_equal(out.numpy()[0][~mask], initial[0][~mask])


@pytest.mark.parametrize("primed", [True, False], ids=["primed", "from_0"])
@pytest.mark.parametrize("variant", ["aligned", "cross"])
def test_fused_b1_sample_model_matches_jax_dense(priors, variant, primed):
    """Batch 1, the whole-scan kernel's path (on the CPU its plain version,
    which adds its partial sums in the kernel's order), token for token
    against the JAX dense sampler: primed by the mask's known prefix, or
    scanned from position 0."""
    jm, variables, tm = priors[variant]
    cfg = jm.config
    initial, mask, condition = inpaint_case(cfg, 1, (1, 3), seed=34)
    options = {} if primed else dict(scan_from=0)
    key = jax.random.PRNGKey(9)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, 1, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, use_fused_step=False, **options))
    sf, su = bounds(tm, mask)
    p0, steps = scan_range(tm, options.get("scan_from", sf), su)
    assert (p0 > 0) == primed
    gumbel = jax_step_gumbel(key, p0, steps, (1, cfg.n_class))[:, 0]
    t_out = sample_model(
        tm, None, 1, condition=condition, initial_code=initial, mask=mask,
        temperature=0.9, gumbel=gumbel, device="cpu", **options).numpy()
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])
