"""PyTorch port vs the JAX package: codemaps and the prior transformer.

The same numpy inputs go through both packages; the port's weights come
from the JAX variables through ``utils.weights.from_flax_params``. Priors
are compared in float32 at the JAX package's decode-step tolerance
(atol 3e-4 / rtol 1e-3, ``tests/test_fused_step.py``)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_transformer import tiny_config, top_config
from interactive_spectrogram_inpainting_tpu.models.prior import (
    SelfAttentiveVQTransformer, UpsamplingVQTransformer)
from interactive_spectrogram_inpainting_tpu.models.prior import (
    codemaps as jax_codemaps)
from interactive_spectrogram_inpainting_tpu.models.prior.transformer import (
    VQNSynthTransformer as JT)
from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    codemaps as torch_codemaps)
from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    transformer as tt)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)

ATOL, RTOL = 3e-4, 1e-3


def port_prior(jax_model, variables):
    """The port's prior with the JAX model's config and weights."""
    cfg = tt.TransformerConfig.from_json(jax_model.config.to_json())
    model = tt.VQNSynthTransformer(cfg)
    model.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, variables)))
    return model.eval()


def jit_method(model, method, **kwargs):
    return jax.jit(functools.partial(model.apply, method=method, **kwargs))


def make_prior(variant, n_layers=2):
    if variant == "aligned":
        cfg = tiny_config(use_aligned_decoder=True,
                          conditional_model_num_decoder_layers=n_layers)
        jm = UpsamplingVQTransformer(cfg)
    else:
        jm = SelfAttentiveVQTransformer(top_config(
            conditional_model_num_decoder_layers=n_layers))
    cfg = jm.config
    variables = jax.jit(functools.partial(jm.init, method=JT.full_init))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1,) + cfg.shape, jnp.int32),
        jnp.zeros((1,) + cfg.condition_shape, jnp.int32))
    return jm, variables, port_prior(jm, variables)


@pytest.fixture(scope="module", params=["aligned", "cross"])
def priors(request):
    return make_prior(request.param)


@pytest.mark.parametrize("helper", [
    ("Simple", (8, 4), ()), ("ZigZag", (8, 4), (2, 2)),
    ("ZigZag", (64, 8), (2, 2)), ("Simple", (32, 4), ())])
def test_codemaps_match_exactly(helper):
    kind, shape, patch = helper
    jh = getattr(jax_codemaps, f"{kind}CodemapsHelper")(*shape, *patch)
    th = getattr(torch_codemaps, f"{kind}CodemapsHelper")(*shape, *patch)
    np.testing.assert_array_equal(jh.flatten_permutation,
                                  th.flatten_permutation)
    rng = np.random.default_rng(0)
    codemap = rng.integers(0, 512, (2,) + shape)
    j_seq = np.asarray(jh.to_sequence(jnp.asarray(codemap)))
    t_seq = th.to_sequence(torch.as_tensor(codemap)).numpy()
    np.testing.assert_array_equal(j_seq, t_seq)
    np.testing.assert_array_equal(
        np.asarray(jh.to_time_frequency_map(jnp.asarray(j_seq))),
        th.to_time_frequency_map(torch.as_tensor(t_seq)).numpy())
    feats = rng.normal(size=(2,) + shape + (3,)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jh.to_sequence(jnp.asarray(feats))),
        th.to_sequence(torch.as_tensor(feats)).numpy())


def sequences(jm, variables, tm, seed):
    cfg = jm.config
    rng = np.random.default_rng(seed)
    codemap = rng.integers(0, cfg.n_class, (1,) + cfg.shape)
    condition = rng.integers(0, cfg.n_class, (1,) + cfg.condition_shape)
    mask = (rng.random((1,) + cfg.condition_shape) < 0.5
            if cfg.self_conditional_model else None)
    j_src, j_tgt = jit_method(jm, JT.to_sequences)(
        variables, jnp.asarray(codemap), jnp.asarray(condition),
        mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        t_src, t_tgt = tm.to_sequences(
            torch.as_tensor(codemap), torch.as_tensor(condition),
            mask=None if mask is None else torch.as_tensor(mask))
    return j_src, j_tgt, t_src, t_tgt


def test_prior_logits_and_memory(priors):
    jm, variables, tm = priors
    j_src, j_tgt, t_src, t_tgt = sequences(jm, variables, tm, 1)
    np.testing.assert_allclose(t_src.numpy(), np.asarray(j_src),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_tgt.numpy(), np.asarray(j_tgt),
                               atol=1e-6, rtol=1e-6)
    j_logits, j_mem = jax.jit(jm.apply)(variables, j_tgt, j_src)
    with torch.no_grad():
        t_mem = tm.encode_source(t_src)
        t_logits, _ = tm(t_tgt, t_src)
    np.testing.assert_allclose(t_mem.numpy(), np.asarray(j_mem),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=RTOL)


def test_prior_prefix_kv(priors):
    jm, variables, tm = priors
    j_src, j_tgt, t_src, t_tgt = sequences(jm, variables, tm, 2)
    j_mem = jit_method(jm, JT.encode_source)(variables, j_src)
    p = 11
    j_kvs = jit_method(jm, JT.prefix_kv)(variables, j_tgt[:, :p], j_mem)
    with torch.no_grad():
        t_kvs = tm.prefix_kv(t_tgt[:, :p], tm.encode_source(t_src))
    for (jk, jv), (tk, tv) in zip(j_kvs, t_kvs):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   atol=ATOL, rtol=RTOL)


def test_prior_decode_step(priors):
    jm, variables, tm = priors
    cfg = jm.config
    c = cfg.target_num_channels
    j_src, _, t_src, _ = sequences(jm, variables, tm, 3)
    j_mem = jit_method(jm, JT.encode_source)(variables, j_src)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.n_class, cfg.target_sequence_length)
    j_pos = jm.apply(variables, "target", None,
                     method=JT._positional_sequence)
    j_start = jm.apply(variables, "target", {}, 1, method=JT._start_block)
    j_caches = jm.apply(variables, j_mem, 1, layout="blhd",
                        method=JT.init_decode_caches)
    j_embed = jit_method(jm, JT.target_input_embedding)
    j_step = jax.jit(functools.partial(jm.apply, layout="blhd",
                                       method=JT.decode_step))
    with torch.no_grad():
        t_mem = tm.encode_source(t_src)
        t_pos = tm._positional_sequence("target")
        t_start = tm._start_block("target", {}, 1)
        t_caches = tm.init_decode_caches(t_mem, 1)
        np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos))
        np.testing.assert_allclose(t_start.numpy(), np.asarray(j_start))
        for p in range(c + 9):
            tok = int(tokens[p - c]) if p >= c else 0
            j_x = j_embed(variables, jnp.asarray([tok]), jnp.asarray(p),
                          j_pos, j_start, None)
            j_logits, j_caches = j_step(variables, j_x, jnp.asarray(p),
                                        j_caches)
            t_x = tm.target_input_embedding(torch.tensor([tok]), p, t_pos,
                                            t_start)
            np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x),
                                       atol=1e-6, rtol=1e-6)
            t_logits, t_caches = tm.decode_step(t_x, p, t_caches)
            np.testing.assert_allclose(t_logits.numpy(),
                                       np.asarray(j_logits),
                                       atol=ATOL, rtol=RTOL)
    for (jk, jv), (tk, tv) in zip(j_caches["self"], t_caches["self"]):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   atol=ATOL, rtol=RTOL)
