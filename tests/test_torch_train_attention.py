"""PyTorch port vs the JAX package: the training attention and the priors'
attention layers in training mode.

The same numpy inputs go through the JAX package's
``fused_train_attention`` (its Pallas kernels in interpret mode on the CPU)
and ``reference_train_attention``, and through the port's plain version
(``reference_train_attention`` with autograd, the written-out
``reference_train_attention_backward``) and its ``autograd.Function`` on
the CPU. Tolerances are the JAX package's own
(``tests/test_train_attention.py``): forward atol/rtol 1e-5, every
gradient (``dab`` included) atol 2e-4 / rtol 1e-4, bfloat16 3e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.ops import (
    train_attention as jax_ta)
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    train_attention as ta)

NEG_INF = -1e9


def masks(lq, lk):
    i = np.arange(lq)
    e_q = i // 4
    return {
        None: None,
        "causal": np.where(i[:, None] >= np.arange(lk)[None], 0.0, NEG_INF),
        "anti_causal": np.where(i[:, None] <= np.arange(lk)[None], 0.0,
                                NEG_INF),
        "aligned": np.where(e_q[:, None] == np.arange(lk)[None], 0.0,
                            NEG_INF),
        # rows 0-2 see no key at all: a uniform softmax over -1e9 scores
        "fully_masked_rows": np.where(i[:, None] >= 3, 0.0,
                                      NEG_INF) * np.ones((1, lk)),
    }


def make_inputs(seed, batch, lq, lk, heads, dh, mask=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, lq, heads, dh)).astype(np.float32)
    k = rng.standard_normal((batch, lk, heads, dh)).astype(np.float32)
    v = rng.standard_normal((batch, lk, heads, dh)).astype(np.float32)
    ab = rng.standard_normal((heads, lq, lk)).astype(np.float32)
    if mask is not None:
        ab = (ab + mask[None]).astype(np.float32)
    dout = rng.standard_normal((batch, lq, heads, dh)).astype(np.float32)
    return q, k, v, ab, dout


def jax_grads(fn, q, k, v, ab, dout, dtype=jnp.float32):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)] + [
        jnp.asarray(ab)]
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(dout).astype(out.dtype))
    return [np.asarray(x, np.float32) for x in (out,) + tuple(grads)]


def torch_grads(fn, q, k, v, ab, dout, dtype=torch.float32):
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    leaves.append(torch.tensor(ab).requires_grad_())
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(dout).to(out.dtype))
    return [x.detach().float().numpy() for x in (out,) + grads]


NAMES = ["out", "dq", "dk", "dv", "dab"]


def assert_all_close(got, want, fwd_tol, grad_tol):
    for name, g, w in zip(NAMES, got, want):
        tol = fwd_tol if name == "out" else grad_tol
        np.testing.assert_allclose(g, w, atol=tol[0], rtol=tol[1],
                                   err_msg=name)


@pytest.mark.parametrize("shape,mask", [
    ((3, 37, 21, 2, 8), None),                  # ragged everything
    ((2, 33, 33, 2, 16), "causal"),
    ((2, 29, 29, 3, 24), "anti_causal"),        # odd heads, small Dh
    ((2, 24, 6, 2, 8), "aligned"),              # cross attention
    ((2, 12, 12, 2, 8), "fully_masked_rows"),
])
def test_plain_matches_both_jax_functions(shape, mask):
    batch, lq, lk, heads, dh = shape
    inputs = make_inputs(0, *shape, mask=masks(lq, lk)[mask])
    got = torch_grads(ta.reference_train_attention, *inputs)
    # a row that sees no key is uniform over its keys in the dense
    # formula; the Pallas kernel pads the keys to 128 with -1e9 columns,
    # which then join that row's softmax, so only the dense function is
    # its reference there
    fns = [jax_ta.reference_train_attention]
    if mask != "fully_masked_rows":
        fns.append(jax_ta.fused_train_attention)
    for fn in fns:
        assert_all_close(got, jax_grads(fn, *inputs), (1e-5, 1e-5),
                         (2e-4, 1e-4))
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("shape,mask", [
    ((3, 37, 21, 2, 8), None),
    ((2, 29, 29, 3, 24), "anti_causal"),
    ((2, 24, 6, 2, 8), "aligned"),
    ((2, 12, 12, 2, 8), "fully_masked_rows"),
])
def test_written_backward_and_autograd_function_match(shape, mask):
    """The backward the kernels compute, written out, and the port's
    autograd.Function on CPU tensors equal autograd of the plain version
    and the JAX gradient (of the dense function for rows that see no
    key, see above)."""
    batch, lq, lk, heads, dh = shape
    q, k, v, ab, dout = make_inputs(1, *shape, mask=masks(lq, lk)[mask])
    want = torch_grads(ta.reference_train_attention, q, k, v, ab, dout)
    written = ta.reference_train_attention_backward(
        *(torch.tensor(x) for x in (q, k, v, ab, dout)))
    assert_all_close(want[:1] + [x.numpy() for x in written], want,
                     (0, 0), (2e-5, 1e-5))
    got = torch_grads(ta.fused_train_attention, q, k, v, ab, dout)
    assert_all_close(got, want, (1e-6, 1e-6), (2e-5, 1e-5))
    jax_fn = (jax_ta.reference_train_attention if mask == "fully_masked_rows"
              else jax_ta.fused_train_attention)
    assert_all_close(got, jax_grads(jax_fn, q, k, v, ab, dout),
                     (1e-5, 1e-5), (2e-4, 1e-4))


def test_bf16_matches_jax():
    inputs = make_inputs(2, 2, 40, 40, 2, 32, mask=masks(40, 40)["causal"])
    got = torch_grads(ta.fused_train_attention, *inputs,
                      dtype=torch.bfloat16)
    want = jax_grads(jax_ta.fused_train_attention, *inputs,
                     dtype=jnp.bfloat16)
    assert_all_close(got, want, (3e-2, 3e-2), (3e-2, 3e-2))
    # dtypes: bfloat16 in and out, dab float32
    leaves = [torch.tensor(x).bfloat16().requires_grad_()
              for x in inputs[:3]] + [torch.tensor(inputs[3])
                                      .requires_grad_()]
    out = ta.fused_train_attention(*leaves)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert out.dtype == torch.bfloat16
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32]


def test_dab_is_the_sum_of_per_batch_dabs():
    q, k, v, ab, dout = (torch.tensor(x) for x in make_inputs(
        3, 4, 10, 12, 2, 8))
    _, _, _, dab = ta.train_attention_backward(q, k, v, ab, dout)
    per_row = sum(ta.train_attention_backward(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], ab, dout[b:b + 1])[3]
        for b in range(4))
    torch.testing.assert_close(dab, per_row, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_bad_inputs():
    q, k, v, ab, dout = (torch.tensor(x) for x in make_inputs(
        4, 2, 6, 5, 2, 8))
    with pytest.raises(ValueError):
        ta.train_attention_forward(q, k, v, ab.double())
    with pytest.raises(ValueError):
        ta.train_attention_forward(q, k, v, ab[:, :5])
    with pytest.raises(ValueError):
        ta.train_attention_backward(q, k, v, ab, dout[:, :5])
    before = (ta.train_attention_forward.launches,
              ta.train_attention_backward.launches)
    ta.train_attention_backward(q, k, v, ab, dout)
    ta.train_attention_forward(q, k, v, ab)
    # CPU tensors take the plain versions: no launch is counted
    assert (ta.train_attention_forward.launches,
            ta.train_attention_backward.launches) == before


def training_mask(name, lq, lk):
    """The additive masks of the priors' three training attentions (the
    bottom prior has 4 channels per event), and an anti-causal mask with
    one row that sees no key."""
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        attention)
    if name == "causal":
        return attention.causal_mask(lq)
    if name == "aligned":
        e_q = torch.arange(lq) // 4
        return torch.where(e_q[:, None] == torch.arange(lk)[None, :], 0.0,
                           -1e9)
    mask = attention.anti_causal_mask(lq)
    if name == "fully_masked_row":
        mask[100] = -1e9
    return mask


@pytest.mark.parametrize("name,lq,lk,live", [
    ("causal", 516, 516, 45), ("aligned", 516, 129, 9),
    ("anti_causal", 129, 129, 6), ("fully_masked_row", 130, 130, 7)])
def test_live_tiles_skip_exactly(name, lq, lk, live):
    """``live_tiles`` at the training shapes with their real masks: the
    tiles it leaves out hold only masked scores, so the plain attention and
    its gradient are the same bits with those tiles removed (-inf). A
    query tile holding a row with no key stays whole."""
    heads = 2
    gen = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(2, n, heads, 8, generator=gen)
                     for n in (lq, lk, lk, lq))
    ab = torch.randn(heads, lq, lk, generator=gen) \
        + training_mask(name, lq, lk)[None]
    tiles = ta.live_tiles(ab)
    assert tiles.dtype == torch.uint8
    assert tiles.shape == (heads, -(-lq // ta.TILE), -(-lk // ta.TILE))
    assert int(tiles.sum()) == heads * live
    keep = tiles.bool().repeat_interleave(ta.TILE, 1).repeat_interleave(
        ta.TILE, 2)[:, :lq, :lk]
    skipped = torch.where(keep, ab, float("-inf"))
    out = ta.reference_train_attention(q, k, v, ab)
    assert torch.isfinite(out).all()
    assert torch.equal(ta.reference_train_attention(q, k, v, skipped), out)
    grads = ta.reference_train_attention_backward(q, k, v, ab, dout)
    again = ta.reference_train_attention_backward(q, k, v, skipped, dout)
    for got, want in zip(again, grads):
        assert torch.equal(got, want)
    assert (grads[3][~keep] == 0).all()


# -- the prior's layers in training mode --------------------------------------

@pytest.mark.parametrize("hier", ["top", "bottom"])
def test_prior_fused_matches_dense_and_jax(hier):
    """A tiny prior with ``fused_attention`` (the autograd function on the
    CPU) and without it gives the JAX model's logits and parameter
    gradients (the JAX package's dense model: its own tests hold its fused
    model to it)."""
    from tests.test_torch_prior import port_prior
    from tests.test_train_attention import _tiny
    from interactive_spectrogram_inpainting_tpu.models.prior import (
        VQNSynthTransformer)
    from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
        transformer as tt)
    from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
        to_flax_params)
    jm, cfg = _tiny(hier, fused=False)
    rng = np.random.default_rng(0)
    target = rng.integers(0, 16, (2, cfg.target_frequencies,
                                  cfg.target_duration))
    condition = rng.integers(0, 16, (2, cfg.source_frequencies,
                                     cfg.source_duration))
    variables = jax.jit(lambda key, t, c: jm.init(
        {"params": key}, t, c, method=VQNSynthTransformer.full_init))(
        jax.random.PRNGKey(0), jnp.asarray(target), jnp.asarray(condition))

    def jax_loss(p):
        src, tgt = jm.apply({"params": p}, jnp.asarray(target),
                            jnp.asarray(condition),
                            method=VQNSynthTransformer.to_sequences)
        logits, _ = jm.apply({"params": p}, tgt, src)
        return jnp.mean(logits ** 2), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables["params"])
    j_flat = dict(jax.tree_util.tree_leaves_with_path(j_grads))

    for fused in (True, False):
        tm = port_prior(jm, variables)
        tm = type(tm)(dataclasses.replace(tm.config, fused_attention=fused))
        tm.load_state_dict(port_prior(jm, variables).state_dict())
        src, tgt = tm.to_sequences(torch.as_tensor(target),
                                   torch.as_tensor(condition))
        logits, _ = tm(tgt, src)
        torch.mean(logits ** 2).backward()
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(j_logits), atol=1e-4,
                                   rtol=1e-4)
        grads = type(tm)(tm.config)
        grads.load_state_dict({k: p.grad for k, p in
                               tm.named_parameters()})
        g_tree = to_flax_params(grads)["params"]
        g_flat = dict(jax.tree_util.tree_leaves_with_path(g_tree))
        assert set(map(jax.tree_util.keystr, g_flat)) == set(
            map(jax.tree_util.keystr, j_flat))
        for path, leaf in j_flat.items():
            key = jax.tree_util.keystr(path)
            got = next(v for p, v in g_flat.items()
                       if jax.tree_util.keystr(p) == key)
            np.testing.assert_allclose(got, np.asarray(leaf), atol=2e-4,
                                       rtol=2e-3, err_msg=key)
        assert isinstance(tm, tt.VQNSynthTransformer)


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 7, 32, 33])
@pytest.mark.parametrize("lq,heads", [(1, 1), (20, 2), (129, 8), (516, 8),
                                      (600, 16)])
def test_dq_batch_groups_cover_the_batch(batch, lq, heads):
    """The dq/dab kernel's blocks take ceil(batch / groups) batch rows
    each: every group is non-empty and together they cover the batch."""
    groups = ta.dq_groups(batch, lq, heads)
    per = -(-batch // groups)
    assert 1 <= groups <= batch
    assert (groups - 1) * per < batch <= groups * per
