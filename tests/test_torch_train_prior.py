"""PyTorch port vs the JAX package: the pieces of one prior training step.

The same numpy inputs (and the JAX draws, for the masks) go through both
packages: mask samplers (exact), schedules (1e-7 at every step of a short
run), Adam / RAdam / clipping against optax's chain over 5 steps (1e-6),
the smoothed cross-entropy (value and gradient), the batch iterator
(exact), one ``train_step`` of a tiny top and bottom prior at dropout 0
(loss and metrics 1e-5, every parameter gradient atol 2e-4 / rtol 2e-3)
and the exact-count ``eval_step``."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_prior import make_prior
from interactive_spectrogram_inpainting_tpu.train import (
    losses as jax_losses, scheduler as jax_sched, train_prior as jax_train)
from interactive_spectrogram_inpainting_tpu_torch.models.prior import masks
from interactive_spectrogram_inpainting_tpu_torch.train import (
    losses, scheduler, train_prior)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    to_flax_params)

L, B = 40, 6


def t(x):
    return torch.as_tensor(np.array(x))


# -- masks -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bernoulli", "uniform-probability",
                                  "uniform-amount", "contiguous-zones"])
def test_mask_samplers_given_the_jax_draws_give_the_jax_masks(name):
    kw = dict(probability=0.3, min_ratio=0.2, probability_range=(0.1, 0.9))
    jax_sampler = jax_train.make_mask_sampler(name, L, 99, **kw)
    sampler = train_prior.make_mask_sampler(name, L, 99, **kw)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_sampler.sample_mask(key, batch_size=B))
        if name == "bernoulli":
            draws = {"uniform": jax.random.uniform(key, (B, L))}
        elif name == "uniform-probability":
            k_p, k_b = jax.random.split(key)
            draws = {"p": jax.random.uniform(k_p, (), minval=0.1, maxval=0.9),
                     "uniform": jax.random.uniform(k_b, (B, L))}
        elif name == "uniform-amount":
            k_k, k_s = jax.random.split(key)
            draws = {"k": jax.random.randint(
                         k_k, (), sampler.min_masked_amount, L + 1),
                     "scores": jax.random.uniform(k_s, (B, L))}
        else:
            k_l, k_o = jax.random.split(key)
            draws = {"length": jax.random.randint(
                         k_l, (B,), sampler.min_masked_amount, L + 1),
                     "offset": jax.random.randint(k_o, (B,), 0, L)}
        got = sampler.from_draws(**{k: t(v) for k, v in draws.items()})
        np.testing.assert_array_equal(got.numpy(), want)
        # the port's own draws: a boolean [B, L] mask of the same kind
        gen = torch.Generator().manual_seed(seed)
        own = sampler.sample_mask(gen, batch_size=B)
        assert own.shape == (B, L) and own.dtype == torch.bool
        if name == "uniform-amount":
            counts = own.sum(1)
            assert (counts == counts[0]).all()
            assert counts[0] >= sampler.min_masked_amount
        if name == "contiguous-zones":
            for row in own.numpy():
                idx = np.nonzero(row)[0]
                assert len(idx) >= sampler.min_masked_amount
                assert idx[-1] - idx[0] + 1 == len(idx)


def test_apply_mask_writes_the_mask_token():
    sampler = masks.BernoulliSequenceMask(0.5, L, 7)
    tokens = torch.zeros(2, L, dtype=torch.long)
    out = sampler.apply_mask(torch.Generator().manual_seed(0), tokens)
    assert set(out.unique().tolist()) == {0, 7}


# -- schedules and the optimizer ---------------------------------------------

@pytest.mark.parametrize("name,make", [
    ("cycle", lambda m: m.cycle_schedule(3e-3, 40)),
    ("cycle_momentum", lambda m: m.cycle_momentum_schedule(40)),
    ("warmup-cosine", lambda m: m.cosine_schedule_with_warmup(1e-3, 5, 40)),
    ("constant", lambda m: m.constant_schedule(3e-4)),
    ("get_scheduler cycle", lambda m: m.get_scheduler("cycle", 1e-3, 37)),
    ("get_scheduler warmup-cosine",
     lambda m: m.get_scheduler("warmup-cosine", 1e-3, 100)),
])
def test_schedules_equal_optax_at_every_step(name, make):
    ours, theirs = make(scheduler), make(jax_sched)
    for step in range(45):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   atol=1e-7, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("opt_name,sched,clip", [
    ("adam", None, None), ("radam", None, None), ("adam", None, 0.5),
    ("adam", "cycle", None), ("radam", "warmup-cosine", 1.0)])
def test_optimizer_equals_optax_chain(opt_name, sched, clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    params0 = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    total = 10
    tx = [optax.clip_by_global_norm(clip)] if clip else []
    chain = optax.chain(*tx, jax_sched.get_optimizer(
        opt_name, sched, 1e-2, total, warmup_steps=2, eps=1e-8))
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    state = chain.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params0.items()}
    opt = scheduler.get_optimizer(list(tparams.values()), opt_name, sched,
                                  1e-2, total, warmup_steps=2, eps=1e-8,
                                  clip_grad_norm=clip)
    for step, g in enumerate(grads):
        updates, state = chain.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{k} step {step}")
    if sched == "cycle":
        b1 = float(state[-1].hyperparams["b1"])
        np.testing.assert_allclose(opt.optimizer.param_groups[0]["betas"][0],
                                   float(jax_sched.cycle_momentum_schedule(
                                       total)(4)), atol=1e-7)
        assert b1 < 0.95
    assert opt.count == 5
    restored = scheduler.get_optimizer(list(tparams.values()), opt_name,
                                       sched, 1e-2, total)
    restored.load_state_dict(opt.state_dict())
    assert restored.count == 5


# -- loss ----------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss_value_and_gradient(monkeypatch, smoothing):
    # chunks of 5 rows: the chunked reductions are exercised
    monkeypatch.setattr(losses, "_CHUNK_ROWS", 5)
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 7, 16))).astype(np.float32)
    targets = rng.integers(0, 16, (3, 7))
    weights = rng.standard_normal((3, 7)).astype(np.float32)

    def jax_fn(x):
        per = jax_losses.label_smoothing_loss(x, jnp.asarray(targets),
                                              smoothing, reduction="none")
        return jnp.sum(per * weights), per

    (_, j_per), j_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    per = losses.label_smoothing_loss(x, t(targets), smoothing,
                                      reduction="none")
    (per * t(weights)).sum().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(j_per),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                               atol=1e-6, rtol=1e-5)
    mean = losses.label_smoothing_loss(x, t(targets), smoothing)
    np.testing.assert_allclose(float(mean.detach()), float(jax_losses.
                               label_smoothing_loss(jnp.asarray(logits),
                                                    jnp.asarray(targets),
                                                    smoothing)), rtol=1e-6)
    # bfloat16 logits: float32 loss, bfloat16 gradient
    xb = x.detach().bfloat16().requires_grad_()
    lb = losses.label_smoothing_loss(xb, t(targets), smoothing,
                                     reduction="none")
    lb.sum().backward()
    assert lb.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(lb.detach().numpy(), np.asarray(j_per),
                               atol=0.1, rtol=0.05)
    xd = x.detach()
    np.testing.assert_allclose(float(losses.mse_loss(xd, xd + 2)), 4.0)


# -- batches -------------------------------------------------------------------

class FakeCodes:
    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.tops = rng.integers(0, 16, size=(n, 4, 2)).astype(np.int32)
        self.bottoms = rng.integers(0, 16, size=(n, 8, 4)).astype(np.int32)
        self.pitch = rng.integers(0, 8, size=(n,)).astype(np.int32)

    def __len__(self):
        return len(self.tops)

    def read_batch(self, idx):
        idx = np.asarray(idx)
        return (self.tops[idx], self.bottoms[idx],
                {"pitch": self.pitch[idx]})


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, epoch=3, seed=5),
    dict(shuffle=False, epoch=0, include_remainder=True),
    dict(shuffle=True, epoch=1, limit=9, include_remainder=True)])
def test_iterate_batches_yield_the_jax_batches(kw):
    data = FakeCodes(11)
    ours = list(train_prior.iterate_batches(data, 4, device="cpu", **kw))
    theirs = list(jax_train.iterate_batches(data, 4, **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
        np.testing.assert_array_equal(a[2]["pitch"].numpy(),
                                      np.asarray(b[2]["pitch"]))
        np.testing.assert_array_equal(a[3].numpy(), np.asarray(b[3]))


# -- one training step -----------------------------------------------------------

class FixedMask:
    """A mask sampler stand-in that returns one given mask."""

    def __init__(self, mask):
        self.mask = mask

    def sample_mask(self, rng, batch_size=1):
        return self.mask


def grad_optimizer():
    """An optax transformation whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def grad_tree(model):
    """The port's parameter gradients in the JAX package's layout."""
    holder = copy.deepcopy(model)
    holder.load_state_dict({k: p.grad for k, p in model.named_parameters()})
    return to_flax_params(holder)["params"]


def step_inputs(cfg, batch=3, seed=2):
    rng = np.random.default_rng(seed)
    tops = rng.integers(0, cfg.n_class, (batch,) + tuple(cfg.condition_shape))
    bottoms = rng.integers(0, cfg.n_class, (batch,) + tuple(cfg.shape))
    mask = rng.random((batch, cfg.source_sequence_length)) < 0.5
    return tops, bottoms, mask


@pytest.fixture(scope="module", params=["aligned", "top"])
def prior(request):
    return make_prior(request.param)


@pytest.mark.parametrize("debug", [{}, {"drop_loss_half": True}])
def test_train_step_loss_metrics_and_gradients_equal_jax(prior, debug):
    jm, variables, tm = prior
    cfg = tm.config
    hier = "top" if cfg.self_conditional_model else "bottom"
    tops, bottoms, mask = step_inputs(cfg)
    opt = grad_optimizer()
    j_step, _ = jax_train.make_steps(jm, opt, hier,
                                     FixedMask(jnp.asarray(mask)), 0.1,
                                     **debug)
    params = variables["params"]
    _, j_grads, j_metrics = j_step(params, opt.init(params),
                                   jax.random.PRNGKey(0), jnp.asarray(tops),
                                   jnp.asarray(bottoms), {})
    model = copy.deepcopy(tm)
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        1e-3, 10)
    step, _ = train_prior.make_steps(model, optimizer, hier,
                                     FixedMask(t(mask)), 0.1, **debug)
    metrics = step(t(tops), t(bottoms), {}, torch.Generator())
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(j_metrics[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    ours = dict(jax.tree_util.tree_leaves_with_path(grad_tree(model)))
    theirs = jax.tree_util.tree_leaves_with_path(j_grads)
    keyed = {jax.tree_util.keystr(p): v for p, v in ours.items()}
    assert len(keyed) == len(theirs)
    for path, leaf in theirs:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(keyed[key], np.asarray(leaf), atol=2e-4,
                                   rtol=2e-3, err_msg=key)
    # the update moved the parameters
    assert not torch.equal(model.project_logits.weight,
                           tm.project_logits.weight)


def test_eval_step_is_the_exact_count_of_jax(prior):
    jm, variables, tm = prior
    cfg = tm.config
    hier = "top" if cfg.self_conditional_model else "bottom"
    tops, bottoms, mask = step_inputs(cfg, batch=4, seed=3)
    weights = np.array([1, 1, 1, 0], np.float32)
    _, j_eval = jax_train.make_steps(jm, optax.adam(1e-3), hier,
                                     FixedMask(jnp.asarray(mask)), 0.0)
    j_sums, j_count = j_eval(variables["params"], jax.random.PRNGKey(0),
                             jnp.asarray(tops), jnp.asarray(bottoms), {},
                             jnp.asarray(weights))
    _, eval_step = train_prior.make_steps(tm, None, hier, FixedMask(t(mask)),
                                          0.0)
    sums, count = eval_step(t(tops), t(bottoms), {}, t(weights),
                            torch.Generator())
    assert float(count) == float(j_count) == 3.0
    for k, v in sums.items():
        np.testing.assert_allclose(float(v), float(j_sums[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # the padding row changes nothing
    tops2, bottoms2 = tops.copy(), bottoms.copy()
    tops2[3], bottoms2[3] = 0, 0
    sums2, _ = eval_step(t(tops2), t(bottoms2), {}, t(weights),
                         torch.Generator())
    for k in sums:
        np.testing.assert_allclose(float(sums2[k]), float(sums[k]),
                                   atol=1e-6)


def run_one_step(model, hier, seed=0, bf16=False):
    cfg = model.config
    tops, bottoms, _ = step_inputs(cfg, batch=2, seed=4)
    sampler = train_prior.make_mask_sampler(
        "uniform-probability", cfg.source_sequence_length,
        cfg.mask_token_index, 0.5, 0.0)
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        1e-3, 10)
    step, _ = train_prior.make_steps(model, optimizer, hier, sampler, 0.1,
                                     bf16=bf16)
    metrics = step(t(tops), t(bottoms), {},
                   torch.Generator().manual_seed(seed))
    return metrics, {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("variant", ["aligned", "top"])
def test_remat_matches_no_remat_exactly_with_dropout(variant):
    _, _, tm = make_prior(variant)
    hier = "top" if tm.config.self_conditional_model else "bottom"
    out = {}
    for remat in (False, True):
        model = type(tm)(dataclasses.replace(tm.config, remat=remat,
                                             dropout=0.3))
        model.load_state_dict(tm.state_dict())
        out[remat] = run_one_step(model, hier)
    (m0, g0), (m1, g1) = out[False], out[True]
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # dropout is on: another seed gives another loss
    model = type(tm)(dataclasses.replace(tm.config, dropout=0.3))
    model.load_state_dict(tm.state_dict())
    m2, _ = run_one_step(model, hier, seed=1)
    assert not torch.equal(m0["loss"], m2["loss"])


def test_bf16_step_keeps_float32_masters():
    _, _, tm = make_prior("aligned")
    model = copy.deepcopy(tm)
    metrics, grads = run_one_step(model, "bottom", bf16=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    _, f32_grads = run_one_step(copy.deepcopy(tm), "bottom")
    assert np.isfinite(float(metrics["loss"]))
    # the same function in another precision: close, not equal
    g, f = grads["project_logits.weight"], f32_grads["project_logits.weight"]
    assert float((g - f).abs().max()) < 0.1 * float(f.abs().max()) + 1e-3
