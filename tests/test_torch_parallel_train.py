"""PyTorch port vs the JAX package: the parallel layer and both trainers'
steps over two gloo ranks on the CPU.

Two spawned processes (``tests/torch_parallel_workers.py``) run the port on
a 2 x 1 (data) and a 1 x 2 (model) mesh; the JAX package runs the same
steps on its virtual 8-device CPU mesh (``tests/conftest.py``). Weights
come from the JAX init through ``from_flax_params``, inputs from numpy
seeds. Tolerances are the JAX package's own for its sharded steps
(``tests/test_train_spmd.py``): loss rtol 1e-5, prior parameters atol
5e-4, VQ-VAE codebooks atol 1e-5 and parameters 1e-4; the gradients
(after the data all-reduce, gathered over the model group) are held to the
port's one-process tolerance against the JAX gradients, atol 2e-4 / rtol
2e-3 (``tests/test_torch_train_prior.py``). Eval is exact-count: weighted
sums and the weight count at rtol 1e-5. Dropout, inpainting masks,
dead-code restarts and code corruption cannot replay JAX's threefry bits:
there the port at two ranks is held to the port at one, to the same
bounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parallel_workers as workers
from tests.test_torch_prior import make_prior
from tests.test_torch_train_main import args as prior_args
from tests.test_torch_train_main import store  # noqa: F401  (fixture)
from tests.test_torch_train_prior import FixedMask, grad_optimizer
from tests.test_torch_train_vqvae import (helpers, model_pair, notes,
                                          to_numpy)
from interactive_spectrogram_inpainting_tpu.parallel import mesh as jmesh
from interactive_spectrogram_inpainting_tpu.train import (
    losses as jl, train_prior as jax_train, train_vqvae as jt)
from interactive_spectrogram_inpainting_tpu_torch.parallel import (
    mesh as pmesh)
from interactive_spectrogram_inpainting_tpu_torch.train import train_prior
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params, to_flax_params)

BATCH = 8
LR = 1e-3
VQ_SPEC = dict(use_mel_scale=True, n_fft=512, hop_length=128,
               window_length=512)
PRIOR_WEIGHTS = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
VQ_WEIGHTS = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
RESUME_ATOL = 2e-4  # 2.6x the largest difference of a sound resume (7.6e-5)


def prior_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tops = rng.integers(0, cfg.n_class,
                        (BATCH,) + tuple(cfg.condition_shape))
    bottoms = rng.integers(0, cfg.n_class, (BATCH,) + tuple(cfg.shape))
    mask = rng.random((BATCH, cfg.source_sequence_length)) < 0.5
    return tops, bottoms, mask


@pytest.fixture(scope="module")
def priors():
    return {"top": make_prior("top"), "bottom": make_prior("aligned")}


@pytest.fixture(scope="module")
def vqvae():
    return model_pair()


def prior_case(pair, hier, mesh, input_seed, **extra):
    jm, variables, _ = pair
    tops, bottoms, mask = prior_inputs(jm.config, input_seed)
    case = dict(config=jm.config.to_json(), hier=hier, mesh=mesh,
                state=from_flax_params(to_numpy(variables)), tops=tops,
                bottoms=bottoms, mask=mask if hier == "top" else None,
                lr=LR, weights=PRIOR_WEIGHTS)
    case.update(extra)
    return case


def dropout_config(pair):
    cfg = dataclasses.replace(pair[0].config, dropout=0.1)
    return cfg.to_json()


def vq_case(pair, seed, **config):
    jm, variables, tmodel = pair
    cfg = dataclasses.replace(tmodel.config, **config)
    return dict(config=cfg.to_json(), spec=VQ_SPEC,
                state={k: v.clone() for k, v in tmodel.state_dict().items()},
                audio=notes(seed, batch=BATCH), weights=VQ_WEIGHTS, lr=LR,
                seed=3)


@pytest.fixture(scope="module")
def two_ranks(priors, vqvae, store, tmp_path_factory):  # noqa: F811
    """Every two-rank run of this file, in one spawn, left running: a
    test takes ``pending.result()`` after its JAX work."""
    runs = tmp_path_factory.mktemp("runs")
    prior = {}
    for hier in ("top", "bottom"):
        pair = priors[hier]
        prior[f"{hier}-data"] = prior_case(pair, hier, (2, 1), 11)
        prior[f"{hier}-model"] = prior_case(pair, hier, (1, 2), 11)
        for mesh, tag in (((2, 1), "data"), ((1, 2), "model")):
            prior[f"{hier}-dropout-{tag}"] = prior_case(
                pair, hier, mesh, 12, config=dropout_config(pair),
                mask=None, seed=5, remat=tag == "model",
                clip=0.05 if tag == "model" else None,
                sampler=("contiguous-zones" if tag == "model"
                         else "uniform-probability"))
    vq = {"plain": vq_case(vqvae, 21),
          "restarts-corruption": vq_case(
              vqvae, 22, restarts_usage_threshold=0.9,
              corruption_weights={"top": [0.1, 0.8, 0.1],
                                  "bottom": [0.2, 0.6, 0.2]}),
          "restarts-kernel": vq_case(vqvae, 23,
                                     restarts_usage_threshold=0.9,
                                     use_pallas_lookup=True)}
    mains = {
        "evaluate": ("prior", prior_args(store, runs, "bottom",
                                         "--evaluate_only", "--batch_size",
                                         "4", "--num_devices_data", "2")),
        "model2": ("prior", prior_args(store, runs / "model2", "top",
                                       "--num_training_epochs", "1",
                                       "--batch_size", "4",
                                       "--num_devices_model", "2")),
        # its checkpoint resumed at model 2: the optimizer state sharded
        "model2-resume": ("prior", prior_args(
            store, runs / "model2-resume", "top", "--num_training_epochs",
            "2", "--batch_size", "4", "--num_devices_model", "2",
            "--resume_training_from", workers.RunDir(runs / "model2"))),
        "bad-size": ("prior", prior_args(store, runs, "top", "--dry_run",
                                         "--num_devices_data", "3")),
        "indivisible": ("prior", prior_args(store, runs, "top", "--dry_run",
                                            "--batch_size", "3")),
    }
    pending = workers.start(tmp_path_factory.mktemp("spawn"),
                            workers.run_jobs,
                            {"prior_steps": prior, "vqvae_steps": vq,
                             "run_mains": mains})
    return prior, vq, mains, runs, pending


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("hier", ["top", "bottom"])
@pytest.mark.parametrize("n_model", [2, 3])
def test_prior_param_spec_slices_what_jax_shards(priors, hier, n_model):
    """Each model rank's shard of every parameter equals the JAX
    package's shard of it, converted: the split dimension, the whole-head
    blocks and the replicate-when-indivisible rule (4 heads and d_ff 64 on
    3 model ranks: every rule falls back to replication)."""
    jm, variables, tm = priors[hier]
    params = to_numpy(variables)["params"]
    mesh = jmesh.make_mesh(n_data=2, n_model=n_model)
    shardings = jmesh.prior_param_shardings(mesh, params)
    full = tm.state_dict()
    dims = pmesh.prior_param_dims(dict(tm.named_parameters()), n_model,
                                  tm.config.conditional_model_nhead)
    assert any(d is not None for d in dims.values()) == (n_model == 2)
    for index in range(n_model):
        def jax_shard(leaf, sharding):
            spec = sharding.spec
            if "model" not in spec:
                return leaf
            axis = list(spec).index("model")
            size = leaf.shape[axis] // n_model
            return np.take(leaf, np.arange(index * size, (index + 1) * size),
                           axis=axis)
        want = from_flax_params(jax.tree_util.tree_map(jax_shard, params,
                                                       shardings))
        for name, tensor in full.items():
            mine = pmesh.shard_tensor(tensor, dims[name], n_model, index)
            assert torch.equal(mine, want[name]), (name, index)


def test_mesh_rank_order_and_eval_padding(monkeypatch):
    """Rank r sits where the JAX package's grid puts device r; a rank's
    rows are the contiguous block ``P('data')`` gives it; the eval padding
    is the JAX package's."""
    grid = jmesh.make_mesh(n_data=4, n_model=2).devices
    for rank in range(8):
        monkeypatch.setattr(pmesh, "world", lambda rank=rank: (rank, 8))
        m = pmesh.make_mesh(n_model=2)
        assert (m.n_data, m.n_model) == (4, 2)
        assert grid[m.data_index, m.model_index].id == rank
        assert m.rows(8) == slice(2 * m.data_index, 2 * m.data_index + 2)
    monkeypatch.setattr(pmesh, "world", lambda: (0, 8))
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.make_mesh(n_data=3, n_model=2)
    for batch in range(1, 12):
        for shards in (1, 2, 3, 4, 8):
            assert pmesh.pad_for_eval(batch, shards) == jmesh.pad_for_eval(
                batch, shards)
    batch = {"a": np.arange(8), "b": [torch.arange(16).reshape(8, 2)]}
    monkeypatch.setattr(pmesh, "world", lambda: (3, 4))
    rows = pmesh.shard_batch(pmesh.make_mesh(), batch)
    np.testing.assert_array_equal(rows["a"], [6, 7])
    assert rows["b"][0].tolist() == [[12, 13], [14, 15]]


# -- prior steps against the JAX package -----------------------------------------

_JAX_STEPS = {}


def jax_prior_step(pair, hier, case, grid):
    """The JAX package's sharded train step (gradients, and the parameters
    after its Adam update of them) and exact-count eval step of ``case``
    on a ``grid`` mesh; cached."""
    key = (hier, grid)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    jm, variables, _ = pair
    mesh = jmesh.make_mesh(n_data=grid[0], n_model=grid[1])
    step, eval_step = jax_train.make_steps(
        jm, grad_optimizer(), hier,
        FixedMask(jnp.asarray(case["mask"])) if hier == "top" else None, 0.1)
    params = variables["params"]
    if grid[1] > 1:
        params = jax.device_put(params,
                                jmesh.prior_param_shardings(mesh, params))
    shard = jmesh.data_sharding(mesh)
    tops = jax.device_put(jnp.asarray(case["tops"]), shard)
    bottoms = jax.device_put(jnp.asarray(case["bottoms"]), shard)
    _, grads, metrics = step(params, grad_optimizer().init(params),
                             jax.random.PRNGKey(0), tops, bottoms, {})
    new = _adam_step(grads, params)
    evaluated = None
    if grid[1] == 1:  # the eval test's mesh
        evaluated = eval_step(params, jax.random.PRNGKey(1), tops, bottoms,
                              {}, jax.device_put(jnp.asarray(PRIOR_WEIGHTS),
                                                 shard))
    _JAX_STEPS[key] = new, grads, metrics, evaluated
    return _JAX_STEPS[key]


@jax.jit
def _adam_step(grads, params):
    """The parameters after optax's first Adam step (compiled: eagerly it
    dispatches every op of every leaf, several seconds here)."""
    adam = optax.adam(LR)
    updates, _ = adam.update(grads, adam.init(params), params)
    return optax.apply_updates(params, updates)


def port_tree(tm, state):
    holder = type(tm)(tm.config)
    holder.load_state_dict(state)
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(to_flax_params(holder))}


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path({"params": tree})}


@pytest.mark.parametrize("hier", ["top", "bottom"])
@pytest.mark.parametrize("tag,grid", [("data", (2, 1)), ("model", (4, 2))])
def test_prior_step_at_two_ranks_matches_jax_sharded_step(priors, two_ranks,
                                                          hier, tag, grid):
    """One train step at data 2 against the JAX step on a 2-device data
    mesh, and at model 2 (2 of 4 heads and half of d_ff a rank) against
    the JAX step on its 4 x 2 mesh: metrics, gradients, and the
    parameters after an Adam step (optax's, on the JAX gradients)."""
    prior, _, _, _, pending = two_ranks
    name = f"{hier}-{tag}"
    case, pair = prior[name], priors[hier]
    new, grads, metrics, _ = jax_prior_step(pair, hier, case, grid)
    result = pending.result()
    ours = result[0]["prior_steps"][name]
    assert set(ours["metrics"]) == set(metrics)
    for k, v in ours["metrics"].items():
        np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    tm = pair[2]
    mine_g, mine_p = port_tree(tm, ours["grads"]), port_tree(tm,
                                                             ours["params"])
    theirs_g, theirs_p = jax_leaves(grads), jax_leaves(new)
    assert set(mine_p) == set(theirs_p)
    for key, want in theirs_g.items():
        np.testing.assert_allclose(mine_g[key], want, atol=2e-4, rtol=2e-3,
                                   err_msg=key)
    for key, want in theirs_p.items():
        np.testing.assert_allclose(mine_p[key], want, atol=5e-4, err_msg=key)
    # both ranks hold the same whole parameters
    for k, v in result[1]["prior_steps"][name]["params"].items():
        assert torch.equal(v, ours["params"][k]), k


@pytest.mark.parametrize("hier", ["top", "bottom"])
def test_prior_eval_at_two_ranks_is_the_jax_exact_count(priors, two_ranks,
                                                        hier):
    """Eval at data 2 with two weight-0 padding rows (both on rank 1):
    the JAX exact-count eval's weighted sums and count."""
    prior, _, _, _, pending = two_ranks
    case = prior[f"{hier}-data"]
    _, _, _, (j_sums, j_count) = jax_prior_step(priors[hier], hier, case,
                                                (2, 1))
    result = pending.result()
    (sums, count) = result[0]["prior_steps"][f"{hier}-data"]["eval"]
    assert count == float(j_count) == 6.0
    assert set(sums) == set(j_sums)
    for k, v in sums.items():
        np.testing.assert_allclose(v, float(j_sums[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert result[1]["prior_steps"][f"{hier}-data"]["eval"] == (sums, count)


@pytest.mark.parametrize("hier", ["top", "bottom"])
@pytest.mark.parametrize("tag", ["data", "model"])
def test_prior_dropout_and_masks_do_not_depend_on_the_ranks(two_ranks, hier,
                                                            tag):
    """Dropout 0.1 and the top prior's drawn inpainting masks: the step at
    two ranks equals the port's one-process step of the global batch (at
    model 2 also with remat and gradient clipping over the shards)."""
    prior, _, _, _, pending = two_ranks
    name = f"{hier}-dropout-{tag}"
    one = workers.prior_step(prior[name])
    ours = pending.result()[0]["prior_steps"][name]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ours["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k, v in one["grads"].items():
        np.testing.assert_allclose(ours["grads"][k].numpy(), v.numpy(),
                                   atol=2e-4, rtol=2e-3, err_msg=k)
    for k, v in one["params"].items():
        np.testing.assert_allclose(ours["params"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


# -- VQ-VAE steps ---------------------------------------------------------------

def test_vqvae_step_at_data_two_matches_jax_sharded_step(vqvae, two_ranks):
    """One mse train step at data 2 against the JAX step on a 2-device
    data mesh: the EMA codebooks are the global batch's (atol 1e-5), the
    gradients the port's one-process tolerance, the parameters atol 1e-4;
    and the exact-count eval (one real row on rank 1)."""
    _, vq, _, _, pending = two_ranks
    case = vq["plain"]
    jm, variables, tm = vqvae
    jh, _ = helpers()
    shard = jmesh.data_sharding(jmesh.make_mesh(n_data=2))
    audio = jax.device_put(jnp.asarray(case["audio"]), shard)

    def run(optimizer):
        step = jt.make_train_step(jm, optimizer, jl.mse_loss, 0.25, jh,
                                  needs_rng=False)
        return step(variables["params"], variables["codebook"],
                    optimizer.init(variables["params"]), audio,
                    jax.random.PRNGKey(1))

    params, codebook, _, metrics = run(optax.adam(LR))
    _, _, grads, _ = run(grad_optimizer())
    ours = pending.result()[0]["vqvae_steps"]["plain"]
    for k in ("vqvae_loss", "reconstruction_loss", "latent_loss",
              "perplexity_top", "perplexity_bottom"):
        np.testing.assert_allclose(ours["metrics"][k], float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    holder = type(tm)(tm.config)
    holder.load_state_dict(ours["state"])
    mine = to_numpy(to_flax_params(holder))
    for level, entries in codebook.items():
        for k, v in entries.items():
            np.testing.assert_allclose(mine["codebook"][level][k],
                                       np.asarray(v), atol=1e-5,
                                       err_msg=f"{level}/{k}")
    mine_p = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(mine["params"])}
    for p, v in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_allclose(mine_p[jax.tree_util.keystr(p)],
                                   np.asarray(v), atol=1e-4,
                                   err_msg=jax.tree_util.keystr(p))
    holder.load_state_dict({**ours["state"], **ours["grads"]})
    mine_g = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(
                  to_numpy(to_flax_params(holder))["params"])}
    for p, v in jax.tree_util.tree_leaves_with_path(grads):
        np.testing.assert_allclose(mine_g[jax.tree_util.keystr(p)],
                                   np.asarray(v), atol=2e-4, rtol=2e-3,
                                   err_msg=jax.tree_util.keystr(p))

    j_eval = jt.make_eval_step(jm, jl.mse_loss, 0.25, jh)
    j_sums, j_count = j_eval(variables["params"], variables["codebook"],
                             audio, jax.device_put(jnp.asarray(VQ_WEIGHTS),
                                                   shard))
    sums, count = ours["eval"]
    assert count == float(j_count) == 5.0
    for k, v in j_sums.items():
        np.testing.assert_allclose(sums[k], float(v), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["restarts-corruption", "restarts-kernel"])
def test_vqvae_restarts_and_corruption_do_not_depend_on_the_ranks(
        two_ranks, name):
    """Dead-code restarts (rows of the global batch, gathered from the rank
    that holds them) and +/-1 code corruption (drawn for the global rows),
    through the dense lookup and through the lookup kernel's plain version:
    the step at two ranks equals the one-process step of the global
    batch."""
    _, vq, _, _, pending = two_ranks
    one = workers.vqvae_step(vq[name])
    result = pending.result()
    ours = result[0]["vqvae_steps"][name]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ours["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    for k, v in one["state"].items():
        atol = 1e-5 if k.startswith("quantize") else 1e-4
        np.testing.assert_allclose(ours["state"][k].numpy(), v.numpy(),
                                   atol=atol, err_msg=k)
    for k, v in result[1]["vqvae_steps"][name]["state"].items():
        assert torch.equal(v, ours["state"][k]), k


# -- the trainers' main ------------------------------------------------------------

def test_trainer_mains_at_two_ranks(store, two_ranks, tmp_path):  # noqa: F811
    """``train_prior.main`` over two gloo ranks: ``--evaluate_only`` at
    data 2 with a remainder equals one process's evaluation; an epoch at
    model 2 writes the one-device checkpoint format (whole tensors, rank 0
    only), which one process resumes, and which a resume at model 2
    (its Adam moments sharded) continues as the one process does; a data
    size that does not divide the batch, or a mesh that does not match the
    world, raises naming the flag."""
    _, _, mains, runs, pending = two_ranks
    want = train_prior.main(prior_args(store, tmp_path, "bottom",
                                       "--evaluate_only", "--batch_size",
                                       "4"))
    got = pending.result()[0]["run_mains"]
    assert set(got["evaluate"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["evaluate"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert "--num_devices_data 3" in got["bad-size"]
    assert "--num_devices_data 2 must divide --batch_size 3" in \
        got["indivisible"]
    (run_dir,) = (runs / "model2").iterdir()
    state = torch.load(run_dir / "checkpoints" / "0" / "state.pt",
                       weights_only=True)
    whole = got["model2"]
    for k, v in whole.items():
        assert torch.equal(state["model"][k], v), k
    assert state["model"]["decoder_layers.0.mlp.fc1.weight"].shape[0] == 64
    resumed = train_prior.main(prior_args(
        store, tmp_path / "resume", "top", "--num_training_epochs", "2",
        "--batch_size", "4", "--resume_training_from", str(run_dir)))
    for k, v in resumed.state_dict().items():
        np.testing.assert_allclose(got["model2-resume"][k].numpy(),
                                   v.numpy(), atol=RESUME_ATOL, err_msg=k)
