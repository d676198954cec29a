"""PyTorch port vs the JAX package: sharded sampling, extraction and the
VQ-VAE trainer's ``main`` over two gloo ranks on the CPU.

``make_sharded_sampling_fn`` at two data ranks, each shard fed the Gumbel
noise the JAX package's ``make_sharded_sampling_fn`` draws for it on a
2-device data mesh (one key a shard, split by absolute position): the
tokens are equal in float32, at one row a shard (the scan and the prefix
prime) and at eight (the batched step), and unmasked cells pass through.
``extract_split`` at two ranks writes the one-process store byte for byte
(a last batch of padding only on rank 1 included). ``train_vqvae.main`` at
data 2 (rows read by each rank, the normalizer's ranges reduced over the
ranks) takes the one-process step: parameters atol 1e-4, codebooks
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_workers as workers
from tests.test_torch_extract import (SPEC_KWARGS, nsynth_dir,  # noqa: F401
                                      vqvae_pair)
from tests.test_torch_prior import make_prior
from tests.test_torch_sampling import bounds, inpaint_case, jax_step_gumbel
from tests.test_torch_train_vqvae import to_numpy
from tests.test_torch_train_vqvae_main import main_args
from tests.test_torch_train_vqvae_main import \
    nsynth_dir as vqvae_notes  # noqa: F401
from interactive_spectrogram_inpainting_tpu import sampling as jsampling
from interactive_spectrogram_inpainting_tpu.parallel import mesh as jmesh
from interactive_spectrogram_inpainting_tpu_torch.extract import (
    extract_codes as textract)
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    scan_range)
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.train import (
    train_vqvae as tt)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    from_flax_params)

SAMPLING = {"one-a-shard": 2, "eight-a-shard": 16}
DATASET = dict(valid_pitch_range=(24, 84),
               categorical_field_list=["pitch", "instrument_family_str"],
               duration_seconds=0.512)


@pytest.fixture(scope="module")
def prior():
    return make_prior("aligned")


def sampling_case(prior, batch):
    jm, variables, tm = prior
    cfg = jm.config
    initial, mask, condition = inpaint_case(cfg, batch, (1, 3), seed=29)
    keys = jax.random.split(jax.random.PRNGKey(31), 2)
    p0, steps = scan_range(tm, *bounds(tm, mask))
    per = batch // 2
    gumbels = [jax_step_gumbel(k, p0, steps, (per, cfg.n_class))
               for k in keys]
    if per == 1:
        gumbels = [g[:, 0] for g in gumbels]
    return dict(config=cfg.to_json(), batch=batch, temperature=0.9,
                state=from_flax_params(to_numpy(variables)),
                condition=condition, initial=initial, mask=mask,
                gumbels=gumbels, keys=keys)


@pytest.fixture(scope="module")
def two_ranks(prior, nsynth_dir, vqvae_pair, vqvae_notes,  # noqa: F811
              tmp_path_factory):
    """Every two-rank run of this file, in one spawn, left running: a
    test takes ``pending.result()`` after its own work."""
    sampling = {name: sampling_case(prior, batch)
                for name, batch in SAMPLING.items()}
    _, _, tmodel = vqvae_pair
    store = tmp_path_factory.mktemp("two_rank_store")
    extract = dict(config=tmodel.config.to_json(),
                   state=tmodel.state_dict(), root=nsynth_dir,
                   dataset=DATASET, spec=SPEC_KWARGS, store=store,
                   batch_size=6)
    runs = tmp_path_factory.mktemp("runs")
    mains = {"vqvae": ("vqvae", main_args(
        vqvae_notes, runs, "--dry_run", "--input_normalization",
        "--pallas_vq", "--restarts_usage_threshold", "0.9",
        "--num_devices_data", "2"))}
    pending = workers.start(
        tmp_path_factory.mktemp("spawn"), workers.run_jobs,
        {"sharded_samples": {k: {n: v for n, v in c.items() if n != "keys"}
                             for k, c in sampling.items()},
         "extract": extract, "run_mains": mains})
    return sampling, store, pending


@pytest.mark.parametrize("name", list(SAMPLING))
def test_sharded_sampling_matches_jax_sharded_sampling(prior, two_ranks,
                                                       name):
    jm, variables, _ = prior
    sampling, _, pending = two_ranks
    case = sampling[name]
    fn = jsampling.make_sharded_sampling_fn(
        jm, case["batch"], jmesh.make_mesh(n_data=2, n_model=1),
        temperature=case["temperature"])
    want = np.asarray(fn(variables, case["keys"],
                         jnp.asarray(case["condition"]),
                         jnp.asarray(case["initial"]),
                         jnp.asarray(case["mask"]), {}))
    result = pending.result()
    for rank in range(2):
        got = result[rank]["sharded_samples"][name].numpy()
        assert got.shape == (case["batch"],) + tuple(jm.config.shape)
        np.testing.assert_array_equal(got, want)
    mask = case["mask"]
    np.testing.assert_array_equal(got[:, ~mask], case["initial"][:, ~mask])
    assert not np.array_equal(got[:, mask], case["initial"][:, mask])


def test_extract_split_at_two_ranks_writes_the_one_process_store(
        nsynth_dir, vqvae_pair, two_ranks, tmp_path):  # noqa: F811
    from interactive_spectrogram_inpainting_tpu_torch.data.nsynth import (
        NSynth)
    _, store, pending = two_ranks
    _, _, tmodel = vqvae_pair
    dataset = NSynth(nsynth_dir, nsynth_dir / "examples.json", **DATASET)
    count = textract.extract_split(
        tmodel, tspec.get_spectrograms_helper(**SPEC_KWARGS), dataset,
        tmp_path / "one", batch_size=6, device="cpu")
    result = pending.result()
    assert result[0]["extract"] == result[1]["extract"] == count == 8
    mine = sorted(p.relative_to(store) for p in store.rglob("*")
                  if p.is_file())
    theirs = sorted(p.relative_to(tmp_path / "one")
                    for p in (tmp_path / "one").rglob("*") if p.is_file())
    assert mine == theirs and mine
    for rel in mine:
        assert (store / rel).read_bytes() == (tmp_path / "one" /
                                              rel).read_bytes(), rel


def test_vqvae_main_at_data_two_takes_the_one_process_step(
        vqvae_notes, two_ranks, tmp_path):  # noqa: F811
    _, _, pending = two_ranks
    want = tt.main(main_args(vqvae_notes, tmp_path, "--dry_run",
                             "--input_normalization", "--pallas_vq",
                             "--restarts_usage_threshold", "0.9"))
    result = pending.result()
    got = result[0]["run_mains"]["vqvae"]
    assert want.config.normalizer_statistics is not None
    for k, v in want.state_dict().items():
        atol = 1e-5 if k.startswith("quantize") else 1e-4
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)
    for k, v in result[1]["run_mains"]["vqvae"].items():
        assert torch.equal(v, got[k]), k
