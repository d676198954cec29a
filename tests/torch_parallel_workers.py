"""Two-process jobs of the port's parallel tests, over gloo on the CPU.

``start(directory, job, payload)`` starts two processes, joins them into
one process group through the port's ``initialize_multihost`` (a file
rendezvous under ``directory``) and runs ``job(rank, payload)`` on each;
``Pending.result()`` hands back both ranks' results. This module imports
torch and the port only, so that a spawned process starts in a few
seconds; the tests that hold the results against the JAX package import
it."""

import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from interactive_spectrogram_inpainting_tpu_torch.models.prior.transformer \
    import TransformerConfig, VQNSynthTransformer
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae import (
    vqvae as tv)
from interactive_spectrogram_inpainting_tpu_torch.parallel import (
    collectives, mesh as pmesh)
from interactive_spectrogram_inpainting_tpu_torch.parallel.distributed \
    import initialize_multihost
from interactive_spectrogram_inpainting_tpu_torch.signal import (
    spectrogram as tspec)
from interactive_spectrogram_inpainting_tpu_torch.train import (
    losses, scheduler, train_prior, train_vqvae)

WORLD = 2
TIMEOUT_S = 240.0


class Pending:
    """Two ranks running a job; ``result()`` waits for them (once)."""

    def __init__(self, directory, context, job, timeout_s):
        self.directory, self.context, self.job = directory, context, job
        self.deadline = time.monotonic() + timeout_s
        self.results = None

    def result(self):
        if self.results is None:
            while not self.context.join(timeout=5):
                if time.monotonic() > self.deadline:
                    for process in self.context.processes:
                        process.kill()
                    raise TimeoutError(f"{self.job.__name__} ran over time")
            self.results = [
                torch.load(self.directory / f"result{rank}.pt",
                           weights_only=False) for rank in range(WORLD)]
        return self.results


def start(directory, job, payload, timeout_s: float = TIMEOUT_S) -> Pending:
    """``job(rank, payload)`` on two gloo ranks, left running: ``result()``
    -> [result of rank 0, of rank 1]. A rank that raises fails
    ``result()`` with its traceback; ranks still running after
    ``timeout_s`` are killed."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(payload, directory / "payload.pt")
    context = mp.start_processes(_entry, args=(job, str(directory)),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
    return Pending(directory, context, job, timeout_s)


def _entry(rank, job, directory):
    torch.set_num_threads(1)
    initialize_multihost(init_method=f"file://{directory}/rendezvous",
                         world_size=WORLD, rank=rank, device="cpu")
    try:
        payload = torch.load(pathlib.Path(directory) / "payload.pt",
                             weights_only=False)
        result = job(rank, payload)
        torch.save(result, pathlib.Path(directory) / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


class FixedMask:
    """A mask sampler that returns one given [B, L] mask."""

    def __init__(self, mask):
        self.mask = torch.as_tensor(np.asarray(mask))

    def sample_mask(self, generator, batch_size=1):
        assert batch_size == self.mask.shape[0]
        return self.mask


# -- priors ------------------------------------------------------------------

def prior_model(config_json, state, remat=False):
    cfg = TransformerConfig.from_json(config_json)
    cfg.remat = remat
    model = VQNSynthTransformer(cfg)
    model.load_state_dict(state)
    return model


def gathered_grads(model):
    """Every parameter's gradient, whole (shards gathered over the model
    group), by name."""
    mesh = getattr(model, "mesh", None)
    out = {}
    for name, p in model.named_parameters():
        dim = model.param_dims.get(name) if mesh is not None else None
        out[name] = (collectives.all_gather_dim(p.grad, dim,
                                                mesh.model_group)
                     if dim is not None else p.grad).clone()
    return out


def prior_step(case, mesh=None):
    """One train step (and, with ``case['weights']``, one eval step) of
    ``case``'s prior on ``mesh`` (one process without): metrics, the whole
    parameters and gradients after it."""
    model = prior_model(case["config"], case["state"], case.get("remat"))
    hier = case["hier"]
    tops = torch.as_tensor(case["tops"])
    bottoms = torch.as_tensor(case["bottoms"])
    weights = case.get("weights")
    if mesh is not None:
        pmesh.shard_prior_parameters(model, mesh)
        tops, bottoms = pmesh.shard_batch(mesh, (tops, bottoms))
        if weights is not None:
            weights = pmesh.shard_batch(mesh, weights)
    optimizer = scheduler.get_optimizer(
        model.parameters(), "adam", None, case["lr"], 10,
        clip_grad_norm=case.get("clip"))
    if mesh is not None and mesh.n_model > 1:
        optimizer.sharded = [model.param_dims[n] is not None
                             for n, _ in model.named_parameters()]
        optimizer.model_group = mesh.model_group
    cfg = model.config
    if case.get("mask") is not None:
        sampler = FixedMask(case["mask"])
    elif hier == "top":
        sampler = train_prior.make_mask_sampler(
            case.get("sampler", "uniform-probability"),
            cfg.source_sequence_length, cfg.mask_token_index, 0.5, 0.25)
    else:
        sampler = None
    step, eval_step = train_prior.make_steps(model, optimizer, hier,
                                             sampler, 0.1, mesh=mesh)
    out = {}
    if weights is not None:
        sums, count = eval_step(tops, bottoms, {}, torch.as_tensor(weights),
                                torch.Generator().manual_seed(2))
        out["eval"] = ({k: float(v) for k, v in sums.items()}, float(count))
    generator = torch.Generator().manual_seed(case.get("seed", 0))
    metrics = step(tops, bottoms, {}, generator)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = gathered_grads(model) if mesh is not None else {
        n: p.grad.clone() for n, p in model.named_parameters()}
    out["params"] = (pmesh.gather_prior_parameters(model) if mesh is not None
                     else model.state_dict())
    return out


def _meshes():
    """Both two-rank meshes, built in the same order on every rank."""
    return {(2, 1): pmesh.make_mesh(2, 1), (1, 2): pmesh.make_mesh(1, 2)}


def prior_steps(rank, payload):
    meshes = _meshes()
    return {name: prior_step(case, meshes[case["mesh"]])
            for name, case in payload.items()}


# -- the VQ-VAE ----------------------------------------------------------------

def vqvae_step(case, mesh=None):
    """One train step and one eval step of ``case``'s VQ-VAE: metrics,
    eval sums, the parameters, gradients and codebook buffers after the
    step."""
    model = tv.VQVAE(tv.VQVAEConfig.from_json(case["config"]))
    model.load_state_dict(case["state"])
    helper = tspec.get_spectrograms_helper(**case["spec"])
    audio = torch.as_tensor(case["audio"])
    weights = torch.as_tensor(case["weights"])
    if mesh is not None:
        pmesh.set_data_mesh(model, mesh)
        audio, weights = pmesh.shard_batch(mesh, (audio, weights))
    optimizer = scheduler.get_optimizer(model.parameters(), "adam", None,
                                        case["lr"], 10)
    step = train_vqvae.make_train_step(
        model, optimizer, losses.mse_loss, 0.25, helper, mesh=mesh)
    eval_step = train_vqvae.make_eval_step(model, losses.mse_loss, 0.25,
                                           helper, mesh=mesh)
    sums, count = eval_step(audio, weights)
    generator = torch.Generator().manual_seed(case.get("seed", 0))
    metrics = step(audio, generator)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "eval": ({k: float(v) for k, v in sums.items()}, float(count)),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def vqvae_steps(rank, payload):
    mesh = pmesh.make_mesh(2, 1)
    return {name: vqvae_step(case, mesh) for name, case in payload.items()}


# -- the trainers' main -----------------------------------------------------

class RunDir:
    """An argument of ``run_mains``: the one run directory that a main run
    earlier in the same job made under ``runs``."""

    def __init__(self, runs):
        self.runs = pathlib.Path(runs)

    def __str__(self):
        (path,) = self.runs.iterdir()
        return str(path)


def run_mains(rank, payload):
    """The trainers' ``main`` at two ranks, one after the other (each
    rank's files written before the next starts): each entry of
    ``payload`` is (module name, argv); returns what ``main`` returned (a
    prior's whole parameters, or the evaluation metrics) or the
    ``SystemExit`` text."""
    mains = {"prior": train_prior.main, "vqvae": train_vqvae.main}
    out = {}
    for name, (which, argv) in payload.items():
        try:
            result = mains[which]([str(a) for a in argv])
        except SystemExit as e:
            out[name] = f"SystemExit: {e}"
            continue
        finally:
            dist.barrier()
        if isinstance(result, torch.nn.Module):
            result = (pmesh.gather_prior_parameters(result)
                      if which == "prior" else result.state_dict())
        out[name] = result
    return out


# -- sampling and extraction ------------------------------------------------------

def sharded_samples(rank, payload):
    """``make_sharded_sampling_fn`` at two data ranks for each case: the
    whole ``[batch, F, T]`` codemap every rank returns."""
    from interactive_spectrogram_inpainting_tpu_torch.sampling import (
        make_sharded_sampling_fn)
    mesh = pmesh.make_mesh(2, 1)
    out = {}
    for name, case in payload.items():
        model = prior_model(case["config"], case["state"]).eval()
        fn = make_sharded_sampling_fn(model, case["batch"], mesh,
                                      temperature=case["temperature"],
                                      device="cpu")
        out[name] = fn(None, case["condition"], case["initial"],
                       case["mask"], {}, gumbels=case["gumbels"])
    return out


def extract(rank, payload):
    """``extract_split`` at two data ranks into ``payload['store']``."""
    from interactive_spectrogram_inpainting_tpu_torch.data.nsynth import (
        NSynth)
    from interactive_spectrogram_inpainting_tpu_torch.extract import (
        extract_codes)
    model = tv.VQVAE(tv.VQVAEConfig.from_json(payload["config"]))
    model.load_state_dict(payload["state"])
    dataset = NSynth(payload["root"], payload["root"] / "examples.json",
                     **payload["dataset"])
    helper = tspec.get_spectrograms_helper(**payload["spec"])
    return extract_codes.extract_split(model, helper, dataset,
                                       payload["store"],
                                       batch_size=payload["batch_size"],
                                       device="cpu")


def run_jobs(rank, payload):
    """Several of the jobs above in one spawn: ``payload`` maps a job's
    name to its payload."""
    jobs = {"prior_steps": prior_steps, "vqvae_steps": vqvae_steps,
            "run_mains": run_mains, "sharded_samples": sharded_samples,
            "extract": extract}
    return {name: jobs[name](rank, job) for name, job in payload.items()}
