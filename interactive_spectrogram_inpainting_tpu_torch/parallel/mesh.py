"""The ``('data', 'model')`` process mesh of the trainers, the sampler and
extraction.

Port of ``interactive_spectrogram_inpainting_tpu/parallel/mesh.py`` to
``torch.distributed``: one process per device, as ``torchrun`` launches
them. Rank ``r`` of ``n_data * n_model`` sits at ``(r // n_model, r %
n_model)``, the row-major order of the JAX package's device grid. The ranks
of one row share a model group (tensor parallelism: Megatron-style heads /
d_ff shards of the priors, ``parallel/collectives.py``); the ranks of one
column share a data group (batches split into contiguous row blocks,
gradients and statistics summed over it).

A mesh of one process without a process group has no groups at all: every
collective of ``parallel/collectives.py`` is then the identity and costs
nothing, so a one-process run computes exactly what it computed before the
mesh existed. With a process group, even of one rank, the collectives run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def world() -> "tuple[int, int]":
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device_count() -> int:
    """CUDA devices of this host (1 for the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and its two groups (``None`` when
    there is no process group)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous block of a global batch (``P('data')``)."""
        if batch_size % self.n_data:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{self.n_data} data ranks")
        per = batch_size // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``(n_data, n_model)`` mesh over the process group's ranks.
    ``n_data`` defaults to ``WORLD_SIZE // n_model``; a mesh that does not
    cover the world exactly raises. Every rank must call this, in the same
    order (``new_group`` is collective)."""
    rank, world_size = world()
    if n_model < 1 or world_size % n_model:
        raise ValueError(f"n_model {n_model} does not divide the world "
                         f"size {world_size}")
    if n_data is None:
        n_data = world_size // n_model
    if n_data * n_model != world_size:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"world size {world_size}")
    data_index, model_index = divmod(rank, n_model)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(n_data, n_model, data_index, model_index)
    grid = np.arange(world_size).reshape(n_data, n_model)
    data_group = model_group = None
    for m in range(n_model):
        group = dist.new_group([int(r) for r in grid[:, m]])
        if m == model_index:
            data_group = group
    for d in range(n_data):
        group = dist.new_group([int(r) for r in grid[d]])
        if d == data_index:
            model_group = group
    return Mesh(n_data, n_model, data_index, model_index, data_group,
                model_group)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a host batch: arrays, tensors, and dicts / lists /
    tuples of them, split on their leading axis (``P('data')``)."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[mesh.rows(batch.shape[0])]


# no split: the placement of every tensor the rules below do not name
replicated = None


def prior_param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dimension of a prior parameter split over the model group, or
    ``None`` (replicated), by the port's parameter name. The JAX package's
    ``prior_param_spec`` rule for rule:

    - q / k / v ``weight [H * Dh, d]`` and ``bias [H * Dh]``: by heads
      (dim 0; rows are head-major);
    - o ``weight [d, H * Dh]``: by heads (dim 1); its bias is replicated
      and added once, after the reduce;
    - ``rel_bias [H, ...]``: by heads;
    - ``fc1`` weight ``[d_ff, d]`` and bias: by d_ff (dim 0);
    - ``fc2`` weight ``[d, d_ff]``: by d_ff (dim 1); its bias replicated;
    - everything else replicated."""
    parts = name.split(".")
    leaf = parts[-1]
    owner = parts[-2] if len(parts) > 1 else ""
    if owner in ("q", "k", "v") and leaf in ("weight", "bias"):
        return 0
    if owner == "o" and leaf == "weight" and tensor.dim() == 2:
        return 1
    if leaf == "rel_bias" and tensor.dim() == 4:
        return 0
    if owner == "fc1" and leaf in ("weight", "bias"):
        return 0
    if owner == "fc2" and leaf == "weight" and tensor.dim() == 2:
        return 1
    return replicated


def prior_param_dims(named: Mapping[str, torch.Tensor], n_model: int,
                     num_heads: int) -> Dict[str, Optional[int]]:
    """``prior_param_spec`` of every full-size parameter, with the JAX
    package's ``prior_param_shardings`` rule on top: a dimension whose head
    count (or d_ff) the model size does not divide stays replicated."""
    dims = {}
    for name, tensor in named.items():
        dim = prior_param_spec(name, tensor) if n_model > 1 else None
        if dim is not None:
            # q/k/v/o rows or columns count heads * head_dim: whole heads
            parts = (num_heads if name.split(".")[-2] in ("q", "k", "v", "o")
                     else tensor.shape[dim])
            if parts % n_model:
                dim = None
        dims[name] = dim
    return dims


def shard_tensor(tensor: torch.Tensor, dim: Optional[int], n: int,
                 index: int) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``tensor`` along ``dim``."""
    if dim is None or n == 1:
        return tensor
    size = tensor.shape[dim] // n
    return tensor.narrow(dim, index * size, size)


def shard_prior_parameters(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice a full prior in place into this rank's shard over the model
    group and tell its layers where they sit on the mesh: the attention
    and feed-forward layers of a split dimension run the tensor-parallel
    collectives, every layer draws its dropout masks for the global batch
    and applies this rank's rows (and d_ff columns). Returns ``model``."""
    from ..models.prior.attention import (DecoderLayer, EncoderLayer,
                                          FeedForward, MultiHeadAttention)
    cfg = model.config
    dims = prior_param_dims(dict(model.named_parameters()), mesh.n_model,
                            cfg.conditional_model_nhead)
    with torch.no_grad():
        for name, dim in dims.items():
            if dim is None:
                continue
            owner_name, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(owner_name)
            part = shard_tensor(getattr(owner, leaf).data, dim,
                                mesh.n_model, mesh.model_index)
            setattr(owner, leaf, nn.Parameter(part.clone()))
    rows = (mesh.n_data, mesh.data_index)
    for name, module in model.named_modules():
        if isinstance(module, (EncoderLayer, DecoderLayer, FeedForward)):
            module.rows = rows
        split = (dims.get(f"{name}.q.weight") is not None
                 if isinstance(module, MultiHeadAttention) else
                 dims.get(f"{name}.fc1.weight") is not None
                 if isinstance(module, FeedForward) else False)
        if split:
            module.model_group = mesh.model_group
            if isinstance(module, FeedForward):
                module.cols = (mesh.n_model, mesh.model_index)
    model.mesh = mesh
    model.param_dims = dims
    return model


def gather_prior_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a prior sharded by ``shard_prior_parameters``
    (every model rank must call it; every rank gets the whole). The inverse
    of the sharding, for checkpoints and the exported weights."""
    from .collectives import all_gather_dim
    mesh = getattr(model, "mesh", None)
    dims = getattr(model, "param_dims", {})
    state = model.state_dict()
    if mesh is None or mesh.n_model == 1:
        return state
    return {name: (all_gather_dim(t, dims[name], mesh.model_group)
                   if dims.get(name) is not None else t)
            for name, t in state.items()}


def set_data_mesh(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Tell a VQ-VAE's codebooks (or any module whose training statistics
    are global) the mesh whose data group they sum over."""
    for module in model.modules():
        if hasattr(module, "embed_avg"):
            module.mesh = mesh
    model.mesh = mesh
    return model


def is_master_process() -> bool:
    """Rank 0 writes logs, figures and checkpoints."""
    return world()[0] == 0


def pad_for_eval(batch_size: int, n_shards: int) -> int:
    """Rows of padding that make an eval batch split over ``n_shards``;
    the padding rows carry weight 0, so the eval's (weighted sums, weight
    sum) stay the exact per-sample means (the reference's
    ``DistributedEvalSampler``)."""
    return (-batch_size) % n_shards


def trainer_mesh(num_devices_data: Optional[int], num_devices_model: int,
                 batch_size: int) -> Mesh:
    """The trainers' mesh from ``--num_devices_data`` /
    ``--num_devices_model``: the data size defaults to ``WORLD_SIZE //
    n_model`` and must divide ``--batch_size``; a mesh that does not
    match the world raises ``SystemExit`` naming the flag."""
    _, world_size = world()
    n_model = int(num_devices_model)
    if n_model < 1 or world_size % n_model:
        raise SystemExit(f"--num_devices_model {n_model} does not divide "
                         f"WORLD_SIZE {world_size}")
    n_data = (world_size // n_model if num_devices_data is None
              else int(num_devices_data))
    if n_data * n_model != world_size:
        raise SystemExit(f"--num_devices_data {n_data} x "
                         f"--num_devices_model {n_model} != WORLD_SIZE "
                         f"{world_size}")
    if batch_size % n_data:
        raise SystemExit(f"--num_devices_data {n_data} must divide "
                         f"--batch_size {batch_size}")
    return make_mesh(n_data, n_model)

