"""Collectives of the parallel paths.

Tensor parallelism (Megatron's two operators, over a mesh's model group):

- ``copy_to_model``: the identity forward, an all-reduce (sum) of the
  gradient backward; it sits where a replicated activation enters a sharded
  projection (q / k / v, ``fc1``), so the activation's gradient sums the
  shards' contributions;
- ``reduce_from_model``: an all-reduce (sum) forward, the identity
  backward; it sits after the sharded ``o`` and ``fc2`` products, whose
  biases are added once, after it.

Data parallelism (over a mesh's data group): the mean of metrics, the sum
of eval sums and codebook statistics, the mean of gradients, and the
all-gather of batch rows.

Every function takes the group as it is on the mesh: ``None`` (one process
without a process group) makes it the identity.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place; returns ``x``."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def mean_of_metrics(metrics: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """Each 0-dim metric's mean over the group (one collective)."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked, group=group)
    stacked = stacked / dist.get_world_size(group)
    return {k: stacked[i] for i, k in enumerate(keys)}


def sum_of_eval(sums: Dict[str, torch.Tensor], count: torch.Tensor, group):
    """An eval step's (weighted sums, weight sum) summed over the group
    (one collective)."""
    if group is None:
        return sums, count
    keys = list(sums)
    stacked = torch.stack([sums[k].float() for k in keys]
                          + [count.float()])
    dist.all_reduce(stacked, group=group)
    return {k: stacked[i] for i, k in enumerate(keys)}, stacked[-1]


def mean_of_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Each gradient replaced by its mean over the group: one all-reduce of
    the gradients flattened into one buffer, so the update is the
    global-batch update."""
    if group is None:
        return
    grads: List[torch.Tensor] = [p.grad for p in params
                                 if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order (the inverse of a split into equal blocks)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks of a batch, in rank order."""
    return all_gather_dim(x, 0, group)


def owned_rows(flat: torch.Tensor, index: torch.Tensor, data_index: int,
               group) -> torch.Tensor:
    """Rows ``index`` (global row numbers) of a batch split into equal
    blocks over the group, this rank holding block ``data_index`` as
    ``flat``: every rank contributes the rows it owns, zeros elsewhere, and
    one all-reduce (sum) hands every rank all of them, exactly."""
    if group is None:
        return flat[index]
    n_local = flat.shape[0]
    owner = torch.div(index, n_local, rounding_mode="floor")
    local = (index - owner * n_local).clamp(0, n_local - 1)
    rows = torch.where((owner == data_index)[:, None], flat[local],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    dist.all_reduce(rows, group=group)
    return rows


def optional_group(mesh, kind: str) -> Optional[object]:
    """``mesh.data_group`` / ``mesh.model_group``, ``None`` without a mesh."""
    return None if mesh is None else getattr(mesh, f"{kind}_group")
