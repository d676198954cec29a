"""Checkpoint and resume of the trainers.

Port of ``interactive_spectrogram_inpainting_tpu/train/checkpoint.py``,
with its layout on disk: in a run directory,

- ``command_line_parameters.json`` and ``model_parameters.json``, the
  sidecars that inference tools read;
- ``checkpoints/<epoch>/state.pt``, a rolling save every
  ``save_frequency`` epochs of which the newest 3 are kept;
- ``best/<epoch>/state.pt`` (one) and ``best_validation_loss.json``, kept
  whenever the validation loss improves.

The state is a dictionary of ``state_dict``s (the model's, the
optimizer's) written with ``torch.save``; it holds only tensors and plain
Python values, so ``restore`` loads it with ``weights_only=True``. The
models themselves are exchanged with the JAX package through
``utils/checkpoint_io.py::save_model``.

A prior trained over a model group (``parallel/mesh.py``) keeps the
one-device format: ``gather_optimizer_state`` (with
``mesh.gather_prior_parameters`` for the model) assembles the whole state
on every rank before rank 0 writes it, and ``shard_optimizer_state`` cuts
a restored optimizer state back to this rank's shard (the trainer loads
the whole model before it shards it).
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..parallel.collectives import all_gather_dim
from ..parallel.mesh import shard_tensor

STATE_FILE = "state.pt"
KEEP = 3


def _json_safe(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


class Checkpointer:
    def __init__(self, directory: Union[str, pathlib.Path],
                 save_frequency: int = 1):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_frequency = int(save_frequency)
        self.best_validation_loss = math.inf
        marker = self.directory / "best_validation_loss.json"
        if marker.exists():
            self.best_validation_loss = json.loads(
                marker.read_text())["validation_loss"]

    # -- sidecars ------------------------------------------------------------
    def store_command_line_parameters(self, args: Mapping[str, Any]) -> None:
        with open(self.directory / "command_line_parameters.json", "w") as f:
            json.dump({k: v for k, v in dict(args).items()
                       if _json_safe(v)}, f, indent=4, default=str)

    def store_model_parameters(self, kwargs_json: str,
                               name: str = "model_parameters.json") -> None:
        (self.directory / name).write_text(kwargs_json)

    # -- save / restore ------------------------------------------------------
    @staticmethod
    def _epochs(root: pathlib.Path):
        if not root.is_dir():
            return []
        return sorted(int(p.name) for p in root.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    @staticmethod
    def _write(root: pathlib.Path, epoch: int, state) -> None:
        target = root / str(epoch)
        tmp = root / f".{epoch}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(state, tmp / STATE_FILE)
        shutil.rmtree(target, ignore_errors=True)
        os.replace(tmp, target)

    def save(self, epoch: int, state: Dict[str, Any],
             validation_loss: Optional[float] = None,
             validation_metrics: Optional[Dict[str, float]] = None) -> bool:
        """Rolling save; returns True if this became the best checkpoint."""
        if epoch % self.save_frequency == 0:
            root = self.directory / "checkpoints"
            self._write(root, epoch, state)
            for old in self._epochs(root)[:-KEEP]:
                shutil.rmtree(root / str(old))
        is_best = (validation_loss is not None
                   and validation_loss < self.best_validation_loss)
        if is_best:
            self.best_validation_loss = float(validation_loss)
            root = self.directory / "best"
            self._write(root, epoch, state)
            for old in self._epochs(root)[:-1]:
                shutil.rmtree(root / str(old))
            payload = {"validation_loss": float(validation_loss),
                       "epoch": int(epoch)}
            if validation_metrics:
                payload["validation_metrics"] = {
                    k: float(v) for k, v in validation_metrics.items()}
            (self.directory / "best_validation_loss.json").write_text(
                json.dumps(payload, indent=4))
        return is_best

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs(self.directory / "checkpoints")
        return epochs[-1] if epochs else None

    def _restore(self, root: pathlib.Path, epoch: Optional[int],
                 map_location) -> Tuple[Dict[str, Any], int]:
        epochs = self._epochs(root)
        step = epoch if epoch is not None else (epochs[-1] if epochs
                                                else None)
        if step is None or step not in epochs:
            raise FileNotFoundError(f"no checkpoint found under {root}")
        state = torch.load(root / str(step) / STATE_FILE,
                           map_location=map_location, weights_only=True)
        return state, step

    def restore(self, epoch: Optional[int] = None, map_location=None
                ) -> Tuple[Dict[str, Any], int]:
        """(state, epoch) of the given or the latest rolling save."""
        return self._restore(self.directory / "checkpoints", epoch,
                             map_location)

    def restore_best(self, map_location=None) -> Tuple[Dict[str, Any], int]:
        return self._restore(self.directory / "best", None, map_location)


def _per_parameter(state: Dict[str, Any], model: nn.Module, fn
                   ) -> Dict[str, Any]:
    """``state`` (an ``Optimizer.state_dict()``) with ``fn(tensor, dim)``
    applied to every per-parameter tensor of a parameter split along
    ``dim`` (the model's ``param_dims``, by the order of its parameters)."""
    dims = getattr(model, "param_dims", None)
    if not dims or all(d is None for d in dims.values()):
        return state
    order = [dims[name] for name, _ in model.named_parameters()]
    inner = dict(state["optimizer"])
    per = {}
    for index, entries in inner["state"].items():
        dim = order[int(index)]
        per[index] = {k: (fn(v, dim) if dim is not None
                          and isinstance(v, torch.Tensor) and v.dim() > 0
                          else v) for k, v in entries.items()}
    inner["state"] = per
    return {**state, "optimizer": inner}


def gather_optimizer_state(state: Dict[str, Any], model: nn.Module
                           ) -> Dict[str, Any]:
    """The whole optimizer state of a model sharded by
    ``shard_prior_parameters`` (every model rank must call it)."""
    mesh = getattr(model, "mesh", None)
    group = None if mesh is None else mesh.model_group
    return _per_parameter(state, model,
                          lambda t, dim: all_gather_dim(t, dim, group))


def shard_optimizer_state(state: Dict[str, Any], model: nn.Module
                          ) -> Dict[str, Any]:
    """This rank's shard of a whole optimizer state."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return state
    return _per_parameter(state, model, lambda t, dim: shard_tensor(
        t, dim, mesh.n_model, mesh.model_index).clone())
