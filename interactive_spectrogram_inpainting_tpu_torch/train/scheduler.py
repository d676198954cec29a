"""Learning-rate schedules and the optimizer of the trainers.

Port of ``interactive_spectrogram_inpainting_tpu/train/scheduler.py``. A
schedule is a plain function of the optimizer step (0 for the first
update), with the formulas of the optax schedules the JAX package builds:
the fastai 1-cycle (``cycle_schedule``, with ``cycle_momentum_schedule``
cycling Adam's ``b1`` inversely), HuggingFace's cosine with warmup, and a
constant. ``get_optimizer`` wraps ``torch.optim.Adam`` / ``RAdam``: before
each update it sets the learning rate (and under ``cycle`` the first
``beta``) of the step and, with ``clip_grad_norm``, scales the gradients to
that global norm as optax's ``clip_by_global_norm`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def fn(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return fn


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two schedules."""
    return lambda count: first(count) if count < boundary else second(
        count - boundary)


def cycle_schedule(lr_max: float, total_steps: int,
                   warmup_proportion: float = 0.3,
                   div_factor: float = 25.0,
                   final_div_factor: float = 1e4) -> Schedule:
    """fastai 1-cycle: linear warmup from ``lr_max / div_factor`` to
    ``lr_max``, then cosine anneal down to ``lr_max / (div_factor *
    final_div_factor)``."""
    warmup = max(1, int(total_steps * warmup_proportion))
    decay = max(1, total_steps - warmup)
    alpha = 1.0 / (div_factor * final_div_factor)

    def cosine(count):
        count = min(count, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return lr_max * ((1.0 - alpha) * cos + alpha)

    return _join(_linear(lr_max / div_factor, lr_max, warmup), cosine, warmup)


def cycle_momentum_schedule(total_steps: int, m_min: float = 0.85,
                            m_max: float = 0.95,
                            warmup_proportion: float = 0.3) -> Schedule:
    """Momentum of the 1-cycle policy: linear ``m_max -> m_min`` over the
    warmup, then a cosine recovery back to ``m_max``."""
    warmup = max(1, int(total_steps * warmup_proportion))
    recover = max(1, total_steps - warmup)

    def cos_recover(count):
        t = min(max(count / recover, 0.0), 1.0)
        return m_max + (m_min - m_max) / 2.0 * (math.cos(math.pi * t) + 1.0)

    return _join(_linear(m_max, m_min, warmup), cos_recover, warmup)


def cosine_schedule_with_warmup(lr: float, num_warmup_steps: int,
                                num_training_steps: int,
                                num_cycles: float = 0.5) -> Schedule:
    """HuggingFace get_cosine_schedule_with_warmup."""

    def fn(step):
        step = min(step, num_training_steps)
        warm = min(max(step / max(1, num_warmup_steps), 0.0), 1.0)
        progress = min(max((step - num_warmup_steps)
                           / max(1, num_training_steps - num_warmup_steps),
                           0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return lr * (warm if step < num_warmup_steps else max(0.0, cos))

    return fn


def constant_schedule(lr: float) -> Schedule:
    return lambda count: lr


def get_scheduler(name: Optional[str], lr: float, total_steps: int,
                  warmup_steps: int = 0) -> Schedule:
    """CLI-facing factory: None/'' -> constant, 'cycle', 'warmup-cosine'."""
    if not name:
        return constant_schedule(lr)
    if name == "cycle":
        return cycle_schedule(lr, total_steps)
    if name in ("warmup-cosine", "warmup_cosine"):
        return cosine_schedule_with_warmup(
            lr, warmup_steps or int(0.02 * total_steps), total_steps)
    raise ValueError(f"unknown scheduler {name}")


def clip_by_global_norm(grads: Iterable[Optional[torch.Tensor]],
                        max_norm: float,
                        sharded: Optional[Sequence[bool]] = None,
                        model_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times
    ``max_norm / norm`` when the global norm reaches ``max_norm``. Returns
    the norm (a tensor: nothing waits for the device).

    ``sharded`` / ``model_group``: which gradients are one shard of a
    parameter split over the model group; their squares are summed over
    the group, the replicated ones counted once."""
    if model_group is None:
        grads = [g for g in grads if g is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        pairs = [(g, s) for g, s in zip(grads, sharded) if g is not None]
        grads = [g for g, _ in pairs]
        split = torch.zeros((), device=grads[0].device)
        whole = torch.zeros((), device=grads[0].device)
        for g, s in pairs:
            square = torch.linalg.vector_norm(g.float()) ** 2
            if s:
                split = split + square
            else:
                whole = whole + square
        torch.distributed.all_reduce(split, group=model_group)
        norm = torch.sqrt(split + whole)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class Optimizer:
    """A ``torch.optim`` optimizer under a schedule: ``step()`` applies the
    step's learning rate (and first beta), clips, updates and counts.
    ``state_dict`` / ``load_state_dict`` carry the step count."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule,
                 b1_schedule: Optional[Schedule] = None,
                 clip_grad_norm: Optional[float] = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.b1_schedule = b1_schedule
        self.clip_grad_norm = clip_grad_norm
        self.count = 0
        # tensor parallelism: which parameters are shards over this group
        self.sharded: Optional[Sequence[bool]] = None
        self.model_group = None

    @property
    def params(self):
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_grad_norm:
            clip_by_global_norm((p.grad for p in self.params),
                                self.clip_grad_norm, self.sharded,
                                self.model_group)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
            if self.b1_schedule is not None:
                group["betas"] = (self.b1_schedule(self.count),
                                  group["betas"][1])
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def get_optimizer(params, opt_name: str, sched_name: Optional[str], lr: float,
                  total_steps: int, warmup_steps: int = 0, eps: float = 1e-8,
                  clip_grad_norm: Optional[float] = None) -> Optimizer:
    """Adam or RAdam under the named schedule; the 1-cycle policy also
    cycles ``b1`` inversely to the learning rate."""
    schedule = get_scheduler(sched_name, lr, total_steps, warmup_steps)
    cls = torch.optim.RAdam if opt_name == "radam" else torch.optim.Adam
    optimizer = cls(params, lr=schedule(0), eps=eps)
    b1 = cycle_momentum_schedule(total_steps) if sched_name == "cycle" \
        else None
    return Optimizer(optimizer, schedule, b1, clip_grad_norm)
