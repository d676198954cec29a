"""Training-time inpainting mask samplers for the self-conditional prior.

Port of ``interactive_spectrogram_inpainting_tpu/models/prior/masks.py``.
Masks are boolean ``[B, L]`` tensors over flattened sequences, ``True`` =
masked (to be regenerated). Each sampler splits its work in two:
``draw(generator, batch_size)`` takes the random numbers from an explicit
``torch.Generator`` and ``from_draws(**draws)`` turns them into the mask,
so that a test can hand it the JAX package's draws and get the JAX mask.
``sample_mask`` does both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Draws = Dict[str, torch.Tensor]


class SequenceMask:
    def __init__(self, sequence_duration: int, mask_token_index: int):
        self.sequence_duration = int(sequence_duration)
        self.mask_token_index = int(mask_token_index)

    def draw(self, generator: Optional[torch.Generator],
             batch_size: int = 1) -> Draws:
        raise NotImplementedError("subclass this")

    def from_draws(self, **draws: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("subclass this")

    def sample_mask(self, generator: Optional[torch.Generator] = None,
                    batch_size: int = 1) -> torch.Tensor:
        return self.from_draws(**self.draw(generator, batch_size))

    def apply_mask(self, generator: Optional[torch.Generator],
                   input: torch.Tensor) -> torch.Tensor:
        mask = self.sample_mask(generator, batch_size=input.shape[0])
        return torch.where(mask.to(input.device), self.mask_token_index,
                           input)


def _uniform(generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator)


class BernoulliSequenceMask(SequenceMask):
    def __init__(self, probability: float, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.probability = float(probability)

    def draw(self, generator, batch_size: int = 1) -> Draws:
        return {"uniform": _uniform(generator, batch_size,
                                    self.sequence_duration)}

    def from_draws(self, uniform: torch.Tensor) -> torch.Tensor:
        return uniform < self.probability


class UniformProbabilityBernoulliSequenceMask(SequenceMask):
    """Bernoulli mask whose probability is itself uniform in [low, high]."""

    def __init__(self, low: float = 0.0, high: float = 1.0, *args, **kwargs):
        if not 0 <= low < high <= 1:
            raise ValueError(f"need 0 <= low < high <= 1, got {low}, {high}")
        super().__init__(*args, **kwargs)
        self.low = float(low)
        self.high = float(high)

    def draw(self, generator, batch_size: int = 1) -> Draws:
        p = self.low + (self.high - self.low) * _uniform(generator)
        return {"p": p, "uniform": _uniform(generator, batch_size,
                                            self.sequence_duration)}

    def from_draws(self, p: torch.Tensor,
                   uniform: torch.Tensor) -> torch.Tensor:
        return uniform < p


class UniformMaskedAmountSequenceMask(SequenceMask):
    """Mask exactly k tokens, k ~ Uniform[min_amount, L]; positions chosen
    without replacement (the same k for the whole batch)."""

    def __init__(self, min_masking_ratio: float = 0.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_masking_ratio = float(min_masking_ratio)
        self.min_masked_amount = int(math.ceil(
            self.sequence_duration * self.min_masking_ratio))

    def draw(self, generator, batch_size: int = 1) -> Draws:
        k = torch.randint(self.min_masked_amount, self.sequence_duration + 1,
                          (), generator=generator)
        return {"k": k, "scores": _uniform(generator, batch_size,
                                           self.sequence_duration)}

    def from_draws(self, k: torch.Tensor,
                   scores: torch.Tensor) -> torch.Tensor:
        # rank of each position under a random per-row permutation; the
        # first k ranks are masked
        ranks = torch.argsort(torch.argsort(scores, dim=1, stable=True),
                              dim=1, stable=True)
        return ranks < k


class ContiguousZonesSequenceMask(SequenceMask):
    """Mask one contiguous span with random offset and length."""

    def __init__(self, min_masking_ratio: float = 0.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_masked_amount = max(1, int(math.ceil(
            self.sequence_duration * float(min_masking_ratio))))

    def draw(self, generator, batch_size: int = 1) -> Draws:
        length = torch.randint(self.min_masked_amount,
                               self.sequence_duration + 1, (batch_size,),
                               generator=generator)
        offset = torch.randint(0, self.sequence_duration, (batch_size,),
                               generator=generator)
        return {"length": length, "offset": offset}

    def from_draws(self, length: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
        offset = torch.minimum(offset, self.sequence_duration - length)
        pos = torch.arange(self.sequence_duration)[None, :]
        return (pos >= offset[:, None]) & (pos < (offset + length)[:, None])
