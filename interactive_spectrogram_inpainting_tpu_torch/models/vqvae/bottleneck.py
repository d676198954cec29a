"""EMA vector-quantization codebook (decode side).

Port of the codebook and ``embed_code`` of
``interactive_spectrogram_inpainting_tpu/models/vqvae/bottleneck.py``.
The codebook ``embed`` is a ``[dim, n_embed]`` buffer, as in the JAX
``codebook`` collection. The nearest-code lookup, the EMA update, code
corruption and restarts (the encode and training paths) are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class QuantizedBottleneck(nn.Module):
    def __init__(self, dim: int, n_embed: int,
                 embeddings_initial_variance: float = 1.0):
        super().__init__()
        self.dim = dim
        self.n_embed = n_embed
        scale = float(embeddings_initial_variance) ** 0.5
        self.register_buffer("embed", scale * torch.randn(dim, n_embed))

    def embed_code(self, ids: torch.Tensor) -> torch.Tensor:
        """[...] int -> [..., dim] codebook lookup."""
        return self.embed.T[ids.long()]
