"""EMA vector-quantization bottlenecks.

Port of
``interactive_spectrogram_inpainting_tpu/models/vqvae/bottleneck.py``:
``QuantizedBottleneck`` (nearest-code lookup, usage perplexity, commitment
``diff``, straight-through output and, in training, the EMA codebook update,
dead-code restarts and +/-1 code corruption) and the
``UnquantizedBottleneck`` passthrough of the ``disable_quantization``
ablation.

The codebook state lives in three buffers with the names and layouts of the
JAX ``codebook`` collection: ``embed [dim, n_embed]``, ``cluster_size
[n_embed]``, ``embed_avg [dim, n_embed]``. A training call updates them in
place. Tensors are channel-first: ``x`` is ``[B, dim, f, t]`` and is
flattened so that row ``n`` of ``flat`` is the same cell ``(b, f, t)`` as
in the JAX package's NHWC code.

With ``use_pallas_lookup`` (the JAX package's name for the flag, kept so the
model JSON carries over) and no corruption weights, the lookup and its
statistics go through ``ops/vq_lookup.py::fused_vq_lookup``, the
hand-written kernel on a CUDA tensor; otherwise through the dense
expression ``nearest_code`` plus one-hot reductions.

Random draws (the corruption ``shift`` in {-1, 0, 1} per row and the restart
source rows ``restart_src``) come from an explicit ``torch.Generator`` or
can be passed in, so a test can replay another framework's draws.

On a data group (``mesh``, set by ``parallel/mesh.py::set_data_mesh``), a
training call sees this rank's rows of the global batch. The EMA statistics
(``counts``, ``embed_sum``) are summed over the group before the update,
the usage perplexity is that of the global counts, the corruption shifts
are drawn for the global rows and this rank's kept, and a dead-code
restart takes the global rows its draw names from the ranks that hold
them: every rank's codebook stays the one-process codebook of the global
batch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...ops.vq_lookup import fused_vq_lookup
from ...parallel.collectives import all_reduce_sum, owned_rows


def nearest_code(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_k ||flat_n - embed[:, k]||^2 -> [N] int32 (the ||x||^2 term is
    constant in k and dropped)."""
    e_sq = (embed * embed).sum(0)
    return torch.argmin(e_sq[None] - 2.0 * (flat @ embed),
                        dim=1).to(torch.int32)


class QuantizedBottleneck(nn.Module):
    """EMA-codebook vector quantizer.

    ``forward(x [B, dim, f, t], train) -> (quantized [B, dim, f, t], diff
    scalar, ids [B, f, t] int32, perplexity scalar)``."""

    mesh = None  # the data group of a training call

    def __init__(self, dim: int, n_embed: int, decay: float = 0.99,
                 eps: float = 1e-5, embeddings_initial_variance: float = 1.0,
                 corruption_weights: Optional[List[float]] = None,
                 restart_threshold: float = 1.0,
                 use_pallas_lookup: bool = False):
        super().__init__()
        self.dim = dim
        self.n_embed = n_embed
        self.decay = decay
        self.eps = eps
        self.corruption_weights = (None if corruption_weights is None
                                   else list(corruption_weights))
        self.restart_threshold = restart_threshold
        self.use_pallas_lookup = use_pallas_lookup
        self.embeddings_initial_variance = float(embeddings_initial_variance)
        embed = self.embeddings_initial_variance ** 0.5 * torch.randn(
            dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def forward(self, x: torch.Tensor, train: bool = False, *,
                generator: Optional[torch.Generator] = None,
                shift: Optional[torch.Tensor] = None,
                restart_src: Optional[torch.Tensor] = None,
                per_sample: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """``per_sample``: ``diff`` and ``perplexity`` of each batch row
        alone (``[B]``), as a forward of that row by itself gives them.
        The output and ``diff`` are float32, as the codebook is: a bfloat16
        ``x`` is promoted, as the JAX package promotes it."""
        embed = self.embed
        x_last = x.permute(0, 2, 3, 1)  # [B, f, t, dim]
        # cuDNN may hand over a channels-last tensor: the kernel wants rows
        flat = x_last.reshape(-1, self.dim).float().contiguous()
        flat_const = flat.detach()
        n_rows = flat.shape[0]
        group = None if self.mesh is None or not train \
            else self.mesh.data_group
        n_data, data_index = ((1, 0) if group is None else
                              (self.mesh.n_data, self.mesh.data_index))

        use_fused = self.use_pallas_lookup and self.corruption_weights is None
        if use_fused:
            ids, quantize_flat, counts, embed_sum = fused_vq_lookup(
                flat_const, embed)
            probs = counts / n_rows
        else:
            ids = nearest_code(flat_const, embed)

        if train and self.corruption_weights is not None:
            if shift is None:
                weights = torch.tensor(self.corruption_weights,
                                       dtype=torch.float32)
                shift = _draw(generator, x.device, lambda dev: (
                    torch.multinomial(weights.to(dev), n_rows * n_data,
                                      replacement=True,
                                      generator=generator) - 1))
                shift = shift[data_index * n_rows:(data_index + 1) * n_rows]
            ids = ((ids.long() + shift.to(ids.device).long())
                   % self.n_embed).to(torch.int32)

        if not use_fused:
            onehot = nn.functional.one_hot(
                ids.long(), self.n_embed).to(torch.float32)
            quantize_flat = embed.T[ids.long()]
            probs = onehot.mean(0)
            if train:
                counts = onehot.sum(0)
                embed_sum = flat_const.T @ onehot

        if train:
            if group is not None:
                stats = all_reduce_sum(
                    torch.cat([counts[None], embed_sum]), group)
                counts, embed_sum = stats[0], stats[1:]
                probs = counts / (n_rows * n_data)
            self._ema_update(flat_const, counts, embed_sum, generator,
                             restart_src, group, n_data, data_index)

        quantize = quantize_flat.reshape(x_last.shape).permute(0, 3, 1, 2)
        sq = (quantize.detach() - x) ** 2
        diff = sq.reshape(x.shape[0], -1).mean(1) if per_sample else sq.mean()
        quantize = x + (quantize - x).detach()
        if per_sample:
            rows = ids.reshape(x.shape[0], -1).long()
            probs = torch.zeros(rows.shape[0], self.n_embed,
                                device=rows.device).scatter_add_(
                1, rows, torch.ones(rows.shape, device=rows.device)
            ) / rows.shape[1]
        perplexity = torch.exp(
            -(probs * torch.log(probs.clamp(min=1e-7))).sum(-1))
        return quantize, diff, ids.reshape(x_last.shape[:-1]), perplexity

    @torch.no_grad()
    def _ema_update(self, flat, counts, embed_sum, generator, restart_src,
                    group=None, n_data: int = 1, data_index: int = 0):
        new_cluster = self.decay * self.cluster_size \
            + (1.0 - self.decay) * counts
        new_avg = self.decay * self.embed_avg + (1.0 - self.decay) * embed_sum
        n = new_cluster.sum()
        smoothed = ((new_cluster + self.eps)
                    / (n + self.n_embed * self.eps) * n)
        new_embed = new_avg / smoothed[None]

        if self.restart_threshold < 1.0:
            # codes whose EMA usage share fell below threshold / n_embed
            # are re-seeded from rows of the current batch
            usage_share = new_cluster / n.clamp(min=1e-8)
            dead = usage_share < (self.restart_threshold / self.n_embed)
            if restart_src is None:
                restart_src = _draw(generator, flat.device, lambda dev: (
                    torch.randint(0, flat.shape[0] * n_data, (self.n_embed,),
                                  device=dev, generator=generator)))
            random_vectors = owned_rows(
                flat, restart_src.to(flat.device).long(), data_index,
                group).T
            new_embed = torch.where(dead[None], random_vectors, new_embed)
            new_avg = torch.where(
                dead[None],
                random_vectors * (1.0 - self.decay) + self.decay * new_avg,
                new_avg)

        self.cluster_size.copy_(new_cluster)
        self.embed_avg.copy_(new_avg)
        self.embed.copy_(new_embed)

    def embed_code(self, ids: torch.Tensor) -> torch.Tensor:
        """[...] int -> [..., dim] codebook lookup."""
        return self.embed.T[ids.long()]


def _draw(generator: Optional[torch.Generator], device: torch.device, fn):
    """Run ``fn(device)`` on the generator's own device (a generator only
    serves tensors of its device), or on ``device`` with the default one."""
    return fn(generator.device if generator is not None else device)


class UnquantizedBottleneck(nn.Module):
    """Passthrough for the ``disable_quantization`` ablation; takes and
    ignores the quantizer's arguments."""

    def __init__(self, dim: int, n_embed: int, **_unused):
        super().__init__()
        self.dim = dim
        self.n_embed = n_embed

    def forward(self, x: torch.Tensor, train: bool = False,
                per_sample: bool = False, **_unused):
        shape = (x.shape[0],) if per_sample else ()
        diff = torch.zeros(shape, dtype=x.dtype, device=x.device)
        ids = torch.zeros((x.shape[0],) + tuple(x.shape[2:]),
                          dtype=torch.int32, device=x.device)
        perplexity = torch.full(shape, float("inf"), device=x.device)
        return x, diff, ids, perplexity

    def embed_code(self, ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "UnquantizedBottleneck has no codebook to embed from")
