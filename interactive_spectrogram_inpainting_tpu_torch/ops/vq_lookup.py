"""Nearest-codebook lookup with EMA statistics (hand-written CUDA for sm_90a).

Replaces the Pallas kernel
``interactive_spectrogram_inpainting_tpu/ops/vq_lookup.py::fused_vq_lookup``:
for rows ``flat [N, dim]`` and a codebook ``embed [dim, K]``,

    ids       = argmin_k (|e_k|^2 - 2 x . e_k)     (lowest k on a tie)
    quantize  = embed[:, ids].T
    counts[k] = #{n : ids[n] = k}
    embed_sum = flat.T @ onehot(ids)

without the ``[N, K]`` score and one-hot matrices ever reaching device
memory. ``QuantizedBottleneck`` reaches it when ``use_pallas_lookup`` is set
(in evaluation as in training), so a server or an extraction run that loads
such a model encodes through it.

``fused_vq_lookup`` launches ``csrc/vq_lookup.cu`` for CUDA tensors and runs
``reference_vq_lookup`` (the dense plain version) for CPU tensors, never
falling back from one to the other. ``counts`` and ``embed_sum`` of the
kernel are sums in a fixed order without float atomics: two calls on the
same inputs give the same bits. ``fused_vq_lookup.launches`` counts the
calls that reached the GPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .common import check_cuda, ptr, raise_on_error, struct_type

# widest embedding the stats kernel's one-thread-per-dimension sum covers
MAX_DIM = 256
# rows one block of the stats kernel scans (kSegmentRows in the source)
SEGMENT_ROWS = 2048

_VqLookupParams = struct_type(
    "VqLookupParams",
    pointers=("flat", "embed", "embed_t", "embed_sq", "ids", "quantize",
              "counts", "embed_sum", "part_sum", "part_count"),
    ints=("n", "dim", "n_embed"), floats=())

VqOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reference_vq_lookup(flat: torch.Tensor, embed: torch.Tensor
                        ) -> VqOutputs:
    """Dense plain version: flat [N, dim], embed [dim, K] -> (ids [N] int32,
    quantize [N, dim], counts [K], embed_sum [dim, K]), all float32."""
    flat = flat.float()
    embed = embed.float()
    n_embed = embed.shape[1]
    scores = (embed * embed).sum(0)[None] - 2.0 * (flat @ embed)
    ids = torch.argmin(scores, dim=1)
    onehot = torch.nn.functional.one_hot(ids, n_embed).to(torch.float32)
    quantize = embed.T[ids]
    return (ids.to(torch.int32), quantize, onehot.sum(0), flat.T @ onehot)


def fused_vq_lookup(flat: torch.Tensor, embed: torch.Tensor) -> VqOutputs:
    """flat [N, dim] float32 (no gradient flows through the lookup: pass it
    detached), embed [dim, K] float32 -> (ids, quantize, counts,
    embed_sum) as ``reference_vq_lookup``."""
    if flat.requires_grad or embed.requires_grad:
        raise ValueError("fused_vq_lookup takes detached inputs; the "
                         "straight-through estimator sits outside it")
    if flat.dim() != 2 or embed.dim() != 2 or flat.shape[1] != embed.shape[0]:
        raise ValueError(f"expected flat [N, dim] and embed [dim, K], got "
                         f"{tuple(flat.shape)} and {tuple(embed.shape)}")
    if flat.device.type != "cuda":
        return reference_vq_lookup(flat, embed)
    from .build import load
    n, dim = flat.shape
    n_embed = embed.shape[1]
    check_cuda({"flat": flat, "embed": embed},
               {"flat": (torch.float32,), "embed": (torch.float32,)})
    if n == 0 or not 0 < dim <= MAX_DIM or n_embed == 0:
        raise ValueError(f"fused_vq_lookup needs N > 0, K > 0 and "
                         f"0 < dim <= {MAX_DIM}")
    device = flat.device
    ids = torch.empty(n, device=device, dtype=torch.int32)
    quantize = torch.empty(n, dim, device=device, dtype=torch.float32)
    counts = torch.empty(n_embed, device=device, dtype=torch.float32)
    embed_sum = torch.empty(dim, n_embed, device=device, dtype=torch.float32)
    embed_t = torch.empty(n_embed, dim, device=device, dtype=torch.float32)
    embed_sq = torch.empty(n_embed, device=device, dtype=torch.float32)
    segments = -(-n // SEGMENT_ROWS)
    part_sum = part_count = None
    if segments > 1:  # per-segment partials, added in a fixed order
        part_sum = torch.empty(segments, dim, n_embed, device=device,
                               dtype=torch.float32)
        part_count = torch.empty(segments, n_embed, device=device,
                                 dtype=torch.int32)
    args = _VqLookupParams(
        flat=ptr(flat), embed=ptr(embed), embed_t=ptr(embed_t),
        embed_sq=ptr(embed_sq), ids=ptr(ids), quantize=ptr(quantize),
        counts=ptr(counts), embed_sum=ptr(embed_sum), part_sum=ptr(part_sum),
        part_count=ptr(part_count), n=n, dim=dim, n_embed=n_embed)
    lib = load("vq_lookup")
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.isi_vq_lookup(ctypes.byref(args), ctypes.c_void_p(stream))
    raise_on_error(lib, code, "fused_vq_lookup")
    fused_vq_lookup.launches += 1
    return ids, quantize, counts, embed_sum


fused_vq_lookup.launches = 0
