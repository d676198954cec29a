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

``fused_vq_lookup`` launches ``csrc/vq_lookup.cu`` for CUDA tensors (two
launches a call: the scores on the tensor cores as split TF32 with the
argmin, then a cooperative kernel that sorts the rows by code and sums each
code's rows in a fixed order) and runs ``reference_vq_lookup`` (the dense
plain version) for CPU tensors, never falling back from one to the other.
``vq_lookup_plain`` follows the kernel's arithmetic: the split-TF32 score,
|e|^2 as four interleaved partial sums, the sums by pieces of the sorted
rows. ``counts`` and ``embed_sum`` of the kernel are sums in a fixed order
without float atomics: two calls on the same inputs give the same bits.
``fused_vq_lookup.launches`` counts the calls that reached the GPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .common import ptr, raise_on_error, struct_type

# widest embedding the kernels take (rows above 64 wide are scored 64 dims
# at a time)
MAX_DIM = 1024
# sorted positions one warp of the statistics kernel sums (kPiece)
PIECE_ROWS = 64

_VqLookupParams = struct_type(
    "VqLookupParams",
    pointers=("flat", "embed", "ids", "quantize", "counts", "embed_sum",
              "work"),
    ints=("n", "dim", "n_embed"), floats=())

VqOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# the statistics kernel's int scratch, one per (device, stream), grown as N
# grows: calls on one stream run one after the other
_WORKSPACE: Dict[Tuple[torch.device, int], torch.Tensor] = {}


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | sign).view(torch.float32)


def _fma_sum(terms: torch.Tensor) -> torch.Tensor:
    """Running float32 sum s = fma(v, v, s) over dim 0 of ``terms``, each
    step rounded once (the square and the sum in float64, then rounded)."""
    s = torch.zeros(terms.shape[1:], dtype=torch.float32)
    for v in terms.double():
        s = (s.double() + v * v).float()
    return s


def vq_lookup_plain(flat: torch.Tensor, embed: torch.Tensor) -> VqOutputs:
    """The kernel's arithmetic in plain PyTorch (on the CPU): scores from
    split TF32 (hi = tf32(x), lo = tf32(x - hi); per 8 dimensions lo*hi +
    hi*lo + hi*hi, each product exact, the 8-dimension sum rounded once to
    float32, the k-steps added in float32), |e_k|^2 as four interleaved
    fused multiply-add chains added as (s0 + s1) + (s2 + s3), ids the first
    minimum; embed_sum by pieces of ``PIECE_ROWS`` positions of the rows
    sorted by (code, row), each piece's run summed in order and the pieces
    added in order. Same arguments and results as
    ``reference_vq_lookup``."""
    flat = flat.float().cpu()
    embed = embed.float().cpu()
    n, dim = flat.shape
    n_embed = embed.shape[1]
    dp = -(-dim // 8) * 8
    x = torch.zeros(n, dp)
    x[:, :dim] = flat
    e = torch.zeros(dp, n_embed)
    e[:dim] = embed
    x_hi = tf32_round(x)
    x_lo = tf32_round(x - x_hi)
    e_hi = tf32_round(e)
    e_lo = tf32_round(e - e_hi)
    acc = torch.zeros(n, n_embed)
    for k0 in range(0, dp, 8):
        sl = slice(k0, k0 + 8)
        step = (x_lo[:, sl].double() @ e_hi[sl].double()
                + x_hi[:, sl].double() @ e_lo[sl].double()
                + x_hi[:, sl].double() @ e_hi[sl].double())
        acc = acc + step.float()
    quads = [_fma_sum(e[q::4]) for q in range(4)]
    e_sq = (quads[0] + quads[1]) + (quads[2] + quads[3])
    ids = torch.argmin(e_sq[None] - 2.0 * acc, dim=1)
    counts = torch.bincount(ids, minlength=n_embed).float()
    order = torch.argsort(ids * n + torch.arange(n))
    sorted_ids = ids[order].tolist()
    sums = torch.zeros(n_embed, dim)
    for p0 in range(0, n, PIECE_ROWS):
        code = sorted_ids[p0]
        cont = p0 > 0 and sorted_ids[p0 - 1] == code
        run = torch.zeros(dim)
        for p in range(p0, min(n, p0 + PIECE_ROWS)):
            if sorted_ids[p] != code:
                sums[code] = sums[code] + run if cont else run
                code, cont, run = sorted_ids[p], False, torch.zeros(dim)
            run = run + flat[order[p]]
        sums[code] = sums[code] + run if cont else run
    return (ids.to(torch.int32), embed.T[ids], counts, sums.T.contiguous())


def _workspace(device: torch.device, stream: int, ints: int
               ) -> torch.Tensor:
    work = _WORKSPACE.get((device, stream))
    if work is None or work.numel() < ints:
        work = torch.empty(max(ints, 1), device=device, dtype=torch.int32)
        _WORKSPACE[(device, stream)] = work
    return work


def _params(flat, embed, ids=None, quantize=None, counts=None,
            embed_sum=None, work=None):
    n, dim = flat.shape
    return _VqLookupParams(
        flat=ptr(flat), embed=ptr(embed), ids=ptr(ids),
        quantize=ptr(quantize), counts=ptr(counts),
        embed_sum=ptr(embed_sum), work=ptr(work), n=n, dim=dim,
        n_embed=embed.shape[1])


def vq_refusal(dim: int) -> Optional[str]:
    """None when ``fused_vq_lookup`` takes rows of this width on the card,
    else why not, naming the width."""
    if not 0 < dim <= MAX_DIM:
        return f"fused_vq_lookup: embedding dim {dim} is not in 1..{MAX_DIM}"
    return None


def _check(flat: torch.Tensor, embed: torch.Tensor) -> None:
    """What the kernel takes: detached float32 CUDA tensors on one device,
    contiguous, N > 0, K > 0 and 0 < dim <= MAX_DIM."""
    for name, t in (("flat", flat), ("embed", embed)):
        if t.device.type != "cuda" or t.device != flat.device:
            raise ValueError(f"{name} must lie on flat's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, dim = flat.shape
    reason = vq_refusal(dim)
    if reason is not None:
        raise ValueError(reason)
    if n == 0 or embed.shape[1] == 0:
        raise ValueError("fused_vq_lookup needs N > 0 and K > 0")


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
    _check(flat, embed)
    n, dim = flat.shape
    n_embed = embed.shape[1]
    device = flat.device
    lib = load("vq_lookup")
    lib.isi_vq_workspace_ints.restype = ctypes.c_longlong
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    work = _workspace(device, stream, lib.isi_vq_workspace_ints(
        ctypes.c_int(n), ctypes.c_int(dim), ctypes.c_int(n_embed)))
    # the four outputs in one allocation
    out = torch.empty(n * (dim + 1) + n_embed * (dim + 1), device=device,
                      dtype=torch.float32)
    quantize, embed_sum, counts, ids = out.split(
        [n * dim, dim * n_embed, n_embed, n])
    quantize = quantize.view(n, dim)
    embed_sum = embed_sum.view(dim, n_embed)
    ids = ids.view(torch.int32)
    args = _params(flat, embed, ids, quantize, counts, embed_sum, work)
    code = lib.isi_vq_lookup(ctypes.byref(args), ctypes.c_void_p(stream))
    raise_on_error(lib, code, "fused_vq_lookup")
    fused_vq_lookup.launches += 1
    return ids, quantize, counts, embed_sum


fused_vq_lookup.launches = 0


def vq_lookup_info(flat: torch.Tensor, embed: torch.Tensor) -> dict:
    """The launch shapes of one call on ``flat``'s CUDA device: both
    kernels' grids, shared memory and registers, the statistics kernel's
    co-resident blocks, sort passes and grid barriers."""
    from .build import load
    _check(flat, embed)
    lib = load("vq_lookup")
    out = (ctypes.c_int * 12)()
    with torch.cuda.device(flat.device):
        code = lib.isi_vq_lookup_info(ctypes.byref(_params(flat, embed)),
                                      out)
    raise_on_error(lib, code, "vq_lookup_info")
    keys = ("assign_grid", "assign_rows_a_block", "assign_codes_a_pass",
            "assign_shared_bytes", "assign_registers", "stats_grid",
            "stats_shared_bytes", "stats_registers", "stats_resident_blocks",
            "sort_passes", "grid_barriers", "threads")
    return dict(zip(keys, list(out)))
