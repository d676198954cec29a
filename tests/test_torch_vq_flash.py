"""PyTorch port vs the JAX package: the plain versions that follow the VQ
lookup's and the flash decode attention's kernels.

``vq_lookup_plain`` (split-TF32 scores, |e|^2 as four interleaved partial
sums, the statistics summed by pieces of the rows sorted by code) and
``decode_attention_plain`` (the keys split eight ways, a running softmax a
part, the parts merged in order) against the JAX Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU, and
against the JAX dense references, at small sizes with inputs drawn from a
numpy seed.

Tolerances are the JAX package's and ``chip_smoke.py``'s: ids equal on the
rows whose two best scores differ by more than 1e-4 (a float32 sum taken in
another order may pick either code nearer than that), at most max(1,
N / 1000) rows nearer; quantize the codebook row bit for bit; counts exact;
embed_sum within atol 1e-3. Flash attention within atol 2e-5 / rtol 1e-4
in float32 and 3e-2 in bfloat16.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from interactive_spectrogram_inpainting_tpu.ops import (
    decode_attention as jda, vq_lookup as jvq)
from interactive_spectrogram_inpainting_tpu_torch.ops import (
    decode_attention as tda, vq_lookup as tvq)

MARGIN = 1e-4


def near_tie_rows(flat: np.ndarray, embed: np.ndarray) -> np.ndarray:
    """Rows whose two best scores (float64) lie closer than MARGIN."""
    scores = (embed.astype(np.float64) ** 2).sum(0)[None] - 2.0 * (
        flat.astype(np.float64) @ embed.astype(np.float64))
    best2 = np.sort(scores, axis=1)[:, :2]
    return (best2[:, 1] - best2[:, 0]) < MARGIN


def vq_case(kind):
    rng = np.random.default_rng({"odd": 0, "narrow": 1, "one_code": 2,
                                 "duplicated": 3}[kind])
    if kind == "odd":        # N no tile of either kernel divides
        n, dim, k = 300, 64, 512
        embed = rng.standard_normal((dim, k)).astype(np.float32)
    elif kind == "narrow":   # dim and K below one k-step and one code group
        n, dim, k = 130, 5, 7
        embed = rng.standard_normal((dim, k)).astype(np.float32)
    elif kind == "one_code":  # an untrained encoder: every row to code 7
        n, dim, k = 200, 64, 512
        embed = 50.0 * rng.standard_normal((dim, k)).astype(np.float32)
        embed[:, 7] = 0.0
    else:                     # codes k, k + 40, k + 80 equal
        n, dim, k = 150, 16, 120
        base = rng.standard_normal((dim, 40)).astype(np.float32)
        embed = np.concatenate([base, base, base], axis=1)
    flat = rng.standard_normal((n, dim)).astype(np.float32)
    return flat, embed


@pytest.mark.parametrize("kind", ["odd", "narrow", "one_code", "duplicated"])
def test_vq_lookup_plain_matches_jax_kernel_and_reference(kind):
    flat, embed = vq_case(kind)
    n, k = flat.shape[0], embed.shape[1]
    ids, quant, counts, esum = tvq.vq_lookup_plain(torch.as_tensor(flat),
                                                   torch.as_tensor(embed))
    assert ids.dtype == torch.int32
    near = near_tie_rows(flat, embed)
    if kind == "duplicated":
        near[:] = False  # equal codes tie exactly: the lowest wins
    assert int(near.sum()) <= max(1, n // 1000)
    assert torch.equal(quant, torch.as_tensor(embed).T[ids.long()])
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(ids.numpy(), minlength=k))
    for ref in (jvq.fused_vq_lookup(jnp.asarray(flat), jnp.asarray(embed),
                                    interpret=True),
                jvq.reference_vq_lookup(jnp.asarray(flat),
                                        jnp.asarray(embed))):
        j_ids, _, j_counts, j_esum = (np.asarray(r) for r in ref)
        np.testing.assert_array_equal(ids.numpy()[~near], j_ids[~near])
        if not near.any():
            np.testing.assert_array_equal(counts.numpy(), j_counts)
            np.testing.assert_allclose(esum.numpy(), j_esum, atol=1e-3)
    if kind == "one_code":
        assert bool((ids == 7).all())
        np.testing.assert_allclose(esum[:, 7].double().numpy(),
                                   flat.astype(np.float64).sum(0),
                                   atol=1e-3, rtol=1e-5)
    if kind == "duplicated":
        assert int(ids.max()) < 40


def test_tf32_round_is_round_to_nearest_ties_away():
    # 1 + 2^-11 lies halfway between two TF32 values: away from zero
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      3.0e38, 0.0])
    expected = [1.0, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 3.0e38, 0.0]
    out = tvq.tf32_round(x)
    assert out[:4].tolist() == expected[:4] and out[5].item() == 0.0
    bits = out.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    # hi + lo keeps about 21 bits: within 2^-21 of x
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(
        1000).astype(np.float32))
    hi = tvq.tf32_round(v)
    lo = tvq.tf32_round(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2.0 ** -20


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("pos", [5, 300, 639])
def test_decode_attention_plain_matches_jax_kernel(dtype, with_bias, pos):
    """pos in the first, a middle and the last 128-key chunk of a 640-row
    cache (the bottom prior's)."""
    rng = np.random.default_rng(pos)
    B, L, H, Dh = 2, 640, 4, 32
    q, k, v, bias = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Dh), (B, L, H, Dh), (B, L, H, Dh), (H, L)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j_out = np.asarray(jda.flash_decode_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), pos,
        jnp.asarray(bias) if with_bias else None,
        interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    tb = torch.as_tensor(bias) if with_bias else None
    out = tda.decode_attention_plain(tq, tk, tv, pos, tb)
    assert out.dtype == tdt
    atol, rtol = (2e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(out.float().numpy(), j_out, atol=atol,
                               rtol=rtol)
    if dtype == "float32":
        j_ref = np.asarray(jda.reference_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
            jnp.asarray(bias) if with_bias else None))
        np.testing.assert_allclose(out.numpy(), j_ref, atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("pos", [0, 6, 127, 128, 1000])
def test_decode_attention_plain_split_and_passes(pos):
    """Fewer keys than parts (empty parts), a part longer than one staged
    pass (1 001 keys: 125 a part, two passes), against the dense plain
    version in float32."""
    rng = np.random.default_rng(11)
    B, L, H, Dh = 1, 1024, 2, 8
    q, k, v, bias = (torch.as_tensor(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, H, Dh), (B, L, H, Dh), (B, L, H, Dh),
                               (H, L)))
    out = tda.decode_attention_plain(q, k, v, pos, bias)
    ref = tda.reference_decode_attention(q, k, v, pos, bias)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=1e-5)
