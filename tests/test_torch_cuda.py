"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks its fixture for a CUDA device and skips
where there is none (as in the CPU test run). They hold the kernels at
small widths (d_model 32, 4 heads of 8, d_ff 64, 16 classes); the full
widths are held by ``chip_smoke.py``. Torch only, so they run on a machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from interactive_spectrogram_inpainting_tpu_torch.models.prior import (
    transformer as tt)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel import (
    decode_scan_plain, fused_decode_scan)
from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
    import fused_prefix_prime, prefix_prime_plain
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    gumbel_noise, precompute_decode_state, sample_model, scan_range)
from interactive_spectrogram_inpainting_tpu_torch.utils.weights import (
    init_like_flax)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tiny_prior(variant):
    base = tt.TransformerConfig(
        shape=(8, 4), n_class=16, d_model=32, embeddings_dim=8,
        positional_embeddings_dim=8, dropout=0.0, condition_shape=(4, 2),
        conditional_model_num_encoder_layers=2,
        conditional_model_num_decoder_layers=2, conditional_model_nhead=4,
        d_ff=64)
    if variant == "aligned":
        model = tt.UpsamplingVQTransformer(
            dataclasses.replace(base, use_aligned_decoder=True))
    else:
        model = tt.SelfAttentiveVQTransformer(base)
    return init_like_flax(model, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module", params=["aligned", "cross"])
def prior(request, device):
    model = tiny_prior(request.param).to(device)
    cfg = model.config
    rng = np.random.default_rng(1)
    codemap = rng.integers(0, cfg.n_class, cfg.shape)
    condition = rng.integers(0, cfg.n_class, cfg.condition_shape)
    mask = np.zeros(cfg.shape, bool)
    mask[:, 1:3] = True
    return model, codemap, condition, mask


def inputs(model, codemap, condition, mask, dtype):
    """The kernels' arguments as sample_model builds them."""
    import chip_smoke
    helper = model.config.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    state = precompute_decode_state(model, compute_dtype=dtype)
    return chip_smoke.scan_inputs(torch, model, state, codemap, condition,
                                  mask, int(nz.min()), int(nz.max()) + 1,
                                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_prime_kernel_matches_plain(prior, dtype):
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, dtype)
    kv_k = chip_smoke.run_prime(torch, fused_prefix_prime, inp, dtype)
    kv_p = chip_smoke.run_prime(torch, prefix_prime_plain, inp, dtype)
    torch.cuda.synchronize()
    p0 = inp["p0"]
    tol = 3e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kv_k[:, :, :p0].float(),
                               kv_p[:, :, :p0].float(), atol=tol, rtol=tol)
    assert (kv_k[:, :, p0:] == 0).all()


def test_decode_scan_kernel_matches_plain(prior):
    import chip_smoke
    model, codemap, condition, mask = prior
    inp = inputs(model, codemap, condition, mask, torch.float32)
    kv0 = chip_smoke.run_prime(torch, fused_prefix_prime, inp, torch.float32)
    n = inp["steps"] - inp["p0"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    noise = gumbel_noise((n, inp["n_class"]), kv0.device, gen)
    for gumbel in (noise, torch.zeros_like(noise)):
        tk, kvk = chip_smoke.run_scan(torch, fused_decode_scan, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        tp, kvp = chip_smoke.run_scan(torch, decode_scan_plain, inp, kv0,
                                      inp["mask"], gumbel, 0.8)
        torch.cuda.synchronize()
        assert torch.equal(tk, tp)
        torch.testing.assert_close(kvk, kvp, atol=3e-4, rtol=1e-3)
    assert fused_decode_scan.launches > 0


def test_sample_model_cuda_matches_cpu(prior):
    model, codemap, condition, mask = prior
    cfg = model.config
    helper = cfg.target_codemaps_helper()
    nz = np.nonzero(mask.reshape(-1)[helper.flatten_permutation])[0]
    p0, steps = scan_range(model, int(nz.min()), int(nz.max()) + 1)
    gumbel = torch.as_tensor(np.random.default_rng(3).gumbel(
        size=(steps - p0, cfg.n_class)).astype(np.float32))
    cond = None if cfg.self_conditional_model else condition
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = sample_model(m, None, 1, condition=cond,
                                initial_code=codemap, mask=mask,
                                gumbel=gumbel, device=dev).cpu()
    model.to("cuda")
    assert torch.equal(out["cuda"], out["cpu"])
    np.testing.assert_array_equal(out["cpu"].numpy()[0][~mask],
                                  codemap[~mask])
