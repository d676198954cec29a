"""Fused sampling at prior geometries beyond the full test models', and the
load-time decision that routes a geometry no fused kernel takes.

The port's fused ``sample_model`` and the JAX package's fused sampler get
the same seeded weights (carried over by ``from_flax_params``) and the same
JAX noise; the tokens must be equal (float32) at head_dim 128, at an odd
head_dim (9) and at 16 heads (the reference's prior has 16), at B 1 (the
whole-scan path), 2 (the step kernel's) and 8 (the batched kernel's). On
the CPU the wrappers run their plain versions; the card tests hold the
kernels to those at the same geometries (``tests/test_torch_cuda.py``)."""

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_prior import port_prior
from tests.test_torch_sampling import bounds, inpaint_case, jax_step_gumbel
from tests.test_transformer import tiny_config, top_config
from interactive_spectrogram_inpainting_tpu import sampling as jsampling
from interactive_spectrogram_inpainting_tpu.models.prior import (
    SelfAttentiveVQTransformer, UpsamplingVQTransformer)
from interactive_spectrogram_inpainting_tpu.models.prior.transformer import (
    VQNSynthTransformer as JT)
from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae import (
    VQVAE, VQVAEConfig)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_attention import (
    flash_refusal)
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_scan_kernel \
    import heads_side_by_side, scan_refusal
from interactive_spectrogram_inpainting_tpu_torch.ops.decode_step_kernel \
    import step_refusal
from interactive_spectrogram_inpainting_tpu_torch.ops.prefix_prime_kernel \
    import prime_refusal
from interactive_spectrogram_inpainting_tpu_torch.ops.vq_lookup import (
    vq_refusal)
from interactive_spectrogram_inpainting_tpu_torch.sampling.sample import (
    fused_refusal, sample_model, scan_range)
from interactive_spectrogram_inpainting_tpu_torch.serve import server

# d_model, heads (d_ff 64, one encoder and one decoder layer)
GEOMETRIES = {"head_dim_128": (256, 2), "head_dim_9": (36, 4),
              "16_heads": (128, 16)}


@functools.lru_cache(maxsize=None)
def wide_prior(variant, geometry):
    d_model, heads = GEOMETRIES[geometry]
    kw = dict(d_model=d_model, conditional_model_nhead=heads, d_ff=64,
              conditional_model_num_encoder_layers=1,
              conditional_model_num_decoder_layers=1)
    if variant == "aligned":
        jm = UpsamplingVQTransformer(tiny_config(use_aligned_decoder=True,
                                                 **kw))
    else:
        jm = SelfAttentiveVQTransformer(top_config(**kw))
    cfg = jm.config
    variables = jax.jit(functools.partial(jm.init, method=JT.full_init))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1,) + cfg.shape, jnp.int32),
        jnp.zeros((1,) + cfg.condition_shape, jnp.int32))
    return jm, variables, port_prior(jm, variables)


@pytest.mark.parametrize("variant,geometry,batch", [
    ("aligned", "head_dim_128", 1), ("aligned", "head_dim_128", 2),
    ("aligned", "head_dim_128", 8), ("aligned", "head_dim_9", 2),
    ("aligned", "16_heads", 1), ("aligned", "16_heads", 2),
    ("cross", "head_dim_128", 2)])
def test_fused_sample_model_wide_geometry_matches_jax(variant, geometry,
                                                      batch):
    """Primed and bounded by the mask, the JAX noise fed to the port."""
    jm, variables, tm = wide_prior(variant, geometry)
    cfg = jm.config
    initial, mask, condition = inpaint_case(cfg, batch, (1, 2), seed=41)
    key = jax.random.PRNGKey(6)
    j_out = np.asarray(jsampling.sample_model(
        jm, variables, key, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, use_fused_step=True))
    p0, steps = scan_range(tm, *bounds(tm, mask))
    assert p0 > 0
    gumbel = jax_step_gumbel(key, p0, steps, (batch, cfg.n_class))
    if batch == 1:
        gumbel = gumbel[:, 0]
    t_out = sample_model(
        tm, None, batch, condition=condition, initial_code=initial,
        mask=mask, temperature=0.9, gumbel=gumbel, device="cpu").numpy()
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out[:, ~mask], initial[:, ~mask])


@pytest.mark.parametrize("refusal,widened,refused,names", [
    (lambda d, h, f: scan_refusal(d, h, f),
     [(512, 16, 2048), (768, 24, 3072), (1024, 8, 4096), (256, 2, 64)],
     [(36, 4, 72), (1088, 8, 4096), (512, 8, 2044)],
     ("fused_decode_scan", "d_model")),
    (lambda d, h, f: prime_refusal(d, h, f),
     [(512, 16, 2048), (1024, 8, 4096), (2048, 16, 8192)],
     [(36, 4, 64), (1088, 8, 4096), (4096, 32, 8192)],
     ("fused_prefix_prime", "d_model")),
    (lambda d, h, f: step_refusal(d, h, f, torch.bfloat16, 640),
     [(512, 16, 2048), (1024, 8, 4096), (512, 8, 8192), (2048, 16, 8192)],
     [(36, 4, 64), (1088, 8, 4096), (96, 8, 64)],
     ("step kernels", "d_model")),
    (lambda d, h, f: step_refusal(d, h, f, torch.float32, 640, e_src=129),
     [(512, 16, 2048), (1024, 8, 4096), (512, 8, 8192)],
     [(1088, 8, 4096), (2048, 16, 8192)],
     ("step kernels", "float32")),
    (lambda d, h, f: flash_refusal(d // h, 640),
     [(512, 8, 0), (1024, 8, 0), (36, 2, 0)],
     [(1088, 8, 0), (36, 4, 0)],
     ("flash_decode_attention", "head_dim")),
    (lambda d, h, f: vq_refusal(d),
     [(64, 0, 0), (512, 0, 0), (1024, 0, 0)],
     [(2048, 0, 0), (0, 0, 0)],
     ("fused_vq_lookup", "dim")),
], ids=["scan", "prime", "step_bf16", "step_f32_cross", "flash", "vq"])
def test_kernel_predicates_name_what_they_refuse(refusal, widened, refused,
                                                  names):
    """Each kernel's predicate takes the widened shapes and, for the rest,
    gives a reason naming the kernel and the shape."""
    for shape in widened:
        assert refusal(*shape) is None, shape
    for shape in refused:
        reason = refusal(*shape)
        assert reason is not None, shape
        for name in names:
            assert name in reason, (name, reason)
        assert str(shape[0]) in reason or str(shape[0] // max(shape[1], 1)) \
            in reason, reason


@pytest.mark.parametrize("n_heads,head_dim,expected", [
    (4, 8, 1), (8, 64, 1), (15, 32, 1), (16, 32, 2), (16, 8, 2), (24, 32, 2),
    (16, 128, 1),
], ids=["4_heads", "8_heads", "15_heads", "16_heads_of_32", "16_heads_of_8",
        "24_heads", "16_heads_of_128"])
def test_scan_heads_side_by_side(n_heads, head_dim, expected):
    """The scan's clusters take one head each up to 15 heads; above, the
    ceil(H / 15) heads of a group side by side where the group is at most
    128 wide (the reference's 16 heads of 32, the wide test prior's 16 of
    8, 24 of 32), else one (the general kernel's heads in series: 16 of
    128)."""
    assert heads_side_by_side(n_heads, head_dim) == expected


def tiny_vqvae(embed_dim=8, pallas=True):
    return VQVAE(VQVAEConfig(num_hidden_channels=16, num_residual_channels=8,
                             embed_dim=embed_dim, num_embeddings=32,
                             resolution_factors={"bottom": 4, "top": 2},
                             use_pallas_lookup=pallas))


def test_server_routes_refused_geometry_at_load(caplog):
    """On the card a prior whose geometry a fused kernel does not take
    (head_dim 9) is served by the dense sampler, decided when the models
    load, with one log line naming the kernel and the shape; a widened
    geometry (16 heads) keeps the fused path."""
    odd = wide_prior("aligned", "head_dim_9")[2]
    wide = wide_prior("cross", "16_heads")[2]
    assert fused_refusal(odd) is not None
    assert fused_refusal(wide, torch.bfloat16) is None
    with caplog.at_level(logging.WARNING, logger="isi-server-torch"):
        refusals = server.kernel_refusals(tiny_vqvae(), wide, odd)
    assert list(refusals) == ["bottom"]
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1
    assert "bottom prior" in lines[0] and "head_dim 9" in lines[0] \
        and "d_model 36" in lines[0] and "fused_decode_scan" in lines[0]
    # the decision as a state on the card holds it (the models stay on the
    # CPU here): the refused prior goes to the dense sampler, the other
    # keeps the fused one
    state = server.ServerState(tiny_vqvae(), wide, odd, None, {},
                               device="cpu")
    assert state._fused_refusals == {}
    assert state._fused_ok("top") and state._fused_ok("bottom")
    state._fused_refusals = refusals
    assert state._fused_ok("top") and not state._fused_ok("bottom")


def test_server_refuses_too_wide_vqvae_at_load():
    """A VQ-VAE with the fused lookup and an embedding wider than the
    lookup kernel takes raises when a state on the card loads it."""
    prior = wide_prior("cross", "16_heads")[2]
    with pytest.raises(ValueError, match="dim 2048"):
        server.kernel_refusals(tiny_vqvae(2048), prior, prior)
    assert server.kernel_refusals(tiny_vqvae(2048, pallas=False), prior,
                                  prior) == {}
