"""The plain reference computes what the program computes: the priors'
logits (evaluation and training with dropout), the VQ-VAE decode and the
mel inverse, at the tiny geometry on the CPU in float32, from the same
seeded parameters."""

import json

import numpy as np
import pytest
import torch

from bench_support import DATA
from harness import program
from harness.seeds import derive
from harness.weights import make_parameters
from reference import prior as ref_prior
from reference import vqvae as ref_vqvae

SEED = 2 ** 31 + 7
CFG = json.loads((DATA / "tiny-serve.json").read_text())
DEV = torch.device("cpu")


def inputs(g, rng, batch=3):
    cond = torch.as_tensor(rng.integers(0, g.n_class, (batch, g.f_s, g.t_s)))
    target = torch.as_tensor(rng.integers(0, g.n_class,
                                          (batch, g.f_t, g.t_t)))
    labels = {name: torch.as_tensor(rng.integers(0, num, batch))
              for name, num in g.modalities.items()}
    mask = torch.as_tensor(rng.random((batch, g.f_s, g.t_s)) < 0.5)
    return cond, target, labels, mask


def program_logits(model, g, cond, target, labels, mask, generator=None):
    src, tgt = model.to_sequences(
        target, cond, class_conditioning=labels,
        mask=mask if g.self_conditional else None)
    logits, _ = model(tgt, src, deterministic=generator is None,
                      generator=generator)
    return logits


@pytest.mark.parametrize("which", ["top_prior", "bottom_prior"])
def test_prior_logits(which):
    g = ref_prior.Geometry(CFG[which])
    model = program.build_prior(CFG, which, SEED, DEV).eval()
    params = program.prior_parameters(CFG, which, SEED, DEV)
    cond, target, labels, mask = inputs(g, np.random.default_rng(1))
    with torch.no_grad():
        want = program_logits(model, g, cond, target, labels, mask)
        got = ref_prior.forward(params, g, cond, target, labels,
                                source_mask=mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_forward_with_dropout():
    which = "bottom_prior"
    cfg = dict(CFG, bottom_prior=dict(CFG[which], dropout=0.1))
    g = ref_prior.Geometry(cfg[which])
    model = program.build_prior(cfg, which, SEED, DEV).train()
    params = program.prior_parameters(cfg, which, SEED, DEV)
    cond, target, labels, mask = inputs(g, np.random.default_rng(2))
    want = program_logits(model, g, cond, target, labels, mask,
                          torch.Generator().manual_seed(5))
    gens = ref_prior.dropout_generators(torch.Generator().manual_seed(5), g,
                                        DEV)
    got = ref_prior.forward(params, g, cond, target, labels, gens=gens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    plain = ref_prior.forward(params, g, cond, target, labels)
    assert (plain - want).abs().max() > 1e-2  # the masks matter


def test_vqvae_decode_and_audio():
    from interactive_spectrogram_inpainting_tpu_torch.signal.spectrogram \
        import get_spectrograms_helper
    model = program.build_vqvae(CFG, SEED, DEV).eval()
    params = make_parameters(ref_vqvae.parameter_spec(CFG["vqvae"]),
                             derive(SEED, "weights", "vqvae"), DEV)
    rng = np.random.default_rng(3)
    n = CFG["vqvae"]["num_embeddings"]
    top = torch.as_tensor(rng.integers(0, n, (2, *CFG["top_prior"]["shape"])))
    bottom = torch.as_tensor(rng.integers(
        0, n, (2, *CFG["bottom_prior"]["shape"])))
    helper = get_spectrograms_helper(**CFG["spectrogram"])
    with torch.no_grad():
        spec = model.decode_code(top, bottom)
        want = helper.to_audio(spec)
        got_spec = ref_vqvae.decode(params, CFG["vqvae"], top, bottom)
        got = ref_vqvae.to_audio(got_spec, CFG["spectrogram"])
    torch.testing.assert_close(got_spec, spec, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_float8_control_moves_the_logits():
    g = ref_prior.Geometry(CFG["bottom_prior"])
    params = program.prior_parameters(CFG, "bottom_prior", SEED, DEV)
    cond, target, labels, _ = inputs(g, np.random.default_rng(4))
    exact = ref_prior.forward(params, g, cond, target, labels)
    low = ref_prior.forward(params, g, cond, target, labels,
                            prec=ref_prior.FLOAT8)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.5
