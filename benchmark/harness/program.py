"""Building the program's objects from a configuration file, with the
parameters the harness draws from the seed.

The port's modules are built on the device, which runs their own
initialisation there, and then given the seeded tensors: no parameter is
drawn on the host. (Built on the meta device instead, the first module's
``normal_`` goes through a Python decomposition that imports
``torch._dynamo``, some 6-7 s of every run's set-up.)
"""

from __future__ import annotations

import torch

from harness.seeds import derive
from harness.weights import make_parameters
from reference import prior as ref_prior
from reference import vqvae as ref_vqvae

PACKAGE = "interactive_spectrogram_inpainting_tpu_torch"


def prior_parameters(cfg: dict, which: str, seed: int, device):
    spec = ref_prior.parameter_spec(ref_prior.Geometry(cfg[which]))
    return make_parameters(spec, derive(seed, "weights", which), device)


def vqvae_parameters(cfg: dict, seed: int, device):
    spec = ref_vqvae.parameter_spec(cfg["vqvae"])
    return make_parameters(spec, derive(seed, "weights", "vqvae"), device)


def _loaded(factory, state, device):
    with torch.device(device):
        module = factory()
    module.load_state_dict(state)
    return module


def build_prior(cfg: dict, which: str, seed: int, device, **overrides):
    from interactive_spectrogram_inpainting_tpu_torch.models.prior.transformer \
        import (SelfAttentiveVQTransformer, TransformerConfig,
                UpsamplingVQTransformer)
    config = TransformerConfig(**dict(cfg[which], **overrides))
    factory = (SelfAttentiveVQTransformer if config.self_conditional_model
               else UpsamplingVQTransformer)
    return _loaded(lambda: factory(config),
                   prior_parameters(cfg, which, seed, device), device)


def build_vqvae(cfg: dict, seed: int, device):
    from interactive_spectrogram_inpainting_tpu_torch.models.vqvae.vqvae \
        import VQVAE, VQVAEConfig
    config = VQVAEConfig(**cfg["vqvae"])
    return _loaded(lambda: VQVAE(config), vqvae_parameters(cfg, seed, device),
                   device)


def label_encoders(cfg: dict):
    from interactive_spectrogram_inpainting_tpu_torch.data.label_encoders \
        import LabelEncoder
    return {name: LabelEncoder(list(classes))
            for name, classes in cfg["labels"].items()}
