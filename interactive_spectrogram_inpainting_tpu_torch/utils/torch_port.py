"""Load the reference's PyTorch VQ-VAE checkpoints into the port's ``VQVAE``.

The reference stores its VQ-VAE as a ``torch`` state dict (a ``.pt`` file;
reference ``vqvae.py:304-337``). Its tensors already have PyTorch's layouts,
so loading one is a renaming:

- ``enc_b`` / ``enc_t``: the strided convolutions at ``blocks.{2i}``, one
  trailing 3x3 at ``blocks.{2n}``, then the residual blocks, whose two
  convolutions sit at ``.conv.1`` / ``.conv.3`` (reference
  ``encoder_decoder.py:38-126``) -> ``downsample.{i}``, ``conv_out``,
  ``res_blocks.{r}.conv1`` / ``.conv2``;
- ``dec`` / ``dec_t``: one 3x3 at ``blocks.0``, the residual blocks, a
  ReLU (no weights), then the transposed convolutions at every other index
  (reference ``encoder_decoder.py:129-227``) -> ``conv_in``,
  ``res_blocks.{r}``, ``upsample.{i}``;
- ``upsample_top_to_bottom.{i}`` -> ``upsample_top_to_bottom.layers.{i}``;
- ``quantize_conv_t`` / ``_b`` and the EMA codebook buffers of
  ``quantize_t`` / ``_b`` (``embed [dim, n_embed]``, ``cluster_size``,
  ``embed_avg``) keep their names and layouts.

Both packages hold ``ConvTranspose2d(k=2s, stride=s, padding=s//2)``
weights as PyTorch does, so they enter unflipped (the JAX package flips them
into flax's correlating transposed convolution, and the port's
``utils/weights.py`` flips flax's back).

Usage::

    state_dict = torch.load("vqvae.pt", map_location="cpu")
    model = VQVAE(config)
    model.load_state_dict(port_vqvae_state_dict(state_dict, config))
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.vqvae.vqvae import VQVAEConfig, _log2_int


def _convs(ref: str, port: str) -> List[Tuple[str, str]]:
    return [(f"{ref}.weight", f"{port}.weight"),
            (f"{ref}.bias", f"{port}.bias")]


def _res_blocks(ref: str, port: str, first: int, n_res: int
                ) -> List[Tuple[str, str]]:
    names = []
    for r in range(n_res):
        names += _convs(f"{ref}.blocks.{first + r}.conv.1",
                        f"{port}.res_blocks.{r}.conv1")
        names += _convs(f"{ref}.blocks.{first + r}.conv.3",
                        f"{port}.res_blocks.{r}.conv2")
    return names


def _encoder(name: str, n_down: int, n_res: int) -> List[Tuple[str, str]]:
    names = []
    for i in range(n_down):
        names += _convs(f"{name}.blocks.{2 * i}", f"{name}.downsample.{i}")
    names += _convs(f"{name}.blocks.{2 * n_down}", f"{name}.conv_out")
    return names + _res_blocks(name, name, 2 * n_down + 1, n_res)


def _decoder(name: str, n_up: int, n_res: int) -> List[Tuple[str, str]]:
    names = _convs(f"{name}.blocks.0", f"{name}.conv_in")
    names += _res_blocks(name, name, 1, n_res)
    first = 1 + n_res + 1  # the ReLU after the residual blocks
    for i in range(n_up):
        names += _convs(f"{name}.blocks.{first + 2 * i}",
                        f"{name}.upsample.{i}")
    return names


def reference_names(config: VQVAEConfig) -> List[Tuple[str, str]]:
    """(reference key, port key) of every tensor of the reference's
    ``VQVAE.state_dict()`` for ``config``. Raises ``ValueError`` for the
    ResNet VQ-VAE (``models/vqvae/resnet.py``), which the reference's
    checkpoints do not hold."""
    if config.use_resnet:
        raise ValueError(
            "the ResNet VQ-VAE (use_resnet, models/vqvae/resnet.py) has no "
            "reference state dict layout to load")
    n_res = config.n_res_block
    n_b = _log2_int(config.resolution_factors["bottom"])
    n_t = _log2_int(config.resolution_factors["top"])
    names = (_encoder("enc_b", n_b, n_res) + _encoder("enc_t", n_t, n_res)
             + _convs("quantize_conv_t", "quantize_conv_t")
             + _decoder("dec_t", n_t, n_res)
             + _convs("quantize_conv_b", "quantize_conv_b")
             + _decoder("dec", n_b, n_res))
    for i in range(n_t):
        names += _convs(f"upsample_top_to_bottom.{i}",
                        f"upsample_top_to_bottom.layers.{i}")
    for level in ("quantize_t", "quantize_b"):
        for buf in ("embed", "cluster_size", "embed_avg"):
            names.append((f"{level}.{buf}", f"{level}.{buf}"))
    return names


def port_vqvae_state_dict(state_dict: Mapping[str, Any],
                          config: VQVAEConfig) -> Dict[str, torch.Tensor]:
    """The reference's ``VQVAE.state_dict()`` (``torch.Tensor``s or numpy
    arrays) -> the port's, float32, ready for
    ``VQVAE(config).load_state_dict(..., strict=True)``. A missing or an
    unused reference key raises ``KeyError`` naming it."""
    names = reference_names(config)
    known = {ref for ref, _ in names}
    unused = sorted(k for k in state_dict if k not in known)
    if unused:
        raise KeyError(f"reference keys the port's VQ-VAE does not use: "
                       f"{unused}")
    missing = [ref for ref, _ in names if ref not in state_dict]
    if missing:
        raise KeyError(f"reference keys missing from the state dict: "
                       f"{missing}")
    out = {}
    for ref, port in names:
        value = state_dict[ref]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
        else:
            value = torch.from_numpy(np.array(value))
        out[port] = value.to(torch.float32).contiguous()
    return out
