"""ResNet encoders and PixelShuffle decoders of the ``use_resnet`` variant.

Port of ``interactive_spectrogram_inpainting_tpu/models/vqvae/resnet.py``:
``XResNetEncoder`` (a conv stem whose first conv is strided, then one
residual stage per further factor-2 downsampling) and the skip-free
``NoSkipUnetDecoder`` (per factor 2: a 1x1 conv to four times the
channels, a pixel shuffle, two 3x3 convs), built by ``get_xresnet_unet``
from the resolution factors. Residual blocks are pre-activation and
normalise with GroupNorm (epsilon 1e-6, flax's default).

Tensors are NCHW, as everywhere in the port's VQ-VAE. ``pixel_shuffle``
keeps the JAX function's channel order: output channel ``c`` at offset
``(i, j)`` of a 2 x 2 cell comes from input channel ``(i r + j) C + c``
(PyTorch's ``nn.PixelShuffle`` takes ``c r^2 + i r + j`` instead).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUPS_NORM = 8
GN_EPS = 1e-6


class ResNetBlock(nn.Module):
    """GroupNorm-ReLU-conv3x3 twice, added to the input (through a 1x1 conv
    when the width or the resolution changes)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 expansion: int = 1):
        super().__init__()
        out_ch = channels * expansion
        self.norm1 = nn.GroupNorm(min(GROUPS_NORM, in_channels), in_channels,
                                  eps=GN_EPS)
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride=stride,
                               padding=1)
        self.norm2 = nn.GroupNorm(min(GROUPS_NORM, channels), channels,
                                  eps=GN_EPS)
        self.conv2 = nn.Conv2d(channels, out_ch, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_ch, 1, stride=stride)
                         if in_channels != out_ch or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class XResNetEncoder(nn.Module):
    """Conv stem + one residual stage per factor-2 downsampling."""

    def __init__(self, in_channels: int, out_channels: int,
                 resolution_factor: int, layers_per_block: int = 4,
                 expansion: int = 1,
                 stem_channels: Sequence[int] = (32, 32, 64)):
        super().__init__()
        num_stages = int(math.log2(resolution_factor))
        ins = (in_channels,) + tuple(stem_channels[:-1])
        self.stem = nn.ModuleList([
            nn.Conv2d(i, o, 3, stride=2 if n == 0 else 1, padding=1)
            for n, (i, o) in enumerate(zip(ins, stem_channels))])
        widths = [64, 128, 256, 512] + [256] * max(0, num_stages - 4)
        blocks = []
        ch = stem_channels[-1]
        for stage in range(max(0, num_stages - 1)):
            width = widths[stage]
            for layer in range(max(1, layers_per_block)):
                blocks.append(ResNetBlock(ch, width,
                                          stride=2 if layer == 0 else 1,
                                          expansion=expansion))
                ch = width * expansion
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ch, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.stem:
            h = F.relu(conv(h))
        for block in self.blocks:
            h = block(h)
        return F.relu(self.conv_out(h))


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, C r^2, H, W] -> [B, C, H r, W r] in the JAX package's channel
    order (see the module docstring)."""
    b, c, h, w = x.shape
    r = factor
    out_c = c // (r * r)
    x = x.reshape(b, r, r, out_c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, out_c, h * r, w * r)


class NoSkipUnetDecoder(nn.Module):
    """Per factor 2: 1x1 conv, pixel shuffle, two 3x3 convs (ReLU after
    each); then a 1x1 conv to ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 resolution_factor: int, hidden_channels: int = 128):
        super().__init__()
        convs = []
        ch_in, ch = in_channels, hidden_channels
        for _ in range(int(math.log2(resolution_factor))):
            convs += [nn.Conv2d(ch_in, ch * 4, 1),
                      nn.Conv2d(ch, ch, 3, padding=1),
                      nn.Conv2d(ch, ch, 3, padding=1)]
            ch_in = ch
            ch = max(ch // 2, 32)
        self.convs = nn.ModuleList(convs)
        self.conv_out = nn.Conv2d(ch_in, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for s in range(0, len(self.convs), 3):
            h = F.relu(pixel_shuffle(self.convs[s](h), 2))
            h = F.relu(self.convs[s + 1](h))
            h = F.relu(self.convs[s + 2](h))
        return self.conv_out(h)


def get_xresnet_unet(in_channels: int, resolution_factors: Mapping[str, int],
                     hidden_channels: int, embeddings_dimension: int,
                     layers_per_downsampling_block: int = 4,
                     expansion: int = 1
                     ) -> Tuple[Dict[str, nn.Module], Dict[str, nn.Module]]:
    """(encoders, decoders) keyed 'top' / 'bottom'. The bottom encoder takes
    the spectrogram, the top encoder the bottom one's output; the top
    decoder takes the top quantized map, the bottom decoder the upsampled
    top map concatenated with the bottom quantized map."""
    encoders = {
        "bottom": XResNetEncoder(
            in_channels, hidden_channels, int(resolution_factors["bottom"]),
            layers_per_downsampling_block, expansion),
        "top": XResNetEncoder(
            hidden_channels, hidden_channels, int(resolution_factors["top"]),
            layers_per_downsampling_block, expansion,
            stem_channels=(hidden_channels // 2,) * 3),
    }
    decoders = {
        "top": NoSkipUnetDecoder(
            embeddings_dimension, embeddings_dimension,
            int(resolution_factors["top"]), hidden_channels),
        "bottom": NoSkipUnetDecoder(
            2 * embeddings_dimension, in_channels,
            int(resolution_factors["bottom"]), hidden_channels),
    }
    return encoders, decoders
