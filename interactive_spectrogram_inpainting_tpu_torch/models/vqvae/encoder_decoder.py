"""Strided-conv encoder and transposed-conv decoder stacks of the VQ-VAE-2.

Port of
``interactive_spectrogram_inpainting_tpu/models/vqvae/encoder_decoder.py``
(``ResBlock``, ``Encoder``, ``Decoder``, ``UpsampleStack``): the same
channel schedules per ``resolution_factor`` in {2, 4, 8, 16}, overlapping
(kernel = 2 * stride) or local (kernel = stride) down- and upsampling
kernels, grouped convs and ReLU-Conv3x3-ReLU-Conv1x1 residual blocks.
Tensors are NCHW.

flax's ``Conv(kernel 2s, stride s, padding=1)`` pads both sides by 1, as
PyTorch's ``Conv2d(kernel 2s, stride s, padding=1)`` does.

flax's ``ConvTranspose(kernel 2s, stride s, padding='SAME')`` is PyTorch's
``ConvTranspose2d(kernel 2s, stride s, padding s // 2)`` with the kernel
flipped spatially (``utils/weights.py`` does the flip); the local variant
(kernel s) needs no padding.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ResBlock(nn.Module):
    """ReLU -> 3x3 conv -> ReLU -> 1x1 conv, added to the ReLU'd input
    (``relu(x) + f(relu(x))``, as the reference's in-place ReLU computes)."""

    def __init__(self, channel: int, res_channel: int, groups: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(channel, res_channel, 3, padding=1,
                               groups=groups)
        self.conv2 = nn.Conv2d(res_channel, channel, 1, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(x)
        return y + self.conv2(F.relu(self.conv1(y)))


def _down_channel_schedule(channel: int, resolution_factor: int
                           ) -> Sequence[int]:
    """Output channels of each strided downsampling conv of the encoder."""
    if resolution_factor == 16:
        return (channel // 4, channel // 2, 3 * channel // 4, channel)
    if resolution_factor == 8:
        return (channel // 2, channel // 2, channel)
    if resolution_factor == 4:
        return (channel // 2, channel)
    if resolution_factor == 2:
        return (channel // 2,)
    raise ValueError(f"Unexpected resolution factor {resolution_factor}")


def _conv_transpose(in_ch: int, out_ch: int, use_local_kernels: bool
                    ) -> nn.ConvTranspose2d:
    stride = 2
    kernel = stride if use_local_kernels else 2 * stride
    padding = 0 if use_local_kernels else stride // 2
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding)


class Encoder(nn.Module):
    """Downsample by ``resolution_factor`` with stride-2 convs, then a 3x3
    conv, the res blocks and a final ReLU."""

    def __init__(self, in_channel: int, channel: int, n_res_block: int,
                 res_channel: int, resolution_factor: int, groups: int = 1,
                 use_local_kernels: bool = False):
        super().__init__()
        stride = 2
        kernel = stride if use_local_kernels else 2 * stride
        padding = 0 if use_local_kernels else 1
        schedule = tuple(_down_channel_schedule(channel, resolution_factor))
        ins = (in_channel,) + schedule[:-1]
        self.downsample = nn.ModuleList([
            nn.Conv2d(i, o, kernel, stride=stride, padding=padding,
                      groups=groups)
            for i, o in zip(ins, schedule)])
        self.conv_out = nn.Conv2d(schedule[-1], channel, 3, padding=1,
                                  groups=groups)
        self.res_blocks = nn.ModuleList([
            ResBlock(channel, res_channel, groups)
            for _ in range(n_res_block)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.downsample:
            h = F.relu(layer(h))
        h = self.conv_out(h)
        for block in self.res_blocks:
            h = block(h)
        return F.relu(h)


class Decoder(nn.Module):
    """3x3 conv + res blocks, then the transposed-conv upsampling chain."""

    def __init__(self, in_channel: int, out_channel: int, channel: int,
                 n_res_block: int, res_channel: int, resolution_factor: int,
                 groups: int = 1, use_local_kernels: bool = False):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channel, channel, 3, padding=1)
        self.res_blocks = nn.ModuleList([
            ResBlock(channel, res_channel, groups)
            for _ in range(n_res_block)])
        up_schedule = tuple(reversed(
            (out_channel,) + tuple(_down_channel_schedule(
                channel, resolution_factor)[:-1])))
        ins = (channel,) + up_schedule[:-1]
        self.upsample = nn.ModuleList([
            _conv_transpose(i, o, use_local_kernels)
            for i, o in zip(ins, up_schedule)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.res_blocks:
            h = block(h)
        h = F.relu(h)
        for i, layer in enumerate(self.upsample):
            h = layer(h)
            if i != len(self.upsample) - 1:
                h = F.relu(h)
        return h


class UpsampleStack(nn.Module):
    """Plain ConvTranspose chain lifting the top quantized map to the
    bottom resolution."""

    def __init__(self, channel: int, num_doublings: int,
                 use_local_kernels: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            _conv_transpose(channel, channel, use_local_kernels)
            for _ in range(num_doublings)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
