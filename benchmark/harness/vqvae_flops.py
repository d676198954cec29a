"""Operations and bytes of a VQ-VAE training step, from shapes.

Two multiply-adds count as two operations. A real FFT of ``n`` points
counts ``2.5 n log2 n`` operations. The step at the flagship flags, on a
batch of ``B`` spectrograms ``[2, F, T]``:

- the convolutions of the encoders, the quantizers' 1x1 maps, the top
  decoder, the lift of the top map and the decoder: forward, the weights'
  gradient and the input's gradient (all but the first layer's, whose
  input is the data);
- the VQ lookup of each map: the scores' product ``2 N dim K``;
- the mel matrix products ``2 B T F F``: two for the input's spectrogram,
  two for each inversion to audio (the criterion's prediction and target,
  the trio's two criteria, each on both), two more for the prediction's
  gradient;
- the FFTs of the input's STFT and of each inversion (the prediction's
  gradient one more);
- the spectral losses: the criterion's Jukebox scales forward and backward,
  the trio's DDSP and Jukebox scales forward, as ``spectral_bound`` counts
  them.

``spectral_bound`` and ``vq_bound`` are frozen copies of
``chip_smoke.py::spectral_bound`` and ``chip_smoke.py::vq_bound``, written
from shapes instead of a call's tensors: each input read once, each output
written once. ``vq_bound`` counts the one product ``2 N dim K`` once: the
kernel runs it as three TF32 passes, which the float32 peak of
``peaks.py`` (a third of the TF32 rate) already reckons with.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .peaks import least_seconds

# (n_fft, hop, window) of each preset's scales (``train/losses.py``'s
# ``make_jukebox_loss`` and ``make_ddsp_loss``, as published)
JUKEBOX = ((2048, 240, 1200), (1024, 120, 600), (512, 48, 240))
DDSP = tuple((n, n // 4, n) for n in (64, 128, 256, 512, 1024, 2048))


def _down_channels(channel: int, factor: int) -> Tuple[int, ...]:
    return {16: (channel // 4, channel // 2, 3 * channel // 4, channel),
            8: (channel // 2, channel // 2, channel),
            4: (channel // 2, channel),
            2: (channel // 2,)}[factor]


def conv_layers(cfg: dict, shape) -> List[Tuple[int, int, int, int]]:
    """(in channels, out channels, kernel cells, output-side cells) of each
    convolution, in the order of the forward; a transposed convolution's
    products run over its input's cells."""
    ch = int(cfg["num_hidden_channels"])
    res = int(cfg["num_residual_channels"])
    n_res = int(cfg["n_res_block"])
    dim = int(cfg["embed_dim"])
    f_b = int(cfg["resolution_factors"]["bottom"])
    f_t = int(cfg["resolution_factors"]["top"])
    h, w = shape
    layers = []

    def res_blocks(cells):
        for _ in range(n_res):
            layers.append((ch, res, 9, cells))
            layers.append((res, ch, 1, cells))

    def encoder(i, factor):
        nonlocal h, w
        for o in _down_channels(ch, factor):
            h, w = h // 2, w // 2
            layers.append((i, o, 16, h * w))
            i = o
        layers.append((i, ch, 9, h * w))
        res_blocks(h * w)

    def decoder(i, o, factor):
        nonlocal h, w
        layers.append((i, ch, 9, h * w))
        res_blocks(h * w)
        up = tuple(reversed((o,) + _down_channels(ch, factor)[:-1]))
        a = ch
        for b in up:
            layers.append((a, b, 16, h * w))
            h, w = 2 * h, 2 * w
            a = b

    encoder(int(cfg["in_channel"]), f_b)
    bottom = (h, w)
    encoder(ch, f_t)
    layers.append((ch, dim, 1, h * w))               # quantize_conv_t
    top = (h, w)
    decoder(dim, dim, f_t)                           # dec_t
    layers.append((dim + ch, dim, 1, h * w))         # quantize_conv_b
    h, w = top
    for _ in range(f_t.bit_length() - 1):            # the top map lifted
        layers.append((dim, dim, 16, h * w))
        h, w = 2 * h, 2 * w
    assert (h, w) == bottom
    decoder(2 * dim, int(cfg["in_channel"]), f_b)    # dec
    return layers


def conv_ops(cfg: dict, batch: int, shape) -> int:
    """Forward and backward operations of a step's convolutions."""
    layers = conv_layers(cfg, shape)
    forward = [2 * batch * i * o * k * cells for i, o, k, cells in layers]
    # the weights' gradient of every layer, the input's of all but the first
    return 2 * sum(forward) + sum(forward[1:])


def code_rows(cfg: dict, batch: int, shape) -> Tuple[int, int]:
    """Rows of the (top, bottom) VQ lookups."""
    f_b = int(cfg["resolution_factors"]["bottom"])
    f_t = int(cfg["resolution_factors"]["top"])
    h, w = shape
    return (batch * (h // (f_b * f_t)) * (w // (f_b * f_t)),
            batch * (h // f_b) * (w // f_b))


def vq_bound(n: int, dim: int, k: int) -> Tuple[int, int]:
    """(bytes, ops) of one VQ lookup of ``n`` rows over ``k`` codes."""
    return 4 * (2 * n * dim + 2 * dim * k + n + k), 2 * n * dim * k


def fft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def spectral_bound(batch: int, length: int, n_fft: int, hop: int,
                   backward: bool) -> Tuple[Tuple[float, float], ...]:
    """((bytes, ops) of the forward, and of the backward when ``backward``)
    of one scale on float32 audio ``[batch, length]``: the forward reads
    pred and target, writes the loss and, with a backward, U (bfloat16);
    the backward reads U and writes the gradient."""
    frames = 1 + (length - n_fft) // hop
    audio = 4 * batch * length
    u = batch * frames * 2 * (n_fft // 2 + 1) * 2 if backward else 0
    fft = batch * frames * fft_ops(n_fft)
    out = ((2 * audio + u + 4 * (batch + 1), 2 * fft),)
    if backward:
        out += ((u + audio + 4, fft),)
    return out


def spectral_calls(batch: int, length: int, trio: bool = True):
    """(bytes, ops) of each spectral-loss kernel call of a step: the
    criterion's Jukebox scales forward and backward, then, with ``trio``
    (a logged step), the trio's DDSP and Jukebox scales forward."""
    calls = []
    for n_fft, hop, _ in JUKEBOX:
        calls += spectral_bound(batch, length, n_fft, hop, True)
    for n_fft, hop, _ in (DDSP + JUKEBOX) if trio else ():
        calls += spectral_bound(batch, length, n_fft, hop, False)
    return calls


def spectral_bound_s(batch: int, length: int, trio: bool = True) -> float:
    """The least time of a step's spectral-loss calls."""
    return sum(least_seconds(b, o, "float32")
               for b, o in spectral_calls(batch, length, trio))


def vq_bound_s(cfg: dict, batch: int, shape) -> float:
    """The least time of a step's two VQ lookups."""
    dim, k = int(cfg["embed_dim"]), int(cfg["num_embeddings"])
    return sum(least_seconds(*vq_bound(n, dim, k), "float32")
               for n in code_rows(cfg, batch, shape))


def step_ops(cfg: dict, spec: dict, batch: int, shape,
             trio: bool = True) -> float:
    """The model operations of a training step (with ``trio``, a logged
    one)."""
    f, t = shape
    n_fft = int(spec["n_fft"])
    length = t * int(spec["hop_length"])
    dim, k = int(cfg["embed_dim"]), int(cfg["num_embeddings"])
    ops = conv_ops(cfg, batch, shape)
    ops += sum(2 * n * dim * k for n in code_rows(cfg, batch, shape))
    # two products an analysis or an inversion, and one transform of every
    # frame: the input's analysis; the criterion's prediction, its gradient
    # and target; the trio's four inversions
    transforms = 1 + 3 + (4 if trio else 0)
    ops += transforms * 2 * 2 * batch * t * f * f
    ops += transforms * batch * t * fft_ops(n_fft)
    ops += sum(o for _, o in spectral_calls(batch, length, trio))
    return ops
