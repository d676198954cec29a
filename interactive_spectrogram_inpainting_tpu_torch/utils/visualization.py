"""Plotting helpers: codemap grids, mel-magnitude / IF figure batches,
prediction success maps and codebook usage, as the trainers draw them for
TensorBoard (reference ``train_vqvae.py:373-427``,
``train_autoregressive_model.py:290-346``).

The ``plot_*`` functions take numpy arrays (or anything ``np.asarray``
reads: pass tensors through ``.cpu()``) and return a matplotlib figure
drawn with the Agg backend: no display is needed. Without matplotlib,
``viridis_lut``, ``image_grid`` and ``encode_png`` draw plain colormapped
images with numpy and zlib alone (the server's spectrogram images and the
sampling CLI's PNGs).
"""

from __future__ import annotations

import importlib.util
import pathlib
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

_VIRIDIS_LUT: Optional[np.ndarray] = None


def viridis_lut() -> np.ndarray:
    """[256, 3] uint8 viridis colormap table (built once; a grayscale ramp
    where matplotlib is not installed)."""
    global _VIRIDIS_LUT
    if _VIRIDIS_LUT is None:
        try:
            from matplotlib import colormaps
            _VIRIDIS_LUT = (colormaps["viridis"](
                np.linspace(0.0, 1.0, 256))[:, :3] * 255 + 0.5
            ).astype(np.uint8)
        except ImportError:
            ramp = np.arange(256, dtype=np.uint8)
            _VIRIDIS_LUT = np.stack([ramp] * 3, axis=1)
    return _VIRIDIS_LUT


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (filter 0 scanlines, one IDAT, deflate
    level 1: latency over size on a local interface)."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + w * 3), np.uint8)  # filter byte 0 per scanline
    raw[:, 1:] = rgb.reshape(h, w * 3)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    idat = zlib.compress(raw.tobytes(), 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def colormapped(values: np.ndarray, vmin: Optional[float] = None,
                vmax: Optional[float] = None, scale: int = 1,
                lower: bool = False) -> np.ndarray:
    """[H, W] values -> [H scale, W scale, 3] uint8 through ``viridis_lut``
    (``vmin`` / ``vmax`` default to the values' own range; ``lower``: row
    0 at the bottom, as imshow's origin='lower')."""
    a = np.asarray(values, np.float64)
    lo = float(a.min()) if vmin is None else vmin
    hi = float(a.max()) if vmax is None else vmax
    idx = np.clip((a - lo) / max(hi - lo, 1e-12) * 255.0 + 0.5, 0, 255)
    rgb = viridis_lut()[idx.astype(np.uint8)]
    if lower:
        rgb = rgb[::-1]
    return np.repeat(np.repeat(rgb, scale, axis=0), scale, axis=1)


def image_grid(rows: Sequence[Sequence[np.ndarray]], gap: int = 4
               ) -> np.ndarray:
    """RGB panels laid out in rows on a white ground, ``gap`` pixels
    apart; each panel at the top left of its cell."""
    heights = [max(p.shape[0] for p in row) for row in rows]
    cols = max(len(row) for row in rows)
    widths = [max(row[c].shape[1] for row in rows if c < len(row))
              for c in range(cols)]
    out = np.full((sum(heights) + gap * (len(rows) + 1),
                   sum(widths) + gap * (cols + 1), 3), 255, np.uint8)
    y = gap
    for row, h in zip(rows, heights):
        x = gap
        for panel, w in zip(row, widths):
            out[y:y + panel.shape[0], x:x + panel.shape[1]] = panel
            x += w + gap
        y += h + gap
    return out


def have_matplotlib() -> bool:
    """Whether matplotlib is installed (the trainers draw their figures
    only then)."""
    return importlib.util.find_spec("matplotlib") is not None


def save_figure(fig, path) -> pathlib.Path:
    """Write ``fig`` to ``path`` (its directory made) and close it."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    _plt().close(fig)
    return path


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_codemap(codemap: np.ndarray, n_class: int, title: str = ""):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 3))
    im = ax.matshow(np.asarray(codemap), vmin=0, vmax=n_class - 1,
                    cmap="viridis")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax)
    return fig


def plot_mel_representations_batch(log_melspecs: np.ndarray,
                                   mel_IFs: np.ndarray,
                                   hop_length: int = 512,
                                   fs_hz: int = 16000):
    """Grid of (log-mel magnitude, IF) image pairs, one column a sound
    (GANsynth_pytorch.utils.plots, used at ``train_vqvae.py:419-423``)."""
    plt = _plt()
    n = len(log_melspecs)
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(np.asarray(log_melspecs[i]), origin="lower",
                          aspect="auto", cmap="magma")
        axes[1][i].imshow(np.asarray(mel_IFs[i]), origin="lower",
                          aspect="auto", cmap="twilight")
        axes[0][i].set_axis_off()
        axes[1][i].set_axis_off()
    axes[0][0].set_title("log-mel magnitude")
    axes[1][0].set_title("IF")
    fig.tight_layout()
    return fig


def plot_prediction_success_map(target: np.ndarray, predicted: np.ndarray,
                                mask: Optional[np.ndarray] = None):
    """Four shades: correct or not x masked or not (reference
    ``train_autoregressive_model.py:308-346``)."""
    plt = _plt()
    target, predicted = np.asarray(target), np.asarray(predicted)
    correct = (target == predicted).astype(int)
    shades = correct.copy()
    if mask is not None:
        shades = correct + 2 * np.asarray(mask).astype(int)
    fig, axes = plt.subplots(1, 3, figsize=(10, 3))
    axes[0].matshow(target, cmap="viridis")
    axes[0].set_title("target")
    axes[1].matshow(predicted, cmap="viridis")
    axes[1].set_title("predicted")
    im = axes[2].matshow(shades, cmap="RdYlGn", vmin=0, vmax=3)
    axes[2].set_title("success map")
    for ax in axes:
        ax.set_axis_off()
    fig.colorbar(im, ax=axes[2])
    return fig


def code_usage_histogram(codemaps: Sequence[np.ndarray], n_class: int
                         ) -> np.ndarray:
    """Codebook usage counts over a set of codemaps (Inference.ipynb's
    code-usage analysis)."""
    counts = np.zeros(n_class, dtype=np.int64)
    for cm in codemaps:
        counts += np.bincount(np.asarray(cm).reshape(-1),
                              minlength=n_class)
    return counts


def plot_code_usage(counts: np.ndarray, title: str = "codebook usage"):
    plt = _plt()
    counts = np.asarray(counts)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(len(counts)), np.sort(counts)[::-1], width=1.0)
    ax.set_yscale("symlog")
    ax.set_title(f"{title} (used: {(counts > 0).sum()}/{len(counts)})")
    ax.set_xlabel("codes (sorted by usage)")
    return fig
