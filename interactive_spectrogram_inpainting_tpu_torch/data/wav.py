"""Pure-numpy WAV read/write.

Replaces the reference's libsndfile/sox dependencies (``soundfile.write`` in
``extract_code.py:294-300``/``sample.py:622``, torchaudio sox_io backend in
``flask_server.py:43``) with dependency-free host-side I/O. Audio I/O is
host-side by design: decode on CPU, feed device batches.

Supports PCM 16/24/32-bit and IEEE float32 WAVs, mono or multichannel.
"""

from __future__ import annotations

import io
import struct
from typing import Tuple, Union

import numpy as np


def read_wav(path_or_bytes: Union[str, bytes, io.BufferedIOBase]
             ) -> Tuple[np.ndarray, int]:
    """Returns (audio [channels, samples] float32 in [-1, 1], sample_rate)."""
    if isinstance(path_or_bytes, bytes):
        f = io.BytesIO(path_or_bytes)
    elif isinstance(path_or_bytes, io.IOBase):
        f = path_or_bytes
    else:
        f = open(path_or_bytes, "rb")
    try:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
            elif chunk_id == b"data":
                data = f.read(chunk_size)
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
            if fmt is not None and data is not None:
                break
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        (audio_format, n_channels, sample_rate, _byte_rate,
         _block_align, bits) = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        if audio_format == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
                x = ((raw[:, 0].astype(np.int32))
                     | (raw[:, 1].astype(np.int32) << 8)
                     | (raw[:, 2].astype(np.int32) << 16))
                x = np.where(x >= 1 << 23, x - (1 << 24), x)
                x = x.astype(np.float32) / float(1 << 23)
            elif bits == 8:
                x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                     - 128.0) / 128.0
            else:
                raise ValueError(f"unsupported PCM bit depth {bits}")
        elif audio_format == 3:  # IEEE float
            if bits == 32:
                x = np.frombuffer(data, dtype="<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, dtype="<f8").astype(np.float32)
            else:
                raise ValueError(f"unsupported float bit depth {bits}")
        else:
            raise ValueError(f"unsupported WAV format code {audio_format}")
        x = x.reshape(-1, n_channels).T  # [channels, samples]
        return np.ascontiguousarray(x), sample_rate
    finally:
        if not isinstance(path_or_bytes, io.IOBase):
            f.close()


def write_wav(path_or_buf, audio: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16") -> None:
    """Write [samples] or [channels, samples] float32 audio."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    n_channels, n_samples = audio.shape
    interleaved = audio.T.reshape(-1)
    if subtype == "PCM_16":
        # NaN-safe: untrained/degenerate models can emit NaN audio and a
        # bare int16 cast of NaN writes garbage silently (with only a
        # RuntimeWarning); map non-finite values to 0 before quantizing
        safe = np.nan_to_num(interleaved, nan=0.0, posinf=1.0, neginf=-1.0)
        payload = np.round(np.clip(safe, -1.0, 1.0)
                           * 32767.0).astype("<i2").tobytes()
        bits, fmt_code = 16, 1
    elif subtype == "FLOAT":
        payload = interleaved.astype("<f4").tobytes()
        bits, fmt_code = 32, 3
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    byte_rate = sample_rate * n_channels * bits // 8
    block_align = n_channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_code, n_channels,
                                    sample_rate, byte_rate, block_align, bits)
    header += b"data" + struct.pack("<I", len(payload))
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(header + payload)
    else:
        with open(path_or_buf, "wb") as f:
            f.write(header + payload)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Band-limited polyphase resampling (windowed-sinc), last-axis."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    # windowed-sinc lowpass at min(orig, target) Nyquist
    max_rate = max(up, down)
    half_width = 32
    taps = 2 * half_width * max_rate + 1
    cutoff = 0.5 / max_rate
    t = np.arange(taps, dtype=np.float64) - (taps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.kaiser(taps, beta=8.0)
    h *= up / h.sum() / 1.0
    # upsample (zero-stuff), filter, downsample
    orig_shape = audio.shape
    x = audio.reshape(-1, orig_shape[-1]).astype(np.float64)
    n_out = int(np.ceil(orig_shape[-1] * up / down))
    out = np.empty((x.shape[0], n_out), dtype=np.float32)
    for row in range(x.shape[0]):
        up_x = np.zeros(orig_shape[-1] * up)
        up_x[::up] = x[row]
        y = np.convolve(up_x, h, mode="same")
        out[row] = y[::down][:n_out].astype(np.float32)
    return out.reshape(orig_shape[:-1] + (n_out,))
