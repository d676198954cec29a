"""ctypes bindings to the port's C++ runtime (``data/csrc/isi_native.cpp``):
the mmap reader of the codemap store and a PCM WAV codec.

The library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``build/torch_native/`` beside the package (override with
``ISI_TORCH_NATIVE_DIR``), named by a hash of the source and the flags, as
``ops/build.py`` names the CUDA kernels' libraries. A failed build raises
with g++'s output: nothing falls back to another reader silently.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
from typing import Dict, Sequence, Tuple

import numpy as np

from ..ops import build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "isi_native.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIBS: Dict[pathlib.Path, ctypes.CDLL] = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def build_dir() -> pathlib.Path:
    env = os.environ.get("ISI_TORCH_NATIVE_DIR")
    if env:
        return pathlib.Path(env)
    return SOURCE.parents[3] / "build" / "torch_native"


def library_path() -> pathlib.Path:
    return build.hashed_library(build_dir(), "isi_native", [SOURCE], FLAGS)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.isi_store_open.restype = ctypes.c_int
    lib.isi_store_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)]
    lib.isi_store_num_records.restype = ctypes.c_int64
    lib.isi_store_num_records.argtypes = [ctypes.c_void_p]
    lib.isi_store_read_batch.restype = ctypes.c_int
    lib.isi_store_read_batch.argtypes = [
        ctypes.c_void_p, _I64P, ctypes.c_int64, _I32P, _I32P, _I32P]
    lib.isi_store_close.restype = None
    lib.isi_store_close.argtypes = [ctypes.c_void_p]
    lib.isi_wav_encode_pcm16.restype = ctypes.c_int64
    lib.isi_wav_encode_pcm16.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p]
    lib.isi_wav_decode.restype = ctypes.c_int64
    lib.isi_wav_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _F32P, _I32P, _I32P]
    return lib


def load_library() -> ctypes.CDLL:
    """The library's ctypes handle, built first if it is not there; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    target = library_path()
    if target not in _LIBS:
        if not target.exists():
            compiler = shutil.which("g++")
            if compiler is None:
                raise RuntimeError("g++ not found: the codemap store's C++ "
                                   "reader is built with it")
            ok, log = build.finish_compile(
                *build.start_compile([compiler, *FLAGS, str(SOURCE)],
                                     target), target)
            if not ok:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{log}")
        _LIBS[target] = _declare(ctypes.CDLL(str(target)))
    return _LIBS[target]


class NativeStoreReader:
    """The C++ mmap reader over a codemap store's ``codes.bin``."""

    def __init__(self, codes_bin_path, num_records: int,
                 top_shape: Tuple[int, int], bottom_shape: Tuple[int, int],
                 num_attrs: int):
        self._handle = None
        self._lib = load_library()
        self.top_shape = tuple(top_shape)
        self.bottom_shape = tuple(bottom_shape)
        self.num_attrs = int(num_attrs)
        self._top_elems = int(np.prod(top_shape))
        self._bottom_elems = int(np.prod(bottom_shape))
        handle = ctypes.c_void_p()
        rc = self._lib.isi_store_open(
            str(codes_bin_path).encode(), num_records, self._top_elems,
            self._bottom_elems, self.num_attrs, ctypes.byref(handle))
        if rc != 0:
            raise OSError(f"isi_store_open({codes_bin_path}) failed: rc {rc}")
        self._handle = handle

    def __len__(self) -> int:
        return int(self._lib.isi_store_num_records(self._handle))

    def read_batch(self, indices: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (tops [n, f, t] int32, bottoms [n, f, t] int32, attributes
        [n, num_attrs] int32). An index out of range raises
        ``IndexError``."""
        if self._handle is None:
            raise ValueError("read_batch on a closed NativeStoreReader")
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        n = len(idx)
        tops = np.empty((n, self._top_elems), np.int32)
        bottoms = np.empty((n, self._bottom_elems), np.int32)
        attrs = np.empty((n, max(self.num_attrs, 1)), np.int32)
        rc = self._lib.isi_store_read_batch(
            self._handle, idx.ctypes.data_as(_I64P), n,
            tops.ctypes.data_as(_I32P), bottoms.ctypes.data_as(_I32P),
            attrs.ctypes.data_as(_I32P))
        if rc != 0:
            raise IndexError(f"a record index is outside [0, {len(self)})")
        return (tops.reshape((n,) + self.top_shape),
                bottoms.reshape((n,) + self.bottom_shape),
                attrs[:, :self.num_attrs])

    def close(self) -> None:
        if self._handle is not None:
            self._lib.isi_store_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def wav_encode_pcm16(audio: np.ndarray, sample_rate: int) -> bytes:
    """Float audio in [-1, 1], ``[n]`` or ``[channels, n]`` -> the bytes of
    a PCM16 WAV file."""
    lib = load_library()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        channels, samples = 1, audio.shape[0]
        interleaved = audio
    else:
        channels, samples = audio.shape
        interleaved = np.ascontiguousarray(audio.T).reshape(-1)
    ptr = interleaved.ctypes.data_as(_F32P)
    size = lib.isi_wav_encode_pcm16(ptr, samples, channels, sample_rate,
                                    None)
    buf = ctypes.create_string_buffer(size)
    lib.isi_wav_encode_pcm16(ptr, samples, channels, sample_rate, buf)
    return buf.raw


def wav_decode(blob: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes (PCM16 / 24 / 32 or float32) -> (audio [channels, n]
    float32, sample rate). A malformed file raises ``ValueError``."""
    lib = load_library()
    channels = ctypes.c_int32()
    sample_rate = ctypes.c_int32()
    frames = lib.isi_wav_decode(blob, len(blob), None,
                                ctypes.byref(channels),
                                ctypes.byref(sample_rate))
    if frames < 0:
        raise ValueError(f"isi_wav_decode failed: rc {frames}")
    out = np.empty(frames * channels.value, np.float32)
    rc = lib.isi_wav_decode(blob, len(blob), out.ctypes.data_as(_F32P),
                            ctypes.byref(channels),
                            ctypes.byref(sample_rate))
    if rc < 0:
        raise ValueError(f"isi_wav_decode failed: rc {rc}")
    audio = out.reshape(frames, channels.value).T
    return np.ascontiguousarray(audio), int(sample_rate.value)
