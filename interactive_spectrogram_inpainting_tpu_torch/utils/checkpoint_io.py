"""The JAX package's two-file checkpoints, read and written without flax.

A stored model is ``<prefix>-model_parameters.json`` (the constructor
arguments: ``VQVAEConfig`` / ``TransformerConfig``, same keys in both
packages) plus ``<prefix>-weights.msgpack``, flax's
``serialization.to_bytes`` of the variables tree: a msgpack map of maps
with string keys whose leaves are arrays in an extension type (code 1; the
payload is itself the msgpack of ``(shape, dtype name, raw bytes)``).

The GPU deployment has neither ``flax`` nor ``msgpack``, so this module
carries the small part of msgpack those files use: maps, arrays, strings,
binary, integers, floats, booleans, nil and extension types.
``save_model`` writes files the JAX package's ``from_parameters_and_weights``
reads, and the two ``*_from_parameters_and_weights`` here read the files
its ``save_model`` wrote.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.prior.transformer import TransformerConfig, VQNSynthTransformer
from ..models.vqvae.vqvae import VQVAE, VQVAEConfig
from .weights import from_flax_params, to_flax_params

PathLike = Union[str, pathlib.Path]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED_KEY = "__msgpack_chunked_array__"


# -- msgpack, the subset flax writes ------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw_strings: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_strings = raw_strings

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw_strings else raw.decode("utf-8")

    def sequence(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.number(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, buffer = _Reader(payload, True).value()
            dtype_name = dtype_name.decode()
            if dtype_name == "bfloat16":
                raise ValueError("bfloat16 checkpoint arrays are not "
                                 "supported: store float32 weights")
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)
                                ).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unsupported msgpack extension type {code}")

    def value(self):
        b = self.number(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.sequence(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.number(numbers[b])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.number(lengths[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.number(lengths[b - 0xC7]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.string(self.number(lengths[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.sequence(self.number(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.mapping(self.number(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def msgpack_unpack(data: bytes):
    """Decode one msgpack value (arrays in flax's extension type become
    numpy arrays)."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return value


def _pack_length(n: int, fix: Tuple[int, int], codes: Tuple[int, ...]
                 ) -> bytes:
    """Header of a sized type: the fix form up to ``fix[1]``, else the
    first of the 8/16/32-bit forms in ``codes`` that holds ``n``."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    forms = [(">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF)][-len(codes):]
    for code, (fmt, limit) in zip(codes, forms):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError("object too large for msgpack")


def _pack(value, out: list) -> None:
    if value is None:
        out.append(b"\xc0")
    elif isinstance(value, bool):
        out.append(b"\xc3" if value else b"\xc2")
    elif isinstance(value, int):
        if 0 <= value <= 0x7F:
            out.append(bytes([value]))
        elif -32 <= value < 0:
            out.append(struct.pack(">b", value))
        else:
            forms = ((b"\xcc", ">B"), (b"\xcd", ">H"), (b"\xce", ">I"),
                     (b"\xcf", ">Q")) if value > 0 else (
                (b"\xd0", ">b"), (b"\xd1", ">h"), (b"\xd2", ">i"),
                (b"\xd3", ">q"))
            for code, fmt in forms:  # the narrowest form that holds it
                try:
                    out.append(code + struct.pack(fmt, value))
                    break
                except struct.error:
                    continue
            else:
                raise ValueError(f"integer {value} exceeds 64 bits")
    elif isinstance(value, float):
        out.append(b"\xcb" + struct.pack(">d", value))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(_pack_length(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        out.append(_pack_length(len(value), None, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(value))
    elif isinstance(value, (list, tuple)):
        out.append(_pack_length(len(value), (0x90, 15), (0xDC, 0xDD)))
        for item in value:
            _pack(item, out)
    elif isinstance(value, dict):
        out.append(_pack_length(len(value), (0x80, 15), (0xDE, 0xDF)))
        for key, item in value.items():
            _pack(key, out)
            _pack(item, out)
    elif isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        if arr.nbytes >= 2 ** 30:
            raise ValueError("arrays of 1 GiB or more need flax's chunked "
                             "form, which is not written here")
        payload = msgpack_pack(
            (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(value, np.ndarray) \
            else _EXT_NPSCALAR
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(bytes([fixext[len(payload)]]))
        else:
            out.append(_pack_length(len(payload), None, (0xC7, 0xC8, 0xC9)))
        out.append(struct.pack(">b", code))
        out.append(payload)
    else:
        raise TypeError(f"cannot pack {type(value).__name__} into msgpack")


def msgpack_pack(value) -> bytes:
    """Encode nested dicts / sequences / scalars / numpy arrays as flax's
    ``serialization.msgpack_serialize`` does."""
    out: list = []
    _pack(value, out)
    return b"".join(out)


def _check_tree(tree) -> None:
    if isinstance(tree, dict):
        if _CHUNKED_KEY in tree:
            raise ValueError("chunked (>= 1 GiB) checkpoint arrays are not "
                             "supported")
        for value in tree.values():
            _check_tree(value)


def load_variables(weights_path: PathLike) -> Dict[str, Any]:
    """The variables tree of a weights blob, numpy leaves."""
    tree = msgpack_unpack(pathlib.Path(weights_path).read_bytes())
    if not isinstance(tree, dict):
        raise ValueError(f"{weights_path} does not hold a variables tree")
    _check_tree(tree)
    return tree


# -- the two-file contract ----------------------------------------------------

def save_model(directory: PathLike, model: nn.Module, prefix: str,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None
               ) -> None:
    """Write ``<prefix>-model_parameters.json`` and
    ``<prefix>-weights.msgpack`` for a port VQ-VAE (``prefix='vqvae'`` in the
    trainers) or prior; ``state_dict`` instead of the model's own (the
    whole of a prior sharded over a model group)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"{prefix}-model_parameters.json").write_text(
        model.config.to_json())
    (directory / f"{prefix}-weights.msgpack").write_bytes(
        msgpack_pack(to_flax_params(model, state_dict)))


def vqvae_from_parameters_and_weights(parameters_json_path: PathLike,
                                      model_weights_path: PathLike) -> VQVAE:
    config = VQVAEConfig.from_json(
        pathlib.Path(parameters_json_path).read_text())
    model = VQVAE(config)
    model.load_state_dict(from_flax_params(load_variables(model_weights_path)))
    return model.eval()


def prior_from_parameters_and_weights(parameters_json_path: PathLike,
                                      model_weights_path: PathLike
                                      ) -> VQNSynthTransformer:
    config = TransformerConfig.from_json(
        pathlib.Path(parameters_json_path).read_text())
    # training-time trades of the JAX package that inference never uses
    config = dataclasses.replace(config, remat=False, fused_attention=False)
    model = VQNSynthTransformer(config)
    model.load_state_dict(from_flax_params(load_variables(model_weights_path)))
    return model.eval()
