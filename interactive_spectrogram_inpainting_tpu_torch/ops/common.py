"""Helpers shared by the kernel wrappers and their plain versions."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

LN_EPS = 1e-6
NEG_INF = -1e9
# dtype code of the C interfaces in csrc/
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm(v: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm in float32, written out as the kernels compute it."""
    v = v.float()
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def round_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 value after a round trip through ``dtype``."""
    return v.to(dtype).float()


def check_tensors(tensors: Dict[str, Optional[torch.Tensor]],
                  dtypes: Dict[str, Sequence[torch.dtype]]) -> None:
    """Every given tensor lies on one device, is contiguous and has one of
    its allowed dtypes."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in dtypes and t.dtype not in dtypes[name]:
            raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                             f"{list(dtypes[name])}")


def check_cuda(tensors: Dict[str, Optional[torch.Tensor]],
               dtypes: Dict[str, Sequence[torch.dtype]]) -> None:
    """``check_tensors``, and the device is a CUDA one."""
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    check_tensors(tensors, dtypes)


def check_shape(t: torch.Tensor, name: str, shape: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def struct_type(name: str, pointers: Sequence[str], ints: Sequence[str],
                floats: Sequence[str]):
    """A ctypes.Structure matching a C struct of pointers, then ints, then
    floats (the layout of the params structs in csrc/)."""
    fields = ([(n, ctypes.c_void_p) for n in pointers]
              + [(n, ctypes.c_int) for n in ints]
              + [(n, ctypes.c_float) for n in floats])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def raise_on_error(lib, code: int, kernel: str) -> None:
    if code != 0:
        lib.isi_error_string.restype = ctypes.c_char_p
        msg = lib.isi_error_string(code).decode()
        raise RuntimeError(f"{kernel} failed to launch: CUDA error {code} "
                           f"({msg})")
