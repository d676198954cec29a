"""Device selection and float32 numerics for the PyTorch port.

Every entry point of the port takes a ``device`` argument and runs on the
GPU unless the caller asks for the CPU. Asking for CUDA where there is none
raises: the port never carries on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def set_float32_precision() -> None:
    """Full float32 for matmuls and cuDNN convolutions.

    ``torch.backends.cudnn.allow_tf32`` defaults to True, which would run
    the VQ-VAE's float32 convolutions in TF32 (about three decimal digits:
    enough to move a nearly tied code of the encoder). Both switches are set to False so the port computes what the
    JAX reference computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

