"""PyTorch/CUDA port of ``interactive_spectrogram_inpainting_tpu``.

The port imports ``torch`` and never JAX; it keeps its own copies of the
JAX-free helpers it needs. Its hot path runs on an NVIDIA H100 through
hand-written CUDA kernels (``ops/csrc``), each with a plain PyTorch version
beside it that serves CPU tensors and the tests.
"""

__version__ = "0.1.0"
