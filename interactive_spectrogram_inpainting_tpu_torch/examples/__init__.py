"""The JAX package's example scripts as modules of the port, run with
``python -m interactive_spectrogram_inpainting_tpu_torch.examples.<name>``."""
