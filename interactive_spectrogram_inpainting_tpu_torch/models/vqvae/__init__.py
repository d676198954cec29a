from .vqvae import VQVAE, VQVAEConfig

__all__ = ["VQVAE", "VQVAEConfig"]
