from .sample import precompute_decode_state, sample_model

__all__ = ["sample_model", "precompute_decode_state"]
