from .sample import (make_sampling_fn, make_sharded_sampling_fn,
                     precompute_decode_state, sample_hierarchical,
                     sample_model, top_k_top_p_filtering)

__all__ = ["sample_model", "precompute_decode_state", "make_sampling_fn",
           "make_sharded_sampling_fn", "sample_hierarchical",
           "top_k_top_p_filtering"]
