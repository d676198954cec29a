from .codemaps import (CodemapsHelper, SimpleCodemapsHelper,
                       ZigZagCodemapsHelper)
from .transformer import (VQNSynthTransformer, TransformerConfig,
                          SelfAttentiveVQTransformer,
                          UpsamplingVQTransformer)

__all__ = [
    "CodemapsHelper",
    "SimpleCodemapsHelper",
    "ZigZagCodemapsHelper",
    "VQNSynthTransformer",
    "TransformerConfig",
    "SelfAttentiveVQTransformer",
    "UpsamplingVQTransformer",
]
