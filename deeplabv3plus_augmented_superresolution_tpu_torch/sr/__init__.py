from .optimizer import Adam, OptimizerConfig, learning_rate
from .solver import (SRConfig, augmented_superresolution, forward_operator,
                     precompute_gram_stencil)
from .postprocess import threshold_image
from .stencil_cache import load_stencil, save_stencil, stencil_cache_key

__all__ = [
    "Adam",
    "OptimizerConfig",
    "learning_rate",
    "SRConfig",
    "augmented_superresolution",
    "forward_operator",
    "precompute_gram_stencil",
    "threshold_image",
    "load_stencil",
    "save_stencil",
    "stencil_cache_key",
]
