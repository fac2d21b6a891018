from .optimizer import Adam, OptimizerConfig, learning_rate
from .solver import (SR_FUNCTIONS, SRConfig, augmented_superresolution,
                     forward_operator, max_mean_superresolution, max_superresolution,
                     mean_superresolution, multiclass_max_mean_superresolution,
                     precompute_gram_stencil)
from .postprocess import (LABEL_MAP_RULES, combine_label_map, normalize_coefficients,
                          threshold_image)
from .stencil_cache import load_stencil, save_stencil, stencil_cache_key

__all__ = [
    "Adam",
    "OptimizerConfig",
    "learning_rate",
    "SR_FUNCTIONS",
    "SRConfig",
    "augmented_superresolution",
    "forward_operator",
    "max_mean_superresolution",
    "max_superresolution",
    "mean_superresolution",
    "multiclass_max_mean_superresolution",
    "precompute_gram_stencil",
    "LABEL_MAP_RULES",
    "combine_label_map",
    "normalize_coefficients",
    "threshold_image",
    "load_stencil",
    "save_stencil",
    "stencil_cache_key",
]
