from .optimizer import OPTIMIZERS, Adam, OptimizerConfig, learning_rate, make_optimizer
from .solver import (SOLVERS, SR_FUNCTIONS, SRConfig, augmented_superresolution,
                     dropout_weights, forward_operator, max_mean_superresolution,
                     max_superresolution, mean_superresolution, minibatch_permutation,
                     multiclass_max_mean_superresolution, precompute_gram_stencil,
                     solve_with_draws, sr_loss)
from .postprocess import (LABEL_MAP_RULES, combine_label_map, normalize_coefficients,
                          threshold_image)
from .stencil_cache import load_stencil, save_stencil, stencil_cache_key

__all__ = [
    "OPTIMIZERS",
    "Adam",
    "OptimizerConfig",
    "learning_rate",
    "make_optimizer",
    "SOLVERS",
    "SR_FUNCTIONS",
    "SRConfig",
    "augmented_superresolution",
    "dropout_weights",
    "forward_operator",
    "max_mean_superresolution",
    "max_superresolution",
    "mean_superresolution",
    "minibatch_permutation",
    "multiclass_max_mean_superresolution",
    "precompute_gram_stencil",
    "solve_with_draws",
    "sr_loss",
    "LABEL_MAP_RULES",
    "combine_label_map",
    "normalize_coefficients",
    "threshold_image",
    "load_stencil",
    "save_stencil",
    "stencil_cache_key",
]
