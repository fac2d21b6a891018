from .deeplab import DeepLab, DeepLabConfig, head_layer_name
from .weights import (build_model, default_weights_path, init_params,
                      load_keras_h5_weights, load_params_npz, params_from_jax,
                      save_params_npz)

__all__ = [
    "DeepLab",
    "DeepLabConfig",
    "head_layer_name",
    "build_model",
    "default_weights_path",
    "init_params",
    "load_keras_h5_weights",
    "load_params_npz",
    "params_from_jax",
    "save_params_npz",
]
