from .deeplab import DeepLab, DeepLabConfig, head_layer_name
from .weights import (build_model, default_weights_path, init_params,
                      load_keras_h5_weights, load_params_npz, params_from_jax,
                      resolve_params, save_params_npz)
from .train import (MasterParams, build_train_step, forward_train, make_train_step,
                    segmentation_loss, update_bn_stats)

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
    "resolve_params",
    "save_params_npz",
    "MasterParams",
    "build_train_step",
    "forward_train",
    "make_train_step",
    "segmentation_loss",
    "update_bn_stats",
]
