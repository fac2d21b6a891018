"""Parameters for the DeepLabV3+ port: random init, conversion, checkpoints.

Port of the JAX package's ``models/weights.py`` plus its ``init_params``.
Parameters travel as the reference's flat dict, Keras layer name -> weight
name -> numpy array in the reference's layout (HWIO kernels, (k, k, 1, C)
depthwise kernels). ``params_from_jax`` converts such a dict into the
port's tensors, ``DeepLab.load_params`` loads them; ``to_reference_layout``
converts one port tensor back (checkpoints are written in the reference's
layout).
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

from .deeplab import DeepLab, DeepLabConfig, head_layer_name

NumpyParams = Dict[str, Dict[str, np.ndarray]]
TorchParams = Dict[str, Dict[str, torch.Tensor]]

WEIGHTS_FILENAMES = {
    "xception": "deeplabv3_xception_tf_dim_ordering_tf_kernels.h5",
    "mobilenet": "deeplabv3_mobilenetv2_tf_dim_ordering_tf_kernels.h5",
}


def default_weights_path(backbone: str, data_dir: Optional[str] = None) -> str:
    data_dir = data_dir or os.path.join(os.getcwd(), "data")
    return os.path.join(data_dir, "model_weights", WEIGHTS_FILENAMES[backbone])


def _glorot(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in = np.prod(shape[:-1])
    fan_out = shape[-1] * np.prod(shape[:-2]) if len(shape) > 1 else shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def init_params(cfg: DeepLabConfig, seed: int = 0) -> NumpyParams:
    """Keras-default random init (glorot_uniform kernels, BN gamma=1/beta=0,
    zero biases) drawn from numpy in the reference's parameter order, so a
    seed gives the reference's exact arrays."""
    rng = np.random.default_rng(seed)
    params: NumpyParams = {}
    for layer, name, shape, init in DeepLab(cfg, device="meta").specs():
        entry = params.setdefault(layer, {})
        if init == "glorot":
            entry[name] = _glorot(rng, tuple(shape))
        elif init == "zeros":
            entry[name] = np.zeros(shape, np.float32)
        else:
            entry[name] = np.ones(shape, np.float32)
    return params


KERNEL_NAMES = ("kernel", "depthwise_kernel")


def from_reference_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """One weight in the reference's layout -> the port's: HWIO kernels
    become OIHW, depthwise (k, k, 1, C) kernels (C, 1, k, k)."""
    return arr.transpose(3, 2, 0, 1) if name in KERNEL_NAMES else arr


def to_reference_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of ``from_reference_layout``."""
    return arr.transpose(2, 3, 1, 0) if name in KERNEL_NAMES else arr


def params_from_jax(params) -> TorchParams:
    """Reference-layout dict (numpy or anything np.asarray takes) -> float32
    CPU tensors in the port's layout (``from_reference_layout``)."""
    out: TorchParams = {}
    for layer, weights in params.items():
        out[layer] = {name: torch.tensor(np.ascontiguousarray(
            from_reference_layout(name, np.asarray(value, np.float32))))
            for name, value in weights.items()}
    return out


def _iter_h5_layers(f):
    """Yield (layer_name, {weight_name: np.ndarray}) for Keras h5 weight files,
    handling both weights-only files and full-model saves."""
    root = f["model_weights"] if "model_weights" in f else f
    layer_names = [n.decode() if isinstance(n, bytes) else n
                   for n in root.attrs.get("layer_names", list(root.keys()))]
    for lname in layer_names:
        if lname not in root:
            continue
        group = root[lname]
        weight_names = [n.decode() if isinstance(n, bytes) else n
                        for n in group.attrs.get("weight_names", [])]
        weights = {}
        for wname in weight_names:
            suffix = wname.split("/")[-1].split(":")[0]
            weights[suffix] = np.asarray(group[wname])
        if weights:
            yield lname, weights


_WEIGHT_NAMES = ("kernel", "bias", "depthwise_kernel", "gamma", "beta",
                 "moving_mean", "moving_variance")


def load_keras_h5_weights(params: NumpyParams, weights_path: str,
                          strict: bool = False) -> NumpyParams:
    """Load a Keras .h5 by layer name with skip_mismatch semantics: layers
    absent from ``params`` are ignored; shape mismatches keep the existing
    value unless strict. Keras depthwise kernels (k, k, C, 1) are transposed
    to the reference's (k, k, 1, C)."""
    import h5py

    new_params = {k: dict(v) for k, v in params.items()}
    loaded = 0
    with h5py.File(weights_path, "r") as f:
        for lname, weights in _iter_h5_layers(f):
            if lname not in new_params:
                continue
            for key, arr in weights.items():
                if key not in _WEIGHT_NAMES or key not in new_params[lname]:
                    continue
                if key == "depthwise_kernel":
                    arr = np.transpose(arr, (0, 1, 3, 2))
                want = new_params[lname][key].shape
                if tuple(arr.shape) != tuple(want):
                    if strict:
                        raise ValueError(f"Shape mismatch for {lname}/{key}: "
                                         f"file {arr.shape} vs model {want}")
                    continue
                new_params[lname][key] = np.asarray(arr, np.float32)
                loaded += 1
    if loaded == 0:
        raise ValueError(f"No weights matched between {weights_path} and the model")
    return new_params


def save_params_npz(params: NumpyParams, path: str) -> None:
    """Flat .npz export (layer.weight -> array), the reference's format."""
    flat = {f"{l}.{w}": np.asarray(v) for l, ws in params.items() for w, v in ws.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str) -> NumpyParams:
    params: NumpyParams = {}
    with np.load(path) as flat:
        for key in flat.files:
            if key.startswith("__"):
                continue  # train-state extras, not params
            layer, weight = key.rsplit(".", 1)
            params.setdefault(layer, {})[weight] = flat[key]
    return params


def resolve_params(cfg: DeepLabConfig, seed: int = 0,
                   params: Optional[NumpyParams] = None,
                   weights_path: Optional[str] = None) -> NumpyParams:
    """The parameters the reference's ``build_model`` returns: random init
    (seed) or the given dict, replaced by an .npz (own format; the head's
    name follows the config) or filled from a Keras .h5 when cfg.weights is
    "pascal_voc"."""
    if params is None:
        params = init_params(cfg, seed=seed)
    if weights_path is not None and weights_path.endswith(".npz"):
        loaded = load_params_npz(weights_path)
        want = head_layer_name(cfg)
        for other in ("logits_semantic", "custom_logits_semantic"):
            if other != want and other in loaded and want not in loaded:
                loaded[want] = loaded.pop(other)
        return loaded
    if cfg.weights == "pascal_voc" and weights_path is not None:
        return load_keras_h5_weights(params, weights_path)
    return params


def build_model(cfg: DeepLabConfig, seed: int = 0,
                params: Optional[NumpyParams] = None,
                weights_path: Optional[str] = None, *, device) -> DeepLab:
    """The DeepLab module on ``device`` with random-init (seed), given, .npz
    or Keras .h5 parameters (``resolve_params``) -- the counterpart of the
    reference's ``build_model``. Evaluation mode, channels-last memory."""
    params = resolve_params(cfg, seed, params, weights_path)
    model = DeepLab(cfg, device=device).load_params(params_from_jax(params))
    return model.eval().to(memory_format=torch.channels_last)
