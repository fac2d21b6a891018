"""TF-semantics image resize as two matrix products.

Port of the JAX package's ``ops/resize.py``. The interpolation matrices are
the same numpy construction (TF2 ``tf.image.resize``: half-pixel centers, no
antialiasing):

  bilinear: src = max(0, (dst + 0.5) * (in/out) - 0.5); lerp of floor/ceil
            with ceil clamped to in-1.
  nearest:  src = min(floor((dst + 0.5) * (in/out)), in - 1).

dtype rules follow the reference: float32 inputs resize in full float32,
bfloat16 inputs resize in bfloat16, anything else is computed in float32.
Nearest is an index selection and keeps the input dtype.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_matrix_np(out_size: int, in_size: int, method: str) -> np.ndarray:
    """Dense (out_size, in_size) interpolation matrix, built on host once."""
    dst = np.arange(out_size, dtype=np.float64)
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "bilinear":
        src = np.maximum((dst + 0.5) * scale - 0.5, 0.0)
        lo = np.floor(src).astype(np.int64)
        lo = np.minimum(lo, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = src - lo
        np.add.at(mat, (dst.astype(np.int64), lo), 1.0 - frac)
        np.add.at(mat, (dst.astype(np.int64), hi), frac)
    elif method == "nearest":
        src = np.minimum(np.floor((dst + 0.5) * scale), in_size - 1).astype(np.int64)
        mat[dst.astype(np.int64), src] = 1.0
    else:
        raise ValueError(f"Unsupported resize method: {method!r}")
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(out_size: int, in_size: int, method: str,
                      device: torch.device) -> torch.Tensor:
    return torch.tensor(_resize_matrix_np(out_size, in_size, method),
                        device=device)


def resize_matrix(out_size: int, in_size: int, method: str = "bilinear", *,
                  device) -> torch.Tensor:
    """Interpolation matrix M with ``out_row = M @ in_row`` (TF semantics).

    The tensor is cached per device and shared between callers: treat it as
    read-only."""
    return _resize_matrix_on(int(out_size), int(in_size), method,
                             torch.device(device))


def _nearest_index(out_size: int, in_size: int, device) -> torch.Tensor:
    idx = np.minimum(np.floor((np.arange(out_size) + 0.5) * (in_size / out_size)),
                     in_size - 1).astype(np.int64)
    return torch.tensor(idx, device=device)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def resize_hw(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """Resize over the LAST TWO axes (..., H, W): the layout the network
    uses internally (NCHW). Same numerics as ``resize``."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x.float() if method == "bilinear" else x
    if method == "nearest":
        rows = _nearest_index(out_h, in_h, x.device)
        cols = _nearest_index(out_w, in_w, x.device)
        return x.index_select(-2, rows).index_select(-1, cols)
    compute = _compute_dtype(x.dtype)
    mh = resize_matrix(out_h, in_h, method, device=x.device).to(compute)
    mw = resize_matrix(out_w, in_w, method, device=x.device).to(compute)
    return torch.matmul(torch.matmul(mh, x.to(compute)), mw.t())


def resize(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """Resize NHWC / HWC / (..., H, W, C) images to ``size`` (h, w).

    Matches ``tf.image.resize(x, size, method=method)`` for "bilinear" and
    "nearest", with the dtype rules in the module docstring.
    """
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x.float() if method == "bilinear" else x
    if method == "nearest":
        rows = _nearest_index(out_h, in_h, x.device)
        cols = _nearest_index(out_w, in_w, x.device)
        return x.index_select(-3, rows).index_select(-2, cols)
    compute = _compute_dtype(x.dtype)
    mh = resize_matrix(out_h, in_h, method, device=x.device).to(compute)
    mw = resize_matrix(out_w, in_w, method, device=x.device).to(compute)
    y = torch.einsum("oh,...hwc->...owc", mh, x.to(compute))
    return torch.einsum("pw,...owc->...opc", mw, y)
