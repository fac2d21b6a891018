"""Persistent cache for the serving Gram stencil.

Port of the JAX package's ``sr/stencil_cache.py``. The stencil is a pure
function of the TTA set and the operator-shaping SRConfig fields; it is
keyed by sha256 over the exact angle/shift values, those fields and the tag
"torch", so the port never loads a stencil the JAX side wrote (the two
operators agree only to float tolerance). The fields include the count of
real copies (``n_valid``), which the JAX key lacks: a set padded with
identity copies (weighted 0) and a set whose last copies are real identity
transforms have the same values and different stencils. They also include
``solve_dtype``, which the JAX key lacks too: the staged operator warps in
bfloat16 when it is "bfloat16", so that stencil differs from the float32
one.
"""

import hashlib
import os
import zipfile
from typing import Optional

import numpy as np

__all__ = ["stencil_cache_key", "load_stencil", "save_stencil"]

BACKEND_TAG = "torch"


def stencil_cache_key(angles, shifts, cfg) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(angles, np.float64).tobytes())
    h.update(np.asarray(shifts, np.float64).tobytes())
    h.update(repr((tuple(cfg.feature_size), tuple(cfg.output_size),
                   cfg.angle_max, cfg.num_aug, cfg.n_valid, cfg.operator_impl,
                   cfg.warp_impl, cfg.gram_probing, cfg.solve_dtype,
                   BACKEND_TAG)).encode())
    return h.hexdigest()[:24]


def _path(cache_dir: str, angles, shifts, cfg) -> str:
    return os.path.join(cache_dir,
                        f"stencil_{stencil_cache_key(angles, shifts, cfg)}.npz")


def load_stencil(cache_dir: str, angles, shifts, cfg) -> Optional[np.ndarray]:
    """The cached coefficients for this exact (TTA set, operator config),
    or None on a miss or an unreadable file."""
    path = _path(cache_dir, angles, shifts, cfg)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            return data["coeffs"]
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None  # corrupt cache entry: treat as a miss, recompute


def save_stencil(cache_dir: str, angles, shifts, cfg, coeffs) -> str:
    """Atomically persist the coefficients; returns the cache path."""
    os.makedirs(cache_dir, exist_ok=True)
    path = _path(cache_dir, angles, shifts, cfg)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, coeffs=np.asarray(coeffs))
    os.replace(tmp, path)
    return path
