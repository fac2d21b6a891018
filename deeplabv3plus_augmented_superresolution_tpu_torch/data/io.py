"""Image I/O (port of the JAX package's ``data/io.py`` load_image / save_img).

PIL is imported inside the functions that decode or encode, so the rest of
the package runs where PIL is not installed.
"""

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize


def load_image(img_path: str, image_size: Optional[Tuple[int, int]] = None,
               normalize: bool = True, is_png: bool = False,
               resize_method: str = "bilinear") -> np.ndarray:
    """Decode a jpg as (H, W, 3) or a label png as (H, W, 1) float32, with an
    optional TF-semantics resize (on the CPU) and optional /255."""
    from PIL import Image

    img = Image.open(img_path)
    if not is_png:
        arr = np.asarray(img.convert("RGB"), dtype=np.float32)
    else:
        # single-channel label PNGs (VOC GT); match tf.io.decode_png(channels=1)
        if img.mode not in ("L", "P", "I", "I;16"):
            img = img.convert("L")
        raw = np.asarray(img)
        arr = (raw.astype(np.float32)[..., None] if raw.ndim == 2
               else raw.astype(np.float32)[..., :1])
    if image_size is not None and tuple(arr.shape[:2]) != tuple(image_size):
        arr = resize(torch.from_numpy(np.ascontiguousarray(arr)), image_size,
                     method=resize_method).numpy()
    arr = arr.astype(np.float32)
    if normalize:
        arr = arr / 255.0
    return arr


def save_img(path: str, x, scale: bool = True, compress_level: int = 6) -> None:
    """tf.keras.utils.save_img-compatible PNG writer (compress_level: zlib
    level; label masks encode fast at 1)."""
    from PIL import Image

    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 2:
        x = x[..., None]
    if scale:
        x = x - x.min()
        mx = x.max()
        if mx > 0:
            x = x / mx
        x = x * 255.0
    x = np.clip(x, 0, 255).astype(np.uint8)
    img = Image.fromarray(x[..., 0], mode="L") if x.shape[-1] == 1 else Image.fromarray(x)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path, compress_level=compress_level)
