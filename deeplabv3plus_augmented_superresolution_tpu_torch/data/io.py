"""Image and hdf5 I/O (port of the JAX package's ``data/io.py``).

The hdf5 staging format is the reference's (augmentation_utils.py:117-136):
datasets class_masks / [max_masks] / angles / shifts and attrs filename /
mode / angle_max / shift_max, so either package reads the other's files.

PIL and h5py are imported inside the functions that use them, so the rest
of the package runs where they are not installed.
"""

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.opm import prepare_sr_inputs
from ..ops.resize import resize


def decode_image(img_path: str, is_png: bool = False) -> np.ndarray:
    """Decode a jpg as (H, W, 3) or a label png as (H, W, 1) float32 (PIL;
    a label png as tf.io.decode_png(channels=1) reads it)."""
    from PIL import Image

    img = Image.open(img_path)
    if not is_png:
        return np.asarray(img.convert("RGB"), dtype=np.float32)
    # single-channel label PNGs (VOC GT); match tf.io.decode_png(channels=1)
    if img.mode not in ("L", "P", "I", "I;16"):
        img = img.convert("L")
    raw = np.asarray(img)
    return raw.astype(np.float32)[..., None] if raw.ndim == 2 else raw.astype(np.float32)[..., :1]


def prepare_image(arr: np.ndarray, image_size: Optional[Tuple[int, int]] = None,
                  normalize: bool = True, resize_method: str = "bilinear") -> np.ndarray:
    """What ``load_image`` does after the decode: float32, an optional
    TF-semantics resize (on the CPU) and an optional /255."""
    arr = np.asarray(arr, dtype=np.float32)
    if image_size is not None and tuple(arr.shape[:2]) != tuple(image_size):
        arr = resize(torch.from_numpy(np.ascontiguousarray(arr)), image_size,
                     method=resize_method).numpy()
    arr = arr.astype(np.float32)
    if normalize:
        arr = arr / 255.0
    return arr


def load_image(img_path: str, image_size: Optional[Tuple[int, int]] = None,
               normalize: bool = True, is_png: bool = False,
               resize_method: str = "bilinear") -> np.ndarray:
    """Decode a jpg as (H, W, 3) or a label png as (H, W, 1) float32, with an
    optional TF-semantics resize (on the CPU) and optional /255."""
    return prepare_image(decode_image(img_path, is_png), image_size, normalize,
                         resize_method)


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


def write_augmented_hdf5(dest_folder: str, image_name: str, class_masks,
                         angles, shifts, mode: str, angle_max: float,
                         shift_max: float, max_masks=None) -> str:
    """Stage one image's LR masks and augmentation set to
    ``dest_folder/<image_name>.hdf5``; max_masks are kept in slice_max mode."""
    import h5py

    os.makedirs(dest_folder, exist_ok=True)
    path = os.path.join(dest_folder, f"{image_name}.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("class_masks", data=np.asarray(class_masks))
        if mode == "slice_max" and max_masks is not None:
            f.create_dataset("max_masks", data=np.asarray(max_masks))
        f.create_dataset("angles", data=np.asarray(angles))
        f.create_dataset("shifts", data=np.asarray(shifts))
        f.attrs["filename"] = image_name
        f.attrs["mode"] = mode
        f.attrs["angle_max"] = angle_max
        f.attrs["shift_max"] = shift_max
    return path


def check_hdf5_validity(file, num_aug: int = 100) -> bool:
    """Every dataset must have first-dim >= num_aug (reference
    superres_utils.py:108-115)."""
    return all(file[key].shape[0] >= num_aug for key in file)


def load_sr_data(filepath: str, num_aug: int = 100, global_normalize: bool = True,
                 device="cpu"):
    """Load a staged hdf5 and normalize its stacks (reference
    superres_utils.py:154-210): (class_masks, max_masks or None, angles,
    shifts, filename), the masks float32 tensors on ``device`` with the
    mode's [0, 1] normalization (``ops.opm.prepare_sr_inputs``), angles and
    shifts float32 numpy. Raises ValueError for a file with fewer than
    num_aug copies."""
    import h5py

    with h5py.File(filepath, "r") as f:
        if not check_hdf5_validity(f, num_aug=num_aug):
            raise ValueError(f"File: {filepath} is invalid")
        filename = f.attrs["filename"]
        mode = f.attrs["mode"]
        angles = f["angles"][:num_aug].astype(np.float32)
        shifts = f["shifts"][:num_aug].astype(np.float32)
        class_masks = torch.as_tensor(f["class_masks"][:num_aug].astype(np.float32),
                                      device=device)
        max_masks = (torch.as_tensor(f["max_masks"][:num_aug].astype(np.float32),
                                     device=device)
                     if mode == "slice_max" and "max_masks" in f else None)
    class_masks, max_masks = prepare_sr_inputs(class_masks, max_masks, mode=str(mode),
                                               global_normalize=global_normalize)
    return class_masks, max_masks, angles, shifts, str(filename)
