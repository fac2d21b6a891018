"""Augmented LR masks of one image: copies -> network forward -> OPM masks
(port of the JAX package's ``pipeline/feature_maps.py``; the reference's
staging loop, augmentation_utils.py:62-138).

``augmented_feature_maps`` is the device computation, ``stage_feature_maps``
draws an image's augmentation set and runs it (the array core of
``cli/generate_augmented_copies.py``), and
``compute_augmented_feature_maps`` adds the file side: decode the image and
stage the result to the reference's hdf5 layout.
"""

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.deeplab import DeepLab
from ..ops.opm import extract_masks
from .augment import image_generator, make_augmented_copies, sample_augmentations


@torch.no_grad()
def augmented_feature_maps(model: DeepLab, image: torch.Tensor, angles: torch.Tensor,
                           shifts: torch.Tensor, class_id: int, mode: str = "argmax",
                           num_aug: int = 100, chunk_size: int = 0
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(H, W, 3) image on the model's device -> (class_masks (N, h, w, 1),
    max_masks (N, h, w, 1) in slice_max mode, else None).

    The copies are warped in the model's compute dtype, as the serving step
    warps them. chunk_size > 0 runs the forward in chunks of that many copies
    (when it divides num_aug), to cut the activation peak; 0 runs all copies
    in one forward."""
    copies = make_augmented_copies(image.to(model.cfg.dtype), angles, shifts, num_aug)
    if chunk_size and num_aug > chunk_size and num_aug % chunk_size == 0:
        preds = torch.cat([model(c) for c in copies.split(chunk_size)])
    else:
        preds = model(copies)
    return extract_masks(preds, class_id, mode)


def draw_augmentations(seed: int, image_name: str, num_aug: int, angle_max: float,
                       shift_max: float, shared_tta: bool = False, *, device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An image's augmentation set: from the seed and the CRC-32 of its name
    (``augment.image_generator``, the same set in every process), or with
    shared_tta the seed's own set for every image."""
    generator = (torch.Generator().manual_seed(seed) if shared_tta
                 else image_generator(seed, image_name))
    return sample_augmentations(generator, num_aug, angle_max, shift_max, device=device)


def stage_feature_maps(model: DeepLab, image_name: str, image, filter_class_id: int,
                       mode: str = "argmax", num_aug: int = 100,
                       angle_max: float = 0.5, shift_max: float = 30,
                       chunk_size: int = 0, seed: int = 1234, shared_tta: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                                  torch.Tensor]:
    """One decoded (H, W, 3) image in [0, 1] (numpy or tensor) -> (class_masks,
    max_masks or None, angles, shifts), tensors on the model's device."""
    device = next(model.buffers()).device
    angles, shifts = draw_augmentations(seed, image_name, num_aug, angle_max,
                                        shift_max, shared_tta, device=device)
    image = torch.as_tensor(np.asarray(image, np.float32), device=device)
    class_masks, max_masks = augmented_feature_maps(model, image, angles, shifts,
                                                    filter_class_id, mode, num_aug,
                                                    chunk_size)
    return class_masks, max_masks, angles, shifts


def compute_augmented_feature_maps(model: DeepLab, image_path: str, filter_class_id: int,
                                   mode: str = "argmax", num_aug: int = 100,
                                   angle_max: float = 0.5, shift_max: float = 30,
                                   image_size=(512, 512), chunk_size: int = 0,
                                   dest_folder: Optional[str] = None, seed: int = 1234,
                                   shared_tta: bool = False):
    """The reference's staging of one image file (augmentation_utils.py:62-138):
    decode, draw its augmentation set, run ``augmented_feature_maps`` and,
    when dest_folder is given, write ``<dest_folder>/<name>.hdf5``.

    Returns (class_masks, max_masks or [], angles, shifts, image_name) as
    numpy arrays."""
    from ..data.io import load_image, write_augmented_hdf5

    image_name = os.path.splitext(os.path.basename(image_path))[0]
    image = load_image(image_path, image_size=image_size, normalize=True)
    class_masks, max_masks, angles, shifts = stage_feature_maps(
        model, image_name, image, filter_class_id, mode, num_aug, angle_max, shift_max,
        chunk_size, seed, shared_tta)
    class_masks = class_masks.cpu().numpy()
    max_masks = max_masks.cpu().numpy() if max_masks is not None else []
    angles, shifts = angles.cpu().numpy(), shifts.cpu().numpy()
    if dest_folder is not None:
        write_augmented_hdf5(dest_folder, image_name, class_masks, angles, shifts, mode,
                             angle_max, shift_max,
                             max_masks=max_masks if mode == "slice_max" else None)
    return class_masks, max_masks, angles, shifts, image_name
