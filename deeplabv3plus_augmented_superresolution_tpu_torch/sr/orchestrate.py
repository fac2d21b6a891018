"""SR orchestration: solve + threshold + optional image export (port of the
JAX package's ``sr/orchestrate.py``; reference superres_utils.py:213-273,
compute_SR).

One of aug/max/mean SR over a normalized LR mask stack; in slice_max mode the
max stack is super-resolved too and the class wins where it reaches the max
(class-vs-max thresholding), else the target is thresholded at th_factor x
its peak.
"""

import os
from typing import Optional

import numpy as np
import torch

from ..data.io import save_img
from .postprocess import threshold_image
from .solver import (SRConfig, augmented_superresolution, max_superresolution,
                     mean_superresolution)

SR_TYPES = ("aug", "mean", "max")


def compute_sr(sr_cfg: SRConfig, class_masks: torch.Tensor, angles: torch.Tensor,
               shifts: torch.Tensor, filename: str, dest_folder: Optional[str] = None,
               sr_type: str = "aug", max_masks: Optional[torch.Tensor] = None,
               save_intermediate_output: bool = False, save_final_output: bool = False,
               class_id: int = 8, th_factor: float = 0.15,
               dropout_generator: Optional[torch.Generator] = None,
               gram_coeffs: Optional[torch.Tensor] = None) -> np.ndarray:
    """The thresholded HR mask (H, W, 1) with values {0, class_id}, as numpy.

    class_masks / max_masks: normalized (N, h, w, 1) stacks on the device
    that angles and shifts are on. gram_coeffs: a precomputed Gram stencil
    for these (angles, shifts, sr_cfg) (``sr.precompute_gram_stencil``), so
    that the aug solve skips its own extraction; for images that share one
    staged augmentation set. dropout_generator: the aug solve's draws
    (``sr.augmented_superresolution``). With save flags and dest_folder, the
    targets (``<name>_class.png``, ``<name>_max.png``) and the final mask
    (``<name>_<type>_SR.png``) go under ``dest_folder/<type>_SR/``."""
    if sr_type not in SR_TYPES:
        raise ValueError(f"SR_type must be one of {SR_TYPES}, got {sr_type!r}")

    if sr_type == "aug":
        def sr_function(masks):
            return augmented_superresolution(masks, angles, shifts, sr_cfg,
                                             gram_coeffs=gram_coeffs,
                                             dropout_generator=dropout_generator)
    elif sr_type == "mean":
        def sr_function(masks):
            return mean_superresolution(masks, angles, shifts, sr_cfg)
    else:
        def sr_function(masks):
            return max_superresolution(masks, angles, shifts, sr_cfg)

    target_image_class, _ = sr_function(class_masks)
    target_image_max = None
    if max_masks is not None and len(max_masks) == len(class_masks):
        target_image_max, _ = sr_function(max_masks)
        th_mask = threshold_image(target_image_class, class_id, th_mask=target_image_max)
    else:
        th_mask = threshold_image(target_image_class, class_id, th_factor=th_factor)
    th_mask = th_mask.cpu().numpy()

    if dest_folder is not None and (save_intermediate_output or save_final_output):
        out_folder = os.path.join(dest_folder, f"{sr_type}_SR")
        if save_intermediate_output:
            save_img(os.path.join(out_folder, f"{filename}_class.png"),
                     target_image_class.cpu().numpy(), scale=True)
            if target_image_max is not None:
                save_img(os.path.join(out_folder, f"{filename}_max.png"),
                         target_image_max.cpu().numpy(), scale=True)
        if save_final_output:
            save_img(os.path.join(out_folder, f"{filename}_{sr_type}_SR.png"),
                     th_mask, scale=True)
    return th_mask
