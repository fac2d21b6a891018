"""The ASR step for one image (port of the JAX package's ``pipeline/end_to_end.py``).

  image -> N augmented copies -> DeepLabV3+ forward -> OPM masks
        -> normalize -> aug SR solve -> threshold

plus the "standard" baseline mask (the plain model's upsampled argmax) from
the forward of the identity copy. Eager PyTorch: each stage enqueues its
device work in order; nothing here synchronizes unless a timer asks to.
"""

import contextlib
from typing import Dict, Optional, Tuple

import torch

from ..models.deeplab import DeepLab
from ..ops.opm import extract_masks, prepare_sr_inputs
from ..ops.resize import resize
from ..sr.postprocess import threshold_image
from ..sr.solver import SRConfig, augmented_superresolution
from .augment import make_augmented_copies

NOT_PORTED_MAX_MEAN = ("max/mean SR is not ported yet (ROADMAP Queue 1: "
                       "'max/mean SR through the inverse warp')")


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


@torch.no_grad()
def asr_step(model: DeepLab, image: torch.Tensor, angles: torch.Tensor,
             shifts: torch.Tensor, sr_cfg: SRConfig, class_id: int,
             mode: str = "argmax", th_factor: float = 0.15,
             sr_types: Tuple[str, ...] = ("aug",),
             chunk_size: int = 0,
             gram_coeffs: Optional[torch.Tensor] = None,
             return_targets: bool = False,
             timer=None) -> Dict[str, torch.Tensor]:
    """Full ASR for one (H, W, 3) image on the model's device. Returns the
    thresholded HR masks ("aug" and "standard"), each (H, W, 1) float32 with
    values {0, class_id}; with return_targets also "aug_target", the
    continuous SR estimate before thresholding.

    gram_coeffs: a precomputed stencil (sr.precompute_gram_stencil) for the
    run's fixed augmentation set. timer: optional object with a
    ``stage(name)`` context manager (utils.profiling.StageTimer), given the
    stages warp, forward, opm, b, solve_steps, threshold and standard.
    """
    if tuple(sr_types) != ("aug",):
        raise NotImplementedError(f"sr_types={tuple(sr_types)}: {NOT_PORTED_MAX_MEAN}; "
                                  "the port runs sr_types=('aug',)")
    model_cfg = model.cfg
    num_aug = sr_cfg.num_aug
    with _stage(timer, "warp"):
        # Warp in the model's compute dtype: the forward casts its input to it
        # at entry anyway, and the kernel blends in f32 either way.
        image = image.to(model_cfg.dtype)
        copies = make_augmented_copies(image, angles, shifts, num_aug,
                                       warp_impl=sr_cfg.warp_impl,
                                       angle_max=sr_cfg.angle_max)
    with _stage(timer, "forward"):
        if chunk_size and num_aug > chunk_size and num_aug % chunk_size == 0:
            preds = torch.cat([model(c) for c in copies.split(chunk_size)])
        else:
            preds = model(copies)
    with _stage(timer, "opm"):
        class_masks, max_masks = extract_masks(preds, class_id, mode)
        class_masks, max_masks = prepare_sr_inputs(class_masks, max_masks, mode)

    target_class, _ = augmented_superresolution(class_masks, angles, shifts, sr_cfg,
                                                gram_coeffs=gram_coeffs, timer=timer)
    target_max = None
    if mode == "slice_max" and max_masks is not None:
        target_max, _ = augmented_superresolution(max_masks, angles, shifts, sr_cfg,
                                                  gram_coeffs=gram_coeffs,
                                                  timer=timer)
    results: Dict[str, torch.Tensor] = {}
    with _stage(timer, "threshold"):
        if target_max is not None:
            results["aug"] = threshold_image(target_class, class_id, th_mask=target_max)
        else:
            results["aug"] = threshold_image(target_class, class_id, th_factor=th_factor)
        if return_targets:
            results["aug_target"] = target_class.to(torch.float32)

    with _stage(timer, "standard"):
        hr_logits = resize(preds[0], model_cfg.input_shape[:2], method="bilinear")
        standard = torch.argmax(hr_logits, dim=-1, keepdim=True)
        results["standard"] = (standard == class_id).to(torch.float32) * class_id
    return results
