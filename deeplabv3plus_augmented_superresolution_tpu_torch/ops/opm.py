"""Output Processing Modes (OPMs): per-copy LR mask extraction.

Port of the JAX package's ``ops/opm.py`` (single class):

  argmax:    argmax over classes, keep pixels == class_id (value class_id)
  slice:     class-channel slice min-max normalized to [0,1] by the whole
             prediction's min/max, per copy
  slice_max: raw class-channel slice + pixelwise max over the other channels
"""

from typing import Optional, Tuple

import torch

MODES = ("argmax", "slice", "slice_max")


def min_max_normalization(image: torch.Tensor, new_min: float = 0.0,
                          new_max: float = 255.0,
                          global_min: Optional[torch.Tensor] = None,
                          global_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(image - min) * (new_max - new_min) / (max - min) + new_min, with a
    zero range guarded to 1."""
    mn = image.min() if global_min is None else global_min
    mx = image.max() if global_max is None else global_max
    num = (image - mn) * (new_max - new_min)
    den = mx - mn
    den = torch.where(den == 0, torch.ones_like(den), den)
    return new_min + num / den


def extract_masks(predictions: torch.Tensor, class_id: int, mode: str = "argmax"
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(N, h, w, C) logits -> (class_masks (N, h, w, 1), max_masks or None)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    if mode == "argmax":
        labels = torch.argmax(predictions, dim=-1, keepdim=True)
        return torch.where(labels == class_id, labels, 0).to(torch.float32), None

    class_masks = predictions[..., class_id:class_id + 1].to(torch.float32)
    if mode == "slice":
        gmin = predictions.amin(dim=(-3, -2, -1), keepdim=True)
        gmax = predictions.amax(dim=(-3, -2, -1), keepdim=True)
        return min_max_normalization(class_masks, 0.0, 1.0,
                                     global_min=gmin, global_max=gmax), None

    others = predictions.clone()
    others[..., class_id] = -torch.inf
    max_masks = others.amax(dim=-1, keepdim=True).to(torch.float32)
    return class_masks, max_masks


def normalize_stack(masks: torch.Tensor, global_normalize: bool = True) -> torch.Tensor:
    """[0,1] normalization of a mask stack: min/max over the whole stack when
    global_normalize, else per copy."""
    if global_normalize:
        return min_max_normalization(masks, 0.0, 1.0,
                                     global_min=masks.min(), global_max=masks.max())
    mn = masks.amin(dim=(-3, -2, -1), keepdim=True)
    mx = masks.amax(dim=(-3, -2, -1), keepdim=True)
    return min_max_normalization(masks, 0.0, 1.0, global_min=mn, global_max=mx)


def prepare_sr_inputs(class_masks: torch.Tensor,
                      max_masks: Optional[torch.Tensor],
                      mode: str, global_normalize: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """'slice' is normalized at extraction; other modes are normalized here;
    slice_max also normalizes the max stack."""
    if mode != "slice":
        class_masks = normalize_stack(class_masks, global_normalize)
    if mode == "slice_max" and max_masks is not None:
        max_masks = normalize_stack(max_masks, global_normalize)
    return class_masks, max_masks
