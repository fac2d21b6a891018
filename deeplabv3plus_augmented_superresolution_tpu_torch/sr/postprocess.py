"""Thresholding, the multi-class label map and coefficient helpers (port of
the JAX package's ``sr/postprocess.py``)."""

from typing import Optional

import torch


def threshold_image(image: torch.Tensor, th_value, th_factor: float = 0.15,
                    th_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixelwise threshold to {0, th_value}, as float32, of one (H, W, 1)
    plane or of each plane of a (K, H, W, 1) stack (th_value then a scalar
    or (K, 1, 1, 1)).

    With th_mask: image >= th_mask wins (the slice_max class-vs-max
    contest); else threshold at th_factor * the plane's max (strict >).
    """
    if th_mask is not None:
        keep = image >= th_mask
    else:
        keep = image > image.amax(dim=(-3, -2, -1), keepdim=True).float() * th_factor
    return keep.to(torch.float32) * th_value


def normalize_coefficients(coeff_dict: dict) -> dict:
    """Scale lambda coefficients to sum to one."""
    normalizer = float(sum(coeff_dict.values()))
    return {k: v / normalizer for k, v in coeff_dict.items()}


LABEL_MAP_RULES = ("class_peak", "scene_peak", "raw", "gated")


def combine_label_map(targets: torch.Tensor, class_ids, th_factor: float,
                      rule: str = "class_peak", gate_th: float = 0.5) -> torch.Tensor:
    """Per-class SR targets (K, H, W, 1) -> one full-scene label map
    (H, W, 1): per pixel the best-scoring class if its score exceeds
    th_factor, else background 0; (B, K, H, W, 1) targets of B images give
    (B, H, W, 1) maps. The rule normalizes the scores:

      class_peak: each class by its own peak;
      scene_peak: every class by the joint peak;
      raw:        no normalization (th_factor is an absolute floor);
      gated:      class_peak, but a class whose raw peak is not above
                  gate_th scores 0 everywhere.
    """
    if rule == "class_peak":
        score = targets / torch.clamp_min(targets.amax(dim=(-3, -2, -1), keepdim=True),
                                          1e-12)
    elif rule == "scene_peak":
        joint = targets.amax(dim=(-4, -3, -2, -1), keepdim=True)
        score = targets / torch.clamp_min(joint, 1e-12)
    elif rule == "raw":
        score = targets
    elif rule == "gated":
        peak = targets.amax(dim=(-3, -2, -1), keepdim=True)
        present = (peak > gate_th).to(targets.dtype)
        score = present * targets / torch.clamp_min(peak, 1e-12)
    else:
        raise ValueError(f"unknown label_map rule {rule!r}")
    best_score, best = torch.max(score, dim=-4)
    cls = torch.as_tensor(class_ids, device=targets.device)
    return torch.where(best_score > th_factor, cls[best], 0)
