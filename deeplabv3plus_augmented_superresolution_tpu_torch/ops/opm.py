"""Output Processing Modes (OPMs): per-copy LR mask extraction.

Port of the JAX package's ``ops/opm.py``, for one class
(``extract_masks``) or K classes from one prediction stack
(``extract_masks_multiclass``):

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


def extract_masks_multiclass(predictions: torch.Tensor, class_ids, mode: str = "argmax"
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(N, h, w, C) logits + K class ids -> ((K, N, h, w, 1) class masks,
    (K, N, h, w, 1) max masks or None). The class-independent work (the
    argmax labels, the per-copy min/max, the top two logits) is done once;
    slice k equals ``extract_masks(predictions, class_ids[k], mode)``
    exactly. Leading axes ride along: (B, N, h, w, C) logits of B images give
    (B, K, N, h, w, 1) stacks."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cls = torch.as_tensor(class_ids, dtype=torch.int64, device=predictions.device)
    per_class = cls[:, None, None, None, None]                     # (K, 1, 1, 1, 1)

    if mode == "argmax":
        labels = torch.argmax(predictions, dim=-1, keepdim=True).unsqueeze(-5)
        return torch.where(labels == per_class, labels, 0).to(torch.float32), None

    # (..., N, h, w, K) -> (..., K, N, h, w, 1)
    class_masks = predictions[..., cls].to(torch.float32).movedim(-1, -4)[..., None]
    if mode == "slice":
        gmin = predictions.amin(dim=(-3, -2, -1), keepdim=True).unsqueeze(-5)
        gmax = predictions.amax(dim=(-3, -2, -1), keepdim=True).unsqueeze(-5)
        return min_max_normalization(class_masks, 0.0, 1.0,
                                     global_min=gmin, global_max=gmax), None

    # slice_max: the max over the other channels is the top logit unless the
    # class itself holds it, then the second (equal to the top on a tie).
    top2 = torch.topk(predictions, 2, dim=-1).values.to(torch.float32)
    first, second = top2[..., :1].unsqueeze(-5), top2[..., 1:].unsqueeze(-5)
    max_masks = torch.where(class_masks == first, second, first)
    return class_masks, max_masks


def normalize_stack(masks: torch.Tensor, global_normalize: bool = True) -> torch.Tensor:
    """[0,1] normalization of a mask stack: min/max over the whole stack when
    global_normalize, else per copy. A 5-D stack (K, N, h, w, 1) carries a
    leading class axis, and each class is normalized on its own."""
    if global_normalize:
        dims = tuple(range(1 if masks.dim() == 5 else 0, masks.dim()))
    else:
        dims = (-3, -2, -1)
    mn = masks.amin(dim=dims, keepdim=True)
    mx = masks.amax(dim=dims, keepdim=True)
    return min_max_normalization(masks, 0.0, 1.0, global_min=mn, global_max=mx)


def prepare_sr_inputs(class_masks: torch.Tensor,
                      max_masks: Optional[torch.Tensor],
                      mode: str, global_normalize: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """'slice' is normalized at extraction; other modes are normalized here;
    slice_max also normalizes the max stack. Stacks with a leading class axis
    (``extract_masks_multiclass``) are normalized per class, as the
    reference's vmap over classes does."""
    if mode != "slice":
        class_masks = normalize_stack(class_masks, global_normalize)
    if mode == "slice_max" and max_masks is not None:
        max_masks = normalize_stack(max_masks, global_normalize)
    return class_masks, max_masks


def create_mask(prediction: torch.Tensor) -> torch.Tensor:
    """Argmax label image with a trailing channel axis (reference utils.py:115-119)."""
    return torch.argmax(prediction, dim=-1, keepdim=True)


def get_prediction(apply_fn, params, image: torch.Tensor) -> torch.Tensor:
    """Single-image forward -> argmax mask (reference utils.py:122-127:
    model.predict on a batch of one, then create_mask of the first output).

    apply_fn: a (params, batch) forward, e.g. ``models.forward`` with its
    config bound."""
    prediction = apply_fn(params, image[None])
    return create_mask(prediction[0])
