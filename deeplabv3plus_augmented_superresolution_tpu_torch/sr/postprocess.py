"""Thresholding of SR targets (port of the JAX package's ``sr/postprocess.py``)."""

from typing import Optional

import torch


def threshold_image(image: torch.Tensor, th_value, th_factor: float = 0.15,
                    th_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixelwise threshold to {0, th_value}, as float32.

    With th_mask: image >= th_mask wins (the slice_max class-vs-max
    contest); else threshold at th_factor * max(image) (strict >).
    """
    if th_mask is not None:
        keep = image >= th_mask
    else:
        keep = image > image.max().float() * th_factor
    return keep.to(torch.float32) * th_value
