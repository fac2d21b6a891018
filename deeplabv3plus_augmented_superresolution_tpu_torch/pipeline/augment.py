"""Augmented-copy generation (port of the JAX package's ``pipeline/augment.py``).

Sampling draws from an explicit ``torch.Generator``; its stream differs from
jax.random's for the same seed, so parity tests hand both packages the same
numpy (angles, shifts). Copy 0 is always the identity.
"""

from typing import Tuple

import torch

from ..ops.shear_warp import paeth_rotate_translate


def sample_augmentations(generator: torch.Generator, num_aug: int,
                         angle_max: float, shift_max: float, *, device
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform angles in +-angle_max (rad), shifts in +-shift_max (px, 2-D),
    first sample forced to identity. Drawn on the generator's device, then
    moved to ``device``."""
    u_angle = torch.rand(num_aug, generator=generator, dtype=torch.float32,
                         device=generator.device)
    u_shift = torch.rand((num_aug, 2), generator=generator, dtype=torch.float32,
                         device=generator.device)
    angles = -angle_max + u_angle * (2.0 * angle_max)
    shifts = -shift_max + u_shift * (2.0 * shift_max)
    angles[0] = 0.0
    shifts[0] = 0.0
    return angles.to(device), shifts.to(device)


def make_augmented_copies(image: torch.Tensor, angles: torch.Tensor,
                          shifts: torch.Tensor, num_aug: int,
                          warp_impl: str = "shear",
                          angle_max: float = 0.35) -> torch.Tensor:
    """(H, W, C) image -> (num_aug, H, W, C) rotated+translated copies, in the
    image's dtype."""
    if warp_impl != "shear":
        raise NotImplementedError("the gather warp is not ported yet "
                                  "(ROADMAP Queue 1: 'ops/warp.py')")
    batched = image[None].expand((num_aug,) + tuple(image.shape))
    return paeth_rotate_translate(batched, angles, shifts, angle_max)
