"""Augmented-copy generation (port of the JAX package's ``pipeline/augment.py``).

Sampling draws from an explicit ``torch.Generator``; its stream differs from
jax.random's for the same seed, so parity tests hand both packages the same
numpy (angles, shifts). Copy 0 is always the identity.
"""

import zlib
from typing import Tuple

import torch

from ..ops.shear_warp import paeth_planes


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


def image_generator(seed: int, name: str) -> torch.Generator:
    """The generator of one image's own augmentation set (``--per_image_augs``):
    seeded from the run's seed and the CRC-32 of the image name, so an image
    draws the same set in every run and process (``hash(str)`` is salted per
    process)."""
    return torch.Generator().manual_seed(
        (int(seed) << 32) | zlib.crc32(name.encode("utf-8")))


def make_augmented_copies(image: torch.Tensor, angles: torch.Tensor,
                          shifts: torch.Tensor, num_aug: int,
                          warp_impl: str = "shear",
                          angle_max: float = 0.35) -> torch.Tensor:
    """(H, W, C) image -> (num_aug, H, W, C) rotated+translated copies, in the
    image's dtype. angle_max is accepted for parity with the reference and
    bounds nothing here.

    (B, H, W, C) images sharing one augmentation set -> (num_aug, B, H, W, C),
    copy-major: the B x C planes ride the kernels' channel axis, read from
    the B images through a stride-0 copy axis, so the warp launches its three
    passes once whatever B is. The result is a view of a dense
    (num_aug, B, C, H, W) tensor, so flattening its first two axes is free."""
    del angle_max
    if warp_impl != "shear":
        raise NotImplementedError("the gather warp is not ported yet "
                                  "(ROADMAP Queue 1: 'ops/warp.py')")
    if image.dim() == 3:
        return make_augmented_copies(image[None], angles, shifts, num_aug)[:, 0]
    b, h, w, c = image.shape
    planes = image.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
    out = paeth_planes(planes[None].expand(num_aug, b * c, h, w), angles, shifts)
    return out.view(num_aug, b, c, h, w).permute(0, 1, 3, 4, 2)
