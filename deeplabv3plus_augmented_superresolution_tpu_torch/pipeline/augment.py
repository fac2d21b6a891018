"""Augmented-copy generation and the training-time warp augmentation
(port of the JAX package's ``pipeline/augment.py``).

Sampling draws from an explicit ``torch.Generator``; its stream differs from
jax.random's for the same seed, so parity tests hand both packages the same
numpy draws (``..._with_draws``). Copy 0 is always the identity.
"""

import zlib
from typing import Tuple

import torch

from ..ops.shear_warp import paeth_planes, paeth_rotate_translate
from ..ops.warp import rotate_translate_planes


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
    """(H, W, C) image -> (num_aug, H, W, C) rotated+translated copies:
    warp_impl "shear" (the three shear passes, in the image's dtype) or
    "gather" (the reference's two-pass tfa warp, rotate then translate, in
    float32 as the reference promotes a bfloat16 image). angle_max is
    accepted for parity with the reference and bounds nothing here.

    (B, H, W, C) images sharing one augmentation set -> (num_aug, B, H, W, C),
    copy-major: the B x C planes ride the kernels' channel axis, read from
    the B images through a stride-0 copy axis, so the warp launches its three
    passes once whatever B is. The result is a view of a dense
    (num_aug, B, C, H, W) tensor, so flattening its first two axes is free."""
    del angle_max
    if image.dim() == 3:
        return make_augmented_copies(image[None], angles, shifts, num_aug,
                                     warp_impl)[:, 0]
    b, h, w, c = image.shape
    planes = image.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
    batched = planes[None].expand(num_aug, b * c, h, w)
    if warp_impl == "shear":
        out = paeth_planes(batched, angles, shifts)
    else:
        out = rotate_translate_planes(batched, angles, shifts)
    return out.view(num_aug, b, c, h, w).permute(0, 1, 3, 4, 2)


def create_augmented_copies(image: torch.Tensor, num_aug: int, angle_max: float,
                            shift_max: float, generator: torch.Generator,
                            warp_impl: str = "shear"
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's create_augmented_copies signature, with a
    torch.Generator in place of the key: (copies, angles, shifts), the set
    drawn on the generator's device and used on the image's."""
    angles, shifts = sample_augmentations(generator, num_aug, angle_max, shift_max,
                                          device=image.device)
    copies = make_augmented_copies(image, angles, shifts, num_aug, warp_impl=warp_impl,
                                   angle_max=max(angle_max, 1e-3))
    return copies, angles, shifts


def sample_warp_draws(generator: torch.Generator, shape, angle_max: float,
                      shift_max: float, prob: float = 0.5, *, device
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draws of ``warp_augment_batch`` for ``shape`` samples (e.g. (B,),
    or (steps, B) for several batches at once): angles uniform in
    +-angle_max, shifts (shape + (2,)) in +-shift_max, and the 0/1 float
    "take" mask with probability prob. Drawn on the generator's device, then
    moved to ``device``."""
    shape = tuple(shape)
    opts = dict(generator=generator, dtype=torch.float32, device=generator.device)
    angles = -angle_max + torch.rand(shape, **opts) * (2.0 * angle_max)
    shifts = -shift_max + torch.rand(shape + (2,), **opts) * (2.0 * shift_max)
    take = (torch.rand(shape, **opts) < prob).to(torch.float32)
    return angles.to(device), shifts.to(device), take.to(device)


def warp_augment_batch_with_draws(images: torch.Tensor, labels: torch.Tensor,
                                  angles: torch.Tensor, shifts: torch.Tensor,
                                  take: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``warp_augment_batch`` with given draws (the reference's (angles (B,),
    shifts (B, 2), take (B,)) as tensors on the images' device): sample i is
    rotated by angles[i] and shifted by shifts[i] where take[i] is 1, else
    left as it is. Images warp bilinear; labels warp as float32 with the
    nearest mode (integer shifts: every output value is an input value) and
    the zero-filled border becomes label 0. Two warps of three shear
    launches each on the card."""
    take = take.to(torch.float32)
    angles = angles * take
    shifts = shifts * take[:, None]
    out_img = paeth_rotate_translate(images, angles, shifts)
    lab = paeth_rotate_translate(labels.to(torch.float32), angles, shifts,
                                 interpolation="nearest")
    return out_img, lab.to(labels.dtype)


def warp_augment_batch(generator: torch.Generator, images: torch.Tensor,
                       labels: torch.Tensor, angle_max: float = 0.15,
                       shift_max: float = 80.0, prob: float = 0.5,
                       static_angle_max: float = 0.16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TTA-distribution training augmentation: each sample, with probability
    prob, gets the random rotation (+-angle_max rad) and translation
    (+-shift_max px) with zero fill that the ASR pipeline applies to its
    copies at test time, so the model learns that warped-in black borders
    are background.

    images: (B, H, W, 3) float; labels: (B, H, W) integer (255 = void).
    static_angle_max sizes a TPU tap window in the reference and bounds
    nothing here; it is accepted and ignored."""
    del static_angle_max
    draws = sample_warp_draws(generator, (images.shape[0],), angle_max, shift_max,
                              prob, device=images.device)
    return warp_augment_batch_with_draws(images, labels, *draws)
