"""Image-gradient / total-variation terms for the SR loss.

Port of the JAX package's ``ops/gradients.py``: tf.image.image_gradients
semantics (zero-padded last row/col), anisotropic TV and bilateral TV.

The derivative of |.| at 0 follows JAX, not torch: jax's abs JVP passes the
tangent where x >= 0, so d|x|/dx = +1 at x = 0, where torch.abs's backward
gives 0. Argmax masks make many neighbour differences exactly 0, so the
choice changes the SR trajectory; ``abs_`` keeps the reference's.
"""

import torch
import torch.nn.functional as F


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: +1 at x = 0 (torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


def image_gradients(image: torch.Tensor):
    """(B, H, W, C) -> (dy, dx), each zero-padded at the bottom/right edge."""
    dy = image[:, 1:, :, :] - image[:, :-1, :, :]
    dx = image[:, :, 1:, :] - image[:, :, :-1, :]
    dy = F.pad(dy, (0, 0, 0, 0, 0, 1))
    dx = F.pad(dx, (0, 0, 0, 1))
    return dy, dx


def image_gradients_transpose(vy: torch.Tensor, vx: torch.Tensor) -> torch.Tensor:
    """D^T (vy, vx): the adjoint of ``image_gradients`` for (B, H, W, C)
    fields. The zero-padded last row of vy and last column of vx never meet
    a real difference, so they are ignored."""
    vy, vx = vy[:, :-1], vx[:, :, :-1]
    dty = F.pad(vy, (0, 0, 0, 0, 1, 0)) - F.pad(vy, (0, 0, 0, 0, 0, 1))
    dtx = F.pad(vx, (0, 0, 1, 0)) - F.pad(vx, (0, 0, 0, 1))
    return dty + dtx


def total_variation(image: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV: sum |dy| + |dx|."""
    dy, dx = image_gradients(image)
    return torch.sum(abs_(dy) + abs_(dx))


def _integer_translate(image: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Zero-fill shift of (..., H, W, C) content by integer (+dx right,
    +dy down): out[y, x] = in[y-dy, x-dx]."""
    h, w = image.shape[-3], image.shape[-2]
    py, px = abs(dy), abs(dx)
    padded = F.pad(image, (0, 0, px, px, py, py))
    y0, x0 = py - dy, px - dx
    return padded[..., y0:y0 + h, x0:x0 + w, :]


def bilateral_tv(image: torch.Tensor, alpha: float = 0.6,
                 shift_factor: int = 2) -> torch.Tensor:
    """Bilateral TV: L1 norms of differences against integer-shifted copies,
    weighted alpha^(|h|+|v|)."""
    total = torch.zeros((), dtype=image.dtype, device=image.device)
    for dx in range(-shift_factor, shift_factor + 1):
        for dy in range(0, shift_factor + 1):
            shifted = _integer_translate(image, dx, dy)
            weight = alpha ** (abs(dx) + abs(dy))
            total = total + weight * torch.sum(abs_(image - shifted))
    return total
