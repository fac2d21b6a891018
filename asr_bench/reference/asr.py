"""Plain PyTorch ASR mathematics, float32: the benchmark's reference for
every layer that ``serve`` runs after the network.

Written from the method (augmented super-resolution of segmentation masks)
and imports nothing of the program. The operator is explicit: each copy is
the high-resolution estimate rotated about the image centre and shifted,
one bilinear resample with zero fill (``F.grid_sample``), then the TF2
half-pixel bilinear downsample to the network's feature size; its adjoint
is autograd's. No Gram stencil.

  copies:     warp(image, angle_n, shift_n), n = 0..N-1 (copy 0 the identity)
  masks:      y_n = [argmax of the copy's logits == class], the stack
              min-max normalised to [0, 1] (``check.normalize``)
  aug:        300 AMSGrad steps (optax semantics, lr decayed x rate every
              decay_steps, not staircase) from the bilinear upsample of y_0 on
              lambda_df sum |A_n x - y_n|^2 + lambda_tv TV(x) + lambda_L2 |x|^2,
              TV anisotropic with d|t|/dt = 1 at t = 0
  max, mean:  the copies' upsampled masks warped back, max or mean over n
  threshold:  1 where a plane exceeds th_factor x its maximum
  standard:   the upsampled logits of copy 0, argmax == class
  label map:  per pixel the class whose aug estimate, over its own peak, is
              highest, where that exceeds th_factor; else 0
"""

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .deeplab import resize_matrix


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """TF2 half-pixel bilinear resize of the last two axes."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    mh = resize_matrix(int(size[0]), x.shape[-2], x.device)
    mw = resize_matrix(int(size[1]), x.shape[-1], x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


def _grid(angles, shifts, h: int, w: int, inverse: bool) -> torch.Tensor:
    """(N, H, W, 2) sampling grid. Forward: output p reads the input at
    R (p - d - c) + c, R the counter-clockwise rotation by the angle, c the
    centre, d the shift (content moves by +d). Inverse: R^T (p - c) + c + d."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    dx, dy = shifts[:, 0, None, None], shifts[:, 1, None, None]
    y = torch.arange(h, dtype=torch.float32, device=angles.device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=angles.device)[None, None, :]
    if inverse:
        u, v = x - cx, y - cy
        x_in = cos * u + sin * v + cx + dx
        y_in = -sin * u + cos * v + cy + dy
    else:
        u, v = x - dx - cx, y - dy - cy
        x_in = cos * u - sin * v + cx
        y_in = sin * u + cos * v + cy
    return torch.stack([2.0 * x_in / (w - 1) - 1.0, 2.0 * y_in / (h - 1) - 1.0], dim=-1)


def warp(planes: torch.Tensor, angles: torch.Tensor, shifts: torch.Tensor,
         inverse: bool = False) -> torch.Tensor:
    """(N, C, H, W) planes, copy n warped by (angles[n], shifts[n]) (or its
    inverse), bilinear, each tap outside the image read as 0."""
    n, _, h, w = planes.shape
    grid = _grid(angles.float(), shifts.float(), h, w, inverse).expand(n, h, w, 2)
    return F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def operator(x: torch.Tensor, angles, shifts, feature_size) -> torch.Tensor:
    """A: (K, H, W) estimates -> (N, K, h, w), every copy's warp then downsample."""
    n = angles.shape[0]
    return resize(warp(x[None].expand(n, *x.shape), angles, shifts), feature_size)


def _abs(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, t, -t)


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """sum |x[i+1, j] - x[i, j]| + |x[i, j+1] - x[i, j]| over (K, H, W)."""
    return _abs(x[:, 1:] - x[:, :-1]).sum() + _abs(x[:, :, 1:] - x[:, :, :-1]).sum()


def aug_solve(masks: torch.Tensor, angles, shifts, asr: dict, output_size) -> torch.Tensor:
    """(K, N, h, w) normalised masks -> (K, H, W) estimates: the K problems
    solved side by side (they do not couple)."""
    feature_size = masks.shape[-2:]
    x = resize(masks[:, 0], output_size).clone()
    y = masks.transpose(0, 1)
    opt = asr["optimizer"]
    b1, b2, eps = opt["beta_1"], opt["beta_2"], opt["epsilon"]
    mu, nu, nu_max = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    for step in range(asr["num_iter"]):
        z = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = (asr["lambda_df"] * torch.square(operator(z, angles, shifts, feature_size)
                                                    - y).sum()
                    + asr["lambda_tv"] * total_variation(z)
                    + asr["lambda_L2"] * torch.square(z).sum())
            (g,) = torch.autograd.grad(loss, z)
        t = step + 1
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        nu_max = torch.maximum(nu_max, nu / float(1 - np.float32(b2) ** np.float32(t)))
        mu_hat = mu / float(1 - np.float32(b1) ** np.float32(t))
        lr = opt["learning_rate"] * opt["decay_rate"] ** (step / opt["decay_steps"])
        x = x - lr * mu_hat / (torch.sqrt(nu_max) + eps)
    return x


def max_mean(masks: torch.Tensor, angles, shifts, output_size
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N, h, w) masks -> ((K, H, W) max, (K, H, W) mean) of the copies
    upsampled and warped back."""
    up = warp(resize(masks, output_size).transpose(0, 1), angles, shifts, inverse=True)
    return up.amax(dim=0), up.mean(dim=0)


def threshold(target: torch.Tensor, th_factor: float) -> torch.Tensor:
    """(K, H, W) -> (K, H, W) bool, per plane above th_factor x its maximum."""
    return target > target.amax(dim=(-2, -1), keepdim=True) * th_factor


def label_map(aug: torch.Tensor, class_ids: Sequence[int], th_factor: float) -> torch.Tensor:
    """(K, H, W) aug estimates -> (H, W) class ids (0 where none is above)."""
    score = aug / torch.clamp_min(aug.amax(dim=(-2, -1), keepdim=True), 1e-12)
    best, idx = score.max(dim=0)
    ids = torch.as_tensor(class_ids, device=aug.device)
    return torch.where(best > th_factor, ids[idx], 0)
