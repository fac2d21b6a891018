"""Fused warp+downsample forward operator A_i(x) = D(W_i(x)) for the SR solve.

Port of the JAX package's ``ops/fused_operator.py``: the decimations are
folded into the shear chain, so the later passes work on fewer rows.

  pass A: x-shear at full resolution.
  pass B: y-shear (as a row shear of the transposed image), then the
          y-decimation: 128 rows per copy at 512 -> 128.
  pass C: x-shear at the decimated y coordinates, then the x-decimation.

Each shift is the shear kernel (``shear_warp.shear_rows_dispatch``); each
decimation is a plain float32 matrix product with the TF-bilinear matrix of
``ops/resize``. The adjoint comes from autograd: the shear Function's
backward (the shift by -s) and the matmul's transpose.
"""

from typing import Tuple

import torch

from .resize import resize_matrix
from .shear_warp import S_MAX, S_MIN, _shear_pass_x, shear_rows_dispatch


def _decimating_shear(images: torch.Tensor, s: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """Per-row fractional shift + TF-bilinear decimation along the last axis.

    images: (N, H, W) contiguous; s: (N, H); returns (N, H, out_size)."""
    w = images.shape[-1]
    shifted = shear_rows_dispatch(images, s.clamp(S_MIN, S_MAX).contiguous())
    dmat = resize_matrix(out_size, w, "bilinear", device=images.device)
    return torch.matmul(shifted, dmat.t())


def fused_warp_downsample(target: torch.Tensor, angles: torch.Tensor,
                          shifts: torch.Tensor,
                          feature_size: Tuple[int, int] = (128, 128),
                          angle_max: float = 0.35) -> torch.Tensor:
    """A_i(x): rotate+translate (tfa convention) then TF-bilinear downsample,
    per copy, with the decimations fused into the shear chain.

    target: (1, H, W, 1) or (H, W) float32; angles (N,); shifts (N, 2).
    Returns (N, h, w, 1). angle_max is accepted for parity with the
    reference and bounds nothing here.
    """
    del angle_max
    img = target if target.dim() == 2 else target[0, :, :, 0]
    h, w = img.shape
    hl, wl = feature_size
    if hl > h or wl > w:
        raise ValueError("fused operator is a downsampling operator")
    n = angles.shape[0]
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    device = img.device

    angles = angles.to(torch.float32)
    dx = shifts[:, 0].to(torch.float32)
    dy = shifts[:, 1].to(torch.float32)
    cos, sin = torch.cos(angles), torch.sin(angles)
    a = -torch.tan(angles / 2.0)
    b = sin

    tx = cos * (-dx) - sin * (-dy) + (cx - (cos * cx - sin * cy))
    ty = sin * (-dx) + cos * (-dy) + (cy - (sin * cx + cos * cy))
    off_a = tx - a * ty + a * cy      # pass A x offset (coef a on y - cy)
    off_b = ty + b * cx               # pass B y offset (coef b on x - cx)
    off_c = a * cy                    # pass C x offset (coef a on y - cy)

    # ---- pass A: x-shear at full resolution ----
    batched = img[None, :, :, None].expand(n, h, w, 1)
    i1 = _shear_pass_x(batched, a, off_a, cy)[..., 0]             # (N, H, W)

    # ---- pass B: y-shear + y-decimation, transposed to row-shift form ----
    x_coords = torch.arange(w, dtype=torch.float32, device=device)
    s_b = b[:, None] * (x_coords[None, :] - cx) + off_b[:, None]   # (N, W)
    i1_t = i1.transpose(1, 2).contiguous()                         # (N, W, H)
    i2 = _decimating_shear(i1_t, s_b, hl).transpose(1, 2)          # (N, hl, W)

    # ---- pass C: x-shear + x-decimation, the shift evaluated at the
    # decimated y sample positions (TF half-pixel mapping) ----
    ratio_y = h / hl
    yl_coords = (torch.arange(hl, dtype=torch.float32, device=device) + 0.5) \
        * ratio_y - 0.5
    s_c = a[:, None] * (yl_coords[None, :] - cy) + off_c[:, None]  # (N, hl)
    out = _decimating_shear(i2.contiguous(), s_c, wl)              # (N, hl, wl)
    return out[..., None]
