"""Fused warp+downsample forward operator A_i(x) = D(W_i(x)) for the SR solve.

Port of the JAX package's ``ops/fused_operator.py``: the decimations are
folded into the shear chain, so the later passes work on fewer rows.

  pass A: x-shear at full resolution; every copy reads the one target
          plane (a stride-0 batch), so no expanded batch is written.
  pass B: y-shear (the column kernel, no transposes), then the
          y-decimation: 128 rows per copy at 512 -> 128.
  pass C: x-shear at the decimated y coordinates, then the x-decimation.

Each shift is a shear kernel (``shear_warp.shear_rows_dispatch`` and
``shear_cols_dispatch``); each decimation is a plain float32 matrix product
with the TF-bilinear matrix of ``ops/resize``, from the left over H and from
the right over W. The adjoint comes from autograd: the shear Function's
backward (the shift by -s) and the matmul's transpose.
"""

from typing import Tuple

import torch

from .resize import resize_matrix
from .shear_warp import pass_shifts, shear_cols_dispatch, shear_rows_dispatch

# Kernel launches of one application of the operator (passes A, B, C); its
# adjoint through autograd launches the same again.
OPERATOR_LAUNCHES = {"shear_rows": 2, "shear_cols": 1}


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
    # One plane; a no-op unless the caller's target is a strided view.
    img = (target if target.dim() == 2 else target[0, :, :, 0]).contiguous()
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

    # ---- pass A: x-shear at full resolution, one plane read by all copies ----
    i1 = shear_rows_dispatch(img[None].expand(n, h, w),
                             pass_shifts(a, off_a, cy, h))          # (N, H, W)

    # ---- pass B: y-shear, then the y-decimation from the left ----
    i1 = shear_cols_dispatch(i1, pass_shifts(b, off_b, cx, w))
    i2 = torch.matmul(resize_matrix(hl, h, "bilinear", device=device), i1)  # (N, hl, W)

    # ---- pass C: x-shear + x-decimation, the shift evaluated at the
    # decimated y sample positions (TF half-pixel mapping) ----
    ratio_y = h / hl
    yl_coords = (torch.arange(hl, dtype=torch.float32, device=device) + 0.5) \
        * ratio_y - 0.5
    s_c = a[:, None] * (yl_coords[None, :] - cy) + off_c[:, None]  # (N, hl)
    i3 = shear_rows_dispatch(i2, s_c)
    out = torch.matmul(i3, resize_matrix(wl, w, "bilinear", device=device).t())
    return out[..., None]                                          # (N, hl, wl, 1)
