"""Fused warp+downsample forward operator A_i(x) = D(W_i(x)) for the SR solve.

Port of the JAX package's ``ops/fused_operator.py``: the decimations are
folded into the shear chain, so the later passes work on fewer rows.

  pass A: x-shear at full resolution; every copy reads the target planes
          (a stride-0 batch), so no expanded batch is written.
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
from .shear_warp import (paeth_coefficients, pass_shifts, shear_cols_dispatch,
                         shear_rows_dispatch)

# Kernel launches of one application of the operator (passes A, B, C), for
# one target plane or K; its adjoint through autograd launches the same again.
OPERATOR_LAUNCHES = {"shear_rows": 2, "shear_cols": 1}


def target_planes(target: torch.Tensor) -> torch.Tensor:
    """(H, W), (K, H, W) or (1, H, W, K) -> contiguous (K, H, W) planes (a
    no-op for (H, W), (1, H, W, 1) and (K, H, W) unless the caller's tensor
    is a strided view)."""
    if target.dim() == 2:
        return target[None].contiguous()
    if target.dim() == 3:
        return target.contiguous()
    if target.dim() == 4 and target.shape[0] == 1:
        return target[0].permute(2, 0, 1).contiguous()
    raise ValueError("target must be (H, W), (K, H, W) or (1, H, W, K), got "
                     f"shape {tuple(target.shape)}")


def fused_warp_downsample(target: torch.Tensor, angles: torch.Tensor,
                          shifts: torch.Tensor,
                          feature_size: Tuple[int, int] = (128, 128),
                          angle_max: float = 0.35) -> torch.Tensor:
    """A_i(x): rotate+translate (tfa convention) then TF-bilinear downsample,
    per copy, with the decimations fused into the shear chain.

    target: one plane, (H, W) or (1, H, W, 1), or K planes, (K, H, W) or
    (1, H, W, K), float32; angles (N,); shifts (N, 2). Returns (N, h, w, K)
    (K = 1 for one plane): copy i of every plane is warped by (angles[i],
    shifts[i]). The K planes ride the kernels' channel axis, so K adds no
    launches. angle_max is accepted for parity with the reference and bounds
    nothing here.
    """
    del angle_max
    img = target_planes(target)                                    # (K, H, W)
    k, h, w = img.shape
    hl, wl = feature_size
    if hl > h or wl > w:
        raise ValueError("fused operator is a downsampling operator")
    n = angles.shape[0]
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    device = img.device
    a, off_a, b, off_b, off_c = paeth_coefficients(angles, shifts, h, w)

    # ---- pass A: x-shear at full resolution, the planes read by all copies ----
    i1 = shear_rows_dispatch(img[None].expand(n, k, h, w),
                             pass_shifts(a, off_a, cy, h))          # (N, K, H, W)

    # ---- pass B: y-shear, then the y-decimation from the left ----
    i1 = shear_cols_dispatch(i1, pass_shifts(b, off_b, cx, w))
    i2 = torch.matmul(resize_matrix(hl, h, "bilinear", device=device), i1)  # (N, K, hl, W)

    # ---- pass C: x-shear + x-decimation, the shift evaluated at the
    # decimated y sample positions (TF half-pixel mapping) ----
    ratio_y = h / hl
    yl_coords = (torch.arange(hl, dtype=torch.float32, device=device) + 0.5) \
        * ratio_y - 0.5
    s_c = a[:, None] * (yl_coords[None, :] - cy) + off_c[:, None]  # (N, hl)
    i3 = shear_rows_dispatch(i2, s_c)
    out = torch.matmul(i3, resize_matrix(wl, w, "bilinear", device=device).t())
    return out.permute(0, 2, 3, 1)                                 # (N, hl, wl, K)
