"""Affine warp (rotation + translation) as three shear passes.

Port of the JAX package's ``ops/shear_warp.py``:

  R(theta) = Sx(-tan(theta/2)) . Sy(sin theta) . Sx(-tan(theta/2))   (Paeth)

with the translation folded into the shear offsets. Each pass shifts every
row (or, for the y pass, every column) by its own fractional amount with a
2-tap lerp and zero fill: ``shear_rows``. The adjoint of that shift is the
shift by -s, so the backward pass is the same operation.

On a CUDA tensor the shift runs the hand-written kernel
(``ops/shear_kernel.py``); on a CPU tensor it runs ``shear_rows``, the plain
PyTorch version below. The GPU gathers directly, so none of the TPU's static
tap windows exist here: ``angle_max`` stays in the public signatures for
parity with the reference and sizes nothing.
"""

import math

import torch

from .shear_kernel import check_args, shear_rows_cuda

# |shift| clip, as the reference's XLA path (shear_warp.py: s clipped to
# [-_PAD + 1, _PAD - 2]).
S_MIN, S_MAX = -255.0, 254.0


def shear_rows(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: out[n, y, x] = (1 - t) in[n, y, x + f] +
    t in[n, y, x + f + 1], f = floor(s), t = s - f, s clipped to [-255, 254],
    zero fill, the blend in float32, the output in the input dtype.

    images: (N, H, W) float32/bfloat16; s: (N, H) float32."""
    n, h, w = images.shape
    s = s.clamp(S_MIN, S_MAX)
    f = torch.floor(s)
    t = (s - f)[..., None]
    idx = torch.arange(w, device=images.device) + f.to(torch.int64)[..., None]
    src = images.float()

    def tap(i):
        valid = (i >= 0) & (i < w)
        return torch.gather(src, 2, i.clamp(0, w - 1)) * valid

    return ((1.0 - t) * tap(idx) + t * tap(idx + 1)).to(images.dtype)


def _shear_rows_on_device(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if images.device.type == "cuda":
        return shear_rows_cuda(images, s)  # checks its arguments itself
    if images.device.type == "cpu":
        check_args(images, s)
        return shear_rows(images, s)
    raise ValueError(f"no shear implementation for device {images.device}")


class ShearRows(torch.autograd.Function):
    """Differentiable in the images; s gets no gradient. Backward = the same
    shift with -s (the exact adjoint of a per-row 2-tap shift)."""

    @staticmethod
    def forward(ctx, images, s):
        ctx.save_for_backward(s)
        return _shear_rows_on_device(images, s)

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        return _shear_rows_on_device(grad.contiguous(), -s), None


def shear_rows_dispatch(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-row fractional x-shift of contiguous (N, H, W) images by s (N, H):
    the CUDA kernel for CUDA tensors, ``shear_rows`` for CPU tensors.
    Differentiable in images; s is treated as a constant."""
    return ShearRows.apply(images, s.detach())


def _shear_pass_x(images: torch.Tensor, coef: torch.Tensor, offset: torch.Tensor,
                  center: float, interpolation: str = "bilinear") -> torch.Tensor:
    """Row shift s(n, y) = coef[n] * (y - center) + offset[n] of (N, H, W, C).

    interpolation="nearest" rounds each row's shift to an integer, so the
    lerp selects exactly one tap and output values are a subset of the input
    values (label images). Channels fold into the batch axis."""
    if interpolation not in ("bilinear", "nearest"):
        raise ValueError(f"interpolation must be bilinear or nearest, got {interpolation!r}")
    n, h, w, c = images.shape
    y = torch.arange(h, dtype=torch.float32, device=images.device)
    s = coef[:, None] * (y[None, :] - center) + offset[:, None]
    if interpolation == "nearest":
        s = torch.round(s)
    flat = images.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
    s_rep = s.repeat_interleave(c, dim=0) if c > 1 else s
    out = shear_rows_dispatch(flat, s_rep.contiguous())
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _shear_pass_y(images: torch.Tensor, coef: torch.Tensor, offset: torch.Tensor,
                  center: float, interpolation: str = "bilinear") -> torch.Tensor:
    out = _shear_pass_x(images.transpose(1, 2), coef, offset, center,
                        interpolation)
    return out.transpose(1, 2)


SHEAR_PASSES = 3  # kernel launches per warp (channels ride the batch axis)


def shear_taps(angle_max: float, size: int) -> int:
    """Bound on a shear pass's row-to-row shift variation for
    |angle| <= angle_max on a size-px axis (the reference's static span)."""
    coef = max(abs(math.tan(angle_max / 2.0)), abs(math.sin(angle_max)))
    return int(math.ceil(coef * size)) + 3


def paeth_rotate_translate(images: torch.Tensor, angles: torch.Tensor,
                           shifts: torch.Tensor, angle_max: float = 0.35,
                           interpolation: str = "bilinear") -> torch.Tensor:
    """tfa-style rotate(angles) followed by translate(shifts), as shears.

    images: (N, H, W) or (N, H, W, C); angles (N,) rad CCW; shifts (N, 2) as
    (dx, dy) pixels. angle_max is accepted for parity with the reference and
    bounds nothing here. interpolation="nearest" rounds each pass's row shift
    (label images: output values are a subset of the input's plus 0).
    Returns a tensor of the input's shape and dtype.
    """
    del angle_max
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    n, h, w = images.shape[:3]
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0

    angles = angles.to(torch.float32)
    dx = shifts[:, 0].to(torch.float32)
    dy = shifts[:, 1].to(torch.float32)

    cos = torch.cos(angles)
    sin = torch.sin(angles)
    a = -torch.tan(angles / 2.0)    # x-shear coefficient (both passes)
    b = sin                          # y-shear coefficient

    # Composite output -> input map of rotate-about-center then translate:
    # p_in = R @ (p_out - d - c) + c, R = [[cos, -sin], [sin, cos]].
    tx = cos * (-dx) - sin * (-dy) + (cx - (cos * cx - sin * cy))
    ty = sin * (-dx) + cos * (-dy) + (cy - (sin * cx + cos * cy))
    off_a = tx - a * ty + a * cy
    off_b = ty + b * cx
    off_c = a * cy

    out = _shear_pass_x(images, a, off_a, cy, interpolation)
    out = _shear_pass_y(out, b, off_b, cx, interpolation)
    out = _shear_pass_x(out, a, off_c, cy, interpolation)
    return out[..., 0] if squeeze else out


def paeth_inverse_rotate_translate(images: torch.Tensor, angles: torch.Tensor,
                                   shifts: torch.Tensor, angle_max: float = 0.35,
                                   interpolation: str = "bilinear") -> torch.Tensor:
    """Inverse warp: translate(-shifts) then rotate(-angles), composed into one
    3-shear chain as rotate(-angles) then translate(-R(angles) shifts)."""
    angles = angles.to(torch.float32)
    shifts = shifts.to(torch.float32)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    dx, dy = shifts[:, 0], shifts[:, 1]
    rot_d = torch.stack([cos * dx - sin * dy, sin * dx + cos * dy], dim=-1)
    return paeth_rotate_translate(images, -angles, -rot_d, angle_max,
                                  interpolation)
