"""Affine warp (rotation + translation) as three shear passes.

Port of the JAX package's ``ops/shear_warp.py``:

  R(theta) = Sx(-tan(theta/2)) . Sy(sin theta) . Sx(-tan(theta/2))   (Paeth)

with the translation folded into the shear offsets. The x passes shift every
row by its own fractional amount (``shear_rows``), the y pass every column
(``shear_cols``), each with a 2-tap lerp and zero fill. The adjoint of such a
shift is the shift by -s, so the backward pass is the same operation.

On a CUDA tensor the shifts run the hand-written kernels
(``ops/shear_kernel.py``); on a CPU tensor they run ``shear_rows`` and
``shear_cols``, the plain PyTorch versions below. The warp folds the channels
into planes once, (N, H, W, C) -> (N, C, H, W), keeps that layout through the
three passes and permutes back once; a batch that is an ``expand`` of one
image is handed to the first pass as it is (stride 0 over the copies), never
copied. The GPU gathers directly, so none of the TPU's static tap windows
exist here: ``angle_max`` stays in the public signatures for parity with the
reference and sizes nothing.
"""

import math

import torch

from .shear_kernel import check_args, shear_cols_cuda, shear_rows_cuda

# |shift| clip, as the reference's XLA path (shear_warp.py: s clipped to
# [-_PAD + 1, _PAD - 2]).
S_MIN, S_MAX = -255.0, 254.0

# Kernel launches of one warp: two x passes and one y pass, whatever the
# number of channels (they ride along as planes).
WARP_LAUNCHES = {"shear_rows": 2, "shear_cols": 1}


def shear_rows(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of the row kernel: out[n, y, x] = (1 - t) in[n, y, x + f]
    + t in[n, y, x + f + 1], f = floor(s), t = s - f, s clipped to
    [-255, 254], zero fill, the blend in float32, the output in the input
    dtype.

    images: (N, H, W) or (N, C, H, W) float32/bfloat16; s: (N, H) float32,
    shared by the C planes of a copy."""
    w = images.shape[-1]
    s = s.clamp(S_MIN, S_MAX)
    if images.dim() == 4:
        s = s[:, None]
    f = torch.floor(s)
    t = (s - f)[..., None]
    idx = torch.arange(w, device=images.device) + f.to(torch.int64)[..., None]
    src = images.float()

    def tap(i):
        valid = (i >= 0) & (i < w)
        return torch.gather(src, -1, i.clamp(0, w - 1).expand(src.shape)) * valid

    return ((1.0 - t) * tap(idx) + t * tap(idx + 1)).to(images.dtype)


def shear_cols(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of the column kernel: out[n, y, x] = (1 - t) in[n, y + f, x]
    + t in[n, y + f + 1, x] with f, t from s[n, x]: the row shear of the
    transposed planes. images: (N, H, W) or (N, C, H, W); s: (N, W)."""
    return shear_rows(images.transpose(-1, -2), s).transpose(-1, -2).contiguous()


_PLAIN = {"rows": shear_rows, "cols": shear_cols}
_KERNEL = {"rows": shear_rows_cuda, "cols": shear_cols_cuda}


def _shear_on_device(axis: str, images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if images.device.type == "cuda":
        return _KERNEL[axis](images, s)  # checks its arguments itself
    if images.device.type == "cpu":
        check_args(images, s, axis)
        return _PLAIN[axis](images, s)
    raise ValueError(f"no shear implementation for device {images.device}")


def _planes_contiguous(t: torch.Tensor) -> bool:
    h, w = t.shape[-2:]
    return (w <= 1 or t.stride(-1) == 1) and (h <= 1 or t.stride(-2) == w)


class _Shear(torch.autograd.Function):
    """Differentiable in the images; s gets no gradient. Backward = the same
    shift with -s (the exact adjoint of a 2-tap shift along one axis). The
    gradient is dense over the copies: for an ``expand``ed input, autograd's
    own expand backward sums it, outside the kernel."""

    @staticmethod
    def forward(ctx, images, s, axis):
        ctx.save_for_backward(s)
        ctx.axis = axis
        return _shear_on_device(axis, images, s)

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        if not _planes_contiguous(grad):
            grad = grad.contiguous()
        return _shear_on_device(ctx.axis, grad, -s), None, None


def shear_rows_dispatch(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-row fractional x-shift of (N, H, W) or (N, C, H, W) images by
    s (N, H): the CUDA kernel for CUDA tensors, ``shear_rows`` for CPU
    tensors. The (H, W) planes must be contiguous; the strides over N and C
    are free (0 for an ``expand``ed batch). Differentiable in images; s is
    treated as a constant."""
    return _Shear.apply(images, s.detach(), "rows")


def shear_cols_dispatch(images: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-column fractional y-shift by s (N, W): ``shear_rows_dispatch``'s
    counterpart along H, with the same layouts and rules."""
    return _Shear.apply(images, s.detach(), "cols")


def pass_shifts(coef: torch.Tensor, offset: torch.Tensor, center: float,
                length: int, interpolation: str = "bilinear") -> torch.Tensor:
    """s[n, i] = coef[n] * (i - center) + offset[n] for i in [0, length): the
    shifts of one shear pass, per row (x pass) or per column (y pass).

    interpolation="nearest" rounds each shift to an integer, so the lerp
    selects exactly one tap and output values are a subset of the input
    values (label images)."""
    if interpolation not in ("bilinear", "nearest"):
        raise ValueError(f"interpolation must be bilinear or nearest, got {interpolation!r}")
    i = torch.arange(length, dtype=torch.float32, device=coef.device)
    s = coef[:, None] * (i[None, :] - center) + offset[:, None]
    return torch.round(s) if interpolation == "nearest" else s


def _to_planes(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, H, W) with contiguous (H, W) planes. A batch that
    repeats one image (stride 0 over N) stays one image's planes, expanded."""
    n = images.shape[0]
    if n > 1 and images.stride(0) == 0:
        return images[0].permute(2, 0, 1).contiguous()[None].expand(n, -1, -1, -1)
    return images.permute(0, 3, 1, 2).contiguous()


def shear_taps(angle_max: float, size: int) -> int:
    """Bound on a shear pass's row-to-row shift variation for
    |angle| <= angle_max on a size-px axis (the reference's static span)."""
    coef = max(abs(math.tan(angle_max / 2.0)), abs(math.sin(angle_max)))
    return int(math.ceil(coef * size)) + 3


def paeth_coefficients(angles: torch.Tensor, shifts: torch.Tensor, h: int, w: int):
    """(a, off_a, b, off_b, off_c) of the three passes of rotate(angles) then
    translate(shifts) about the centre of an (h, w) plane."""
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
    return a, tx - a * ty + a * cy, b, ty + b * cx, a * cy


def paeth_planes(planes: torch.Tensor, angles: torch.Tensor, shifts: torch.Tensor,
                 interpolation: str = "bilinear") -> torch.Tensor:
    """The three shear passes on an (N, C, H, W) view whose (H, W) planes are
    contiguous (any stride over N and C, 0 included): copy n's C planes share
    its angle and shift. Returns a dense (N, C, H, W) tensor. Three kernel
    launches on the card (``WARP_LAUNCHES``), whatever C is."""
    h, w = planes.shape[-2:]
    a, off_a, b, off_b, off_c = paeth_coefficients(angles, shifts, h, w)
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    out = shear_rows_dispatch(planes, pass_shifts(a, off_a, cy, h, interpolation))
    out = shear_cols_dispatch(out, pass_shifts(b, off_b, cx, w, interpolation))
    return shear_rows_dispatch(out, pass_shifts(a, off_c, cy, h, interpolation))


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
    out = paeth_planes(_to_planes(images), angles, shifts, interpolation)
    out = out.permute(0, 2, 3, 1)
    return out[..., 0] if squeeze else out


def inverse_shifts(angles: torch.Tensor, shifts: torch.Tensor):
    """(angles, shifts) of the inverse warp: translate(-shifts) then
    rotate(-angles) is rotate(-angles) then translate(-R(angles) shifts)."""
    angles = angles.to(torch.float32)
    shifts = shifts.to(torch.float32)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    dx, dy = shifts[:, 0], shifts[:, 1]
    rot_d = torch.stack([cos * dx - sin * dy, sin * dx + cos * dy], dim=-1)
    return -angles, -rot_d


def paeth_inverse_rotate_translate(images: torch.Tensor, angles: torch.Tensor,
                                   shifts: torch.Tensor, angle_max: float = 0.35,
                                   interpolation: str = "bilinear") -> torch.Tensor:
    """Inverse warp: translate(-shifts) then rotate(-angles), composed into one
    3-shear chain as rotate(-angles) then translate(-R(angles) shifts)."""
    inv_angles, inv_shifts = inverse_shifts(angles, shifts)
    return paeth_rotate_translate(images, inv_angles, inv_shifts, angle_max,
                                  interpolation)
