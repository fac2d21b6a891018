"""Affine image warps with tfa.image.{rotate,translate} semantics, by gathers.

Port of the JAX package's ``ops/warp.py``: the exact reference of the
reference's two-pass ``tfa.image.rotate`` then ``tfa.image.translate`` (TF's
``ImageProjectiveTransformV3``). For every output pixel (x, y) the projective
transform [a0 a1 a2; b0 b1 b2; c0 c1 1] gives the input sampling point,
which is read bilinearly (or nearest) with a constant fill for any
neighbour outside the image. The serving path warps through the shear
kernels (``shear_warp.py``); this module is the path of strict parity
(``warp_impl="gather"``).

The JAX file is XLA gathers, so plain PyTorch is the port on both devices,
in the order of the JAX arithmetic: the output grid from an iota, the
projective divide, floor, four reads with a per-tap validity mask and
fill, a lerp in x, then in y. Bilinear blends with float32 weights, so a
bfloat16 image gives a float32 warp, as JAX's type promotion does; nearest
keeps the image's dtype and rounds half to even (``torch.round``, as
``jnp.round``).

The gradient (in the images; the transforms are constants) scatter-adds the
four taps' weighted cotangents, accumulated in float32 and returned in the
image's dtype. On a CUDA tensor the scatter-add uses atomics, so its sums
land in a run-dependent order and the gradient varies from run to run in
its last float32 bits. Both directions walk the copies in chunks of at most
CHUNK_ELEMENTS gathered values, the backward recomputing the taps, so the
index tensors' peak stays bounded whatever the number of copies.

Transform convention (identical to TF):
  x_in = (a0 * x_out + a1 * y_out + a2) / (c0 * x_out + c1 * y_out + 1)
  y_in = (b0 * x_out + b1 * y_out + b2) / (c0 * x_out + c1 * y_out + 1)
with transforms packed as length-8 vectors [a0,a1,a2,b0,b1,b2,c0,c1].
"""

from typing import List, Optional, Tuple

import torch

# Gathered values (copies x planes x output pixels) per chunk: 32 copies of
# one 512 x 512 plane, whose int64 tap index takes 64 MB.
CHUNK_ELEMENTS = 1 << 23
INTERPOLATIONS = ("bilinear", "nearest")


def rotation_transform(angles, image_height: int, image_width: int) -> torch.Tensor:
    """(N, 8) projective transforms of a counterclockwise rotation by angles
    (rad) about the image centre (tfa.image.angles_to_projective_transforms)."""
    angles = torch.atleast_1d(torch.as_tensor(angles, dtype=torch.float32))
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    w = image_width - 1.0
    h = image_height - 1.0
    x_offset = (w - (cos * w - sin * h)) / 2.0
    y_offset = (h - (sin * w + cos * h)) / 2.0
    zeros = torch.zeros_like(cos)
    return torch.stack([cos, -sin, x_offset, sin, cos, y_offset, zeros, zeros], dim=-1)


def translation_transform(translations) -> torch.Tensor:
    """(N, 8) transforms shifting content by (dx, dy) pixels (tfa.image.translate)."""
    t = torch.atleast_2d(torch.as_tensor(translations, dtype=torch.float32))
    dx, dy = t[..., 0], t[..., 1]
    ones = torch.ones_like(dx)
    zeros = torch.zeros_like(dx)
    return torch.stack([ones, zeros, -dx, zeros, ones, -dy, zeros, zeros], dim=-1)


def compose_transforms(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """The transform of applying ``first`` then ``second`` to an image: output
    coordinates go through ``second`` then ``first`` (M_first @ M_second)."""
    def to_mat(t):
        full = torch.cat([t, torch.ones_like(t[..., :1])], dim=-1)
        return full.reshape(t.shape[:-1] + (3, 3))

    m = to_mat(first) @ to_mat(second)
    m = m / m[..., 2:3, 2:3]
    return m.reshape(m.shape[:-2] + (9,))[..., :8]


def _sample_points(transforms: torch.Tensor, out_h: int, out_w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input coordinates (x_in, y_in), each (n, out_h, out_w), of every
    output pixel under each of the n transforms."""
    yy = torch.arange(out_h, dtype=torch.float32, device=transforms.device)[:, None]
    xx = torch.arange(out_w, dtype=torch.float32, device=transforms.device)[None, :]
    a0, a1, a2, b0, b1, b2, c0, c1 = transforms[:, :, None, None].unbind(1)
    denom = c0 * xx + c1 * yy + 1.0
    x_in = (a0 * xx + a1 * yy + a2) / denom
    y_in = (b0 * xx + b1 * yy + b2) / denom
    return x_in, y_in


def _tap(ix: torch.Tensor, iy: torch.Tensor, h: int, w: int):
    """(flat index into an (h, w) plane, validity) of the pixels (ix, iy),
    each (n, P): a neighbour outside the image reads the fill value."""
    valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    flat = (torch.clamp(iy, 0, h - 1).to(torch.int64) * w
            + torch.clamp(ix, 0, w - 1).to(torch.int64))
    return flat, valid


def _taps(transforms: torch.Tensor, h: int, w: int, out_h: int, out_w: int,
          interpolation: str):
    """The taps of n transforms: [(flat index (n, P), validity (n, P))] and the
    bilinear fractions (fx, fy), each (n, 1, P), None for nearest."""
    n = transforms.shape[0]
    x, y = (c.reshape(n, -1) for c in _sample_points(transforms, out_h, out_w))
    if interpolation == "nearest":
        return [_tap(torch.round(x), torch.round(y), h, w)], None
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fractions = ((x - x0)[:, None], (y - y0)[:, None])
    taps = [_tap(x0, y0, h, w), _tap(x0 + 1, y0, h, w),
            _tap(x0, y0 + 1, h, w), _tap(x0 + 1, y0 + 1, h, w)]
    return taps, fractions


def _chunks(n: int, planes: int, pixels: int) -> List[slice]:
    step = max(1, CHUNK_ELEMENTS // max(planes * pixels, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _forward(images: torch.Tensor, transforms: torch.Tensor, out_h: int, out_w: int,
             interpolation: str, fill_value: float) -> torch.Tensor:
    n, c, h, w = images.shape
    dtype = images.dtype
    if interpolation == "bilinear":
        dtype = torch.promote_types(dtype, torch.float32)
    out = torch.empty((n, c, out_h * out_w), dtype=dtype, device=images.device)
    for part in _chunks(n, c, out_h * out_w):
        src = images[part].reshape(-1, c, h * w)
        taps, fractions = _taps(transforms[part], h, w, out_h, out_w, interpolation)
        m = src.shape[0]
        vals = [torch.where(valid[:, None],
                            torch.gather(src, 2, flat[:, None].expand(m, c, -1)),
                            fill_value)
                for flat, valid in taps]
        if fractions is None:
            out[part] = vals[0]
            continue
        fx, fy = fractions
        v00, v01, v10, v11 = vals
        top = v00 * (1.0 - fx) + v01 * fx
        bot = v10 * (1.0 - fx) + v11 * fx
        out[part] = top * (1.0 - fy) + bot * fy
    return out.view(n, c, out_h, out_w)


def _backward(grad: torch.Tensor, transforms: torch.Tensor, shape, dtype,
              interpolation: str) -> torch.Tensor:
    """The images' gradient: each tap's cotangent (where the tap is valid)
    scatter-added in float32 at the pixel it read."""
    n, c, h, w = shape
    out_h, out_w = grad.shape[-2:]
    grad_in = torch.zeros((n, c, h * w), dtype=torch.float32, device=grad.device)
    for part in _chunks(n, c, out_h * out_w):
        g = grad[part].reshape(-1, c, out_h * out_w).float()
        taps, fractions = _taps(transforms[part], h, w, out_h, out_w, interpolation)
        if fractions is None:
            cotangents = [g]
        else:
            fx, fy = fractions
            g_top = g * (1.0 - fy)
            g_bot = g * fy
            cotangents = [g_top * (1.0 - fx), g_top * fx, g_bot * (1.0 - fx), g_bot * fx]
        target = grad_in[part]
        m = target.shape[0]
        for (flat, valid), ct in zip(taps, cotangents):
            target.scatter_add_(2, flat[:, None].expand(m, c, -1),
                                torch.where(valid[:, None], ct, 0.0))
    return grad_in.view(n, c, h, w).to(dtype)


class _GatherWarp(torch.autograd.Function):
    """Differentiable in the images; the transforms get no gradient."""

    @staticmethod
    def forward(ctx, images, transforms, out_h, out_w, interpolation, fill_value):
        ctx.save_for_backward(transforms)
        ctx.meta = (tuple(images.shape), images.dtype, interpolation)
        return _forward(images, transforms, out_h, out_w, interpolation, fill_value)

    @staticmethod
    def backward(ctx, grad):
        (transforms,) = ctx.saved_tensors
        shape, dtype, interpolation = ctx.meta
        return _backward(grad, transforms, shape, dtype, interpolation), \
            None, None, None, None, None


def warp_planes(planes: torch.Tensor, transforms, interpolation: str = "bilinear",
                fill_value: float = 0.0,
                output_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``affine_warp`` of an (N, C, H, W) stack: copy n's C planes share
    transform n (a single transform broadcasts over N). Any strides, 0
    included (an ``expand``ed batch is read, not copied). Returns a dense
    (N, C, out_h, out_w) tensor: float32 (or wider) for bilinear, the input's
    dtype for nearest."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"Unsupported interpolation: {interpolation!r}")
    n = planes.shape[0]
    transforms = torch.atleast_2d(torch.as_tensor(transforms, dtype=torch.float32,
                                                  device=planes.device))
    if transforms.shape[0] == 1 and n != 1:
        transforms = transforms.expand(n, 8)
    out_h, out_w = output_shape or planes.shape[-2:]
    return _GatherWarp.apply(planes, transforms.detach(), int(out_h), int(out_w),
                             interpolation, float(fill_value))


def affine_warp(images: torch.Tensor, transforms, interpolation: str = "bilinear",
                fill_value: float = 0.0, output_shape=None) -> torch.Tensor:
    """Batched projective warp matching TF ImageProjectiveTransformV3.

    images: (B, H, W, C) or (H, W, C); transforms: (B, 8) or (8,) (a single
    transform broadcasts over the batch); interpolation "bilinear" or
    "nearest"; fill_value for out-of-image samples; output_shape an optional
    (out_h, out_w), the input's size by default. Returns (B, out_h, out_w, C)
    (or (out_h, out_w, C)), a view of a dense (B, C, out_h, out_w) tensor."""
    single = images.dim() == 3
    if single:
        images = images[None]
    out = warp_planes(images.permute(0, 3, 1, 2), transforms, interpolation,
                      fill_value, output_shape).permute(0, 2, 3, 1)
    return out[0] if single else out


def rotate(images: torch.Tensor, angles, interpolation: str = "bilinear",
           fill_value: float = 0.0) -> torch.Tensor:
    """tfa.image.rotate: CCW rotation about the centre, constant fill."""
    h, w = images.shape[-3], images.shape[-2]
    return affine_warp(images, rotation_transform(angles, h, w),
                       interpolation=interpolation, fill_value=fill_value)


def translate(images: torch.Tensor, translations, interpolation: str = "bilinear",
              fill_value: float = 0.0) -> torch.Tensor:
    """tfa.image.translate: shift content by (dx, dy), constant fill."""
    return affine_warp(images, translation_transform(translations),
                       interpolation=interpolation, fill_value=fill_value)


def rotate_translate_fused(images: torch.Tensor, angles, shifts,
                           interpolation: str = "bilinear",
                           fill_value: float = 0.0) -> torch.Tensor:
    """Rotate-then-translate in a single resample (the two transforms
    composed): less lossy than the two-pass reference path and not equal to
    it; use rotate() then translate() for parity."""
    h, w = images.shape[-3], images.shape[-2]
    composed = compose_transforms(rotation_transform(angles, h, w),
                                  translation_transform(shifts))
    return affine_warp(images, composed, interpolation=interpolation,
                       fill_value=fill_value)


def rotate_translate_planes(planes: torch.Tensor, angles: torch.Tensor,
                            shifts: torch.Tensor) -> torch.Tensor:
    """The reference's two-pass warp of an (N, C, H, W) stack: rotate(angles)
    then translate(shifts), bilinear, zero fill, a float32 intermediate."""
    h, w = planes.shape[-2:]
    rotated = warp_planes(planes, rotation_transform(angles, h, w))
    return warp_planes(rotated, translation_transform(shifts))


def inverse_rotate_translate_planes(planes: torch.Tensor, angles: torch.Tensor,
                                    shifts: torch.Tensor) -> torch.Tensor:
    """The inverse two-pass warp of an (N, C, H, W) stack: translate(-shifts)
    then rotate(-angles), as the reference's max/mean SR undoes the copies."""
    h, w = planes.shape[-2:]
    moved = warp_planes(planes, translation_transform(-shifts))
    return warp_planes(moved, rotation_transform(-angles, h, w))
