"""Host-side (CPU) image augmentation without OpenCV.

Port of the JAX package's ``data/host_augment.py`` (the reference's
data_scripts/image_utils.py: pad/crop/flip/zoom/rotate/photometric ops,
label<->color codecs and the composed ``random_transform``). The JAX module
calls OpenCV, which the card's machine lacks, so every op here is numpy and
runs the same on any host. The ops reproduce OpenCV 5.0's arithmetic on
uint8 images, so both packages give the same pixels:

  * resize (``INTER_LINEAR``): half-pixel centres; column taps clamped to
    the edge with weights rounded to 1/2048, row weights unclamped (the
    taps clamp), the vertical blend in OpenCV's vector form
    ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2``; an exact
    halving in both axes averages 2x2 blocks. ``INTER_NEAREST`` takes
    ``floor(dst * (1 / (out / in)))``, with no half-pixel shift;
  * ``getRotationMatrix2D(c, deg, s)``: ``[[a, b, (1-a) cx - b cy],
    [-b, a, b cx + (1-a) cy]]``, ``a = s cos``, ``b = s sin``, the centre in
    float32;
  * ``warpAffine`` (BORDER_CONSTANT): the matrix inverted in double, then
    float32 source coordinates per pixel, ``fma(m0, x, y m1 + m2)`` in
    blocks of 16 pixels a row and ``fma(x, m0, y m1) + m2`` for the row's
    last ``width % 16`` (OpenCV's AVX2 build); bilinear taps outside the
    image take the fill, blended with fused multiply-adds and rounded half
    to even; nearest rounds the coordinate half to even;
  * ``GaussianBlur``: OpenCV's bit-exact uint8 kernels (the 3/5/7/9-tap
    tables for sigma <= 0, else the Gaussian with sigma <= 0 meaning
    ``0.3 ((k - 1) / 2 - 1) + 0.8``, normalised in double and quantised to
    1/256 with error diffusion), rows then columns in integers, rounded
    half up, BORDER_REFLECT_101; sigmaY <= 0 takes sigmaX;
  * RGB <-> HSV on uint8: H in [0, 180) (half degrees); OpenCV's 12-bit
    division tables one way, its float32 sector formula the other (s and v
    scaled by 1/255, fused multiply-adds, x 255, truncated in blocks of 32
    pixels a row, the rest rounded).

Interpolation is named by ``LINEAR`` or ``NEAREST`` (strings), not by an
OpenCV constant. Float images warp and resize in float32 with the same
taps and unquantised weights, as OpenCV's float path does (within a few
float32 ulps of it). ``imread``/``imwrite`` import PIL when called.
"""

import math
import os
import random
from typing import Optional, Tuple

import numpy as np

from .voc import voc_colormap

LINEAR = "linear"
NEAREST = "nearest"

# OpenCV's AVX2 build computes warpAffine's source coordinates 16 pixels a
# vector step; the rest of a row takes its scalar formula.
_WARP_LANES = 16
# OpenCV's fixed-point resize weights: 11 fractional bits.
_RESIZE_ONE = 2048
# OpenCV's AVX2 HSV2RGB_b converts 32 pixels a vector step, truncating; the
# rest of a row takes its scalar formula, which rounds.
_HSV_BLOCK = 32


def _interpolation(interpolation) -> str:
    if interpolation is None:
        return LINEAR
    if interpolation not in (LINEAR, NEAREST):
        raise ValueError(f"interpolation must be {LINEAR!r} or {NEAREST!r}, "
                         f"not {interpolation!r}")
    return interpolation


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """RGB (or grayscale) read, as the reference's cv2 read then BGR->RGB:
    palette and alpha images come back as 3-channel RGB."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode in ("P", "RGBA", "LA", "PA", "CMYK", "YCbCr"):
            img = img.convert("RGB")
        return np.array(img)


def imwrite(path: str, image: np.ndarray) -> None:
    """Write an RGB or grayscale array; the format follows the extension
    (JPEG at OpenCV's default quality 95)."""
    from PIL import Image

    ext = os.path.splitext(path)[1].lower()
    kw = {"quality": 95} if ext in (".jpg", ".jpeg") else {}
    Image.fromarray(np.asarray(image)).save(path, **kw)


def pad_to(image: np.ndarray, size: Tuple[int, int], value=0) -> np.ndarray:
    h, w = image.shape[:2]
    th, tw = size
    top = max(0, (th - h) // 2)
    bottom = max(0, th - h - top)
    left = max(0, (tw - w) // 2)
    right = max(0, tw - w - left)
    border = ((top, bottom), (left, right)) + ((0, 0),) * (image.ndim - 2)
    return np.pad(image, border, constant_values=value)


def center_crop(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = image.shape[:2]
    th, tw = size
    y0 = max(0, (h - th) // 2)
    x0 = max(0, (w - tw) // 2)
    return image[y0:y0 + th, x0:x0 + tw]


def random_crop(image: np.ndarray, mask: np.ndarray, size: Tuple[int, int],
                rng: Optional[random.Random] = None):
    rng = rng or random
    h, w = image.shape[:2]
    th, tw = size
    y0 = rng.randint(0, max(0, h - th))
    x0 = rng.randint(0, max(0, w - tw))
    return image[y0:y0 + th, x0:x0 + tw], mask[y0:y0 + th, x0:x0 + tw]


def flip_horizontal(image: np.ndarray) -> np.ndarray:
    return image[:, ::-1]


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps along one axis and the second tap's float32
    weight (the first's is 1 - it)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:   # the column pass: an edge tap takes weight 1
        f[(s < 0) | (s >= n_in - 1)] = 0
        s = np.clip(s, 0, n_in - 1)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def resize(image: np.ndarray, size: Tuple[int, int], interpolation=None) -> np.ndarray:
    """``cv2.resize(image, size, interpolation)``: size is (width, height)."""
    interpolation = _interpolation(interpolation)
    out_w, out_h = size
    h, w = image.shape[:2]
    if interpolation == NEAREST:
        xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
        ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
        return image[ys][:, xs]
    if image.dtype == np.uint8 and (w, h) == (2 * out_w, 2 * out_h):
        blocks = image.astype(np.int32).reshape((out_h, 2, out_w, 2) + image.shape[2:])
        return ((blocks.sum(axis=(1, 3)) + 2) >> 2).astype(np.uint8)
    x0, x1, fx = _linear_taps(w, out_w, clamp=True)
    y0, y1, fy = _linear_taps(h, out_h, clamp=False)
    chan = (None,) * (image.ndim - 2)
    fx, fy = fx[(slice(None),) + chan], fy[(slice(None), None) + chan]
    one = np.float32(1)
    if image.dtype != np.uint8:
        src = image.astype(np.float32)
        rows = src[:, x0] * (one - fx) + src[:, x1] * fx
        return rows[y0] * (one - fy) + rows[y1] * fy
    a0, a1, b0, b1 = (np.rint(wt * np.float32(_RESIZE_ONE)).astype(np.int64)
                      for wt in (one - fx, fx, one - fy, fy))
    src = image.astype(np.int64)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    out = ((((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def zoom(image: np.ndarray, factor: float, interpolation=None) -> np.ndarray:
    """Scale about the center, keeping the original frame size."""
    h, w = image.shape[:2]
    scaled = resize(image, (max(1, int(w * factor)), max(1, int(h * factor))),
                    interpolation)
    if factor >= 1.0:
        return center_crop(scaled, (h, w))
    return pad_to(scaled, (h, w))


def rotation_matrix(center: Tuple[float, float], angle_deg: float,
                    scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, counter-clockwise for a
    positive angle in image coordinates (y down)."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle_deg * (math.pi / 180)
    a = math.cos(angle) * scale
    b = math.sin(angle) * scale
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def _invert_affine(matrix: np.ndarray) -> np.ndarray:
    """warpAffine's inversion of a forward matrix, in double, as 6 values."""
    m = np.asarray(matrix, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(image: np.ndarray, matrix: np.ndarray, size: Tuple[int, int],
                interpolation=None, fill=0) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, size, flags=interpolation,
    borderMode=BORDER_CONSTANT, borderValue=fill)``: size is (width,
    height); fill is a scalar or one value per channel."""
    interpolation = _interpolation(interpolation)
    h, w = image.shape[:2]
    out_w, out_h = size
    m = _invert_affine(matrix).astype(np.float32)
    x = np.arange(out_w, dtype=np.float32)[None]
    y = np.arange(out_h, dtype=np.float32)[:, None]
    sx = _fma32(m[0], x, y * m[1] + m[2])
    sy = _fma32(m[3], x, y * m[4] + m[5])
    tail = out_w - out_w % _WARP_LANES
    if tail < out_w:
        sx[:, tail:] = _fma32(x[:, tail:], m[0], y * m[1]) + m[2]
        sy[:, tail:] = _fma32(x[:, tail:], m[3], y * m[4]) + m[5]

    # Taps index a copy framed by 2 fill pixels; a base tap clipped to
    # [-2, size] keeps both of its taps where they were, in or out.
    chans = image.shape[2:]
    values = np.asarray(fill, np.float64).ravel()
    n = chans[0] if chans else 1
    values = np.broadcast_to(values, (n,)) if values.size == 1 else values[:n]
    framed = np.empty((h + 4, w + 4) + chans, image.dtype)
    framed[...] = _round_u8(values) if image.dtype == np.uint8 else values
    framed[2:-2, 2:-2] = image
    flat = framed.reshape(((h + 4) * (w + 4),) + chans)

    def base(ix, iy):
        return (np.clip(iy, -2, h) + 2) * (w + 4) + np.clip(ix, -2, w) + 2

    if interpolation == NEAREST:
        return np.take(flat, base(np.rint(sx).astype(np.int64),
                                  np.rint(sy).astype(np.int64)), axis=0)
    fx, fy = np.floor(sx), np.floor(sy)
    at = base(fx.astype(np.int64), fy.astype(np.int64))
    p00, p01, p10, p11 = (np.take(flat, at + step, axis=0).astype(np.float32)
                          for step in (0, 1, w + 4, w + 5))
    ax = (sx - fx)[(...,) + (None,) * len(chans)]
    ay = (sy - fy)[(...,) + (None,) * len(chans)]
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, bottom - top, top)
    return _round_u8(out) if image.dtype == np.uint8 else out


def rotate(image: np.ndarray, angle_deg: float, interpolation=None) -> np.ndarray:
    """Rotate about the center with constant fill (host path; degrees)."""
    h, w = image.shape[:2]
    m = rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle_deg, 1.0)
    return warp_affine(image, m, (w, h), interpolation)


def remove_mean(image: np.ndarray) -> np.ndarray:
    """Subtract the ImageNet channel means (B, G, R order — the Keras
    'caffe' preprocessing the reference's FCN-era path used,
    reference image_utils.py:92-105)."""
    return image.astype(np.float32) - np.array([103.939, 116.779, 123.68],
                                               np.float32)


def rotate_expand(image: np.ndarray, angle_deg: float, scale: float = 1.0,
                  interpolation=None, fill=0) -> np.ndarray:
    """Rotate (+optional zoom) about the center onto an EXPANDED canvas that
    contains the whole rotated frame — no content is ever clipped at the
    corners (reference image_utils.py:327-364). GT masks pass
    interpolation=NEAREST and fill=ignore_label."""
    h, w = image.shape[:2]
    mat = rotation_matrix((w // 2, h // 2), angle_deg, scale)
    cos, sin = abs(mat[0, 0]), abs(mat[0, 1])
    out_w = int(round(w * cos + h * sin))
    out_h = int(round(w * sin + h * cos))
    mat[0, 2] += out_w / 2 - w // 2
    mat[1, 2] += out_h / 2 - h // 2
    if np.isscalar(fill):
        fill = (fill, fill, fill)
    return warp_affine(image, mat, (out_w, out_h), interpolation, fill)


def random_rotate(image: np.ndarray, mask: np.ndarray, rotation_range,
                  zoom_range=None, ignore_label: int = 255,
                  rng: Optional[random.Random] = None):
    """Joint expanding rotate+zoom of an image and its labels; out-of-frame
    label pixels become ignore_label (reference image_utils.py:366-384)."""
    rng = rng or random
    angle = rng.uniform(*rotation_range)
    scale = 1.0 if zoom_range is None else rng.uniform(*zoom_range)
    img = rotate_expand(image, angle, scale)
    gt = rotate_expand(mask, angle, scale, interpolation=NEAREST, fill=ignore_label)
    return img, gt


# OpenCV's fixed Gaussian kernels for sigma <= 0 (getGaussianKernel's table).
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                   9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256,
                       30 / 256, 13 / 256, 4 / 256]}


def _gaussian_kernel_u8(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact uint8 Gaussian kernel: ksize integer weights in
    1/256 summing to 256."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        weights = _SMALL_GAUSSIAN[ksize]
    else:
        s = sigma if sigma > 0 else ksize * 0.15 + 0.35
        scale2 = -0.125 / (s * s)
        half = [math.exp((x * x) * scale2) for x in range(1 - ksize, 0, 2)]
        mul = 1.0 / (2 * sum(half) + 1.0)
        weights = [v * mul for v in half] + [mul]
    weights = list(weights)[:ksize // 2]
    out, err = [], 0.0
    for v in weights:   # error diffusion over the first half, centre closes the sum
        adj = v * 256 + err
        q = int(np.rint(adj))
        err = adj - q
        out.append(q)
    return np.array(out + [256 - 2 * sum(out)] + out[::-1], np.int64)


def _reflect101(image: np.ndarray, axis: int, pad: int) -> np.ndarray:
    width = [(0, 0)] * image.ndim
    width[axis] = (pad, pad)
    return np.pad(image, width, mode="reflect")


def gaussian_blur(image: np.ndarray, ksize: Tuple[int, int], sigma_x: float,
                  sigma_y: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(image, ksize, sigmaX, sigmaY)`` on uint8 (odd
    kernel sizes, BORDER_REFLECT_101)."""
    if image.dtype != np.uint8:
        raise TypeError("gaussian_blur takes uint8 images (OpenCV's bit-exact path)")
    kx, ky = ksize
    h, w = image.shape[:2]
    kx, ky = (1 if w == 1 else kx), (1 if h == 1 else ky)
    if kx == 1 and ky == 1:
        return image.copy()
    if sigma_y <= 0:
        sigma_y = sigma_x
    wx = _gaussian_kernel_u8(kx, max(sigma_x, 0.0))
    wy = _gaussian_kernel_u8(ky, max(sigma_y, 0.0))
    src = _reflect101(image.astype(np.int64), 1, kx // 2)
    rows = sum(wx[k] * src[:, k:k + w] for k in range(kx))
    rows = _reflect101(rows, 0, ky // 2)
    out = sum(wy[k] * rows[k:k + h] for k in range(ky))
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def random_blur(image: np.ndarray, ksize_max=(9, 9), sigma_max=(1.5, 1.5),
                rng: Optional[random.Random] = None) -> np.ndarray:
    """Gaussian blur with random odd kernel sizes up to ksize_max and random
    sigmas up to sigma_max (reference image_utils.py:165-185)."""
    rng = rng or random
    kx = rng.randrange(0, ksize_max[0]) | 1
    ky = rng.randrange(0, ksize_max[1]) | 1
    return gaussian_blur(image, (kx, ky), sigma_max[0] * rng.random(),
                         sigma_max[1] * rng.random())


def _hsv_tables():
    """OpenCV's RGB2HSV_b division tables (12 fractional bits)."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << 12) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << 12) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2HSV)`` on uint8: H in [0, 180)."""
    sdiv, hdiv = _hsv_tables()
    r, g, b = (image[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` on a uint8 (H, W, 3) image (H in
    [0, 180))."""
    one = np.float32(1.0)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    sector = np.floor(h)
    h = (h - sector).astype(np.float32)
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)])
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    b, g, r = (np.take_along_axis(tab, order[sector][None, ..., c], 0)[0] for c in range(3))
    rgb = np.stack([r, g, b], axis=-1) * np.float32(255.0)
    # A row's blocks of _HSV_BLOCK pixels truncate; the rest rounds, grey as v.
    tail = hsv.shape[1] - hsv.shape[1] % _HSV_BLOCK
    out = np.trunc(rgb)
    grey = (s[:, tail:] == 0)[..., None]
    out[:, tail:] = np.rint(np.where(grey, v[:, tail:, None] * np.float32(255.0),
                                     rgb[:, tail:]))
    return np.clip(out, 0, 255).astype(np.uint8)


def adjust_saturation_value(image: np.ndarray, saturation: int = 0,
                            value: int = 0) -> np.ndarray:
    """Shift HSV saturation/value by absolute amounts with saturation-safe
    clipping (reference image_utils.py:215-247)."""
    if saturation == 0 and value == 0:
        return image
    hsv = rgb_to_hsv(image.astype(np.uint8)).astype(np.int16)
    hsv[..., 1] = np.clip(hsv[..., 1] + saturation, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + value, 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8))


def adjust_brightness_contrast(image: np.ndarray, brightness: int = 0,
                               contrast: int = 0) -> np.ndarray:
    """Absolute brightness shift + contrast gain about the mid-gray point
    (the standard alpha/gamma formulation, reference image_utils.py:250-285)."""
    out = image.astype(np.float32)
    if brightness:
        lo, hi = (brightness, 255) if brightness > 0 else (0, 255 + brightness)
        out = out * (hi - lo) / 255.0 + lo
    if contrast:
        gain = 131.0 * (contrast + 127) / (127.0 * (131 - contrast))
        out = gain * out + 127.0 * (1.0 - gain)
    return np.clip(out, 0, 255).astype(np.uint8)


def pad_or_crop(image: np.ndarray, size: Tuple[int, int], value=0) -> np.ndarray:
    """Center-pad each axis that is too small and center-crop each axis that
    is too large (reference image_utils.py:301-325)."""
    return center_crop(pad_to(image, size, value=value), size)


def random_shift(image: np.ndarray, mask: np.ndarray, shift_range,
                 ignore_label: int = 255,
                 rng: Optional[random.Random] = None):
    """Translate by up to +-shift_range px via center-pad then random-crop
    back to the original size — the reference's shift mechanism
    (image_utils.py:437-504 'shift_range' docstring)."""
    rng = rng or random
    h, w = image.shape[:2]
    sy, sx = shift_range
    img = pad_to(image, (h + 2 * sy, w + 2 * sx))
    gt = pad_to(mask, (h + 2 * sy, w + 2 * sx), value=ignore_label)
    return random_crop(img, gt, (h, w), rng)


def apply_mask(image: np.ndarray, pred_colors: np.ndarray,
               alpha: float = 0.5) -> np.ndarray:
    """Overlay a colorized prediction onto the image; black (background)
    prediction pixels stay fully transparent (reference image_utils.py:421-435)."""
    fg = np.any(pred_colors != 0, axis=-1, keepdims=True)
    blend = (1 - alpha) * image.astype(np.float32) \
        + alpha * pred_colors.astype(np.float32)
    return np.where(fg, blend, image.astype(np.float32)).astype(np.uint8)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    hsv = rgb_to_hsv(image.astype(np.uint8)).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8))


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return np.clip(image.astype(np.float32) + delta, 0, 255).astype(image.dtype)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    mean = image.astype(np.float32).mean(axis=(0, 1), keepdims=True)
    return np.clip((image - mean) * factor + mean, 0, 255).astype(image.dtype)


def blur(image: np.ndarray, ksize: int = 3) -> np.ndarray:
    return gaussian_blur(image, (ksize | 1, ksize | 1), 0)


def labels_to_colors(label_img: np.ndarray) -> np.ndarray:
    """Label indices -> VOC palette RGB (reference image_utils label codecs)."""
    cmap = voc_colormap()
    return cmap[np.clip(label_img.astype(np.int32), 0, 255)]


def colors_to_labels(color_img: np.ndarray, one_hot: bool = False) -> np.ndarray:
    """VOC palette RGB -> label indices, or a one-hot stack over the 21
    classes when one_hot=True (reference image_utils.py:406-418)."""
    cmap = voc_colormap()
    if one_hot:
        n = 21
        out = np.zeros(color_img.shape[:2] + (n,), np.uint8)
        for i in range(n):
            out[..., i] = np.all(color_img == cmap[i], axis=-1)
        return out
    lookup = {tuple(c): i for i, c in enumerate(cmap)}
    flat = color_img.reshape(-1, 3)
    out = np.array([lookup.get(tuple(px), 255) for px in flat], dtype=np.uint8)
    return out.reshape(color_img.shape[:2])


def random_transform(image: np.ndarray, mask: np.ndarray,
                     target_shape: Optional[Tuple[int, int]] = None,
                     saturation_range=None, value_range=None,
                     brightness_range=None, contrast_range=None,
                     blur_params=None, flip_lr: bool = False,
                     rotation_range=None, shift_range=None, zoom_range=None,
                     ignore_label: int = 255,
                     seed: Optional[int] = None):
    """The composed host augmentation pipeline (reference
    image_utils.py:437-504): photometric adjustments (image only), then the
    joint geometric chain — flip / expanding rotate+zoom (or plain zoom) /
    pad-or-crop to target (+shift_range) / random crop for translation. GT
    fill is always ignore_label; photometric ranges are integer amounts.
    The draws come from ``random.Random(seed)`` in the JAX package's order,
    so both packages take the same parameters."""
    rng = random.Random(seed)
    img, gt = image, mask
    target_shape = target_shape or img.shape[:2]

    img = adjust_saturation_value(
        img,
        0 if saturation_range is None else rng.randint(*saturation_range),
        0 if value_range is None else rng.randint(*value_range))
    img = adjust_brightness_contrast(
        img,
        0 if brightness_range is None else rng.randint(*brightness_range),
        0 if contrast_range is None else rng.randint(*contrast_range))
    if blur_params is not None:
        img = random_blur(img, blur_params["ksize_max"],
                          blur_params["sigma_max"], rng)

    if flip_lr and rng.random() < 0.5:
        img, gt = flip_horizontal(img), flip_horizontal(gt)

    if rotation_range is not None:
        img, gt = random_rotate(img, gt, rotation_range, zoom_range,
                                ignore_label, rng)
    elif zoom_range is not None:
        z = rng.uniform(*zoom_range)
        img = zoom(img, z)
        gt = zoom(gt, z, interpolation=NEAREST)

    padded = (np.asarray(target_shape)
              + (np.asarray(shift_range) if shift_range is not None else 0))
    img = pad_or_crop(img, tuple(padded))
    gt = pad_or_crop(gt, tuple(padded), value=ignore_label)
    if shift_range is not None:
        img, gt = random_crop(img, gt, tuple(target_shape), rng)
    return img, gt


def list_files(pathname):
    """Plain files directly under a directory (reference image_utils.py:23)."""
    return [f for f in os.listdir(pathname)
            if os.path.isfile(os.path.join(pathname, f))]


def bytes_read(filename):
    """Raw file bytes (reference image_utils.py:27)."""
    with open(filename, "rb") as f:
        return f.read()


def image_histogram(im):
    """(colors, counts) over an RGB image (reference image_utils.py:84-91)."""
    return np.unique(im.reshape(-1, im.shape[2]), axis=0, return_counts=True)
