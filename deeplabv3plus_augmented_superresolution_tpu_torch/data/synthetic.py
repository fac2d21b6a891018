"""Procedural synthetic segmentation scenes (numpy, host-side).

A verbatim copy of the JAX package's ``data/synthetic.py`` (numpy only;
the port imports nothing of that package): the same numpy generator gives
the same scenes bit for bit.

Purpose: quality evidence without egress. The reference's quality numbers
come from PASCAL VOC + the downloaded bonlime checkpoint (reference
model.py:129-145, BASELINE.md) — neither is fetchable in this container.
These scenes give a dataset the real DeepLabV3+ architecture can be trained
on in minutes (models/train.py), after which the full 512-px ASR pipeline
runs with a *genuinely trained* model and the reference's headline
ASR-vs-standard IoU comparison becomes measurable end to end
(scripts/quality_demo.py).

Scene recipe: a smooth low-frequency color background plus 1..max_shapes
anti-learnable-free foreground shapes (rotated ellipses / rectangles /
triangles). Class identity is carried by color family (one hue band per
class id), geometry is random — so the model must learn color+locality, and
the recovered masks have the curved/angled HR boundaries super-resolution is
about. Labels follow VOC conventions: 0 = background, class ids as given,
255 = ignore on a ~2 px shape contour (like VOC's void contours, reference
data: SegmentationClass borders).
"""

from typing import Sequence, Tuple

import numpy as np

# Hue bands (RGB base colors) assigned to class ids in order. Backgrounds
# draw from muted grey-greens far from all bands. The first six are the
# round-3 palette (kept byte-identical so committed artifacts reproduce);
# the rest extend it to 20 distinct colors so a full 20-class validation —
# the reference's final_validations protocol (one row per VOC foreground
# class, argmax_validation_final.csv) — is generable. Pairwise RGB distance
# is kept above the per-channel jitter so color remains a learnable cue.
_CLASS_COLORS = [
    (0.85, 0.25, 0.20),   # red-ish
    (0.20, 0.35, 0.85),   # blue-ish
    (0.90, 0.80, 0.20),   # yellow-ish
    (0.60, 0.20, 0.75),   # purple-ish
    (0.95, 0.55, 0.15),   # orange-ish
    (0.15, 0.75, 0.70),   # teal-ish
    (0.20, 0.70, 0.25),   # green
    (0.95, 0.45, 0.70),   # pink
    (0.55, 0.90, 0.25),   # lime
    (0.25, 0.90, 0.95),   # cyan
    (0.50, 0.15, 0.20),   # maroon
    (0.10, 0.15, 0.45),   # navy
    (0.95, 0.75, 0.60),   # peach
    (0.70, 0.65, 0.95),   # lavender
    (0.15, 0.45, 0.30),   # forest
    (0.75, 0.95, 0.80),   # mint
    (0.55, 0.35, 0.10),   # ochre
    (0.75, 0.10, 0.50),   # magenta
    (0.40, 0.60, 0.85),   # steel blue
    (0.85, 0.85, 0.90),   # near-white
]


def _rotated_coords(h: int, w: int, cy: float, cx: float, theta: float):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy = yy - cy
    xx = xx - cx
    c, s = np.cos(theta), np.sin(theta)
    return c * yy - s * xx, s * yy + c * xx


def _shape_mask(rng: np.random.Generator, h: int, w: int,
                rmin: float = 0.08, rmax: float = 0.22,
                thin_prob: float = 0.0) -> np.ndarray:
    """One random rotated ellipse/rectangle/triangle mask (bool (h, w)).

    rmin/rmax bound the half-extents as fractions of the image; thin_prob
    turns a fraction of shapes into thin elongated structures (one axis
    squeezed 4-8x) — the small/thin regime the hard quality mode needs."""
    kind = rng.integers(0, 3)
    cy = rng.uniform(0.25 * h, 0.75 * h)
    cx = rng.uniform(0.25 * w, 0.75 * w)
    ry = rng.uniform(rmin * h, rmax * h)
    rx = rng.uniform(rmin * w, rmax * w)
    if thin_prob and rng.uniform() < thin_prob:
        squeeze = rng.uniform(4.0, 8.0)
        if rng.uniform() < 0.5:
            ry = max(ry / squeeze, 1.5)
        else:
            rx = max(rx / squeeze, 1.5)
    theta = rng.uniform(0, np.pi)
    u, v = _rotated_coords(h, w, cy, cx, theta)
    if kind == 0:      # ellipse
        return (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
    if kind == 1:      # rectangle
        return (np.abs(u) <= ry) & (np.abs(v) <= rx)
    # triangle: isoceles in the rotated frame
    return (u >= -ry) & (u <= ry) & (np.abs(v) <= rx * (ry - u) / (2 * ry))


def _bilinear_upsample(g: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinearly upsample a small (gh, gw) grid to (h, w)."""
    gh, gw = g.shape
    y = np.linspace(0, gh - 1, h, dtype=np.float32)
    x = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x1] * fx
    bot = g[y1][:, x0] * (1 - fx) + g[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _value_noise(rng: np.random.Generator, h: int, w: int,
                 scales=(4, 8, 16, 32)) -> np.ndarray:
    """Multi-octave smooth value noise in roughly [-1, 1] ((h, w) f32)."""
    out = np.zeros((h, w), np.float32)
    total = 0.0
    for i, s in enumerate(scales):
        g = rng.normal(0, 1, (s + 1, s + 1)).astype(np.float32)
        weight = 1.0 / (1 << i)
        out += weight * _bilinear_upsample(g, h, w)
        total += weight
    return out / total


def _blur3(img: np.ndarray, passes: int = 1) -> np.ndarray:
    """Separable 3-tap [1/4, 1/2, 1/4] blur, edge-replicated ((..., H, W, C))."""
    for _ in range(passes):
        p = np.pad(img, ((1, 1), (0, 0), (0, 0)), mode="edge")
        img = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
        p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="edge")
        img = 0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]
    return img


def _contour(mask: np.ndarray) -> np.ndarray:
    """~2 px inner+outer contour of a boolean mask (4-neighborhood)."""
    pad = np.pad(mask, 1)
    neigh = (pad[:-2, 1:-1] | pad[2:, 1:-1] | pad[1:-1, :-2] | pad[1:-1, 2:])
    inner = mask & ~(pad[:-2, 1:-1] & pad[2:, 1:-1]
                     & pad[1:-1, :-2] & pad[1:-1, 2:])
    outer = ~mask & neigh
    return inner | outer


def synthetic_scene(rng: np.random.Generator, size: Tuple[int, int] = (512, 512),
                    class_ids: Sequence[int] = (8, 12), max_shapes: int = 3,
                    void_contour: bool = True,
                    hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """One scene. Returns (image f32 (H, W, 3) in [0, 1], label int32 (H, W)).

    hard=False is the original easy recipe (unchanged — round-3 artifacts
    stay reproducible). hard=True de-saturates the quality regime (VERDICT
    r3 next #1): textured clutter background, near-class-hue distractor
    shapes labeled background, small/thin foreground structures, partial
    occlusion, wider class-color jitter, illumination fields, boundary blur
    and stronger sensor noise — targeting standard-arm IoU ~0.8-0.88 so
    ASR-vs-standard margins are measured with real headroom.
    """
    h, w = size
    # Background: blend three muted colors along two random linear gradients.
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    c = rng.uniform(0.25, 0.55, (3, 1, 1, 3)).astype(np.float32)
    img = c[0] + (c[1] - c[0]) * gx + (c[2] - c[0]) * gy
    label = np.zeros((h, w), np.int32)

    if hard:
        # Multi-octave texture, per channel (decorrelated => chroma clutter).
        tex = np.stack([_value_noise(rng, h, w) for _ in range(3)], axis=-1)
        img = img + 0.16 * tex
        # Background clutter: small muted shapes, labeled background.
        for _ in range(int(rng.integers(4, 9))):
            color = rng.uniform(0.15, 0.65, 3).astype(np.float32)
            mask = _shape_mask(rng, h, w, rmin=0.015, rmax=0.06)
            img = np.where(mask[..., None], color, img)
        # Distractors: shapes in NEAR-class hues (class color pulled partway
        # toward a muted tone) but labeled background — color-only cues stop
        # being sufficient, the model must also learn context/shape.
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, len(class_ids)))
            base = np.asarray(_CLASS_COLORS[k % len(_CLASS_COLORS)],
                              np.float32)
            muted = rng.uniform(0.25, 0.55, 3).astype(np.float32)
            t = rng.uniform(0.45, 0.7)
            color = np.clip(base * (1 - t) + muted * t, 0, 1)
            mask = _shape_mask(rng, h, w, rmin=0.02, rmax=0.1, thin_prob=0.3)
            img = np.where(mask[..., None], color, img)

    n_shapes = int(rng.integers(1, max_shapes + 1))
    fg_masks = []
    for _ in range(n_shapes):
        k = int(rng.integers(0, len(class_ids)))
        base = np.asarray(_CLASS_COLORS[k % len(_CLASS_COLORS)], np.float32)
        jitter = 0.16 if hard else 0.08
        color = np.clip(base + rng.uniform(-jitter, jitter, 3), 0, 1).astype(np.float32)
        if hard:
            color = np.clip(color * rng.uniform(0.75, 1.15), 0, 1)
            mask = _shape_mask(rng, h, w, rmin=0.025, rmax=0.2, thin_prob=0.25)
        else:
            mask = _shape_mask(rng, h, w)
        img = np.where(mask[..., None], color, img)
        label = np.where(mask, np.int32(class_ids[k]), label)
        fg_masks.append(mask)
        if void_contour:
            label = np.where(_contour(mask), np.int32(255), label)

    if hard:
        # Partial occlusion: background-colored occluders drawn OVER
        # foreground shapes (holes in objects, like VOC's foreground
        # occluders), relabeled background with a fresh void contour.
        for mask in fg_masks:
            if rng.uniform() < 0.5:
                ys, xs = np.nonzero(mask)
                if ys.size == 0:
                    continue
                i = int(rng.integers(0, ys.size))
                occ = _shape_mask(rng, h, w, rmin=0.015, rmax=0.05)
                # recenter the occluder onto a random point of the shape
                oy, ox = np.nonzero(occ)
                if oy.size == 0:
                    continue
                dy = int(ys[i] - oy.mean())
                dx = int(xs[i] - ox.mean())
                occ = np.roll(np.roll(occ, dy, axis=0), dx, axis=1)
                color = rng.uniform(0.2, 0.6, 3).astype(np.float32)
                img = np.where(occ[..., None], color, img)
                label = np.where(occ, np.int32(0), label)
                if void_contour:
                    label = np.where(_contour(occ) & (label != 255) & occ,
                                     label, label)  # keep existing voids
                    label = np.where(_contour(occ) & mask, np.int32(255),
                                     label)

        # Photometric hardness: low-frequency illumination field, boundary
        # blur (soft edges like real optics), stronger sensor noise.
        illum = 1.0 + 0.22 * _value_noise(rng, h, w, scales=(2, 4))
        img = img * illum[..., None]
        img = _blur3(img, passes=int(rng.integers(1, 3)))
        img = img + rng.normal(0, 0.055, img.shape).astype(np.float32)
    else:
        img = img + rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32), label


def synthetic_batch(rng: np.random.Generator, n: int,
                    size: Tuple[int, int] = (512, 512),
                    class_ids: Sequence[int] = (8, 12), max_shapes: int = 3,
                    void_contour: bool = True,
                    require_class: int = 0,
                    hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """n scenes stacked: (images (n, H, W, 3), labels (n, H, W)).

    require_class: if nonzero, redraw scenes until each contains that class
    (like the reference's filter_images_by_class staging,
    reference superres_utils.py:41-53). hard: the de-saturated scene recipe
    (see synthetic_scene).
    """
    images, labels = [], []
    while len(images) < n:
        img, lab = synthetic_scene(rng, size, class_ids, max_shapes,
                                   void_contour, hard=hard)
        if require_class and not np.any(lab == require_class):
            continue
        images.append(img)
        labels.append(lab)
    return np.stack(images), np.stack(labels)
