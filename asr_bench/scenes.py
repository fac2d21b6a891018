"""The traffic's images: synthetic scenes drawn from the run's seed.

A frozen copy of the program's ``data/synthetic.synthetic_scene`` (its
default recipe, numpy only): a smooth background of three muted colours and
1..max_shapes rotated ellipses, rectangles or triangles in the colour band
of a class, with sensor noise. Frozen here so that a change to the program
cannot change the benchmark's inputs. ``make_scenes`` draws them on a few
threads, each scene from its own generator spawned from the seed, so the
set does not depend on the order in which the threads finish.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

_CLASS_COLORS = [
    (0.85, 0.25, 0.20), (0.20, 0.35, 0.85), (0.90, 0.80, 0.20), (0.60, 0.20, 0.75),
    (0.95, 0.55, 0.15), (0.15, 0.75, 0.70), (0.20, 0.70, 0.25), (0.95, 0.45, 0.70),
    (0.55, 0.90, 0.25), (0.25, 0.90, 0.95), (0.50, 0.15, 0.20), (0.10, 0.15, 0.45),
    (0.95, 0.75, 0.60), (0.70, 0.65, 0.95), (0.15, 0.45, 0.30), (0.75, 0.95, 0.80),
    (0.55, 0.35, 0.10), (0.75, 0.10, 0.50), (0.40, 0.60, 0.85), (0.85, 0.85, 0.90),
]


def _shape_mask(rng: np.random.Generator, h: int, w: int, rmin: float = 0.08,
                rmax: float = 0.22) -> np.ndarray:
    kind = rng.integers(0, 3)
    cy = rng.uniform(0.25 * h, 0.75 * h)
    cx = rng.uniform(0.25 * w, 0.75 * w)
    ry = rng.uniform(rmin * h, rmax * h)
    rx = rng.uniform(rmin * w, rmax * w)
    theta = rng.uniform(0, np.pi)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy - cy, xx - cx
    c, s = np.cos(theta), np.sin(theta)
    u, v = c * yy - s * xx, s * yy + c * xx
    if kind == 0:
        return (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
    if kind == 1:
        return (np.abs(u) <= ry) & (np.abs(v) <= rx)
    return (u >= -ry) & (u <= ry) & (np.abs(v) <= rx * (ry - u) / (2 * ry))


def synthetic_scene(rng: np.random.Generator, size: Tuple[int, int],
                    class_ids: Sequence[int], max_shapes: int) -> np.ndarray:
    """One (H, W, 3) float32 image in [0, 1]."""
    h, w = size
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    c = rng.uniform(0.25, 0.55, (3, 1, 1, 3)).astype(np.float32)
    img = c[0] + (c[1] - c[0]) * gx + (c[2] - c[0]) * gy
    for _ in range(int(rng.integers(1, max_shapes + 1))):
        k = int(rng.integers(0, len(class_ids)))
        base = np.asarray(_CLASS_COLORS[k % len(_CLASS_COLORS)], np.float32)
        color = np.clip(base + rng.uniform(-0.08, 0.08, 3), 0, 1).astype(np.float32)
        img = np.where(_shape_mask(rng, h, w)[..., None], color, img)
    img = img + rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def make_scenes(seed: int, count: int, size, class_ids: Sequence[int], max_shapes: int,
                threads: int = 4) -> List[np.ndarray]:
    """``count`` distinct scenes, scene i from the i-th generator spawned from
    ``seed``."""
    seqs = np.random.SeedSequence(int(seed)).spawn(count)

    def one(seq):
        return synthetic_scene(np.random.default_rng(seq), tuple(size), class_ids,
                               max_shapes)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, seqs))
