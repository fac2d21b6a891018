"""IoU metrics in numpy (port of the JAX package's ``metrics.py``).

Reference semantics: mean IoU over the classes present in the ground truth
(255 never counts as a class), and single-class IoU optionally averaged
with the background IoU; a class with an empty union yields NaN and is
dropped from the mean.
"""

from typing import Optional

import numpy as np

NUM_CLASSES = 21
IGNORE_LABEL = 255


def _flat_int(x) -> np.ndarray:
    return np.asarray(x).reshape(-1).astype(np.int32)


def _iou(t: np.ndarray, p: np.ndarray, class_id: int) -> float:
    te, pe = t == class_id, p == class_id
    union = np.sum(te | pe)
    return float(np.sum(te & pe)) / float(union) if union else float("nan")


def mean_iou(y_true, y_pred, num_classes: int = NUM_CLASSES) -> float:
    t, p = _flat_int(y_true), _flat_int(y_pred)
    ious = [_iou(t, p, c) for c in range(num_classes) if np.any(t == c)]
    return float(np.mean(ious)) if ious else float("nan")


def single_class_iou(y_true, y_pred, class_id: int, include_bg: bool = False) -> float:
    t, p = _flat_int(y_true), _flat_int(y_pred)
    ious = [_iou(t, p, class_id)]
    if include_bg:
        ious.append(_iou(np.where(t != class_id, 0, t), p, 0))
    legal = [v for v in ious if not np.isnan(v)]
    return float(np.mean(legal)) if legal else float("nan")


def compute_iou(true_image, image, img_size=(512, 512),
                class_id: Optional[int] = None, include_bg: bool = False) -> float:
    """Flatten + dispatch: single-class IoU when class_id is given, else mean IoU."""
    del img_size  # flattening handles any shape
    if class_id is not None:
        return single_class_iou(true_image, image, class_id, include_bg)
    return mean_iou(true_image, image)
