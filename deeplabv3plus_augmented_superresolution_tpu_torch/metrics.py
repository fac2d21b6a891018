"""IoU metrics (port of the JAX package's ``metrics.py``): numpy versions for
host-side scoring, tensor versions that score a batch on its device, and the
reference's training-time metrics.

Reference semantics: mean IoU over the classes present in the ground truth
(255 never counts as a class), and single-class IoU optionally averaged
with the background IoU; a class with an empty union yields NaN and is
dropped from the mean.
"""

from typing import Optional

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Tensor versions: a (B, ...) batch of label maps scored on its device.
# ---------------------------------------------------------------------------

def _batch_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).to(torch.int64)


def _class_counts(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, P) labels -> (B, num_classes) pixel counts of the classes 0..C-1;
    other values (255, a negative marker) count nowhere."""
    b = labels.shape[0]
    valid = (labels >= 0) & (labels < num_classes)
    offset = torch.arange(b, device=labels.device)[:, None] * num_classes
    index = torch.where(valid, labels + offset, b * num_classes)
    counts = torch.bincount(index.flatten(), minlength=b * num_classes + 1)
    return counts[:-1].view(b, num_classes).to(torch.float32)


def batch_mean_iou(y_true: torch.Tensor, y_pred: torch.Tensor,
                   num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """``mean_iou`` of each image of a (B, ...) batch, on the labels' device:
    (B,) float32, NaN for an image whose ground truth holds no class."""
    t, p = _batch_flat(y_true), _batch_flat(y_pred)
    t_count = _class_counts(t, num_classes)
    inter = _class_counts(torch.where(t == p, t, -1), num_classes)
    union = t_count + _class_counts(p, num_classes) - inter
    present = t_count > 0
    iou = torch.where(present, inter / union.clamp_min(1.0), 0.0)
    return iou.sum(dim=1) / present.sum(dim=1)


def batch_single_class_iou(y_true: torch.Tensor, y_pred: torch.Tensor, class_id: int,
                           include_bg: bool = False) -> torch.Tensor:
    """``single_class_iou`` of each image of a (B, ...) batch, on the labels'
    device: (B,) float32."""
    t, p = _batch_flat(y_true), _batch_flat(y_pred)

    def iou(te, pe):   # NaN where the union is empty
        return (te & pe).sum(dim=1).float() / (te | pe).sum(dim=1).float()

    ious = [iou(t == class_id, p == class_id)]
    if include_bg:   # every other GT label, 255 included, becomes background
        ious.append(iou(torch.where(t != class_id, 0, t) == 0, p == 0))
    ious = torch.stack(ious, dim=1)
    legal = ~torch.isnan(ious)
    return torch.where(legal, ious, 0.0).sum(dim=1) / legal.sum(dim=1)


# ---------------------------------------------------------------------------
# Training-time metrics (reference utils.py:41-91: unused by the reference's
# entry points but part of its public surface).
# ---------------------------------------------------------------------------

def sparse_crossentropy_ignoring_last_label(y_true: torch.Tensor,
                                            y_pred: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross-entropy from (..., C) logits against (..., 1)
    labels; a label outside 0..C-1 (255) has an all-zero one-hot and costs 0."""
    nb_classes = y_pred.shape[-1]
    labels = y_true[..., 0].to(torch.int64)
    one_hot = (labels[..., None] == torch.arange(nb_classes, device=labels.device))
    log_softmax = torch.log_softmax(y_pred.float(), dim=-1)
    return -(one_hot * log_softmax).sum(dim=-1)


def sparse_accuracy_ignoring_last_label(y_true: torch.Tensor,
                                        y_pred: torch.Tensor) -> torch.Tensor:
    """Pixel accuracy of the logits' argmax over the labels that are not 255."""
    nb_classes = y_pred.shape[-1]
    pred = torch.argmax(y_pred.reshape(-1, nb_classes), dim=-1)
    true = y_true.reshape(-1).to(torch.int64)
    legal = true != IGNORE_LABEL
    return (legal & (true == pred)).sum().float() / legal.sum().float()


def sparse_mean_iou(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Batched mean IoU from (B, ..., C) logits: per class, IoU averaged over
    the batch elements whose labels hold the class; classes absent from
    every element are dropped."""
    nb_classes = y_pred.shape[-1]
    b = y_pred.shape[0]
    pred = torch.argmax(y_pred, dim=-1).reshape(b, -1)
    true = y_true.reshape(b, -1).to(torch.int64)
    classes = torch.arange(nb_classes, device=pred.device)[:, None, None]
    t_eq, p_eq = true[None] == classes, pred[None] == classes       # (C, B, P)
    inter = (t_eq & p_eq).sum(dim=-1).float()
    union = (t_eq | p_eq).sum(dim=-1).float()
    legal = t_eq.sum(dim=-1) > 0                                     # (C, B)
    per_class = (torch.where(legal, inter / union, 0.0).sum(dim=1)
                 / legal.sum(dim=1).clamp_min(1))
    present = legal.any(dim=1)
    return torch.where(present, per_class, 0.0).sum() / present.sum()
