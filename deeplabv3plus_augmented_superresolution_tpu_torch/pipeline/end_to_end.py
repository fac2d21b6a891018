"""The ASR step (port of the JAX package's ``pipeline/end_to_end.py``).

  image -> N augmented copies -> DeepLabV3+ forward -> OPM masks
        -> normalize -> {aug | max | mean} SR -> threshold

plus the "standard" baseline mask (the plain model's upsampled argmax) from
the forward of the identity copy. ``asr_step`` serves one class,
``asr_step_multiclass`` K classes from one warp and one forward.

Both take one (H, W, 3) image or a batch (B, H, W, 3) that shares the
augmentation set, as the reference's ``jax.vmap`` of the step over images:
the batch rides the kernels' channel axis (B x 3 planes in the copies warp,
B x K target planes in b, the solve and the inverse warp), so a batch
launches the kernels as often as one image does, and one solve covers all
its planes. Eager PyTorch: each stage enqueues its device work in order;
nothing here synchronizes unless a timer asks to.

Given a ``CopyShard`` (``parallel/``), a step warps and forwards only this
rank's block of the copies, then gathers the raw masks of every block
before the normalization and the solve, which run on the whole (padded)
stack as on one card.
"""

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.deeplab import DeepLab
from ..ops.opm import extract_masks, extract_masks_multiclass, prepare_sr_inputs
from ..ops.resize import resize
from ..sr.postprocess import combine_label_map, threshold_image
from ..sr.solver import (SR_FUNCTIONS, SRConfig, augmented_superresolution,
                         multiclass_max_mean_superresolution)
from .augment import make_augmented_copies

SR_TYPES = tuple(SR_FUNCTIONS)


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class CopyShard(NamedTuple):
    """This rank's block of the copy axis: the block's transforms, and
    gather, which takes the block's mask stacks (copy axis -4; None passes
    through) and returns the whole stacks, every rank's block in its place."""
    angles: torch.Tensor
    shifts: torch.Tensor
    gather: Callable[..., Tuple[Optional[torch.Tensor], ...]]


def _check_sr_types(sr_types) -> None:
    unknown = [t for t in sr_types if t not in SR_FUNCTIONS]
    if unknown:
        raise ValueError(f"unknown sr_types {unknown}; choose from {SR_TYPES}")


def _forward(model: DeepLab, images: torch.Tensor, angles, shifts, sr_cfg: SRConfig,
             chunk_size: int, timer) -> torch.Tensor:
    """The copies warp and the network forward of a (B, H, W, 3) batch:
    (B, N, h, w, classes) logits, N = len(angles). The network runs on the
    copies in copy-major order (a free view of the warp's output);
    chunk_size cuts it into forwards of chunk_size copies of every image."""
    b = images.shape[0]
    num_aug = angles.shape[0]
    with _stage(timer, "warp"):
        # Warp in the model's compute dtype: the forward casts its input to it
        # at entry anyway, and the kernel blends in f32 either way.
        copies = make_augmented_copies(images.to(model.cfg.dtype), angles, shifts,
                                       num_aug, warp_impl=sr_cfg.warp_impl,
                                       angle_max=sr_cfg.angle_max).flatten(0, 1)
    with _stage(timer, "forward"):
        if chunk_size and num_aug > chunk_size and num_aug % chunk_size == 0:
            preds = torch.cat([model(c) for c in copies.split(chunk_size * b)])
        else:
            preds = model(copies)
    return preds.unflatten(0, (num_aug, b)).transpose(0, 1)


def _masks(preds, extract, mode: str, copies: Optional[CopyShard], timer):
    """The OPM stage: extract(preds) -> (class masks, max masks or None),
    normalized. Sharded, the stage "gather" assembles the whole stacks from
    the blocks and normalizes them (the normalization reads every copy)."""
    with _stage(timer, "opm"):
        masks = extract(preds)
        if copies is None:
            return prepare_sr_inputs(*masks, mode)
    with _stage(timer, "gather"):
        return prepare_sr_inputs(*copies.gather(*masks), mode)


def _standard_labels(model: DeepLab, preds: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) argmax labels of the identity copies' upsampled logits."""
    hr_logits = resize(preds[:, 0], model.cfg.input_shape[:2], method="bilinear")
    return torch.argmax(hr_logits, dim=-1, keepdim=True)


def _as_batch(image: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if image.dim() == 4:
        return image, True
    if image.dim() == 3:
        return image[None], False
    raise ValueError(f"image must be (H, W, 3) or (B, H, W, 3), got {tuple(image.shape)}")


@torch.no_grad()
def asr_step(model: DeepLab, image: torch.Tensor, angles: torch.Tensor,
             shifts: torch.Tensor, sr_cfg: SRConfig, class_id: int,
             mode: str = "argmax", th_factor: float = 0.15,
             sr_types: Tuple[str, ...] = ("aug", "max", "mean"),
             chunk_size: int = 0,
             gram_coeffs: Optional[torch.Tensor] = None,
             return_targets: bool = False,
             timer=None,
             dropout_generator: Optional[torch.Generator] = None,
             copies: Optional[CopyShard] = None
             ) -> Dict[str, torch.Tensor]:
    """Full ASR for one (H, W, 3) image on the model's device. Returns the
    thresholded HR mask of each SR type and "standard", each (H, W, 1)
    float32 with values {0, class_id}; with return_targets also
    "<type>_target", the continuous SR estimate before thresholding. A
    (B, H, W, 3) batch returns each value with a leading image axis,
    (B, H, W, 1), slice i equal to the step of image i alone.

    max and mean share one inverse warp. gram_coeffs: a precomputed stencil
    (sr.precompute_gram_stencil) for the run's fixed augmentation set.
    timer: optional object with a ``stage(name)`` context manager
    (utils.profiling.StageTimer), given the stages warp, forward, opm,
    max_mean, b, solve_steps, threshold and standard (and gather when
    sharded). dropout_generator: draws the solve's copy-dropout mask
    (sr.augmented_superresolution), one for the batch. copies: this rank's
    block of the copies (``CopyShard``); angles and shifts are then the
    whole padded set, and "standard" is the block's first copy's (the
    identity copy's on the rank that holds copy 0).
    """
    _check_sr_types(sr_types)
    images, batched = _as_batch(image)
    own = (copies.angles, copies.shifts) if copies is not None else (angles, shifts)
    preds = _forward(model, images, *own, sr_cfg, chunk_size, timer)
    class_masks, max_masks = _masks(preds, lambda p: extract_masks(p, class_id, mode),
                                    mode, copies, timer)
    slice_max = mode == "slice_max" and max_masks is not None

    # (target, target of the max stack or None) per SR type; the B images'
    # (B, N, h, w, 1) stacks are the solvers' class axis.
    targets: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    if "max" in sr_types or "mean" in sr_types:
        with _stage(timer, "max_mean"):
            mx, mean = multiclass_max_mean_superresolution(class_masks, angles,
                                                           shifts, sr_cfg)
            mx_m = mean_m = None
            if slice_max:
                mx_m, mean_m = multiclass_max_mean_superresolution(max_masks, angles,
                                                                   shifts, sr_cfg)
        targets["max"], targets["mean"] = (mx, mx_m), (mean, mean_m)
    if "aug" in sr_types:  # stages b and solve_steps inside
        aug = dict(gram_coeffs=gram_coeffs, timer=timer,
                   dropout_generator=dropout_generator)
        targets["aug"] = (
            augmented_superresolution(class_masks, angles, shifts, sr_cfg, **aug)[0],
            augmented_superresolution(max_masks, angles, shifts, sr_cfg, **aug)[0]
            if slice_max else None)

    results: Dict[str, torch.Tensor] = {}
    with _stage(timer, "threshold"):
        for sr_type in sr_types:
            target_class, target_max = targets[sr_type]
            results[sr_type] = threshold_image(target_class, class_id, th_factor,
                                               th_mask=target_max)
            if return_targets:
                results[sr_type + "_target"] = target_class.to(torch.float32)

    with _stage(timer, "standard"):
        standard = _standard_labels(model, preds)
        results["standard"] = (standard == class_id).to(torch.float32) * class_id
    return results if batched else {k: v[0] for k, v in results.items()}


def _class_chunks(n_classes: int, class_chunk: int):
    """Slices of the class axis: all K at once, or groups of class_chunk (the
    last one ragged). The classes do not couple, so each group's results are
    those of the whole."""
    step = class_chunk if 0 < class_chunk < n_classes else n_classes
    return [slice(i, min(i + step, n_classes)) for i in range(0, n_classes, step)]


@torch.no_grad()
def asr_step_multiclass(model: DeepLab, image: torch.Tensor, angles: torch.Tensor,
                        shifts: torch.Tensor, sr_cfg: SRConfig,
                        class_ids: Sequence[int],
                        mode: str = "argmax", th_factor: float = 0.15,
                        sr_types: Tuple[str, ...] = ("aug", "max", "mean"),
                        chunk_size: int = 0,
                        class_chunk: int = 0,
                        gram_coeffs: Optional[torch.Tensor] = None,
                        return_targets: bool = False,
                        return_label_map: bool = False,
                        label_map_rule: str = "class_peak",
                        timer=None,
                        dropout_generator: Optional[torch.Generator] = None,
                        copies: Optional[CopyShard] = None
                        ) -> Dict[str, torch.Tensor]:
    """ASR for one image over K classes: one copies warp and one forward feed
    every class, and the K solves share the stencil. Returns the asr_step
    dict with a leading class axis: each value (K, H, W, 1) float32 with
    values {0, class_ids[k]} in slice k; slice k equals
    ``asr_step(class_id=class_ids[k], ...)``. A (B, H, W, 3) batch returns
    (B, K, H, W, 1) values (label maps (B, H, W, 1)).

    The per-class work (b = A^T y and the solve for "aug", the inverse warp
    for max/mean) runs on the B x K planes at once, or on groups of
    class_chunk classes of every image in turn to bound the memory peak; the
    results are the same. Each group launches the kernels of one b and one
    inverse warp, whatever its size.

    return_label_map: also "label_map", the (H, W, 1) full-scene label map
    combined from the per-class aug targets by ``label_map_rule``
    (sr.postprocess.combine_label_map), and "label_map_standard", the plain
    model's upsampled argmax labels. Needs "aug" in sr_types. copies: as
    in ``asr_step``.
    """
    _check_sr_types(sr_types)
    class_ids = tuple(int(c) for c in class_ids)
    images, batched = _as_batch(image)
    own = (copies.angles, copies.shifts) if copies is not None else (angles, shifts)
    preds = _forward(model, images, *own, sr_cfg, chunk_size, timer)
    cls = torch.as_tensor(class_ids, device=preds.device)

    def extract(p):
        # (B, K, N, h, w, 1) -> one (B*K, N, h, w, 1) stack, normalized per plane
        class_masks, max_masks = extract_masks_multiclass(p, class_ids, mode)
        return (class_masks.flatten(0, 1),
                max_masks.flatten(0, 1) if max_masks is not None else None)

    class_masks, max_masks = _masks(preds, extract, mode, copies, timer)
    slice_max = mode == "slice_max" and max_masks is not None
    chunks = _class_chunks(len(class_ids), class_chunk)
    b, k = images.shape[0], len(class_ids)

    def by_groups(fn, masks, **kw):
        """fn over the class groups in turn (each group's classes of every
        image together), its outputs joined back into (B, K, ...)."""
        masks = masks.unflatten(0, (b, k))
        parts = [[out.unflatten(0, (b, c.stop - c.start))
                  for out in fn(masks[:, c].flatten(0, 1), angles, shifts, sr_cfg, **kw)]
                 for c in chunks]
        return [torch.cat(p, dim=1) if len(p) > 1 else p[0] for p in zip(*parts)]

    targets: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    if "max" in sr_types or "mean" in sr_types:
        with _stage(timer, "max_mean"):
            mx, mean = by_groups(multiclass_max_mean_superresolution, class_masks)
            mx_m, mean_m = (by_groups(multiclass_max_mean_superresolution, max_masks)
                            if slice_max else (None, None))
        targets["max"], targets["mean"] = (mx, mx_m), (mean, mean_m)
    if "aug" in sr_types:
        aug = dict(gram_coeffs=gram_coeffs, timer=timer,  # stages b and solve_steps
                   dropout_generator=dropout_generator)
        targets["aug"] = (
            by_groups(augmented_superresolution, class_masks, **aug)[0],
            by_groups(augmented_superresolution, max_masks, **aug)[0] if slice_max else None)

    results: Dict[str, torch.Tensor] = {}
    with _stage(timer, "threshold"):
        th_value = cls.to(torch.float32)[:, None, None, None]
        for sr_type in sr_types:
            target_class, target_max = targets[sr_type]
            results[sr_type] = threshold_image(target_class, th_value, th_factor,
                                               th_mask=target_max)
            if return_targets:
                results[sr_type + "_target"] = target_class.to(torch.float32)

    with _stage(timer, "standard"):
        standard = _standard_labels(model, preds)                  # (B, H, W, 1)
        results["standard"] = ((standard[:, None] == cls[:, None, None, None])
                               .to(torch.float32) * cls[:, None, None, None])
        if return_label_map and "aug" in targets:
            label = combine_label_map(targets["aug"][0], class_ids, th_factor,
                                      rule=label_map_rule)
            results["label_map"] = label.to(torch.float32)
            results["label_map_standard"] = standard.to(torch.float32)
    return results if batched else {k: v[0] for k, v in results.items()}
