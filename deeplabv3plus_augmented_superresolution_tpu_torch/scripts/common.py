"""Shared work of the quality-evidence scripts: training DeepLabV3+ on
synthetic scenes, the test-time augmentation (TTA) sets, the four arms'
IoUs and strict-JSON output.

The JAX repository's ``scripts/quality_demo.py``, ``ab_stats.py`` and
``per_class_validation.py`` each repeat this work; here it is written once.
Those scripts draw batches and TTA sets from jax.random, whose stream no
torch generator reproduces, so the port runs the same experiment, not the
same bits:

  * the scenes come from numpy's ``default_rng(seed)`` through
    ``data/synthetic.py``, as there, so the training and held-out scenes are
    the JAX run's;
  * each chunk of steps draws its batch indices and warp draws from a
    generator seeded with (seed, the steps done), as ``cli.train`` does;
  * a per-image TTA set comes from a generator seeded with (seed + 1, the
    image's index), so it does not depend on the order of the images or on
    the process (ROADMAP F5); the run's fixed set from one seeded with seed.
"""

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..cli.train import chunk_seed
from ..data.synthetic import synthetic_batch
from ..metrics import single_class_iou
from ..models import DeepLabConfig, build_model, init_params, params_from_jax
from ..models.deeplab import DeepLab
from ..models.optim import Schedule, TrainOptimizer
from ..models.train import MasterParams, build_train_step
from ..pipeline.augment import sample_augmentations, warp_augment_batch
from ..sr import OptimizerConfig, SRConfig

ARMS = ("aug", "max", "mean", "standard")
# The TTA sets' angle bound (rad); the SR config's angle_max is 0.16.
TTA_ANGLE_MAX = 0.15
# Steps per training chunk: the losses are fetched once per chunk.
TRAIN_CHUNK = 50

NumpyParams = Dict[str, Dict[str, np.ndarray]]


def stage(timer, name: str):
    """timer.stage(name), or nothing without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def shift_max(size: int) -> float:
    """The production 80-px shift bound scaled to the image size."""
    return 80.0 * size / 512.0


def train_config(backbone: str, size: int, alpha: float = 1.0,
                 compute_dtype: str = "bfloat16") -> DeepLabConfig:
    """The scripts' training model: 21 classes, random init, with the final
    upsample (labels at the input's resolution)."""
    return DeepLabConfig(input_shape=(size, size, 3), classes=21, backbone=backbone,
                         alpha=alpha, weights=None, final_upsample=True,
                         compute_dtype=compute_dtype)


def eval_model(params: NumpyParams, train_cfg: DeepLabConfig, size: int,
               device) -> DeepLab:
    """The training model's serving twin at ``size``: no final upsample."""
    cfg = dataclasses.replace(train_cfg, final_upsample=False,
                              input_shape=(size, size, 3))
    return build_model(cfg, params=params, device=device)


def sr_config(size: int, backbone: str, num_aug: int, num_iter: int,
              solver: str = "gram") -> SRConfig:
    """The reference's SR configuration of the quality scripts: lambda_tv
    0.3, lambda_L2 0.7, AMSGrad from 1e-3 decaying by 0.3 every 60 steps."""
    feat = size // (4 if backbone == "xception" else 8)
    return SRConfig(
        lambda_df=1.0, lambda_tv=0.3, lambda_L2=0.7, num_iter=num_iter,
        num_aug=num_aug, feature_size=(feat, feat), output_size=(size, size),
        angle_max=0.16, solver_impl=solver,
        optimizer=OptimizerConfig(learning_rate=1e-3, amsgrad=True,
                                  lr_scheduler=True, decay_steps=60, decay_rate=0.3))


def quality_scenes(seed: int, train_set: int, train_size: int, eval_images: int,
                   size: int, class_id: int, hard: bool):
    """The training scenes at train_size, then the held-out scenes at size
    that each hold class_id, from one numpy stream: (imgs, labs, eval_imgs,
    eval_labs). The scenes hold class_id and a second class (12, or 15 when
    class_id is 12). The training scenes are drawn even when a checkpoint is
    loaded, so the held-out scenes are those of the run that trained it."""
    class_ids = (class_id, 12 if class_id != 12 else 15)
    rng = np.random.default_rng(seed)
    imgs, labs = synthetic_batch(rng, train_set, size=(train_size, train_size),
                                 class_ids=class_ids, hard=hard)
    eval_imgs, eval_labs = synthetic_batch(rng, eval_images, size=(size, size),
                                           class_ids=class_ids, require_class=class_id,
                                           hard=hard)
    return imgs, labs, eval_imgs, eval_labs


def fixed_tta(seed: int, num_aug: int, shift: float, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The run's one TTA set (serving mode)."""
    return sample_augmentations(torch.Generator().manual_seed(int(seed)), num_aug,
                                TTA_ANGLE_MAX, shift, device=device)


def image_tta(seed: int, index: int, num_aug: int, shift: float, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image ``index``'s own TTA set (the reference's strict protocol): the
    same in any order and any process."""
    gen = torch.Generator().manual_seed(((int(seed) + 1) << 32) + int(index))
    return sample_augmentations(gen, num_aug, TTA_ANGLE_MAX, shift, device=device)


@dataclasses.dataclass
class TrainRun:
    """A training's result: the final params (reference layout, host), the
    loss of every step, the seconds from the scenes' upload to the last
    fetch, and at each milestone its params and its chunk's last loss."""
    params: NumpyParams
    losses: List[float]
    seconds: float
    snapshots: Dict[int, NumpyParams]
    loss_at: Dict[int, float]


def train_scenes(cfg: DeepLabConfig, imgs: np.ndarray, labs: np.ndarray, steps: int,
                 batch: int, lr: float, seed: int, device, warp_augment: bool = False,
                 remat: bool = False, milestones: Sequence[int] = (), timer=None,
                 log=print) -> TrainRun:
    """Adam(lr) with batch-statistics BatchNorm (momentum 0.9) from
    ``init_params(cfg, seed=0)`` on the scenes, kept on the device as
    uint8. Each step trains on ``batch`` scenes drawn with replacement;
    with warp_augment each batch first goes through ``warp_augment_batch``
    (+-0.15 rad, the size-scaled 80-px shift), the shear kernels on the
    card. Chunks of TRAIN_CHUNK steps, cut at the milestones; each chunk
    runs in ``stage(timer, "train_chunk")`` and ends with the fetch of its
    losses."""
    master = MasterParams(params_from_jax(init_params(cfg, seed=0)), device)
    tx = TrainOptimizer("adam", Schedule("constant", lr))
    opt_state = tx.init(master)
    step = build_train_step(DeepLab(cfg, device="meta"), tx, bn_momentum=0.9, remat=remat)
    shift = shift_max(cfg.input_shape[0])
    gen = torch.Generator(device=device)
    t0 = time.time()
    ds_img = torch.as_tensor((imgs * 255).astype(np.uint8), device=device)
    ds_lab = torch.as_tensor(labs.astype(np.uint8), device=device)
    stops = sorted({int(m) for m in milestones if 0 < m <= steps} | {steps})
    losses: List[float] = []
    snapshots: Dict[int, NumpyParams] = {}
    loss_at: Dict[int, float] = {}
    done = 0
    for stop in stops:
        while done < stop:
            n = min(TRAIN_CHUNK, stop - done)
            with stage(timer, "train_chunk"):
                gen.manual_seed(chunk_seed(seed, done))
                idx = torch.randint(0, ds_img.shape[0], (n, batch), generator=gen,
                                    device=device)
                chunk = []
                for i in range(n):
                    im = ds_img[idx[i]].float() / 255.0
                    lb = ds_lab[idx[i]]
                    if warp_augment:
                        im, lb = warp_augment_batch(gen, im, lb, angle_max=TTA_ANGLE_MAX,
                                                    shift_max=shift)
                    master, opt_state, loss = step(master, opt_state, im, lb)
                    chunk.append(loss)
                losses.extend(torch.stack(chunk).tolist())
            done += n
            log(f"step {done}/{steps} loss {losses[-1]:.4f}")
        if stop in milestones:
            snapshots[stop] = master.numpy_params()
            loss_at[stop] = losses[-1]
    return TrainRun(master.numpy_params(), losses, time.time() - t0, snapshots, loss_at)


def arm_ious(label: np.ndarray, out: Dict[str, torch.Tensor], class_id: int,
             arms: Sequence[str] = ARMS) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Each arm's single-class IoU against the label map, without and with
    the background class (the reference's SR_single_class.py:109-141)."""
    iou, iou_bg = {}, {}
    for arm in arms:
        mask = out[arm].cpu().numpy()
        iou[arm] = float(single_class_iou(label, mask, class_id))
        iou_bg[arm] = float(single_class_iou(label, mask, class_id, include_bg=True))
    return iou, iou_bg


def sanitize(x):
    """Non-finite floats -> None, recursively: the artifact stays strict
    JSON (bare NaN / Infinity are rejected by jq and JSON.parse)."""
    if isinstance(x, float) and not (x == x and abs(x) != float("inf")):
        return None
    if isinstance(x, dict):
        return {k: sanitize(v) for k, v in x.items()}
    if isinstance(x, list):
        return [sanitize(v) for v in x]
    return x


def write_json(path: str, result) -> None:
    with open(path, "w") as f:
        json.dump(sanitize(result), f, indent=2, allow_nan=False)
