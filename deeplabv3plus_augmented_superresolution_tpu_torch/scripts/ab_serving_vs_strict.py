"""Serving-vs-strict quality A/B at production shape (512 px, 100 copies).

Port of the JAX repository's ``scripts/ab_serving_vs_strict.py``. Serving
draws ONE fixed TTA set for the whole run where the reference draws a fresh
set per image (generate_augmented_copies.py:41-44 + augmentation_utils.py:
14-15). The claim is that the SR outputs depend on the set only through its
statistics: any 100-draw uniform set recovers the same masks.

For N variants of one image (rolls, flips and gamma of a fixed input), the
full fused pipeline runs twice, once with the run's fixed set and once with
the variant's own draw, and the script reports each SR type's mask
disagreement and each arm's IoU against the model's own standard mask.
Random weights suffice: the claim is about the TTA sets' statistics, not
about segmentation quality.

Documented bound: mean aug-mask disagreement < 1%, and the two arms'
standard-vs-SR IoUs agree to ~0.02.

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.ab_serving_vs_strict \\
        [--num_images 20]

``main`` decodes ``test_images/smoke_input.jpg`` (PIL or the native ring);
``serving_vs_strict`` takes the decoded image, for a machine without a JPEG
decoder. Runs on the card unless ``--device cpu``.
"""

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli import _common
from ..cli._common import SEED, add_device_arg, feature_size_of, make_sr_config
from ..data import load_image
from ..metrics import compute_iou
from ..models.deeplab import DeepLab
from ..pipeline import asr_step, sample_augmentations

SR_TYPES = ("aug", "max", "mean")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--num_images", type=int, default=20)
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--num_iter", type=int, default=300)
    parser.add_argument("--class_id", type=int, default=8)
    parser.add_argument("--backbone", type=str, default="xception")
    parser.add_argument("--weights_path", type=str, default=None)
    return add_device_arg(parser)


def variant(base: np.ndarray, i: int) -> np.ndarray:
    """Distinct inputs from one fixture: rolls, flips, gamma (host side)."""
    rng = np.random.default_rng(i)
    img = np.roll(base, (int(rng.integers(-96, 96)), int(rng.integers(-96, 96))),
                  axis=(0, 1))
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img ** float(rng.uniform(0.8, 1.25)))


def serving_vs_strict(base: np.ndarray, model: DeepLab, num_images: int = 20,
                      num_aug: int = 100, num_iter: int = 300, class_id: int = 8,
                      device="cuda") -> Dict:
    """The A/B on ``num_images`` variants of the decoded (H, W, 3) image in
    [0, 1]; prints each variant's disagreements and the summary with the
    bound check, and returns {"disagreement", "iou_fixed", "iou_per_image"}
    (each SR type's mean) and "bound_pass"."""
    device = torch.device(device)
    sr_cfg = make_sr_config(argparse.Namespace(num_iter=num_iter), num_aug=num_aug,
                            feature_size=feature_size_of(model.cfg),
                            output_size=model.cfg.input_shape[:2], angle_max=0.2)
    # The run's fixed serving set (what cli.run_asr uses by default).
    fixed = sample_augmentations(torch.Generator().manual_seed(SEED), num_aug, 0.15, 80,
                                 device=device)

    def masks(img, angles, shifts):
        out = asr_step(model, torch.as_tensor(img, device=device), angles, shifts,
                       sr_cfg, class_id, mode="argmax", th_factor=0.2)
        return {k: v.cpu().numpy() for k, v in out.items()}

    dis = {k: [] for k in SR_TYPES}
    iou_fix, iou_per = {k: [] for k in SR_TYPES}, {k: [] for k in SR_TYPES}
    for i in range(num_images):
        img = variant(base, i)
        own = sample_augmentations(torch.Generator().manual_seed(10_000 + i), num_aug,
                                   0.15, 80, device=device)
        m_fix = masks(img, *fixed)
        m_per = masks(img, *own)
        if not np.array_equal(m_fix["standard"], m_per["standard"]):
            raise AssertionError("standard mask must not depend on the TTA set")
        std = m_fix["standard"]
        for k in SR_TYPES:
            dis[k].append(float(np.mean(m_fix[k] != m_per[k])))
            iou_fix[k].append(compute_iou(std, m_fix[k], class_id=class_id))
            iou_per[k].append(compute_iou(std, m_per[k], class_id=class_id))
        print(f"img {i}: disagreement aug={dis['aug'][-1]:.4f} "
              f"max={dis['max'][-1]:.4f} mean={dis['mean'][-1]:.4f}", flush=True)

    print()
    summary = {"disagreement": {}, "iou_fixed": {}, "iou_per_image": {}}
    for k in SR_TYPES:
        d = float(np.mean(dis[k]))
        fx = float(np.nanmean(iou_fix[k]))
        pr = float(np.nanmean(iou_per[k]))
        summary["disagreement"][k], summary["iou_fixed"][k] = d, fx
        summary["iou_per_image"][k] = pr
        print(f"{k:5s}: mean mask disagreement {d:.4f} ({100 * d:.2f}%) | "
              f"IoU-vs-standard fixed={fx:.4f} per-image={pr:.4f} (delta {fx - pr:+.4f})")
    bound = summary["disagreement"]["aug"]
    summary["bound_pass"] = bound < 0.01
    print(f"\nBOUND CHECK: mean aug disagreement {100 * bound:.2f}% "
          f"{'< 1% PASS' if bound < 0.01 else '>= 1% FAIL'}")
    return summary


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    model = _common.build_deeplab(args.backbone, weights_path=args.weights_path,
                                  device=torch.device(args.device))
    base = load_image(os.path.join(REPO, "test_images", "smoke_input.jpg"),
                      image_size=_common.IMG_SIZE, normalize=True)
    return serving_vs_strict(np.asarray(base, np.float32), model, args.num_images,
                             args.num_aug, args.num_iter, args.class_id, args.device)


if __name__ == "__main__":
    main()
