"""Threshold-factor sweep (port of the JAX repository's
``cli/threshold_tests.py``; reference threshold_tests.py): one aug-SR solve
per staged image, scored at every th_factor of a grid; the per-factor
average IoU goes to experiments_data/th_<mode>_<num_samples>.csv (columns
th_factor, avg_iou, num_images).

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.threshold_tests \\
      --class_id 8 --no_validation

``main`` is the file side; its array core is ``threshold_ious``.
"""

import argparse
import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.io import load_image, load_sr_data
from ..data.paths import list_precomputed_data_paths
from ..metrics import compute_iou
from ..sr import SRConfig, augmented_superresolution, threshold_image
from ._common import IMG_SIZE, SEED, add_device_arg, add_sr_args, data_paths, make_sr_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--class_id", type=int, default=8, choices=range(21))
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true", default=True)
    parser.add_argument("--no_validation", dest="use_validation", action="store_false")
    parser.add_argument("--th_start", type=float, default=0.1)
    parser.add_argument("--th_stop", type=float, default=0.9)
    parser.add_argument("--th_step", type=float, default=0.05)
    parser.add_argument("--angle_max", type=float, default=0.5)
    parser.add_argument("--output_csv", type=str, default=None)
    add_sr_args(parser)
    add_device_arg(parser)
    return parser


def threshold_grid(start: float, stop: float, step: float) -> List[float]:
    """The th_factor grid, stop included, each rounded to 4 places."""
    return [round(float(t), 4) for t in np.arange(start, stop + 1e-9, step)]


def threshold_ious(sr_cfg: SRConfig, class_masks: torch.Tensor, angles: torch.Tensor,
                   shifts: torch.Tensor, true_mask: np.ndarray, class_id: int,
                   th_factors: Sequence[float]) -> List[float]:
    """One aug solve of a normalized (N, h, w, 1) stack (on the device of
    angles and shifts), thresholded at each th_factor; the class IoU of
    each mask against true_mask."""
    target, _ = augmented_superresolution(
        class_masks, angles, shifts, sr_cfg,
        dropout_generator=torch.Generator().manual_seed(SEED))
    masks = torch.stack([threshold_image(target, class_id, th_factor=t)
                         for t in th_factors]).cpu().numpy()
    return [compute_iou(true_mask, mask, class_id=class_id) for mask in masks]


def main(argv: Optional[List[str]] = None) -> Dict[float, float]:
    """Write the CSV; returns the average IoU per th_factor."""
    from tqdm import tqdm

    args = build_parser().parse_args(argv)
    paths = data_paths(args.use_validation, args.backbone, args.mode, args.class_id,
                       args.num_aug)
    path_list = list_precomputed_data_paths(paths["augmented_copies_dir"], sort=True)
    path_list = path_list[:args.num_samples] if args.num_samples else path_list
    if not path_list:
        raise SystemExit(f"No precomputed hdf5 files under {paths['augmented_copies_dir']}")
    device = torch.device(args.device)
    th_factors = threshold_grid(args.th_start, args.th_stop, args.th_step)
    rows: Dict[float, List[float]] = {t: [] for t in th_factors}
    for filepath in tqdm(path_list):
        try:
            class_masks, _, angles, shifts, filename = load_sr_data(
                filepath, num_aug=args.num_aug, global_normalize=True, device=device)
        except (OSError, KeyError, ValueError):
            print(f"File: {filepath} is invalid, skipping...")
            continue
        true_mask = load_image(
            os.path.join(paths["pascal_root"], "SegmentationClassAug", f"{filename}.png"),
            image_size=IMG_SIZE, normalize=False, is_png=True, resize_method="nearest")
        sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                                feature_size=tuple(class_masks.shape[1:3]),
                                output_size=IMG_SIZE)
        ious = threshold_ious(sr_cfg, class_masks, torch.as_tensor(angles, device=device),
                              torch.as_tensor(shifts, device=device), true_mask,
                              args.class_id, th_factors)
        for t, iou in zip(th_factors, ious):
            rows[t].append(iou)

    averages = {t: float(np.mean(v)) for t, v in rows.items()}
    out_csv = args.output_csv or os.path.join(
        os.getcwd(), "experiments_data", f"th_{args.mode}_{args.num_samples}.csv")
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["th_factor", "avg_iou", "num_images"])
        for t, v in rows.items():
            writer.writerow([t, averages[t], len(v)])
    print(f"{'th_factor':>9} {'avg_iou':>9} {'num_images':>10}")
    for t, v in rows.items():
        print(f"{t:>9} {averages[t]:>9.6f} {len(v):>10}")
    best = max(averages, key=averages.get)
    print(f"Best threshold: {best} (IoU {averages[best]:.4f}); wrote {out_csv}")
    return averages


if __name__ == "__main__":
    main()
