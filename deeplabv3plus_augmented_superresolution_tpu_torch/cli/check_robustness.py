"""Model-robustness grid study (port of the JAX repository's
``cli/check_robustness.py``; reference check_robustness.py): warp a fixed
image set over an (angle, shift_x, shift_y) grid, run the full model, and
record the mean IoU of each combination to CSV.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.check_robustness

A combination is one program on the device per batch of images: the images
warped bilinearly and their ground truth with the nearest mode (label
selection, no blending of class ids or of the 255 ignore label), both
through the shear kernels, the forward, the argmax and a per-image mean IoU
(``combo_iou_sums``). ``main`` is the file side (sampling, decode, CSV);
its array core is ``robustness_grid``.
"""

import argparse
import csv
import os
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.io import load_image
from ..data.paths import filter_images_by_class, get_img_paths
from ..metrics import batch_mean_iou
from ..models.deeplab import DeepLab
from ..ops.shear_warp import paeth_rotate_translate
from ._common import SEED, add_device_arg, build_deeplab, data_paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_samples", type=int, default=350)
    parser.add_argument("--class_id", type=int, default=None,
                        help="optional class filter; default random sample over all classes")
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true")
    parser.add_argument("--angle_range", type=float, default=0.7)
    parser.add_argument("--angle_step", type=float, default=0.05)
    parser.add_argument("--shift_max", type=float, default=80)
    parser.add_argument("--shift_steps", type=int, default=9)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--output_csv", type=str, default=None)
    parser.add_argument("--weights_path", type=str, default=None)
    add_device_arg(parser)
    return parser


def warp_batch(images: torch.Tensor, gts: torch.Tensor, angle: float, sx: float,
               sy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) images and (B, H, W, 1) labels rotated by angle and
    shifted by (sx, sy): the images bilinear, the labels as float32 with
    the nearest mode. Three kernel launches each on the card."""
    n = images.shape[0]
    angles = torch.full((n,), float(angle), dtype=torch.float32, device=images.device)
    shifts = torch.tensor([sx, sy], dtype=torch.float32, device=images.device).expand(n, 2)
    aug = paeth_rotate_translate(images, angles, shifts)
    gt_aug = paeth_rotate_translate(gts.to(torch.float32), angles, shifts,
                                    interpolation="nearest")
    return aug, gt_aug


@torch.no_grad()
def combo_iou_sums(model: DeepLab, images: torch.Tensor, gts: torch.Tensor,
                   angle: float, sx: float, sy: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One combination on one batch, on the device: (sum of the per-image
    mean IoUs, count of images with a class in their warped ground truth),
    so that a combination's mean weighs every image alike across ragged
    batches. model: the full model (final upsample on)."""
    aug, gt_aug = warp_batch(images, gts, angle, sx, sy)
    pred = torch.argmax(model(aug), dim=-1)
    ious = batch_mean_iou(gt_aug[..., 0], pred)
    valid = ~torch.isnan(ious)
    return torch.where(valid, ious, 0.0).sum(), valid.sum()


def robustness_grid(model: DeepLab, images: torch.Tensor, gts: torch.Tensor,
                    angles: Sequence[float], shift_vals: Sequence[float],
                    batch_size: int = 16) -> Iterator[Tuple[float, float, float, float]]:
    """(angle, shift_x, shift_y, mean IoU) of every combination, the images
    in batches of batch_size (the ragged tail batch included); the card's
    sums are fetched once a combination."""
    n_batches = -(-images.shape[0] // batch_size)
    for angle in angles:
        for sx in shift_vals:
            for sy in shift_vals:
                sums = [combo_iou_sums(model, images[b * batch_size:(b + 1) * batch_size],
                                       gts[b * batch_size:(b + 1) * batch_size],
                                       angle, sx, sy) for b in range(n_batches)]
                tot = float(sum(s for s, _ in sums))
                cnt = float(sum(c for _, c in sums))
                yield float(angle), float(sx), float(sy), (tot / cnt if cnt else float("nan"))


def main(argv: Optional[List[str]] = None) -> str:
    """Write the CSV; returns its path."""
    from tqdm import tqdm

    args = build_parser().parse_args(argv)
    paths = data_paths(args.use_validation, args.backbone)
    model = build_deeplab(args.backbone, args.weights_path, device=args.device,
                          final_upsample=True)
    image_size = model.cfg.input_shape[:2]
    rng = random.Random(SEED)
    image_paths = get_img_paths(paths["image_list"], paths["imgs_path"], sort=True)
    if args.class_id is not None:
        image_paths = filter_images_by_class(image_paths, args.class_id,
                                             num_images=args.num_samples,
                                             image_size=image_size)
    else:
        image_paths = rng.sample(image_paths, min(args.num_samples, len(image_paths)))

    print(f"Loading {len(image_paths)} images + GT masks...")
    images, gts = [], []
    for p in image_paths:
        images.append(load_image(p, image_size=image_size, normalize=True))
        gt_path = p.replace("JPEGImages", "SegmentationClassAug").replace("jpg", "png")
        gts.append(load_image(gt_path, image_size=image_size, normalize=False,
                              is_png=True, resize_method="nearest"))
    images = torch.as_tensor(np.stack(images), device=args.device)
    gts = torch.as_tensor(np.stack(gts), device=args.device)

    angles = np.arange(-args.angle_range, args.angle_range + 1e-6, args.angle_step)
    shift_vals = np.linspace(-args.shift_max, args.shift_max, args.shift_steps)
    class_tag = args.class_id if args.class_id is not None else "all"
    out_csv = args.output_csv or os.path.join(
        os.getcwd(), "experiments_data", f"robustness_{args.num_samples}_class_{class_tag}.csv")
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Angle", "Shift_x", "Shift_y", "Mean_IoU"])
        grid = robustness_grid(model, images, gts, angles, shift_vals, args.batch_size)
        for angle, sx, sy, miou in tqdm(grid, total=len(angles) * len(shift_vals) ** 2):
            writer.writerow([round(angle, 4), sx, sy, miou])
            f.flush()
    print(f"Wrote {out_csv}")
    return out_csv


if __name__ == "__main__":
    main()
