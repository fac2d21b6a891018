"""End-to-end smoke run on the bundled cat image (port of the JAX
repository's ``cli/test_SR.py``; reference test_SR.py): ``asr_step`` with
aug, max and mean SR on one image, twice (first use, then steady), and the
IoUs of the masks and the standard baseline against the ground truth.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.test_SR [--plot]

``main`` is the file side; its array core is ``pipeline.asr_step``.
"""

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from ..data.io import load_image, save_img
from ..metrics import compute_iou
from ..pipeline import asr_step, sample_augmentations
from ._common import (SEED, add_device_arg, add_sr_args, build_deeplab, feature_size_of,
                      make_sr_config)

_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "test_images")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--img_path", type=str,
                        default=os.path.join(_FIXTURES, "smoke_input.jpg"))
    parser.add_argument("--gt_path", type=str,
                        default=os.path.join(_FIXTURES, "smoke_gt.png"))
    parser.add_argument("--output_dir", type=str,
                        default=os.path.join(os.getcwd(), "test_images", "SR_output"))
    parser.add_argument("--class_id", type=int, default=8)
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--angle_max", type=float, default=0.15)
    parser.add_argument("--shift_max", type=float, default=80)
    parser.add_argument("--th_factor", type=float, default=0.2)
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--plot", action="store_true",
                        help="save the input/GT/prediction+overlay panel")
    parser.add_argument("--weights_path", type=str, default=None)
    add_sr_args(parser)
    add_device_arg(parser)
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Returns the IoU of each mask (aug, max, mean, standard)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    model = build_deeplab(args.backbone, args.weights_path, device=device)
    img_size = model.cfg.input_shape[:2]
    sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                            feature_size=feature_size_of(model.cfg),
                            output_size=img_size, angle_max=args.angle_max)
    image = load_image(args.img_path, image_size=img_size, normalize=True)
    gt_mask = load_image(args.gt_path, image_size=img_size, normalize=False,
                         is_png=True, resize_method="nearest")
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED),
                                          args.num_aug, args.angle_max, args.shift_max,
                                          device=device)
    times = []
    for _ in range(2):   # first use, then steady
        start = time.perf_counter()
        out = asr_step(model, torch.as_tensor(image, device=device), angles, shifts,
                       sr_cfg, args.class_id, mode=args.mode, th_factor=args.th_factor)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        times.append(time.perf_counter() - start)

    ious = {k: compute_iou(gt_mask, v, class_id=args.class_id) for k, v in out.items()}
    print(f"Aug. SR ({args.mode} OPM) IoU: {ious['aug']}, Max SR IoU: {ious['max']}, "
          f"Mean SR IoU: {ious['mean']}, Standard IoU: {ious['standard']}")
    print(f"timing: first run {times[0]:.1f}s, steady {times[1]:.3f}s/image "
          f"({args.num_aug} copies, {sr_cfg.num_iter} iters, aug+max+mean)")
    name = os.path.splitext(os.path.basename(args.img_path))[0]
    if args.save_images:
        for sr_type in ("aug", "max", "mean"):
            save_img(os.path.join(args.output_dir, f"{sr_type}_SR",
                                  f"{name}_{sr_type}_SR.png"), out[sr_type], scale=True)
        print(f"saved outputs under {args.output_dir}")
    if args.plot:
        from ..utils.viz import plot_prediction

        input_image = load_image(args.img_path, image_size=img_size, normalize=False,
                                 resize_method="nearest")
        panel = os.path.join(args.output_dir, "prediction_panel.png")
        os.makedirs(args.output_dir, exist_ok=True)
        plot_prediction([input_image, gt_mask, out["aug"]], only_prediction=False,
                        show_overlay=True, save_path=panel)
        print(f"saved {panel}")
    return ious


if __name__ == "__main__":
    main()
