"""One-command mIoU-parity harness against the reference's published numbers
(port of the JAX repository's ``cli/validate_parity.py``).

The reference's quality bar is its committed experiment CSVs: per-class
final validations, the class-8 threshold sweeps, the best class-8 sweep run
and the robustness grid, whose aggregates are in
configs/reference_baselines.json with their tolerances. This harness reruns
those workloads end to end (validation, threshold, sweep, robustness) and
prints a PASS/FAIL table against them, so that the day a pretrained
checkpoint is at data/model_weights/, quality parity is one command:

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.validate_parity \\
      --weights_path <bonlime .h5> --workloads validation,threshold,sweep,robustness

instead of composing generate_augmented_copies / generate_standard_output /
SR_single_class / threshold_tests / check_robustness by hand (the
reference's own workflow, README.md:35-55).

``--smoke`` runs the same machinery tiny (the bundled fixture image, random
weights, MobileNetV2, 6 copies, 5 iterations, 2-point grids), without
weights or a VOC tree; its pass criteria are structural (every workload
runs, the CSVs land in the reference's schemas, the table renders), not
quality.

Each image draws its own augmentation set from a seed (the reference
redraws per image), 100 copies, 300 iterations, the mode's default
th_factor, and the six IoUs of SR_single_class.
"""

import argparse
import csv
import json
import math
import os
import random
import sys
from typing import List, Optional

import numpy as np
import torch

from ..data.io import load_image
from ..data.paths import filter_images_by_class, get_img_paths
from ..metrics import compute_iou
from ..models import default_weights_path
from ..pipeline import asr_step, sample_augmentations
from ..sr import threshold_image
from . import check_robustness
from ._common import (SEED, add_device_arg, build_deeplab, data_paths, feature_size_of,
                      make_sr_config)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
IOU_COLUMNS = ["aug_iou_single", "standard_iou_single", "aug_iou_multiple",
               "standard_iou_multiple", "max_iou", "mean_iou"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--weights_path", type=str, default=None,
                        help="bonlime .h5 checkpoint (default: data/model_weights/"
                             "<backbone>.h5); required for non-smoke runs")
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--modes", type=str, default="argmax",
                        help="comma list of OPMs for the validation workload "
                             "(argmax,slice,slice_max)")
    parser.add_argument("--workloads", type=str,
                        default="validation,threshold,sweep,robustness")
    parser.add_argument("--classes", type=str, default="",
                        help="comma list of class ids for validation "
                             "(default 1..20, the reference's per-class runs)")
    parser.add_argument("--num_samples_per_class", type=int, default=0,
                        help="validation images per class (0 = all containing it)")
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--num_iter", type=int, default=300)
    parser.add_argument("--angle_max_gen", type=float, default=0.15,
                        help="TTA angle draw bound (reference test_SR.py:24)")
    parser.add_argument("--shift_max_gen", type=float, default=80.0)
    parser.add_argument("--threshold_class", type=int, default=8)
    parser.add_argument("--threshold_samples", type=int, default=500)
    parser.add_argument("--robustness_samples", type=int, default=350)
    parser.add_argument("--robustness_grid", type=str, default="coarse",
                        choices=["coarse", "full"],
                        help="full = the reference's 29x9x9 grid; coarse = the "
                             "5x3x3 subgrid containing the compared aggregates")
    parser.add_argument("--baselines", type=str,
                        default=os.path.join(REPO, "configs", "reference_baselines.json"))
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--batch", type=int, default=1,
                        help="images per device program (accepted for the JAX "
                             "CLI's flag set; the harness steps one image at a time)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny end-to-end run on the bundled fixture with "
                             "random weights (structural pass criteria)")
    add_device_arg(parser)
    return parser


def _th_default(mode: str) -> float:
    # the reference's defaults: 0.2 for argmax (test_SR.py:35), 0.65 for the
    # slice modes (SR_single_class.py:28)
    return 0.2 if mode == "argmax" else 0.65


class Harness:
    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = torch.device(args.device)
        self.rows = []  # (workload, name, ours, ref, tol, ok, note)
        with open(args.baselines) as f:
            self.baselines = json.load(f)
        self.out_dir = args.output_dir or os.path.join(os.getcwd(), "experiments_data",
                                                       "parity")
        os.makedirs(self.out_dir, exist_ok=True)
        self.model = build_deeplab(args.backbone, args.weights_path, device=self.device)
        self.img_size = self.model.cfg.input_shape[:2]

    # -- data ---------------------------------------------------------------

    def _val_paths(self, class_id: int, limit: int) -> List[str]:
        if self.args.smoke:
            return [os.path.join(REPO, "test_images", "smoke_input.jpg")]
        paths = data_paths(use_validation=True, backbone=self.args.backbone)
        all_paths = get_img_paths(paths["image_list"], paths["imgs_path"], sort=True)
        return filter_images_by_class(all_paths, class_id, num_images=limit or None,
                                      image_size=self.img_size)

    def _gt_path(self, img_path: str) -> str:
        if self.args.smoke:
            return os.path.join(REPO, "test_images", "smoke_gt.png")
        return img_path.replace("JPEGImages", "SegmentationClassAug").replace(".jpg", ".png")

    def _load_pair(self, img_path: str):
        img = load_image(img_path, image_size=self.img_size, normalize=True)
        gt = load_image(self._gt_path(img_path), image_size=self.img_size,
                        normalize=False, is_png=True, resize_method="nearest")
        return img, gt

    # -- workloads ----------------------------------------------------------

    def _asr_masks(self, image, class_id: int, mode: str, th_factor: float, seed: int,
                   return_targets: bool = False, sr_overrides=None):
        """The ASR step of one image with its own augmentation set (the
        reference redraws per image), as numpy masks."""
        a = self.args
        angles, shifts = sample_augmentations(torch.Generator().manual_seed(seed),
                                              a.num_aug, a.angle_max_gen,
                                              a.shift_max_gen, device=self.device)
        # overrides (the sweep row's num_iter and lambdas) win over the
        # harness's defaults
        sr_kwargs = dict(num_aug=a.num_aug, feature_size=feature_size_of(self.model.cfg),
                         output_size=self.img_size, num_iter=a.num_iter,
                         angle_max=max(a.angle_max_gen + 0.05, 1e-3))
        sr_kwargs.update(sr_overrides or {})
        out = asr_step(self.model, torch.as_tensor(image, device=self.device), angles,
                       shifts, make_sr_config(None, **sr_kwargs), class_id, mode=mode,
                       th_factor=th_factor, return_targets=return_targets)
        return out

    def _six_ious(self, gt, masks, class_id: int):
        return {c: compute_iou(gt, masks[c.split("_")[0]], class_id=class_id,
                               include_bg=c.endswith("multiple"))
                for c in IOU_COLUMNS}

    def run_validation(self, mode: str):
        a = self.args
        classes = ([int(c) for c in a.classes.split(",") if c]
                   or ([8] if a.smoke else list(range(1, 21))))
        th = _th_default(mode)
        table = []
        for class_id in classes:
            paths = self._val_paths(class_id, a.num_samples_per_class)
            agg = {c: [] for c in IOU_COLUMNS}
            for i, p in enumerate(paths):
                img, gt = self._load_pair(p)
                out = self._asr_masks(img, class_id, mode, th,
                                      seed=SEED + 7919 * class_id + i)
                masks = {k: v.cpu().numpy() for k, v in out.items()}
                for c, v in self._six_ious(gt, masks, class_id).items():
                    agg[c].append(v)
            row = {"Name": f"Class {class_id}"}
            row.update({c: float(np.nanmean(agg[c])) if agg[c] else float("nan")
                        for c in IOU_COLUMNS})
            table.append(row)
            print(f"[validation/{mode}] {row['Name']}: aug={row['aug_iou_single']:.4f} "
                  f"std={row['standard_iou_single']:.4f} ({len(paths)} imgs)")
        out_csv = os.path.join(self.out_dir, f"{mode}_validation_final.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["Name"] + IOU_COLUMNS)
            w.writeheader()
            w.writerows(table)
        print(f"[validation/{mode}] wrote {out_csv}")
        ref = self.baselines["validation"].get(mode)
        tol = self.baselines["tolerances"]["validation_aggregate_iou"]
        for c in IOU_COLUMNS:
            ours = float(np.nanmean([r[c] for r in table]))
            want = ref["aggregate_mean"].get(c) if ref else None
            self._compare(f"validation/{mode}", c, ours, want, tol,
                          one_sided=not c.startswith("standard"))

    def run_threshold(self, mode: str = "argmax"):
        a = self.args
        class_id = a.threshold_class
        if a.smoke:
            th_grid = [0.2, 0.5]
            paths = self._val_paths(class_id, 1)
        else:
            th_grid = [round(0.1 + 0.05 * i, 4) for i in range(17)]
            paths = self._val_paths(class_id, a.threshold_samples)
        per_th = {t: [] for t in th_grid}
        for i, p in enumerate(paths):
            img, gt = self._load_pair(p)
            out = self._asr_masks(img, class_id, mode, th_grid[0], seed=SEED + i,
                                  return_targets=True)
            # one solve, many thresholds (reference threshold_tests.py:104)
            target = out["aug_target"]
            for t in th_grid:
                mask = threshold_image(target, class_id, th_factor=t).cpu().numpy()
                per_th[t].append(compute_iou(gt, mask, class_id=class_id))
        out_csv = os.path.join(self.out_dir, f"th_{mode}_{len(paths)}.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "Th_Value", "IoU"])
            for i, t in enumerate(th_grid):
                w.writerow([i, t, float(np.nanmean(per_th[t]))])
        print(f"[threshold/{mode}] wrote {out_csv}")
        means = {t: float(np.nanmean(v)) for t, v in per_th.items()}
        best_t = max(means, key=means.get)
        ref = self.baselines["threshold"].get(mode)
        tol = self.baselines["tolerances"]["threshold_best_iou"]
        self._compare(f"threshold/{mode}", "best_iou", means[best_t],
                      ref and ref["best_iou"], tol, one_sided=True,
                      note=f"@ th={best_t} (ref @ {ref['best_th_factor'] if ref else '?'})")

    def run_sweep(self):
        """The reference's best argmax class-8 sweep run: its configuration
        over the same class-8 subset, all six IoU aggregates compared."""
        a = self.args
        ref = self.baselines["sweep"]["argmax_class8"]
        cfg = ref["config"]
        class_id = cfg["class_id"]
        overrides = {k: cfg[k] for k in ("lambda_tv", "lambda_L2", "lambda_L1",
                                         "learning_rate", "decay_steps", "decay_rate")}
        if not a.smoke:
            overrides["num_iter"] = cfg["num_iter"]
        paths = self._val_paths(class_id, 1 if a.smoke else cfg["num_samples"])
        agg = {c: [] for c in IOU_COLUMNS}
        for i, p in enumerate(paths):
            img, gt = self._load_pair(p)
            out = self._asr_masks(img, class_id, "argmax", _th_default("argmax"),
                                  seed=SEED + i, sr_overrides=overrides)
            masks = {k: v.cpu().numpy() for k, v in out.items()}
            for c, v in self._six_ious(gt, masks, class_id).items():
                agg[c].append(v)
        row = {"Name": "best_argmax_sweep",
               **{k: cfg[k] for k in ("lambda_tv", "lambda_L2", "lambda_L1",
                                      "learning_rate", "num_iter", "num_aug")}}
        row.update({c: float(np.nanmean(agg[c])) if agg[c] else float("nan")
                    for c in IOU_COLUMNS})
        out_csv = os.path.join(self.out_dir, "sweep_best_argmax.csv")
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            w.writeheader()
            w.writerow(row)
        print(f"[sweep] wrote {out_csv} ({len(paths)} imgs)")
        tol = self.baselines["tolerances"]["sweep_iou"]
        for c in IOU_COLUMNS:
            self._compare("sweep/argmax_class8", c, row[c], ref["aggregate_mean"].get(c),
                          tol, one_sided=not c.startswith("standard"))

    def run_robustness(self):
        a = self.args
        # the full model (final upsample on), apart from the SR model
        wp = a.weights_path
        if wp is None and not a.smoke:
            wp = default_weights_path(a.backbone)
            wp = wp if os.path.exists(wp) else None
        model = build_deeplab(a.backbone, wp, device=self.device, final_upsample=True)
        if a.smoke:
            img_paths = self._val_paths(0, 1)
            angles, shift_vals = [0.0, 0.2], [0.0]
        else:
            paths = data_paths(use_validation=False, backbone=a.backbone)
            all_paths = get_img_paths(paths["image_list"], paths["imgs_path"], sort=True)
            img_paths = random.Random(SEED).sample(
                all_paths, min(a.robustness_samples, len(all_paths)))
            if a.robustness_grid == "full":
                angles = [round(-0.7 + 0.05 * i, 4) for i in range(29)]
                shift_vals = list(np.linspace(-80, 80, 9))
            else:
                angles = [-0.7, -0.35, 0.0, 0.35, 0.7]
                shift_vals = [-80.0, 0.0, 80.0]
        pairs = [self._load_pair(p) for p in img_paths]
        images = torch.as_tensor(np.stack([im for im, _ in pairs]), device=self.device)
        gts = torch.as_tensor(np.stack([gt for _, gt in pairs]), device=self.device)
        out_csv = os.path.join(self.out_dir, f"robustness_{len(img_paths)}_class_all.csv")
        results = {}
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Angle", "Shift_X", "Shift_Y", "mIoU"])
            for angle, sx, sy, miou in check_robustness.robustness_grid(
                    model, images, gts, angles, shift_vals, batch_size=16):
                results[(angle, sx, sy)] = miou
                w.writerow([angle, sx, sy, round(miou, 4)])
                f.flush()
        print(f"[robustness] wrote {out_csv}")
        ref = self.baselines["robustness"]
        tol = self.baselines["tolerances"]["robustness_identity_miou"]
        self._compare("robustness", "identity_miou", results.get((0.0, 0.0, 0.0)),
                      ref["identity_miou"], tol, one_sided=True)
        vals = [v for v in results.values() if not math.isnan(v)]
        if vals and not a.smoke:
            self._compare("robustness", "grid_max_miou", max(vals), ref["max_miou"],
                          tol, one_sided=True)

    # -- comparison / report --------------------------------------------------

    def _compare(self, workload, name, ours, ref, tol, one_sided=False, note=""):
        if self.args.smoke:
            # structural pass: the workload ran and produced a value
            ok = ours is not None
            note = (note + " smoke: structural check only").strip()
        elif ref is None:
            ok = True
            note = (note + " no reference baseline").strip()
        elif ours is None or math.isnan(ours):
            ok = False
            note = (note + " no finite result").strip()
        elif one_sided:
            ok = ours >= ref - tol  # better than the reference also passes
        else:
            ok = abs(ours - ref) <= tol
        self.rows.append((workload, name, ours, ref, tol, ok, note))

    def report(self) -> int:
        print()
        header = (f"{'workload':<22}{'metric':<26}{'ours':>9}{'ref':>9}"
                  f"{'tol':>7}  {'verdict':<8}note")
        print(header)
        print("-" * len(header))
        all_ok = True
        for wl, name, ours, ref, tol, ok, note in self.rows:
            all_ok &= ok
            o = "   --" if ours is None else f"{ours:9.4f}"
            r = "   --" if ref is None else f"{ref:9.4f}"
            print(f"{wl:<22}{name:<26}{o:>9}{r:>9}{tol:>7.3f}  "
                  f"{'PASS' if ok else 'FAIL':<8}{note}")
        print("-" * len(header))
        print(f"OVERALL: {'PASS' if all_ok else 'FAIL'}"
              + (" (smoke mode: structural checks only)" if self.args.smoke else ""))
        return 0 if all_ok else 1


def main(argv: Optional[List[str]] = None) -> None:
    """Run the workloads and exit with 0 when every row passes, else 1."""
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.num_aug, args.num_iter = 6, 5
        args.classes = args.classes or "8"
        args.threshold_class = 8
        args.modes = "argmax"
        args.backbone = "mobilenet"
    else:
        wp = args.weights_path or default_weights_path(args.backbone)
        if not os.path.exists(wp):
            raise SystemExit(
                f"No pretrained checkpoint at {wp}. Quality parity needs the bonlime "
                "weights (reference model.py:129-145); put them there, or run "
                "--smoke to exercise the harness.")
        paths = data_paths(use_validation=True, backbone=args.backbone)
        if not os.path.isdir(paths["imgs_path"]):
            raise SystemExit(f"No VOC tree at {paths['pascal_root']} (or run --smoke).")
    harness = Harness(args)
    for wl in (w.strip() for w in args.workloads.split(",") if w.strip()):
        if wl == "validation":
            for mode in args.modes.split(","):
                harness.run_validation(mode.strip())
        elif wl == "threshold":
            harness.run_threshold()
        elif wl == "sweep":
            harness.run_sweep()
        elif wl == "robustness":
            harness.run_robustness()
        else:
            raise SystemExit(f"unknown workload {wl!r}")
    sys.exit(harness.report())


if __name__ == "__main__":
    main()
