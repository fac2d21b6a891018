"""Score the full-scene HR label map (``asr_step_multiclass`` with
``return_label_map``) against the plain model's upsampled argmax.

Port of the JAX repository's ``scripts/label_map_eval.py``. The reference
recovers ONE class per staged run and has no full-scene HR segmentation.
On held-out scenes that hold at least two of the classes, the multi-class
ASR step (one forward and one Gram stencil shared by every class, a solve
per class) reports

  * the mean IoU of ``label_map`` (per-class aug-SR targets, the best class
    above threshold per pixel), and
  * the mean IoU of ``label_map_standard`` (the plain model's upsampled
    argmax, what a user gets without ASR),

and with --rules, the other rules of ``sr.combine_label_map`` on the same
targets. The JSON has the JAX script's keys.

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.label_map_eval \\
        --load_params ckpt.npz --hard --out label_map_hard.json

Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli._common import add_device_arg
from ..data.synthetic import synthetic_scene
from ..metrics import mean_iou, single_class_iou
from ..models import DeepLabConfig, build_model
from ..pipeline import asr_step_multiclass
from ..sr import combine_label_map, precompute_gram_stencil
from .common import fixed_tta, shift_max, sr_config, write_json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--load_params", required=True, nargs="+",
                    help=".npz checkpoint(s) (quality_demo / per_class_validation "
                         "--save_params or cli.train output, either package's). With "
                         "several, every checkpoint is scored on the SAME scenes, TTA "
                         "set and stencil, one arm per checkpoint in the JSON")
    ap.add_argument("--backbone", default="xception", choices=["xception", "mobilenet"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--eval_images", type=int, default=20)
    ap.add_argument("--class_ids", type=int, nargs="+", default=[8, 12])
    ap.add_argument("--num_aug", type=int, default=100)
    ap.add_argument("--num_iter", type=int, default=300)
    ap.add_argument("--th_factor", type=float, default=0.65)
    ap.add_argument("--class_chunk", type=int, default=0)
    ap.add_argument("--hard", action="store_true", help="hard-scene recipe (data/synthetic.py)")
    ap.add_argument("--seed", type=int, default=4321)
    ap.add_argument("--rules", nargs="+", default=None,
                    choices=["class_peak", "scene_peak", "raw", "gated"],
                    help="ALSO score these cross-class combination rules "
                         "(sr.combine_label_map) from the same per-class SR targets")
    ap.add_argument("--raw_th", type=float, default=0.5,
                    help="absolute score floor for the 'raw' rule")
    ap.add_argument("--out", default="label_map_eval.json")
    return add_device_arg(ap)


def held_out_scenes(seed: int, n: int, size: int, class_ids: List[int], hard: bool):
    """n scenes that hold at least two of class_ids (the JAX script's numpy
    stream)."""
    rng = np.random.default_rng(seed)
    want = set(class_ids)
    scenes = []
    while len(scenes) < n:
        img, lab = synthetic_scene(rng, (size, size), class_ids=tuple(class_ids),
                                   max_shapes=4, hard=hard)
        if len(set(np.unique(lab).tolist()) & want) >= 2:
            scenes.append((img, lab))
    return scenes


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    size = args.size
    model_cfg = DeepLabConfig(input_shape=(size, size, 3), classes=21,
                              backbone=args.backbone, weights=None, final_upsample=False,
                              compute_dtype="bfloat16")
    arms = {os.path.splitext(os.path.basename(path))[0]:
            build_model(model_cfg, seed=0, weights_path=path, device=device)
            for path in args.load_params}
    sr_cfg = sr_config(size, args.backbone, args.num_aug, args.num_iter)
    scenes = held_out_scenes(args.seed, args.eval_images, size, args.class_ids, args.hard)
    print(f"[label_map_eval] {len(scenes)} held-out scenes with >=2 of classes "
          f"{sorted(set(args.class_ids))}", flush=True)
    angles, shifts = fixed_tta(args.seed, args.num_aug, shift_max(size), device)
    gram_coeffs = precompute_gram_stencil(angles, shifts, sr_cfg)

    def evaluate(model, label):
        lm_ious, std_ious = [], []
        rule_ious = {r: [] for r in (args.rules or [])}
        per_class = {c: {"lm": [], "std": []} for c in args.class_ids}
        t0 = time.time()
        for i, (img, lab) in enumerate(scenes):
            out = asr_step_multiclass(
                model, torch.as_tensor(img, device=device), angles, shifts, sr_cfg,
                class_ids=tuple(args.class_ids), mode="argmax",
                th_factor=args.th_factor, class_chunk=args.class_chunk,
                gram_coeffs=gram_coeffs, return_label_map=True,
                return_targets=bool(args.rules))
            lm = out["label_map"][..., 0].cpu().numpy()
            std = out["label_map_standard"][..., 0].cpu().numpy()
            lm_ious.append(float(mean_iou(lab, lm)))
            std_ious.append(float(mean_iou(lab, std)))
            for r in rule_ious:
                alt = combine_label_map(out["aug_target"], args.class_ids,
                                        args.raw_th if r == "raw" else args.th_factor,
                                        rule=r)
                rule_ious[r].append(float(mean_iou(lab, alt[..., 0].cpu().numpy())))
            for c in args.class_ids:
                if (lab == c).any():
                    per_class[c]["lm"].append(float(single_class_iou(lab, lm, c)))
                    per_class[c]["std"].append(float(single_class_iou(lab, std, c)))
            print(f"[label_map_eval] {label} scene {i}: label_map {lm_ious[-1]:.4f} "
                  f"standard {std_ious[-1]:.4f}"
                  + "".join(f" {r} {rule_ious[r][-1]:.4f}" for r in rule_ious),
                  flush=True)
        return {
            **({"by_rule": {
                r: {"mean_iou": round(float(np.mean(v)), 4),
                    "minus_standard": round(float(np.mean(v)) - float(np.mean(std_ious)),
                                            4),
                    "win_rate_vs_standard": round(
                        float(np.mean([a >= b for a, b in zip(v, std_ious)])), 3)}
                for r, v in rule_ious.items()}} if rule_ious else {}),
            "eval_s": round(time.time() - t0, 1),
            "label_map_mean_iou": round(float(np.mean(lm_ious)), 4),
            "label_map_standard_mean_iou": round(float(np.mean(std_ious)), 4),
            "label_map_minus_standard": round(
                float(np.mean(lm_ious)) - float(np.mean(std_ious)), 4),
            "win_rate_vs_standard": round(
                float(np.mean([a >= b for a, b in zip(lm_ious, std_ious)])), 3),
            "per_class_iou": {
                str(c): {"label_map": round(float(np.mean(v["lm"])), 4),
                         "standard": round(float(np.mean(v["std"])), 4),
                         "n": len(v["lm"])}
                for c, v in per_class.items() if v["lm"]},
        }

    shared = {
        "backbone": args.backbone, "size": size,
        "eval_images": len(scenes), "class_ids": args.class_ids,
        "num_aug": args.num_aug, "num_iter": args.num_iter,
        "th_factor": args.th_factor, "hard_scenes": args.hard,
        "class_chunk": args.class_chunk,
        "loaded_params": args.load_params, "seed": args.seed,
        "note": ("label_map = full-scene HR segmentation from per-class aug-SR targets "
                 "(the reference has no such product: one class per staged run); "
                 "standard = plain upsampled argmax labels from the same forward"),
    }
    blocks = {label: evaluate(model, label) for label, model in arms.items()}
    if len(blocks) == 1:
        result = {**shared, **next(iter(blocks.values()))}
        headline = {k: result[k] for k in
                    ("label_map_mean_iou", "label_map_standard_mean_iou",
                     "label_map_minus_standard", "win_rate_vs_standard")}
    else:
        result = {**shared, "arms": blocks,
                  "paired_design": ("identical scenes + TTA set + Gram stencil for "
                                    "every checkpoint")}
        headline = {label: {
            "label_map_mean_iou": b["label_map_mean_iou"],
            "label_map_minus_standard": b["label_map_minus_standard"],
            "win_rate_vs_standard": b["win_rate_vs_standard"],
            **({"by_rule": b["by_rule"]} if "by_rule" in b else {})}
            for label, b in blocks.items()}
    write_json(args.out, result)
    print(json.dumps(headline))
    return result


if __name__ == "__main__":
    main()
