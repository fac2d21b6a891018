"""Per-class validation over all 20 foreground classes: the reference's
headline table (``argmax_validation_final.csv``: one row per VOC foreground
class, 6 IoU columns), made end to end from synthetic scenes.

Port of the JAX repository's ``scripts/per_class_validation.py``. The
reference makes that CSV with 20 separate staged runs against VOC and the
bonlime checkpoint, neither of which can be fetched here, so this script:

  1. trains ONE DeepLabV3+ from scratch on synthetic scenes drawn across
     all the classes (``data/synthetic.py``'s 20-colour palette);
  2. runs the multi-class ASR step (``pipeline.asr_step_multiclass``: one
     forward and one stencil shared by every class) once per held-out scene,
     each scene with its own TTA set (the reference's strict protocol);
  3. aggregates per class, over the scenes that hold it, the reference's 6
     IoU variants (SR_single_class.py:109-141): aug / standard with and
     without background, and max / mean SR;
  4. writes the CSV in the reference's schema and a JSON with the class
     averages beside the reference's published ones (the JAX script's keys).

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.per_class_validation \\
        --hard --modes argmax slice slice_max --out_prefix per_class

Runs on the card unless ``--device cpu``; ``--quick`` changes the sizes,
not the device.
"""

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli._common import add_device_arg
from ..data.synthetic import synthetic_batch, synthetic_scene
from ..metrics import single_class_iou
from ..models import resolve_params, save_params_npz
from ..pipeline import asr_step_multiclass
from .common import (ARMS, eval_model, image_tta, shift_max, sr_config, train_config,
                     train_scenes, write_json)

# The reference's published 20-class averages (final_validations CSVs)
# keyed by the mode names; slice is the reference's "slice_var" CSV.
REFERENCE_PUBLISHED = {
    "argmax": {"aug": 0.6841, "standard": 0.6751, "max": 0.6230,
               "mean": 0.6749, "aug_with_bg": 0.8148,
               "standard_with_bg": 0.8119},
    "slice": {"aug": 0.6103, "standard": 0.6751},
    "slice_max": {"aug": 0.4849, "standard": 0.6751},
}

CSV_HEADER = ('"Name","aug_iou_multiple","standard_iou_multiple",'
              '"aug_iou_single","standard_iou_single","max_iou","mean_iou"')
COLUMNS = ("aug_iou_multiple", "standard_iou_multiple", "aug_iou_single",
           "standard_iou_single", "max_iou", "mean_iou")
QUICK = dict(backbone="mobilenet", alpha=0.35, size=96, num_classes=4, train_steps=300,
             train_batch=4, train_set=32, lr=3e-3, scenes=6, min_class_n=2, num_aug=8,
             num_iter=30, compute_dtype="float32")


def build_parser(argv: List[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbone", default="xception", choices=["xception", "mobilenet"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--num_classes", type=int, default=20,
                    help="foreground classes validated (ids 1..N; 20 = the "
                         "reference's full VOC table)")
    ap.add_argument("--train_steps", type=int, default=1000)
    ap.add_argument("--train_batch", type=int, default=8)
    ap.add_argument("--train_set", type=int, default=320)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--scenes", type=int, default=120,
                    help="held-out eval scene pool; every scene is scored for each "
                         "class it contains")
    ap.add_argument("--min_class_n", type=int, default=10,
                    help="top up the pool with targeted scenes until every class "
                         "appears in at least this many")
    ap.add_argument("--max_shapes", type=int, default=4)
    ap.add_argument("--num_aug", type=int, default=100)
    ap.add_argument("--num_iter", type=int, default=300)
    ap.add_argument("--th_factor", type=float, default=0.65)
    ap.add_argument("--modes", nargs="+", default=["argmax"],
                    choices=["argmax", "slice", "slice_max"],
                    help="OPM modes; the reference publishes all three")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--hard", action="store_true",
                    help="de-saturated scene recipe (data/synthetic.py)")
    ap.add_argument("--warp_augment", action="store_true",
                    help="train on the TTA distribution (garbage-vote fix)")
    ap.add_argument("--class_chunk", type=int, default=0)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--save_params", default="")
    ap.add_argument("--load_params", default="")
    ap.add_argument("--train_only", action="store_true",
                    help="train + --save_params, then exit (a checkpoint for "
                         "label_map_eval and friends)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny configuration (explicit flags win); the device stays "
                         "--device")
    ap.add_argument("--out_prefix", default="per_class")
    add_device_arg(ap)
    if "--quick" in argv:
        ap.set_defaults(**QUICK)
    return ap


def scene_pool(rng: np.random.Generator, args, class_ids):
    """The held-out pool: args.scenes scenes, then targeted top-ups until
    every class appears in at least args.min_class_n of them (the JAX
    script's numpy stream)."""
    size = (args.size, args.size)
    eval_imgs, eval_labs = synthetic_batch(rng, args.scenes, size=size, class_ids=class_ids,
                                           max_shapes=args.max_shapes, hard=args.hard)
    eval_imgs, eval_labs = list(eval_imgs), list(eval_labs)
    counts = {c: 0 for c in class_ids}
    for lab in eval_labs:
        for c in np.unique(lab):
            if c in counts:
                counts[int(c)] += 1
    for c in class_ids:
        while counts[c] < args.min_class_n:
            # A scene whose shape pool holds c and two other classes, redrawn
            # until c survives occlusion.
            others = rng.choice([k for k in class_ids if k != c], size=2, replace=False)
            img, lab = synthetic_scene(rng, size, (c, int(others[0]), int(others[1])),
                                       max_shapes=args.max_shapes, hard=args.hard)
            if not np.any(lab == c):
                continue
            eval_imgs.append(img)
            eval_labs.append(lab)
            for k in np.unique(lab):
                if int(k) in counts:
                    counts[int(k)] += 1
    return eval_imgs, eval_labs, counts


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser(argv).parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(args.seed)
    class_ids = tuple(range(1, args.num_classes + 1))
    size = args.size

    # ---- 1. one model across all classes ----------------------------------
    train_cfg = train_config(args.backbone, size, args.alpha, args.compute_dtype)
    print(f"[per_class] generating {args.train_set} training scenes "
          f"({args.num_classes} classes, hard={args.hard})", flush=True)
    imgs, labs = synthetic_batch(rng, args.train_set, size=(size, size),
                                 class_ids=class_ids, max_shapes=args.max_shapes,
                                 hard=args.hard)
    if args.load_params:
        params = resolve_params(train_cfg, weights_path=args.load_params)
        final_loss, train_s = None, 0.0
        print(f"[per_class] loaded params from {args.load_params}")
    else:
        run = train_scenes(train_cfg, imgs, labs, args.train_steps, args.train_batch,
                           args.lr, args.seed, device, warp_augment=args.warp_augment,
                           log=lambda m: print(f"[per_class] {m}", flush=True))
        params, train_s, final_loss = run.params, run.seconds, run.losses[-1]
        print(f"[per_class] trained in {train_s:.1f}s "
              f"(loss {run.losses[0]:.3f} -> {final_loss:.4f})")
    del imgs, labs
    if args.save_params:
        save_params_npz(params, args.save_params)
        print(f"[per_class] params -> {args.save_params}")
    if args.train_only:
        print("[per_class] --train_only: skipping the validation phases")
        return None

    # ---- 2. held-out scene pool (every class >= min_class_n scenes) -------
    eval_imgs, eval_labs, counts = scene_pool(rng, args, class_ids)
    print(f"[per_class] eval pool: {len(eval_imgs)} scenes; per-class n: "
          f"{sorted(counts.values())}", flush=True)

    # ---- 3. multi-class ASR once per scene, per mode -----------------------
    model = eval_model(params, train_cfg, size, device)
    sr_cfg = sr_config(size, args.backbone, args.num_aug, args.num_iter)
    summary = {
        "backbone": args.backbone, "size": size,
        "num_classes": args.num_classes, "hard_scenes": args.hard,
        "warp_augment": args.warp_augment,
        "train_steps": 0 if args.load_params else args.train_steps,
        "train_loss_final": final_loss, "train_s": round(train_s, 1),
        "scenes": len(eval_imgs), "num_aug": args.num_aug,
        "num_iter": args.num_iter, "th_factor": args.th_factor,
        "seed": args.seed, "loaded_params": args.load_params or None,
        "modes": {},
    }
    json_path = f"{args.out_prefix}_validation.json"
    if os.path.exists(json_path):
        # A rerun of one mode keeps the modes an earlier run finished; this
        # run's modes overwrite theirs.
        try:
            with open(json_path) as f:
                summary["modes"].update(json.load(f).get("modes", {}))
        except (json.JSONDecodeError, OSError):
            pass  # a corrupt or partial file: start afresh

    for mode in args.modes:
        per_class = {c: {k: [] for k in COLUMNS} for c in class_ids}
        t0 = time.time()
        for i, (img, lab) in enumerate(zip(eval_imgs, eval_labs)):
            angles, shifts = image_tta(args.seed, i, args.num_aug, shift_max(size), device)
            out = asr_step_multiclass(
                model, torch.as_tensor(img, device=device), angles, shifts, sr_cfg,
                class_ids=class_ids, mode=mode, th_factor=args.th_factor,
                class_chunk=args.class_chunk)
            present = [int(c) for c in np.unique(lab) if c in per_class]
            # Fetch only the present classes' slices.
            idx = torch.as_tensor([c - 1 for c in present], device=device)
            out = {a: out[a][idx].cpu().numpy() for a in ARMS}
            for k, c in enumerate(present):
                d = per_class[c]
                d["aug_iou_single"].append(float(single_class_iou(lab, out["aug"][k], c)))
                d["aug_iou_multiple"].append(
                    float(single_class_iou(lab, out["aug"][k], c, include_bg=True)))
                d["standard_iou_single"].append(
                    float(single_class_iou(lab, out["standard"][k], c)))
                d["standard_iou_multiple"].append(
                    float(single_class_iou(lab, out["standard"][k], c, include_bg=True)))
                d["max_iou"].append(float(single_class_iou(lab, out["max"][k], c)))
                d["mean_iou"].append(float(single_class_iou(lab, out["mean"][k], c)))
            if (i + 1) % 20 == 0:
                print(f"[per_class] {mode}: scene {i + 1}/{len(eval_imgs)} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        eval_s = time.time() - t0

        rows = []
        for c in class_ids:
            means = {k: float(np.mean(v)) if v else float("nan")
                     for k, v in per_class[c].items()}
            means["n"] = len(per_class[c]["aug_iou_single"])
            rows.append((c, means))
        csv_path = f"{args.out_prefix}_validation_{mode}.csv"
        with open(csv_path, "w") as f:
            f.write(CSV_HEADER + "\n")
            for c, m in rows:
                f.write(f'"Class {c}",' + ",".join(f'"{m[k]}"' for k in COLUMNS) + "\n")

        avg = {k: float(np.mean([m[k] for _, m in rows])) for k in COLUMNS}
        summary["modes"][mode] = {
            "csv": csv_path, "eval_s": round(eval_s, 1),
            "class_avg": avg,
            "aug_minus_standard_single": round(
                avg["aug_iou_single"] - avg["standard_iou_single"], 4),
            "per_class_n": {c: m["n"] for c, m in rows},
            "reference_published_class_avg": REFERENCE_PUBLISHED.get(mode),
        }
        print(f"[per_class] {mode}: {args.num_classes}-class avg aug "
              f"{avg['aug_iou_single']:.4f} vs standard {avg['standard_iou_single']:.4f} "
              f"({avg['aug_iou_single'] - avg['standard_iou_single']:+.4f}); "
              f"max {avg['max_iou']:.4f} mean {avg['mean_iou']:.4f} -> {csv_path}",
              flush=True)
        # Written after each mode: a finished mode survives a later one's failure.
        write_json(json_path, summary)
    print(f"[per_class] summary -> {json_path}")
    return summary


if __name__ == "__main__":
    main()
