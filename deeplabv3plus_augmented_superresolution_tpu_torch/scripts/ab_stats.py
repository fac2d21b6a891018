"""Hard-regime A/B of aug SR against the standard mask, with a paired
bootstrap, along the calibration curve.

Port of the JAX repository's ``scripts/ab_stats.py``:

  1. trains ONE DeepLabV3+ from scratch on synthetic scenes, keeping its
     params at calibration milestones (default 150/300/600/1200 steps: 150
     is the soft-logit regime most like the reference's bonlime checkpoint,
     1200 the saturated one);
  2. evaluates EVERY milestone on the SAME held-out scenes with the SAME
     fixed TTA set and its stencil (a paired design), through the full
     pipeline (512 px, 100 copies, argmax OPM, 300 AMSGrad steps of aug SR,
     max/mean and the standard mask);
  3. reports for each milestone a paired bootstrap CI (default 10k
     resamples) of mean(aug - standard) and of the win rate, in one JSON
     with the JAX script's keys.

The reference's comparison it instruments: aug 0.6841 vs standard 0.6751
(+0.9 pt) at bonlime calibration (argmax_validation_final.csv).

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.ab_stats \\
        --hard --out quality_hard_stats.json [--save_prefix ckpt_hard]

Runs on the card unless ``--device cpu``; ``--quick`` changes the sizes,
not the device.
"""

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cli._common import add_device_arg
from ..models import resolve_params, save_params_npz
from ..pipeline import asr_step
from ..sr import precompute_gram_stencil
from .common import (ARMS, arm_ious, eval_model, fixed_tta, quality_scenes, shift_max,
                     sr_config, train_config, train_scenes, write_json)

QUICK = dict(backbone="mobilenet", size=96, milestones=[20, 40], train_batch=4,
             train_set=16, lr=3e-3, eval_images=4, num_aug=8, num_iter=20, bootstrap=200,
             compute_dtype="float32")


def paired_bootstrap(deltas, n_boot, rng, wins=None):
    """Percentile bootstrap CI for the mean of paired deltas (and optionally
    the win rate over the same resamples)."""
    deltas = np.asarray(deltas, np.float64)
    n = len(deltas)
    idx = rng.integers(0, n, size=(n_boot, n))
    boot_means = deltas[idx].mean(axis=1)
    out = {
        "mean": float(deltas.mean()),
        "ci95": [float(np.percentile(boot_means, 2.5)),
                 float(np.percentile(boot_means, 97.5))],
        "p_mean_le_0": float((boot_means <= 0).mean()),
        "n": n, "n_boot": n_boot,
    }
    if wins is not None:
        wins = np.asarray(wins, np.float64)
        boot_wins = wins[idx].mean(axis=1)
        out["win_rate"] = float(wins.mean())
        out["win_rate_ci95"] = [float(np.percentile(boot_wins, 2.5)),
                                float(np.percentile(boot_wins, 97.5))]
    return out


def build_parser(argv: List[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbone", default="xception", choices=["xception", "mobilenet"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--milestones", type=int, nargs="+", default=[150, 300, 600, 1200],
                    help="training steps at which the params are kept and evaluated "
                         "(the calibration axis)")
    ap.add_argument("--train_batch", type=int, default=8)
    ap.add_argument("--train_set", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval_images", type=int, default=50)
    ap.add_argument("--num_aug", type=int, default=100)
    ap.add_argument("--num_iter", type=int, default=300)
    ap.add_argument("--class_id", type=int, default=8)
    ap.add_argument("--th_factor", type=float, default=0.65)
    ap.add_argument("--mode", default="argmax", choices=["argmax", "slice", "slice_max"])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--bootstrap", type=int, default=10000)
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--warp_augment", action="store_true")
    ap.add_argument("--save_prefix", default="",
                    help="save milestone params as <prefix>_s<step>.npz")
    ap.add_argument("--load_prefix", default="",
                    help="skip training; load <prefix>_s<step>.npz per milestone "
                         "(same seed => identical eval scenes)")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--quick", action="store_true",
                    help="tiny configuration (explicit flags win); the device stays "
                         "--device")
    ap.add_argument("--out", default="quality_stats.json")
    add_device_arg(ap)
    if "--quick" in argv:
        ap.set_defaults(**QUICK)
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser(argv).parse_args(argv)
    device = torch.device(args.device)
    size = args.size
    milestones = sorted(set(args.milestones))
    alpha = 0.35 if args.quick else 1.0
    train_cfg = train_config(args.backbone, size, alpha, args.compute_dtype)

    # The training scenes are drawn even under --load_prefix, so the held-out
    # scenes are those of the run that trained the checkpoints.
    print(f"[ab_stats] generating {args.train_set} training scenes (hard={args.hard})",
          flush=True)
    imgs, labs, eval_imgs, eval_labs = quality_scenes(
        args.seed, args.train_set, size, args.eval_images, size, args.class_id, args.hard)
    loss_at: Dict[int, float] = {}
    if args.load_prefix:
        ckpts = {}
        for m in milestones:
            path = f"{args.load_prefix}_s{m}.npz"
            ckpts[m] = resolve_params(train_cfg, weights_path=path)
            print(f"[ab_stats] loaded {path}")
        train_s = 0.0
    else:
        run = train_scenes(train_cfg, imgs, labs, milestones[-1], args.train_batch,
                           args.lr, args.seed, device, warp_augment=args.warp_augment,
                           milestones=milestones, log=lambda m: None)
        ckpts, loss_at, train_s = run.snapshots, run.loss_at, run.seconds
        for m in milestones:
            print(f"[ab_stats] milestone {m}: loss {loss_at[m]:.4f}", flush=True)
            if args.save_prefix:
                save_params_npz(ckpts[m], f"{args.save_prefix}_s{m}.npz")
    del imgs, labs

    # ---- paired eval: same scenes + same fixed TTA for every checkpoint ---
    sr_cfg = sr_config(size, args.backbone, args.num_aug, args.num_iter)
    fixed = fixed_tta(args.seed, args.num_aug, shift_max(size), device)
    gram_coeffs = precompute_gram_stencil(*fixed, sr_cfg)
    boot_rng = np.random.default_rng(args.seed + 7)
    curve = {}
    for m in milestones:
        model = eval_model(ckpts[m], train_cfg, size, device)
        per_scene = {a: [] for a in ARMS}
        t0 = time.time()
        for i in range(args.eval_images):
            out = asr_step(model, torch.as_tensor(eval_imgs[i], device=device), *fixed,
                           sr_cfg, args.class_id, mode=args.mode,
                           th_factor=args.th_factor, gram_coeffs=gram_coeffs)
            for a, v in arm_ious(eval_labs[i], out, args.class_id)[0].items():
                per_scene[a].append(v)
        eval_s = time.time() - t0
        deltas = [a - s for a, s in zip(per_scene["aug"], per_scene["standard"])]
        wins = [float(d >= 0) for d in deltas]
        stats = paired_bootstrap(deltas, args.bootstrap, boot_rng, wins=wins)
        curve[m] = {
            "train_loss": loss_at.get(m),
            "iou": {a: round(float(np.mean(per_scene[a])), 4) for a in ARMS},
            "aug_minus_standard": stats,
            "eval_s": round(eval_s, 1),
        }
        print(f"[ab_stats] ckpt@{m}: aug {curve[m]['iou']['aug']:.4f} vs "
              f"standard {curve[m]['iou']['standard']:.4f} "
              f"(delta {stats['mean']:+.4f}, 95% CI "
              f"[{stats['ci95'][0]:+.4f}, {stats['ci95'][1]:+.4f}], "
              f"win {stats['win_rate']:.0%} "
              f"CI [{stats['win_rate_ci95'][0]:.0%}, {stats['win_rate_ci95'][1]:.0%}])",
              flush=True)

    flagship = milestones[-1]
    result = {
        "backbone": args.backbone, "size": size, "mode": args.mode,
        "hard_scenes": args.hard, "warp_augment": args.warp_augment,
        "train_set": args.train_set, "lr": args.lr,
        "train_s": round(train_s, 1),
        "eval_images": args.eval_images, "num_aug": args.num_aug,
        "num_iter": args.num_iter, "th_factor": args.th_factor,
        "seed": args.seed, "bootstrap": args.bootstrap,
        "serving": True, "paired_design": ("identical scenes + identical fixed TTA "
                                           "set for every checkpoint"),
        "milestones": milestones,
        "flagship_step": flagship,
        "calibration_curve": {str(m): curve[m] for m in milestones},
        "flagship": curve[flagship],
        "reference_published": {"aug": 0.6841, "standard": 0.6751, "delta": 0.009,
                                "source": "argmax_validation_final.csv (VOC + bonlime, "
                                          "mIoU 0.68 calibration)"},
    }
    write_json(args.out, result)
    print(f"[ab_stats] -> {args.out}")
    return result


if __name__ == "__main__":
    main()
