"""Train DeepLabV3+ from scratch (or from a checkpoint) on one card.

Port of the JAX repository's ``cli/train.py`` around ``models/train.py``,
with the same flags and defaults:

  * data: procedural synthetic scenes (``data/synthetic.py``), kept on the
    device as uint8; each chunk of ``--log_every`` steps draws its batch
    indices (and warp draws) from a device ``torch.Generator`` seeded with
    (``--seed``, the chunk's first step), so a resumed run sees the data the
    uninterrupted run saw. The losses are fetched once per chunk, not per
    step (the reference's ``lax.scan`` chunk);
  * ``--warp_augment``: every batch through ``warp_augment_batch``, i.e.
    the shear kernels (two warps of three launches a step);
  * the train step (bf16 or f32 forward, batch-statistics BatchNorm with the
    EMA of the moving statistics, cross-entropy ignoring 255, the optax
    optimizers), with ``--remat`` and ``--skip_nonfinite`` (default on);
  * held-out mIoU every ``--eval_every`` steps and at the end, through the
    inference forward (BatchNorm folded) built from the current params;
  * train-state .npz checkpoints every ``--ckpt_every`` steps under
    ``--ckpt_dir``, in the reference's layout (params, optimizer leaves,
    step: a checkpoint of either package resumes in the other and serves as
    any CLI's ``--weights_path``); ``--resume`` takes such a file or a
    params-only .npz; ``--save_params`` and ``--out`` (the summary JSON,
    with the reference's keys).

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.train \\
        --steps 600 --size 128 --out train_run.json [--warp_augment] [--remat]

Runs on the card unless ``--device cpu``. ``--devices``, ``--multihost``,
``--data voc`` and ``--ckpt_format orbax`` exit naming what they wait for.
"""

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.synthetic import synthetic_batch
from ..metrics import mean_iou
from ..models import (DeepLabConfig, init_params, params_from_jax, resolve_params,
                      save_params_npz)
from ..models.deeplab import DeepLab
from ..models.optim import make_optimizer
from ..models.train import MasterParams, make_train_step
from ..pipeline.augment import sample_warp_draws, warp_augment_batch_with_draws
from ..utils.checkpoint import load_train_state, restore_opt_state, save_train_state
from .run_asr import NOT_PORTED, SEED

ORBAX_NOT_PORTED = ("is not ported (ROADMAP ground rules: orbax checkpoints stay "
                    "on the JAX side; use the npz train state)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "voc"])
    ap.add_argument("--pascal_root", default="",
                    help="prepared VOC tree (--data voc; not ported yet)")
    ap.add_argument("--split", default="trainaug",
                    help="VOC split file (trainaug/valaug)")
    ap.add_argument("--augment", action="store_true",
                    help="host-side random_transform augmentation (VOC data)")
    ap.add_argument("--backbone", default="xception",
                    choices=["xception", "mobilenet"])
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=128,
                    help="training resolution (params are resolution-free; "
                         "evaluate/serve at any other size)")
    ap.add_argument("--classes", type=int, default=21)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block's activations in the backward "
                         "pass (torch.utils.checkpoint): the same numbers, "
                         "less memory, for high-res batches")
    ap.add_argument("--warp_augment", action="store_true",
                    help="train on the TTA distribution: per-sample random "
                         "rotate+translate with zero fill, black borders "
                         "labeled background (warp_augment_batch)")
    ap.add_argument("--warp_angle_max", type=float, default=0.15)
    ap.add_argument("--warp_shift_max", type=float, default=-1.0,
                    help="-1 = scale the production 80px to --size")
    ap.add_argument("--skip_nonfinite", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="atomically skip steps whose loss/grads are "
                         "non-finite (models/train.py); "
                         "--no-skip_nonfinite disables")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8, help="batch size")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "sgd"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_schedule", default="constant",
                    choices=["constant", "cosine", "exponential"])
    ap.add_argument("--warmup_steps", type=int, default=50)
    ap.add_argument("--decay_steps", type=int, default=200)
    ap.add_argument("--decay_rate", type=float, default=0.5)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--grad_clip", type=float, default=0.0)
    ap.add_argument("--bn_momentum", type=float, default=0.9)
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel over N cards (not ported yet)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-host data parallelism (not ported yet)")
    ap.add_argument("--train_set", type=int, default=128,
                    help="synthetic: number of generated training scenes")
    ap.add_argument("--hard", action="store_true",
                    help="synthetic: de-saturated hard-scene recipe")
    ap.add_argument("--class_ids", type=int, nargs="+", default=[8, 12],
                    help="synthetic: foreground class ids")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="evaluate held-out mIoU every N steps (0 = only at "
                         "the end)")
    ap.add_argument("--eval_images", type=int, default=16)
    ap.add_argument("--log_every", type=int, default=50,
                    help="steps per chunk: the losses are fetched, logged, "
                         "checkpointed and evaluated at chunk ends")
    ap.add_argument("--ckpt_dir", default="", help="write step_<N>.npz checkpoints here")
    ap.add_argument("--ckpt_every", type=int, default=200)
    ap.add_argument("--ckpt_format", default="npz", choices=["npz", "orbax"],
                    help="npz: one flat .npz per checkpoint (also valid as "
                         "any CLI's --weights_path); orbax is not ported")
    ap.add_argument("--resume", default="",
                    help="checkpoint to start from: a train-state .npz "
                         "restores params + optimizer moments + schedule step "
                         "and runs --steps more steps; a params-only .npz "
                         "warm-starts params only")
    ap.add_argument("--save_params", default="trained_params.npz",
                    help="final params .npz ('' to skip)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default="", help="write the run summary as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device (the shear kernels need 'cuda'; 'cpu' "
                         "runs the plain versions)")
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse; flags that select a path the port does not have exit with a
    message naming it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    checks = [
        (args.devices != 0, "--devices", NOT_PORTED.format("parallel/")),
        (args.multihost, "--multihost", NOT_PORTED.format("parallel/")),
        (args.data == "voc", "--data voc",
         NOT_PORTED.format("the remaining CLIs and host side")),
        (args.ckpt_format == "orbax", "--ckpt_format orbax", ORBAX_NOT_PORTED),
        (bool(args.resume) and os.path.isdir(args.resume),
         "--resume from a checkpoint directory", ORBAX_NOT_PORTED),
    ]
    problems = [f"{flag} {msg}" for bad, flag, msg in checks if bad]
    if problems:
        ap.error("; ".join(problems))
    return args


def synthetic_eval_fn(args, cfg: DeepLabConfig, eval_imgs: np.ndarray,
                      eval_labs: np.ndarray, device: torch.device):
    """mIoU of the inference-mode forward (BatchNorm folded from the current
    moving statistics) over a held-out array batch."""
    model = DeepLab(cfg, device=device).eval().to(memory_format=torch.channels_last)
    images = torch.as_tensor(eval_imgs, device=device)

    @torch.no_grad()
    def evaluate(master: MasterParams) -> float:
        model.load_params(master.params)
        ious = []
        for start in range(0, images.shape[0], args.batch):
            pred = model(images[start:start + args.batch]).argmax(-1).cpu().numpy()
            for t, p in zip(eval_labs[start:start + args.batch], pred):
                ious.append(mean_iou(t, p, cfg.classes))
        return float(np.nanmean(ious))

    return evaluate


def chunk_seed(seed: int, step: int) -> int:
    """The seed of the chunk that starts after ``step`` steps."""
    return (int(seed) << 32) + int(step)


def train(args: argparse.Namespace) -> Tuple[Dict, Dict]:
    """Run the training of ``args`` (from ``parse_args``). Returns (summary,
    timing): the summary has the reference's keys (``train_s`` from the
    data's generation to the final evaluation, as there); timing holds the
    host clock (s since the loop started) at the end of the first step
    (``first_step_s``, one synchronisation) and at each chunk's end
    (``chunk_ends``: (steps done, seconds), each after the chunk's losses
    were fetched)."""
    device = torch.device(args.device)
    cfg = DeepLabConfig(
        input_shape=(args.size, args.size, 3), classes=args.classes,
        backbone=args.backbone, alpha=args.alpha, weights=None,
        final_upsample=True, compute_dtype=args.compute_dtype)
    params = init_params(cfg, seed=args.seed)
    resume_leaves, start_step = None, 0
    if args.resume:
        params = resolve_params(cfg, params=params, weights_path=args.resume)
        if args.resume.endswith(".npz"):
            resume_leaves, start_step = load_train_state(args.resume)
        print(f"[train] resumed params from {args.resume}"
              + (f" at step {start_step} (full train state)"
                 if resume_leaves is not None else " (params only)"))
    master = MasterParams(params_from_jax(params), device)
    tx = make_optimizer(args)
    opt_state = tx.init(master)
    if resume_leaves is not None:
        try:
            restore_opt_state(opt_state, master, resume_leaves)
            print("[train] restored optimizer state (moments + schedule position)")
        except ValueError as e:
            print(f"[train] WARNING: checkpoint optimizer state does not fit the "
                  f"requested optimizer ({e}); starting the optimizer fresh")
    step = make_train_step(DeepLab(cfg, device="meta"), tx, bn_momentum=args.bn_momentum,
                           remat=args.remat, skip_nonfinite=args.skip_nonfinite)

    t0 = time.time()   # train_s counts from the data's generation, as the reference's
    rng = np.random.default_rng(args.seed)
    size = (args.size, args.size)
    imgs, labs = synthetic_batch(rng, args.train_set, size=size,
                                 class_ids=tuple(args.class_ids), hard=args.hard)
    eval_imgs, eval_labs = synthetic_batch(rng, args.eval_images, size=size,
                                           class_ids=tuple(args.class_ids),
                                           hard=args.hard)
    evaluate = synthetic_eval_fn(args, cfg, eval_imgs, eval_labs, device)
    ds_img = torch.as_tensor((imgs * 255).astype(np.uint8), device=device)
    ds_lab = torch.as_tensor(labs.astype(np.uint8), device=device)
    shift_max = (args.warp_shift_max if args.warp_shift_max >= 0
                 else 80.0 * args.size / 512.0)
    gen = torch.Generator(device=device)

    def maybe_checkpoint(done: int) -> None:
        if not (args.ckpt_dir and done % args.ckpt_every == 0):
            return
        path = os.path.join(args.ckpt_dir, f"step_{done}.npz")
        save_train_state(path, master, opt_state, done)
        print(f"[train] checkpoint -> {path}")

    losses: List[float] = []
    evals: Dict[int, float] = {}
    timing: Dict = {"first_step_s": None, "chunk_ends": []}
    total_steps = start_step + args.steps
    t_loop = time.time()
    done = start_step
    while done < total_steps:
        n = min(args.log_every, total_steps - done)
        gen.manual_seed(chunk_seed(args.seed, done))
        idx = torch.randint(0, ds_img.shape[0], (n, args.batch), generator=gen,
                            device=device)
        if args.warp_augment:
            draws = sample_warp_draws(gen, (n, args.batch), args.warp_angle_max,
                                      shift_max, device=device)
        chunk = []
        for i in range(n):
            im = ds_img[idx[i]].float() / 255.0
            lb = ds_lab[idx[i]]
            if args.warp_augment:
                im, lb = warp_augment_batch_with_draws(im, lb, *(d[i] for d in draws))
            master, opt_state, loss = step(master, opt_state, im, lb)
            chunk.append(loss)
            if timing["first_step_s"] is None:
                loss.item()
                timing["first_step_s"] = time.time() - t_loop
        losses.extend(torch.stack(chunk).tolist())  # the chunk's one fetch
        done += n
        timing["chunk_ends"].append((done, time.time() - t_loop))
        print(f"[train] step {done}/{total_steps} loss {losses[-1]:.4f}", flush=True)
        maybe_checkpoint(done)
        if args.eval_every and done % args.eval_every == 0:
            evals[done] = evaluate(master)
            print(f"[train] step {done} held-out mIoU {evals[done]:.4f}")
    final_miou = evaluate(master)
    train_s = time.time() - t0

    if args.save_params:
        save_params_npz(master.numpy_params(), args.save_params)
        print(f"[train] final params -> {args.save_params} "
              "(drop into any CLI's --weights_path)")
    summary = {
        "backbone": args.backbone, "size": args.size, "steps": args.steps,
        "start_step": start_step, "total_steps": total_steps,
        "global_batch": args.batch, "devices": 1,
        "optimizer": args.optimizer, "lr_schedule": args.lr_schedule,
        "remat": args.remat, "compute_dtype": args.compute_dtype,
        "loss_first": losses[0] if losses else None,
        "loss_final": losses[-1] if losses else None,
        "losses": losses,
        "train_s": round(train_s, 1),
        "steps_per_s": round(args.steps / train_s, 3),
        "held_out_miou": final_miou, "evals": evals,
    }
    return summary, timing


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    summary, _ = train(args)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
