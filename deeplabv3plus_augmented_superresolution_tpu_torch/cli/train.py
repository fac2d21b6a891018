"""Train DeepLabV3+ from scratch (or from a checkpoint) on one card.

Port of the JAX repository's ``cli/train.py`` around ``models/train.py``,
with the same flags and defaults:

  * data: procedural synthetic scenes (``data/synthetic.py``), kept on the
    device as uint8; each chunk of ``--log_every`` steps draws its batch
    indices (and warp draws) from a device ``torch.Generator`` seeded with
    (``--seed``, the chunk's first step), so a resumed run sees the data the
    uninterrupted run saw. The losses are fetched once per chunk, not per
    step (the reference's ``lax.scan`` chunk);
  * or ``--data voc``: a prepared VOC tree (``--pascal_root``, the split's
    list at ``ImageSets/Segmentation/<--split>.txt``) through
    ``data.dataset.PascalVOC2012Dataset``: each epoch restarts its batches
    shuffled with ``--seed`` + the steps done, ``--augment`` runs
    ``host_augment.random_transform`` on the host, a thread prefetches the
    batches, each moves to the card as it is taken, and with
    ``--warp_augment`` its warp draws come from the generator seeded with
    (``--seed``, the step). The loss is fetched at each ``--log_every``
    step, as the reference records it; no held-out evaluation (run
    ``cli.validate_parity`` on the checkpoint);
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

Data parallel (``parallel/``): ``--devices N`` spawns N ranks, one per card
(NCCL; gloo ranks on the CPU with ``--device cpu``), and ``--multihost``
joins the process group of a torchrun launch, a rank per card:

    torchrun --nnodes 2 --nproc_per_node 4 ... -m \
        deeplabv3plus_augmented_superresolution_tpu_torch.cli.train --multihost

Every rank draws the same global batch and warp draws from the chunk's
generator and trains on its slice (``parallel.shard_train_batch``), with
synchronised BatchNorm and one all-reduce of the gradient, so a run on N
ranks takes the one-card run's steps on the same data. Rank 0 alone
evaluates and writes checkpoints, ``--save_params`` and ``--out``.

Runs on the card unless ``--device cpu``. ``--ckpt_format orbax`` exits
naming why it is not ported.
"""

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from ..data.dataset import PascalVOC2012Dataset
from ..data.synthetic import synthetic_batch
from ..metrics import mean_iou
from ..models import (DeepLabConfig, init_params, params_from_jax, resolve_params,
                      save_params_npz)
from ..models.deeplab import DeepLab
from ..models.optim import make_optimizer
from ..models.train import MasterParams, make_train_step
from ..parallel.mesh import (Mesh, default_backend, free_port, initialize_distributed,
                             make_mesh, make_multihost_mesh, rank_device)
from ..parallel.sharded import make_sharded_train_step, shard_train_batch
from ..pipeline.augment import sample_warp_draws, warp_augment_batch_with_draws
from ..utils.checkpoint import load_train_state, restore_opt_state, save_train_state
from ._common import SEED

ORBAX_NOT_PORTED = ("is not ported (ROADMAP ground rules: orbax checkpoints stay "
                    "on the JAX side; use the npz train state)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "voc"])
    ap.add_argument("--pascal_root", default="",
                    help="prepared VOC tree (cli/download_and_prepare_voc.py)")
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
                    help="data-parallel over N cards: N ranks, one per card "
                         "(0 or 1: one card)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-host data parallelism: join the process group "
                         "of a torchrun launch (one rank per card)")
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
    if args.devices > 1 and args.batch % args.devices:
        ap.error(batch_split_error(args.batch, args.devices))
    if args.data == "voc" and not args.pascal_root:
        ap.error("--data voc requires --pascal_root")
    checks = [
        (args.ckpt_format == "orbax", "--ckpt_format orbax", ORBAX_NOT_PORTED),
        (bool(args.resume) and os.path.isdir(args.resume),
         "--resume from a checkpoint directory", ORBAX_NOT_PORTED),
    ]
    problems = [f"{flag} {msg}" for bad, flag, msg in checks if bad]
    if problems:
        ap.error("; ".join(problems))
    return args


def batch_split_error(batch: int, ranks: int) -> str:
    """The JAX CLI's message for a batch that does not split over the mesh."""
    return f"--batch {batch} must divide the {ranks}-device mesh"


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


def train(args: argparse.Namespace, mesh: Optional[Mesh] = None,
          dataset: Optional[PascalVOC2012Dataset] = None) -> Tuple[Dict, Dict]:
    """Run the training of ``args`` (from ``parse_args``). Returns (summary,
    timing): the summary has the reference's keys (``train_s`` from the
    data's generation to the final evaluation, as there); timing holds the
    host clock (s since the loop started) at the end of the first step
    (``first_step_s``, one synchronisation) and at each chunk's end
    (``chunk_ends``: (steps done, seconds), each after the chunk's losses
    were fetched; with --data voc each --log_every step), and with --data
    voc ``prefetch_wait``: (steps done, seconds the loop had waited on the
    prefetch queue so far) at the same points.

    mesh: data parallel over its ranks (every rank calls train together,
    ``args.device`` its own device): each step's global batch of
    ``args.batch`` is drawn on every rank and each trains on its slice;
    the losses are the global batch's. Only rank 0 evaluates (the others'
    held-out mIoU is None) and writes checkpoints and ``--save_params``.

    dataset: with --data voc, the dataset to train on (e.g. one whose
    ``decode`` hands over arrays); by default one over ``args.pascal_root``
    at ``args.size``."""
    device = torch.device(args.device)
    lead = mesh is None or mesh.rank == 0
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
    if mesh is not None:
        if args.batch % mesh.size:
            raise SystemExit(batch_split_error(args.batch, mesh.size))
        step = make_sharded_train_step(mesh, DeepLab(cfg, device="meta"), tx,
                                       bn_momentum=args.bn_momentum, remat=args.remat,
                                       skip_nonfinite=args.skip_nonfinite)
        if lead:
            print(f"[train] data-parallel over {mesh.size} devices (mesh {mesh.shape})")
    else:
        step = make_train_step(DeepLab(cfg, device="meta"), tx,
                               bn_momentum=args.bn_momentum, remat=args.remat,
                               skip_nonfinite=args.skip_nonfinite)

    t0 = time.time()   # train_s counts from the data's generation, as the reference's
    size = (args.size, args.size)
    shift_max = (args.warp_shift_max if args.warp_shift_max >= 0
                 else 80.0 * args.size / 512.0)
    gen = torch.Generator(device=device)

    def warp_draws(shape):
        return (sample_warp_draws(gen, shape, args.warp_angle_max, shift_max, device=device)
                if args.warp_augment else ())

    def train_step(im, lb, draws):
        """One step on this rank's slice of the global batch (im (B, H, W, 3)
        float in [0, 1] or uint8, lb (B, H, W), the warp draws of B)."""
        nonlocal master, opt_state
        if mesh is not None:
            im, lb = shard_train_batch(mesh, im, lb)
            draws = [shard_train_batch(mesh, d, d)[0] for d in draws]
        im = im.to(device, non_blocking=True)
        lb = lb.to(device, non_blocking=True)
        if im.dtype == torch.uint8:
            im = im.float() / 255.0
        if args.warp_augment:
            im, lb = warp_augment_batch_with_draws(im, lb, *draws)
        master, opt_state, loss = step(master, opt_state, im, lb)
        return loss

    def maybe_checkpoint(done: int) -> None:
        if not (lead and args.ckpt_dir and done % args.ckpt_every == 0):
            return
        path = os.path.join(args.ckpt_dir, f"step_{done}.npz")
        save_train_state(path, master, opt_state, done)
        print(f"[train] checkpoint -> {path}")

    losses: List[float] = []
    evals: Dict[int, float] = {}
    timing: Dict = {"first_step_s": None, "chunk_ends": []}
    total_steps = start_step + args.steps
    done = start_step

    def first_step(loss, t_loop):
        if timing["first_step_s"] is None:
            loss.item()
            timing["first_step_s"] = time.time() - t_loop

    if args.data == "voc":
        ds = dataset or PascalVOC2012Dataset(args.pascal_root, image_size=size)
        timing["prefetch_wait"] = []
        waited = 0.0
        t_loop = time.time()
        while done < total_steps:
            taken = 0
            with contextlib.closing(ds.batches(args.split, args.batch, shuffle=True,
                                               seed=args.seed + done,
                                               augment=args.augment)) as epoch:
                while done < total_steps:
                    t_wait = time.perf_counter()
                    batch = next(epoch, None)
                    waited += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    taken += 1
                    im, mk = batch
                    gen.manual_seed(chunk_seed(args.seed, done))
                    loss = train_step(torch.from_numpy(im),
                                      torch.from_numpy(mk[..., 0].astype(np.uint8)),
                                      warp_draws((args.batch,)))
                    done += 1
                    first_step(loss, t_loop)
                    if done % args.log_every == 0:
                        losses.append(loss.item())   # the log point's one fetch
                        timing["chunk_ends"].append((done, time.time() - t_loop))
                        timing["prefetch_wait"].append((done, waited))
                        if lead:
                            print(f"[train] step {done}/{total_steps} "
                                  f"loss {losses[-1]:.4f}", flush=True)
                    maybe_checkpoint(done)
            if not taken:
                raise SystemExit(f"--data voc: split {args.split!r} holds fewer than "
                                 f"--batch {args.batch} images, so an epoch has no batch")
        final_miou = None   # VOC evaluation: cli.validate_parity on the checkpoint
    else:
        rng = np.random.default_rng(args.seed)
        imgs, labs = synthetic_batch(rng, args.train_set, size=size,
                                     class_ids=tuple(args.class_ids), hard=args.hard)
        eval_imgs, eval_labs = synthetic_batch(rng, args.eval_images, size=size,
                                               class_ids=tuple(args.class_ids),
                                               hard=args.hard)
        evaluate = (synthetic_eval_fn(args, cfg, eval_imgs, eval_labs, device)
                    if lead else None)
        ds_img = torch.as_tensor((imgs * 255).astype(np.uint8), device=device)
        ds_lab = torch.as_tensor(labs.astype(np.uint8), device=device)
        t_loop = time.time()
        while done < total_steps:
            n = min(args.log_every, total_steps - done)
            gen.manual_seed(chunk_seed(args.seed, done))
            idx = torch.randint(0, ds_img.shape[0], (n, args.batch), generator=gen,
                                device=device)
            draws = warp_draws((n, args.batch))
            chunk = []
            for i in range(n):
                chunk.append(train_step(ds_img[idx[i]], ds_lab[idx[i]],
                                        [d[i] for d in draws]))
                first_step(chunk[-1], t_loop)
            losses.extend(torch.stack(chunk).tolist())  # the chunk's one fetch
            done += n
            timing["chunk_ends"].append((done, time.time() - t_loop))
            if lead:
                print(f"[train] step {done}/{total_steps} loss {losses[-1]:.4f}",
                      flush=True)
            maybe_checkpoint(done)
            if lead and args.eval_every and done % args.eval_every == 0:
                evals[done] = evaluate(master)
                print(f"[train] step {done} held-out mIoU {evals[done]:.4f}")
        final_miou = evaluate(master) if lead else None
    train_s = time.time() - t0

    if lead and args.save_params:
        save_params_npz(master.numpy_params(), args.save_params)
        print(f"[train] final params -> {args.save_params} "
              "(drop into any CLI's --weights_path)")
    summary = {
        "backbone": args.backbone, "size": args.size, "steps": args.steps,
        "start_step": start_step, "total_steps": total_steps,
        "global_batch": args.batch, "devices": mesh.size if mesh is not None else 1,
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


def _rank_main(rank: int, args: argparse.Namespace, port: int, out: str) -> None:
    """One rank of ``--devices``: joins the group (NCCL on cards, gloo on the
    CPU), takes card ``rank``, trains on the (1, N) mesh; rank 0 writes the
    summary to ``out``."""
    device = rank_device(args.device, local_rank=rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        default_backend(device), init_method=f"tcp://localhost:{port}",
        world_size=args.devices, rank=rank)
    try:
        summary, _ = train(argparse.Namespace(**{**vars(args), "device": str(device)}),
                           make_mesh((1, args.devices)))
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(summary, f)


def run(args: argparse.Namespace) -> Dict:
    """The training of ``args`` on one card, on ``--devices`` ranks of this
    host, or as this process's rank of a ``--multihost`` launch; returns
    rank 0's summary (another rank of a multi-host launch: its own)."""
    if args.devices > 1:
        if torch.device(args.device).type == "cuda" and \
                torch.cuda.device_count() < args.devices:
            raise SystemExit(f"--devices {args.devices} needs {args.devices} cards: "
                             f"{torch.cuda.device_count()} visible")
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "summary.json")
            mp.spawn(_rank_main, args=(args, free_port(), out), nprocs=args.devices)
            with open(out) as f:
                return json.load(f)
    if args.multihost:
        initialize_distributed(args.device)
        try:
            device = rank_device(args.device)
            return train(argparse.Namespace(**{**vars(args), "device": str(device)}),
                         make_multihost_mesh())[0]
        finally:
            torch.distributed.destroy_process_group()
    return train(args)[0]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    summary = run(args)
    if args.multihost and int(os.environ.get("RANK", "0")) != 0:
        return summary
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
