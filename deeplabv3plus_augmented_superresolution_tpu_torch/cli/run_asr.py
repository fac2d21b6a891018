"""Fused end-to-end ASR serving over a directory / file list.

Port of the JAX repository's ``cli/run_asr.py`` for its default path: one
image per call, one fixed test-time-augmentation (TTA) set per run, the Gram
stencil loaded from the cache or extracted once, then ``asr_step`` per image
and a writer pool for PNGs and IoUs. The same flag names and defaults;
flags that select paths not ported yet raise a clear error.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr \\
      --images test_images/smoke_input.jpg --gt_dir <dir of <name>.png>

``serve`` carries the per-run flow for decoded images; ``main`` decodes
files and calls it.
"""

import argparse
import glob
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models import DeepLabConfig, build_model, default_weights_path
from ..models.deeplab import DeepLab, NOT_PORTED_MOBILENET
from ..pipeline import asr_step, sample_augmentations
from ..sr import OptimizerConfig, SRConfig, load_stencil, precompute_gram_stencil, save_stencil

SEED = 1234
IMG_SIZE = (512, 512)
FEATURE_SIZE = (128, 128)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".dsr_cache")

NOT_PORTED = "is not ported yet (ROADMAP Queue 1: {!r})"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=str, required=True,
                        help="image file, directory, or glob of .jpg inputs")
    parser.add_argument("--gt_dir", type=str, default=None,
                        help="optional dir of <name>.png GT label masks for IoU")
    parser.add_argument("--output_dir", type=str,
                        default=os.path.join(os.getcwd(), "asr_output"))
    parser.add_argument("--class_id", type=str, default="8",
                        help="PASCAL class id (one class; lists and 'all' are "
                             "not ported yet)")
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--angle_max", type=float, default=0.15)
    parser.add_argument("--shift_max", type=float, default=80)
    parser.add_argument("--th_factor", type=float, default=0.2)
    parser.add_argument("--sr_types", type=str, default="aug",
                        help="comma list of SR types; the port runs 'aug'")
    parser.add_argument("--label_map", action="store_true",
                        help="multi-class label map (not ported yet)")
    parser.add_argument("--fast", action="store_true",
                        help="minibatched fast preset (not ported yet)")
    parser.add_argument("--per_image_augs", action="store_true",
                        help="a fresh augmentation set per image (not ported yet)")
    parser.add_argument("--prefetch", type=int, default=4,
                        help="host-side image decode lookahead (0 disables)")
    parser.add_argument("--batch", type=int, default=0,
                        help="images per device program (values > 1 not ported yet)")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--chunk_size", type=int, default=0,
                        help="run the model forward in copy chunks to cut the "
                             "activation peak (0 = single forward)")
    parser.add_argument("--class_chunk", type=int, default=0,
                        help="multi-class class groups (not ported yet)")
    parser.add_argument("--writer_threads", type=int, default=4,
                        help="artifact-writer pool size (mask fetch + PNG "
                             "encode + IoU overlapped with device work; "
                             "0 = synchronous writes)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="profiler trace directory (not ported yet)")
    parser.add_argument("--summary_json", type=str, default="",
                        help="write a machine-readable run summary here")
    parser.add_argument("--cache_dir", type=str, default=DEFAULT_CACHE_DIR,
                        help="warm-start cache for the serving gram stencil, "
                             "keyed by (TTA set, operator config); '' disables")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (the CUDA kernel needs "
                             "'cuda'; 'cpu' runs the plain versions)")
    add_sr_args(parser)
    return parser


def add_sr_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--lambda_df", type=float, default=1.0)
    parser.add_argument("--lambda_tv", type=float, default=0.3)
    parser.add_argument("--lambda_L2", type=float, default=0.7)
    parser.add_argument("--lambda_L1", type=float, default=0.0)
    parser.add_argument("--num_iter", type=int, default=300)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "adamax", "adagrad", "adadelta", "sgd"])
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--amsgrad", action="store_true", default=True)
    parser.add_argument("--lr_scheduler", action="store_true", default=True)
    parser.add_argument("--decay_steps", type=int, default=60)
    parser.add_argument("--decay_rate", type=float, default=0.3)
    parser.add_argument("--copy_dropout", type=float, default=0.0)
    parser.add_argument("--use_BTV", action="store_true")
    parser.add_argument("--sgd_copies", type=int, default=0)
    parser.add_argument("--solver_impl", type=str, default="gram",
                        choices=["gram", "cg", "direct"])
    parser.add_argument("--operator_impl", type=str, default="fused",
                        choices=["fused", "staged"])
    parser.add_argument("--warp_impl", type=str, default="shear",
                        choices=["shear", "gather"])
    parser.add_argument("--gram_probing", type=str, default="aliased",
                        choices=["aliased", "dense"])
    return parser


def _unported_flags(args) -> List[str]:
    """One message per flag that selects a path the port does not have."""
    solvers = "the direct and CG solvers, minibatching and dropout"
    checks = [
        (args.batch > 1, "--batch > 1", "the --batch path and the native staging ring"),
        (args.class_id.strip().lower() == "all" or "," in args.class_id,
         "several classes in --class_id", "multi-class and the label map"),
        (args.label_map, "--label_map", "multi-class and the label map"),
        (args.class_chunk != 0, "--class_chunk", "multi-class and the label map"),
        ([t.strip() for t in args.sr_types.split(",") if t.strip()] != ["aug"],
         f"--sr_types {args.sr_types}", "max/mean SR through the inverse warp"),
        (args.backbone != "xception", "--backbone mobilenet",
         "MobileNet and the decoder variants"),
        (args.solver_impl != "gram", f"--solver_impl {args.solver_impl}", solvers),
        (args.fast, "--fast", solvers),
        (args.sgd_copies > 0, "--sgd_copies", solvers),
        (args.copy_dropout > 0, "--copy_dropout", solvers),
        (args.per_image_augs, "--per_image_augs", "the --batch path and the native staging ring"),
        (args.optimizer != "adam", f"--optimizer {args.optimizer}", solvers),
        (args.warp_impl != "shear", "--warp_impl gather", "ops/warp.py"),
        (args.operator_impl != "fused", "--operator_impl staged", "ops/warp.py"),
        (args.profile_dir is not None, "--profile_dir", "the remaining CLIs"),
    ]
    return [f"{flag} {NOT_PORTED.format(item)}" for bad, flag, item in checks if bad]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: flags outside the ported slice exit with an error."""
    parser = build_parser()
    args = parser.parse_args(argv)
    problems = _unported_flags(args)
    if problems:
        parser.error("; ".join(problems))
    if not args.class_id.strip().isdigit() or not 0 <= int(args.class_id) <= 20:
        parser.error(f"--class_id must name a class in 0..20, got {args.class_id!r}")
    return args


def make_sr_config(args=None, num_aug: int = 100, feature_size=FEATURE_SIZE,
                   output_size=IMG_SIZE, **overrides) -> SRConfig:
    """SRConfig from CLI args with the reference's serving defaults."""
    hp = {
        "lambda_df": 1.0, "lambda_tv": 0.3, "lambda_L2": 0.7, "lambda_L1": 0.0,
        "num_iter": 300, "optimizer": "adam", "learning_rate": 1e-3,
        "amsgrad": True, "lr_scheduler": True, "decay_steps": 60,
        "decay_rate": 0.3, "copy_dropout": 0.0, "use_BTV": False,
        "angle_max": 0.5, "sgd_copies": 0, "solver_impl": "gram",
        "operator_impl": "fused", "warp_impl": "shear",
        "gram_probing": "aliased",
    }
    if args is not None:
        for key in hp:
            if hasattr(args, key):
                hp[key] = getattr(args, key)
    hp.update(overrides)
    opt = OptimizerConfig(
        name=hp["optimizer"], learning_rate=hp["learning_rate"],
        amsgrad=hp["amsgrad"], lr_scheduler=hp["lr_scheduler"],
        decay_steps=hp["decay_steps"], decay_rate=hp["decay_rate"])
    return SRConfig(
        lambda_df=hp["lambda_df"], lambda_tv=hp["lambda_tv"],
        lambda_L2=hp["lambda_L2"], lambda_L1=hp["lambda_L1"],
        num_iter=hp["num_iter"], num_aug=num_aug,
        feature_size=tuple(feature_size), output_size=tuple(output_size),
        use_BTV=hp["use_BTV"], copy_dropout=hp["copy_dropout"],
        angle_max=max(float(hp["angle_max"]), 1e-3),
        sgd_copies=hp["sgd_copies"], solver_impl=hp["solver_impl"],
        operator_impl=hp["operator_impl"], warp_impl=hp["warp_impl"],
        gram_probing=hp["gram_probing"], optimizer=opt)


def build_deeplab(backbone: str = "xception", weights_path: Optional[str] = None,
                  *, device) -> DeepLab:
    """The serving model (Xception OS16, bf16, no final upsample), with the
    bonlime checkpoint when a local .h5 exists, else random init (seed 0)."""
    if backbone != "xception":
        raise NotImplementedError(NOT_PORTED_MOBILENET)
    cfg = DeepLabConfig(input_shape=IMG_SIZE + (3,), classes=21, os=16,
                        backbone=backbone, final_upsample=False,
                        compute_dtype="bfloat16")
    path = weights_path or default_weights_path(backbone)
    if not os.path.exists(path):
        print(f"WARNING: pretrained weights not found at {path}; running with "
              "random initialization (masks will be meaningless)")
        path = None
    return build_model(cfg, seed=0, weights_path=path, device=device)


class ArtifactWriter:
    """Bounded writer pool: each result (still on the device) is fetched,
    encoded and scored here while the device runs the next image."""

    def __init__(self, n_threads: int, max_pending: int = 16):
        self.pool = ThreadPoolExecutor(max_workers=max(n_threads, 1))
        self.sem = threading.BoundedSemaphore(max_pending)
        self.futures = []

    def submit(self, fn, *args):
        self.sem.acquire()

        def task():
            try:
                return fn(*args)
            finally:
                self.sem.release()

        self.futures.append(self.pool.submit(task))

    def close(self):
        try:
            for f in self.futures:
                f.result()  # propagate writer errors
        finally:
            self.pool.shutdown()


def _stencil_for_run(angles, shifts, sr_cfg: SRConfig, cache_dir: str) -> torch.Tensor:
    angles_np, shifts_np = angles.cpu().numpy(), shifts.cpu().numpy()
    cached = load_stencil(cache_dir, angles_np, shifts_np, sr_cfg) if cache_dir else None
    if cached is not None:
        print("gram stencil loaded from cache")
        return torch.as_tensor(cached, device=angles.device)
    t0 = time.perf_counter()
    coeffs = precompute_gram_stencil(angles, shifts, sr_cfg)
    if cache_dir:
        save_stencil(cache_dir, angles_np, shifts_np, sr_cfg, coeffs.cpu().numpy())
    print(f"gram stencil precomputed once in {time.perf_counter() - t0:.1f}s "
          "(amortized across all images)")
    return coeffs


def serve(images: Iterable[Tuple[str, np.ndarray]], model: DeepLab, sr_cfg: SRConfig,
          *, device, class_id: int = 8, mode: str = "argmax",
          th_factor: float = 0.2, angle_max: float = 0.15, shift_max: float = 80.0,
          output_dir: Optional[str] = None,
          gt_dir: Optional[str] = None, cache_dir: str = "",
          gram_coeffs: Optional[torch.Tensor] = None, chunk_size: int = 0,
          writer_threads: int = 4, summary_json: str = "", timer=None) -> Dict:
    """Serve (name, (H, W, 3) float image in [0, 1]) pairs through ASR.

    Per run: one TTA set drawn from SEED, the Gram stencil (given, from
    the cache, or extracted once), then ``asr_step`` per image. The writer
    pool fetches each result, writes ``{name}_aug.png`` and
    ``{name}_standard.png`` under output_dir (when given) and scores IoU
    against ``gt_dir/{name}.png`` (when present). Returns the run summary,
    also written to summary_json when given.
    """
    device = torch.device(device)
    generator = torch.Generator().manual_seed(SEED)
    angles, shifts = sample_augmentations(generator, sr_cfg.num_aug, angle_max,
                                          shift_max, device=device)
    if gram_coeffs is None:
        gram_coeffs = _stencil_for_run(angles, shifts, sr_cfg, cache_dir)

    out_keys = ("aug", "standard")
    ious: Dict[str, List[float]] = {k: [] for k in out_keys}
    fractions: Dict[str, Dict[str, float]] = {}
    done_ts: List[float] = []
    lock = threading.Lock()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    def emit(name: str, packed: torch.Tensor) -> None:
        masks = packed.cpu().numpy()  # waits for this image's device work
        if output_dir:
            from ..data.io import save_img
            for j, k in enumerate(out_keys):
                save_img(os.path.join(output_dir, f"{name}_{k}.png"), masks[j],
                         scale=False, compress_level=1)
        scores = {}
        gt_path = os.path.join(gt_dir, f"{name}.png") if gt_dir else None
        if gt_path and os.path.exists(gt_path):
            from ..data.io import load_image
            from ..metrics import compute_iou
            gt = load_image(gt_path, image_size=masks.shape[1:3], normalize=False,
                            is_png=True, resize_method="nearest")
            scores = {k: compute_iou(gt, masks[j], class_id=class_id)
                      for j, k in enumerate(out_keys)}
        with lock:
            fractions[name] = {k: float((masks[j] > 0).mean())
                               for j, k in enumerate(out_keys)}
            for k, v in scores.items():
                ious[k].append(v)
            done_ts.append(time.perf_counter())

    writer = ArtifactWriter(writer_threads) if writer_threads else None
    start = time.perf_counter()
    n_images = 0
    try:
        for name, image in images:
            image_t = torch.as_tensor(np.asarray(image, np.float32)).to(device)
            out = asr_step(model, image_t, angles, shifts, sr_cfg, class_id,
                           mode=mode, th_factor=th_factor, chunk_size=chunk_size,
                           gram_coeffs=gram_coeffs, timer=timer)
            packed = torch.stack([out[k] for k in out_keys]).to(torch.uint8)
            if writer:
                writer.submit(emit, name, packed)
            else:
                emit(name, packed)
            n_images += 1
    finally:
        if writer:
            writer.close()
    wall = time.perf_counter() - start
    done = sorted(t - start for t in done_ts)
    summary = {
        "n_images": n_images,
        "wall_s": wall,
        "first_image_s": done[0] if done else None,
        "steady_s_per_image": ((done[-1] - done[0]) / (len(done) - 1)
                               if len(done) > 1 else None),
        "done_ts": done,
        "mask_fractions": fractions,
        "ious": {k: float(np.mean(v)) for k, v in ious.items() if v},
        "stages": timer.as_dict() if timer is not None else {},
    }
    if summary_json:
        with open(summary_json, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def _resolve_paths(spec: str, limit: Optional[int]) -> List[str]:
    if os.path.isdir(spec):
        paths = sorted(glob.glob(os.path.join(spec, "*.jpg")))
    elif any(ch in spec for ch in "*?["):
        paths = sorted(glob.glob(spec))
    else:
        paths = [spec]
    return paths[:limit] if limit else paths


def _decoded(paths: List[str], prefetch: int) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, image) pairs, decoded up to ``prefetch`` images ahead on a
    thread (0: inline)."""
    from ..data.io import load_image

    def load(path):
        name = os.path.splitext(os.path.basename(path))[0]
        return name, load_image(path, image_size=IMG_SIZE, normalize=True)

    if prefetch <= 0:
        for p in paths:
            yield load(p)
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = [pool.submit(load, p) for p in paths[:prefetch]]
        for p in paths[prefetch:]:
            item = pending.pop(0).result()
            pending.append(pool.submit(load, p))
            yield item
        for fut in pending:
            yield fut.result()


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    paths = _resolve_paths(args.images, args.limit)
    if not paths:
        raise SystemExit(f"No images matched {args.images}")
    device = torch.device(args.device)
    model = build_deeplab(args.backbone, args.weights_path, device=device)
    sr_cfg = make_sr_config(args, num_aug=args.num_aug, feature_size=FEATURE_SIZE,
                            angle_max=args.angle_max)
    summary = serve(_decoded(paths, args.prefetch), model, sr_cfg, device=device,
                    class_id=int(args.class_id), mode=args.mode,
                    th_factor=args.th_factor, angle_max=args.angle_max,
                    shift_max=args.shift_max, output_dir=args.output_dir,
                    gt_dir=args.gt_dir, cache_dir=args.cache_dir,
                    chunk_size=args.chunk_size, writer_threads=args.writer_threads,
                    summary_json=args.summary_json)
    msg = f"{summary['n_images']} images in {summary['wall_s']:.1f}s"
    if summary["steady_s_per_image"]:
        msg += f" ({summary['steady_s_per_image']:.3f} s/image steady)"
    print(msg + f"; masks under {args.output_dir}")
    for k, v in summary["ious"].items():
        print(f"  avg IoU[{k}]: {v:.4f}")
    return summary


if __name__ == "__main__":
    main()
