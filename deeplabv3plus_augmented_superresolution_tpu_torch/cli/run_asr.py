"""Fused end-to-end ASR serving over a directory / file list.

Port of the JAX repository's ``cli/run_asr.py`` on one card: one fixed
test-time-augmentation (TTA) set per run, the Gram stencil loaded from the
cache or extracted once (when the solver can use it), then ``asr_step`` (one
class) or ``asr_step_multiclass`` (a class list or 'all', optionally with
the full-scene label map) per image or per batch of ``--batch`` images, and
a writer pool for PNGs and IoUs. ``--per_image_augs`` draws a fresh set per
image instead (each solve then extracts its own stencil); ``--fast`` is the
minibatched direct solver's preset. Images are decoded by the native ring
(``data/native_loader.py``) where it builds, else by a Python lookahead, and
staged to the card by a thread: pinned host memory, a side stream. Xception
or MobileNetV2. The same flag names and defaults; flags that select paths
not ported yet raise a clear error.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr \\
      --images test_images/smoke_input.jpg --gt_dir <dir of <name>.png>

``serve`` carries the per-run flow for decoded images; ``main`` decodes
files and calls it.
"""

import argparse
import contextlib
import glob
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models import DeepLabConfig, build_model, default_weights_path
from ..models.deeplab import DeepLab
from ..pipeline import asr_step, asr_step_multiclass, sample_augmentations
from ..pipeline.augment import image_generator
from ..pipeline.end_to_end import SR_TYPES
from ..sr import OptimizerConfig, SRConfig, load_stencil, precompute_gram_stencil, save_stencil
from ..utils.profiling import StageTimer

SEED = 1234
IMG_SIZE = (512, 512)
# The network's output size at 512 px: Xception OS16 + decoder is 1/4,
# MobileNetV2 (OS8, no decoder) 1/8.
FEATURE_SIZES = {"xception": (128, 128), "mobilenet": (64, 64)}
FEATURE_SIZE = FEATURE_SIZES["xception"]
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".dsr_cache")

NOT_PORTED = "is not ported yet (ROADMAP Queue 1: {!r})"
BATCH_NEEDS_SHARED_TTA = ("--batch requires the fixed-TTA-set mode "
                          "(drop --per_image_augs)")
# Batches staged ahead of the card by the staging thread.
STAGING_DEPTH = 2


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=str, required=True,
                        help="image file, directory, or glob of .jpg inputs")
    parser.add_argument("--gt_dir", type=str, default=None,
                        help="optional dir of <name>.png GT label masks for IoU")
    parser.add_argument("--output_dir", type=str,
                        default=os.path.join(os.getcwd(), "asr_output"))
    parser.add_argument("--class_id", type=str, default="8",
                        help="PASCAL class id, a comma list like '8,12,15', or "
                             "'all' (classes 1-20); several classes share one "
                             "forward and one Gram stencil")
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--angle_max", type=float, default=0.15)
    parser.add_argument("--shift_max", type=float, default=80)
    parser.add_argument("--th_factor", type=float, default=0.2)
    parser.add_argument("--sr_types", type=str, default="aug",
                        help="comma list of aug,max,mean")
    parser.add_argument("--label_map", action="store_true",
                        help="multi-class only: also emit <name>_labelmap.png "
                             "(best class above threshold per pixel, from the "
                             "per-class aug targets) and "
                             "<name>_labelmap_standard.png, with mean-IoU "
                             "scores when --gt_dir is given")
    parser.add_argument("--fast", action="store_true",
                        help="tuned fast preset: 60 iters, lr 1e-2, 25-copy minibatch")
    parser.add_argument("--per_image_augs", action="store_true",
                        help="draw a fresh random augmentation set per image "
                             "(reference behavior; each solve extracts its "
                             "own stencil). Default: one fixed TTA set for "
                             "the run")
    parser.add_argument("--prefetch", type=int, default=4,
                        help="host-side image decode lookahead (0 disables)")
    parser.add_argument("--batch", type=int, default=0,
                        help="images per step on the card (0 or 1 = one "
                             "image per step): the batch rides the kernels' "
                             "channel axis and shares one solve")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--chunk_size", type=int, default=0,
                        help="run the model forward in copy chunks to cut the "
                             "activation peak (0 = single forward)")
    parser.add_argument("--class_chunk", type=int, default=0,
                        help="multi-class only: run the per-class solves and "
                             "max/mean warps in class groups of this size to "
                             "cut the memory peak (0 = all classes at once); "
                             "results are identical")
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
    checks = [
        (args.warp_impl != "shear", "--warp_impl gather", "ops/warp.py"),
        (args.operator_impl != "fused", "--operator_impl staged", "ops/warp.py"),
        (args.profile_dir is not None, "--profile_dir", "the remaining CLIs"),
    ]
    return [f"{flag} {NOT_PORTED.format(item)}" for bad, flag, item in checks if bad]


def apply_fast_preset(args: argparse.Namespace) -> None:
    """--fast: at most 60 steps, lr at least 1e-2 decaying 10x over a fifth
    of the steps, 25-copy minibatches (the JAX CLI's preset)."""
    args.num_iter = min(args.num_iter, 60)
    args.learning_rate = max(args.learning_rate, 1e-2)
    args.decay_steps = max(args.num_iter // 5, 1)
    args.decay_rate = 0.1
    args.sgd_copies = args.sgd_copies or 25


def parse_class_ids(spec: str) -> Tuple[int, ...]:
    """'8' -> (8,); '8,12' -> (8, 12); 'all' -> the 20 foreground classes."""
    if spec.strip().lower() == "all":
        return tuple(range(1, 21))
    try:
        ids = tuple(int(t) for t in spec.split(",") if t.strip())
    except ValueError:
        ids = ()
    if not ids or any(not 0 <= c <= 20 for c in ids):
        raise SystemExit(f"--class_id must name classes in 0..20, got {spec!r}")
    return ids


def parse_sr_types(spec: str) -> Tuple[str, ...]:
    return tuple(t.strip() for t in spec.split(",") if t.strip())


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse and validate: flags outside the ported slice exit with an error,
    and so do --label_map without several classes and 'aug' and --batch with
    --per_image_augs; --fast applies its preset."""
    parser = build_parser()
    args = parser.parse_args(argv)
    problems = _unported_flags(args)
    if problems:
        parser.error("; ".join(problems))
    if args.fast:
        apply_fast_preset(args)
    sr_types = parse_sr_types(args.sr_types)
    if not sr_types or any(t not in SR_TYPES for t in sr_types):
        parser.error(f"--sr_types must be a comma list of {','.join(SR_TYPES)}, "
                     f"got {args.sr_types!r}")
    class_ids = parse_class_ids(args.class_id)
    if args.label_map and (len(class_ids) < 2 or "aug" not in sr_types):
        raise SystemExit("--label_map needs a multi-class --class_id and "
                         "'aug' in --sr_types")
    if args.batch > 1 and args.per_image_augs:
        raise SystemExit(BATCH_NEEDS_SHARED_TTA)
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
    """The serving model (Xception OS16 or MobileNetV2 OS8, bf16, no final
    upsample), with the bonlime checkpoint when a local .h5 exists, else
    random init (seed 0)."""
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


def uses_shared_stencil(sr_cfg: SRConfig, sr_types: Sequence[str]) -> bool:
    """Whether a fixed-TTA run extracts the stencil once for every solve: the
    solver reads one ("gram" or "cg", no minibatching) and no copy dropout
    makes it change per solve (the JAX CLI's condition)."""
    return (sr_cfg.solver_impl in ("gram", "cg") and "aug" in sr_types
            and sr_cfg.copy_dropout == 0.0
            and not 0 < sr_cfg.sgd_copies < sr_cfg.num_aug)


def _host_image(image, dtype: torch.dtype) -> torch.Tensor:
    """A decoded (H, W, 3) image (numpy float, or a tensor from the native
    ring) as a CPU tensor of the model's compute dtype."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.asarray(image, np.float32))
    return image.to(dtype)


def _host_batches(images: Iterable[Tuple[str, np.ndarray]], batch: int,
                  dtype: torch.dtype, timer: StageTimer
                  ) -> Iterator[Tuple[List[str], torch.Tensor]]:
    """(names, (batch, H, W, 3) stack) in order; a ragged tail is padded by
    repeating its last image, and names lists only the real ones."""
    names: List[str] = []
    stack: List[torch.Tensor] = []
    it = iter(images)
    while True:
        with timer.stage("host_decode"):
            item = next(it, None)
        if item is None:
            break
        names.append(item[0])
        stack.append(_host_image(item[1], dtype))
        if len(names) == batch:
            yield names, torch.stack(stack)
            names, stack = [], []
    if names:
        stack += [stack[-1]] * (batch - len(stack))
        yield names, torch.stack(stack)


@contextlib.contextmanager
def _staged(batches: Iterator[Tuple[List[str], torch.Tensor]], device: torch.device,
            timer: StageTimer):
    """The batches on the device, staged STAGING_DEPTH ahead by a thread. On
    a card the thread copies each batch from pinned host memory on a side
    stream; the consumer's stream waits on the copy's event, and the tensor
    is recorded on that stream, so the allocator does not hand its memory
    out while the step still reads it. Yields an iterator of
    (names, device batch); the thread stops when the context exits."""
    items: "queue.Queue" = queue.Queue(maxsize=STAGING_DEPTH)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                items.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for names, host in batches:
                with timer.stage("host_to_device"):
                    if copy_stream is None:
                        staged = (names, host.to(device), None)
                    else:
                        host = host.pin_memory()
                        with torch.cuda.stream(copy_stream):
                            dev = host.to(device, non_blocking=True)
                            done = torch.cuda.Event()
                            done.record(copy_stream)
                        staged = (names, dev, done)
                if not put(staged):
                    return
            put(None)
        except BaseException as exc:  # hand the failure to the consumer
            put(exc)

    def consume():
        while (item := items.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            names, dev, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                dev.record_stream(stream)
            yield names, dev

    thread = threading.Thread(target=produce, name="asr-staging", daemon=True)
    thread.start()
    try:
        yield consume()
    finally:
        stop.set()
        thread.join(timeout=60)


def serve(images: Iterable[Tuple[str, np.ndarray]], model: DeepLab, sr_cfg: SRConfig,
          *, device, class_id: Union[int, Sequence[int]] = 8, mode: str = "argmax",
          th_factor: float = 0.2, angle_max: float = 0.15, shift_max: float = 80.0,
          sr_types: Sequence[str] = ("aug",), label_map: bool = False,
          class_chunk: int = 0, batch: int = 0, per_image_augs: bool = False,
          output_dir: Optional[str] = None,
          gt_dir: Optional[str] = None, cache_dir: str = "",
          gram_coeffs: Optional[torch.Tensor] = None, chunk_size: int = 0,
          writer_threads: int = 4, summary_json: str = "", timer=None,
          loader: str = "arrays") -> Dict:
    """Serve (name, (H, W, 3) image in [0, 1]) pairs through ASR. An image is
    a float numpy array or a CPU tensor (the native ring's bf16 frames).

    Per run: one TTA set drawn from SEED and, when the solver reads it
    (``uses_shared_stencil``), the Gram stencil (given, from the cache, or
    extracted once); with per_image_augs instead a set per image from SEED
    and its name (``pipeline.augment.image_generator``), each solve
    extracting its own stencil. Then per step ``asr_step`` for one class or
    ``asr_step_multiclass`` for several (class_id a sequence of more than one
    id; label_map adds the full-scene label map), on one image or, with
    batch > 1, on a batch of that many (a ragged last batch padded with its
    last image, whose results are dropped). A staging thread moves the
    batches to the device ahead of the step. The writer pool fetches each
    step's masks as one packed uint8 tensor and, when output_dir is given,
    writes ``{name}_{type}.png`` per SR type and "standard" (one class) or
    ``{name}_{type}_c{id}.png`` per class, plus ``{name}_labelmap.png`` and
    ``{name}_labelmap_standard.png``; it scores IoU against
    ``gt_dir/{name}.png`` when present (series "<type>" or "<type>/c<id>",
    and the label maps' mean IoU).

    Returns the run summary, also written to summary_json when given: the
    steady seconds per image count from the first step's completion
    (``first_image_s``) to the last; "loop_stages" times the loop's host
    stages (host_decode, host_to_device, dispatch, device_fetch,
    encode_write_score; they overlap), "stages" the timer's; "loader" names
    what decoded the images.
    """
    device = torch.device(device)
    class_ids = (int(class_id),) if isinstance(class_id, int) else tuple(class_id)
    multi = len(class_ids) > 1
    sr_types = tuple(sr_types)
    step_images = max(batch, 1)
    if label_map and (not multi or "aug" not in sr_types):
        raise ValueError("label_map needs several classes and 'aug' in sr_types")
    if per_image_augs and step_images > 1:
        raise ValueError(BATCH_NEEDS_SHARED_TTA)
    shared_stencil = not per_image_augs and uses_shared_stencil(sr_cfg, sr_types)
    if gram_coeffs is not None and not shared_stencil:
        raise ValueError("gram_coeffs needs a fixed TTA set and a solver that "
                         "reads one stencil for every solve")
    angles = shifts = None
    if not per_image_augs:
        angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED),
                                              sr_cfg.num_aug, angle_max, shift_max,
                                              device=device)
        if gram_coeffs is None and shared_stencil:
            gram_coeffs = _stencil_for_run(angles, shifts, sr_cfg, cache_dir)

    out_keys = tuple(sorted(set(sr_types) | {"standard"}))
    lm_keys = ("label_map", "label_map_standard") if label_map else ()
    # One name per output plane, in the order of the packed result.
    if multi:
        names = [f"{k}_c{cid}" for k in out_keys for cid in class_ids] + \
            [k.replace("label_map", "labelmap") for k in lm_keys]
        series = [f"{k}/c{cid}" for k in out_keys for cid in class_ids]
    else:
        names = list(out_keys)
        series = list(out_keys)
    ious: Dict[str, List[float]] = {}
    fractions: Dict[str, Dict[str, float]] = {}
    done: List[Tuple[float, int]] = []   # (completion time, images) per step
    lock = threading.Lock()
    loop_timer = StageTimer()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    def emit(image_names: List[str], packed: torch.Tensor) -> None:
        with loop_timer.stage("device_fetch"):
            masks = packed.cpu().numpy()  # waits for this step's device work
        with loop_timer.stage("encode_write_score"):
            for i, name in enumerate(image_names):
                emit_one(name, masks[:, i])
        with lock:
            done.append((time.perf_counter(), len(image_names)))

    def emit_one(name: str, masks: np.ndarray) -> None:
        if output_dir:
            from ..data.io import save_img
            for j, key in enumerate(names):
                save_img(os.path.join(output_dir, f"{name}_{key}.png"), masks[j],
                         scale=False, compress_level=1)
        scores = {}
        gt_path = os.path.join(gt_dir, f"{name}.png") if gt_dir else None
        if gt_path and os.path.exists(gt_path):
            from ..data.io import load_image
            from ..metrics import compute_iou, mean_iou
            gt = load_image(gt_path, image_size=masks.shape[1:3], normalize=False,
                            is_png=True, resize_method="nearest")
            scores = {key: compute_iou(gt, masks[j], class_id=class_ids[j % len(class_ids)])
                      for j, key in enumerate(series)}
            for j, key in enumerate(lm_keys, start=len(series)):
                scores[f"{key} (mIoU)"] = mean_iou(gt, masks[j])
        with lock:
            fractions[name] = {key: float((masks[j] > 0).mean())
                               for j, key in enumerate(series + list(lm_keys))}
            for key, v in scores.items():
                ious.setdefault(key, []).append(v)

    def step(image_names: List[str], batch_images: torch.Tensor) -> torch.Tensor:
        """One step on the device: the (P, B, H, W, 1) uint8 masks."""
        a, sh = angles, shifts
        if per_image_augs:
            a, sh = sample_augmentations(image_generator(SEED, image_names[0]),
                                         sr_cfg.num_aug, angle_max, shift_max,
                                         device=device)
        kw = dict(mode=mode, th_factor=th_factor, sr_types=sr_types,
                  chunk_size=chunk_size, gram_coeffs=gram_coeffs, timer=timer)
        if multi:
            out = asr_step_multiclass(model, batch_images, a, sh, sr_cfg, class_ids,
                                      class_chunk=class_chunk,
                                      return_label_map=label_map, **kw)
            planes = [out[k].transpose(0, 1) for k in out_keys] + \
                [out[k][None] for k in lm_keys]
            return torch.cat(planes).to(torch.uint8)
        out = asr_step(model, batch_images, a, sh, sr_cfg, class_ids[0], **kw)
        return torch.stack([out[k] for k in out_keys]).to(torch.uint8)

    writer = ArtifactWriter(writer_threads) if writer_threads else None
    start = time.perf_counter()
    n_images = n_steps = 0
    host = _host_batches(images, step_images, model.cfg.dtype, loop_timer)
    try:
        with _staged(host, device, loop_timer) as staged:
            for image_names, batch_images in staged:
                with loop_timer.stage("dispatch"):
                    packed = step(image_names, batch_images)[:, :len(image_names)]
                if writer:
                    writer.submit(emit, image_names, packed)
                else:
                    emit(image_names, packed)
                n_images += len(image_names)
                n_steps += 1
    finally:
        if writer:
            writer.close()
    wall = time.perf_counter() - start
    done.sort()
    first_s = done[0][0] - start if done else None
    later = sum(n for _, n in done[1:])
    summary = {
        "n_images": n_images,
        "batch": batch,
        "steps": n_steps,
        "loader": loader,
        "per_image_augs": per_image_augs,
        "wall_s": wall,
        "first_image_s": first_s,
        "steady_s_per_image": ((done[-1][0] - done[0][0]) / later if later else None),
        "done_ts": [t - start for t, _ in done],
        "mask_fractions": fractions,
        "ious": {k: float(np.mean(v)) for k, v in ious.items() if v},
        "loop_stages": loop_timer.as_dict(),
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


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _decoded(paths: List[str], prefetch: int) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, image) pairs, decoded by PIL up to ``prefetch`` images ahead on
    a thread (0: inline)."""
    from ..data.io import load_image

    def load(path):
        return _name(path), load_image(path, image_size=IMG_SIZE, normalize=True)

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


def _ring_frames(paths: List[str], prefetch: int,
                 dtype: torch.dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, frame) pairs from the native ring, frames in the model's dtype."""
    from ..data import native_loader

    ring_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    with native_loader.ImageRing(paths, IMG_SIZE, normalize=True,
                                 n_threads=min(4, prefetch),
                                 capacity=max(2, prefetch), dtype=ring_dtype) as ring:
        for i, frame in ring:
            yield _name(paths[i]), frame


def image_source(paths: List[str], prefetch: int, dtype: torch.dtype
                 ) -> Tuple[str, Iterator[Tuple[str, np.ndarray]]]:
    """(loader name, decoded images): the native ring where it builds and
    every input is a .jpg, else PIL on a lookahead thread (inline with
    prefetch 0), as the JAX CLI chooses."""
    if prefetch > 0:
        from ..data import native_loader

        if all(p.endswith(".jpg") for p in paths) and native_loader.available():
            return "native ring", _ring_frames(paths, prefetch, dtype)
        return "python lookahead", _decoded(paths, prefetch)
    return "python inline", _decoded(paths, 0)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    paths = _resolve_paths(args.images, args.limit)
    if not paths:
        raise SystemExit(f"No images matched {args.images}")
    device = torch.device(args.device)
    model = build_deeplab(args.backbone, args.weights_path, device=device)
    sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                            feature_size=FEATURE_SIZES[args.backbone],
                            output_size=IMG_SIZE, angle_max=args.angle_max)
    loader, images = image_source(paths, args.prefetch, model.cfg.dtype)
    print(f"images decoded by the {loader}")
    summary = serve(images, model, sr_cfg, device=device,
                    class_id=parse_class_ids(args.class_id), mode=args.mode,
                    th_factor=args.th_factor, angle_max=args.angle_max,
                    shift_max=args.shift_max, sr_types=parse_sr_types(args.sr_types),
                    label_map=args.label_map, class_chunk=args.class_chunk,
                    batch=args.batch, per_image_augs=args.per_image_augs,
                    output_dir=args.output_dir,
                    gt_dir=args.gt_dir, cache_dir=args.cache_dir,
                    chunk_size=args.chunk_size, writer_threads=args.writer_threads,
                    summary_json=args.summary_json, loader=loader)
    msg = f"{summary['n_images']} images in {summary['wall_s']:.1f}s"
    if summary["steady_s_per_image"]:
        msg += f" ({summary['steady_s_per_image']:.3f} s/image steady"
        msg += f", batch={args.batch})" if args.batch > 1 else ")"
    print(msg + f"; masks under {args.output_dir}")
    for k, v in summary["ious"].items():
        print(f"  avg IoU[{k}]: {v:.4f}")
    return summary


if __name__ == "__main__":
    main()
