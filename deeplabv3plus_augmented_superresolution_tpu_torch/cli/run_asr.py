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
or MobileNetV2. The same flag names and defaults, every flag ported.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr \\
      --images test_images/smoke_input.jpg --gt_dir <dir of <name>.png>

``serve`` carries the per-run flow for decoded images; ``main`` decodes
files and calls it. Under torchrun (``WORLD_SIZE`` > 1) with ``--batch``
> 1, the ranks form a (data, aug) mesh factored as the JAX CLI's: each
step serves a global batch, each data group its slice of it, each rank of
a group its block of the copies (``parallel/``); aug index 0 of each group
writes and scores, and rank 0's summary covers every rank.

  torchrun --nproc_per_node 4 -m \
      deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr \
      --images <dir> --batch 4
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
import torch.distributed

from ..models.deeplab import DeepLab
from ..ops.gram import RADIUS_X, RADIUS_Y
from ..parallel.mesh import Mesh, initialize_distributed, make_mesh, rank_device
from ..parallel.sharded import copy_block, make_asr_batch_fn, padded_sr_cfg
from ..pipeline import asr_step, asr_step_multiclass, sample_augmentations
from ..pipeline.augment import image_generator
from ..pipeline.end_to_end import SR_TYPES
from ..sr import SRConfig, load_stencil, precompute_gram_stencil, save_stencil
from ..sr.solver import pad_copies
from ..utils.profiling import StageTimer, trace_to
from ._common import (IMG_SIZE, SEED, add_device_arg, add_sr_args,
                      build_deeplab, feature_size_of, make_sr_config, reads_one_stencil)

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".dsr_cache")

BATCH_NEEDS_SHARED_TTA = ("--batch requires the fixed-TTA-set mode "
                          "(drop --per_image_augs)")
RANKS_NEED_BATCH = ("several ranks (WORLD_SIZE > 1) serve --batch > 1 images a "
                    "step over a (data, aug) mesh; with --batch <= 1 every rank "
                    "would serve every image")
# The loop stages that rank 0's summary sums over the writing ranks.
LOOP_STAGES = ("host_decode", "host_to_device", "dispatch", "device_fetch",
               "encode_write_score")
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
                        help="write a torch.profiler trace of the steady-state "
                             "loop (every step after the first) here, as a "
                             "Chrome trace (open with Perfetto)")
    parser.add_argument("--summary_json", type=str, default="",
                        help="write a machine-readable run summary here")
    parser.add_argument("--cache_dir", type=str, default=DEFAULT_CACHE_DIR,
                        help="warm-start cache for the serving gram stencil, "
                             "keyed by (TTA set, operator config); '' disables")
    add_device_arg(parser)
    add_sr_args(parser)
    return parser


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
    """Parse and validate: --label_map without several classes and 'aug' and
    --batch with --per_image_augs exit with the JAX CLI's messages; --fast
    applies its preset."""
    parser = build_parser()
    args = parser.parse_args(argv)
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
    """Whether a fixed-TTA run extracts the stencil once for every solve: it
    solves "aug" and the solver reads one stencil (the JAX CLI's condition)."""
    return "aug" in sr_types and reads_one_stencil(sr_cfg)


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


def mesh_shape(batch: int, world: int) -> Tuple[int, int]:
    """The (data, aug) factors of a run over world ranks serving batch images
    a step, as the JAX CLI factors its devices: the largest data axis that
    divides both the batch and the rank count, the rest on aug."""
    data = min(batch, world)
    while world % data or batch % data:
        data -= 1
    return data, world // data


def rank_share(items: Sequence, batch: int, mesh: Mesh) -> List[Tuple[bool, object]]:
    """This rank's share of items served in global batches of ``batch``: data
    group g takes items [g b, (g + 1) b) of each batch (b = batch / d). A
    ragged last batch is first padded by repeating its last item, so every
    rank takes part in every step; (False, item) marks such a repeat."""
    b = batch // mesh.shape["data"]
    lo = mesh.data_index * b
    out: List[Tuple[bool, object]] = []
    for start in range(0, len(items), batch):
        chunk = list(items[start:start + batch])
        real = [True] * len(chunk) + [False] * (batch - len(chunk))
        chunk += chunk[-1:] * (batch - len(chunk))
        out += list(zip(real[lo:lo + b], chunk[lo:lo + b]))
    return out


def _merge_summary(mesh: Mesh, summary: Dict, done: List[Tuple[float, int]],
                   ious: Dict[str, List[float]], iou_keys: List[str], device) -> None:
    """Every rank's summary becomes the run's (one all-reduce of sums, one of
    maxima): images, the first step, the steady s/image (the longest span
    of the writing ranks over the images they served after their first
    step: the groups run side by side), the loop stages (summed over the
    writers) and the IoUs (their mean over every scored image)."""
    later = sum(n for _, n in done[1:])
    span = done[-1][0] - done[0][0] if len(done) > 1 else 0.0
    stages = summary["loop_stages"]
    sums = [summary["n_images"], later]
    for name in LOOP_STAGES:
        sums += [stages.get(name, {}).get("total_s", 0.0), stages.get(name, {}).get("calls", 0)]
    for key in iou_keys:
        values = [v for v in ious.get(key, []) if not np.isnan(v)]
        sums += [float(np.sum(values)), len(values)]
    sums = mesh.all_reduce(torch.tensor(sums, dtype=torch.float64, device=device)).tolist()
    maxes = mesh.all_reduce(torch.tensor([span, summary["first_image_s"] or 0.0],
                                         dtype=torch.float64, device=device), "max").tolist()
    summary["n_images"], later = int(sums[0]), sums[1]
    summary["first_image_s"] = maxes[1]
    summary["steady_s_per_image"] = maxes[0] / later if later else None
    merged = {}
    for i, name in enumerate(LOOP_STAGES):
        total, calls = sums[2 + 2 * i], int(sums[3 + 2 * i])
        if calls:
            merged[name] = {"total_s": total, "calls": calls,
                            "ms_per_call": total / calls * 1000}
    summary["loop_stages"] = merged
    base = 2 + 2 * len(LOOP_STAGES)
    summary["ious"] = {key: sums[base + 2 * i] / sums[base + 2 * i + 1]
                       for i, key in enumerate(iou_keys) if sums[base + 2 * i + 1]}


def serve(images: Iterable[Tuple[str, np.ndarray]], model: DeepLab, sr_cfg: SRConfig,
          *, device, class_id: Union[int, Sequence[int]] = 8, mode: str = "argmax",
          th_factor: float = 0.2, angle_max: float = 0.15, shift_max: float = 80.0,
          sr_types: Sequence[str] = ("aug",), label_map: bool = False,
          class_chunk: int = 0, batch: int = 0, per_image_augs: bool = False,
          output_dir: Optional[str] = None,
          gt_dir: Optional[str] = None, cache_dir: str = "",
          gram_coeffs: Optional[torch.Tensor] = None, chunk_size: int = 0,
          writer_threads: int = 4, summary_json: str = "", timer=None,
          loader: str = "arrays", profile_dir: Optional[str] = None,
          mesh: Optional[Mesh] = None) -> Dict:
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
    what decoded the images. profile_dir: a torch.profiler trace of the
    steps after the first (``utils.profiling.trace_to``), written when the
    writer pool has drained.

    mesh (``parallel.make_mesh``, every rank calling serve together): batch
    is the global batch, and images this rank's share of the run's images
    (``rank_share``: its data group's batch / d images a step, a padding
    repeat named None). The copy axis is padded to the aug axis, the
    stencil extracted with the padded config on rank 0 (given, it must be
    that one) and broadcast, and each step runs ``make_asr_batch_fn``'s
    step on this rank's images and block of copies; aug index 0 of each
    data group writes and scores. The summary's images, first step, steady
    s/image, loop stages and IoUs are then the whole run's (every rank's
    summary is), its mask fractions this rank's.
    """
    device = torch.device(device)
    class_ids = (int(class_id),) if isinstance(class_id, int) else tuple(class_id)
    multi = len(class_ids) > 1
    sr_types = tuple(sr_types)
    step_images = max(batch, 1)
    if label_map and (not multi or "aug" not in sr_types):
        raise ValueError("label_map needs several classes and 'aug' in sr_types")
    if per_image_augs and (step_images > 1 or mesh is not None):
        raise ValueError(BATCH_NEEDS_SHARED_TTA)
    shared_stencil = not per_image_augs and uses_shared_stencil(sr_cfg, sr_types)
    if gram_coeffs is not None and not shared_stencil:
        raise ValueError("gram_coeffs needs a fixed TTA set and a solver that "
                         "reads one stencil for every solve")
    writes = mesh is None or mesh.aug_index == 0
    angles = shifts = None
    if not per_image_augs:
        angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED),
                                              sr_cfg.num_aug, angle_max, shift_max,
                                              device=device)
    if mesh is not None:
        if step_images % mesh.shape["data"]:
            raise ValueError(f"batch {batch} does not split over the "
                             f"{mesh.shape['data']}-rank data axis")
        step_images //= mesh.shape["data"]
        padded = padded_sr_cfg(sr_cfg, mesh)
        if gram_coeffs is None and shared_stencil:
            gram_coeffs = (_stencil_for_run(*pad_copies(angles, shifts, padded.num_aug),
                                            padded, cache_dir)
                           if mesh.rank == 0 else
                           torch.empty((2 * RADIUS_Y + 1, 2 * RADIUS_X + 1)
                                       + tuple(sr_cfg.output_size), device=device))
        batch_fn = make_asr_batch_fn(
            mesh, model, sr_cfg, class_ids if multi else class_ids[0], mode=mode,
            th_factor=th_factor, sr_types=sr_types, chunk_size=chunk_size,
            class_chunk=class_chunk, gram_coeffs=gram_coeffs,
            return_label_map=label_map, timer=timer)
        own_angles, own_shifts = copy_block(mesh, angles, shifts)
    elif not per_image_augs and gram_coeffs is None and shared_stencil:
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
        if mesh is not None:
            out = batch_fn(batch_images, own_angles, own_shifts)
        elif multi:
            out = asr_step_multiclass(model, batch_images, a, sh, sr_cfg, class_ids,
                                      class_chunk=class_chunk,
                                      return_label_map=label_map, **kw)
        else:
            out = asr_step(model, batch_images, a, sh, sr_cfg, class_ids[0], **kw)
        if multi:
            planes = [out[k].transpose(0, 1) for k in out_keys] + \
                [out[k][None] for k in lm_keys]
            return torch.cat(planes).to(torch.uint8)
        return torch.stack([out[k] for k in out_keys]).to(torch.uint8)

    writer = ArtifactWriter(writer_threads) if writer_threads else None
    trace = contextlib.ExitStack()
    start = time.perf_counter()
    n_images = n_steps = 0
    host = _host_batches(images, step_images, model.cfg.dtype, loop_timer)
    try:
        with _staged(host, device, loop_timer) as staged:
            for image_names, batch_images in staged:
                image_names = [n for n in image_names if n is not None]
                with loop_timer.stage("dispatch"):
                    packed = step(image_names, batch_images)[:, :len(image_names)]
                if writes and writer:
                    writer.submit(emit, image_names, packed)
                elif writes:
                    emit(image_names, packed)
                n_images += len(image_names)
                n_steps += 1
                if profile_dir and n_steps == 1:
                    # The steady state only: the first step pays first-use work.
                    trace.enter_context(trace_to(profile_dir))
    finally:
        if writer:
            writer.close()
        trace.close()
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
    if mesh is not None:
        if not writes:
            summary["n_images"] = 0
        _merge_summary(mesh, summary, done, ious,
                       series + [f"{k} (mIoU)" for k in lm_keys], device)
        summary["mesh"] = dict(mesh.shape)
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.batch <= 1:
        raise SystemExit(RANKS_NEED_BATCH)
    paths = _resolve_paths(args.images, args.limit)
    if not paths:
        raise SystemExit(f"No images matched {args.images}")
    device, mesh, joined = torch.device(args.device), None, False
    if world > 1:
        joined = not torch.distributed.is_initialized()
        initialize_distributed(args.device)
        device = rank_device(args.device)
        mesh = make_mesh(mesh_shape(args.batch, world))
    lead = mesh is None or mesh.rank == 0
    model = build_deeplab(args.backbone, args.weights_path, device=device)
    sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                            feature_size=feature_size_of(model.cfg),
                            output_size=IMG_SIZE, angle_max=args.angle_max)
    share = rank_share(paths, args.batch, mesh) if mesh is not None else None
    loader, images = image_source([p for _, p in share] if share else paths,
                                  args.prefetch, model.cfg.dtype)
    if share:
        images = ((name if real else None, image)
                  for (real, _), (name, image) in zip(share, images))
    if lead:
        print(f"images decoded by the {loader}"
              + (f"; mesh {mesh.shape} over {world} ranks" if mesh else ""))
    try:
        summary = serve(images, model, sr_cfg, device=device,
                        class_id=parse_class_ids(args.class_id), mode=args.mode,
                        th_factor=args.th_factor, angle_max=args.angle_max,
                        shift_max=args.shift_max, sr_types=parse_sr_types(args.sr_types),
                        label_map=args.label_map, class_chunk=args.class_chunk,
                        batch=args.batch, per_image_augs=args.per_image_augs,
                        output_dir=args.output_dir,
                        gt_dir=args.gt_dir, cache_dir=args.cache_dir,
                        chunk_size=args.chunk_size, writer_threads=args.writer_threads,
                        summary_json=args.summary_json if lead else "", loader=loader,
                        profile_dir=args.profile_dir, mesh=mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    if not lead:
        return summary
    msg = f"{summary['n_images']} images in {summary['wall_s']:.1f}s"
    if summary["steady_s_per_image"]:
        msg += f" ({summary['steady_s_per_image']:.3f} s/image steady"
        msg += f", batch={args.batch})" if args.batch > 1 else ")"
    print(msg + f"; masks under {args.output_dir}")
    if args.profile_dir:
        print(f"profiler trace written to {args.profile_dir}")
    for k, v in summary["ious"].items():
        print(f"  avg IoU[{k}]: {v:.4f}")
    return summary


if __name__ == "__main__":
    main()
