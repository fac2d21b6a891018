"""Run one cell of the benchmark once and print its result line.

  python3 -m asr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the program's
model with weights drawn from the seed on the card, the run's TTA set and
its Gram stencil extracted by the program (no stencil cache), the scenes,
and one warm ``serve`` call on the cell's own shapes. The served class of a
one-class cell is chosen by the reference network; that is the harness's
work, and its seconds are left out of ``setup_s``. The window: one call
of the program's ``cli/run_asr.serve`` over a stream of distinct scenes,
closed loop, that stops handing images over once ``--seconds`` have passed
(at a batch boundary); it runs from the first image handed over to the
last one's masks written. With ``--trace 1`` the profiler covers a few
steady steps inside it (``profile.StageRanges``). Afterwards the check
(``check.py``) compares a sample of what ``serve`` wrote with the plain
reference.

The last line of standard output is the JSON result; the last lines of
standard error are the numbers compared, each beside its limit. Without a
card (or with fewer than the cell asks for) the run exits 2 and prints no
result; if jax, jaxlib, flax or the JAX package were loaded, it exits 3.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional, Sequence  # noqa: E402

from .spec import load_cell  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "asr_bench_cache")
# Build and kernel caches at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# One intra-op CPU thread: serve's own threads (staging, four writers) and
# the launching thread share the card's host with no pool spinning beside
# them (on the H100 host: steadier, and 2% faster, than the default pool).
os.environ.setdefault("OMP_NUM_THREADS", "1")
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplabv3plus_augmented_superresolution_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: object
    images: int
    window_s: float
    setup_s: float
    peak_bytes: int
    batch: int
    classes: int
    loop_stages: dict
    trace: Optional[dict]
    flops_per_step: float
    warp_bytes_per_step: float
    solve_ops_per_step: float
    solve_bytes_per_step: float


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def build_program_model(cfg: dict, weights, device):
    """The program's DeepLab of the configuration, loaded with the weights
    dict (the program's ``DeepLab.load_params``, as ``models.weights.
    build_model`` loads a dict), in evaluation mode, channels-last."""
    import torch
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import (
        DeepLab, DeepLabConfig)

    dl_cfg = DeepLabConfig(input_shape=tuple(cfg["input_size"]) + (3,),
                           classes=cfg["classes"], os=cfg["output_stride"],
                           backbone=cfg["backbone"], final_upsample=cfg["final_upsample"],
                           compute_dtype=cfg["compute_dtype"])
    model = DeepLab(dl_cfg, device=device).load_params(weights)
    return model.eval().to(memory_format=torch.channels_last)


def program_sr_config(cfg: dict, model):
    """The program's SRConfig for the configuration, through the CLI's own
    ``make_sr_config``; raises where the program would run other settings
    than the configuration states."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import (
        feature_size_of, make_sr_config)

    asr = cfg["asr"]
    opt = asr["optimizer"]
    sr_cfg = make_sr_config(
        None, num_aug=asr["num_aug"], feature_size=feature_size_of(model.cfg),
        output_size=tuple(cfg["input_size"]), angle_max=asr["angle_max"],
        lambda_df=asr["lambda_df"], lambda_tv=asr["lambda_tv"], lambda_L2=asr["lambda_L2"],
        lambda_L1=asr["lambda_L1"], num_iter=asr["num_iter"], optimizer=opt["name"],
        learning_rate=opt["learning_rate"], amsgrad=opt["amsgrad"],
        lr_scheduler=opt["lr_scheduler"], decay_steps=opt["decay_steps"],
        decay_rate=opt["decay_rate"], solver_impl=asr["solver_impl"],
        operator_impl=asr["operator_impl"], warp_impl=asr["warp_impl"],
        gram_probing=asr["gram_probing"])
    o = sr_cfg.optimizer
    stated = {"solve_dtype": asr["solve_dtype"], "beta_1": opt["beta_1"],
              "beta_2": opt["beta_2"], "epsilon": opt["epsilon"]}
    runs = {"solve_dtype": sr_cfg.solve_dtype, "beta_1": o.beta_1, "beta_2": o.beta_2,
            "epsilon": o.epsilon}
    if stated != runs:
        raise SystemExit(f"the program would run {runs}, the configuration states {stated}")
    return sr_cfg


class Stream:
    """The window's images: distinct scenes handed over one by one until the
    deadline has passed at a batch boundary (the first batch always goes).
    Records when the first was handed over."""

    def __init__(self, scenes, batch: int, prefix: str):
        self.scenes, self.batch, self.prefix = scenes, batch, prefix
        self.deadline = float("inf")
        self.first_at: Optional[float] = None
        self.handed = 0

    def __iter__(self):
        for i, scene in enumerate(self.scenes):
            if i and i % self.batch == 0 and time.perf_counter() >= self.deadline:
                return
            if self.first_at is None:
                self.first_at = time.perf_counter()
            self.handed += 1
            yield f"{self.prefix}{i:05d}", scene
        if time.perf_counter() < self.deadline:
            raise RuntimeError(f"the {len(self.scenes)} scenes ran out before the window "
                               "closed: give the workload more scenes")


def pick_class(rule: dict, scenes, weights, cfg: dict, device) -> int:
    """The one class served: with rule "most_frequent_foreground", the class
    of 1..classes-1 that the reference network (float32) predicts on most
    pixels of the first ``rule["scenes"]`` scenes."""
    import torch

    from .check import exact_float32
    from .reference.deeplab import logits

    if rule["rule"] != "most_frequent_foreground":
        raise SystemExit(f"unknown class rule {rule['rule']!r}")
    counts = torch.zeros(cfg["classes"], dtype=torch.long, device=device)
    with exact_float32():
        for scene in scenes[:rule["scenes"]]:
            lg = logits(weights, torch.as_tensor(scene, device=device)[None], cfg)
            counts += torch.bincount(lg.argmax(-1).flatten(), minlength=cfg["classes"])
    return int(counts[1:].argmax()) + 1


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float = _T0, age0: float = _AGE0, control: bool = False,
             scene_count: Optional[int] = None, faults: Sequence[str] = ()) -> dict:
    """One run of the cell on ``device``; returns the result. scene_count:
    fewer scenes than the workload's (a run that serves a step or two).
    With ``control``, the control's decisions, and for each name in
    ``faults`` the window's images served again with that fault planted
    (``faults.FAULTS``), are judged as the program's are, each with its
    numbers and its ``correct`` under the cell's limits in the detail's
    "variants"."""
    import torch

    from . import check, counts
    from .faults import FAULTS
    from .profile import StageRanges
    from .scenes import make_scenes
    from .spec import read_metrics
    from .weights import make_weights

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import SEED
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        serve, uses_shared_stencil)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.augment import (
        sample_augmentations)
    from deeplabv3plus_augmented_superresolution_tpu_torch.sr import precompute_gram_stencil

    marks = {"imports": time.perf_counter() - t0}
    device = torch.device(device)
    cell = load_cell(root, workload)
    cfg, wl = cell.config, cell.workload
    asr = cfg["asr"]
    batch = wl["batch"]
    sc = wl["scenes"]
    size = tuple(cfg["input_size"])

    weights = make_weights(cfg, seed, device)
    model = build_program_model(cfg, weights, device)
    sr_cfg = program_sr_config(cfg, model)
    marks["weights_model"] = time.perf_counter() - t0
    warm_count = batch * wl["warm_steps"]
    scenes = make_scenes(seed, (scene_count or sc["count"]) + warm_count, size, sc["class_ids"],
                         sc["max_shapes"], sc["threads"])
    warm, scenes = scenes[:warm_count], scenes[warm_count:]
    marks["scenes"] = time.perf_counter() - t0
    picking = time.perf_counter()
    class_ids = (list(wl["classes"]) if isinstance(wl["classes"], list)
                 else [pick_class(wl["classes"], scenes, weights, cfg, device)])
    pick_s = time.perf_counter() - picking
    marks["reference_class_s"] = pick_s
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED),
                                          sr_cfg.num_aug, asr["angle_max"],
                                          asr["shift_max"], device=device)
    coeffs = (precompute_gram_stencil(angles, shifts, sr_cfg)
              if uses_shared_stencil(sr_cfg, wl["sr_types"]) else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["class_and_stencil"] = time.perf_counter() - t0
    out_root = tempfile.mkdtemp(prefix="asr_bench_")
    kw = dict(device=device, class_id=class_ids if len(class_ids) > 1 else class_ids[0],
              mode=asr["mode"], th_factor=asr["th_factor"], angle_max=asr["angle_max"],
              shift_max=asr["shift_max"], sr_types=tuple(wl["sr_types"]),
              label_map=wl["label_map"], class_chunk=wl["class_chunk"], batch=batch,
              cache_dir="", gram_coeffs=coeffs, writer_threads=wl["writer_threads"])
    try:
        serve([(f"warm{i:05d}", scene) for i, scene in enumerate(warm)], model, sr_cfg,
              output_dir=os.path.join(out_root, "warm"), timer=StageRanges(), **kw)

        marks["warm_step"] = time.perf_counter() - t0
        profile_steps = tuple(wl["trace"]) if trace else None
        timer = StageRanges(profile_steps)
        stream = Stream(scenes, batch, "img")
        out_dir = os.path.join(out_root, "window")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        window_open = time.perf_counter()
        stream.deadline = window_open + seconds
        summary = serve(stream, model, sr_cfg, output_dir=out_dir, timer=timer, **kw)
        returned = time.perf_counter()
        timer.stop()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        serve_start = returned - summary["wall_s"]
        window_s = serve_start + summary["done_ts"][-1] - stream.first_at
        setup_s = age0 + (stream.first_at - t0) - pick_s
        found = forbidden_modules()
        if found:
            print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
            raise SystemExit(3)

        h, w = size
        planes = batch * len(class_ids)
        forward = counts.forward_flops(cfg, batch * asr["num_aug"])
        record = RunRecord(
            cell=cell, images=summary["n_images"], window_s=window_s, setup_s=setup_s,
            peak_bytes=peak, batch=batch, classes=len(class_ids),
            loop_stages=summary["loop_stages"], trace=timer.trace,
            flops_per_step=counts.step_flops(forward, batch, asr["num_aug"],
                                             len(class_ids), asr["num_iter"], h, w,
                                             wl["sr_types"]),
            warp_bytes_per_step=counts.copies_warp_bytes(batch, asr["num_aug"], h, w),
            solve_ops_per_step=counts.solve_ops(planes, asr["num_iter"], h, w),
            solve_bytes_per_step=counts.solve_bytes(planes, h, w))
        metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, record)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
        if trace and timer.trace is not None and timer.trace["busy_s"] > 0:
            dev["busy_s"] = timer.trace["busy_s"]
            dev["window_s"] = timer.trace["window_s"]
        limit = power_limit() if device.type == "cuda" else None
        if limit:
            dev["power_limit"] = limit

        names = [f"img{i:05d}" for i in range(summary["n_images"])]
        served = list(zip(names, scenes))
        for fault in faults:
            with FAULTS[fault]():
                serve(served, model, sr_cfg, output_dir=os.path.join(out_root, fault),
                      timer=StageRanges(), **kw)

        # The check: the program's state is freed first, so that the
        # reference neither sets the peak nor runs short of memory.
        del model, coeffs, angles, shifts
        if device.type == "cuda":
            torch.cuda.empty_cache()
        check_start = time.perf_counter()
        picked = check.sample_images([scenes[i] for i in range(len(names))],
                                     wl["check"]["images"], seed, weights, cfg, class_ids,
                                     device)
        picked_names, picked_scenes = [names[i] for i in picked], [scenes[i] for i in picked]
        refs = check.reference(picked_scenes, weights, cfg, class_ids, wl, device)
        reading = check.judge(check.served(out_dir, picked_names, class_ids, wl), refs, device)
        limits = wl["check"]["limits"]
        variants = {}
        if control:
            variants["control"] = check.judge(
                check.control(picked_scenes, weights, cfg, class_ids, wl, device), refs, device)
        for fault in faults:
            variants[fault] = check.judge(check.served(os.path.join(out_root, fault),
                                                       picked_names, class_ids, wl),
                                          refs, device)
        for v in variants.values():
            v["correct"] = check.is_correct(v["numbers"], limits)
        checks = {k: {"value": v, "limit": limits[k]} for k, v in reading["numbers"].items()}
        failed = stream.handed - summary["n_images"]
        correct = failed == 0 and check.is_correct(reading["numbers"], limits)
        result = {"correct": correct, "attempted": stream.handed, "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace and timer.trace is not None:
            result["breakdown"] = {"device_ops": timer.trace["device_ops"],
                                   "idle_gaps": timer.trace["idle_gaps"]}
        result["detail"] = {"classes": class_ids, "sampled": picked_names,
                            "reading": reading, "variants": variants, "window_s": window_s,
                            "setup_marks_s": dict(marks, process_start=-age0),
                            "check_s": time.perf_counter() - check_start,
                            "steps": summary["steps"], "loop_stages": summary["loop_stages"],
                            "done_ts": summary["done_ts"]}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def report(result: dict, out=None, err=None) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output (its "checks" key last)."""
    out, err = out or sys.stdout, err or sys.stderr
    err.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def run_and_report(root: str, workload: str, seed: int, seconds: float, trace: bool,
                   device) -> dict:
    """run_cell, then its detail on standard error and ``report``."""
    result = run_cell(root, workload, seed, seconds, trace, device)
    print(json.dumps({"detail": result.pop("detail")}), file=sys.stderr)
    report(result)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s), {found} found: no result",
              file=sys.stderr)
        return 2
    run_and_report(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
