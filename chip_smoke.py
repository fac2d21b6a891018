"""On-card smoke run of the PyTorch/CUDA port's serving path.

    python3 chip_smoke.py [--seed 0] [--images 8] [--stage-trace]
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout. In
order, each phase raising on failure:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA shear kernels from csrc/shear_rows.cu and
     csrc/shear_cols.cu (one nvcc call, ptxas report);
  3. each kernel vs its plain version at the serving path's shapes and
     layouts (contiguous and stride-0 input), forward and backward, with
     per-call device times (CUDA events around 5 back-to-back calls behind a
     spin kernel, median of 10 such windows) of the kernel, the
     plain version and the library yardstick (grid_sample on a prebuilt
     grid, used nowhere in the port) beside the kernel's bound;
  4. the full-size Gram stencil (100 copies, 512 -> 128) against the
     autograd normal operator;
  5. a small-input end-to-end check: ``asr_step`` on the card against the
     same call on the CPU (the plain versions);
  6. serving: ``cli.run_asr.serve`` on N images at full width (Xception OS16,
     bf16, 100 copies, 300 AMSGrad steps, random weights from seed 0), as a
     user runs it (no synchronisation inside an image): seconds per image,
     peak memory and the launch count of each kernel; then a synchronised
     per-stage profile of the first PROFILE_IMAGES images. With
     --stage-trace, also a torch.profiler window around the stages ``warp``
     and ``b`` of two more images: device kernels and device time of each.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX
package.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances of the kernel against its plain version on the same inputs:
# float32 -- both compute the same two products and a sum in f32; the kernel
# may contract them into an FMA, so they differ by a few f32 ulps, far below
# 1e-5 for values in [0, 1].
ATOL_F32 = 1e-5
# bfloat16 -- both blend in f32 and round once to bf16; an f32-ulp difference
# can flip that rounding, so the bound is one bf16 ulp of the f32 result.
# Stencil: apply_gram against the autograd normal operator A^T A x, relative
# to max|A^T A x| -- the reference's bound for the aliased extraction at the
# production shape (tests/test_gram.py: 5e-5 for the fused operator + 2e-4
# for the aliased disentangling's cumulative sums).
STENCIL_RTOL = 2.5e-4
# Small-input end to end, card vs CPU: both run float32 (TF32 off), so the
# logits agree to ~1e-5 and an argmax can flip only at near-ties; masks must
# agree on >= 99% of pixels and the continuous SR target to 1e-2.
E2E_MASK_AGREE = 0.99
E2E_TARGET_ATOL = 1e-2
# Images of the synchronised per-stage profile that follows the serving run.
PROFILE_IMAGES = 4
# Length of the spin kernel ahead of each timing window (about 2 ms at the
# card's clock): long enough for the host to enqueue the window behind it.
SPIN_CYCLES = 4_000_000

# The card's published peaks (NVIDIA H100 SXM data sheet): the bound of a call
# is the larger of its bytes over the memory rate and its float32 operations
# over the rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# One output element: 1 - t, two products, one sum.
OPS_PER_ELEMENT = 4

# Both kernels stand in for the one TPU kernel: the JAX package runs the y
# pass through it on a transposed array.
REPLACES = "deeplabv3plus_augmented_superresolution_tpu/ops/pallas_shear.py:102"
CSRC = "deeplabv3plus_augmented_superresolution_tpu_torch/csrc/"
KERNELS = {"shear_rows": CSRC + "shear_rows.cu", "shear_cols": CSRC + "shear_cols.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build():
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel

    t0 = time.perf_counter()
    path, diagnostics = shear_kernel.build(ptxas_verbose=True)
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f}s")
    for line in diagnostics.strip().splitlines():
        log(f"[build] {line}")


def median_ms(fn, iters: int = 10, calls: int = 5) -> float:
    """Device ms of one call of fn: the median over iters windows of calls
    back-to-back calls each. A spin kernel ahead of every window keeps the
    card busy while the host enqueues the window, so the events bracket the
    calls' device time and not the host's launch cost, which for a wrapper
    around one short kernel would otherwise be most of the reading."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    exponent = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(exponent - 7)


def warp_coefficients(angles: torch.Tensor, shifts: torch.Tensor, h: int, w: int):
    """Coefficients and offsets of the three passes (ops/shear_warp.py)."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(angles), torch.sin(angles)
    a = -torch.tan(angles / 2.0)
    dx, dy = shifts[:, 0], shifts[:, 1]
    tx = cos * (-dx) - sin * (-dy) + (cx - (cos * cx - sin * cy))
    ty = sin * (-dx) + cos * (-dy) + (cy - (sin * cx + cos * cy))
    return a, tx - a * ty + a * cy, sin, ty + sin * cx, a * cy


def kernel_cases(device, angles, shifts):
    """(name, kernel, shape, dtype, s, stride-0 input, primary) for every
    layout in which the serving path reaches a kernel, plus the edge probes."""
    def pass_shifts(coef, offset, center, length):
        i = torch.arange(length, dtype=torch.float32, device=device)
        return coef[:, None] * (i[None, :] - center) + offset[:, None]

    a, off_a, b, off_b, off_c = warp_coefficients(angles, shifts, 512, 512)
    s_a = pass_shifts(a, off_a, 255.5, 512)          # x pass A, per row
    s_b = pass_shifts(b, off_b, 255.5, 512)          # y pass, per column
    s_c3 = pass_shifts(a, off_c, 255.5, 512)         # the warp's last x pass
    yl = (torch.arange(128, dtype=torch.float32, device=device) + 0.5) * 4.0 - 0.5
    s_c = a[:, None] * (yl[None, :] - 255.5) + off_c[:, None]
    ramp = torch.linspace(-1.0, 1.0, 128, device=device)
    probe = torch.stack([ramp + 240.25, ramp - 239.5])
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("copies warp x pass 3 (100,3,512,512) bf16", "shear_rows",
         (100, 3, 512, 512), bf16, s_c3, False, True),
        ("copies warp x pass 1 (100,3,512,512) bf16 from one stride-0 image",
         "shear_rows", (100, 3, 512, 512), bf16, s_a, True, False),
        ("fused pass A backward (100,512,512) f32", "shear_rows",
         (100, 512, 512), f32, s_a, False, False),
        ("fused pass A (100,512,512) f32 from one stride-0 plane", "shear_rows",
         (100, 512, 512), f32, s_a, True, False),
        ("fused pass C (100,128,512) f32", "shear_rows", (100, 128, 512), f32, s_c,
         False, False),
        ("budget probe +-240 (2,128,512) f32", "shear_rows", (2, 128, 512), f32, probe,
         False, False),
        ("copies warp y pass (100,3,512,512) bf16", "shear_cols",
         (100, 3, 512, 512), bf16, s_b, False, True),
        ("fused pass B (100,512,512) f32", "shear_cols", (100, 512, 512), f32, s_b,
         False, False),
        ("edge probe +-240 (2,512,128) f32", "shear_cols", (2, 512, 128), f32, probe,
         False, False),
        ("edge probe +-240 (2,3,512,128) bf16", "shear_cols", (2, 3, 512, 128), bf16,
         probe, False, False),
    ]


def library_call(kernel: str, x: torch.Tensor, s: torch.Tensor):
    """The one PyTorch call that computes the same function: grid_sample
    (bilinear, zero padding, align_corners) of the planes at x + s (rows) or
    y + s (cols). Returns a closure over the prebuilt grid, so that only the
    call itself is timed. The port never calls it."""
    h, w = x.shape[-2:]
    channels = x.shape[1] if x.dim() == 4 else 1
    planes = x.reshape(-1, 1, h, w)
    s = s.clamp(-255.0, 254.0).repeat_interleave(channels, dim=0)
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    if kernel == "shear_rows":
        xs = xs + s[:, :, None]
    else:
        ys = ys + s[:, None, :]
    count = planes.shape[0]
    grid = torch.stack([(xs * (2.0 / (w - 1)) - 1.0).expand(count, h, w),
                        (ys * (2.0 / (h - 1)) - 1.0).expand(count, h, w)], dim=-1)
    grid = grid.to(x.dtype)
    return lambda: torch.nn.functional.grid_sample(
        planes, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def phase_kernel(device, angles, shifts):
    """Each kernel vs its plain version, forward and backward, at the path's
    shapes and layouts; times beside the bound."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops import (
        shear_kernel, shear_warp)

    kernels = {"shear_rows": (shear_kernel.shear_rows_cuda, shear_warp.shear_rows,
                              shear_warp.shear_rows_dispatch)}
    # With --package-root the package may be an earlier one whose only kernel
    # takes contiguous (N, H, W): it gets the cases it can run, channels folded.
    earlier = not hasattr(shear_kernel, "shear_cols_cuda")
    if not earlier:
        kernels["shear_cols"] = (shear_kernel.shear_cols_cuda, shear_warp.shear_cols,
                                 shear_warp.shear_cols_dispatch)
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    for name, kernel, shape, dtype, s, stride0, primary in kernel_cases(
            device, angles, shifts):
        if earlier and (stride0 or kernel not in kernels):
            continue
        if earlier and len(shape) == 4:
            s = s.repeat_interleave(shape[1], dim=0)
            shape = (shape[0] * shape[1], *shape[2:])
        launch, plain, dispatch = kernels[kernel]
        s = s.contiguous()
        source_shape = shape[1:] if stride0 else shape
        x = torch.rand(source_shape, generator=gen, device=device).to(dtype)
        if stride0:
            x = x[None].expand(shape)
        g = torch.rand(shape, generator=gen, device=device).to(dtype)
        got = launch(x, s)
        xg = x.detach().requires_grad_(True)
        (got_bwd,) = torch.autograd.grad(dispatch(xg, s), xg, g)
        torch.cuda.synchronize()
        if tuple(got.shape) != shape or tuple(got_bwd.shape) != shape:
            raise AssertionError(f"[kernel] {name}: wrong output shape")
        errs = []
        for kern, inp, shift in ((got, x, s), (got_bwd, g, -s)):
            ref32 = plain(inp.float(), shift)
            err = (kern.float() - ref32).abs()
            if dtype == torch.bfloat16:
                bad = err > bf16_ulp(ref32)
                errs.append(float((kern.float() - plain(inp, shift).float())
                                  .abs().max()))
            else:
                bad = err > ATOL_F32
                errs.append(float(err.max()))
            if bool(bad.any()):
                raise AssertionError(f"[kernel] {name}: {int(bad.sum())} elements "
                                     f"beyond tolerance, max err {float(err.max()):.3g}")
            del ref32, err, bad
        # The bound: every input byte read once (a stride-0 batch is one
        # source), every output byte written once, against the operations.
        numel = got.numel()
        moved = (x.numel() if not stride0 else x[0].numel()) * x.element_size() \
            + numel * got.element_size() + s.numel() * s.element_size()
        by_bytes = moved / PEAK_BYTES_PER_S * 1e3
        by_ops = numel * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
        bound_ms = max(by_bytes, by_ops)
        library = library_call(kernel, x, s)
        library_err = float((library().reshape(shape).float() - got.float()).abs().max())
        ms = median_ms(lambda: launch(x, s))
        plain_ms = median_ms(lambda: plain(x, s))
        library_ms = median_ms(library)
        del library
        results.append({
            "case": name, "kernel": kernel, "primary": primary, "stride0": stride0,
            "fwd_err": errs[0], "bwd_err": errs[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": moved, "share_of_bound": bound_ms / ms})
        log(f"[kernel] {kernel} {name}: fwd err {errs[0]:.3g} bwd err {errs[1]:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms grid_sample {library_ms:.4f} ms "
            f"(differs by {library_err:.3g}) bound {bound_ms:.4f} ms "
            f"({moved / 1e6:.1f} MB), share of bound {bound_ms / ms:.1%}")
    return results


def phase_stencil(device, angles, shifts, sr_cfg):
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import apply_gram
    from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
        forward_operator, precompute_gram_stencil)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coeffs = precompute_gram_stencil(angles, shifts, sr_cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((1, *sr_cfg.output_size, 1), generator=gen, device=device)
    z = x.clone().requires_grad_(True)
    out = forward_operator(z, angles, shifts, sr_cfg.feature_size, sr_cfg)
    (direct,) = torch.autograd.grad(out, z, out.detach())
    via = apply_gram(x, coeffs)
    scale = float(direct.abs().max())
    err = float((via - direct).abs().max())
    log(f"[stencil] {tuple(coeffs.shape)} extracted in {seconds:.2f}s; "
        f"|G x - A^T A x| max {err:.3g} (scale {scale:.3g}, "
        f"rel {err / scale:.3g}, bound {STENCIL_RTOL})")
    if not (np.isfinite(err) and err <= STENCIL_RTOL * scale):
        raise AssertionError("[stencil] stencil disagrees with the normal operator")
    return coeffs


def phase_small_e2e(device):
    """asr_step on the card vs the same call on the CPU (plain versions)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, build_model)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        asr_step, sample_augmentations)

    cfg = DeepLabConfig(input_shape=(64, 64, 3), final_upsample=False)
    sr_cfg = make_sr_config(None, num_aug=4, feature_size=(16, 16),
                            output_size=(64, 64), angle_max=0.15, num_iter=30)
    image = np.random.default_rng(7).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(3), 4,
                                          0.15, 8.0, device="cpu")
    outs = {}
    for dev in (torch.device("cpu"), device):
        model = build_model(cfg, seed=0, device=dev)
        if not outs:  # a class the random model predicts, so masks are non-empty
            labels = model(torch.as_tensor(image)[None]).argmax(-1)
            class_id = int(torch.bincount(labels.flatten(), minlength=21).argmax())
        outs[dev.type] = {k: v.cpu() for k, v in asr_step(
            model, torch.as_tensor(image, device=dev), angles.to(dev),
            shifts.to(dev), sr_cfg, class_id, return_targets=True).items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    agree = {k: float((cpu[k] == gpu[k]).float().mean()) for k in ("aug", "standard")}
    target_err = float((cpu["aug_target"] - gpu["aug_target"]).abs().max())
    log(f"[e2e-small] class {class_id}: mask agreement {agree}, aug_target "
        f"max err {target_err:.3g} (bounds {E2E_MASK_AGREE}, {E2E_TARGET_ATOL}); "
        f"aug fraction {float((gpu['aug'] > 0).float().mean()):.4f}")
    if min(agree.values()) < E2E_MASK_AGREE or not target_err <= E2E_TARGET_ATOL:
        raise AssertionError("[e2e-small] card and CPU disagree")


def make_images(seed: int, n: int):
    """Band-limited random scenes: smooth colour fields plus a few discs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
    images = []
    for i in range(n):
        low = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        img = np.kron(low, np.ones((64, 64, 1), np.float32))
        for _ in range(3):
            cy, cx, r = rng.uniform(100, 412), rng.uniform(100, 412), rng.uniform(30, 120)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 1, 3)
        images.append((f"scene{i}", img))
    return images


def launch_counters():
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel

    return {"shear_rows": shear_kernel.shear_rows_cuda,
            "shear_cols": shear_kernel.shear_cols_cuda}


class StageTrace:
    """A timer for ``serve`` that opens a torch.profiler window of its own
    around each of the named stages (synchronised on both sides, so kernels
    launched by autograd's thread land in the window too) and keeps each
    window's count of device activities and their summed device time."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self.windows = {name: [] for name in self.stages}

    @contextlib.contextmanager
    def stage(self, name: str):
        if name not in self.stages:
            yield
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        self.windows[name].append(
            (len(on_card), sum(e.time_range.elapsed_us() for e in on_card) / 1e3))

    def as_dict(self):
        return {}


def phase_stage_trace(device, images, model, sr_cfg, class_id, coeffs):
    """Device activities and device ms of the stages around the kernels."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import serve

    trace = StageTrace(("warp", "b"))
    serve(images[:3], model, sr_cfg, device=device, class_id=class_id,
          gram_coeffs=coeffs, writer_threads=2, timer=trace)
    for name, windows in trace.windows.items():
        if not windows or any(count == 0 for count, _ in windows):
            raise AssertionError(f"[stage-trace] no device activity traced in {name}")
        log(f"[stage-trace] stage {name}: " + "; ".join(
            f"{count} device activities, {ms:.3f} ms" for count, ms in windows)
            + " (one window per image, the first includes first-use work)")


def phase_serve(device, seed, n_images, coeffs, sr_cfg):
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab, serve)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
        OPERATOR_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.utils import StageTimer

    t0 = time.perf_counter()
    model = build_deeplab("xception", device=device)
    log(f"[serve] model built in {time.perf_counter() - t0:.1f}s "
        f"({sum(b.numel() for b in model.buffers()) / 1e6:.1f}M values)")
    images = make_images(seed, n_images)
    with torch.no_grad():
        labels = model(torch.as_tensor(images[0][1], device=device)[None]).argmax(-1)
    class_id = int(torch.bincount(labels.flatten(), minlength=21).argmax())

    # Per image: the copies warp (two x passes, one y pass; the channels ride
    # along as planes) and b = A^T y (the fused operator's three passes
    # forward, three backward). The stencil is given, so no probe launches.
    expected = {name: WARP_LAUNCHES[name] + 2 * OPERATOR_LAUNCHES[name]
                for name in KERNELS}
    counters = launch_counters()
    # The main path as a user runs it: no timer, so nothing inside an image
    # waits for the card and the host enqueues ahead of it. This run gives
    # the end-to-end seconds per image and the launch counts.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary = serve(images, model, sr_cfg, device=device, class_id=class_id,
                    gram_coeffs=coeffs, writer_threads=2)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[serve] class {class_id}; {summary['n_images']} images, first "
        f"{summary['first_image_s']:.3f}s, steady {summary['steady_s_per_image']:.3f}"
        f" s/image, wall {summary['wall_s']:.2f}s, peak memory {peak / 2**30:.2f} GiB")

    # A synchronised profile on the first images: each stage is bracketed by
    # torch.cuda.synchronize, so host and card no longer overlap; each stage's
    # time is its cost alone, and their sum exceeds the end-to-end time above.
    timer = StageTimer(sync_device=device)
    profile = serve(images[:PROFILE_IMAGES], model, sr_cfg, device=device,
                    class_id=class_id, gram_coeffs=coeffs, writer_threads=2,
                    timer=timer)
    log(f"[serve-profile] synchronised stages, {profile['n_images']} images, "
        f"steady {profile['steady_s_per_image']:.3f} s/image")
    for stage, d in profile["stages"].items():
        log(f"[serve-profile] stage {stage}: {d['ms_per_call']:.2f} ms/call"
            f" (steady {d.get('steady_ms_per_call', float('nan')):.2f}) x{d['calls']}")
    log(f"[serve] mask fractions {json.dumps(summary['mask_fractions'])}")
    log(f"[serve] kernel launches {json.dumps(launches)} over {n_images} images, "
        f"expected per image {json.dumps(expected)}")
    if summary["n_images"] != n_images or len(summary["mask_fractions"]) != n_images:
        raise AssertionError("[serve] not every image was served")
    for name, count in launches.items():
        if count <= 0 or count != expected[name] * n_images:
            raise AssertionError(f"[serve] {count} {name} launches, expected "
                                 f"{expected[name] * n_images}")
    if expected != {"shear_rows": 6, "shear_cols": 3}:
        raise AssertionError(f"[serve] the per-image split moved: {expected}")
    for name, fr in summary["mask_fractions"].items():
        if not all(0.0 <= v <= 1.0 for v in fr.values()):
            raise AssertionError(f"[serve] mask fractions out of range for {name}")
    return launches, summary, peak, class_id, model, images


def check_target(model, device, image, class_id, coeffs, sr_cfg, angles, shifts):
    """The continuous SR target of one full-size image is finite, (512, 512, 1)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import asr_step

    out = asr_step(model, torch.as_tensor(image, device=device), angles, shifts,
                   sr_cfg, class_id, th_factor=0.2, gram_coeffs=coeffs,
                   return_targets=True)
    target = out["aug_target"]
    if tuple(target.shape) != (512, 512, 1) or not bool(torch.isfinite(target).all()):
        raise AssertionError("[serve] SR target is not a finite (512, 512, 1) map")
    log(f"[serve] target range [{float(target.min()):.4f}, {float(target.max()):.4f}]")


def main() -> None:
    parser = argparse.ArgumentParser(description="On-card smoke run of the port.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--stage-trace", action="store_true",
                        help="also trace the warp and b stages with torch.profiler")
    parser.add_argument("--package-root", default="",
                        help="with --kernels-only: a directory that holds another "
                             "checkout's port package, whose kernels are timed "
                             "instead (before and after in one call)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel phase (for tuning): prints no "
                             "result line")
    args = parser.parse_args()

    if args.package_root:
        if not args.kernels_only:
            parser.error("--package-root needs --kernels-only")
        sys.path.insert(0, args.package_root)
    # The port itself first: outside a checkout this fails before any output.
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        SEED, make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        sample_augmentations)

    device = phase_device()
    t_start = time.perf_counter()
    phase_build()
    sr_cfg = make_sr_config(None, num_aug=100, angle_max=0.15)
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED), 100,
                                          0.15, 80.0, device=device)
    kernel_results = phase_kernel(device, angles, shifts)
    if args.kernels_only:
        return
    coeffs = phase_stencil(device, angles, shifts, sr_cfg)
    phase_small_e2e(device)
    launches, summary, peak, class_id, model, images = phase_serve(
        device, args.seed, args.images, coeffs, sr_cfg)
    check_target(model, device, images[0][1], class_id, coeffs, sr_cfg, angles, shifts)
    if args.stage_trace:
        phase_stage_trace(device, images, model, sr_cfg, class_id, coeffs)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")

    entries = []
    for name, source in KERNELS.items():
        cases = [r for r in kernel_results if r["kernel"] == name]
        (main_case,) = [r for r in cases if r["primary"]]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES,
            "launches": launches[name],
            "max_abs_err": max(max(r["fwd_err"], r["bwd_err"]) for r in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "ms_case": main_case["case"],
            "per_case": cases})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
