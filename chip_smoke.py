"""On-card smoke run of the PyTorch/CUDA port's serving path.

    python3 chip_smoke.py [--seed 0] [--images 8]

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout. In
order, each phase raising on failure:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA shear kernel from csrc/shear_rows.cu (nvcc, ptxas report);
  3. kernel vs plain version at the serving path's shapes, forward and
     backward, with per-call times (CUDA events, median of 10 calls);
  4. the full-size Gram stencil (100 copies, 512 -> 128) against the
     autograd normal operator;
  5. a small-input end-to-end check: ``asr_step`` on the card against the
     same call on the CPU (the plain versions);
  6. serving: ``cli.run_asr.serve`` on N images at full width (Xception OS16,
     bf16, 100 copies, 300 AMSGrad steps, random weights from seed 0), as a
     user runs it (no synchronisation inside an image): seconds per image,
     peak memory and the kernel launch count; then a synchronised per-stage
     profile of the first PROFILE_IMAGES images.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX
package.
"""

import argparse
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

REPLACES = "deeplabv3plus_augmented_superresolution_tpu/ops/pallas_shear.py:102"
SOURCE = "deeplabv3plus_augmented_superresolution_tpu_torch/csrc/shear_rows.cu"


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


def median_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    exponent = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(exponent - 7)


def pass_a_shifts(angles: torch.Tensor, shifts: torch.Tensor, h: int, w: int):
    """Row shifts of the warp's first x pass (ops/shear_warp.py)."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(angles), torch.sin(angles)
    a = -torch.tan(angles / 2.0)
    dx, dy = shifts[:, 0], shifts[:, 1]
    tx = cos * (-dx) - sin * (-dy) + (cx - (cos * cx - sin * cy))
    ty = sin * (-dx) + cos * (-dy) + (cy - (sin * cx + cos * cy))
    y = torch.arange(h, dtype=torch.float32, device=angles.device)
    return a[:, None] * (y[None, :] - cy) + (tx - a * ty + a * cy)[:, None], a


def phase_kernel(device, angles, shifts):
    """Kernel vs plain version, forward and backward, at the path's shapes."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_kernel import (
        shear_rows_cuda)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        shear_rows, shear_rows_dispatch)

    gen = torch.Generator(device=device).manual_seed(0)
    s_a, a = pass_a_shifts(angles, shifts, 512, 512)
    yl = (torch.arange(128, dtype=torch.float32, device=device) + 0.5) * 4.0 - 0.5
    s_c = a[:, None] * (yl[None, :] - 255.5) + (a * 255.5)[:, None]
    ramp = torch.linspace(-1.0, 1.0, 128, device=device)
    cases = [
        ("copies warp (300,512,512) bf16", (300, 512, 512), torch.bfloat16,
         s_a.repeat_interleave(3, dim=0)),
        ("fused pass A/B (100,512,512) f32", (100, 512, 512), torch.float32, s_a),
        ("fused pass C (100,128,512) f32", (100, 128, 512), torch.float32, s_c),
        ("budget probe +-240 (2,128,512) f32", (2, 128, 512), torch.float32,
         torch.stack([ramp + 240.25, ramp - 239.5])),
    ]
    results, worst = [], 0.0
    for name, shape, dtype, s in cases:
        s = s.contiguous()
        x = torch.rand(shape, generator=gen, device=device).to(dtype)
        g = torch.rand(shape, generator=gen, device=device).to(dtype)
        got = shear_rows_cuda(x, s)
        xg = x.clone().requires_grad_(True)
        (got_bwd,) = torch.autograd.grad(shear_rows_dispatch(xg, s), xg, g)
        torch.cuda.synchronize()
        errs = []
        for kern, inp, shift in ((got, x, s), (got_bwd, g, -s)):
            ref32 = shear_rows(inp.float(), shift)
            err = (kern.float() - ref32).abs()
            if dtype == torch.bfloat16:
                bad = err > bf16_ulp(ref32)
                errs.append(float((kern.float() - shear_rows(inp, shift).float())
                                  .abs().max()))
            else:
                bad = err > ATOL_F32
                errs.append(float(err.max()))
            if bool(bad.any()):
                raise AssertionError(f"[kernel] {name}: {int(bad.sum())} elements "
                                     f"beyond tolerance, max err {float(err.max()):.3g}")
        ms = median_ms(lambda: shear_rows_cuda(x, s))
        plain_ms = median_ms(lambda: shear_rows(x, s))
        worst = max(worst, *errs)
        results.append({"case": name, "fwd_err": errs[0], "bwd_err": errs[1],
                        "ms": ms, "plain_ms": plain_ms})
        log(f"[kernel] {name}: fwd err {errs[0]:.3g} bwd err {errs[1]:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return results, worst


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


def phase_serve(device, seed, n_images, coeffs, sr_cfg):
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab, serve)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_kernel import (
        shear_rows_cuda)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        SHEAR_PASSES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.utils import StageTimer

    t0 = time.perf_counter()
    model = build_deeplab("xception", device=device)
    log(f"[serve] model built in {time.perf_counter() - t0:.1f}s "
        f"({sum(b.numel() for b in model.buffers()) / 1e6:.1f}M values)")
    images = make_images(seed, n_images)
    with torch.no_grad():
        labels = model(torch.as_tensor(images[0][1], device=device)[None]).argmax(-1)
    class_id = int(torch.bincount(labels.flatten(), minlength=21).argmax())

    # Per image: the copies warp (SHEAR_PASSES launches, channels folded into
    # the batch) and b = A^T y (the fused operator's three passes forward,
    # three backward). The stencil is given, so no probe launches.
    expected_per_image = SHEAR_PASSES + 2 * SHEAR_PASSES
    # The main path as a user runs it: no timer, so nothing inside an image
    # waits for the card and the host enqueues ahead of it. This run gives
    # the end-to-end seconds per image and the launch count.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    shear_rows_cuda.launches = 0
    summary = serve(images, model, sr_cfg, device=device, class_id=class_id,
                    gram_coeffs=coeffs, writer_threads=2)
    launches = shear_rows_cuda.launches
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
    log(f"[serve] kernel launches {launches} ({launches / n_images:g} per image, "
        f"expected {expected_per_image})")
    if summary["n_images"] != n_images or len(summary["mask_fractions"]) != n_images:
        raise AssertionError("[serve] not every image was served")
    if launches <= 0 or launches != expected_per_image * n_images:
        raise AssertionError(f"[serve] {launches} kernel launches, expected "
                             f"{expected_per_image * n_images}")
    for name, fr in summary["mask_fractions"].items():
        if not all(0.0 <= v <= 1.0 for v in fr.values()):
            raise AssertionError(f"[serve] mask fractions out of range for {name}")
    return launches, summary, peak, class_id, model


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
    args = parser.parse_args()

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
    kernel_results, worst = phase_kernel(device, angles, shifts)
    coeffs = phase_stencil(device, angles, shifts, sr_cfg)
    phase_small_e2e(device)
    launches, summary, peak, class_id, model = phase_serve(
        device, args.seed, args.images, coeffs, sr_cfg)
    check_target(model, device, make_images(args.seed, 1)[0][1], class_id,
                 coeffs, sr_cfg, angles, shifts)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")

    main_shape = kernel_results[0]
    print(json.dumps({"kernels": [{
        "name": "shear_rows", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "ms_case": main_shape["case"], "per_case": kernel_results}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
