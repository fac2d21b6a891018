"""On-card smoke run of the PyTorch/CUDA port: its serving and training paths.

    python3 chip_smoke.py [--seed 0] [--images 6] [--stage-trace]
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout. In
order, each phase raising on failure:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA shear kernels from csrc/shear_rows.cu and
     csrc/shear_cols.cu (one nvcc call, ptxas report);
  3. the full-size Gram stencils (100 copies, 512 -> 128 for Xception and
     512 -> 64 for MobileNetV2) against the autograd normal operator;
  4. serving: ``cli.run_asr.serve`` at full width (512 px, bf16, 100 copies,
     300 AMSGrad steps, random weights from seed 0), as a user runs it (no
     synchronisation inside an image), on three configurations: Xception
     OS16, one class, aug (N images, then a synchronised per-stage profile
     of the first PROFILE_IMAGES); Xception OS16, all 20 classes, aug + max
     + mean and the label map, unchunked and in class groups; MobileNetV2
     OS8, feature 64, its own stencil, one class, aug + max + mean. Each
     reports seconds per image, the first image, peak memory, mask
     fractions and the launches of each kernel, counted from 0 for that
     path, against the launches its design implies per step (one image,
     or one batch). Then three more Xception paths, each with its own
     synchronised profile: ``--batch 4`` (BATCH_IMAGES images: two full
     batches and a ragged one, the batch riding the kernels' channel axis,
     so a batch launches what one image does), ``--per_image_augs`` (each
     image its own set, so each solve extracts its stencil: 35 probes of
     the operator), ``--fast`` (the direct solver on 25-copy windows, 60
     steps, the operator forward and backward in every step). With
     --stage-trace, also a torch.profiler window around the stages
     ``warp`` and ``b`` of two more images: device kernels and device time
     of each;
  5. training: ``cli.train`` at full width (Xception OS16, bf16, adam 1e-3,
     batch 8, random init from its seed, synthetic scenes), as a user runs
     it (no synchronisation inside a chunk of steps; the losses fetched once
     per chunk): ``train`` (the CLI's default, 128 px), ``train-warp-512``
     (512 px with ``--warp_augment``: 4 shear_rows + 2 shear_cols launches
     a step, asserted), ``train-remat-512`` (the same with ``--remat``);
     each reports the steady seconds per step and images per second over
     the steps after the first chunk, the first step, the peak memory, the
     losses (finite and falling) and its launches, then a torch.profiler
     window over three more steps (device time a step, the idle share, the
     kernels that take it). Then ``train-then-serve``: the warp run's
     checkpoint resumes for one step, and its saved params serve one image
     through ``cli.run_asr.serve`` (``--weights_path``);
  6. each kernel vs its plain version at the serving paths' shapes and
     layouts (contiguous, stride-0 and class-major input: the copies warp
     of one image or of a batch of 4, the fused operator at features 128
     and 64 with one, 4 or 20 target planes and on 25-copy windows, the
     inverse warp of max/mean SR with one or 20 class planes), forward
     and backward, with per-call device times (CUDA events around 5
     back-to-back calls behind a spin kernel, median of 10 such windows) of
     the kernel, the plain version and the library yardstick (grid_sample on
     a prebuilt grid, used nowhere in the port) beside the kernel's bound.
     A case that moves less than ROTATE_BYTES is timed on a ring of inputs
     and outputs that together exceed the card's L2, so that its time is
     one of memory, not of the cache;
     The training layouts are there too: a batch of 8 images (3 planes each,
     its own shifts) and of 8 label maps (integer shifts: the nearest mode,
     held exactly), at 128 and 512 px;
  7. small-input end-to-end checks, each on the card against the same call
     on the CPU (the plain versions): ``asr_step`` with aug, max and mean;
     ``asr_step_multiclass`` of 3 classes with the label map, unchunked and
     in class groups of 2, and of a batch of 2 images; MobileNetV2;
     ``asr_step`` with the IRLS-CG solver and with the direct solver on
     copy minibatches; one train step of MobileNetV2 (alpha 0.35, 32 px,
     f32) and ``warp_augment_batch`` with given draws.

Before any of it, a line says whether the native decode ring
(``data/native_loader.py``, host decode) builds on this machine; the script
serves decoded arrays and needs no ring.

The serving and training paths run before the kernel cases and the CPU
checks, and training after serving, so that no phase leaves load on the
card or the host while a path is timed.
The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX
package.
"""

import argparse
import contextlib
import itertools
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
# Training (cli.train, Xception bf16 adam 1e-3): the batch, the sizes (the
# CLI's default and the quality demo's), steps and chunk (--log_every) of each
# timed run, its synthetic set (--train_set, --eval_images; cut at 512 px,
# where the host draws each scene in numpy) and the steps of the profiled
# window.
TRAIN_BATCH = 8
TRAIN_SIZES = (128, 512)
TRAIN_STEPS, TRAIN_CHUNK = 25, 5
REMAT_STEPS = 15
TRAIN_SET = {128: 128, 512: 32}
TRAIN_EVAL_IMAGES = {128: 16, 512: 8}
PROFILE_STEPS = 3
# Card vs CPU, one train step (tests/test_torch_train.py's start and
# tolerances): sgd at lr 1e-5 from the initial params with every BN's gamma
# from U(0.25, 0.5) and beta from +-U(1, 2), where the gradient is well
# conditioned. The loss 1e-5 relative; moving statistics 1e-5 absolute +
# 1e-5 relative; the other parameters 1e-6 absolute; sgd's momentum trace
# (the gradient) per leaf to 1% of the leaf's largest value + 1e-4 of the
# whole trace's.
TRAIN_CHECK_LR = 1e-5
# Images of the synchronised per-stage profile that follows the serving run.
PROFILE_IMAGES = 4
# Images of the 20-class and the MobileNetV2 serving paths, and the class
# group size of the 20-class path's chunked run (4 groups of 5).
MULTI_IMAGES = 4
MOBILENET_IMAGES = 4
CLASS_CHUNK = 5
# The batch of the --batch path and its images: two full batches and a
# ragged one; the images of the --per_image_augs and --fast paths.
BATCH = 4
BATCH_IMAGES = 9
PER_IMAGE_IMAGES = 3
FAST_IMAGES = 4
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
# The card's L2 (50 MB on the H100 SXM). A kernel case that moves less than
# four times this is timed on a ring of inputs (and their outputs) that
# together move at least that much, so that its time is the memory's.
L2_BYTES = 50 * 2**20
ROTATE_BYTES = 4 * L2_BYTES

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
    from deeplabv3plus_augmented_superresolution_tpu_torch.data import native_loader
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops import shear_kernel

    t0 = time.perf_counter()
    path, diagnostics = shear_kernel.build(ptxas_verbose=True)
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f}s")
    for line in diagnostics.strip().splitlines():
        log(f"[build] {line}")
    # Host decode for run_asr's file inputs; this script serves arrays.
    t0 = time.perf_counter()
    if native_loader.available():
        log(f"[build] native decode ring built in {time.perf_counter() - t0:.2f}s")
    else:
        lines = (native_loader.build_error() or "unknown").strip().splitlines()
        error = next((ln for ln in lines if "error" in ln), lines[-1])
        log("[build] native decode ring did not build here (run_asr would decode "
            f"with PIL): {error.strip()}")


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


def rotating(fn, inputs):
    """A call of fn on the next of inputs in turn. Each output is kept until
    its slot comes round again, so that with a ring larger than L2 no call
    finds its input or its output's memory in the cache."""
    outputs = [None] * len(inputs)
    turn = itertools.count()

    def call():
        i = next(turn) % len(inputs)
        outputs[i] = fn(inputs[i])
    return call


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    exponent = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(exponent - 7)


def kernel_cases(device, angles, shifts):
    """(name, kernel, shape, dtype, s, layout, primary, exact) for every layout
    in which the serving and training paths reach a kernel, plus the edge
    probes; exact: integer shifts (the nearest mode), held bit for bit. layout:
    "dense"; "stride0", every copy reads the same planes (stride 0 over the
    copies); "class_major", the (N, K, H, W) view of a (K, N, H, W) stack, as
    the inverse warp reads the upsampled class masks."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        inverse_shifts, paeth_coefficients, pass_shifts)

    def decimated_shifts(a, off_c, feature):
        yl = (torch.arange(feature, dtype=torch.float32, device=device) + 0.5) \
            * (512 / feature) - 0.5
        return a[:, None] * (yl[None, :] - 255.5) + off_c[:, None]

    a, off_a, b, off_b, off_c = paeth_coefficients(angles, shifts, 512, 512)
    s_a = pass_shifts(a, off_a, 255.5, 512)          # x pass A, per row
    s_b = pass_shifts(b, off_b, 255.5, 512)          # y pass, per column
    s_c3 = pass_shifts(a, off_c, 255.5, 512)         # the warp's last x pass
    s_c = decimated_shifts(a, off_c, 128)
    s_c64 = decimated_shifts(a, off_c, 64)
    # the inverse warp of max/mean SR
    ia, ioff_a, ib, ioff_b, ioff_c = paeth_coefficients(*inverse_shifts(angles, shifts),
                                                        512, 512)
    si_a = pass_shifts(ia, ioff_a, 255.5, 512)
    si_b = pass_shifts(ib, ioff_b, 255.5, 512)
    si_c = pass_shifts(ia, ioff_c, 255.5, 512)
    ramp = torch.linspace(-1.0, 1.0, 128, device=device)
    probe = torch.stack([ramp + 240.25, ramp - 239.5])
    bf16, f32 = torch.bfloat16, torch.float32
    train_cases = _train_kernel_cases(device, paeth_coefficients, pass_shifts)
    return [
        ("copies warp x pass 3 (100,3,512,512) bf16", "shear_rows",
         (100, 3, 512, 512), bf16, s_c3, "dense", True, False),
        ("copies warp x pass 1 (100,3,512,512) bf16 from one stride-0 image",
         "shear_rows", (100, 3, 512, 512), bf16, s_a, "stride0", False, False),
        ("fused pass A backward (100,512,512) f32", "shear_rows",
         (100, 512, 512), f32, s_a, "dense", False, False),
        ("fused pass A (100,512,512) f32 from one stride-0 plane", "shear_rows",
         (100, 512, 512), f32, s_a, "stride0", False, False),
        ("fused pass C (100,128,512) f32", "shear_rows", (100, 128, 512), f32, s_c,
         "dense", False, False),
        ("fused pass C at feature 64 (MobileNetV2) (100,64,512) f32", "shear_rows",
         (100, 64, 512), f32, s_c64, "dense", False, False),
        ("fused pass A, 20 target planes (b of 20 classes) (100,20,512,512) f32 "
         "from stride-0 planes", "shear_rows", (100, 20, 512, 512), f32, s_a,
         "stride0", False, False),
        ("fused pass C, 20 planes (100,20,128,512) f32", "shear_rows",
         (100, 20, 128, 512), f32, s_c, "dense", False, False),
        ("inverse warp x pass 1 (100,1,512,512) f32", "shear_rows",
         (100, 1, 512, 512), f32, si_a, "dense", False, False),
        ("inverse warp x pass 3 (100,1,512,512) f32", "shear_rows",
         (100, 1, 512, 512), f32, si_c, "dense", False, False),
        ("inverse warp x pass 1, 20 class planes (100,20,512,512) f32, class-major",
         "shear_rows", (100, 20, 512, 512), f32, si_a, "class_major", False, False),
        ("inverse warp x pass 3, 20 class planes (100,20,512,512) f32", "shear_rows",
         (100, 20, 512, 512), f32, si_c, "dense", False, False),
        ("budget probe +-240 (2,128,512) f32", "shear_rows", (2, 128, 512), f32, probe,
         "dense", False, False),
        # --batch 4: the copies warp of 4 images (12 planes), b on 4 planes
        ("copies warp x pass 1, batch of 4 (100,12,512,512) bf16 from 4 stride-0 "
         "images", "shear_rows", (100, 12, 512, 512), bf16, s_a, "stride0", False, False),
        ("copies warp x pass 3, batch of 4 (100,12,512,512) bf16", "shear_rows",
         (100, 12, 512, 512), bf16, s_c3, "dense", False, False),
        ("fused pass A, batch of 4 (100,4,512,512) f32 from 4 stride-0 planes",
         "shear_rows", (100, 4, 512, 512), f32, s_a, "stride0", False, False),
        ("fused pass A backward, batch of 4 (100,4,512,512) f32", "shear_rows",
         (100, 4, 512, 512), f32, s_a, "dense", False, False),
        ("fused pass C, batch of 4 (100,4,128,512) f32", "shear_rows",
         (100, 4, 128, 512), f32, s_c, "dense", False, False),
        # --fast: the direct solver's operator on 25-copy windows
        ("direct solver pass A (25,512,512) f32 from one stride-0 plane",
         "shear_rows", (25, 512, 512), f32, s_a[:25], "stride0", False, False),
        ("direct solver pass A backward (25,512,512) f32", "shear_rows",
         (25, 512, 512), f32, s_a[:25], "dense", False, False),
        ("direct solver pass C (25,128,512) f32", "shear_rows", (25, 128, 512), f32,
         s_c[:25], "dense", False, False),
        ("copies warp y pass (100,3,512,512) bf16", "shear_cols",
         (100, 3, 512, 512), bf16, s_b, "dense", True, False),
        ("fused pass B (100,512,512) f32", "shear_cols", (100, 512, 512), f32, s_b,
         "dense", False, False),
        ("inverse warp y pass (100,1,512,512) f32", "shear_cols", (100, 1, 512, 512),
         f32, si_b, "dense", False, False),
        ("inverse warp y pass, 20 class planes (100,20,512,512) f32 (also fused "
         "pass B of 20 planes)", "shear_cols", (100, 20, 512, 512), f32, si_b,
         "dense", False, False),
        ("copies warp y pass, batch of 4 (100,12,512,512) bf16", "shear_cols",
         (100, 12, 512, 512), bf16, s_b, "dense", False, False),
        ("fused pass B, batch of 4 (100,4,512,512) f32", "shear_cols",
         (100, 4, 512, 512), f32, s_b, "dense", False, False),
        ("direct solver pass B (25,512,512) f32", "shear_cols", (25, 512, 512), f32,
         s_b[:25], "dense", False, False),
        ("edge probe +-240 (2,512,128) f32", "shear_cols", (2, 512, 128), f32, probe,
         "dense", False, False),
        ("edge probe +-240 (2,3,512,128) bf16", "shear_cols", (2, 3, 512, 128), bf16,
         probe, "dense", False, False),
    ] + train_cases


def _train_kernel_cases(device, paeth_coefficients, pass_shifts):
    """warp_augment_batch's layouts: TRAIN_BATCH images of 3 planes and as many
    label maps of 1 plane, contiguous, each sample its own angle and shift
    (all taken), at the training sizes; labels with the nearest mode's
    integer shifts."""
    cases = []
    gen = torch.Generator().manual_seed(5)
    for size in TRAIN_SIZES:
        angles = ((torch.rand(TRAIN_BATCH, generator=gen) * 2 - 1) * 0.15).to(device)
        shifts = ((torch.rand((TRAIN_BATCH, 2), generator=gen) * 2 - 1)
                  * (80.0 * size / 512)).to(device)
        a, off_a, b, off_b, _ = paeth_coefficients(angles, shifts, size, size)
        centre = (size - 1) / 2.0
        for planes, mode in ((3, "bilinear"), (1, "nearest")):
            what = "images" if planes == 3 else "labels, nearest"
            shape = (TRAIN_BATCH, planes, size, size)
            exact = mode == "nearest"
            cases.append((f"train warp x pass, {what} {shape} f32", "shear_rows", shape,
                          torch.float32, pass_shifts(a, off_a, centre, size, mode),
                          "dense", False, exact))
            cases.append((f"train warp y pass, {what} {shape} f32", "shear_cols", shape,
                          torch.float32, pass_shifts(b, off_b, centre, size, mode),
                          "dense", False, exact))
    return cases


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
                              shear_warp.shear_rows_dispatch),
               "shear_cols": (shear_kernel.shear_cols_cuda, shear_warp.shear_cols,
                              shear_warp.shear_cols_dispatch)}
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    for name, kernel, shape, dtype, s, layout, primary, exact in kernel_cases(
            device, angles, shifts):
        launch, plain, dispatch = kernels[kernel]
        s = s.contiguous()
        stride0 = layout == "stride0"

        def make_input():
            if stride0:
                return torch.rand(shape[1:], generator=gen,
                                  device=device).to(dtype)[None].expand(shape)
            if layout == "class_major":
                return torch.rand((shape[1], shape[0], *shape[2:]), generator=gen,
                                  device=device).to(dtype).transpose(0, 1)
            return torch.rand(shape, generator=gen, device=device).to(dtype)

        x = make_input()
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
            if exact:
                bad = err > 0
                errs.append(float(err.max()))
            elif dtype == torch.bfloat16:
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
        del library, g, got, got_bwd, xg
        copies = -(-ROTATE_BYTES // moved)
        ring = [x] + [make_input() for _ in range(copies - 1)]
        ms = median_ms(rotating(lambda xi: launch(xi, s), ring))
        plain_ms = median_ms(rotating(lambda xi: plain(xi, s), ring))
        library_ms = median_ms(rotating(lambda f: f(), [library_call(kernel, xi, s)
                                                         for xi in ring]))
        del x, ring
        torch.cuda.empty_cache()
        results.append({
            "case": name, "kernel": kernel, "primary": primary, "layout": layout,
            "exact": exact,
            "ring": copies,
            "fwd_err": errs[0], "bwd_err": errs[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": moved, "share_of_bound": bound_ms / ms})
        log(f"[kernel] {kernel} {name} (ring of {copies}): fwd err {errs[0]:.3g} "
            f"bwd err {errs[1]:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms grid_sample {library_ms:.4f} ms "
            f"(differs by {library_err:.3g}) bound {bound_ms:.4f} ms "
            f"({moved / 1e6:.1f} MB), share of bound {bound_ms / ms:.1%}")
    return results


def phase_stencil(device, angles, shifts, sr_cfg, label):
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
    log(f"[stencil] {label}: {tuple(coeffs.shape)} for 512 -> "
        f"{sr_cfg.feature_size[0]} extracted in {seconds:.2f}s; "
        f"|G x - A^T A x| max {err:.3g} (scale {scale:.3g}, "
        f"rel {err / scale:.3g}, bound {STENCIL_RTOL})")
    if not (np.isfinite(err) and err <= STENCIL_RTOL * scale):
        raise AssertionError(f"[stencil] {label}: stencil disagrees with the "
                             "normal operator")
    return coeffs


def _compare(label, cpu, gpu):
    """Masks agree on >= E2E_MASK_AGREE of pixels, continuous targets within
    E2E_TARGET_ATOL, on every key of one step's result."""
    if set(cpu) != set(gpu):
        raise AssertionError(f"[e2e-small] {label}: keys differ")
    agree, err = {}, {}
    for key in cpu:
        if key.endswith("_target"):
            err[key] = float((cpu[key] - gpu[key]).abs().max())
        else:
            agree[key] = float((cpu[key] == gpu[key]).float().mean())
    log(f"[e2e-small] {label}: mask agreement {agree}, target max err {err} "
        f"(bounds {E2E_MASK_AGREE}, {E2E_TARGET_ATOL})")
    if min(agree.values()) < E2E_MASK_AGREE or not all(
            e <= E2E_TARGET_ATOL for e in err.values()):
        raise AssertionError(f"[e2e-small] {label}: the two disagree")


def phase_small_e2e(device):
    """The per-image programs on the card vs the same calls on the CPU (the
    plain versions), at 64 px, f32: asr_step with aug, max and mean;
    asr_step_multiclass of 3 classes with the label map, unchunked and in
    class groups of 2, and of 2 classes on a batch of 2 images; asr_step on
    MobileNetV2 (feature 8); asr_step with IRLS-CG (2 x 5 steps) and with
    the direct solver on windows of 2 of the 4 copies (10 steps)."""
    import dataclasses

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, build_model)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        asr_step, asr_step_multiclass, sample_augmentations)

    cfg = DeepLabConfig(input_shape=(64, 64, 3), final_upsample=False)
    mob_cfg = dataclasses.replace(cfg, backbone="mobilenet")
    sr_cfg = make_sr_config(None, num_aug=4, feature_size=(16, 16),
                            output_size=(64, 64), angle_max=0.15, num_iter=30)
    mob_sr_cfg = dataclasses.replace(sr_cfg, feature_size=(8, 8))
    cg_cfg = dataclasses.replace(sr_cfg, solver_impl="cg", cg_outer=2, cg_inner=5)
    minibatch_cfg = dataclasses.replace(sr_cfg, sgd_copies=2, num_iter=10)
    rng = np.random.default_rng(7)
    image = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    pair = np.stack([image, rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)])
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(3), 4,
                                          0.15, 8.0, device="cpu")
    sr_types = ("aug", "max", "mean")
    outs = {}
    for dev in (torch.device("cpu"), device):
        model = build_model(cfg, seed=0, device=dev)
        mob = build_model(mob_cfg, seed=0, device=dev)
        img, a, sh = torch.as_tensor(image, device=dev), angles.to(dev), shifts.to(dev)
        imgs = torch.as_tensor(pair, device=dev)
        if not outs:  # classes the random models predict, so masks are non-empty
            with torch.no_grad():
                counts = torch.bincount(model(img[None]).argmax(-1).flatten(),
                                        minlength=21)
                class_ids = tuple(int(c) for c in counts.argsort(descending=True)[:3])
                mob_class = int(torch.bincount(mob(img[None]).argmax(-1).flatten(),
                                               minlength=21).argmax())
        runs = {
            "asr_step aug+max+mean": asr_step(
                model, img, a, sh, sr_cfg, class_ids[0], sr_types=sr_types,
                return_targets=True),
            "asr_step_multiclass": asr_step_multiclass(
                model, img, a, sh, sr_cfg, class_ids, sr_types=sr_types,
                return_targets=True, return_label_map=True),
            "asr_step_multiclass class_chunk 2": asr_step_multiclass(
                model, img, a, sh, sr_cfg, class_ids, sr_types=sr_types,
                class_chunk=2, return_targets=True, return_label_map=True),
            "asr_step MobileNetV2": asr_step(
                mob, img, a, sh, mob_sr_cfg, mob_class, sr_types=sr_types,
                return_targets=True),
            "asr_step_multiclass batch of 2": asr_step_multiclass(
                model, imgs, a, sh, sr_cfg, class_ids[:2], sr_types=sr_types,
                return_targets=True, return_label_map=True),
            "asr_step cg": asr_step(
                model, img, a, sh, cg_cfg, class_ids[0], sr_types=("aug",),
                return_targets=True),
            "asr_step direct minibatch": asr_step(
                model, img, a, sh, minibatch_cfg, class_ids[0], sr_types=("aug",),
                return_targets=True),
        }
        outs[dev.type] = {label: {k: v.cpu() for k, v in out.items()}
                          for label, out in runs.items()}
    log(f"[e2e-small] classes {class_ids} (Xception), {mob_class} (MobileNetV2)")
    for label in outs["cpu"]:
        _compare(label, outs["cpu"][label], outs["cuda"][label])
    _compare("class_chunk 2 vs 0 on the card", outs["cuda"]["asr_step_multiclass"],
             outs["cuda"]["asr_step_multiclass class_chunk 2"])
    gpu = outs["cuda"]["asr_step aug+max+mean"]
    log(f"[e2e-small] aug fraction {float((gpu['aug'] > 0).float().mean()):.4f}")


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


def expected_launches(sr_types, groups: int = 1, probes: int = 0,
                      direct_steps: int = 0):
    """Kernel launches per step (one image, or one batch: its images ride
    the kernels' channel axis, so the batch size does not count) that the
    design implies: the copies warp (two x passes, one y pass; the channels
    ride along as planes) once, and per class group for "aug" one
    application of the fused operator (three passes) forward and one
    backward for b = A^T y, plus as many for each of the stencil's probes
    when the step extracts its own (``probes``), or instead of both, one
    forward and one backward in each step of the direct solver
    (``direct_steps``); and one inverse warp (three passes) when "max" or
    "mean" is served. The K classes of a group ride the channel axis too, so
    K does not count; groups = ceil(K / class_chunk), 1 when unchunked."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
        OPERATOR_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    out = {}
    for name in KERNELS:
        per_group = 0
        if "aug" in sr_types:
            applications = direct_steps if direct_steps else 1 + probes
            per_group += 2 * OPERATOR_LAUNCHES[name] * applications
        if "max" in sr_types or "mean" in sr_types:
            per_group += WARP_LAUNCHES[name]
        out[name] = WARP_LAUNCHES[name] + groups * per_group
    return out


def most_frequent_class(model, image, device) -> int:
    with torch.no_grad():
        labels = model(torch.as_tensor(image, device=device)[None]).argmax(-1)
    return int(torch.bincount(labels.flatten(), minlength=21).argmax())


def serve_path(label, device, images, model, sr_cfg, coeffs, expected, **kw):
    """One serving path as a user runs it: no timer, so nothing inside a
    step waits for the card and the host enqueues ahead of it. The launch
    counts are set to 0 just before and read just after, and must be the
    design's per step times the steps (one per image, or one per batch of
    kw["batch"] images); peak memory is this path's own."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import serve

    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary = serve(images, model, sr_cfg, device=device, gram_coeffs=coeffs,
                    writer_threads=2, **kw)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    n_images = len(images)
    n_steps = -(-n_images // max(kw.get("batch", 0), 1))
    done = summary["done_ts"]
    if len(done) < 2:
        raise AssertionError(f"[{label}] a path needs two steps for a steady rate")
    per_step = (done[-1] - done[0]) / (len(done) - 1)
    log(f"[{label}] {summary['n_images']} images in {summary['steps']} steps, first "
        f"step {summary['first_image_s']:.3f}s, steady "
        f"{summary['steady_s_per_image']:.3f} s/image ({per_step:.3f} s/step; a "
        f"ragged last batch does a full batch's work), wall "
        f"{summary['wall_s']:.2f}s, peak memory {peak / 2**30:.2f} GiB")
    fractions = summary["mask_fractions"].values()
    mean_fraction = {key: round(float(np.mean([fr[key] for fr in fractions])), 4)
                     for key in next(iter(fractions))}
    log(f"[{label}] mask fractions, mean over the images (nonzero ones): "
        + json.dumps({k: v for k, v in mean_fraction.items() if v > 0}))
    log(f"[{label}] kernel launches {json.dumps(launches)} over {n_images} images in "
        f"{n_steps} steps, expected per step {json.dumps(expected)}")
    if (summary["n_images"] != n_images or summary["steps"] != n_steps
            or len(summary["mask_fractions"]) != n_images):
        raise AssertionError(f"[{label}] not every image was served")
    for name, count in launches.items():
        if count <= 0 or count != expected[name] * n_steps:
            raise AssertionError(f"[{label}] {count} {name} launches, expected "
                                 f"{expected[name] * n_steps}")
    for name, fr in summary["mask_fractions"].items():
        if not all(0.0 <= v <= 1.0 for v in fr.values()):
            raise AssertionError(f"[{label}] mask fractions out of range for {name}")
    return {"launches": launches, "n_images": n_images, "steps": n_steps,
            "launches_per_step": expected, "peak_bytes": peak,
            "first_image_s": summary["first_image_s"],
            "steady_s_per_image": summary["steady_s_per_image"],
            "steady_s_per_step": per_step,
            "loop_stages_ms": {k: round(v["ms_per_call"], 3)
                               for k, v in summary["loop_stages"].items()}}


def profile_path(label, device, images, model, sr_cfg, coeffs, **kw):
    """A synchronised per-stage profile of a serving path: each stage is
    bracketed by torch.cuda.synchronize, so host and card no longer overlap;
    each stage's time is its cost alone, and their sum exceeds the
    unsynchronised seconds per image."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import serve
    from deeplabv3plus_augmented_superresolution_tpu_torch.utils import StageTimer

    timer = StageTimer(sync_device=device)
    profile = serve(images, model, sr_cfg, device=device, gram_coeffs=coeffs,
                    writer_threads=2, timer=timer, **kw)
    log(f"[{label}-profile] synchronised stages, {profile['n_images']} images in "
        f"{profile['steps']} steps (a call is a step), steady "
        f"{profile['steady_s_per_image']:.3f} s/image")
    for stage, d in profile["stages"].items():
        log(f"[{label}-profile] stage {stage}: {d['ms_per_call']:.2f} ms/call"
            f" (steady {d.get('steady_ms_per_call', float('nan')):.2f}) x{d['calls']}")


def phase_serve(device, images, coeffs, sr_cfg):
    """Xception OS16, one class, aug: the CLI's default path, then a
    synchronised per-stage profile of its first images."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab)

    t0 = time.perf_counter()
    model = build_deeplab("xception", device=device)
    log(f"[serve] model built in {time.perf_counter() - t0:.1f}s "
        f"({sum(b.numel() for b in model.buffers()) / 1e6:.1f}M values)")
    class_id = most_frequent_class(model, images[0][1], device)
    expected = expected_launches(("aug",))
    if expected != {"shear_rows": 6, "shear_cols": 3}:
        raise AssertionError(f"[serve] the per-image split moved: {expected}")
    log(f"[serve] class {class_id}")
    result = serve_path("serve", device, images, model, sr_cfg, coeffs, expected,
                        class_id=class_id)

    profile_path("serve", device, images[:PROFILE_IMAGES], model, sr_cfg, coeffs,
                 class_id=class_id)
    return result, class_id, model


def phase_serve_new_paths(device, model, images, coeffs, sr_cfg, class_id, angles,
                          shifts):
    """This slice's Xception paths, one class, aug: --batch BATCH on
    BATCH_IMAGES images (a ragged last batch); --per_image_augs (each solve
    extracts its own stencil); --fast (the CLI's preset: the direct solver on
    25-copy windows, 60 steps). Each with the launches its design implies
    per step and a synchronised profile; and the full-size targets of one
    batch are finite."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        FEATURE_SIZES, make_sr_config, parse_args)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import (
        RADIUS_X, RADIUS_Y)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import asr_step

    paths = {}
    expected = expected_launches(("aug",))
    if expected != {"shear_rows": 6, "shear_cols": 3}:
        raise AssertionError(f"[serve-batch] the per-batch split moved: {expected}")
    paths["serve-batch"] = serve_path(f"serve-batch-{BATCH}", device,
                                      images[:BATCH_IMAGES], model, sr_cfg, coeffs,
                                      expected, class_id=class_id, batch=BATCH)
    profile_path(f"serve-batch-{BATCH}", device, images[:2 * BATCH], model, sr_cfg,
                 coeffs, class_id=class_id, batch=BATCH)
    out = asr_step(model, torch.stack([torch.as_tensor(img, device=device)
                                       for _, img in images[:BATCH]]),
                   angles, shifts, sr_cfg, class_id, th_factor=0.2, sr_types=("aug",),
                   gram_coeffs=coeffs, return_targets=True)
    target = out["aug_target"]
    if tuple(target.shape) != (BATCH, 512, 512, 1) or not bool(
            torch.isfinite(target).all()):
        raise AssertionError("[serve-batch] targets are not a finite "
                             f"({BATCH}, 512, 512, 1) stack")

    probes = (2 * RADIUS_Y + 1) * (RADIUS_X + 1)   # the aliased extraction's
    expected = expected_launches(("aug",), probes=probes)
    if expected != {"shear_rows": 146, "shear_cols": 73}:
        raise AssertionError(f"[serve-per-image-augs] the split moved: {expected}")
    paths["serve-per-image-augs"] = serve_path(
        "serve-per-image-augs", device, images[:PER_IMAGE_IMAGES], model, sr_cfg, None,
        expected, class_id=class_id, per_image_augs=True)
    profile_path("serve-per-image-augs", device, images[:2], model, sr_cfg, None,
                 class_id=class_id, per_image_augs=True)

    args = parse_args(["--images", "unused.jpg", "--fast"])
    fast_cfg = make_sr_config(args, num_aug=args.num_aug,
                              feature_size=FEATURE_SIZES["xception"],
                              angle_max=args.angle_max)
    log(f"[serve-fast] preset: {fast_cfg.num_iter} steps, lr "
        f"{fast_cfg.optimizer.learning_rate}, decay {fast_cfg.optimizer.decay_rate} "
        f"per {fast_cfg.optimizer.decay_steps} steps, windows of "
        f"{fast_cfg.sgd_copies} of {fast_cfg.num_aug} copies")
    expected = expected_launches(("aug",), direct_steps=fast_cfg.num_iter)
    if expected != {"shear_rows": 242, "shear_cols": 121}:
        raise AssertionError(f"[serve-fast] the per-image split moved: {expected}")
    paths["serve-fast"] = serve_path("serve-fast", device, images[:FAST_IMAGES], model,
                                     fast_cfg, None, expected, class_id=class_id)
    profile_path("serve-fast", device, images[:2], model, fast_cfg, None,
                 class_id=class_id)
    return paths


def phase_serve_multiclass(device, model, images, coeffs, sr_cfg, angles, shifts):
    """Xception OS16, all 20 classes (run_asr --class_id all --label_map
    --sr_types aug,max,mean), unchunked on every image, then in class groups
    of CLASS_CHUNK on two, each with its peak memory; and the full-size
    targets of one image are finite."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        parse_class_ids)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        asr_step_multiclass)

    class_ids = parse_class_ids("all")
    sr_types = ("aug", "max", "mean")
    kw = dict(class_id=class_ids, sr_types=sr_types, label_map=True)
    unchunked = serve_path("serve-20-classes", device, images, model, sr_cfg, coeffs,
                           expected_launches(sr_types), **kw)
    profile_path("serve-20-classes", device, images[:2], model, sr_cfg, coeffs, **kw)
    groups = -(-len(class_ids) // CLASS_CHUNK)
    chunked = serve_path(f"serve-20-classes-chunk-{CLASS_CHUNK}", device, images[:2],
                         model, sr_cfg, coeffs, expected_launches(sr_types, groups),
                         class_chunk=CLASS_CHUNK, **kw)
    out = asr_step_multiclass(model, torch.as_tensor(images[0][1], device=device),
                              angles, shifts, sr_cfg, class_ids, th_factor=0.2,
                              sr_types=sr_types, gram_coeffs=coeffs,
                              return_targets=True, return_label_map=True)
    size = tuple(sr_cfg.output_size)
    for key in ("aug_target", "max_target", "mean_target"):
        if tuple(out[key].shape) != (20, *size, 1) or not bool(
                torch.isfinite(out[key]).all()):
            raise AssertionError(f"[serve-20-classes] {key} is not a finite "
                                 f"(20, {size}, 1) stack")
    labels = set(int(v) for v in torch.unique(out["label_map"]).tolist())
    if tuple(out["label_map"].shape) != (*size, 1) or not labels <= {0, *class_ids}:
        raise AssertionError(f"[serve-20-classes] label map labels {labels}")
    log(f"[serve-20-classes] label map holds {sorted(labels)}; aug target range "
        f"[{float(out['aug_target'].min()):.4f}, {float(out['aug_target'].max()):.4f}]")
    return unchunked, chunked


def phase_serve_mobilenet(device, images, coeffs, sr_cfg):
    """MobileNetV2 OS8 (feature 64, its own stencil), one class, aug + max +
    mean (run_asr --backbone mobilenet --sr_types aug,max,mean)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab)

    model = build_deeplab("mobilenet", device=device)
    class_id = most_frequent_class(model, images[0][1], device)
    sr_types = ("aug", "max", "mean")
    expected = expected_launches(sr_types)
    if expected != {"shear_rows": 8, "shear_cols": 4}:
        raise AssertionError(f"[serve-mobilenet] the per-image split moved: {expected}")
    log(f"[serve-mobilenet] class {class_id}")
    result = serve_path("serve-mobilenet", device, images, model, sr_cfg, coeffs,
                        expected, class_id=class_id, sr_types=sr_types)
    profile_path("serve-mobilenet", device, images[:2], model, sr_cfg, coeffs,
                 class_id=class_id, sr_types=sr_types)
    return result


TRAIN_DIR = "build/chip_smoke_train"


def train_args(size: int, steps: int, *extra: str):
    """cli.train's arguments for a timed run at ``size``: the CLI's defaults
    (Xception, bf16, adam 1e-3, batch 8) on the card."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.train import parse_args

    return parse_args([
        "--size", str(size), "--steps", str(steps), "--log_every", str(TRAIN_CHUNK),
        "--batch", str(TRAIN_BATCH), "--train_set", str(TRAIN_SET[size]),
        "--eval_images", str(TRAIN_EVAL_IMAGES[size]), "--save_params", "",
        "--device", "cuda", *extra])


def train_path(label, device, args, warp: bool):
    """One training run as a user runs it (cli.train's ``train``): no
    synchronisation inside a chunk, the chunk's losses fetched at its end.
    The launch counts are set to 0 just before and read just after: 4
    shear_rows + 2 shear_cols a step with --warp_augment (the images' warp
    and the labels'), none without. Steady s/step over the steps after the
    first chunk; peak memory is this run's own."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.train import train
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary, timing = train(args)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    (first_done, first_t), (last_done, last_t) = timing["chunk_ends"][0], \
        timing["chunk_ends"][-1]
    per_step = (last_t - first_t) / (last_done - first_done)
    losses = summary["losses"]
    steps = summary["total_steps"] - summary["start_step"]
    expected = {name: (2 * WARP_LAUNCHES[name] if warp else 0) for name in counters}
    log(f"[{label}] {args.backbone} {args.size} px, batch {args.batch}, "
        f"{args.compute_dtype}, remat {args.remat}: {steps} steps, first step "
        f"{timing['first_step_s']:.3f}s, steady {per_step:.4f} s/step "
        f"({args.batch / per_step:.1f} images/s) over steps {first_done + 1}-{last_done}, "
        f"peak memory {peak / 2**30:.2f} GiB, loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}, held-out mIoU {summary['held_out_miou']:.4f}")
    log(f"[{label}] kernel launches {json.dumps(launches)} over {steps} steps, "
        f"expected per step {json.dumps(expected)}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[{label}] losses not finite: {losses}")
    if not np.mean(losses[-TRAIN_CHUNK:]) < np.mean(losses[:TRAIN_CHUNK]):
        raise AssertionError(f"[{label}] the loss did not fall: {losses}")
    for name, count in launches.items():
        if count != expected[name] * steps:
            raise AssertionError(f"[{label}] {count} {name} launches, expected "
                                 f"{expected[name] * steps}")
    return {"launches": launches, "steps": steps, "launches_per_step": expected,
            "peak_bytes": peak, "first_step_s": timing["first_step_s"],
            "steady_s_per_step": per_step, "images_per_s": args.batch / per_step,
            "loss_first": losses[0], "loss_last": losses[-1],
            "held_out_miou": summary["held_out_miou"]}


KERNEL_GROUPS = (("shear kernels", ("shear_",)),
                 ("depthwise convolutions", ("conv_depthwise",)),
                 ("dense convolutions and matmuls",
                  ("xmma", "cudnn", "cutlass", "gemm", "conv", "nhwc", "nchw")),
                 ("reductions (BN statistics, loss, norms)", ("reduce_kernel",)),
                 ("elementwise", ("elementwise", "index", "copy", "fill", "cat")))


def kernel_group(name: str) -> str:
    lowered = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(key in lowered for key in keys):
            return group
    return "other"


def profile_train_step(label, device, args, steady_s_per_step: float):
    """A torch.profiler window over PROFILE_STEPS train steps of ``args``'s
    configuration (after two warm-up steps): the device time a step, by
    kernel group, and the idle share against the unprofiled run's steady
    step (the profiler's own host cost would inflate a profiled step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, init_params, params_from_jax)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import DeepLab
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.optim import (
        make_optimizer)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.train import (
        MasterParams, make_train_step)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        warp_augment_batch)

    cfg = DeepLabConfig(input_shape=(args.size, args.size, 3), weights=None,
                        final_upsample=True, compute_dtype=args.compute_dtype)
    master = MasterParams(params_from_jax(init_params(cfg, seed=args.seed)), device)
    tx = make_optimizer(args)
    opt_state = tx.init(master)
    step = make_train_step(DeepLab(cfg, device="meta"), tx, remat=args.remat,
                           skip_nonfinite=args.skip_nonfinite)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    images = torch.rand((args.batch, args.size, args.size, 3), generator=gen,
                        device=device)
    labels = torch.randint(0, 21, (args.batch, args.size, args.size), generator=gen,
                           device=device, dtype=torch.uint8)

    def one_step():
        im, lb = images, labels
        if args.warp_augment:
            im, lb = warp_augment_batch(gen, im, lb, args.warp_angle_max,
                                        80.0 * args.size / 512)
        return step(master, opt_state, im, lb)[2]

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            loss = one_step()
        float(loss)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        raise AssertionError(f"[{label}-profile] no device activity traced")
    groups = {}
    for e in on_card:
        group = kernel_group(e.name)
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILE_STEPS
    busy = sum(groups.values())
    idle = max(0.0, 1.0 - busy / (steady_s_per_step * 1e3))
    log(f"[{label}-profile] device busy {busy:.1f} ms a step "
        f"({len(on_card) / PROFILE_STEPS:.0f} device activities), idle share "
        f"{idle:.1%} of the unprofiled {steady_s_per_step * 1e3:.1f} ms step; by kernel "
        "group (ms a step): " + "; ".join(
            f"{group} {ms:.2f}" for group, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    return {"device_ms_per_step": busy, "idle_share": idle,
            "device_activities_per_step": len(on_card) / PROFILE_STEPS,
            "device_ms_by_group": groups}


def phase_train(device, images, coeffs, sr_cfg):
    """cli.train at full width: the CLI's default (128 px), 512 px with
    --warp_augment, the same with --remat; then the warp run's checkpoint
    resumed for a step and its saved params served (train, then serve)."""
    import os
    import shutil

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab, serve)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.train import train
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ckpt_dir = os.path.join(TRAIN_DIR, "ckpt")
    saved = os.path.join(TRAIN_DIR, "trained_params.npz")
    paths = {}
    args = train_args(128, TRAIN_STEPS)
    paths["train"] = train_path("train", device, args, warp=False)
    paths["train"].update(profile_train_step(
        "train", device, args, paths["train"]["steady_s_per_step"]))
    args = train_args(512, TRAIN_STEPS, "--warp_augment", "--ckpt_dir", ckpt_dir,
                      "--ckpt_every", str(TRAIN_STEPS), "--save_params", saved)
    paths["train-warp-512"] = train_path("train-warp-512", device, args, warp=True)
    paths["train-warp-512"].update(profile_train_step(
        "train-warp-512", device, args, paths["train-warp-512"]["steady_s_per_step"]))
    args = train_args(512, REMAT_STEPS, "--warp_augment", "--remat")
    paths["train-remat-512"] = train_path("train-remat-512", device, args, warp=True)
    log(f"[train-remat-512] peak {paths['train-remat-512']['peak_bytes'] / 2**30:.2f} GiB "
        f"with --remat against {paths['train-warp-512']['peak_bytes'] / 2**30:.2f} GiB "
        f"without; {paths['train-remat-512']['steady_s_per_step']:.4f} against "
        f"{paths['train-warp-512']['steady_s_per_step']:.4f} s/step")

    # Train, then serve: resume one step from the warp run's checkpoint, then
    # serve an image with its saved params, as run_asr --weights_path does.
    counters = launch_counters()
    for counter in counters.values():
        counter.launches = 0
    resumed, _ = train(train_args(512, 1, "--warp_augment", "--resume",
                                  os.path.join(ckpt_dir, f"step_{TRAIN_STEPS}.npz")))
    if (resumed["start_step"], resumed["total_steps"]) != (TRAIN_STEPS, TRAIN_STEPS + 1) \
            or not np.isfinite(resumed["loss_final"]):
        raise AssertionError(f"[train-then-serve] resume went wrong: {resumed}")
    model = build_deeplab("xception", weights_path=saved, device=device)
    summary = serve(images[:1], model, sr_cfg, device=device, gram_coeffs=coeffs,
                    class_id=8, writer_threads=0)
    launches = {name: counter.launches for name, counter in counters.items()}
    fractions = next(iter(summary["mask_fractions"].values()))
    per_image = expected_launches(("aug",))
    expected = {name: 2 * WARP_LAUNCHES[name] + per_image[name] for name in counters}
    log(f"[train-then-serve] resumed at step {resumed['start_step']} for one step "
        f"(loss {resumed['loss_final']:.4f}); served {summary['n_images']} image with "
        f"the saved params: mask fractions {json.dumps(fractions)}; launches "
        f"{json.dumps(launches)} (one train step with the warp, then one image)")
    if summary["n_images"] != 1 or not all(0.0 <= v <= 1.0 for v in fractions.values()):
        raise AssertionError("[train-then-serve] the trained params did not serve")
    if launches != expected:
        raise AssertionError(f"[train-then-serve] launches {launches}, expected {expected}")
    paths["train-then-serve"] = {"launches": launches, "resumed_loss": resumed["loss_final"]}
    del model
    torch.cuda.empty_cache()
    return paths


def phase_train_small(device):
    """One train step of MobileNetV2 (alpha 0.35, 32 px, f32, sgd with
    Nesterov momentum, the non-finite guard on) and warp_augment_batch with
    given draws, on the card against the same calls on the CPU."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, init_params, params_from_jax)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import DeepLab
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.optim import (
        Schedule, TrainOptimizer)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.train import (
        MasterParams, make_train_step)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models.weights import (
        to_reference_layout)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        warp_augment_batch_with_draws)

    cfg = DeepLabConfig(input_shape=(32, 32, 3), backbone="mobilenet", alpha=0.35,
                        weights=None, final_upsample=True, compute_dtype="float32")
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 21, (2, 32, 32)).astype(np.int32)
    labels[:, :3] = 255
    draws = (rng.uniform(-0.15, 0.15, 2).astype(np.float32),
             rng.uniform(-5, 5, (2, 2)).astype(np.float32), np.array([1.0, 0.0], np.float32))
    start = init_params(cfg, seed=0)
    rng = np.random.default_rng(7)
    for entry in start.values():
        if "gamma" in entry:
            n = entry["gamma"].shape
            entry["gamma"] = rng.uniform(0.25, 0.5, n).astype(np.float32)
            entry["beta"] = (rng.choice([-1.0, 1.0], n)
                             * rng.uniform(1.0, 2.0, n)).astype(np.float32)
    outs = {}
    for dev in (torch.device("cpu"), device):
        master = MasterParams(params_from_jax(start), dev)
        tx = TrainOptimizer("sgd", Schedule("constant", TRAIN_CHECK_LR), momentum=0.9)
        step = make_train_step(DeepLab(cfg, device="meta"), tx, skip_nonfinite=True)
        _, opt_state, loss = step(master, tx.init(master), torch.as_tensor(images, device=dev),
                                  torch.as_tensor(labels, device=dev))
        trace = {(layer, name): to_reference_layout(name, view.numpy()) for (layer, name), view
                 in zip(master.keys, master.leaves(opt_state.tensors["trace"].cpu()))}
        img, lab = warp_augment_batch_with_draws(
            torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev),
            *(torch.as_tensor(d, device=dev) for d in draws))
        outs[dev.type] = (float(loss), master.numpy_params(), trace, img.cpu(), lab.cpu())
    (l_cpu, p_cpu, t_cpu, i_cpu, b_cpu), (l_gpu, p_gpu, t_gpu, i_gpu, b_gpu) = (
        outs["cpu"], outs["cuda"])
    scale = max(float(np.abs(g).max()) for g in t_cpu.values())
    worst_param, worst_stat, worst_grad, worst_leaf, failed = 0.0, 0.0, 0.0, "", []
    for layer, entry in p_cpu.items():
        for name, want in entry.items():
            err = float(np.abs(p_gpu[layer][name] - want).max())
            if name.startswith("moving"):
                worst_stat = max(worst_stat, err)
                if err > 1e-5 + 1e-5 * np.abs(want).max():
                    failed.append(f"{layer}/{name} {err:.3g}")
                continue
            worst_param = max(worst_param, err)
            g = t_cpu[layer, name]
            share = float(np.abs(t_gpu[layer, name] - g).max()
                          / (1e-2 * np.abs(g).max() + 1e-4 * scale))
            if share > worst_grad:
                worst_grad, worst_leaf = share, f"{layer}/{name}"
            if err > 1e-6 or share > 1:
                failed.append(f"{layer}/{name} param {err:.3g}, gradient {share:.2f} of its bound")
    img_err = float((i_gpu - i_cpu).abs().max())
    log(f"[train-small] MobileNetV2 32 px f32 train step, card vs CPU: loss {l_gpu:.7f} "
        f"vs {l_cpu:.7f}, parameters max err {worst_param:.3g}, the gradient's worst leaf "
        f"{worst_leaf} at {worst_grad:.3f} of its bound, moving statistics max err "
        f"{worst_stat:.3g}; warp_augment_batch images max err {img_err:.3g}, labels equal "
        f"{bool(torch.equal(b_gpu, b_cpu))}")
    if (failed or abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu) or img_err > ATOL_F32
            or not torch.equal(b_gpu, b_cpu)):
        raise AssertionError(f"[train-small] card and CPU disagree: {failed[:5]}")


def check_target(model, device, image, class_id, coeffs, sr_cfg, angles, shifts):
    """The continuous SR target of one full-size image is finite, (512, 512, 1)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import asr_step

    out = asr_step(model, torch.as_tensor(image, device=device), angles, shifts,
                   sr_cfg, class_id, th_factor=0.2, sr_types=("aug",),
                   gram_coeffs=coeffs, return_targets=True)
    target = out["aug_target"]
    if tuple(target.shape) != (512, 512, 1) or not bool(torch.isfinite(target).all()):
        raise AssertionError("[serve] SR target is not a finite (512, 512, 1) map")
    log(f"[serve] target range [{float(target.min()):.4f}, {float(target.max()):.4f}]")


def main() -> None:
    parser = argparse.ArgumentParser(description="On-card smoke run of the port.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--images", type=int, default=6,
                        help="images of the one-class Xception serving path")
    parser.add_argument("--stage-trace", action="store_true",
                        help="also trace the warp and b stages with torch.profiler")
    parser.add_argument("--package-root", default="",
                        help="with --kernels-only: a directory that holds another "
                             "checkout's port package, whose kernels are timed "
                             "instead (before and after in one call); that package "
                             "must have both kernels and "
                             "ops.shear_warp.paeth_coefficients / inverse_shifts")
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
        FEATURE_SIZES, SEED, make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        sample_augmentations)

    device = phase_device()
    t_start = time.perf_counter()
    phase_build()
    sr_cfg = make_sr_config(None, num_aug=100, feature_size=FEATURE_SIZES["xception"],
                            angle_max=0.15)
    mob_sr_cfg = make_sr_config(None, num_aug=100,
                                feature_size=FEATURE_SIZES["mobilenet"], angle_max=0.15)
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED), 100,
                                          0.15, 80.0, device=device)
    if args.kernels_only:
        phase_kernel(device, angles, shifts)
        return
    coeffs = phase_stencil(device, angles, shifts, sr_cfg, "Xception")
    mob_coeffs = phase_stencil(device, angles, shifts, mob_sr_cfg, "MobileNetV2")
    # The serving paths come before the kernel cases and the CPU references,
    # so that no earlier phase's load is on the card or the host when they run.
    images = make_images(args.seed, max(args.images, MULTI_IMAGES, MOBILENET_IMAGES,
                                        BATCH_IMAGES, PER_IMAGE_IMAGES, FAST_IMAGES))
    paths = {}
    paths["serve"], class_id, model = phase_serve(device, images[:args.images],
                                                  coeffs, sr_cfg)
    check_target(model, device, images[0][1], class_id, coeffs, sr_cfg, angles, shifts)
    paths.update(phase_serve_new_paths(device, model, images, coeffs, sr_cfg, class_id,
                                       angles, shifts))
    paths["serve-20-classes"], paths["serve-20-classes-chunked"] = phase_serve_multiclass(
        device, model, images[:MULTI_IMAGES], coeffs, sr_cfg, angles, shifts)
    if args.stage_trace:
        phase_stage_trace(device, images, model, sr_cfg, class_id, coeffs)
    del model
    torch.cuda.empty_cache()
    paths["serve-mobilenet"] = phase_serve_mobilenet(
        device, images[:MOBILENET_IMAGES], mob_coeffs, mob_sr_cfg)
    paths.update(phase_train(device, images, coeffs, sr_cfg))
    kernel_results = phase_kernel(device, angles, shifts)
    phase_small_e2e(device)
    phase_train_small(device)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")

    entries = []
    for name, source in KERNELS.items():
        cases = [r for r in kernel_results if r["kernel"] == name]
        (main_case,) = [r for r in cases if r["primary"]]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {label: p["launches"][name] for label, p in paths.items()},
            "max_abs_err": max(max(r["fwd_err"], r["bwd_err"]) for r in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "ms_case": main_case["case"],
            "per_case": cases})
    log("[done] serving and training paths " + json.dumps(
        {label: {k: v for k, v in p.items() if k != "launches"}
         for label, p in paths.items()}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
