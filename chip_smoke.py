"""On-card smoke run of the PyTorch/CUDA port: its serving, training and
evaluation paths.

    python3 chip_smoke.py [--seed 0] [--images 6] [--stage-trace]
    python3 chip_smoke.py --kernels-only [--package-root DIR]
    python3 chip_smoke.py --sharded-only
    python3 chip_smoke.py --quality-only

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
     steps, the operator forward and backward in every step). Then the
     gather warp and the staged operator (one class, aug + max + mean,
     each stencil first checked as in 3): ``serve-staged``
     (--operator_impl staged), ``serve-staged-per-image-augs``,
     ``serve-gather`` (--warp_impl gather: no kernel launch) and
     ``solve-staged-bf16`` (the direct solver on the staged operator in
     bf16, a library configuration), each with its masks' IoU against the
     fused path on the first image and its targets finite. With
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
     through ``cli.run_asr.serve`` (``--weights_path``). Then
     ``[train-voc]``: ``--data voc --augment --warp_augment`` at 512 px for
     three chunks, on a VOC-shaped root whose dataset is handed its
     synthetic scenes decoded (half at 512 px, half at 375 x 500; the card's
     machine cannot decode JPEG, so file decoding is outside the phase):
     shuffled epochs, the host's random_transform and resize, the prefetch
     thread, the warp (4 + 2 launches a step, asserted) and the step, with
     the share of the steady window the loop waited on the prefetch queue,
     and the host pipeline's seconds a batch alone;
  6. the evaluation workflow at full width (Xception OS16, bf16, 512 px,
     100 copies, 300 AMSGrad steps, random weights from seed 0) on
     synthetic scenes holding class 8, each path with its launches (counted
     from 0 for it) and peak memory: ``[staged]``, generate_augmented_copies'
     core on EVAL_IMAGES scenes in every OPM mode with one shared set, the
     forward in one batch and in chunks of EVAL_CHUNK copies, held against
     each other; ``[standard]``, generate_standard_output's core (the full
     model, x4 upsample); ``[sr-eval]``, SR_single_class's core over the
     staged stacks (load_sr_data's normalization, the shared set's stencil
     extracted once, aug/max/mean and six IoUs), then ``[threshold]``,
     threshold_tests' core (one solve, 17 thresholds); ``[robustness]``,
     check_robustness' core on ROBUST_IMAGES scenes in one batch over 27
     combinations, its nearest-warped labels held bit for bit against the
     plain path's;
     then ``[sharded]`` (parallel/): the ranks are processes that share card
     0 through gloo groups (NCCL takes one rank a card; the machine may
     show one): ``serve-sharded-aug3`` (``serve`` with --batch 2 on a (1, 3)
     mesh, 100 copies padded to 102, the padded stencil checked first) and
     ``serve-sharded-data2-aug2`` (a (2, 2) mesh), each rank's launches per
     step asserted equal to one card's, the masks' IoU against the
     one-process path, its peak; ``train-sharded`` (2 ranks, cli.train's
     ``train`` at 128 px in f32) and ``train-voc-sharded`` (the same with
     ``--data voc --augment``) against the one-process runs; a world-1 NCCL
     group's ``make_asr_batch_fn`` step bit for bit against the one-process
     step; with two cards, ``serve-sharded-aug2-nccl``;
  7. each kernel vs its plain version at the serving paths' shapes and
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
     The staged operator's full-resolution passes on one target plane
     (stride 0 over the copies), f32 and bf16, are there, and the
     training layouts too: a batch of 8 images (3 planes each,
     its own shifts) and of 8 label maps (integer shifts: the nearest mode,
     held exactly), at 128 and 512 px; and the robustness grid's: 16 images
     of 3 planes and 16 label maps sharing one combination's shifts;
  8. small-input end-to-end checks, each on the card against the same call
     on the CPU (the plain versions): ``asr_step`` with aug, max and mean;
     ``asr_step_multiclass`` of 3 classes with the label map, unchunked and
     in class groups of 2, and of a batch of 2 images; MobileNetV2;
     ``asr_step`` with the IRLS-CG solver and with the direct solver on
     copy minibatches; the staged (f32, bf16) and gather operators'
     forward and adjoint; one train step of MobileNetV2 (alpha 0.35, 32 px,
     f32) and ``warp_augment_batch`` with given draws; the evaluation
     cores (staging in every mode, standard masks, score_image,
     threshold_ious, robustness_grid) at 64 px;
  9. ``[quality]``, the quality-evidence scripts (``scripts/``) with trained
     weights: quality_demo's ``run_demo`` trains Xception OS16 bf16 at 512 px
     with --warp_augment (QUALITY_TRAIN_STEPS steps), then serves 20
     held-out scenes through the full path (100 copies, each scene its own
     set, 300 AMSGrad steps, aug / max / mean / standard), its launches
     asserted per training chunk and per scene, its IoUs printed beside the
     JAX package's committed ones and the standard arm's held to
     QUALITY_MIN_STANDARD_IOU; then label_map_eval on those params,
     ab_stats, per_class_validation (20 classes), ab_cg_vs_adam and
     ab_serving_vs_strict, each at a smaller depth with its headline.

Before any of it, a line says whether the native decode ring
(``data/native_loader.py``, host decode) builds on this machine; the script
serves decoded arrays and needs no ring.

The serving, training and evaluation paths run before the kernel cases and
the CPU checks, in that order, so that no phase leaves load on the card or
the host while a path is timed.
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
# The evaluation workflow (the reference's staged runs) on synthetic scenes
# with class 8 in each: EVAL_IMAGES staged in every OPM mode, with the
# forward in one batch and in chunks of EVAL_CHUNK copies; the robustness
# grid's ROBUST_IMAGES images (one batch, the CLI's default) over
# ROBUST_ANGLES x ROBUST_SHIFTS^2 = 27 combinations.
EVAL_CLASS = 8
EVAL_SIZE = 512
EVAL_NUM_AUG = 100
EVAL_IMAGES = 4
EVAL_MODES = ("argmax", "slice", "slice_max")
EVAL_CHUNK = 25
ROBUST_IMAGES = 16
ROBUST_ANGLES = (-0.35, 0.0, 0.35)
ROBUST_SHIFTS = (-80.0, 0.0, 80.0)
# A forward in chunks of copies against one forward of all: bf16 rounds each
# layer and cuDNN may pick other algorithms for the smaller batch, so argmax
# masks must agree on >= E2E_MASK_AGREE of pixels and continuous stacks
# within BF16_STACK_RTOL of their largest magnitude (the bf16 forward's bound
# in tests/test_torch_model.py and tests/test_torch_mobilenet.py).
BF16_STACK_RTOL = 0.05
# Card vs CPU, the evaluation cores at 64 px in f32: IoUs to 1e-3, raw logit
# stacks to 1e-2 of their scale (random-init logits are ~1e-6).
EVAL_IOU_ATOL = 1e-3
# This slice's full-width paths (the staged operator, the gather warp, the
# bf16 solve), one class, aug + max + mean, and the images of each.
SLICE_SR_TYPES = ("aug", "max", "mean")
STAGED_IMAGES = 3
STAGED_PER_IMAGE_IMAGES = 2
GATHER_IMAGES = 3
BF16_SOLVE_IMAGES = 3
# A path's masks against the fused/shear path's on the same image: the
# operators differ at the interpolation level (staged vs fused decimation,
# two-pass gathers vs shears, a bf16 warp, the direct solver vs the stencil,
# which follow the same trajectory in exact arithmetic), so the masks
# overlap; a wrong warp (a transposed or inverted transform) would not.
SLICE_MIN_IOU = 0.5
# The staged and gather operators at 64 px, card vs CPU: the forward A x
# within the bound below, the adjoint A^T y (cotangent in [0, 1]) within it
# times the copies. Shear f32: the kernel is within 1e-5 of the plain version
# per pass, three passes, plus the resize matmul's f32 sums (TF32 off). Shear
# bf16: each of the three passes may round one bf16 ulp (2 ** -8 below 1)
# apart. Gather: the same IEEE operations on both, but cos and sin differ by
# an f32 ulp on the card, which moves sample points by ~1e-5 px.
OPERATOR_SMALL_ATOL = {"staged shear f32": 5e-5, "staged shear bf16": 3 * 2.0 ** -8,
                       "gather": 5e-5}
# The [sharded] phase (parallel/): its global batch and images (two
# batches), the serving runs (label, ranks, (data, aug) mesh), the masks'
# IoU bound against the one-process path (each rank's cuDNN forward runs a
# block of 34 or 50 copies and may pick other algorithms than for 100, so the
# bf16 logits, hence the masks, need not be equal bit for bit), and the
# training run's ranks, steps and compute dtype: the `train` configuration
# (Xception, 128 px, batch 8) in float32, TF32 off, as the card-vs-CPU step
# check (`[train-small]`) runs; in bfloat16 the two runs' losses differ by
# 2.2e-4 relative after 3 steps (a rank's 4-sample convolutions and the
# synchronised statistics round otherwise than the 8-sample run's), past
# that check's 1e-5.
SHARDED_BATCH = 2
SHARDED_IMAGES = 4
SHARDED_SERVE_RUNS = (("serve-sharded-aug3", 3, (1, 3)),
                      ("serve-sharded-data2-aug2", 4, (2, 2)))
SHARDED_MIN_IOU = 0.98
SHARDED_TRAIN_RANKS = 2
SHARDED_TRAIN_STEPS = 3
SHARDED_TRAIN_DTYPE = "float32"
# The sharded training runs' start: every BN's gamma from U(0.25, 0.5) as in
# `[train-small]`, and beta from +-U(2, 4), so that a ReLU input sits at 0
# only 4 to 16 batch standard deviations from its channel's mean. The
# ranks' statistics and convolutions round otherwise than the one-process
# run's, so a ReLU input within rounding of 0 can take the other side, and
# one such flip moves a leaf's whole gradient through its BatchNorm's
# backward. With `[train-small]`'s +-U(1, 2), the VOC run's augmented
# scenes left such an input in decoder_conv0's pointwise BN output, and
# the ranks' trace in decoder_conv0_pointwise.kernel read 0.66 of its bound
# in one run on the card and 1.17 in the next. So each one-process run is
# made twice and held against itself first, with the same bounds: a check
# whose reference does not reproduce itself stops there (`--sharded-beta`
# sets the range for such a probe).
SHARDED_BETA_RANGE = (2.0, 4.0)
# The [train-voc] phase (cli.train --data voc at full width): its synthetic
# scenes, handed over decoded (the card's machine has no JPEG decoder),
# every other one at VOC's common 375 x 500 so that the dataset's resize to
# 512 runs too; 3 chunks of TRAIN_CHUNK steps; and the batches of the host
# pipeline timed alone after the run. The [sharded] phase's VOC run: its
# scenes at 128 px (every other one at 96 x 128), an epoch of 2 batches.
VOC_SCENES = 32
VOC_OFF_SIZE = (375, 500)
VOC_STEPS = 3 * TRAIN_CHUNK
VOC_HOST_BATCHES = 4
SHARDED_VOC_SCENES = 16
SHARDED_VOC_OFF_SIZE = (96, 128)
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
    robustness_cases = _robustness_kernel_cases(device, paeth_coefficients, pass_shifts)
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
        # the staged operator: all three passes at full resolution on one
        # target plane read by every copy, f32 and (solve_dtype bf16) bf16;
        # the dense x pass is also pass 1's backward
        ("staged pass 1 (100,1,512,512) f32 from one stride-0 plane", "shear_rows",
         (100, 1, 512, 512), f32, s_a, "stride0", False, False),
        ("staged pass 1 (100,1,512,512) bf16 from one stride-0 plane", "shear_rows",
         (100, 1, 512, 512), bf16, s_a, "stride0", False, False),
        ("staged pass 3 and pass 1 backward (100,1,512,512) f32", "shear_rows",
         (100, 1, 512, 512), f32, s_c3, "dense", False, False),
        ("staged pass 3 and pass 1 backward (100,1,512,512) bf16", "shear_rows",
         (100, 1, 512, 512), bf16, s_c3, "dense", False, False),
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
        ("staged y pass (100,1,512,512) f32", "shear_cols", (100, 1, 512, 512), f32, s_b,
         "dense", False, False),
        ("staged y pass (100,1,512,512) bf16", "shear_cols", (100, 1, 512, 512), bf16, s_b,
         "dense", False, False),
        ("edge probe +-240 (2,512,128) f32", "shear_cols", (2, 512, 128), f32, probe,
         "dense", False, False),
        ("edge probe +-240 (2,3,512,128) bf16", "shear_cols", (2, 3, 512, 128), bf16,
         probe, "dense", False, False),
    ] + train_cases + robustness_cases


def _robustness_kernel_cases(device, paeth_coefficients, pass_shifts):
    """check_robustness' layouts: ROBUST_IMAGES different images of 3 planes
    and their label maps of 1 plane, the whole batch sharing one
    combination's angle and shift (the grid's corner); labels with the
    nearest mode's integer shifts."""
    n = ROBUST_IMAGES
    angles = torch.full((n,), ROBUST_ANGLES[-1], device=device)
    shifts = torch.tensor([ROBUST_SHIFTS[-1], ROBUST_SHIFTS[0]], device=device).expand(n, 2)
    a, off_a, b, off_b, _ = paeth_coefficients(angles, shifts, 512, 512)
    cases = []
    for planes, mode in ((3, "bilinear"), (1, "nearest")):
        what = "images" if planes == 3 else "labels, nearest"
        shape = (n, planes, 512, 512)
        exact = mode == "nearest"
        cases.append((f"robustness warp x pass, {what} {shape} f32", "shear_rows", shape,
                      torch.float32, pass_shifts(a, off_a, 255.5, 512, mode), "dense",
                      False, exact))
        cases.append((f"robustness warp y pass, {what} {shape} f32", "shear_cols", shape,
                      torch.float32, pass_shifts(b, off_b, 255.5, 512, mode), "dense",
                      False, exact))
    return cases


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
    K does not count; groups = ceil(K / class_chunk), 1 when unchunked. The
    staged operator launches the fused one's three passes (at full
    resolution); the gather warp launches none."""
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
        if count != expected[name] * n_steps:
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
        make_sr_config, parse_args)
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
    fast_cfg = make_sr_config(args, num_aug=args.num_aug, angle_max=args.angle_max)
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


def _iou(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a > 0, b > 0
    union = int((a | b).sum())
    return 1.0 if union == 0 else int((a & b).sum()) / union


def phase_serve_staged_gather(device, model, images, coeffs, sr_cfg, class_id,
                              angles, shifts):
    """This slice's paths at full width (Xception OS16, bf16, 512 px, 100
    copies, 300 AMSGrad steps, one class, aug + max + mean), each through
    ``run_asr.serve`` with its launches asserted per image:
    ``serve-staged`` (--operator_impl staged: the shear warp at full
    resolution, then the resize; its stencil extracted once through it),
    ``serve-staged-per-image-augs`` (each image extracts its own: 35 probes
    of the staged operator), ``serve-gather`` (--warp_impl gather: the
    copies, the operator and the inverse warp by gathers, no kernel
    launch) and ``solve-staged-bf16`` (the direct solver on the staged
    operator warping in bf16: a library configuration, as no CLI sets
    solve_dtype), each followed by a synchronised profile of two images.
    Then each path's masks on the first image against the fused/shear
    path's (IoU, on the image's own set for per_image_augs) and its
    continuous targets finite."""
    import dataclasses

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import SEED
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import (
        RADIUS_X, RADIUS_Y)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        asr_step, sample_augmentations)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.augment import (
        image_generator)

    staged = dataclasses.replace(sr_cfg, operator_impl="staged")
    gather = dataclasses.replace(sr_cfg, warp_impl="gather")
    bf16 = dataclasses.replace(staged, solve_dtype="bfloat16", solver_impl="direct")
    staged_coeffs = phase_stencil(device, angles, shifts, staged, "Xception staged")
    gather_coeffs = phase_stencil(device, angles, shifts, gather, "Xception gather")
    probes = (2 * RADIUS_Y + 1) * (RADIUS_X + 1)
    runs = {
        "serve-staged": (staged, staged_coeffs, STAGED_IMAGES, {},
                         expected_launches(SLICE_SR_TYPES),
                         {"shear_rows": 8, "shear_cols": 4}),
        "serve-staged-per-image-augs": (
            staged, None, STAGED_PER_IMAGE_IMAGES, {"per_image_augs": True},
            expected_launches(SLICE_SR_TYPES, probes=probes),
            {"shear_rows": 148, "shear_cols": 74}),
        "serve-gather": (gather, gather_coeffs, GATHER_IMAGES, {},
                         {name: 0 for name in KERNELS},
                         {"shear_rows": 0, "shear_cols": 0}),
        "solve-staged-bf16": (bf16, None, BF16_SOLVE_IMAGES, {},
                              expected_launches(SLICE_SR_TYPES,
                                                direct_steps=bf16.num_iter),
                              {"shear_rows": 1204, "shear_cols": 602}),
    }
    paths = {}
    for label, (cfg, stencil, n, kw, expected, design) in runs.items():
        if expected != design:
            raise AssertionError(f"[{label}] the per-image split moved: {expected}")
        paths[label] = serve_path(label, device, images[:n], model, cfg, stencil,
                                  expected, class_id=class_id, sr_types=SLICE_SR_TYPES,
                                  **kw)
        profile_path(label, device, images[:2], model, cfg, stencil, class_id=class_id,
                     sr_types=SLICE_SR_TYPES, **kw)

    name, image = images[0]
    image = torch.as_tensor(image, device=device)
    own = sample_augmentations(image_generator(SEED, name), sr_cfg.num_aug, 0.15, 80.0,
                               device=device)

    def step(cfg, stencil, tta):
        out = asr_step(model, image, *tta, cfg, class_id, th_factor=0.2,
                       sr_types=SLICE_SR_TYPES, gram_coeffs=stencil, return_targets=True)
        for key in SLICE_SR_TYPES:
            target = out[f"{key}_target"]
            shape = (*cfg.output_size, 1)
            if tuple(target.shape) != shape or not bool(torch.isfinite(target).all()):
                raise AssertionError(f"[{cfg.operator_impl}/{cfg.warp_impl}] {key} target "
                                     f"is not a finite {shape} map")
        return out

    shared = (angles, shifts)
    fused = {"shared": step(sr_cfg, coeffs, shared), "own": step(sr_cfg, None, own)}
    for label, (cfg, stencil, _, kw, _, _) in runs.items():
        tta = "own" if kw.get("per_image_augs") else "shared"
        out = step(cfg, stencil if tta == "shared" else None,
                   own if tta == "own" else shared)
        ious = {key: _iou(out[key], fused[tta][key]) for key in SLICE_SR_TYPES}
        fractions = {key: round(float((out[key] > 0).float().mean()), 4)
                     for key in SLICE_SR_TYPES}
        log(f"[{label}] {name}: IoU against the fused/shear path "
            f"{json.dumps({k: round(v, 4) for k, v in ious.items()})} (bound "
            f"{SLICE_MIN_IOU}), mask fractions {json.dumps(fractions)}, targets finite")
        if min(ious.values()) < SLICE_MIN_IOU:
            raise AssertionError(f"[{label}] masks differ from the fused/shear path's")
        paths[label]["iou_vs_fused"] = ious
    return paths


def phase_operator_small(device):
    """The staged operator (shear f32, shear bf16) and the gather operator on
    the card against the same calls on the CPU (the plain versions), at 64
    px: 4 copies, 2 target planes, the forward A x and the adjoint A^T y
    through autograd, within OPERATOR_SMALL_ATOL (the adjoint times the
    copies)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        sample_augmentations)
    from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
        SRConfig, forward_operator)

    rng = np.random.default_rng(11)
    planes = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64)).astype(np.float32))
    cot = torch.from_numpy(rng.uniform(0, 1, (4, 16, 16, 2)).astype(np.float32))
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(4), 4, 0.3, 8.0,
                                          device="cpu")
    configs = {"staged shear f32": dict(operator_impl="staged"),
               "staged shear bf16": dict(operator_impl="staged", solve_dtype="bfloat16"),
               "gather": dict(warp_impl="gather")}
    for label, kw in configs.items():
        cfg = SRConfig(num_aug=4, feature_size=(16, 16), output_size=(64, 64), **kw)
        results = []
        for dev in (torch.device("cpu"), device):
            x = planes.to(dev).requires_grad_(True)
            out = forward_operator(x, angles.to(dev), shifts.to(dev), (16, 16), cfg)
            (adj,) = torch.autograd.grad(out, x, cot.to(dev))
            results.append((out.detach().cpu(), adj.cpu()))
        (cpu_out, cpu_adj), (gpu_out, gpu_adj) = results
        fwd_err = float((cpu_out - gpu_out).abs().max())
        adj_err = float((cpu_adj - gpu_adj).abs().max())
        tol = OPERATOR_SMALL_ATOL[label]
        log(f"[operator-small] {label}: A x max err {fwd_err:.3g} (bound {tol:.3g}), "
            f"A^T y max err {adj_err:.3g} (bound {4 * tol:.3g})")
        if not (fwd_err <= tol and adj_err <= 4 * tol):
            raise AssertionError(f"[operator-small] {label}: card and CPU disagree")


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


VOC_DIR = "build/chip_smoke_voc"


def voc_scenes(seed: int, n: int, size, off_size):
    """name -> (image (H, W, 3) uint8, labels (H, W) uint8 with 255
    contours): synthetic scenes at size, every other one at off_size."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import (
        synthetic_scene)

    rng = np.random.default_rng(seed)
    scenes = {}
    for i in range(n):
        img, lab = synthetic_scene(rng, size if i % 2 == 0 else off_size)
        scenes[f"voc{i:04d}"] = ((img * 255).astype(np.uint8), lab.astype(np.uint8))
    return scenes


def write_voc_root(root: str, names) -> None:
    """A VOC-shaped root holding the split list ImageSets/Segmentation/train.txt."""
    import os

    os.makedirs(os.path.join(root, "ImageSets", "Segmentation"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "Segmentation", "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def voc_dataset(root: str, scenes, size: int):
    """The VOC dataset over root at size px whose decode hands over the
    scenes' arrays: everything after the file decode (the resize, /255,
    shuffle, random_transform, prefetch) runs as a user runs it."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.data.dataset import (
        PascalVOC2012Dataset)

    return PascalVOC2012Dataset(root, image_size=(size, size), decode=scenes.__getitem__)


def phase_train_voc(device):
    """cli.train --data voc at full width (Xception OS16, bf16, adam 1e-3,
    batch 8, 512 px, --augment --warp_augment) for VOC_STEPS steps, on
    VOC_SCENES scenes handed over decoded: the shuffled epochs, the host's
    random_transform (flip, rotate with expand, zoom, brightness) and
    resize, the prefetch thread, the warp on the card and the step run as a
    user runs them. Launches counted from 0 around the run (4 + 2 a step,
    asserted); steady s/step between the first and the last log point; the
    share of that window the loop waited on the prefetch queue; then the
    host pipeline alone (VOC_HOST_BATCHES batches, no training)."""
    import contextlib
    import shutil

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.train import train
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    shutil.rmtree(VOC_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    scenes = voc_scenes(11, VOC_SCENES, (512, 512), VOC_OFF_SIZE)
    write_voc_root(VOC_DIR, scenes)
    dataset = voc_dataset(VOC_DIR, scenes, 512)
    log(f"[train-voc] {VOC_SCENES} scenes drawn in {time.perf_counter() - t0:.2f}s "
        f"({VOC_SCENES // 2} at 512 x 512, {VOC_SCENES // 2} at "
        f"{VOC_OFF_SIZE[0]} x {VOC_OFF_SIZE[1]}), handed to the dataset decoded: file "
        "decoding is outside this phase (the card's machine has no JPEG decoder)")
    args = train_args(512, VOC_STEPS, "--data", "voc", "--pascal_root", VOC_DIR,
                      "--split", "train", "--augment", "--warp_augment")
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary, timing = train(args, dataset=dataset)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    (first_done, first_t), (last_done, last_t) = timing["chunk_ends"][0], \
        timing["chunk_ends"][-1]
    (_, first_wait), (_, last_wait) = timing["prefetch_wait"][0], timing["prefetch_wait"][-1]
    per_step = (last_t - first_t) / (last_done - first_done)
    wait_share = (last_wait - first_wait) / (last_t - first_t)
    losses = summary["losses"]
    steps = summary["total_steps"] - summary["start_step"]
    expected = {name: 2 * WARP_LAUNCHES[name] for name in counters}
    t0 = time.perf_counter()
    with contextlib.closing(dataset.batches("train", TRAIN_BATCH, shuffle=True, seed=0,
                                            augment=True)) as batches:
        for _ in range(VOC_HOST_BATCHES):
            next(batches)
    host_s = (time.perf_counter() - t0) / VOC_HOST_BATCHES
    log(f"[train-voc] {args.backbone} {args.size} px, batch {args.batch}, "
        f"{args.compute_dtype}, --augment --warp_augment: {steps} steps, first step "
        f"{timing['first_step_s']:.3f}s, steady {per_step:.4f} s/step "
        f"({args.batch / per_step:.1f} images/s) over steps {first_done + 1}-{last_done}, "
        f"waiting on the prefetch queue {wait_share:.1%} of that window "
        f"({last_wait:.2f}s of {last_t:.2f}s over the whole run); the host pipeline "
        f"alone {host_s:.4f} s/batch; peak memory {peak / 2**30:.2f} GiB; losses {losses}")
    log(f"[train-voc] kernel launches {json.dumps(launches)} over {steps} steps, "
        f"expected per step {json.dumps(expected)}")
    if len(losses) != steps // TRAIN_CHUNK or not all(np.isfinite(losses)):
        raise AssertionError(f"[train-voc] losses not finite: {losses}")
    for name, count in launches.items():
        if count != expected[name] * steps:
            raise AssertionError(f"[train-voc] {count} {name} launches, expected "
                                 f"{expected[name] * steps}")
    return {"launches": launches, "steps": steps, "launches_per_step": expected,
            "peak_bytes": peak, "first_step_s": timing["first_step_s"],
            "steady_s_per_step": per_step, "images_per_s": args.batch / per_step,
            "prefetch_wait_share": wait_share, "prefetch_wait_s": last_wait,
            "loop_s": last_t, "host_s_per_batch": host_s, "losses": losses}


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


class LaunchWindow:
    """The launch counts of one path (set to 0 on entry, read on exit) and
    its peak device memory."""

    def __init__(self, device):
        self.device = device
        self.counters = launch_counters()
        self.launches = {}
        self.peak = 0

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.device)
        for counter in self.counters.values():
            counter.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.launches = {name: c.launches for name, c in self.counters.items()}
        self.peak = torch.cuda.max_memory_allocated(self.device)
        return False

    def check(self, label, expected):
        log(f"[{label}] kernel launches {json.dumps(self.launches)}, expected "
            f"{json.dumps(expected)}; peak memory {self.peak / 2**30:.2f} GiB")
        for name, count in self.launches.items():
            if count != expected[name]:
                raise AssertionError(f"[{label}] {count} {name} launches, expected "
                                     f"{expected[name]}")


def eval_scenes(seed: int, n: int):
    """n synthetic EVAL_SIZE-px scenes that hold class EVAL_CLASS
    (data/synthetic.py): names, (n, H, W, 3) float32 images in [0, 1] and
    (n, H, W, 1) float32 labels with 255 on the shapes' contours."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import (
        synthetic_batch)

    images, labels = synthetic_batch(np.random.default_rng(seed), n,
                                     size=(EVAL_SIZE, EVAL_SIZE), require_class=EVAL_CLASS)
    return ([f"scene{i:02d}" for i in range(n)], images,
            labels[..., None].astype(np.float32))


def _steady(seconds):
    """Mean seconds after the first call (which pays first-use work)."""
    return float(np.mean(seconds[1:])) if len(seconds) > 1 else float(seconds[0])


def phase_staged(device, names, images):
    """generate_augmented_copies' core (``stage_feature_maps``) at the CLI's
    defaults with --shared_tta: Xception OS16 bf16, 100 copies, angles to
    0.3, shifts to 30 px, in every OPM mode, the forward in one batch and in
    chunks of EVAL_CHUNK copies (each image synchronised, as the CLI fetches
    its masks to write them). The chunked stacks are held against the
    unchunked ones; one copies warp (2 + 1 launches) per staging."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli import (
        generate_augmented_copies)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import (
        SEED, build_deeplab, feature_size_of)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.feature_maps import (
        stage_feature_maps)

    args = generate_augmented_copies.build_parser().parse_args(
        ["--class_id", str(EVAL_CLASS), "--num_aug", str(EVAL_NUM_AUG), "--shared_tta"])
    model = build_deeplab(args.backbone, device=device)
    stack_shape = (args.num_aug, *feature_size_of(model.cfg), 1)
    staged, seconds = {}, {}
    with LaunchWindow(device) as window:
        for mode in EVAL_MODES:
            for chunk in (0, EVAL_CHUNK):
                staged[mode, chunk], seconds[mode, chunk] = [], []
                for name, image in zip(names, images):
                    start = time.perf_counter()
                    out = stage_feature_maps(model, name, image, EVAL_CLASS, mode,
                                             args.num_aug, args.angle_max, args.shift_max,
                                             chunk, SEED, args.shared_tta)
                    torch.cuda.synchronize()
                    seconds[mode, chunk].append(time.perf_counter() - start)
                    staged[mode, chunk].append(out)
    stagings = len(EVAL_MODES) * 2 * len(names)
    window.check("staged", {k: v * stagings for k, v in WARP_LAUNCHES.items()})
    for mode in EVAL_MODES:
        agree, rel = 1.0, 0.0
        for (cls0, mx0, a0, s0), (cls1, mx1, a1, s1) in zip(staged[mode, 0],
                                                           staged[mode, EVAL_CHUNK]):
            if tuple(cls0.shape) != stack_shape or not (
                    torch.equal(a0, a1) and torch.equal(s0, s1)):
                raise AssertionError(f"[staged] {mode}: wrong stack or draws")
            if mode == "argmax":
                agree = min(agree, float((cls0 == cls1).float().mean()))
            for x0, x1 in ((cls0, cls1), (mx0, mx1)):
                if x0 is not None:
                    rel = max(rel, float((x0 - x1).abs().max() / x0.abs().max()))
        log(f"[staged] {mode}: {len(names)} images, {args.num_aug} copies, synchronised "
            f"steady {_steady(seconds[mode, 0]):.3f} s/image in one forward (first "
            f"{seconds[mode, 0][0]:.3f}s), {_steady(seconds[mode, EVAL_CHUNK]):.3f} in "
            f"chunks of {EVAL_CHUNK}; chunked vs one forward: argmax agreement {agree:.6f}, "
            f"max |diff| / max |stack| {rel:.3g} (bounds {E2E_MASK_AGREE}, "
            f"{BF16_STACK_RTOL})")
        if agree < E2E_MASK_AGREE or rel > BF16_STACK_RTOL:
            raise AssertionError(f"[staged] {mode}: the chunked forward disagrees")
    first = staged["argmax", 0][0]
    if not all(torch.equal(out[2], first[2]) for out in staged["argmax", 0]):
        raise AssertionError("[staged] --shared_tta staged different sets")
    del model
    torch.cuda.empty_cache()
    record = {"launches": window.launches, "peak_bytes": window.peak,
              "s_per_image": {mode: _steady(seconds[mode, 0]) for mode in EVAL_MODES},
              "s_per_image_chunked": {mode: _steady(seconds[mode, EVAL_CHUNK])
                                      for mode in EVAL_MODES}}
    return {mode: staged[mode, 0] for mode in EVAL_MODES}, record


def phase_standard(device, images):
    """generate_standard_output's core (``standard_masks``): the full model
    with its x4 upsample, argmax, the class kept; one image a call,
    synchronised. No shear kernel on this path."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import (
        build_deeplab)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.generate_standard_output \
        import standard_masks

    model = build_deeplab("xception", device=device, final_upsample=True)
    masks, seconds = [], []
    with LaunchWindow(device) as window:
        for image in images:
            start = time.perf_counter()
            mask = standard_masks(model, torch.as_tensor(image, device=device)[None],
                                  EVAL_CLASS)[0]
            masks.append(mask.float().cpu().numpy())
            seconds.append(time.perf_counter() - start)
    window.check("standard", {name: 0 for name in KERNELS})
    values = set(np.unique(np.stack(masks)).tolist())
    if masks[0].shape != (*images.shape[1:3], 1) or not values <= {0.0, float(EVAL_CLASS)}:
        raise AssertionError(f"[standard] masks {masks[0].shape} with values {values}")
    log(f"[standard] {len(images)} images, full model (x4 upsample): steady "
        f"{_steady(seconds):.3f} s/image (first {seconds[0]:.3f}s); class fraction "
        f"{float(np.mean([m > 0 for m in masks])):.4f}")
    return masks, model, {"launches": window.launches, "peak_bytes": window.peak,
                          "s_per_image": _steady(seconds)}


def phase_sr_eval(device, names, labels, staged, standard):
    """SR_single_class's core over the staged stacks kept in memory, mode by
    mode as three runs: load_sr_data's normalization (``prepare_sr_inputs``),
    the shared set's stencil from one ``StencilCache`` (extracted at the
    second image of the first run, reused after), ``score_image`` (aug, max
    and mean SR, six IoUs against the scene's labels and the standard
    mask), at SR_single_class's defaults (300 AMSGrad steps, th_factor
    0.65); then threshold_tests' core (``threshold_ious``: one solve, its
    own extraction, 17 thresholds) on the argmax stacks. Launches per image
    as the design implies: per solved stack b (the operator forward and
    backward), 35 probes more when the solve extracts its own stencil, and
    an inverse warp each for max and mean; slice_max solves two stacks."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli import (
        SR_single_class, threshold_tests)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import (
        make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
        OPERATOR_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import (
        RADIUS_X, RADIUS_Y)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.opm import (
        prepare_sr_inputs)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    probes = (2 * RADIUS_Y + 1) * (RADIUS_X + 1)
    args = SR_single_class.build_parser().parse_args(
        ["--class_id", str(EVAL_CLASS), "--num_aug", str(EVAL_NUM_AUG)])
    # The LR size from the staged stacks, as SR_single_class reads it.
    sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                            feature_size=tuple(staged["argmax"][0][0].shape[1:3]),
                            output_size=labels.shape[1:3])
    cache = SR_single_class.StencilCache()
    expected = dict.fromkeys(KERNELS, 0)
    timed = {mode: [] for mode in EVAL_MODES}
    averages = {}
    with LaunchWindow(device) as window:
        for mode in EVAL_MODES:
            run_seen, scores = set(), []
            for i, (cls, mx, angles, shifts) in enumerate(staged[mode]):
                start = time.perf_counter()
                cls_n, mx_n = prepare_sr_inputs(cls, mx, mode)
                before = cache.extractions
                coeffs = cache.lookup(SR_single_class.tta_key(angles.cpu().numpy(),
                                                              shifts.cpu().numpy()),
                                      run_seen, angles, shifts, sr_cfg)
                scores.append(SR_single_class.score_image(
                    sr_cfg, cls_n, mx_n, angles, shifts, labels[i], standard[i],
                    class_id=EVAL_CLASS, th_factor=args.th_factor, gram_coeffs=coeffs))
                extracted = cache.extractions - before
                if coeffs is not None and not extracted:
                    timed[mode].append(time.perf_counter() - start)
                stacks = 1 if mx_n is None else 2
                applications = 1 + (probes if coeffs is None else 0)
                for name in KERNELS:
                    expected[name] += (stacks * (2 * OPERATOR_LAUNCHES[name] * applications
                                                 + 2 * WARP_LAUNCHES[name])
                                       + extracted * probes * 2 * OPERATOR_LAUNCHES[name])
            if not all(0.0 <= v <= 1.0 for sc in scores for v in sc.values()):
                raise AssertionError(f"[sr-eval] {mode}: an IoU outside [0, 1]: {scores}")
            averages[mode] = {k: float(np.mean([sc[k] for sc in scores]))
                              for k in SR_single_class.IOU_KEYS}
    window.check("sr-eval", expected)
    if cache.extractions != 1:
        raise AssertionError(f"[sr-eval] {cache.extractions} stencil extractions, expected "
                             "1 (at the second image of the first run)")
    for mode in EVAL_MODES:
        log(f"[sr-eval] {mode}: {len(names)} images, aug+max+mean and six IoUs, "
            f"{np.mean(timed[mode]):.3f} s/image with the cached stencil "
            f"({len(timed[mode])} images); averages "
            + json.dumps({k: round(v, 4) for k, v in averages[mode].items()}))
    log(f"[sr-eval] the shared set's stencil extracted once in {cache.extraction_s:.3f}s "
        "(at the second image of the first run)")

    factors = threshold_tests.threshold_grid(0.1, 0.9, 0.05)
    seconds, curves = [], []
    with LaunchWindow(device) as thresholds:
        for i, (cls, mx, angles, shifts) in enumerate(staged["argmax"]):
            start = time.perf_counter()
            cls_n, _ = prepare_sr_inputs(cls, mx, "argmax")
            curves.append(threshold_tests.threshold_ious(sr_cfg, cls_n, angles, shifts,
                                                         labels[i], EVAL_CLASS, factors))
            seconds.append(time.perf_counter() - start)
    thresholds.check("threshold", {name: len(seconds) * 2 * OPERATOR_LAUNCHES[name]
                                   * (1 + probes) for name in KERNELS})
    curve = np.mean(curves, axis=0)
    if len(factors) != 17 or not np.all((curve >= 0) & (curve <= 1)):
        raise AssertionError(f"[threshold] curve {curve}")
    log(f"[threshold] {len(seconds)} images, one solve (its own 35-probe extraction) and "
        f"17 thresholds each: steady {_steady(seconds):.3f} s/image (first "
        f"{seconds[0]:.3f}s); best th_factor {factors[int(np.argmax(curve))]} "
        f"(IoU {curve.max():.4f})")
    return ({"launches": window.launches, "peak_bytes": window.peak,
             "s_per_image_cached_stencil": {m: float(np.mean(t)) for m, t in timed.items()},
             "extraction_s": cache.extraction_s, "averages": averages},
            {"launches": thresholds.launches, "peak_bytes": thresholds.peak,
             "s_per_image": _steady(seconds)})


def phase_robustness(device, model, images, labels):
    """check_robustness' core (``robustness_grid``) at full width: the full
    model, ROBUST_IMAGES scenes in one batch, ROBUST_ANGLES x ROBUST_SHIFTS^2
    combinations, each a bilinear warp of the images and a nearest warp of
    the labels (3 + 3 launches), the forward, the argmax and the per-image
    mean IoU on the card, fetched once a combination. Then the card's warped
    labels are held bit for bit (images to ATOL_F32) against the plain
    path's on the CPU."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli import check_robustness
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)

    images = torch.as_tensor(images, device=device)
    gts = torch.as_tensor(labels, device=device)
    combos = len(ROBUST_ANGLES) * len(ROBUST_SHIFTS) ** 2
    rows, seconds = [], []
    with LaunchWindow(device) as window:
        start = time.perf_counter()
        for row in check_robustness.robustness_grid(model, images, gts, ROBUST_ANGLES,
                                                    ROBUST_SHIFTS, ROBUST_IMAGES):
            rows.append(row)
            seconds.append(time.perf_counter() - start)
            start = time.perf_counter()
    window.check("robustness", {k: 2 * v * combos for k, v in WARP_LAUNCHES.items()})
    mious = {(a, sx, sy): m for a, sx, sy, m in rows}
    if len(rows) != combos or not all(0.0 <= m <= 1.0 for m in mious.values()):
        raise AssertionError(f"[robustness] {len(rows)} combinations: {rows}")
    per_combo = _steady(seconds)
    log(f"[robustness] {images.shape[0]} images x {combos} combinations: steady "
        f"{per_combo:.4f} s/combination ({images.shape[0] / per_combo:.1f} images/s; "
        f"first {seconds[0]:.3f}s); combination mean IoUs: identity "
        f"{mious[0.0, 0.0, 0.0]:.4f}, min {min(mious.values()):.4f}, max "
        f"{max(mious.values()):.4f}; all " + json.dumps([round(m, 4) for *_, m in rows]))
    combo = (ROBUST_ANGLES[-1], ROBUST_SHIFTS[-1], ROBUST_SHIFTS[0])
    aug, gt_aug = check_robustness.warp_batch(images, gts, *combo)
    aug_cpu, gt_cpu = check_robustness.warp_batch(images.cpu(), gts.cpu(), *combo)
    img_err = float((aug.cpu() - aug_cpu).abs().max())
    equal = bool(torch.equal(gt_aug.cpu(), gt_cpu))
    log(f"[robustness] combination {combo} card vs the plain path on the CPU: labels "
        f"equal {equal}, images max err {img_err:.3g} (bound {ATOL_F32})")
    if not equal or img_err > ATOL_F32:
        raise AssertionError("[robustness] the card's warp disagrees with the plain path")
    return {"launches": window.launches, "peak_bytes": window.peak, "combinations": combos,
            "s_per_combination": per_combo, "images_per_s": images.shape[0] / per_combo,
            "identity_miou": mious[0.0, 0.0, 0.0]}


def _close(label, what, cpu, gpu, atol):
    err = float((torch.as_tensor(cpu) - torch.as_tensor(gpu)).abs().max())
    log(f"[eval-small] {label}: {what} max err {err:.3g} (bound {atol:.3g})")
    if not err <= atol:
        raise AssertionError(f"[eval-small] {label}: the card and the CPU disagree")


def _agree(label, cpu, gpu):
    agree = float((torch.as_tensor(cpu) == torch.as_tensor(gpu)).float().mean())
    log(f"[eval-small] {label}: mask agreement {agree:.6f} (bound {E2E_MASK_AGREE})")
    if agree < E2E_MASK_AGREE:
        raise AssertionError(f"[eval-small] {label}: the card and the CPU disagree")


def phase_eval_small(device):
    """The evaluation cores on the card against the same calls on the CPU
    (the plain versions), Xception OS16 at 64 px in f32 on a synthetic
    scene: stage_feature_maps in every mode (masks >= E2E_MASK_AGREE equal;
    the [0, 1] slice stack to E2E_TARGET_ATOL, the raw slice_max logits to
    E2E_TARGET_ATOL of their scale); standard_masks; score_image of the
    CPU's argmax and slice_max stacks, and threshold_ious, IoUs to
    EVAL_IOU_ATOL; robustness_grid of two images over 2 x 2 x 2
    combinations, mean IoUs to EVAL_IOU_ATOL. The ground truth is the CPU
    full model's own labels, so that the IoUs are not trivial."""
    import dataclasses

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli import (
        SR_single_class, check_robustness, threshold_tests)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import (
        SEED, make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.generate_standard_output \
        import standard_masks
    from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import (
        synthetic_batch)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, build_model)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.opm import (
        prepare_sr_inputs)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.feature_maps import (
        stage_feature_maps)

    cfg = DeepLabConfig(input_shape=(64, 64, 3), final_upsample=False)
    full_cfg = dataclasses.replace(cfg, final_upsample=True)
    sr_cfg = make_sr_config(None, num_aug=4, feature_size=(16, 16), output_size=(64, 64),
                            num_iter=30)
    images, _ = synthetic_batch(np.random.default_rng(11), 2, size=(64, 64))
    factors = threshold_tests.threshold_grid(0.1, 0.9, 0.05)
    outs, truth, class_id = [], None, None
    for dev in (torch.device("cpu"), device):
        model = build_model(cfg, seed=0, device=dev)
        full = build_model(full_cfg, seed=0, device=dev)
        imgs = torch.as_tensor(images, device=dev)
        if truth is None:   # the CPU model's labels and its most frequent class
            with torch.no_grad():
                truth = full(imgs).argmax(-1, keepdim=True).float()
            class_id = int(torch.bincount(truth.flatten().long(), minlength=21).argmax())
        out = {"staged": {mode: stage_feature_maps(model, "small", images[0], class_id,
                                                   mode, 4, 0.15, 8.0, 0, SEED)
                          for mode in EVAL_MODES},
               "standard": standard_masks(full, imgs, class_id)}
        cpu_staged = outs[0]["staged"] if outs else out["staged"]
        out["scores"] = {}
        for mode in ("argmax", "slice_max"):
            cls, mx, angles, shifts = (t if t is None else t.to(dev)
                                       for t in cpu_staged[mode])
            cls_n, mx_n = prepare_sr_inputs(cls, mx, mode)
            out["scores"][mode] = SR_single_class.score_image(
                sr_cfg, cls_n, mx_n, angles, shifts, truth[0].cpu().numpy(),
                truth[0].cpu().numpy(), class_id=class_id, th_factor=0.2)
        cls, _, angles, shifts = (t if t is None else t.to(dev)
                                  for t in cpu_staged["argmax"])
        out["thresholds"] = threshold_tests.threshold_ious(
            sr_cfg, prepare_sr_inputs(cls, None, "argmax")[0], angles, shifts,
            truth[0].cpu().numpy(), class_id, factors)
        out["robustness"] = [m for *_, m in check_robustness.robustness_grid(
            full, imgs, truth.to(dev), (-0.1, 0.1), (0.0, 4.0), batch_size=2)]
        outs.append(out)
    cpu, gpu = outs
    log(f"[eval-small] class {class_id}")
    for mode in EVAL_MODES:
        (c_cls, c_mx, c_a, _), (g_cls, g_mx, g_a, _) = cpu["staged"][mode], gpu["staged"][mode]
        _close(f"staged {mode}", "angles", c_a, g_a.cpu(), 0.0)
        if mode == "argmax":
            _agree("staged argmax", c_cls, g_cls.cpu())
        elif mode == "slice":
            _close("staged slice", "[0, 1] stack", c_cls, g_cls.cpu(), E2E_TARGET_ATOL)
        else:
            scale = float(c_cls.abs().max())
            _close("staged slice_max", "class logits", c_cls, g_cls.cpu(),
                   E2E_TARGET_ATOL * scale)
            _close("staged slice_max", "max logits", c_mx, g_mx.cpu(),
                   E2E_TARGET_ATOL * scale)
    _agree("standard masks", cpu["standard"], gpu["standard"].cpu())
    for mode in ("argmax", "slice_max"):
        _close(f"score_image {mode}", "six IoUs",
               [cpu["scores"][mode][k] for k in SR_single_class.IOU_KEYS],
               [gpu["scores"][mode][k] for k in SR_single_class.IOU_KEYS], EVAL_IOU_ATOL)
    _close("threshold_ious", "17 IoUs", cpu["thresholds"], gpu["thresholds"], EVAL_IOU_ATOL)
    _close("robustness_grid", "8 combination mean IoUs", cpu["robustness"],
           gpu["robustness"], EVAL_IOU_ATOL)


SHARDED_DIR = "build/chip_smoke_sharded"


def _sharded_stencil_path(cfg) -> str:
    import os

    return os.path.join(SHARDED_DIR, f"stencil_{cfg.num_aug}_{cfg.n_valid}.npy")


def _sharded_serve(rank, run, mesh, model, device, images, sr_cfg, class_id):
    """One rank of a sharded serving run: ``serve`` with the mesh on this
    rank's share of the images (launches counted from 0 around it, its peak
    memory), then ``make_asr_batch_fn`` on the first global batch, whose
    masks the writing ranks keep for the IoU against the one-process path."""
    import os

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        SEED, rank_share, serve)
    from deeplabv3plus_augmented_superresolution_tpu_torch.parallel import (
        make_asr_batch_fn, padded_sr_cfg, shard_batch)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        sample_augmentations)

    padded = padded_sr_cfg(sr_cfg, mesh)
    coeffs = (torch.as_tensor(np.load(_sharded_stencil_path(padded)), device=device)
              if mesh.rank == 0 else
              torch.empty((7, 9) + tuple(sr_cfg.output_size), device=device))
    share = [(name if real else None, image)
             for real, (name, image) in rank_share(images, SHARDED_BATCH, mesh)]
    counters = launch_counters()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary = serve(share, model, sr_cfg, device=device, class_id=class_id,
                    sr_types=SLICE_SR_TYPES, batch=SHARDED_BATCH, gram_coeffs=coeffs,
                    writer_threads=2, mesh=mesh)
    launches = {name: counter.launches for name, counter in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED),
                                          sr_cfg.num_aug, 0.15, 80.0, device=device)
    batch_fn = make_asr_batch_fn(mesh, model, sr_cfg, class_id, th_factor=0.2,
                                 sr_types=SLICE_SR_TYPES, gram_coeffs=coeffs,
                                 return_targets=True)
    first = torch.stack([torch.as_tensor(image, device=device)
                         for _, image in images[:SHARDED_BATCH]])
    own, own_angles, own_shifts = shard_batch(mesh, first, angles, shifts)
    out = batch_fn(own, own_angles, own_shifts)
    finite = all(bool(torch.isfinite(out[f"{t}_target"]).all()) for t in SLICE_SR_TYPES)
    start, count = mesh.block("data", SHARDED_BATCH)
    if mesh.aug_index == 0:
        np.savez(os.path.join(SHARDED_DIR, f"{run['label']}.masks{mesh.data_index}.npz"),
                 **{t: out[t].cpu().numpy() for t in SLICE_SR_TYPES})
    return {"rank": rank, "data_index": mesh.data_index, "aug_index": mesh.aug_index,
            "images": list(range(start, start + count)), "launches": launches,
            "steps": summary["steps"], "peak_bytes": peak, "targets_finite": finite,
            "copies": own_angles.shape[0], "num_aug": padded.num_aug,
            "num_valid": padded.n_valid, "n_images": summary["n_images"],
            "first_image_s": summary["first_image_s"],
            "steady_s_per_image": summary["steady_s_per_image"],
            "loop_stages_ms": {k: round(v["ms_per_call"], 3)
                               for k, v in summary["loop_stages"].items()}}


SHARDED_VOC_DIR = SHARDED_DIR + "/voc"
# The sharded training runs: the synthetic data, and --data voc with
# --augment (a loss at every step) on the SHARDED_VOC_SCENES scenes.
SHARDED_TRAIN_RUNS = ("train-sharded", "train-voc-sharded")


def sharded_train(label: str, ckpt_dir: str, mesh=None):
    """cli.train's `train` configuration (Xception OS16, 128 px, batch 8) for
    the sharded check ``label``: sgd at TRAIN_CHECK_LR for SHARDED_TRAIN_STEPS
    steps from the conditioned start (SHARDED_BETA_RANGE), a checkpoint at
    the end; on one process, or as this rank of ``mesh``."""
    import os

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.train import train

    extra, dataset = (), None
    if label == "train-voc-sharded":
        extra = ("--data", "voc", "--pascal_root", SHARDED_VOC_DIR, "--split", "train",
                 "--augment", "--log_every", "1")
        dataset = voc_dataset(SHARDED_VOC_DIR, voc_scenes(
            13, SHARDED_VOC_SCENES, (128, 128), SHARDED_VOC_OFF_SIZE), 128)
    args = train_args(128, SHARDED_TRAIN_STEPS, "--optimizer", "sgd", "--lr",
                      str(TRAIN_CHECK_LR), "--resume", os.path.join(SHARDED_DIR, "start.npz"),
                      "--compute_dtype", SHARDED_TRAIN_DTYPE, "--ckpt_dir", ckpt_dir,
                      "--ckpt_every", str(SHARDED_TRAIN_STEPS), "--eval_images", "1", *extra)
    return train(args, mesh, dataset=dataset)


def _sharded_train(rank, label, mesh, device):
    """One rank of the sharded training run ``label``: cli.train's ``train``
    with the mesh, launches counted from 0 around it."""
    import os

    counters = launch_counters()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for counter in counters.values():
        counter.launches = 0
    summary, timing = sharded_train(label, os.path.join(SHARDED_DIR, f"{label}-ranks"), mesh)
    return {"rank": rank, "losses": summary["losses"], "devices": summary["devices"],
            "launches": {name: counter.launches for name, counter in counters.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "first_step_s": timing["first_step_s"]}


def _sharded_worker(rank: int, spec: dict) -> None:
    """A process of the [sharded] phase: it takes part, as rank ``rank``, in
    each of spec's runs that has more ranks than that, each in a process
    group of its own (gloo ranks on card 0, or NCCL ranks a card each); a
    run's results go to SHARDED_DIR as JSON. An exception ends the process,
    and torch.multiprocessing.spawn then ends the others and raises."""
    import datetime
    import os

    import torch.distributed as dist

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        build_deeplab, make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = make_images(spec["seed"], SHARDED_IMAGES)
    sr_cfg = make_sr_config(None, num_aug=100, angle_max=0.15)
    models = {}
    for run in spec["runs"]:
        if rank >= run["ranks"]:
            continue
        device = torch.device("cuda", rank if run["backend"] == "nccl" else 0)
        torch.cuda.set_device(device)
        dist.init_process_group(run["backend"], init_method=f"tcp://localhost:{run['port']}",
                                world_size=run["ranks"], rank=rank,
                                timeout=datetime.timedelta(seconds=600))
        mesh = make_mesh(tuple(run["mesh"]))
        if run["kind"] == "serve":
            if device not in models:
                models[device] = build_deeplab("xception", device=device)
            result = _sharded_serve(rank, run, mesh, models[device], device, images,
                                    sr_cfg, spec["class_id"])
        else:
            result = _sharded_train(rank, run["label"], mesh, device)
        dist.destroy_process_group()
        with open(os.path.join(SHARDED_DIR, f"{run['label']}.rank{rank}.json"), "w") as f:
            json.dump(result, f)


def _check_train_state(label, want_path, got_path):
    """A sharded run's final train state against the one-process run's (the
    form of `[train-small]`'s check, over SHARDED_TRAIN_STEPS steps): sgd's
    momentum trace per leaf to 1% of the leaf's largest value + 1e-4 of the
    whole trace's; the moving statistics 1e-5 absolute + 1e-5 relative; every
    other parameter to 1e-6 + lr x steps x its leaf's trace bound (the
    parameters move by lr times the trace each step). Returns the worst
    share of each bound."""
    with np.load(want_path) as want, np.load(got_path) as got:
        opt = sorted((k for k in want.files if k.startswith("__opt__.")),
                     key=lambda k: int(k.split(".")[1]))
        traces = [want[k] for k in opt if want[k].ndim and want[k].size > 1]
        scale = max(float(np.abs(t).max()) for t in traces)
        worst = {"trace": (0.0, ""), "moving": (0.0, ""), "params": (0.0, "")}
        failed = []

        def note(kind, share, key):
            if share > worst[kind][0]:
                worst[kind] = (share, key)
            if not share <= 1.0:
                failed.append(f"{key} {kind} {share:.3g} of its bound")

        trace_bound = {}
        for key in opt:
            w, g = want[key], got[key]
            bound = 1e-2 * float(np.abs(w).max()) + 1e-4 * scale
            trace_bound[key] = bound
            note("trace", float(np.abs(g - w).max()) / bound if w.size else 0.0, key)
        params = sorted(k for k in want.files if not k.startswith("__"))
        per_leaf = dict(zip(params, (trace_bound[k] for k in opt))) \
            if len(opt) == len(params) else {}
        for key in params:
            w, g = want[key], got[key]
            err = float(np.abs(g - w).max())
            if "moving" in key:
                note("moving", err / (1e-5 + 1e-5 * float(np.abs(w).max())), key)
            else:
                bound = 1e-6 + TRAIN_CHECK_LR * SHARDED_TRAIN_STEPS * per_leaf.get(key, scale)
                note("params", err / bound, key)
    log(f"[{label}] final state vs the one-process run: worst trace leaf "
        f"{worst['trace'][1]} at {worst['trace'][0]:.3f} of its bound, moving "
        f"statistics {worst['moving'][1]} at {worst['moving'][0]:.3f}, parameters "
        f"{worst['params'][1]} at {worst['params'][0]:.3f}")
    if failed:
        raise AssertionError(f"[{label}] the sharded run disagrees: {failed[:5]}")
    return {kind: round(share, 4) for kind, (share, _) in worst.items()}


def phase_sharded(device, images, sr_cfg, class_id, angles, shifts, coeffs, seed):
    """``parallel/`` on the card, the ranks spawned as processes that share
    card 0 through a gloo group (the harness's choice: NCCL refuses two ranks
    on one device; the CLIs take NCCL, a rank per card), each running the
    library functions the CLIs run:

      * ``serve-sharded-aug3``: 3 ranks, ``serve`` with --batch 2 on a (1, 3)
        mesh, the 100 copies padded to 102 (34 a rank, num_valid 100, the
        padded stencil extracted here and checked first), one class, aug +
        max + mean, 2 batches;
      * ``serve-sharded-data2-aug2``: 4 ranks, a (2, 2) mesh, 50 copies a
        rank, an image a data group, 2 batches;
      * ``train-sharded``: 2 ranks, ``cli.train``'s ``train`` at 128 px,
        global batch 8 (4 a rank), SHARDED_TRAIN_STEPS sgd steps from the
        conditioned start (SHARDED_BETA_RANGE), held against the one-process
        run on the same draws (``_check_train_state``), which is first made
        twice and held against itself with the same bounds;
      * ``train-voc-sharded``: the same with ``--data voc --augment`` on
        SHARDED_VOC_SCENES scenes handed over decoded (an epoch of 2
        batches, so the third step restarts the epoch), a loss every step.

    Each serving run's masks of its first batch against the one-process
    --batch 2 path's (IoU >= SHARDED_MIN_IOU each), its targets finite, each
    rank's launches per step equal to the one-card path's (asserted) and
    its peak; seconds per batch are of ranks sharing one card, not a speed
    figure. Then a world-1 NCCL group runs ``make_asr_batch_fn`` on a (1, 1)
    mesh for one image, held bit for bit against the one-process step; with
    two cards or more, ``serve-sharded-aug2-nccl`` (a rank per card) too."""
    import os
    import shutil

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import build_deeplab
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
        DeepLabConfig, init_params, save_params_npz)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import apply_gram
    from deeplabv3plus_augmented_superresolution_tpu_torch.parallel import (
        make_asr_batch_fn, make_mesh, padded_sr_cfg)
    from deeplabv3plus_augmented_superresolution_tpu_torch.parallel.mesh import (
        Mesh, free_port)
    from deeplabv3plus_augmented_superresolution_tpu_torch.parallel.sharded import (
        copy_block)
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import asr_step
    from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
        forward_operator, precompute_gram_stencil)

    t_phase = time.perf_counter()
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    os.makedirs(SHARDED_DIR)
    images = images[:SHARDED_IMAGES]
    runs = [{"label": label, "kind": "serve", "ranks": ranks, "mesh": shape,
             "backend": "gloo"} for label, ranks, shape in SHARDED_SERVE_RUNS]
    runs += [{"label": label, "kind": "train", "ranks": SHARDED_TRAIN_RANKS,
              "mesh": (1, SHARDED_TRAIN_RANKS), "backend": "gloo"}
             for label in SHARDED_TRAIN_RUNS]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs.append({"label": "serve-sharded-aug2-nccl", "kind": "serve", "ranks": 2,
                     "mesh": (1, 2), "backend": "nccl"})
    for run in runs:
        run["port"] = free_port()

    # The stencils for rank 0 to load: the run's (coeffs, checked in phase 3)
    # and the padded one of the aug-3 mesh (102 copies, 100 real), checked
    # here against the normal operator of the 100 real copies.
    np.save(_sharded_stencil_path(sr_cfg), coeffs.cpu().numpy())
    for run in runs:
        if run["kind"] != "serve":
            continue
        padded = padded_sr_cfg(sr_cfg, Mesh({"data": run["mesh"][0], "aug": run["mesh"][1]}, 0))
        path = _sharded_stencil_path(padded)
        if os.path.exists(path):
            continue
        t0 = time.perf_counter()
        padded_coeffs = precompute_gram_stencil(angles, shifts, padded)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        x = torch.rand((1, *sr_cfg.output_size, 1),
                       generator=torch.Generator(device=device).manual_seed(1), device=device)
        z = x.clone().requires_grad_(True)
        out = forward_operator(z, angles, shifts, sr_cfg.feature_size, sr_cfg)
        (direct,) = torch.autograd.grad(out, z, out.detach())
        scale = float(direct.abs().max())
        err = float((apply_gram(x, padded_coeffs) - direct).abs().max())
        log(f"[sharded] stencil of {padded.num_aug} copies ({padded.n_valid} real) "
            f"extracted in {seconds:.2f}s; |G x - A^T A x| over the real copies max "
            f"{err:.3g} (scale {scale:.3g}, rel {err / scale:.3g}, bound {STENCIL_RTOL})")
        if not err <= STENCIL_RTOL * scale:
            raise AssertionError("[sharded] the padded stencil disagrees with the "
                                 "normal operator of the real copies")
        np.save(path, padded_coeffs.cpu().numpy())

    # The one-process references: the --batch 2 step on the first batch, and
    # the training run.
    model = build_deeplab("xception", device=device)
    first = torch.stack([torch.as_tensor(image, device=device)
                         for _, image in images[:SHARDED_BATCH]])
    kw = dict(th_factor=0.2, sr_types=SLICE_SR_TYPES, gram_coeffs=coeffs,
              return_targets=True)
    reference = asr_step(model, first, angles, shifts, sr_cfg, class_id, **kw)
    start = init_params(DeepLabConfig(input_shape=(128, 128, 3), classes=21,
                                      backbone="xception", weights=None,
                                      final_upsample=True,
                                      compute_dtype=SHARDED_TRAIN_DTYPE), seed=0)
    rng = np.random.default_rng(7)
    for entry in start.values():
        if "gamma" in entry:
            n = entry["gamma"].shape
            entry["gamma"] = rng.uniform(0.25, 0.5, n).astype(np.float32)
            entry["beta"] = (rng.choice([-1.0, 1.0], n)
                             * rng.uniform(*SHARDED_BETA_RANGE, n)).astype(np.float32)
    save_params_npz(start, os.path.join(SHARDED_DIR, "start.npz"))
    write_voc_root(SHARDED_VOC_DIR, [f"voc{i:04d}" for i in range(SHARDED_VOC_SCENES)])
    one = {label: sharded_train(label, os.path.join(SHARDED_DIR, f"{label}-one"))[0]
           for label in SHARDED_TRAIN_RUNS}
    # The reference reproduces itself: a second one-process run of each,
    # within the bounds the ranks are held to.
    last = f"step_{SHARDED_TRAIN_STEPS}.npz"
    again = {}
    for label in SHARDED_TRAIN_RUNS:
        sharded_train(label, os.path.join(SHARDED_DIR, f"{label}-again"))
        again[label] = _check_train_state(
            f"{label}-again", os.path.join(SHARDED_DIR, f"{label}-one", last),
            os.path.join(SHARDED_DIR, f"{label}-again", last))

    # The world-1 NCCL group: the production backend's gather and broadcast.
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    mesh = make_mesh((1, 1))
    batch_fn = make_asr_batch_fn(mesh, model, sr_cfg, class_id, **kw)
    out = batch_fn(first[:1], *copy_block(mesh, angles, shifts))
    dist.destroy_process_group()
    single = asr_step(model, first[:1], angles, shifts, sr_cfg, class_id, **kw)
    equal = {key: bool(torch.equal(out[key], single[key])) for key in single}
    log(f"[sharded] nccl world 1, mesh (1, 1), one image: make_asr_batch_fn vs the "
        f"one-process step, bit for bit per output: {json.dumps(equal)}")
    if not all(equal.values()):
        raise AssertionError("[sharded] the NCCL (1, 1) step differs from the one-process step")
    del model, batch_fn
    torch.cuda.empty_cache()

    log(f"[sharded] {cards} card(s) visible; runs: "
        + ", ".join(f"{r['label']} ({r['ranks']} {r['backend']} ranks, mesh "
                    f"{tuple(r['mesh'])})" for r in runs)
        + ("" if cards >= 2 else "; serve-sharded-aug2-nccl needs 2 cards: not run")
        + "; the gloo ranks share card 0 (the harness's choice)")
    t0 = time.perf_counter()
    mp.spawn(_sharded_worker, args=({"seed": seed, "class_id": class_id, "runs": runs},),
             nprocs=max(r["ranks"] for r in runs))
    log(f"[sharded] ranks done in {time.perf_counter() - t0:.1f}s")

    paths = {}
    expected = expected_launches(SLICE_SR_TYPES)
    for run in runs:
        label = run["label"]
        ranks = []
        for rank in range(run["ranks"]):
            with open(os.path.join(SHARDED_DIR, f"{label}.rank{rank}.json")) as f:
                ranks.append(json.load(f))
        launches = {name: sum(r["launches"][name] for r in ranks) for name in KERNELS}
        if run["kind"] == "train":
            losses = [r["losses"] for r in ranks]
            want = one[label]["losses"]
            log(f"[{label}] {run['ranks']} ranks, global batch {TRAIN_BATCH}, "
                f"{SHARDED_TRAIN_DTYPE}: losses {losses[0]} against the one-process run's "
                f"{want}; devices {ranks[0]['devices']}; launches "
                f"{json.dumps(launches)}; peak per rank "
                + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in ranks) + " GiB")
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[0], want))
            if any(l != losses[0] for l in losses) or not loss_err <= 1e-5 \
                    or len(want) != SHARDED_TRAIN_STEPS or len(losses[0]) != len(want) \
                    or ranks[0]["devices"] != run["ranks"] or any(launches.values()):
                raise AssertionError(f"[{label}] losses {losses} vs {want} "
                                     f"(rel {loss_err:.3g}, bound 1e-5)")
            shares = _check_train_state(
                label, os.path.join(SHARDED_DIR, f"{label}-one", last),
                os.path.join(SHARDED_DIR, f"{label}-ranks", last))
            paths[label] = {"launches": launches, "loss_rel_err": loss_err,
                            "bound_shares": shares,
                            "one_process_again_bound_shares": again[label],
                            "peak_bytes": max(r["peak_bytes"] for r in ranks)}
            continue
        ious = {}
        for data in range(run["mesh"][0]):
            masks = np.load(os.path.join(SHARDED_DIR, f"{label}.masks{data}.npz"))
            writer = next(r for r in ranks if r["data_index"] == data and r["aug_index"] == 0)
            for t in SLICE_SR_TYPES:
                for i, image in enumerate(writer["images"]):
                    ious.setdefault(t, []).append(
                        _iou(torch.as_tensor(masks[t][i]), reference[t][image].cpu()))
        worst = {t: round(min(v), 5) for t, v in ious.items()}
        lead = ranks[0]
        per_batch = lead["steady_s_per_image"] * SHARDED_BATCH
        log(f"[{label}] mesh {tuple(run['mesh'])}, {run['ranks']} {run['backend']} ranks, "
            f"{lead['num_aug']} copies ({lead['num_valid']} real, {lead['copies']} a "
            f"rank), {lead['n_images']} images in {lead['steps']} steps of "
            f"{SHARDED_BATCH}: masks' IoU against the one-process --batch 2 path, worst "
            f"per type {json.dumps(worst)} (bound {SHARDED_MIN_IOU}); targets finite "
            f"{all(r['targets_finite'] for r in ranks)}; {per_batch:.3f} s/batch "
            f"(ranks sharing one card, not a speed figure)")
        for r in ranks:
            per_step = {name: r["launches"][name] / r["steps"] for name in KERNELS}
            log(f"[{label}] rank {r['rank']} (data {r['data_index']}, aug "
                f"{r['aug_index']}): launches per step {json.dumps(per_step)}, expected "
                f"{json.dumps(expected)}; peak {r['peak_bytes'] / 2**30:.2f} GiB")
            if per_step != {name: float(v) for name, v in expected.items()}:
                raise AssertionError(f"[{label}] rank {r['rank']} launches {r['launches']} "
                                     f"in {r['steps']} steps, expected {expected} a step")
        if (lead["n_images"] != SHARDED_IMAGES or min(worst.values()) < SHARDED_MIN_IOU
                or not all(r["targets_finite"] for r in ranks)):
            raise AssertionError(f"[{label}] {lead['n_images']} images, IoU {worst}")
        paths[label] = {"launches": launches, "launches_per_step_per_rank": expected,
                        "steps": lead["steps"], "min_iou": worst,
                        "s_per_batch_shared_card": per_batch,
                        "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks]}
    log(f"[sharded] phase done in {time.perf_counter() - t_phase:.1f}s")
    return paths


QUALITY_DIR = "build/chip_smoke_quality"
# quality_demo's step and scene counts; nothing else differs from the
# script's defaults but --warp_augment (Xception OS16 bf16, 512 px, 100
# copies, 300 AMSGrad steps, per-image sets, argmax, th 0.65). 600 steps are
# the committed JAX results' count (the script's default is 400): at 400 the
# warp-augmented model is not yet converged (standard IoU 0.7188 on the
# card, PERF.md §6).
QUALITY_TRAIN_STEPS = 600
QUALITY_EVAL_IMAGES = 20
# Below this the model never left the all-background basin.
QUALITY_MIN_STANDARD_IOU = 0.5
# The JAX package's committed results of the same script (600 steps, strict
# per-image sets, without and with --warp_augment).
JAX_QUALITY = ("quality_demo_tpu512.json", "quality_demo_tpu512_warpaug.json")


class StageLaunches:
    """A timer for the quality scripts' ``stage(name)`` hook: each stage's
    host seconds and kernel launches (the counts read before and after).
    The scripts' stages end with a fetch to the host, so it adds no
    synchronisation."""

    def __init__(self):
        self.counters = launch_counters()
        self.records = []

    @contextlib.contextmanager
    def stage(self, name: str):
        before = {k: c.launches for k, c in self.counters.items()}
        start = time.perf_counter()
        yield
        self.records.append((name, time.perf_counter() - start,
                             {k: c.launches - before[k] for k, c in self.counters.items()}))

    def of(self, name: str):
        return [(sec, launches) for n, sec, launches in self.records if n == name]


def _jax_quality_lines():
    """The JAX package's committed quality_demo IoUs (its time figures left
    out), or a line saying a file is missing."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    for name in JAX_QUALITY:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            yield f"{name}: not in this checkout"
            continue
        with open(path) as f:
            ref = json.load(f)
        yield (f"{name} (the JAX package's {ref['train_steps']}-step result, "
               f"warp_augment {ref.get('warp_augment', False)}, {ref['eval_images']} "
               f"scenes): IoU " + json.dumps({k: round(v, 4) for k, v in ref["iou"].items()})
               + " with bg " + json.dumps({k: round(v, 4)
                                           for k, v in ref["iou_with_bg"].items()})
               + f", aug - standard {ref['aug_minus_standard']:+.4f}, win rate "
               f"{ref['aug_win_rate_vs_standard']:.2f}")


def phase_quality(device):
    """quality_demo at full width (the script's main path, ``run_demo``):
    Xception OS16 bf16 trained from init_params(seed 0) on 128 synthetic
    512-px scenes with --warp_augment (adam 1e-3, batch 8, QUALITY_TRAIN_STEPS
    steps), then each held-out scene through ``asr_step`` with its own TTA
    set (its stencil extracted: 35 probes), 100 copies, 300 AMSGrad steps,
    argmax, th 0.65.
    Each training chunk's launches (4 + 2 a step) and each image's are
    asserted; train s/step, eval s/image, peak, the losses (finite), the
    four arms' IoUs beside the JAX package's committed ones; the standard
    arm's IoU must reach QUALITY_MIN_STANDARD_IOU. The params are saved for
    label_map_eval."""
    import os

    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import (
        RADIUS_X, RADIUS_Y)
    from deeplabv3plus_augmented_superresolution_tpu_torch.ops.shear_warp import (
        WARP_LAUNCHES)
    from deeplabv3plus_augmented_superresolution_tpu_torch.scripts import quality_demo
    from deeplabv3plus_augmented_superresolution_tpu_torch.scripts.common import (
        ARMS, TRAIN_CHUNK, sanitize, write_json)

    os.makedirs(QUALITY_DIR, exist_ok=True)
    npz = os.path.join(QUALITY_DIR, "quality_params.npz")
    log(f"[quality] train_steps {QUALITY_TRAIN_STEPS} (the script's default 400; the "
        "committed JAX results' 600)")
    log(f"[quality] eval_images {QUALITY_EVAL_IMAGES} (the script's default 20)")
    timer, losses = StageLaunches(), []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with LaunchWindow(device) as window:
        result = quality_demo.run_demo(
            train_steps=QUALITY_TRAIN_STEPS, eval_images=QUALITY_EVAL_IMAGES,
            warp_augment=True, save_params=npz, device=str(device), timer=timer,
            losses=losses, verbose=False)
    wall = time.perf_counter() - t0
    result = sanitize(result)
    write_json(os.path.join(QUALITY_DIR, "quality_demo.json"), result)

    chunks, images = timer.of("train_chunk"), timer.of("eval_image")
    steps = [min(TRAIN_CHUNK, QUALITY_TRAIN_STEPS - i) for i in
             range(0, QUALITY_TRAIN_STEPS, TRAIN_CHUNK)]
    per_step = {k: 2 * v for k, v in WARP_LAUNCHES.items()}   # images' warp + labels'
    per_image = expected_launches(SLICE_SR_TYPES,
                                  probes=(2 * RADIUS_Y + 1) * (RADIUS_X + 1))
    steady_step = sum(sec for sec, _ in chunks[1:]) / sum(steps[1:])
    first_step = chunks[0][0] - (steps[0] - 1) * steady_step
    image_s = [sec for sec, _ in images]
    log(f"[quality] train: {QUALITY_TRAIN_STEPS} steps in {len(chunks)} chunks, "
        f"{result['train_s']:.1f}s with the scenes' upload; steady "
        f"{steady_step:.4f} s/step over chunks 2-{len(chunks)}, first chunk "
        f"{chunks[0][0]:.2f}s (first step ~{first_step:.2f}s: the chunk less "
        f"{steps[0] - 1} steady steps); loss first {losses[0]:.4f} last {losses[-1]:.4f}")
    log(f"[quality] eval: {len(images)} images, steady {_steady(image_s):.3f} s/image "
        f"(first {image_s[0]:.3f}s), {result['eval_s']:.1f}s in all; the phase "
        f"{wall:.1f}s; peak memory {window.peak / 2**30:.2f} GiB")
    log(f"[quality] kernel launches {json.dumps(window.launches)}: per train step "
        f"{json.dumps(per_step)}, per eval image {json.dumps(per_image)}")
    for (_, got), n in zip(chunks, steps):
        if got != {k: n * v for k, v in per_step.items()}:
            raise AssertionError(f"[quality] a chunk of {n} steps launched {got}")
    for _, got in images:
        if got != per_image:
            raise AssertionError(f"[quality] an eval image launched {got}, expected "
                                 f"{per_image}")
    total = {k: QUALITY_TRAIN_STEPS * per_step[k] + QUALITY_EVAL_IMAGES * per_image[k]
             for k in per_step}
    if window.launches != total or len(images) != QUALITY_EVAL_IMAGES:
        raise AssertionError(f"[quality] {window.launches} launches in all, expected {total}")
    if len(losses) != QUALITY_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError("[quality] a training loss is not finite")
    iou = result["iou"]
    log(f"[quality] port (this run, {QUALITY_TRAIN_STEPS} steps, warp_augment, "
        f"{QUALITY_EVAL_IMAGES} scenes): IoU "
        + json.dumps({a: round(iou[a], 4) for a in ARMS}) + " with bg "
        + json.dumps({a: round(result["iou_with_bg"][a], 4) for a in ARMS})
        + f", aug - standard {result['aug_minus_standard']:+.4f}, win rate "
        f"{result['aug_win_rate_vs_standard']:.2f}")
    for line in _jax_quality_lines():
        log(f"[quality] {line}")
    if not (iou["standard"] is not None and iou["standard"] >= QUALITY_MIN_STANDARD_IOU):
        raise AssertionError(f"[quality] standard IoU {iou['standard']} under "
                             f"{QUALITY_MIN_STANDARD_IOU}: the model never left the "
                             "all-background basin")
    train_launches = {k: QUALITY_TRAIN_STEPS * v for k, v in per_step.items()}
    record = {"peak_bytes": window.peak, "steady_s_per_step": steady_step,
              "first_chunk_s": chunks[0][0], "steady_s_per_image": _steady(image_s),
              "loss_first": losses[0], "loss_last": losses[-1], "iou": iou,
              "iou_with_bg": result["iou_with_bg"],
              "aug_minus_standard": result["aug_minus_standard"]}
    paths = {"quality-train": {"launches": train_launches, **record},
             "quality-eval": {"launches": {k: window.launches[k] - train_launches[k]
                                           for k in per_step}}}
    return paths, npz


def phase_quality_scripts(device, npz):
    """The other quality scripts on the card, each at a smaller depth with
    its headline, seconds and launches: label_map_eval on quality_demo's
    params (classes 8 and 12, 3 scenes, 512 px, 100 copies, 300 steps),
    ab_stats (512 px, milestones 25 and 50, 3 scenes, 1000 resamples),
    per_class_validation (20 classes, --class_chunk 5, 25 training steps,
    the pool topped up to every class once), ab_cg_vs_adam (2 images) and
    ab_serving_vs_strict (2 variants of a synthetic scene holding class 8,
    handed over decoded, through quality_demo's params: the script's
    --weights_path)."""
    import os

    from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import build_deeplab
    from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import (
        synthetic_batch)
    from deeplabv3plus_augmented_superresolution_tpu_torch.scripts import (
        ab_cg_vs_adam, ab_serving_vs_strict, ab_stats, label_map_eval, per_class_validation)

    out = lambda name: os.path.join(QUALITY_DIR, name)   # noqa: E731
    dev = ["--device", str(device)]
    runs = {
        "quality-label-map": lambda: label_map_eval.main(
            ["--load_params", npz, "--eval_images", "3", "--out", out("label_map.json")]
            + dev),
        "quality-ab-stats": lambda: ab_stats.main(
            ["--milestones", "25", "50", "--train_set", "16", "--eval_images", "3",
             "--bootstrap", "1000", "--warp_augment", "--out", out("ab_stats.json")] + dev),
        "quality-per-class": lambda: per_class_validation.main(
            ["--num_classes", "20", "--class_chunk", "5", "--train_steps", "25",
             "--train_set", "16", "--scenes", "4", "--min_class_n", "1",
             "--out_prefix", out("per_class")] + dev),
        "quality-cg-vs-adam": lambda: ab_cg_vs_adam.main(["--num_images", "2"] + dev),
        "quality-serving-vs-strict": lambda: ab_serving_vs_strict.serving_vs_strict(
            synthetic_batch(np.random.default_rng(0), 1, require_class=8)[0][0],
            build_deeplab("xception", weights_path=npz, device=device), num_images=2,
            device=device),
    }
    headlines = {
        "quality-label-map": lambda r: {k: r[k] for k in (
            "label_map_mean_iou", "label_map_standard_mean_iou",
            "label_map_minus_standard", "win_rate_vs_standard")},
        "quality-ab-stats": lambda r: {m: {"iou": c["iou"], "delta": c[
            "aug_minus_standard"]["mean"], "ci95": c["aug_minus_standard"]["ci95"]}
            for m, c in r["calibration_curve"].items()},
        "quality-per-class": lambda r: {"scenes": r["scenes"], **{
            k: round(v, 4) for k, v in r["modes"]["argmax"]["class_avg"].items()}},
        "quality-cg-vs-adam": lambda r: r,
        "quality-serving-vs-strict": lambda r: r,
    }
    paths = {}
    for label, run in runs.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with LaunchWindow(device) as window:
            result = run()
        seconds = time.perf_counter() - t0
        log(f"[{label}] {seconds:.1f}s, peak memory {window.peak / 2**30:.2f} GiB, kernel "
            f"launches {json.dumps(window.launches)}; headline "
            + json.dumps(headlines[label](result)))
        if not any(window.launches.values()):
            raise AssertionError(f"[{label}] launched no kernel")
        paths[label] = {"launches": window.launches, "seconds": seconds,
                        "peak_bytes": window.peak}
    return paths


def phase_quality_all(device):
    """[quality]: quality_demo, then the other scripts on its params."""
    t0 = time.perf_counter()
    paths, npz = phase_quality(device)
    paths.update(phase_quality_scripts(device, npz))
    log(f"[quality] phase done in {time.perf_counter() - t0:.1f}s")
    return paths


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
    parser.add_argument("--sharded-only", action="store_true",
                        help="run only the [sharded] phase (after the build and the "
                             "stencil): prints no result line")
    parser.add_argument("--sharded-beta", type=float, nargs=2, metavar=("LO", "HI"),
                        default=SHARDED_BETA_RANGE,
                        help="with --sharded-only: the sharded training runs' start "
                             "draws every BN's beta from +-U(LO, HI)")
    parser.add_argument("--quality-only", action="store_true",
                        help="run only the [quality] phase (after the build): prints "
                             "no result line")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel phase (for tuning): prints no "
                             "result line")
    args = parser.parse_args()

    if tuple(args.sharded_beta) != SHARDED_BETA_RANGE:
        if not args.sharded_only:
            parser.error("--sharded-beta needs --sharded-only")
        globals()["SHARDED_BETA_RANGE"] = tuple(args.sharded_beta)
    if args.package_root:
        if not args.kernels_only:
            parser.error("--package-root needs --kernels-only")
        sys.path.insert(0, args.package_root)
    # The port itself first: outside a checkout this fails before any output.
    from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
        SEED, feature_size_of, make_sr_config)
    from deeplabv3plus_augmented_superresolution_tpu_torch.models import DeepLabConfig
    from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
        sample_augmentations)

    device = phase_device()
    t_start = time.perf_counter()
    phase_build()
    sr_cfg = make_sr_config(None, num_aug=100, angle_max=0.15)
    mob_sr_cfg = make_sr_config(
        None, num_aug=100, angle_max=0.15,
        feature_size=feature_size_of(DeepLabConfig(backbone="mobilenet")))
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED), 100,
                                          0.15, 80.0, device=device)
    if args.kernels_only:
        phase_kernel(device, angles, shifts)
        return
    if args.quality_only:
        phase_quality_all(device)
        return
    coeffs = phase_stencil(device, angles, shifts, sr_cfg, "Xception")
    if args.sharded_only:
        from deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr import (
            build_deeplab)

        images = make_images(args.seed, SHARDED_IMAGES)
        class_id = most_frequent_class(build_deeplab("xception", device=device),
                                       images[0][1], device)
        torch.cuda.empty_cache()
        phase_sharded(device, images, sr_cfg, class_id, angles, shifts, coeffs, args.seed)
        return
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
    paths.update(phase_serve_staged_gather(device, model, images, coeffs, sr_cfg,
                                           class_id, angles, shifts))
    paths["serve-20-classes"], paths["serve-20-classes-chunked"] = phase_serve_multiclass(
        device, model, images[:MULTI_IMAGES], coeffs, sr_cfg, angles, shifts)
    if args.stage_trace:
        phase_stage_trace(device, images, model, sr_cfg, class_id, coeffs)
    del model
    torch.cuda.empty_cache()
    paths["serve-mobilenet"] = phase_serve_mobilenet(
        device, images[:MOBILENET_IMAGES], mob_coeffs, mob_sr_cfg)
    paths.update(phase_train(device, images, coeffs, sr_cfg))
    paths["train-voc"] = phase_train_voc(device)
    # The evaluation workflow: staging, standard masks, SR evaluation with
    # the threshold study, the robustness grid.
    names, eval_images, eval_labels = eval_scenes(args.seed, ROBUST_IMAGES)
    staged, paths["staged"] = phase_staged(device, names[:EVAL_IMAGES],
                                           eval_images[:EVAL_IMAGES])
    standard, full_model, paths["standard"] = phase_standard(device,
                                                             eval_images[:EVAL_IMAGES])
    paths["sr-eval"], paths["threshold"] = phase_sr_eval(
        device, names[:EVAL_IMAGES], eval_labels, staged, standard)
    del staged
    paths["robustness"] = phase_robustness(device, full_model, eval_images, eval_labels)
    del full_model
    torch.cuda.empty_cache()
    paths.update(phase_sharded(device, images, sr_cfg, class_id, angles, shifts, coeffs,
                               args.seed))
    kernel_results = phase_kernel(device, angles, shifts)
    phase_small_e2e(device)
    phase_operator_small(device)
    phase_train_small(device)
    phase_eval_small(device)
    paths.update(phase_quality_all(device))
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
    log("[done] serving, training and evaluation paths " + json.dumps(
        {label: {k: v for k, v in p.items() if k != "launches"}
         for label, p in paths.items()}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
