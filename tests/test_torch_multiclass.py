"""Port parity: max/mean SR, the multi-class OPM, the label map and
asr_step_multiclass.

The same numpy masks, logits, image, params, angles and shifts go through
the JAX package and the PyTorch port (plain versions on the CPU). The
jitted JAX references are computed once per module. The step runs
MobileNetV2 at 64 px (feature 8: the serving decimation factor 8 of
MobileNetV2), 4 copies, 3 classes, 10 serving AMSGrad steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.metrics import mean_iou as j_mean_iou
from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.opm import (
    extract_masks_multiclass as j_extract_multiclass,
)
from deeplabv3plus_augmented_superresolution_tpu.pipeline import (
    asr_step as j_asr_step,
    asr_step_multiclass as j_asr_step_multiclass,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    combine_label_map as j_combine_label_map,
    max_mean_superresolution as j_max_mean,
    max_superresolution as j_max,
    mean_superresolution as j_mean,
)
from deeplabv3plus_augmented_superresolution_tpu.sr.solver import (
    multiclass_max_mean_superresolution as j_multiclass_max_mean,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.metrics import mean_iou
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig,
    build_model,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.opm import (
    extract_masks,
    extract_masks_multiclass,
    prepare_sr_inputs,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    asr_step,
    asr_step_multiclass,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    LABEL_MAP_RULES,
    OptimizerConfig,
    SRConfig,
    augmented_superresolution,
    combine_label_map,
    max_mean_superresolution,
    max_superresolution,
    mean_superresolution,
    multiclass_max_mean_superresolution,
    precompute_gram_stencil,
)
from test_torch_shear import EXACT_COMPILE, jax_init_params, run_fast

torch.set_num_threads(1)


SERVING_OPT = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True,
                   decay_steps=60, decay_rate=0.3)
MODEL = dict(input_shape=(64, 64, 3), backbone="mobilenet", final_upsample=False)
SR = dict(num_aug=4, feature_size=(8, 8), output_size=(64, 64), angle_max=0.15,
          num_iter=30, solver_impl="gram")
# The steps: 10 AMSGrad steps are enough to hold the pipelines against each
# other; the solver's parity over 30 and 300 steps is test_torch_solver's.
STEP_SR = dict(SR, num_iter=10)
SLICE_MAX = dict(mode="slice_max", th_factor=0.2, sr_types=("aug", "max", "mean"),
                 return_targets=True)
# The three classes the random model predicts on the test image (each on
# 20-35% of the standard mask), so that no SR target is noise.
CLASSES = (2, 17, 18)


def _tta(n, seed, angle_max=0.15, shift_max=6.0):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-angle_max, angle_max, n).astype(np.float32)
    shifts = rng.uniform(-shift_max, shift_max, (n, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    return angles, shifts


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- max / mean SR ----------------------------------------------------------

@pytest.fixture(scope="module")
def max_mean_case():
    """Masks (K=3, N=4, 8, 8, 1) -> 64 px through the JAX functions, once,
    as one jitted program (one compile for the four)."""
    angles, shifts = _tta(4, 1)
    masks = np.random.default_rng(2).uniform(0, 1, (3, 4, 8, 8, 1)).astype(np.float32)
    cfg = JSRConfig(**SR)

    def all_four(m, a, s):
        return {"max": j_max(m[0], a, s, cfg)[0], "mean": j_mean(m[0], a, s, cfg)[0],
                "max_mean": j_max_mean(m[0], a, s, cfg),
                "multiclass": j_multiclass_max_mean(m, a, s, cfg)}

    ref = jax.tree.map(np.asarray, run_fast(jax.jit(all_four), jnp.asarray(masks),
                                            jnp.asarray(angles), jnp.asarray(shifts)))
    return masks, angles, shifts, ref


@pytest.mark.parametrize("kind", ["max", "mean", "max_mean", "multiclass"])
def test_max_mean_sr_match_jax(max_mean_case, kind):
    """Upsample + inverse Paeth warp + reduction over the copies, f32 on both
    sides: 1e-5 (the warp parity's f32 tap weights)."""
    masks, angles, shifts, ref = max_mean_case
    cfg = SRConfig(**SR)
    ta, ts = _t(angles, shifts)
    if kind == "max":
        got, none = max_superresolution(torch.from_numpy(masks[0]), ta, ts, cfg)
        assert none is None and got.shape == (64, 64, 1)
        np.testing.assert_allclose(got.numpy(), ref["max"], atol=1e-5)
    elif kind == "mean":
        got, none = mean_superresolution(torch.from_numpy(masks[0]), ta, ts, cfg)
        assert none is None and got.shape == (64, 64, 1)
        np.testing.assert_allclose(got.numpy(), ref["mean"], atol=1e-5)
    else:
        if kind == "max_mean":
            got = max_mean_superresolution(torch.from_numpy(masks[0]), ta, ts, cfg)
        else:
            got = multiclass_max_mean_superresolution(torch.from_numpy(masks), ta, ts,
                                                      cfg)
        for ours, theirs in zip(got, ref[kind]):
            assert ours.shape == theirs.shape
            np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5)


def test_max_mean_of_classes_equal_single_class_runs(max_mean_case):
    """The class planes share the inverse warp: slice k of the multi-class
    stack is the single-class result bit for bit; with the last copy padding
    (num_valid, its masks junk) max and mean are those of the real copies
    alone (held against JAX in test_torch_parallel.py)."""
    masks, angles, shifts, _ = max_mean_case
    cfg = SRConfig(**SR)
    ta, ts = _t(angles, shifts)
    mx, mean = multiclass_max_mean_superresolution(torch.from_numpy(masks), ta, ts, cfg)
    for k in range(3):
        single = max_mean_superresolution(torch.from_numpy(masks[k]), ta, ts, cfg)
        assert torch.equal(mx[k], single[0]) and torch.equal(mean[k], single[1])
    n = cfg.num_aug
    junk = torch.from_numpy(masks[0]).clone()
    junk[n - 1] = 7.0
    real = dataclasses.replace(cfg, num_aug=n - 1)
    for fn in (max_superresolution, mean_superresolution):
        got = fn(junk, ta, ts, dataclasses.replace(cfg, num_valid=n - 1))[0]
        want = fn(junk[:n - 1], ta[:n - 1], ts[:n - 1], real)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---- OPM and label map ------------------------------------------------------

@pytest.mark.parametrize("mode", ["argmax", "slice", "slice_max"])
def test_extract_masks_multiclass_exact(mode):
    """Slice k equals extract_masks(class_ids[k]) exactly (ties in the logits
    included, where slice_max takes the second-largest logit), and the JAX
    multi-class OPM to f32 rounding of the min-max normalization (1e-6;
    argmax exactly)."""
    rng = np.random.default_rng(7)
    preds = rng.standard_normal((3, 6, 6, 21)).astype(np.float32)
    preds[0, 0, 0, 8] = preds[0, 0, 0].max()  # a tie at the top for class 8
    preds[0, 0, 1, 3] = preds[0, 0, 1].max()
    class_ids = (3, 8, 15)
    tp = torch.from_numpy(preds)
    masks, max_masks = extract_masks_multiclass(tp, class_ids, mode)
    assert masks.shape == (3, 3, 6, 6, 1)
    for k, c in enumerate(class_ids):
        single, single_max = extract_masks(tp, c, mode)
        assert torch.equal(masks[k], single)
        assert (max_masks is None) == (single_max is None)
        if single_max is not None:
            assert torch.equal(max_masks[k], single_max)
    j_masks, j_max_masks = j_extract_multiclass(jnp.asarray(preds),
                                                jnp.asarray(class_ids), mode)
    np.testing.assert_allclose(masks.numpy(), np.asarray(j_masks),
                               atol=0 if mode == "argmax" else 1e-6)
    if max_masks is not None:
        np.testing.assert_array_equal(max_masks.numpy(), np.asarray(j_max_masks))
    # prepare_sr_inputs normalizes each class of a class stack on its own
    norm, _ = prepare_sr_inputs(masks, max_masks, mode)
    for k, c in enumerate(class_ids):
        single, single_max = prepare_sr_inputs(*extract_masks(tp, c, mode), mode)
        assert torch.equal(norm[k], single)


@pytest.mark.parametrize("rule", LABEL_MAP_RULES)
def test_combine_label_map_matches_jax(rule):
    """Every rule, exactly: the same f32 divisions and the first maximum on
    ties (two classes share a peak pixel here)."""
    rng = np.random.default_rng(9)
    targets = rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)
    targets[1] *= 0.4                       # below the gate: absent under "gated"
    targets[2, 3, 3] = targets[0, 3, 3] = 1.0
    ids = (3, 8, 15)
    ref = np.asarray(j_combine_label_map(jnp.asarray(targets), jnp.asarray(ids), 0.2,
                                         rule=rule))
    ours = combine_label_map(torch.from_numpy(targets), ids, 0.2, rule=rule)
    assert ours.shape == (16, 16, 1)
    np.testing.assert_array_equal(ours.numpy(), ref)
    with pytest.raises(ValueError, match="rule"):
        combine_label_map(torch.from_numpy(targets), ids, 0.2, rule="nope")


def test_mean_iou_matches_jax_on_label_maps():
    """The label map's score: mean IoU over the classes present in the GT
    (255 ignored as a class), as the JAX metric, to f32 rounding (1e-6)."""
    rng = np.random.default_rng(10)
    gt = rng.choice([0, 3, 8, 15, 255], size=(32, 32, 1)).astype(np.float32)
    pred = np.where(rng.uniform(size=gt.shape) < 0.7, gt, rng.choice([0, 8, 12], gt.shape))
    pred[pred == 255] = 0
    ours = mean_iou(gt, pred)
    assert 0.0 < ours < 1.0
    assert ours == pytest.approx(float(j_mean_iou(jnp.asarray(gt), jnp.asarray(pred))),
                                 abs=1e-6)


# ---- the batched class solve ------------------------------------------------

def test_batched_class_solve_equals_single_solves():
    """K solves in one loop (one stencil, an AMSGrad state per element) give
    each class's single solve exactly; the losses to f32 summation order."""
    angles, shifts = _tta(4, 3)
    masks = np.random.default_rng(4).uniform(0, 1, (3, 4, 8, 8, 1)).astype(np.float32)
    cfg = SRConfig(**{**SR, "num_iter": 10}, optimizer=OptimizerConfig(**SERVING_OPT))
    ta, ts = _t(angles, shifts)
    coeffs = precompute_gram_stencil(ta, ts, cfg)
    batch, losses = augmented_superresolution(torch.from_numpy(masks), ta, ts, cfg,
                                              gram_coeffs=coeffs)
    assert batch.shape == (3, 64, 64, 1) and losses.shape == (3,)
    for k in range(3):
        single, loss = augmented_superresolution(torch.from_numpy(masks[k]), ta, ts,
                                                 cfg, gram_coeffs=coeffs)
        assert torch.equal(batch[k], single)
        np.testing.assert_allclose(float(losses[k]), float(loss), rtol=1e-6)


# ---- asr_step_multiclass ----------------------------------------------------

@pytest.fixture(scope="module")
def step_case():
    """One image through the JAX asr_step_multiclass and the port's; and the
    reference's one-class asr_step in slice_max mode on that image and a
    second one, as the reference CLI's batched program runs it
    (jax.vmap of asr_step over the images). The JAX steps run as one jitted
    program, so XLA compiles their shared warp and forward once. Both sides
    take the port's stencil (held against the reference's at this
    decimation factor in test_torch_mobilenet), which spares the reference
    an inline extraction in its compile."""
    params = jax_init_params(JDeepLabConfig(**MODEL), seed=0)
    model = build_model(DeepLabConfig(**MODEL), params=params, device="cpu")
    image = np.random.default_rng(3).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    second = np.random.default_rng(23).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    images = np.stack([image, second])
    angles, shifts = _tta(4, 4)
    kw = dict(th_factor=0.2, sr_types=("aug", "max", "mean"), return_targets=True,
              return_label_map=True)
    sr_cfg = SRConfig(**STEP_SR, optimizer=OptimizerConfig(**SERVING_OPT))
    ta, ts = _t(angles, shifts)
    coeffs = precompute_gram_stencil(ta, ts, sr_cfg)
    cfgs = (JDeepLabConfig(**MODEL),
            JSRConfig(**STEP_SR, optimizer=JOptimizerConfig(**SERVING_OPT)))

    def both(params, images, angles, shifts, coeffs):
        return (j_asr_step_multiclass(params, images[0], angles, shifts, *cfgs,
                                      class_ids=CLASSES, gram_coeffs=coeffs, **kw),
                jax.vmap(lambda im: j_asr_step(params, im, angles, shifts, *cfgs,
                                               class_id=CLASSES[0], gram_coeffs=coeffs,
                                               **SLICE_MAX))(images))

    ref, ref_slice_max = run_fast(jax.jit(both), params, jnp.asarray(images),
                                  jnp.asarray(angles), jnp.asarray(shifts),
                                  jnp.asarray(coeffs.numpy()), options=EXACT_COMPILE)
    ours = asr_step_multiclass(model, torch.from_numpy(image), ta, ts, sr_cfg, CLASSES,
                               gram_coeffs=coeffs, **kw)
    return dict(model=model, image=torch.from_numpy(image),
                images=torch.from_numpy(images), angles=ta, shifts=ts,
                sr_cfg=sr_cfg, coeffs=coeffs, kw=kw,
                ref={k: np.asarray(v) for k, v in ref.items()}, ours=ours,
                ref_slice_max={k: np.asarray(v) for k, v in ref_slice_max.items()})


def test_asr_step_multiclass_matches_jax(step_case):
    """The bounds of test_asr_step_matches_jax: masks agree on >= 99% of
    pixels (argmax of logits equal to ~1e-6), targets within 5e-3 (Adam's
    normalized steps); the label maps likewise."""
    ours, ref = step_case["ours"], step_case["ref"]
    assert set(ours) == set(ref)
    for key in ("aug", "max", "mean", "standard"):
        assert ours[key].shape == (3, 64, 64, 1)
        for k, c in enumerate(CLASSES):
            assert set(np.unique(ours[key][k].numpy())) <= {0.0, float(c)}
        agree = float((ours[key].numpy() == ref[key]).mean())
        assert agree >= 0.99, (key, agree)
    for key in ("aug_target", "max_target", "mean_target"):
        err = np.abs(ours[key].numpy() - ref[key]).max()
        assert err <= 5e-3, (key, err)
    for key in ("label_map", "label_map_standard"):
        assert ours[key].shape == (64, 64, 1)
        assert float((ours[key].numpy() == ref[key]).mean()) >= 0.99, key
    for k in range(len(CLASSES)):
        assert float((ours["standard"][k] > 0).float().mean()) > 0.1


def _check_slice_max(ours, ref, shape):
    """The bounds of test_asr_step_matches_jax: masks agree on >= 99% of
    pixels, targets within 5e-3."""
    assert set(ours) == set(ref) == {"aug", "max", "mean", "standard", "aug_target",
                                     "max_target", "mean_target"}
    for key in ("aug", "max", "mean", "standard"):
        assert ours[key].shape == shape
        assert set(np.unique(ours[key].numpy())) <= {0.0, float(CLASSES[0])}
        agree = float((ours[key].numpy() == ref[key]).mean())
        assert agree >= 0.99, (key, agree)
    for key in ("aug_target", "max_target", "mean_target"):
        err = np.abs(ours[key].numpy() - ref[key]).max()
        assert err <= 5e-3, (key, err)


def test_asr_step_slice_max_matches_jax(step_case):
    """The one-class asr_step with aug, max and mean through slice_max, where
    a second stack (the max over the other classes' logits), warped and
    solved alike, sets each threshold, against the JAX asr_step on the same
    inputs, at the bounds of test_asr_step_matches_jax: masks agree on >= 99%
    of pixels, targets within 5e-3."""
    c = step_case
    ref = {k: v[0] for k, v in c["ref_slice_max"].items()}
    ours = asr_step(c["model"], c["image"], c["angles"], c["shifts"], c["sr_cfg"],
                    CLASSES[0], gram_coeffs=c["coeffs"], **SLICE_MAX)
    _check_slice_max(ours, ref, (64, 64, 1))
    assert 0.05 < float((ours["aug"] > 0).float().mean()) < 0.95


def test_asr_step_batch_matches_jax_vmap(step_case):
    """Both images as one (2, 64, 64, 3) batch through the port's asr_step
    (one copies warp and one forward for the 8 copies, b, the solve and the
    inverse warp on 2 planes, each for the class and the max stack) against
    the reference's jax.vmap of asr_step, aug + max + mean in slice_max
    mode: every mask and target of each image, at the single step's
    bounds."""
    c = step_case
    ours = asr_step(c["model"], c["images"], c["angles"], c["shifts"], c["sr_cfg"],
                    CLASSES[0], gram_coeffs=c["coeffs"], **SLICE_MAX)
    _check_slice_max(ours, c["ref_slice_max"], (2, 64, 64, 1))
    for i in range(2):
        assert 0.05 < float((ours["aug"][i] > 0).float().mean()) < 0.95


def test_asr_step_multiclass_slices_match_asr_step(step_case):
    """Slice k is asr_step(class_id=class_ids[k]): the class planes share
    every warp, so the targets agree to 1e-6 and the masks exactly."""
    c = step_case
    multi = c["ours"]
    for k, cid in enumerate(CLASSES):
        single = asr_step(c["model"], c["image"], c["angles"], c["shifts"], c["sr_cfg"],
                          cid, th_factor=0.2, sr_types=("aug", "max", "mean"),
                          gram_coeffs=c["coeffs"], return_targets=True)
        assert set(single) == set(multi) - {"label_map", "label_map_standard"}
        for key, value in single.items():
            np.testing.assert_allclose(multi[key][k].numpy(), value.numpy(), atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("class_chunk", [1, 2])
def test_class_chunk_matches_unchunked(step_case, class_chunk):
    """Groups of 1 or 2 of the 3 classes (the last group ragged) give the
    unchunked results exactly."""
    c = step_case
    out = asr_step_multiclass(c["model"], c["image"], c["angles"], c["shifts"],
                              c["sr_cfg"], CLASSES, class_chunk=class_chunk,
                              gram_coeffs=c["coeffs"], **c["kw"])
    assert set(out) == set(c["ours"])
    for key, value in out.items():
        assert torch.equal(value, c["ours"][key]), key
