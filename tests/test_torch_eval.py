"""Port parity of the evaluation workflow's modules: the IoU metrics (numpy
and tensor) and the training metrics, the data paths, the hdf5 staging
format both ways, ``augmented_feature_maps`` and ``compute_sr``.

The same numpy inputs go through the JAX package and the port (its plain
versions on the CPU); each JAX reference is one jitted program.
"""

import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu import metrics as j_metrics
from deeplabv3plus_augmented_superresolution_tpu.data import io as j_io
from deeplabv3plus_augmented_superresolution_tpu.data import paths as j_paths
from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig,
)
from deeplabv3plus_augmented_superresolution_tpu.pipeline import (
    augmented_feature_maps as j_augmented_feature_maps,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
    precompute_gram_stencil as j_precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu.sr.orchestrate import (
    compute_sr as j_compute_sr,
)
from deeplabv3plus_augmented_superresolution_tpu_torch import metrics
from deeplabv3plus_augmented_superresolution_tpu_torch.data import io, paths
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig,
    build_model,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.feature_maps import (
    augmented_feature_maps,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OptimizerConfig,
    SRConfig,
    precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr.orchestrate import compute_sr
from test_torch_shear import EXACT_COMPILE, jax_init_params, run_fast

torch.set_num_threads(1)

MOBILENET = dict(input_shape=(64, 64, 3), backbone="mobilenet", final_upsample=False)


def _labels():
    """Three (12, 12) GT / prediction pairs with the void label 255 and
    classes absent from either side; the third GT holds no class."""
    rng = np.random.default_rng(0)
    gt = rng.choice([0, 2, 3, 20, 255], (3, 12, 12)).astype(np.int32)
    pred = rng.choice([0, 1, 2, 3, 5], (3, 12, 12)).astype(np.int32)
    gt[2] = 255
    return gt, pred


def test_iou_metrics_numpy_and_tensor_match_jax():
    """mean_iou and single_class_iou (alone and with the background; a class
    present, one absent everywhere, class 0): the port's numpy versions and
    its batched tensor versions equal the JAX package's per image to 1e-6,
    NaN where the JAX value is NaN (an image without a class, an empty
    union)."""
    gt, pred = _labels()
    combos = [(c, bg) for c in (0, 3, 7) for bg in (False, True)]
    # Every reference value in one jitted program, one image per vmap lane.
    want, singles = run_fast(jax.jit(lambda g, p: (
        jax.vmap(j_metrics.mean_iou)(g, p),
        [jax.vmap(lambda a, b, c=c, bg=bg: j_metrics.single_class_iou(a, b, c, bg))(g, p)
         for c, bg in combos])), jnp.asarray(gt), jnp.asarray(pred))
    want = np.asarray(want)
    assert np.isnan(want[2]) and not np.isnan(want[:2]).any()
    got_np = np.array([metrics.mean_iou(gt[i], pred[i]) for i in range(3)])
    got_t = metrics.batch_mean_iou(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    np.testing.assert_allclose(got_np, want, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got_t, want, rtol=1e-6, equal_nan=True)
    for (class_id, include_bg), want in zip(combos, singles):
        want = np.asarray(want)
        got_np = np.array([metrics.compute_iou(gt[i], pred[i], class_id=class_id,
                                               include_bg=include_bg) for i in range(3)])
        got_t = metrics.batch_single_class_iou(torch.from_numpy(gt), torch.from_numpy(pred),
                                               class_id, include_bg).numpy()
        np.testing.assert_allclose(got_np, want, rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(got_t, want, rtol=1e-6, equal_nan=True)


def test_training_metrics_match_jax():
    """The reference's training metrics from (2, 6, 6, 5) logits against
    labels with 255 and one label outside the classes: cross-entropy per
    pixel 1e-5, accuracy and batched mean IoU 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 6, 6, 5)).astype(np.float32)
    labels = rng.choice([0, 1, 2, 4, 5, 255], (2, 6, 6, 1)).astype(np.int32)
    lt, ll = torch.from_numpy(logits), torch.from_numpy(labels)
    names = ("sparse_accuracy_ignoring_last_label", "sparse_mean_iou")
    ce, *wants = run_fast(jax.jit(lambda y, x: [
        getattr(j_metrics, name)(y, x)
        for name in ("sparse_crossentropy_ignoring_last_label",) + names]),
        jnp.asarray(labels), jnp.asarray(logits))
    np.testing.assert_allclose(
        metrics.sparse_crossentropy_ignoring_last_label(ll, lt).numpy(), np.asarray(ce),
        atol=1e-5)
    for name, want in zip(names, wants):
        got = float(getattr(metrics, name)(ll, lt))
        assert abs(got - float(want)) <= 1e-6, (name, got, float(want))


def test_paths_match_jax(tmp_path):
    """The image list (numeric VOC ids and other names, sorted or not), the
    class filter over GT masks (all, and stopping at one), the staged-file
    listing and the two directory names equal the JAX package's."""
    voc = tmp_path / "JPEGImages"
    gt_dir = tmp_path / "SegmentationClassAug"
    voc.mkdir()
    gt_dir.mkdir()
    names = ["2007_000010", "2007_000002", "scene_b", "scene_a"]
    for i, name in enumerate(names):
        (voc / f"{name}.jpg").write_bytes(b"")
        mask = np.zeros((8, 8), np.uint8)
        mask[2:5, 2:5] = 8 if i % 2 == 0 else 3
        Image.fromarray(mask, mode="L").save(gt_dir / f"{name}.png")
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(names))
    for sort in (True, False):
        assert paths.get_img_paths(str(listing), str(voc), sort=sort) == \
            j_paths.get_img_paths(str(listing), str(voc), sort=sort)
    image_paths = paths.get_img_paths(str(listing), str(voc))
    for num_images in (None, 1):
        got = paths.filter_images_by_class(image_paths, 8, num_images, image_size=(8, 8))
        assert got == j_paths.filter_images_by_class(image_paths, 8, num_images,
                                                     image_size=(8, 8))
    assert len(paths.filter_images_by_class(image_paths, 8, image_size=(8, 8))) == 2
    staged = tmp_path / "staged" / "sub"
    staged.mkdir(parents=True)
    for name in ("2007_000003.hdf5", "b.hdf5", "a.txt"):
        (staged / name).write_bytes(b"")
    for sort in (True, False):
        assert sorted(paths.list_precomputed_data_paths(str(tmp_path / "staged"), sort)) \
            == sorted(j_paths.list_precomputed_data_paths(str(tmp_path / "staged"), sort))
    assert paths.list_precomputed_data_paths(str(tmp_path / "staged"), True) == \
        j_paths.list_precomputed_data_paths(str(tmp_path / "staged"), True)
    for args in (("r", "xception", "argmax", 8, 100, False), ("r", "mobilenet", "slice", 3, 4, True)):
        assert paths.augmented_copies_dir(*args) == j_paths.augmented_copies_dir(*args)
        no_mode = (args[0], args[1], args[3], args[5])
        assert paths.standard_output_dir(*no_mode) == j_paths.standard_output_dir(*no_mode)


@pytest.mark.parametrize("mode", ["argmax", "slice_max"])
def test_hdf5_staging_reads_both_ways(mode, tmp_path):
    """A file written by either package loads in the other: the same
    datasets and attributes, the normalized stacks to 1e-6 (float32
    min-max), angles, shifts and name exactly; a file with fewer copies than
    asked is invalid on both sides."""
    rng = np.random.default_rng(2)
    if mode == "argmax":
        class_masks = rng.choice([0.0, 8.0], (5, 8, 8, 1)).astype(np.float32)
        max_masks = None
    else:
        class_masks = rng.normal(0, 3, (5, 8, 8, 1)).astype(np.float32)
        max_masks = rng.normal(1, 3, (5, 8, 8, 1)).astype(np.float32)
    angles = rng.uniform(-0.3, 0.3, 5).astype(np.float32)
    shifts = rng.uniform(-30, 30, (5, 2)).astype(np.float32)
    args = ("img", class_masks, angles, shifts, mode, 0.3, 30)
    ours = io.write_augmented_hdf5(str(tmp_path / "port"), *args, max_masks=max_masks)
    theirs = j_io.write_augmented_hdf5(str(tmp_path / "jax"), *args, max_masks=max_masks)
    with h5py.File(ours) as a, h5py.File(theirs) as b:
        assert sorted(a) == sorted(b) and dict(a.attrs) == dict(b.attrs)
    for path in (ours, theirs):
        got = io.load_sr_data(path, num_aug=4)
        want = j_io.load_sr_data(path, num_aug=4)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
        if mode == "slice_max":
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
        else:
            assert got[1] is None and want[1] is None
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        assert got[4] == want[4] == "img"
        with pytest.raises(ValueError, match="invalid"):
            io.load_sr_data(path, num_aug=6)
        with pytest.raises(ValueError, match="invalid"):
            j_io.load_sr_data(path, num_aug=6)


@pytest.fixture(scope="module")
def mobilenet():
    """MobileNetV2 at 64 px (one Keras-named param dict in both packages), an
    image, 4 copies' draws and the JAX feature maps in slice_max mode: the
    class logits and the max of the other logits."""
    jcfg = JDeepLabConfig(**MOBILENET)
    params = jax_init_params(jcfg, seed=0)
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    angles = rng.uniform(-0.15, 0.15, 4).astype(np.float32)
    shifts = rng.uniform(-6, 6, (4, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    args = (params, jnp.asarray(image), jnp.asarray(angles), jnp.asarray(shifts))
    ref = j_augmented_feature_maps.lower(*args, jcfg, 8, "slice_max", 4, 0).compile(
        EXACT_COMPILE)(*args)
    model = build_model(DeepLabConfig(**MOBILENET), params=params, device="cpu")
    return model, image, angles, shifts, [np.asarray(m) for m in ref]


@pytest.mark.parametrize("chunk_size", [0, 2])
def test_augmented_feature_maps_match_jax(mobilenet, chunk_size):
    """The copies warp, the forward (in one batch, or in chunks of 2 of the 4
    copies) and the OPM masks: slice_max's class and max logits within 1e-4
    of their scale; the argmax masks (values {0, 8}) equal, on >= 99% of
    pixels (an f32 near-tie may flip), the class where its logit beats the
    others' max in the JAX logits."""
    model, image, angles, shifts, (cls_ref, max_ref) = mobilenet
    args = (model, torch.from_numpy(image), torch.from_numpy(angles),
            torch.from_numpy(shifts), 8)
    cls, mx = augmented_feature_maps(*args, mode="slice_max", num_aug=4,
                                     chunk_size=chunk_size)
    scale = np.abs(cls_ref).max()
    assert cls.shape == mx.shape == (4, 8, 8, 1)
    np.testing.assert_allclose(cls.numpy(), cls_ref, atol=1e-4 * scale)
    np.testing.assert_allclose(mx.numpy(), max_ref, atol=1e-4 * scale)
    masks, none = augmented_feature_maps(*args, mode="argmax", num_aug=4,
                                         chunk_size=chunk_size)
    assert none is None and set(np.unique(masks.numpy())) <= {0.0, 8.0}
    assert float((masks.numpy() == np.where(cls_ref > max_ref, 8.0, 0.0)).mean()) >= 0.99


@pytest.fixture(scope="module")
def sr_case():
    """Normalized class and max stacks of 3 copies at 16 px, their draws,
    and each package's own stencil for them (64 px)."""
    rng = np.random.default_rng(4)
    cls = rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)
    mx = rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)
    angles = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    shifts = rng.uniform(-4, 4, (3, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    kw = dict(num_aug=3, feature_size=(16, 16), output_size=(64, 64), angle_max=0.15,
              num_iter=5, solver_impl="gram")
    opt = dict(learning_rate=1e-2, amsgrad=True, lr_scheduler=True, decay_steps=60,
               decay_rate=0.3)
    cfg = SRConfig(**kw, optimizer=OptimizerConfig(**opt))
    jcfg = JSRConfig(**kw, optimizer=JOptimizerConfig(**opt))
    coeffs = precompute_gram_stencil(torch.from_numpy(angles), torch.from_numpy(shifts), cfg)
    j_coeffs = run_fast(jax.jit(j_precompute_gram_stencil, static_argnames="cfg"),
                        jnp.asarray(angles), jnp.asarray(shifts), cfg=jcfg)
    return cls, mx, angles, shifts, cfg, jcfg, (coeffs, j_coeffs)


@pytest.mark.parametrize("sr_type", ["aug", "max", "mean"])
@pytest.mark.parametrize("threshold", ["th_factor", "th_mask"])
def test_compute_sr_matches_jax(sr_case, sr_type, threshold, tmp_path):
    """compute_sr of each SR type, thresholded at 0.2 of the peak or against
    the max stack's target (slice_max's class-vs-max contest): (64, 64, 1)
    masks valued {0, 8}, equal to the JAX package's on >= 99.9% of pixels
    (targets agree to ~1e-6; a pixel at the threshold may flip); the same
    image files written."""
    cls, mx, angles, shifts, cfg, jcfg, (coeffs, j_coeffs) = sr_case
    max_masks = mx if threshold == "th_mask" else None
    kw = dict(sr_type=sr_type, class_id=8, th_factor=0.2, save_intermediate_output=True,
              save_final_output=True)
    ours = compute_sr(cfg, torch.from_numpy(cls), torch.from_numpy(angles),
                      torch.from_numpy(shifts), "img", dest_folder=str(tmp_path / "port"),
                      max_masks=None if max_masks is None else torch.from_numpy(max_masks),
                      gram_coeffs=coeffs if sr_type == "aug" else None, **kw)
    ref = np.asarray(j_compute_sr(
        jcfg, jnp.asarray(cls), jnp.asarray(angles), jnp.asarray(shifts), "img",
        dest_folder=str(tmp_path / "jax"),
        max_masks=None if max_masks is None else jnp.asarray(max_masks),
        gram_coeffs=j_coeffs if sr_type == "aug" else None, **kw))
    assert ours.shape == ref.shape == (64, 64, 1)
    assert set(np.unique(ours)) <= {0.0, 8.0} and 0.0 < float((ours > 0).mean()) < 1.0
    assert float((ours == ref).mean()) >= 0.999
    assert sorted(os.listdir(tmp_path / "port" / f"{sr_type}_SR")) == \
        sorted(os.listdir(tmp_path / "jax" / f"{sr_type}_SR"))
    with pytest.raises(ValueError, match="SR_type"):
        compute_sr(cfg, torch.from_numpy(cls), torch.from_numpy(angles),
                   torch.from_numpy(shifts), "img", sr_type="median")
