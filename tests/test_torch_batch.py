"""The port's batched step and serving loop, per-image augmentation sets, the
native decode ring, and copy dropout in the CLI (ROADMAP F6).

A batch of B images rides the kernels' channel axis and one solve; each of
its results must equal the image's own step. These comparisons are within
the port, on a stub network (the JAX reference of the batched step,
``jax.vmap(asr_step)`` on MobileNetV2, is held in test_torch_multiclass.py, which
shares its compile); the native ring is held bit for bit against the JAX
package's ring. 32 px, 4 copies, 5 serving AMSGrad steps.
"""

import os
import shutil
import zlib

import numpy as np
import pytest
import torch

from deeplabv3plus_augmented_superresolution_tpu.data import (
    native_loader as j_native_loader,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import SRConfig as JSRConfig
from deeplabv3plus_augmented_superresolution_tpu.sr.solver import (
    _dropout_weights as j_dropout_weights,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import run_asr
from deeplabv3plus_augmented_superresolution_tpu_torch.data import native_loader
from deeplabv3plus_augmented_superresolution_tpu_torch.models import DeepLabConfig
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    asr_step,
    asr_step_multiclass,
    sample_augmentations,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.augment import (
    image_generator,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OptimizerConfig,
    SRConfig,
    dropout_weights,
    precompute_gram_stencil,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_IMG = os.path.join(REPO, "test_images", "smoke_input.jpg")
SERVING_OPT = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True,
                   decay_steps=60, decay_rate=0.3)
SR = SRConfig(num_aug=4, feature_size=(8, 8), output_size=(32, 32), angle_max=0.15,
              num_iter=5, solver_impl="gram", optimizer=OptimizerConfig(**SERVING_OPT))
# A batch's targets against the images' own: the same arithmetic per plane
# but sums over stacks, so f32 rounding only.
TARGET_ATOL = 1e-5


class _StubModel(torch.nn.Module):
    """Logits that favour class 8 where the red channel is bright and class
    12 where the green one is, copy by copy: a network fast enough for many
    steps and serving runs (the real networks' batched forward is held
    against jax.vmap(asr_step) in test_torch_multiclass.py)."""

    def __init__(self, size=16):
        super().__init__()
        self.cfg = DeepLabConfig(input_shape=(size, size, 3), final_upsample=False)

    def forward(self, images):
        logits = torch.zeros(images.shape[0], images.shape[1] // 4,
                             images.shape[2] // 4, 21)
        logits[..., 8] = images[:, ::4, ::4, 0].float() * 2.0
        logits[..., 12] = images[:, 1::4, 1::4, 1].float() * 2.0
        logits[..., 0] = 1.0
        return logits


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    angles = rng.uniform(-0.15, 0.15, 4).astype(np.float32)
    shifts = rng.uniform(-3, 3, (4, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    angles, shifts = torch.from_numpy(angles), torch.from_numpy(shifts)
    coeffs = precompute_gram_stencil(angles, shifts, SR)
    return _StubModel(32), images, angles, shifts, coeffs


def _assert_batch_equals_singles(batch_out, single_outs):
    for key, value in batch_out.items():
        for i, single in enumerate(single_outs):
            if key.endswith("_target"):
                torch.testing.assert_close(value[i], single[key], rtol=0,
                                           atol=TARGET_ATOL)
            else:
                assert torch.equal(value[i], single[key]), (key, i)


def test_asr_step_batch_equals_per_image_steps(case):
    """(2, 32, 32, 3) through asr_step, aug + max + mean, the forward in
    chunks of 2 copies of both images: every mask of image i equals its own
    step's exactly, the targets to 1e-5; the results carry the image axis."""
    model, images, angles, shifts, coeffs = case
    kw = dict(sr_types=("aug", "max", "mean"), th_factor=0.2, return_targets=True,
              gram_coeffs=coeffs)
    batch = asr_step(model, images, angles, shifts, SR, 8, chunk_size=2, **kw)
    assert batch["aug"].shape == (2, 32, 32, 1)
    assert float((batch["standard"] > 0).float().mean()) > 0.05
    singles = [asr_step(model, images[i], angles, shifts, SR, 8, **kw)
               for i in range(2)]
    _assert_batch_equals_singles(batch, singles)


def test_asr_step_multiclass_batch_equals_per_image_steps(case):
    """2 images x 2 classes with slice_max, aug + max + mean and the label
    map, solved in class groups of 1 (each group both images' planes):
    equal to each image's own unchunked multi-class step, masks and label
    maps exactly, targets to 1e-5."""
    model, images, angles, shifts, coeffs = case
    kw = dict(mode="slice_max", sr_types=("aug", "max", "mean"), th_factor=0.2,
              return_targets=True, return_label_map=True, gram_coeffs=coeffs)
    classes = (8, 12)
    batch = asr_step_multiclass(model, images, angles, shifts, SR, classes,
                                class_chunk=1, **kw)
    assert batch["aug"].shape == (2, 2, 32, 32, 1)
    assert batch["label_map"].shape == (2, 32, 32, 1)
    singles = [asr_step_multiclass(model, images[i], angles, shifts, SR, classes, **kw)
               for i in range(2)]
    _assert_batch_equals_singles(batch, singles)


def _stub_images(n):
    rng = np.random.default_rng(2)
    return [(f"img{i}", rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
            for i in range(n)]


def _serve(images, tmp_path, run, **kw):
    cfg = kw.pop("cfg", None) or run_asr.make_sr_config(
        None, num_aug=2, feature_size=(4, 4), output_size=(16, 16), angle_max=0.15,
        num_iter=3)
    out_dir = tmp_path / run
    summary = run_asr.serve(images, _StubModel(16), cfg, device="cpu", shift_max=2.0,
                            output_dir=str(out_dir), writer_threads=3, **kw)
    masks = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
    return summary, masks


def test_serve_batches_equal_per_image_serving(tmp_path):
    """7 images in batches of 3 (the last padded with its last image, whose
    results are dropped) write the same PNGs as 7 one-image steps; the
    summary counts images and steps and names the batch and the loader."""
    images = _stub_images(7)
    one, one_masks = _serve(images, tmp_path, "one", batch=0)
    three, three_masks = _serve(images, tmp_path, "three", batch=3)
    assert (one["steps"], three["steps"]) == (7, 3)
    assert three["n_images"] == 7 and three["batch"] == 3
    assert three["loader"] == "arrays" and len(three["mask_fractions"]) == 7
    assert three["steady_s_per_image"] is not None
    assert set(three["loop_stages"]) >= {"host_decode", "host_to_device", "dispatch",
                                         "device_fetch", "encode_write_score"}
    assert sorted(one_masks) == sorted(three_masks) and len(one_masks) == 14
    for name in one_masks:
        assert one_masks[name] == three_masks[name], name
    with pytest.raises(ValueError, match="fixed-TTA-set"):
        _serve(images, tmp_path, "bad", batch=2, per_image_augs=True)


def test_per_image_augmentation_sets(tmp_path):
    """--per_image_augs: each image draws its own set from the run's seed and
    the CRC-32 of its name (stable across processes, unlike hash()), and each
    solve extracts its own stencil: nothing is cached. An image's result
    does not depend on which images run before it."""
    gen = image_generator(1234, "2007_000032")
    assert gen.initial_seed() == (1234 << 32) | zlib.crc32(b"2007_000032")
    a = torch.rand(3, generator=image_generator(1234, "x"))
    assert torch.equal(a, torch.rand(3, generator=image_generator(1234, "x")))
    assert not torch.equal(a, torch.rand(3, generator=image_generator(1234, "y")))
    images = _stub_images(3)
    cache = tmp_path / "cache"
    full, full_masks = _serve(images, tmp_path, "all", per_image_augs=True,
                              cache_dir=str(cache))
    last, last_masks = _serve(images[2:], tmp_path, "last", per_image_augs=True)
    assert full["per_image_augs"] and not cache.exists()
    for name, png in last_masks.items():
        assert full_masks[name] == png, name
    shared = sample_augmentations(torch.Generator().manual_seed(run_asr.SEED), 2,
                                  0.15, 2.0, device="cpu")
    own = sample_augmentations(image_generator(run_asr.SEED, "img0"), 2, 0.15, 2.0,
                               device="cpu")
    assert not torch.equal(own[1], shared[1])


def test_copy_dropout_without_a_generator_drops_nothing(tmp_path):
    """ROADMAP F6: the JAX CLI passes no dropout key, so --copy_dropout > 0
    drops no copy there (its _dropout_weights returns no mask without a key)
    and only stops the shared stencil; the port's serve does the same: the
    run extracts the stencil in each solve (nothing cached) and writes the
    same masks as a run without dropout. With a generator, the mask drops
    int(n * p) copies."""
    kw = dict(num_aug=4, feature_size=(4, 4), output_size=(16, 16), angle_max=0.15,
              num_iter=3)
    assert j_dropout_weights(None, JSRConfig(**kw, copy_dropout=0.5)) is None
    cfg = run_asr.make_sr_config(None, copy_dropout=0.5, **kw)
    assert dropout_weights(None, cfg) is None
    assert int((dropout_weights(torch.Generator().manual_seed(0), cfg) == 0).sum()) == 2
    assert not run_asr.uses_shared_stencil(cfg, ("aug",))
    images = _stub_images(2)
    cache = tmp_path / "cache"
    _, dropped = _serve(images, tmp_path, "dropout", cfg=cfg, cache_dir=str(cache))
    assert not cache.exists()
    _, plain = _serve(images, tmp_path, "plain", cfg=run_asr.make_sr_config(None, **kw),
                      cache_dir=str(cache))
    assert len(list(cache.glob("stencil_*.npz"))) == 1
    for name, png in plain.items():
        assert dropped[name] == png, name


def test_native_ring_matches_the_jax_ring(tmp_path):
    """The port's copy of the native decode ring delivers the JAX package's
    frames bit for bit, float32 and bf16 (uint16 bit patterns viewed as
    torch.bfloat16), in order; skipped where g++, libjpeg or libpng are
    missing, as tests/test_native_loader.py is."""
    if not (native_loader.available() and j_native_loader.available()):
        pytest.skip(f"native loader unavailable: {native_loader.build_error()}")
    paths = []
    for i in range(3):
        shutil.copy(SMOKE_IMG, tmp_path / f"img{i}.jpg")
        paths.append(str(tmp_path / f"img{i}.jpg"))
    for dtype in ("float32", "bfloat16"):
        ref_ring = j_native_loader.ImageRing(paths, (128, 96), dtype=dtype)
        try:
            ref = [(i, np.asarray(frame)) for i, frame in ref_ring]
        finally:
            ref_ring.close()
        with native_loader.ImageRing(paths, (128, 96), n_threads=2, capacity=2,
                                     dtype=dtype) as ring:
            ours = list(ring)
        assert [i for i, _ in ours] == [i for i, _ in ref] == [0, 1, 2]
        for (_, frame), (_, want) in zip(ours, ref):
            assert frame.dtype == getattr(torch, dtype) and frame.shape == (128, 96, 3)
            if dtype == "bfloat16":
                assert np.array_equal(frame.view(torch.int16).numpy(), want.view(np.int16))
            else:
                assert np.array_equal(frame.numpy(), want)
    one = native_loader.load_image_native(paths[0], (128, 96))
    assert np.array_equal(one, j_native_loader.load_image_native(paths[0], (128, 96)))
