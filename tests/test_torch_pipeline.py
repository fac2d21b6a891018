"""Port parity: augmentation, asr_step end to end, serving and the CLI.

The same numpy image, params, angles and shifts go through the JAX package
and the PyTorch port (plain versions on the CPU). The port's ``serve`` and
``main`` run at 64 px with few copies; the CLI's fixed 512 px bf16 model is
only parsed here (too slow for a CPU test).
"""

import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.data.io import load_image as j_load_image
from deeplabv3plus_augmented_superresolution_tpu.metrics import (
    compute_iou as j_compute_iou,
)
from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig,
    init_params as j_init_params,
)
from deeplabv3plus_augmented_superresolution_tpu.pipeline import (
    asr_step as j_asr_step,
    make_augmented_copies as j_make_copies,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    OptimizerConfig as JOptimizerConfig,
    SRConfig as JSRConfig,
)
from deeplabv3plus_augmented_superresolution_tpu_torch import metrics
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import run_asr
from deeplabv3plus_augmented_superresolution_tpu_torch.data.io import load_image, save_img
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLabConfig,
    build_model,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    asr_step,
    make_augmented_copies,
    sample_augmentations,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    OptimizerConfig,
    SRConfig,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_IMG = os.path.join(REPO, "test_images", "smoke_input.jpg")
SMOKE_GT = os.path.join(REPO, "test_images", "smoke_gt.png")
SERVING_OPT = dict(learning_rate=1e-3, amsgrad=True, lr_scheduler=True,
                   decay_steps=60, decay_rate=0.3)
SMALL_MODEL = dict(input_shape=(64, 64, 3), final_upsample=False)


@pytest.fixture(scope="module")
def params():
    return j_init_params(JDeepLabConfig(**SMALL_MODEL), seed=0)


@pytest.fixture(scope="module")
def model(params):
    return build_model(DeepLabConfig(**SMALL_MODEL), params=params, device="cpu")


def _tta(n, seed, angle_max=0.15, shift_max=10.0):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-angle_max, angle_max, n).astype(np.float32)
    shifts = rng.uniform(-shift_max, shift_max, (n, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    return angles, shifts


def test_sample_augmentations_identity_first_and_seeded():
    a1, s1 = sample_augmentations(torch.Generator().manual_seed(7), 16, 0.5, 30.0,
                                  device="cpu")
    a2, s2 = sample_augmentations(torch.Generator().manual_seed(7), 16, 0.5, 30.0,
                                  device="cpu")
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    assert float(a1[0]) == 0.0 and float(s1[0].abs().sum()) == 0.0
    assert float(a1.abs().max()) <= 0.5 and float(s1.abs().max()) <= 30.0
    assert a1.dtype == torch.float32 and s1.shape == (16, 2)


def test_augmented_copies_match_jax():
    """(H, W, 3) -> (N, H, W, 3) f32 copies through the three shear passes:
    2e-5 as the warp parity; copy 0 is the image itself."""
    img = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    angles, shifts = _tta(4, 2)
    ours = make_augmented_copies(torch.from_numpy(img), torch.from_numpy(angles),
                                 torch.from_numpy(shifts), 4, angle_max=0.15)
    ref = np.asarray(j_make_copies(jnp.asarray(img), jnp.asarray(angles),
                                   jnp.asarray(shifts), 4, angle_max=0.15))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(ours[0].numpy(), img, atol=1e-6)


def _most_frequent_label(model, image):
    with torch.no_grad():
        labels = model(torch.from_numpy(image)[None]).argmax(-1)
    return int(torch.bincount(labels.flatten(), minlength=21).argmax())


def test_asr_step_matches_jax(params, model):
    """The whole step at 64 px, f32 model, 4 copies, 30 serving AMSGrad steps,
    the stencil extracted inline on both sides. The class is the one the
    random model predicts most, so the masks are not empty. Logits agree to
    1e-4 of their scale, so argmax masks agree on >= 99% of pixels; the SR
    target within 5e-3 (Adam's normalized steps, see test_torch_solver)."""
    image = np.random.default_rng(3).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    angles, shifts = _tta(4, 4)
    class_id = _most_frequent_label(model, image)
    kw = dict(num_aug=4, feature_size=(16, 16), output_size=(64, 64),
              angle_max=0.15, num_iter=30, solver_impl="gram")
    ref = j_asr_step(params, jnp.asarray(image), jnp.asarray(angles),
                     jnp.asarray(shifts), JDeepLabConfig(**SMALL_MODEL),
                     JSRConfig(**kw, optimizer=JOptimizerConfig(**SERVING_OPT)),
                     class_id=class_id, th_factor=0.2, sr_types=("aug",),
                     return_targets=True)
    ours = asr_step(model, torch.from_numpy(image), torch.from_numpy(angles),
                    torch.from_numpy(shifts),
                    SRConfig(**kw, optimizer=OptimizerConfig(**SERVING_OPT)),
                    class_id, th_factor=0.2, sr_types=("aug",), return_targets=True)
    assert set(ours) == {"aug", "aug_target", "standard"}
    for key in ("aug", "standard"):
        assert ours[key].shape == (64, 64, 1)
        assert set(np.unique(ours[key].numpy())) <= {0.0, float(class_id)}
        agree = float((ours[key].numpy() == np.asarray(ref[key])).mean())
        assert agree >= 0.99, (key, agree)
    assert float((ours["standard"] > 0).float().mean()) > 0.05
    err = np.abs(ours["aug_target"].numpy() - np.asarray(ref["aug_target"]))
    assert err.max() <= 5e-3, err.max()


def test_asr_step_slice_max_and_unported_sr_types(model):
    """max and mean SR, which raised before they were ported, through the
    slice_max path (a second inverse-warp stack of the max masks sets each
    threshold): (64, 64, 1) masks valued {0, 8}; targets in [0, 1] with
    max >= mean; the max alone (its own inverse warp) equals the max of the
    shared stack, targets and masks."""
    image = np.random.default_rng(5).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    angles, shifts = (torch.from_numpy(a) for a in _tta(2, 6))
    cfg = SRConfig(num_aug=2, feature_size=(16, 16), output_size=(64, 64),
                   angle_max=0.15, num_iter=5, solver_impl="gram")
    out = asr_step(model, torch.from_numpy(image), angles, shifts, cfg, 8,
                   mode="slice_max", chunk_size=1, return_targets=True)
    assert set(out) == {"aug", "max", "mean", "standard", "aug_target",
                        "max_target", "mean_target"}
    for key in ("aug", "max", "mean"):
        assert out[key].shape == (64, 64, 1)
        assert set(np.unique(out[key].numpy())) <= {0.0, 8.0}
    mx, mean = out["max_target"], out["mean_target"]
    assert float(mean.min()) >= 0.0 and float(mx.max()) <= 1.0 + 1e-6
    assert bool((mx >= mean - 1e-6).all())
    alone = asr_step(model, torch.from_numpy(image), angles, shifts, cfg, 8,
                     mode="slice_max", chunk_size=1, sr_types=("max",),
                     return_targets=True)
    assert torch.equal(alone["max_target"], mx) and torch.equal(alone["max"], out["max"])
    with pytest.raises(ValueError, match="sr_types"):
        asr_step(model, torch.from_numpy(image), angles, shifts, cfg, 8,
                 sr_types=("aug", "median"))


def test_load_image_and_metrics_match_jax():
    """Decode + TF-semantics resize to 64 px (1e-5 on [0, 1] images, same
    interpolation matrices); nearest label resize exact; IoU identical."""
    ours = load_image(SMOKE_IMG, image_size=(64, 64))
    ref = j_load_image(SMOKE_IMG, image_size=(64, 64))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    gt = load_image(SMOKE_GT, image_size=(64, 64), normalize=False, is_png=True,
                    resize_method="nearest")
    np.testing.assert_array_equal(gt, j_load_image(SMOKE_GT, image_size=(64, 64),
                                                   normalize=False, is_png=True,
                                                   resize_method="nearest"))
    pred = np.where(np.roll(gt, 3, axis=1) == 8, 8, 0).astype(np.float32)
    for kw in ({"class_id": 8}, {"class_id": 8, "include_bg": True}, {}):
        assert metrics.compute_iou(gt, pred, **kw) == pytest.approx(
            j_compute_iou(gt, pred, **kw), abs=1e-6)


def test_serve_writes_masks_and_iou(model, tmp_path):
    """serve() at 64 px with 2 copies on the bundled smoke image (resized by
    the port's load_image): PNGs, IoU against the GT, the summary JSON, and
    a second run that loads the stencil from the cache and reproduces the
    masks exactly."""
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    shutil.copy(SMOKE_GT, gt_dir / "smoke_input.png")
    image = load_image(SMOKE_IMG, image_size=(64, 64))
    cfg = run_asr.make_sr_config(None, num_aug=2, feature_size=(16, 16),
                                 output_size=(64, 64), angle_max=0.15, num_iter=10)
    outs = []
    for run in ("a", "b"):
        out_dir = tmp_path / run
        summary = run_asr.serve(
            [("smoke_input", image)], model, cfg, device="cpu", class_id=8,
            angle_max=0.15, shift_max=10.0, output_dir=str(out_dir),
            gt_dir=str(gt_dir), cache_dir=str(tmp_path / "cache"),
            writer_threads=2, summary_json=str(tmp_path / f"{run}.json"))
        assert summary["n_images"] == 1
        assert set(summary["ious"]) == {"aug", "standard"}
        assert all(0.0 <= v <= 1.0 for v in summary["ious"].values())
        assert json.loads((tmp_path / f"{run}.json").read_text())["n_images"] == 1
        outs.append([load_image(str(out_dir / f"smoke_input_{k}.png"), is_png=True,
                                normalize=False) for k in ("aug", "standard")])
    assert len(list((tmp_path / "cache").glob("stencil_*.npz"))) == 1
    for first, second in zip(*outs):
        assert first.shape == (64, 64, 1) and set(np.unique(first)) <= {0.0, 8.0}
        np.testing.assert_array_equal(first, second)


class _StubModel(torch.nn.Module):
    """Logits that favour class 8 on the left half: a model fast enough to
    push many images through the writer pool."""

    cfg = DeepLabConfig(input_shape=(16, 16, 3), final_upsample=False)

    def forward(self, images):
        logits = torch.zeros(images.shape[0], 4, 4, 21)
        logits[:, :, :2, 8] = images[:, ::4, :8:4, 0].float() + 1.0
        return logits


def test_serve_writer_pool_keeps_every_result():
    """40 images through 8 writer threads with a short thread switch
    interval: every image's completion and mask fractions are recorded
    (the writers share the summary under a lock)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rng = np.random.default_rng(0)
        images = [(f"img{i}", rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
                  for i in range(40)]
        cfg = run_asr.make_sr_config(None, num_aug=2, feature_size=(4, 4),
                                     output_size=(16, 16), angle_max=0.15, num_iter=2)
        summary = run_asr.serve(images, _StubModel(), cfg, device="cpu",
                                shift_max=2.0, writer_threads=8)
    finally:
        sys.setswitchinterval(interval)
    assert summary["n_images"] == 40
    assert len(summary["done_ts"]) == 40
    assert sorted(summary["mask_fractions"]) == sorted(n for n, _ in images)
    assert all(fr["standard"] > 0 for fr in summary["mask_fractions"].values())


def test_save_img_roundtrip(tmp_path):
    mask = np.zeros((16, 16, 1), np.float32)
    mask[4:9, 2:7] = 8.0
    save_img(str(tmp_path / "m.png"), mask, scale=False, compress_level=1)
    np.testing.assert_array_equal(load_image(str(tmp_path / "m.png"), is_png=True,
                                             normalize=False), mask)


@functools.lru_cache(maxsize=None)
def _jax_run_asr():
    """The JAX CLI's module (its parser and make_sr_config), loaded once."""
    cli_dir = os.path.join(REPO, "cli")
    sys.path.insert(0, cli_dir)
    try:
        spec = importlib.util.spec_from_file_location("_jax_run_asr",
                                                      os.path.join(cli_dir, "run_asr.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(cli_dir)
    return mod


def _jax_run_asr_parser():
    return _jax_run_asr().parser


def test_cli_flags_and_defaults_match_jax_cli():
    """Every flag of the JAX run_asr exists in the port with the same default
    (output and cache directories are per-package paths)."""
    ours = {a.dest: a.default for a in run_asr.build_parser()._actions}
    for action in _jax_run_asr_parser()._actions:
        if action.dest in ("help", "output_dir", "cache_dir"):
            continue
        assert action.dest in ours, action.dest
        assert ours[action.dest] == action.default, action.dest
    args = run_asr.parse_args(["--images", SMOKE_IMG])
    assert (args.num_aug, args.angle_max, args.shift_max, args.th_factor,
            args.solver_impl, args.mode, args.class_id) == (
        100, 0.15, 80, 0.2, "gram", "argmax", "8")
    cfg = run_asr.make_sr_config(args, num_aug=args.num_aug, angle_max=args.angle_max)
    assert cfg.optimizer.amsgrad and cfg.optimizer.lr_scheduler
    assert (cfg.num_iter, cfg.angle_max, cfg.feature_size) == (300, 0.15, (128, 128))


@pytest.mark.parametrize("flags", [
    ["--warp_impl", "gather"], ["--operator_impl", "staged"],
    ["--profile_dir", "x"],
], ids=lambda f: " ".join(f))
def test_main_rejects_flags_outside_the_slice(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        run_asr.main(["--images", SMOKE_IMG, *flags])
    assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def _jax_fast_preset(args):
    """The JAX CLI's --fast preset, as its main() applies it (cli/run_asr.py,
    right after parse_args); the port applies it in parse_args."""
    args.num_iter = min(args.num_iter, 60)
    args.learning_rate = max(args.learning_rate, 1e-2)
    args.decay_steps = max(args.num_iter // 5, 1)
    args.decay_rate = 0.1
    args.sgd_copies = args.sgd_copies or 25


@pytest.mark.parametrize("flags", [
    ["--batch", "4"], ["--solver_impl", "cg"], ["--per_image_augs"], ["--fast"],
    ["--copy_dropout", "0.1"], ["--sgd_copies", "25"], ["--optimizer", "sgd"],
], ids=lambda f: " ".join(f))
def test_parse_accepts_the_flags_this_slice_ports(flags):
    """The flags that exited with "not ported yet" before this slice parse to
    the JAX CLI's values, and make_sr_config turns them into the JAX CLI's
    solver config, field for field (no model runs). --batch with
    --per_image_augs exits with the JAX CLI's message."""
    jax_cli = _jax_run_asr()
    argv = ["--images", SMOKE_IMG, *flags]
    args, jargs = run_asr.parse_args(argv), jax_cli.parser.parse_args(argv)
    if jargs.fast:
        _jax_fast_preset(jargs)
    for key, value in vars(jargs).items():
        if key not in ("output_dir", "cache_dir"):
            assert getattr(args, key) == value, key
    ours = run_asr.make_sr_config(args, num_aug=args.num_aug, angle_max=args.angle_max)
    ref = jax_cli.make_sr_config(jargs, num_aug=jargs.num_aug, angle_max=jargs.angle_max)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    if flags[0] == "--batch":
        with pytest.raises(SystemExit, match="--batch requires the fixed-TTA-set mode"):
            run_asr.parse_args(argv + ["--per_image_augs"])


@functools.lru_cache(maxsize=None)
def _small_deeplab(backbone="xception", weights_path=None, *, device):
    """The CLI's model at 64 px and in f32, so that main runs on the CPU;
    built once per backbone (main only reads it)."""
    return build_model(DeepLabConfig(**SMALL_MODEL, backbone=backbone), seed=0,
                       device=device)


@pytest.mark.parametrize("flags, files, series", [
    (["--class_id", "8,12"], ["aug_c8", "aug_c12", "standard_c8", "standard_c12"],
     ["aug/c8", "aug/c12", "standard/c8", "standard/c12"]),
    (["--class_id", "all", "--label_map", "--class_chunk", "7"],
     ["aug_c1", "aug_c20", "standard_c20", "labelmap", "labelmap_standard"],
     ["aug/c20", "label_map (mIoU)", "label_map_standard (mIoU)"]),
    (["--sr_types", "aug,max"], ["aug", "max", "standard"], ["aug", "max", "standard"]),
    (["--backbone", "mobilenet", "--sr_types", "max,mean"], ["max", "mean", "standard"],
     ["max", "mean", "standard"]),
    (["--label_map"], None, None),
], ids=["--class_id 8,12", "--class_id all", "--sr_types aug,max",
        "--backbone mobilenet", "--label_map"])
def test_main_runs_the_flags_this_slice_ports(flags, files, series, tmp_path,
                                              monkeypatch):
    """The flags that raised "not ported yet" before now parse and run main
    end to end (64 px, f32, 2 copies, 3 steps): the JAX CLI's file names
    (<name>_<type>_c<id>.png per class, the label maps) and IoU series.
    --label_map with one class exits with the JAX CLI's message."""
    monkeypatch.setattr(run_asr, "IMG_SIZE", (64, 64))
    monkeypatch.setattr(run_asr, "FEATURE_SIZES", {"xception": (16, 16),
                                                   "mobilenet": (8, 8)})
    monkeypatch.setattr(run_asr, "build_deeplab", _small_deeplab)
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    shutil.copy(SMOKE_GT, gt_dir / "smoke_input.png")
    argv = ["--images", SMOKE_IMG, "--gt_dir", str(gt_dir), "--num_aug", "2",
            "--num_iter", "3", "--shift_max", "8", "--cache_dir", "",
            "--writer_threads", "2", "--device", "cpu",
            "--output_dir", str(tmp_path / "out"), *flags]
    if files is None:
        with pytest.raises(SystemExit, match="--label_map needs a multi-class"):
            run_asr.main(argv)
        return
    summary = run_asr.main(argv)
    assert summary["n_images"] == 1
    for name in files:
        mask = load_image(str(tmp_path / "out" / f"smoke_input_{name}.png"),
                          is_png=True, normalize=False)
        assert mask.shape == (64, 64, 1)
    assert set(series) <= set(summary["ious"])
    # NaN where a class is in neither the GT nor the mask (as the JAX CLI)
    assert all(np.isnan(v) or 0.0 <= v <= 1.0 for v in summary["ious"].values())


@pytest.mark.parametrize("flags, n_files, steps", [
    (["--batch", "2"], 3, 2),
    (["--per_image_augs"], 1, 1),
    (["--fast", "--sgd_copies", "1"], 1, 1),
], ids=["--batch 2", "--per_image_augs", "--fast"])
def test_main_runs_batch_per_image_augs_and_fast(flags, n_files, steps, tmp_path,
                                                 monkeypatch):
    """main end to end with this slice's serving flags (64 px, f32, 2
    copies): --batch 2 on three files (a ragged last batch), a fresh
    augmentation set per image, and --fast (the minibatched direct solver,
    here windows of 1 of the 2 copies). Every image gets its PNGs; the
    summary names the batch and the loader (the native ring where it
    builds)."""
    from deeplabv3plus_augmented_superresolution_tpu_torch.data import native_loader

    monkeypatch.setattr(run_asr, "IMG_SIZE", (64, 64))
    monkeypatch.setattr(run_asr, "FEATURE_SIZES", {"xception": (16, 16),
                                                   "mobilenet": (8, 8)})
    monkeypatch.setattr(run_asr, "build_deeplab", _small_deeplab)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(n_files):
        shutil.copy(SMOKE_IMG, in_dir / f"img{i}.jpg")
    argv = ["--images", str(in_dir), "--num_aug", "2", "--num_iter", "3",
            "--shift_max", "8", "--cache_dir", "", "--writer_threads", "2",
            "--device", "cpu", "--output_dir", str(tmp_path / "out"), *flags]
    summary = run_asr.main(argv)
    assert (summary["n_images"], summary["steps"]) == (n_files, steps)
    assert summary["batch"] == (2 if "--batch" in flags else 0)
    assert summary["loader"] == ("native ring" if native_loader.available()
                                 else "python lookahead")
    for i in range(n_files):
        for key in ("aug", "standard"):
            mask = load_image(str(tmp_path / "out" / f"img{i}_{key}.png"), is_png=True,
                              normalize=False)
            assert mask.shape == (64, 64, 1) and set(np.unique(mask)) <= {0.0, 8.0}
