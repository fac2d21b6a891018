"""The port's quality-evidence scripts (``_torch/scripts``) and the names the
JAX package exports.

Each script's ``main`` runs in-process on the CPU at a tiny size (MobileNetV2
at 32 px, 2 training steps, 2 scenes, 4 copies, 5 solve steps) and
writes the JSON keys and CSV header of the JAX script, read from that
script's source (the dict literals it writes) or from its committed
artifacts. The JAX scripts themselves are not run: their training and ASR
programs would compile here. Held exactly: ``paired_bootstrap`` against the
JAX script's on the same seeded generator, the held-out scenes against the
JAX scripts' numpy streams, a per-image TTA set whatever the order it is
drawn in, and ``make_schedule`` against optax's schedule (eager, to float32
rounding: 1e-6 relative). ``make_synthetic_voc`` writes a tree that
``cli.train --data voc`` trains on.
"""

import ast
import csv
import importlib.util
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import deeplabv3plus_augmented_superresolution_tpu as jax_package
from deeplabv3plus_augmented_superresolution_tpu.data.synthetic import (
    synthetic_batch as j_synthetic_batch,
    synthetic_scene as j_synthetic_scene,
)
from deeplabv3plus_augmented_superresolution_tpu.models import WEIGHTS_URLS as J_WEIGHTS_URLS
from deeplabv3plus_augmented_superresolution_tpu_torch import models, ops, pipeline, sr, utils
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import _common
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import train as cli_train
from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import synthetic_scene
from deeplabv3plus_augmented_superresolution_tpu_torch.scripts import (
    ab_cg_vs_adam, ab_serving_vs_strict, ab_stats, common, label_map_eval,
    make_synthetic_voc, per_class_validation, quality_demo)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")
EXPERIMENTS = os.path.join(REPO, "experiments")
# Every script's tiny configuration: MobileNetV2 in float32, 2 scenes, 4
# copies, 5 solve steps, the CPU.
TINY = ["--backbone", "mobilenet", "--num_aug", "4", "--num_iter", "5", "--device", "cpu"]
# The JAX __init__ exports the port leaves out (ROADMAP ground rules): orbax
# checkpoints, utils/retry.py and utils/roofline.py.
NOT_PORTED = {"save_checkpoint", "restore_checkpoint", "device_healthy", "device_resilient",
              "wait_for_device", "parse_hlo_flop_classes", "sol_summary"}
SUBPACKAGES = ("data", "models", "ops", "parallel", "pipeline", "sr", "utils")


def _jax_source(script):
    with open(os.path.join(JAX_SCRIPTS, script)) as f:
        return ast.parse(f.read())


def _dict_keys(node):
    """The string keys of a dict literal, those of a ``**(cond and {...})``
    entry included."""
    keys = set()
    for key, value in zip(node.keys, node.values):
        if key is not None:
            keys.add(key.value)
        else:
            for sub in ast.walk(value):
                if isinstance(sub, ast.Dict):
                    keys |= _dict_keys(sub)
                    break
    return keys


def _assigned_keys(tree, target):
    """The keys of the dict literals the script assigns to ``target`` (its
    source text as ast.unparse writes it, e.g. "summary['modes'][mode]"), and the
    constant keys it assigns to ``target[...]`` afterwards."""
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if ast.unparse(t) == target and isinstance(node.value, ast.Dict):
                keys |= _dict_keys(node.value)
            elif (isinstance(t, ast.Subscript) and ast.unparse(t.value) == target
                  and isinstance(t.slice, ast.Constant)):
                keys.add(t.slice.value)
    return keys


def _returned_keys(tree, function):
    """The keys of the dict literal that ``function`` returns."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == function:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Dict):
                    return _dict_keys(sub.value)
    raise LookupError(function)


def _constant(tree, name):
    for node in tree.body:
        if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == name:
            return ast.literal_eval(node.value)
    raise LookupError(name)


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_ab_stats():
    """The JAX script scripts/ab_stats.py as a module, loaded by path: its
    module level imports no jax but sets three TPU_* environment defaults,
    which are undone."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("jax_ab_stats",
                                                      os.path.join(JAX_SCRIPTS, "ab_stats.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return module


def test_paired_bootstrap_equals_the_jax_script(jax_ab_stats):
    deltas = np.random.default_rng(3).normal(0.01, 0.02, 37)
    wins = (deltas >= 0).astype(np.float64)
    for kw in ({}, {"wins": wins}):
        ours = ab_stats.paired_bootstrap(deltas, 1000, np.random.default_rng(11), **kw)
        theirs = jax_ab_stats.paired_bootstrap(deltas, 1000, np.random.default_rng(11), **kw)
        assert ours == theirs


def test_quality_demo_main_writes_the_jax_keys(tmp_path):
    """Train 2 steps (warp-augmented), save, evaluate 2 scenes with their own
    sets and the threshold sweep; then the saved params with --serving."""
    out, npz = str(tmp_path / "qd.json"), str(tmp_path / "qd.npz")
    base = TINY + ["--alpha", "0.35", "--size", "32", "--train_set", "4", "--eval_images", "2"]
    result = quality_demo.main(base + ["--train_steps", "2", "--train_batch", "2",
                                       "--warp_augment", "--th_sweep", "--save_params", npz,
                                       "--out", out])
    tree = _jax_source("quality_demo.py")
    assert set(_load(out)) == _assigned_keys(tree, "result") == set(result)
    assert {"th_sweep", "th_best"} <= set(result) and result["train_steps"] == 2
    assert np.isfinite(result["train_loss_final"])
    assert set(_load(out)["th_sweep"]["aug"]) == {str(t) for t in quality_demo.SWEEP_THS}
    served = quality_demo.main(base + ["--serving", "--load_params", npz, "--out", out])
    assert set(served) == _assigned_keys(tree, "result") - {"th_sweep", "th_best"}
    assert served["loaded_params"] == npz and served["train_loss_final"] is None
    # The same held-out scenes and weights: the standard masks do not depend
    # on the TTA set.
    assert served["iou"]["standard"] == result["iou"]["standard"]


def test_ab_stats_main_writes_the_jax_keys(tmp_path):
    out = str(tmp_path / "ab.json")
    result = ab_stats.main(TINY + ["--quick", "--size", "32", "--milestones", "1", "2",
                                   "--train_batch", "2", "--train_set", "4",
                                   "--eval_images", "2", "--bootstrap", "50", "--out", out,
                                   "--save_prefix", str(tmp_path / "ck")])
    tree = _jax_source("ab_stats.py")
    written = _load(out)
    assert set(written) == _assigned_keys(tree, "result")
    assert set(written["calibration_curve"]) == {"1", "2"}
    assert set(written["flagship"]) == _assigned_keys(tree, "curve[m]")
    committed = _load(os.path.join(EXPERIMENTS, "quality_hard_stats_plain.json"))
    assert set(written["flagship"]["aug_minus_standard"]) == \
        set(committed["flagship"]["aug_minus_standard"])
    assert os.path.exists(str(tmp_path / "ck_s2.npz")) and result["flagship_step"] == 2


def test_label_map_eval_main_writes_the_jax_keys(tmp_path):
    npz, out = str(tmp_path / "mob.npz"), str(tmp_path / "lm.json")
    models.save_params_npz(models.init_params(models.DeepLabConfig(
        input_shape=(32, 32, 3), backbone="mobilenet"), seed=0), npz)
    result = label_map_eval.main(TINY + ["--load_params", npz, "--size", "32",
                                         "--eval_images", "2", "--class_chunk", "1",
                                         "--rules", "raw", "gated", "--out", out])
    tree = _jax_source("label_map_eval.py")
    assert set(_load(out)) == _assigned_keys(tree, "shared") | _returned_keys(tree, "evaluate")
    assert set(result["by_rule"]) == {"raw", "gated"}
    assert 0.0 <= result["label_map_mean_iou"] <= 1.0


def test_per_class_validation_main_writes_the_reference_csv(tmp_path):
    prefix = str(tmp_path / "pc")
    summary = per_class_validation.main(TINY + [
        "--alpha", "0.35", "--size", "32", "--num_classes", "3", "--train_steps", "2",
        "--train_batch", "2", "--train_set", "4", "--scenes", "2", "--min_class_n", "1",
        "--class_chunk", "2", "--compute_dtype", "float32", "--out_prefix", prefix])
    tree = _jax_source("per_class_validation.py")
    written = _load(prefix + "_validation.json")
    committed = _load(os.path.join(EXPERIMENTS, "per_class_hard_validation.json"))
    assert set(written) == _assigned_keys(tree, "summary") == set(committed)
    assert set(written["modes"]["argmax"]) == \
        _assigned_keys(tree, "summary['modes'][mode]") == set(committed["modes"]["argmax"])
    with open(prefix + "_validation_argmax.csv") as f:
        header = f.readline().strip()
        rows = list(csv.reader(f))
    with open(os.path.join(EXPERIMENTS, "per_class_hard_validation_argmax.csv")) as f:
        assert header == f.readline().strip() == _constant(tree, "CSV_HEADER")
    assert [r[0] for r in rows] == [f"Class {c}" for c in range(1, 4)]
    assert min(summary["modes"]["argmax"]["per_class_n"].values()) >= 1


def test_ab_serving_vs_strict_main(monkeypatch, capsys):
    """The CLIs' model replaced by a 32-px MobileNetV2 in float32, as the
    port's CLI tests do; the fixture image decoded at that size."""
    small = models.build_model(models.DeepLabConfig(input_shape=(32, 32, 3),
                                                    backbone="mobilenet",
                                                    final_upsample=False),
                               seed=0, device="cpu")
    monkeypatch.setattr(_common, "IMG_SIZE", (32, 32))
    monkeypatch.setattr(_common, "build_deeplab", lambda *a, **kw: small)
    summary = ab_serving_vs_strict.main(["--num_images", "2", "--num_aug", "4",
                                         "--num_iter", "5", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "BOUND CHECK: mean aug disagreement" in printed
    assert set(summary["disagreement"]) == {"aug", "max", "mean"}
    assert all(0.0 <= d <= 1.0 for d in summary["disagreement"].values())


def test_ab_cg_vs_adam_main(monkeypatch, capsys):
    """At 32 px (observations 8 px): the truths scale with the size."""
    monkeypatch.setattr(ab_cg_vs_adam, "HR", 32)
    monkeypatch.setattr(ab_cg_vs_adam, "LR", 8)
    result = ab_cg_vs_adam.main(["--num_images", "2", "--num_aug", "4", "--num_iter", "5",
                                 "--device", "cpu"])
    assert "BOUND CHECK: cg recovery IoU >= adam - 0.005" in capsys.readouterr().out
    assert 0.0 < result["iou_adam"] <= 1.0 and 0.0 < result["iou_cg"] <= 1.0


def test_make_synthetic_voc_tree_feeds_train_voc(tmp_path):
    """The tree holds the JAX script's scenes (labels exactly; the JPEG
    images to its quantisation), and with its list where the dataset reads
    (ROADMAP F9) cli.train --data voc takes a step on it."""
    root = str(tmp_path / "voc")
    names = make_synthetic_voc.main(["--root", root, "--n", "3", "--size", "32"])
    voc = os.path.join(root, "data", "dataset_root", "VOCdevkit", "VOC2012")
    rng = np.random.default_rng(4321)
    from PIL import Image
    for name in names:
        img, lab = j_synthetic_scene(rng, (32, 32), class_ids=(8, 12))
        got = np.asarray(Image.open(os.path.join(voc, "SegmentationClassAug", name + ".png")))
        np.testing.assert_array_equal(got, lab)
        jpg = np.asarray(Image.open(os.path.join(voc, "JPEGImages", name + ".jpg")))
        assert np.abs(jpg.astype(np.float32) - img * 255).mean() < 8
    os.makedirs(os.path.join(voc, "ImageSets", "Segmentation"))
    shutil.copy(os.path.join(root, "data", "augmented_file_lists", "trainaug.txt"),
                os.path.join(voc, "ImageSets", "Segmentation", "train.txt"))
    summary = cli_train.main([
        "--data", "voc", "--pascal_root", voc, "--split", "train", "--device", "cpu",
        "--backbone", "mobilenet", "--alpha", "0.35", "--size", "32", "--batch", "2",
        "--steps", "1", "--log_every", "1", "--compute_dtype", "float32",
        "--save_params", ""])
    assert len(summary["losses"]) == 1 and np.isfinite(summary["losses"][0])


@pytest.mark.parametrize("hard", [False, True])
def test_held_out_scenes_are_the_jax_scripts(hard):
    """quality_demo / ab_stats: the training scenes, then the held-out ones
    holding the class, from one stream; label_map_eval: scenes holding two
    of the classes."""
    imgs, labs, eval_imgs, eval_labs = common.quality_scenes(7, 3, 24, 2, 32, 8, hard)
    rng = np.random.default_rng(7)
    j_imgs, j_labs = j_synthetic_batch(rng, 3, size=(24, 24), class_ids=(8, 12), hard=hard)
    j_eval = j_synthetic_batch(rng, 2, size=(32, 32), class_ids=(8, 12), require_class=8,
                               hard=hard)
    for ours, theirs in zip((imgs, labs, eval_imgs, eval_labs), (j_imgs, j_labs) + j_eval):
        np.testing.assert_array_equal(ours, theirs)
    scenes = label_map_eval.held_out_scenes(5, 2, 32, [8, 12], hard)
    rng = np.random.default_rng(5)
    want = []
    while len(want) < 2:
        img, lab = j_synthetic_scene(rng, (32, 32), class_ids=(8, 12), max_shapes=4,
                                     hard=hard)
        if len(set(np.unique(lab).tolist()) & {8, 12}) >= 2:
            want.append((img, lab))
    for (img, lab), (j_img, j_lab) in zip(scenes, want):
        np.testing.assert_array_equal(img, j_img)
        np.testing.assert_array_equal(lab, j_lab)
    img, lab = synthetic_scene(np.random.default_rng(1), (16, 16), hard=hard)
    j_img, j_lab = j_synthetic_scene(np.random.default_rng(1), (16, 16), hard=hard)
    assert np.array_equal(img, j_img) and np.array_equal(lab, j_lab)


def test_per_image_tta_is_the_same_in_any_order():
    forward = [common.image_tta(1234, i, 6, 40.0, "cpu") for i in range(4)]
    backward = [common.image_tta(1234, i, 6, 40.0, "cpu") for i in reversed(range(4))][::-1]
    for (a0, s0), (a1, s1) in zip(forward, backward):
        assert torch.equal(a0, a1) and torch.equal(s0, s1)
        assert float(a0[0]) == 0.0 and float(s0[0].abs().sum()) == 0.0
        assert float(a0.abs().max()) <= common.TTA_ANGLE_MAX
    assert not torch.equal(forward[0][0], forward[1][0])
    assert not torch.equal(common.fixed_tta(1234, 6, 40.0, "cpu")[0], forward[0][0])


def test_every_jax_export_has_a_counterpart():
    """Each subpackage's __all__ of the JAX package, less the exports the
    ground rules leave out, is in the port's."""
    import importlib

    for name in SUBPACKAGES:
        theirs = importlib.import_module(f"{jax_package.__name__}.{name}")
        ours = importlib.import_module(f"deeplabv3plus_augmented_superresolution_tpu_torch.{name}")
        missing = set(theirs.__all__) - set(ours.__all__) - NOT_PORTED
        assert not missing, (name, sorted(missing))
        assert all(hasattr(ours, n) for n in ours.__all__), name
    assert models.WEIGHTS_URLS == J_WEIGHTS_URLS


@pytest.mark.parametrize("scheduled", [True, False])
def test_make_schedule_matches_optax(scheduled):
    cfg = sr.OptimizerConfig(learning_rate=1e-3, lr_scheduler=scheduled, decay_steps=60,
                             decay_rate=0.3)
    ours = sr.make_schedule(cfg)
    if not scheduled:
        assert ours == cfg.learning_rate
        return
    theirs = optax.exponential_decay(init_value=cfg.learning_rate, transition_steps=60,
                                     decay_rate=0.3, staircase=False)
    counts = np.arange(0, 301, 7, dtype=np.int32)
    np.testing.assert_allclose([float(ours(c)) for c in counts],
                               np.asarray(theirs(counts), np.float32), rtol=1e-6)


def test_the_reference_api_helpers():
    """create_augmented_copies draws the set and warps with it;
    create_mask / get_prediction are the argmax with a channel axis;
    device_summary names the CPU here (test_torch_model.py holds forward)."""
    image = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(0))
    copies, angles, shifts = pipeline.create_augmented_copies(
        image, 5, 0.2, 3.0, torch.Generator().manual_seed(9))
    want_a, want_s = pipeline.sample_augmentations(torch.Generator().manual_seed(9), 5, 0.2,
                                                   3.0, device="cpu")
    assert torch.equal(angles, want_a) and torch.equal(shifts, want_s)
    assert torch.equal(copies, pipeline.make_augmented_copies(image, want_a, want_s, 5))
    logits = torch.randn(2, 8, 8, 21, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ops.create_mask(logits), logits.argmax(-1)[..., None])
    mask = ops.get_prediction(lambda p, x: x * p, 2.0, logits[0])
    assert mask.shape == (8, 8, 1) and torch.equal(mask, ops.create_mask(logits[0]))
    assert utils.device_summary().startswith("1 device(s), platform=cpu")
