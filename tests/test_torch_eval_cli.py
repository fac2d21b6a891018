"""The port's evaluation CLIs end to end, in-process, on a tiny VOC-layout tree
of synthetic 64-px scenes (class 8 in each): generate_augmented_copies ->
generate_standard_output -> SR_single_class (the shared-set stencil reused),
threshold_tests, test_SR, check_robustness, sweep_agent, validate_parity
--smoke and run_asr --profile_dir. Each output file's schema is checked and
its values held against the port's module functions on the same inputs.

The CLIs' 512-px bf16 model is replaced by MobileNetV2 at 64 px in float32
(``build_deeplab`` and the image size patched), so that they run on the
CPU; their flags are held against the JAX CLIs'.
"""

import csv
import functools
import importlib.util
import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3plus_augmented_superresolution_tpu_torch import metrics
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import (
    SR_single_class,
    check_robustness,
    generate_augmented_copies,
    generate_standard_output,
    run_asr,
    sweep_agent,
    sweep_script,
    test_SR,
    threshold_tests,
    validate_parity,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.cli._common import SEED
from deeplabv3plus_augmented_superresolution_tpu_torch.data import load_image, load_sr_data
from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import synthetic_batch
from deeplabv3plus_augmented_superresolution_tpu_torch.models import DeepLabConfig, build_model
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline import (
    asr_step,
    sample_augmentations,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.feature_maps import (
    stage_feature_maps,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["2007_000001", "2007_000002", "2007_000003"]
SIZE = (64, 64)
# The staging and solve flags of the chain: MobileNetV2 (LR masks 8 px),
# 3 copies, 3 solver steps.
STAGE = ["--class_id", "8", "--backbone", "mobilenet", "--device", "cpu"]
SOLVE = STAGE + ["--no_validation", "--num_aug", "3", "--num_iter", "3",
                 "--angle_max", "0.2"]


def _small_deeplab(backbone="xception", weights_path=None, *, device,
                   final_upsample=False):
    """The CLIs' model at 64 px and in float32, built once per variant (the
    CLIs run on the CPU, and only read it)."""
    return _built(backbone, final_upsample)


@functools.lru_cache(maxsize=None)
def _built(backbone, final_upsample):
    return build_model(DeepLabConfig(input_shape=SIZE + (3,), backbone=backbone,
                                     final_upsample=final_upsample), seed=0, device="cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The working directory: data/dataset_root/VOCdevkit/VOC2012 with three
    scenes (JPEG images, PNG labels with 255 contours) in both image lists,
    staged with one shared augmentation set (3 copies), and the standard
    masks; the CLIs patched to the small model for the module."""
    root = tmp_path_factory.mktemp("workdir")
    voc = root / "data" / "dataset_root" / "VOCdevkit" / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "SegmentationClassAug").mkdir(parents=True)
    lists = root / "data" / "augmented_file_lists"
    lists.mkdir(parents=True)
    images, labels = synthetic_batch(np.random.default_rng(0), len(NAMES), size=SIZE,
                                     require_class=8)
    for name, image, label in zip(NAMES, images, labels):
        Image.fromarray((image * 255).round().astype(np.uint8)).save(
            voc / "JPEGImages" / f"{name}.jpg", quality=95)
        Image.fromarray(label.astype(np.uint8), mode="L").save(
            voc / "SegmentationClassAug" / f"{name}.png")
    for split in ("trainaug", "valaug"):
        (lists / f"{split}.txt").write_text("\n".join(NAMES))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        for module in (generate_augmented_copies, generate_standard_output, test_SR,
                       check_robustness, validate_parity, run_asr):
            mp.setattr(module, "build_deeplab", _small_deeplab)
        for module in (SR_single_class, threshold_tests, run_asr):
            mp.setattr(module, "IMG_SIZE", SIZE)
        staged = generate_augmented_copies.main(
            STAGE + ["--num_aug", "3", "--angle_max", "0.2", "--shift_max", "6",
                     "--shared_tta"])
        standard = generate_standard_output.main(STAGE)
        yield root, voc, staged, standard


def _staged_files(root):
    return root / "data" / "superres_root" / "augmented_copies" / "mobilenet_argmax_8_3"


def test_staging_standard_masks_and_sr_single_class(tree):
    """The staged hdf5 files hold the reference's datasets and attributes and
    the masks and draws of ``stage_feature_maps`` on the decoded image, one
    shared set for all; the standard masks are ``standard_masks`` of the full
    model; SR_single_class extracts the shared set's stencil once (at the
    second file) and its six averages equal ``score_image`` of each file
    solved with its own extraction (the same stencil, so exactly)."""
    root, voc, staged, standard = tree
    assert staged == standard == NAMES
    files = _staged_files(root)
    assert sorted(os.listdir(files)) == [f"{n}.hdf5" for n in NAMES]
    model = _small_deeplab("mobilenet", device="cpu")
    full = _small_deeplab("mobilenet", device="cpu", final_upsample=True)
    for name in NAMES:
        image = load_image(str(voc / "JPEGImages" / f"{name}.jpg"), image_size=SIZE)
        want = stage_feature_maps(model, name, image, 8, "argmax", 3, 0.2, 6, 0, SEED,
                                  shared_tta=True)
        with h5py.File(files / f"{name}.hdf5") as f:
            assert sorted(f) == ["angles", "class_masks", "shifts"]
            assert dict(f.attrs) == {"filename": name, "mode": "argmax",
                                     "angle_max": 0.2, "shift_max": 6}
            assert f["class_masks"].shape == (3, 8, 8, 1)
            np.testing.assert_array_equal(f["class_masks"][:], want[0].numpy())
            np.testing.assert_array_equal(f["angles"][:], want[2].numpy())
            np.testing.assert_array_equal(f["shifts"][:], want[3].numpy())
        mask = load_image(str(root / "data" / "superres_root" / "standard_output"
                              / "mobilenet_8" / f"{name}.png"), is_png=True,
                          normalize=False)
        expect = generate_standard_output.standard_masks(full, torch.from_numpy(image)[None],
                                                         8)[0]
        np.testing.assert_array_equal(mask, expect.numpy().astype(np.float32))

    stencils = SR_single_class.StencilCache()
    avg = SR_single_class.run(SR_single_class.build_parser().parse_args(SOLVE), stencils)
    assert stencils.extractions == 1
    cfg = SR_single_class.make_sr_config(num_aug=3, feature_size=(8, 8), output_size=SIZE,
                                         num_iter=3, angle_max=0.2)
    scores = []
    for name in NAMES:
        cls, mx, angles, shifts, filename = load_sr_data(str(files / f"{name}.hdf5"), 3)
        true = load_image(str(voc / "SegmentationClassAug" / f"{name}.png"),
                          image_size=SIZE, normalize=False, is_png=True,
                          resize_method="nearest")
        std = load_image(str(root / "data" / "superres_root" / "standard_output"
                             / "mobilenet_8" / f"{name}.png"), image_size=SIZE,
                         normalize=False, is_png=True, resize_method="nearest")
        scores.append(SR_single_class.score_image(
            cfg, cls, mx, torch.from_numpy(angles), torch.from_numpy(shifts), true, std,
            class_id=8, th_factor=0.65))
    assert avg == pytest.approx(SR_single_class.average(scores), abs=1e-9, nan_ok=True)
    assert set(avg) == set(SR_single_class.IOU_KEYS)


def test_sr_single_class_runs_the_staged_operator(tree):
    """SR_single_class with --operator_impl staged, a flag every evaluation
    CLI shares (add_sr_args) that exited with "not ported yet" before the
    staged operator was ported: one extraction for the shared set, and the
    six averages equal ``score_image`` of each file with the staged config,
    the library call whose solver and stencil tests/test_torch_warp.py holds
    against JAX."""
    root, voc, _, _ = tree
    stencils = SR_single_class.StencilCache()
    args = SR_single_class.build_parser().parse_args(SOLVE + ["--operator_impl", "staged"])
    avg = SR_single_class.run(args, stencils)
    assert stencils.extractions == 1
    cfg = SR_single_class.make_sr_config(num_aug=3, feature_size=(8, 8), output_size=SIZE,
                                         num_iter=3, angle_max=0.2, operator_impl="staged")
    scores = []
    for name in NAMES:
        cls, mx, angles, shifts, _ = load_sr_data(str(_staged_files(root) / f"{name}.hdf5"), 3)
        labels = [load_image(str(path), image_size=SIZE, normalize=False, is_png=True,
                             resize_method="nearest")
                  for path in (voc / "SegmentationClassAug" / f"{name}.png",
                               root / "data" / "superres_root" / "standard_output"
                               / "mobilenet_8" / f"{name}.png")]
        scores.append(SR_single_class.score_image(
            cfg, cls, mx, torch.from_numpy(angles), torch.from_numpy(shifts), *labels,
            class_id=8, th_factor=0.65))
    assert avg == pytest.approx(SR_single_class.average(scores), abs=1e-9, nan_ok=True)


def test_threshold_tests_csv(tree):
    """th_argmax_<n>.csv: the header, the 17 factors 0.1 .. 0.9, each image
    counted, and each average equal to ``threshold_ious`` of the files."""
    root, voc, _, _ = tree
    out = root / "th.csv"
    averages = threshold_tests.main(SOLVE + ["--output_csv", str(out)])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["th_factor", "avg_iou", "num_images"]
    factors = threshold_tests.threshold_grid(0.1, 0.9, 0.05)
    assert [float(r[0]) for r in rows[1:]] == factors and len(factors) == 17
    assert all(r[2] == "3" for r in rows[1:])
    cfg = SR_single_class.make_sr_config(num_aug=3, feature_size=(8, 8), output_size=SIZE,
                                         num_iter=3, angle_max=0.2)
    per_image = []
    for name in NAMES:
        cls, _, angles, shifts, _ = load_sr_data(str(_staged_files(root) / f"{name}.hdf5"), 3)
        true = load_image(str(voc / "SegmentationClassAug" / f"{name}.png"),
                          image_size=SIZE, normalize=False, is_png=True,
                          resize_method="nearest")
        per_image.append(threshold_tests.threshold_ious(
            cfg, cls, torch.from_numpy(angles), torch.from_numpy(shifts), true, 8, factors))
    want = np.mean(per_image, axis=0)
    np.testing.assert_allclose([averages[t] for t in factors], want, atol=1e-12)
    np.testing.assert_allclose([float(r[1]) for r in rows[1:]], want, atol=1e-12)


def test_test_sr_scores_and_saved_masks(tree):
    """test_SR on the bundled image: the IoUs of aug, max, mean and the
    standard mask equal those of ``asr_step`` with the seed's set; the
    saved masks are written. (--plot is not run here: importing matplotlib
    alone takes ~2 s.)"""
    root, _, _, _ = tree
    out = root / "sr_out"
    argv = ["--backbone", "mobilenet", "--num_aug", "3", "--num_iter", "3",
            "--shift_max", "6", "--device", "cpu", "--output_dir", str(out),
            "--save_images"]
    ious = test_SR.main(argv)
    args = test_SR.build_parser().parse_args(argv)
    model = _small_deeplab("mobilenet", device="cpu")
    image = load_image(args.img_path, image_size=SIZE)
    gt = load_image(args.gt_path, image_size=SIZE, normalize=False, is_png=True,
                    resize_method="nearest")
    angles, shifts = sample_augmentations(torch.Generator().manual_seed(SEED), 3, 0.15,
                                          6.0, device="cpu")
    cfg = SR_single_class.make_sr_config(num_aug=3, feature_size=(8, 8), output_size=SIZE,
                                         num_iter=3, angle_max=0.15)
    want = asr_step(model, torch.from_numpy(image), angles, shifts, cfg, 8, th_factor=0.2)
    assert ious == pytest.approx({k: metrics.compute_iou(gt, v.numpy(), class_id=8)
                                  for k, v in want.items()}, nan_ok=True)
    for sr_type in ("aug", "max", "mean"):
        assert (out / f"{sr_type}_SR" / f"smoke_input_{sr_type}_SR.png").exists()


def test_check_robustness_grid(tree):
    """A 2-point grid (two angles, no shift) over the three scenes in batches
    of 2 (a ragged tail): the CSV's header and combinations, each mean IoU
    equal to the per-image numpy mean IoU of the warped labels and the
    model's argmax, averaged over the images."""
    root, _, _, _ = tree
    out = root / "robustness.csv"
    check_robustness.main(["--num_samples", "3", "--angle_range", "0.05",
                           "--angle_step", "0.1", "--shift_max", "0", "--shift_steps", "1",
                           "--batch_size", "2", "--backbone", "mobilenet", "--device",
                           "cpu", "--output_csv", str(out)])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Angle", "Shift_x", "Shift_y", "Mean_IoU"]
    assert [(float(r[0]), float(r[1]), float(r[2])) for r in rows[1:]] == [
        (-0.05, 0.0, 0.0), (0.05, 0.0, 0.0)]
    model = _small_deeplab("mobilenet", device="cpu", final_upsample=True)
    voc = root / "data" / "dataset_root" / "VOCdevkit" / "VOC2012"
    images = torch.stack([torch.from_numpy(load_image(str(voc / "JPEGImages" / f"{n}.jpg"),
                                                      image_size=SIZE)) for n in NAMES])
    gts = torch.stack([torch.from_numpy(load_image(
        str(voc / "SegmentationClassAug" / f"{n}.png"), image_size=SIZE, normalize=False,
        is_png=True, resize_method="nearest")) for n in NAMES])
    for row in rows[1:]:
        aug, gt_aug = check_robustness.warp_batch(images, gts, float(row[0]), 0.0, 0.0)
        assert set(torch.unique(gt_aug).tolist()) <= set(torch.unique(gts).tolist()) | {0.0}
        with torch.no_grad():
            pred = model(aug).argmax(-1)
        want = np.mean([metrics.mean_iou(gt_aug[i, ..., 0].numpy(), pred[i].numpy())
                        for i in range(len(NAMES))])
        assert float(row[3]) == pytest.approx(want, abs=1e-6)


def _jax_cli(name):
    """A JAX CLI script's module (its parser), loaded from cli/."""
    cli_dir = os.path.join(REPO, "cli")
    sys.path.insert(0, cli_dir)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_cli_{name}",
                                                      os.path.join(cli_dir, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(cli_dir)
    return module


def test_sweep_agent_trials_and_proposals(tree, monkeypatch):
    """Two random trials over sweep.yaml's space (explicit flags win over its
    fixed values): two CSV rows with the sweep columns, lambdas on its
    0.05 grid, one stencil extraction across both trials; and the random
    and TPE proposals equal the JAX agent's for the same seed and history."""
    root, _, _, _ = tree
    made = []

    class Recording(SR_single_class.StencilCache):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(sweep_agent, "StencilCache", Recording)
    out = root / "agent.csv"
    config = os.path.join(REPO, "configs", "sweep_configs", "sweep.yaml")
    best = sweep_agent.main(["--config", config, "--trials", "2", "--method", "random",
                             "--output_csv", str(out), "--num_samples", "3",
                             "--num_aug", "3", "--num_iter", "3", "--angle_max", "0.2",
                             "--backbone", "mobilenet", "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and list(rows[0]) == sweep_script.CSV_FIELDS + [
        "standard_iou_single", "standard_iou_multiple", "aug_iou_single",
        "aug_iou_multiple", "max_iou", "mean_iou", "runtime_s"]
    for row in rows:
        assert row["num_iter"] == "3"
        for key in ("lambda_tv", "lambda_L2", "lambda_L1"):
            value = float(row[key])
            assert 0.0 <= value <= 5.0 and abs(value / 0.05 - round(value / 0.05)) < 1e-6
    assert len(made) == 1 and made[0].extractions == 1
    assert best[2]["aug_iou_single"] == max(float(r["aug_iou_single"]) for r in rows)

    import random
    import yaml

    jax_agent = _jax_cli("sweep_agent")
    with open(config) as f:
        params = yaml.safe_load(f)["parameters"]
    ours, theirs = sweep_agent.Space(params), jax_agent.Space(params)
    history = [(ours.sample(random.Random(s)), float(s)) for s in range(6)]
    assert history[0][0] == theirs.sample(random.Random(0))
    for seed in range(3):
        a = sweep_agent.TPE(ours, random.Random(seed), 0.3, 8).propose(history)
        b = jax_agent.TPE(theirs, random.Random(seed), 0.3, 8).propose(history)
        assert a == b


def test_validate_parity_smoke(tree):
    """--smoke runs every workload and exits 0: the four CSVs in the
    reference's schemas (validation's six IoU columns, the two-point
    threshold grid, the sweep row, the two-angle robustness grid)."""
    root, _, _, _ = tree
    out = root / "parity"
    with pytest.raises(SystemExit) as exc:
        validate_parity.main(["--smoke", "--device", "cpu", "--output_dir", str(out)])
    assert exc.value.code == 0
    with open(out / "argmax_validation_final.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Name"] + validate_parity.IOU_COLUMNS and rows[1][0] == "Class 8"
    with open(out / "th_argmax_1.csv") as f:
        assert [r[:2] for r in csv.reader(f)] == [["", "Th_Value"], ["0", "0.2"], ["1", "0.5"]]
    with open(out / "sweep_best_argmax.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["lambda_tv"] == "0.35"
    with open(out / "robustness_1_class_all.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Angle", "Shift_X", "Shift_Y", "mIoU"] and len(rows) == 3


def test_run_asr_profile_dir_writes_a_trace(tree):
    """run_asr --profile_dir: a torch.profiler Chrome trace of the steps
    after the first, with the second image's work in it."""
    root, voc, _, _ = tree
    trace_dir = root / "trace"
    summary = run_asr.main(["--images", str(voc / "JPEGImages"), "--limit", "2",
                            "--backbone", "mobilenet", "--num_aug", "2",
                            "--num_iter", "3", "--shift_max", "8", "--cache_dir", "",
                            "--writer_threads", "0", "--prefetch", "0", "--device", "cpu",
                            "--output_dir", str(root / "served"),
                            "--profile_dir", str(trace_dir)])
    assert summary["n_images"] == 2
    (trace,) = os.listdir(trace_dir)
    with open(trace_dir / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("shear" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)


@pytest.mark.parametrize("name", ["generate_augmented_copies", "generate_standard_output",
                                  "SR_single_class", "threshold_tests", "test_SR",
                                  "check_robustness", "sweep_script", "sweep_agent",
                                  "validate_parity"])
def test_cli_flags_and_defaults_match_jax_cli(name):
    """Every flag of the JAX CLI exists in the port with the same default
    (paths compared normalized), and the port's --device is 'cuda' by
    default (sweep_agent passes its other flags on to sweep_script)."""
    port = globals()[name].build_parser()
    ours = {a.dest: a.default for a in port._actions}
    for action in _jax_cli(name).parser._actions:
        if action.dest == "help":
            continue
        assert action.dest in ours, action.dest
        want, got = action.default, ours[action.dest]
        if isinstance(want, str) and os.sep in want:
            want, got = os.path.normpath(want), os.path.normpath(got)
        assert got == want, action.dest
    assert ours.get("device", "cuda") == "cuda"
    if name != "sweep_agent":
        assert "device" in ours
