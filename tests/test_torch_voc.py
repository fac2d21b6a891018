"""Port parity: the VOC training input and the last host-side CLIs.

The same numpy inputs go through the JAX package and the PyTorch port:
``data/host_augment.py`` (the JAX module on OpenCV, the port's on numpy),
``data/voc.py`` on a VOC tar built here, ``PascalVOC2012Dataset.batches``,
``cli.train --data voc`` on the CPU (MobileNetV2 alpha 0.35 at 32 px, no
JAX train step: ``test_torch_train.py`` holds the step), the JAX side's
F9 (ROADMAP Queue 3) on both packages, ``download_and_prepare_voc`` (the
archive placed on disk first, so nothing is fetched), ``analyze_results
--no_plots`` and ``utils/viz.py``.

Tolerances. The host ops reproduce OpenCV 5.0's arithmetic on uint8 images
(resize, warpAffine, GaussianBlur, RGB<->HSV), so every op and
``random_transform`` is held bit for bit, nearest-mode label warps
included; float32 images (OpenCV's float path, unquantised weights)
within 1e-5. The dataset decodes the same files with PIL; its resize to
``image_size`` is the TF-semantics resize of each package (float32 matrix
products summed in another order): images within 1e-5 without
augmentation; with it the image is truncated to uint8 before the warp, so
a value on an integer boundary may land one step apart: images within
1/255 + 1e-5, labels (nearest) exact. The .npz export truncates the same
way: images within 1, masks exact. Lists, colormaps, names and printed
summaries exactly.
"""

import os
import random
import runpy
import sys
import tarfile

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3plus_augmented_superresolution_tpu.data import host_augment as j_aug
from deeplabv3plus_augmented_superresolution_tpu.data import voc as j_voc
from deeplabv3plus_augmented_superresolution_tpu.data.dataset import (
    PascalVOC2012Dataset as JDataset)
from deeplabv3plus_augmented_superresolution_tpu.utils import viz as j_viz
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import (
    analyze_results, download_and_prepare_voc)
from deeplabv3plus_augmented_superresolution_tpu_torch.cli import train as cli_train
from deeplabv3plus_augmented_superresolution_tpu_torch.data import host_augment as aug
from deeplabv3plus_augmented_superresolution_tpu_torch.data import voc
from deeplabv3plus_augmented_superresolution_tpu_torch.data.dataset import PascalVOC2012Dataset
from deeplabv3plus_augmented_superresolution_tpu_torch.data.synthetic import synthetic_scene
from deeplabv3plus_augmented_superresolution_tpu_torch.utils import viz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# random_transform's parameter sets: the dataset's default, every option,
# and zoom without rotation (the resize path) with a shift.
TRANSFORMS = {
    "default": dict(flip_lr=True, rotation_range=(-10.0, 10.0), zoom_range=(0.8, 1.2),
                    brightness_range=(-20, 20)),
    "every option": dict(saturation_range=(-30, 30), value_range=(-20, 20),
                         brightness_range=(-20, 20), contrast_range=(-20, 20),
                         blur_params={"ksize_max": (9, 9), "sigma_max": (1.5, 1.5)},
                         flip_lr=True, rotation_range=(-10, 10), zoom_range=(0.8, 1.2),
                         shift_range=(6, 8)),
    "zoom and shift": dict(zoom_range=(0.7, 1.3), shift_range=(4, 6), flip_lr=True),
}


def _scenes(seed, n, sizes=((37, 45), (48, 40), (33, 61))):
    """uint8 images and label maps (classes 0/8/12, 255 contours) at mixed
    sizes, one row count past a multiple of 16 and 32 (OpenCV's vector
    blocks)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img, lab = synthetic_scene(rng, sizes[i % len(sizes)])
        out.append(((img * 255).astype(np.uint8), lab.astype(np.uint8)))
    return out


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["zoom", "rotate", "rotate_expand"])
def test_geometric_ops_match_opencv(op):
    """Image bilinear and label nearest, bit for bit, at zoom factors that
    shrink and grow (an exact halving too) and angles of both signs; a
    float32 image within 1e-5."""
    for k, (img, lab) in enumerate(_scenes(1, 6)):
        flt = img.astype(np.float32) / 255
        if op == "zoom":
            for f in (0.5, 0.83, 1.0, 1.27):
                _equal(aug.zoom(img, f), j_aug.zoom(img, f))
                _equal(aug.zoom(lab, f, aug.NEAREST), j_aug.zoom(lab, f, cv2.INTER_NEAREST))
                np.testing.assert_allclose(aug.zoom(flt, f), j_aug.zoom(flt, f), atol=1e-5)
        elif op == "rotate":
            for a in (-33.3, 7.5):
                _equal(aug.rotate(img, a), j_aug.rotate(img, a))
                _equal(aug.rotate(lab, a, aug.NEAREST), j_aug.rotate(lab, a, cv2.INTER_NEAREST))
        else:
            for a, s in ((-9.7, 0.83), (4.2, 1.19), (30.0, 1.0)):
                _equal(aug.rotate_expand(img, a, s), j_aug.rotate_expand(img, a, s))
                np.testing.assert_allclose(aug.rotate_expand(flt, a, s),
                                           j_aug.rotate_expand(flt, a, s), atol=1e-5)
                _equal(aug.rotate_expand(lab, a, s, aug.NEAREST, 255),
                       j_aug.rotate_expand(lab, a, s, cv2.INTER_NEAREST, 255))
                seed = 100 + k
                got = aug.random_rotate(img, lab, (-10, 10), (0.8, 1.2), rng=random.Random(seed))
                want = j_aug.random_rotate(img, lab, (-10, 10), (0.8, 1.2),
                                           rng=random.Random(seed))
                for g, w in zip(got, want):
                    _equal(g, w)


@pytest.mark.parametrize("op", ["blur", "hsv", "brightness and contrast"])
def test_photometric_ops_match_opencv(op):
    for k, (img, _) in enumerate(_scenes(2, 6)):
        if op == "blur":
            for ksize in (1, 3, 5, 7, 9, 11):
                _equal(aug.blur(img, ksize), j_aug.blur(img, ksize))
            for ksize_max, sigma_max in (((9, 9), (1.5, 1.5)), ((15, 21), (4.0, 0.5))):
                _equal(aug.random_blur(img, ksize_max, sigma_max, rng=random.Random(k)),
                       j_aug.random_blur(img, ksize_max, sigma_max, rng=random.Random(k)))
        elif op == "hsv":
            hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
            _equal(aug.rgb_to_hsv(img), hsv)
            _equal(aug.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
            for s, v in ((25, -17), (-40, 0), (0, 33)):
                _equal(aug.adjust_saturation_value(img, s, v),
                       j_aug.adjust_saturation_value(img, s, v))
            _equal(aug.adjust_saturation(img, 1.3), j_aug.adjust_saturation(img, 1.3))
        else:
            for b, c in ((17, 0), (-20, 11), (0, -25)):
                _equal(aug.adjust_brightness_contrast(img, b, c),
                       j_aug.adjust_brightness_contrast(img, b, c))
            _equal(aug.adjust_brightness(img, -13.5), j_aug.adjust_brightness(img, -13.5))
            _equal(aug.adjust_contrast(img, 1.4), j_aug.adjust_contrast(img, 1.4))
            np.testing.assert_array_equal(aug.remove_mean(img), j_aug.remove_mean(img))


def test_array_ops_codecs_and_files_match(tmp_path):
    """Crops, pads, shifts, the overlay, the label<->color codecs, the
    histogram, the file helpers and imread/imwrite (PNG, lossless) against
    the JAX module and OpenCV's own reads."""
    (img, lab), (img2, _) = _scenes(3, 2)
    for size in ((30, 50), (50, 30)):
        _equal(aug.pad_to(img, size, 7), j_aug.pad_to(img, size, 7))
        _equal(aug.center_crop(img, size), j_aug.center_crop(img, size))
        _equal(aug.pad_or_crop(lab, size, 255), j_aug.pad_or_crop(lab, size, 255))
    for got, want in ((aug.random_crop(img, lab, (20, 25), random.Random(4)),
                       j_aug.random_crop(img, lab, (20, 25), random.Random(4))),
                      (aug.random_shift(img, lab, (5, 7), rng=random.Random(5)),
                       j_aug.random_shift(img, lab, (5, 7), rng=random.Random(5)))):
        for g, w in zip(got, want):
            _equal(g, w)
    _equal(aug.flip_horizontal(img), j_aug.flip_horizontal(img))
    colors = aug.labels_to_colors(lab)
    _equal(colors, j_aug.labels_to_colors(lab))
    _equal(aug.colors_to_labels(colors), j_aug.colors_to_labels(colors))
    _equal(aug.colors_to_labels(colors, one_hot=True), j_aug.colors_to_labels(colors, True))
    _equal(aug.apply_mask(img, colors, 0.4), j_aug.apply_mask(img, colors, 0.4))
    for g, w in zip(aug.image_histogram(img), j_aug.image_histogram(img)):
        _equal(g, w)

    aug.imwrite(str(tmp_path / "rgb.png"), img)
    _equal(cv2.cvtColor(cv2.imread(str(tmp_path / "rgb.png")), cv2.COLOR_BGR2RGB), img)
    j_aug.imwrite(str(tmp_path / "cv.png"), img2)
    Image.fromarray(lab, mode="L").save(tmp_path / "gray.png")
    palette = Image.fromarray(lab, mode="P")
    palette.putpalette(voc.voc_colormap().ravel().tolist())
    palette.save(tmp_path / "palette.png")
    for name in ("rgb.png", "cv.png", "gray.png", "palette.png"):
        _equal(aug.imread(str(tmp_path / name)), j_aug.imread(str(tmp_path / name)))
    assert sorted(aug.list_files(str(tmp_path))) == sorted(j_aug.list_files(str(tmp_path)))
    assert aug.bytes_read(str(tmp_path / "rgb.png")) == j_aug.bytes_read(str(tmp_path / "rgb.png"))
    with pytest.raises(ValueError):
        aug.zoom(img, 1.1, interpolation=cv2.INTER_NEAREST)


@pytest.mark.parametrize("params", list(TRANSFORMS), ids=list(TRANSFORMS))
def test_random_transform_matches_jax(params):
    """The same draws from random.Random(seed) in the same order, so both
    packages take the same parameters and give the same pixels."""
    scenes = _scenes(4, 6)
    for seed, (img, lab) in enumerate(scenes):
        for target in ((40, 40), None):
            got = aug.random_transform(img, lab, target, seed=seed, **TRANSFORMS[params])
            want = j_aug.random_transform(img, lab, target, seed=seed, **TRANSFORMS[params])
            for g, w in zip(got, want):
                _equal(np.asarray(g), np.asarray(w))


def _voc_tree(root, names, size=(40, 48), labels_dir="SegmentationClass", seed=5,
              lists=None):
    """A VOC2012 tree under root: JPEGs, palette label PNGs and the split
    lists (split -> names)."""
    voc_root = os.path.join(root, "VOCdevkit", "VOC2012")
    for d in ("JPEGImages", labels_dir, "ImageSets/Segmentation"):
        os.makedirs(os.path.join(voc_root, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        img, lab = synthetic_scene(rng, size)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(voc_root, "JPEGImages", name + ".jpg"), quality=95)
        png = Image.fromarray(lab.astype(np.uint8), mode="P")
        png.putpalette(voc.voc_colormap().ravel().tolist())
        png.save(os.path.join(voc_root, labels_dir, name + ".png"))
    for split, listed in (lists or {"train": names[:-2], "val": names[-2:]}).items():
        with open(os.path.join(voc_root, "ImageSets", "Segmentation", split + ".txt"), "w") as f:
            f.write("\n".join(listed) + "\n")
    return voc_root


def _voc_tar(tmp_path, names):
    src = tmp_path / "src"
    _voc_tree(str(src), names)
    path = tmp_path / "VOCtrainval_11-May-2012.tar"
    with tarfile.open(path, "w") as tar:
        tar.add(src / "VOCdevkit", arcname="VOCdevkit")
    return path


def test_voc_functions_on_a_tar(tmp_path, capsys):
    """extract_file (then kept as unpacked), remove_gt_colormap,
    generate_dataset_files, get_basenames and export_arrayrecord of both
    packages on one tar; the classes and the palette."""
    names = [f"2008_{i:06d}" for i in range(6)]
    archive = _voc_tar(tmp_path, names)
    berkeley = tmp_path / "berkley"
    berkeley.mkdir()
    (berkeley / "train.txt").write_text("2008_000000\n2009_000001\n")
    (berkeley / "val.txt").write_text("2009_000002\n")
    assert voc.PASCAL_CLASSES == j_voc.PASCAL_CLASSES
    _equal(voc.voc_colormap(), j_voc.voc_colormap())
    outs = {}
    for tag, mod in (("port", voc), ("jax", j_voc)):
        dest = tmp_path / tag
        root = str(dest / "VOCdevkit" / "VOC2012")
        mod.extract_file(str(archive), str(dest), is_extracted=root)
        mod.extract_file(str(archive), str(dest), is_extracted=root)
        raw = str(dest / "raw")
        n = mod.remove_gt_colormap(os.path.join(root, "SegmentationClass"), raw)
        counts = mod.generate_dataset_files(root, str(berkeley), str(dest / "lists"))
        npz = mod.export_arrayrecord("train", root, str(dest / "records"), image_size=(32, 24),
                                     limit=3)
        outs[tag] = dict(n=n, counts=counts, names=list(mod.get_basenames("val", root)),
                         raw={f: np.asarray(Image.open(os.path.join(raw, f)))
                              for f in sorted(os.listdir(raw))},
                         lists={f: (dest / "lists" / f).read_text()
                                for f in ("trainaug.txt", "valaug.txt")},
                         npz=dict(np.load(npz)), out=capsys.readouterr().out)
    port, jax_ = outs["port"], outs["jax"]
    assert port["out"] == jax_["out"] and port["out"].count("already unpacked") == 1
    assert (port["n"], port["counts"], port["names"], port["lists"]) == \
        (jax_["n"], jax_["counts"], jax_["names"], jax_["lists"]) == \
        (6, (6, 2), names[-2:], port["lists"])
    assert port["raw"].keys() == jax_["raw"].keys()
    for f in port["raw"]:
        _equal(port["raw"][f], jax_["raw"][f])
    _equal(port["npz"]["masks"], jax_["npz"]["masks"])
    _equal(port["npz"]["basenames"], jax_["npz"]["basenames"])
    diff = np.abs(port["npz"]["images"].astype(int) - jax_["npz"]["images"].astype(int))
    assert port["npz"]["images"].shape == (3, 32, 24, 3) and diff.max() <= 1


def _dataset_tree(tmp_path, n=6, size=(40, 48)):
    names = [f"synth_{i:04d}" for i in range(n)]
    return _voc_tree(str(tmp_path), names, size=size, labels_dir="SegmentationClassAug",
                     lists={"train": names}), names


def _assert_batches_close(got, want, augment):
    assert len(got) == len(want) > 0
    atol = 1 / 255 + 1e-5 if augment else 1e-5
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.shape == wi.shape and gi.dtype == wi.dtype == np.float32
        np.testing.assert_allclose(gi, wi, rtol=0, atol=atol)
        _equal(gm, wm)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_dataset_batches_match_jax(tmp_path, augment):
    """Same names in the same shuffled order, the ragged tail dropped, the
    resize to image_size and the default augmentation; a decode handed in
    as arrays gives the file decode's batches; an error in the prefetch
    thread reaches the caller."""
    root, names = _dataset_tree(tmp_path)
    size = (32, 36)
    port = PascalVOC2012Dataset(root, image_size=size)
    ref = JDataset(root, image_size=size)
    assert port.CLASS_LABELS == ref.CLASS_LABELS and port.IGNORE_LABEL == ref.IGNORE_LABEL
    kw = dict(shuffle=True, seed=9, augment=augment)
    got = list(port.batches("train", 4, **kw))
    _assert_batches_close(got, list(ref.batches("train", 4, **kw)), augment)
    assert len(got) == 1 and got[0][0].shape == (4, 32, 36, 3) and got[0][1].shape == (4, 32, 36, 1)
    decoded = {name: port.decode_files(name) for name in names}
    arrays = PascalVOC2012Dataset(root, image_size=size,
                                  decode=lambda name: (decoded[name][0].astype(np.uint8),
                                                       decoded[name][1][..., 0].astype(np.uint8)))
    for (a, am), (b, bm) in zip(arrays.batches("train", 2, **kw), port.batches("train", 2, **kw)):
        _equal(a, b)
        _equal(am, bm)

    def broken(name):
        raise OSError(f"cannot decode {name}")

    with pytest.raises(OSError, match="cannot decode"):
        list(PascalVOC2012Dataset(root, image_size=size, decode=broken).batches("train", 2))


class _RecordingDataset(PascalVOC2012Dataset):
    """The port's dataset, recording each epoch's arguments and the batches
    the training loop took from it."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.epochs = []

    def batches(self, split, batch_size, **kw):
        taken = []
        self.epochs.append(((split, batch_size), kw, taken))
        for item in super().batches(split, batch_size, **kw):
            taken.append(item)
            yield item


def test_train_voc_on_the_cpu(tmp_path):
    """cli.train --data voc --augment --warp_augment: 3 steps over a split
    of 4 at batch 2, so the second epoch restarts with seed + 2; finite
    losses at each --log_every step; the batches it took equal the JAX
    dataset's, epoch by epoch; a checkpoint at the end."""
    root, _ = _dataset_tree(tmp_path, n=4, size=(40, 36))
    args = cli_train.parse_args([
        "--data", "voc", "--pascal_root", root, "--split", "train", "--augment",
        "--warp_augment", "--device", "cpu", "--backbone", "mobilenet", "--alpha", "0.35",
        "--size", "32", "--batch", "2", "--steps", "3", "--log_every", "1",
        "--compute_dtype", "float32", "--save_params", "", "--seed", "3",
        "--ckpt_dir", str(tmp_path / "ck"), "--ckpt_every", "3"])
    dataset = _RecordingDataset(root, image_size=(32, 32))
    summary, timing = cli_train.train(args, dataset=dataset)
    assert len(summary["losses"]) == 3 and np.all(np.isfinite(summary["losses"]))
    assert summary["held_out_miou"] is None and summary["total_steps"] == 3
    assert [d for d, _ in timing["prefetch_wait"]] == [1, 2, 3]
    assert (tmp_path / "ck" / "step_3.npz").exists()
    assert [kw["seed"] for _, kw, _ in dataset.epochs] == [3, 5]
    assert [len(taken) for _, _, taken in dataset.epochs] == [2, 1]
    ref = JDataset(root, image_size=(32, 32))
    for (split, batch), kw, taken in dataset.epochs:
        _assert_batches_close(taken, list(ref.batches(split, batch, **kw))[:len(taken)],
                              augment=True)


def test_f9_trainaug_list_is_not_where_the_dataset_reads(tmp_path, capsys):
    """ROADMAP F9: generate_dataset_files writes trainaug.txt to its own
    folder (data/augmented_file_lists), the datasets read
    ImageSets/Segmentation/<split>.txt, so the default --split trainaug
    raises FileNotFoundError on a tree those tools prepared, in both
    packages and in the port's train CLI."""
    root, _ = _dataset_tree(tmp_path, n=4)
    (tmp_path / "berkley").mkdir()
    for name in ("train.txt", "val.txt"):
        (tmp_path / "berkley" / name).write_text("")
    with open(os.path.join(root, "ImageSets", "Segmentation", "val.txt"), "w") as f:
        f.write("synth_0003\n")
    for mod in (voc, j_voc):
        assert mod.generate_dataset_files(root, str(tmp_path / "berkley"),
                                          str(tmp_path / "lists")) == (3, 1)
    for ds in (PascalVOC2012Dataset(root), JDataset(root)):
        with pytest.raises(FileNotFoundError, match="trainaug.txt"):
            ds.get_basenames("trainaug")
    args = cli_train.parse_args(["--data", "voc", "--pascal_root", root, "--device", "cpu",
                                 "--backbone", "mobilenet", "--alpha", "0.35", "--size",
                                 "32", "--steps", "1", "--save_params", ""])
    with pytest.raises(FileNotFoundError, match="trainaug.txt"):
        cli_train.train(args)
    capsys.readouterr()


def _run_jax_cli(name, argv):
    """The JAX repository's cli/<name>.py as its own __main__ (its _common
    puts the repository on sys.path and sets TPU variables, undone here)."""
    saved, env = sys.argv[:], dict(os.environ)
    sys.path.insert(0, os.path.join(REPO, "cli"))
    try:
        sys.argv = [name] + argv
        runpy.run_path(os.path.join(REPO, "cli", name + ".py"), run_name="__main__")
    finally:
        sys.argv = saved
        sys.path.remove(os.path.join(REPO, "cli"))
        os.environ.clear()
        os.environ.update(env)


def test_download_and_prepare_voc_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs in their own working directory, the archive already under
    data/dataset_root (kept, not fetched): unpack, strip the colormap, the
    file lists and the export; the same files and the same stdout."""
    names = [f"2010_{i:06d}" for i in range(5)]
    archive = _voc_tar(tmp_path, names)
    argv = ["--remove_cmap", "--generate_file_lists", "--generate_tf_records"]
    outs = {}
    for tag in ("port", "jax"):
        cwd = tmp_path / tag
        (cwd / "data" / "dataset_root").mkdir(parents=True)
        (cwd / "data" / "berkley_file_lists").mkdir()
        for split in ("train", "val"):
            (cwd / "data" / "berkley_file_lists" / f"{split}.txt").write_text("2011_000001\n")
        (cwd / "data" / "dataset_root" / archive.name).write_bytes(archive.read_bytes())
        monkeypatch.chdir(cwd)
        if tag == "port":
            download_and_prepare_voc.main(argv)
        else:
            _run_jax_cli("download_and_prepare_voc", argv)
        root = cwd / "data" / "dataset_root"
        outs[tag] = dict(
            out=capsys.readouterr().out.replace(str(cwd), "<cwd>"),
            files=sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*") if p.is_file()),
            lists=[(cwd / "data" / "augmented_file_lists" / f).read_text()
                   for f in ("trainaug.txt", "valaug.txt")],
            raw=[np.asarray(Image.open(p)) for p in
                 sorted((root / "VOCdevkit" / "VOC2012" / "SegmentationClassRaw").iterdir())],
            npz=[dict(np.load(root / "ArrayRecords" / f"segmentation_{s}.npz"))
                 for s in ("train", "val")])
    port, jax_ = outs["port"], outs["jax"]
    assert port["out"] == jax_["out"] and "already on disk, not re-fetching" in port["out"]
    assert port["files"] == jax_["files"] and port["lists"] == jax_["lists"]
    for a, b in zip(port["raw"], jax_["raw"]):
        _equal(a, b)
    for a, b in zip(port["npz"], jax_["npz"]):
        _equal(a["masks"], b["masks"])
        _equal(a["basenames"], b["basenames"])
        assert a["images"].shape == b["images"].shape
        assert np.abs(a["images"].astype(int) - b["images"].astype(int)).max() <= 1


def test_analyze_results_matches_jax(tmp_path, monkeypatch, capsys):
    """--no_plots over the four CSV kinds the test writes (and over an empty
    folder): the same summary lines as the JAX CLI."""
    import pandas as pd

    rng = np.random.default_rng(6)
    pd.DataFrame({"th_factor": np.linspace(0.1, 0.9, 9),
                  "avg_iou": rng.random(9)}).to_csv(tmp_path / "th_8.csv", index=False)
    grid = [(a, x, y) for a in (-0.2, 0.0, 0.2) for x in (-8, 0, 8) for y in (-8, 0, 8)]
    pd.DataFrame({"Angle": [g[0] for g in grid], "Shift_x": [g[1] for g in grid],
                  "Shift_y": [g[2] for g in grid], "Mean_IoU": rng.random(len(grid))}
                 ).to_csv(tmp_path / "robustness_argmax.csv", index=False)
    pd.DataFrame({"lambda_tv": rng.random(5), "lambda_L2": rng.random(5),
                  "lambda_L1": rng.random(5), "aug_iou_single": rng.random(5)}
                 ).to_csv(tmp_path / "sweep_8.csv", index=False)
    pd.DataFrame({"Name": [f"Class {i}" for i in range(4)],
                  **{c: rng.random(4) for c in ("aug_iou_single", "standard_iou_single",
                                                "max_iou", "mean_iou")}}
                 ).to_csv(tmp_path / "argmax_validation_final.csv", index=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    for folder in (tmp_path, empty):
        argv = ["--experiments_dir", str(folder), "--no_plots"]
        analyze_results.main(argv)
        port = capsys.readouterr().out
        monkeypatch.chdir(tmp_path)
        _run_jax_cli("analyze_results", argv)
        assert port == capsys.readouterr().out
        assert port.count("\n") == (5 if folder == tmp_path else 1)


def test_viz_functions(tmp_path, capsys):
    """plot_images, plot_image, plot_histogram write their PNGs and draw the
    JAX functions' panels (those drawn without a path, shown on the
    headless backend); print_labels prints the same counts."""
    import matplotlib.pyplot as plt

    (img, lab), (img2, lab2) = _scenes(7, 2)
    figs = {}
    for mod, tag in ((viz, "port"), (j_viz, "jax")):
        path = (lambda kind: str(tmp_path / f"{kind}.png")) if tag == "port" else \
            (lambda kind: None)
        figs[tag] = [mod.plot_images([img, lab, img2], 1, 3, save_path=path("grid")),
                     mod.plot_image(lab2, save_path=path("one")),
                     mod.plot_histogram(img, save_path=path("hist"))]
        mod.print_labels([lab, lab2])
        if tag == "port":
            port_out = capsys.readouterr().out
    assert port_out == capsys.readouterr().out and port_out.startswith("Standard Labels: {0: ")
    for a, b in zip(figs["port"], figs["jax"]):
        assert len(a.axes) == len(b.axes)
        for ax_a, ax_b in zip(a.axes, b.axes):
            for im_a, im_b in zip(ax_a.images, ax_b.images):
                np.testing.assert_array_equal(im_a.get_array(), im_b.get_array())
            assert [p.get_height() for p in ax_a.patches] == [p.get_height() for p in ax_b.patches]
        plt.close(b)
    for kind in ("grid", "one", "hist"):
        assert (tmp_path / f"{kind}.png").stat().st_size > 0
