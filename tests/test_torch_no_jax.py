"""The port imports neither jax nor the JAX package, and its array cores load
none of the file libraries the card's machine lacks.

The card's machine has no JAX, so a module of the port that imported it (or
any module of the JAX package, whose ``__init__`` imports jax) would fail
there. Nor does it have h5py, pandas, tqdm, yaml, PIL, OpenCV or
matplotlib, so the modules that ``chip_smoke.py`` drives on the card (the
VOC input's ``data.voc``, ``data.host_augment`` and ``data.dataset`` and
the quality-evidence scripts among them) import them only inside the functions that read or draw files. One fresh interpreter imports those array
cores and lists what was loaded, then the port's entry points and lists it
again; it also draws an image's augmentation set, which must equal this
process's draw (hash() is salted per process; the port seeds from CRC-32).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from deeplabv3plus_augmented_superresolution_tpu_torch.pipeline.feature_maps import (
    draw_augmentations,
)

PORT = "deeplabv3plus_augmented_superresolution_tpu_torch"
JAX_PACKAGE = "deeplabv3plus_augmented_superresolution_tpu"
# What chip_smoke.py imports to drive the paths on the card.
ARRAY_CORES = [f"{PORT}.{m}" for m in (
    "cli.run_asr", "cli.train", "models.train", "data.synthetic", "pipeline.feature_maps",
    "sr.orchestrate", "cli.generate_augmented_copies", "cli.generate_standard_output",
    "cli.SR_single_class", "cli.threshold_tests", "cli.check_robustness", "ops.warp",
    "parallel", "parallel.mesh", "parallel.sharded", "data.voc", "data.host_augment",
    "data.dataset", "scripts.common", "scripts.quality_demo", "scripts.ab_stats",
    "scripts.label_map_eval", "scripts.per_class_validation", "scripts.ab_cg_vs_adam",
    "scripts.ab_serving_vs_strict")]
ENTRY_POINTS = ARRAY_CORES + [f"{PORT}.cli.{m}" for m in (
    "test_SR", "sweep_script", "sweep_agent", "validate_parity", "download_and_prepare_voc",
    "analyze_results")] + [f"{PORT}.scripts.make_synthetic_voc"]
FILE_LIBRARIES = ("h5py", "pandas", "tqdm", "yaml", "PIL", "cv2", "matplotlib")
DRAW = dict(seed=1234, image_name="2007_000032", num_aug=4, angle_max=0.3, shift_max=30.0)


@pytest.fixture(scope="module")
def report():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, json, sys\n"
            "import numpy, torch\n"
            "base = sorted(sys.modules)\n"
            f"for name in {ARRAY_CORES!r}:\n"
            "    importlib.import_module(name)\n"
            "cores = sorted(sys.modules)\n"
            f"for name in {ENTRY_POINTS!r}:\n"
            "    importlib.import_module(name)\n"
            f"from {PORT}.pipeline.feature_maps import draw_augmentations\n"
            f"a, s = draw_augmentations(**{DRAW!r}, device='cpu')\n"
            "print(json.dumps({'base': base, 'cores': cores, 'all': sorted(sys.modules),\n"
            "                  'draw': [a.tolist(), s.tolist()]}))")
    env = dict(os.environ, PYTHONPATH=root, PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(report):
    loaded = report["all"]
    assert set(ENTRY_POINTS) <= set(loaded)
    offending = [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == JAX_PACKAGE or m.startswith(JAX_PACKAGE + ".")]
    assert not offending, offending


def test_array_cores_load_no_file_libraries(report):
    """Neither the array cores nor any entry point loads a file library at
    import (beyond what torch itself loads where the library is installed):
    the CLIs import them inside their file-reading functions."""
    base = set(report["base"])
    for key in ("cores", "all"):
        offending = [m for m in report[key]
                     if m.split(".")[0] in FILE_LIBRARIES and m not in base]
        assert not offending, (key, offending)


def test_per_image_sets_are_the_same_in_every_process(report):
    """ROADMAP F5: generate_augmented_copies draws an image's set from the
    seed and the CRC-32 of its name, so another process with another hash
    salt draws the same set (the reference's abs(hash(name)) does not)."""
    angles, shifts = draw_augmentations(**DRAW, device="cpu")
    assert torch.equal(angles, torch.tensor(report["draw"][0]))
    assert torch.equal(shifts, torch.tensor(report["draw"][1]))
    other, _ = draw_augmentations(**dict(DRAW, image_name="2007_000033"), device="cpu")
    assert not torch.equal(angles, other)
    shared, _ = draw_augmentations(**DRAW, shared_tta=True, device="cpu")
    assert torch.equal(shared, draw_augmentations(**dict(DRAW, image_name="x"),
                                                  shared_tta=True, device="cpu")[0])
