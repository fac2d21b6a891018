"""A throwaway benchmark tree for the CPU tests: a copy of BENCHMARK.json
with one more configuration and cell, and their files. The configuration is
MobileNetV2 at its published widths on 64-px inputs, float32, with 4
copies and 60 solve steps at a learning rate of 0.02, so that the solve
moves the estimate by as much as the check can see at this size; the cell
serves batches of 2 and checks 2 images. Nothing of the harness is edited
to run it. Under ``tiny_bands()`` the check's network margin bands are
narrowed to 0.001 (float32 on both sides), the estimate band to 0.03 and
the rim to 2 pixels, as fits this size."""

import copy
import json
import os
from unittest import mock

from asr_bench import check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny-mobilenet"
CELL = "tiny-b2"
BANDS = {"margin_band": 0.001, "copy_margin_band": 0.001, "estimate_band": 0.03,
         "border_band": 2}


def tiny_bands():
    """The check's bands for the tiny cell, for the length of a with block."""
    return mock.patch.dict(check.BANDS, BANDS)


def make_tree(dest: str, limits=None, workload_overrides=None) -> str:
    """A tree at dest holding BENCHMARK.json (the repository's, plus the
    tiny configuration and cell) and their files under asr_bench/."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "asr_bench", "configs", "mobilenetv2-os8.json")) as f:
        cfg = json.load(f)
    cfg.update(name=TINY, input_size=[64, 64], compute_dtype="float32")
    cfg["asr"] = dict(cfg["asr"], num_aug=4, num_iter=60, shift_max=6.0)
    cfg["asr"]["optimizer"] = dict(cfg["asr"]["optimizer"], learning_rate=0.02)
    with open(os.path.join(ROOT, "asr_bench", "workloads", "mobilenetv2-b4.json")) as f:
        wl = json.load(f)
    wl.update(name=CELL, batch=2, warm_steps=1, trace=[1, 1])
    wl["scenes"] = dict(wl["scenes"], count=64, threads=2)
    wl["check"] = {"images": 2, "limits": limits or {"violation_pct": 100.0, "flip_margin": 1.0,
                                                     "solve_miss_pct": 100.0}}
    wl.update(workload_overrides or {})
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": TINY, "source": "test", "reduced": ["input_size"],
                             "file": f"asr_bench/configs/{TINY}.json", "why": "test"})
    bench["workloads"].append({"name": CELL, "config": TINY, "traffic": wl["traffic"],
                               "chips": 1, "why": "test"})
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(dest, "asr_bench", sub), exist_ok=True)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(dest, "asr_bench", "configs", f"{TINY}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dest, "asr_bench", "workloads", f"{CELL}.json"), "w") as f:
        json.dump(wl, f)
    return dest
