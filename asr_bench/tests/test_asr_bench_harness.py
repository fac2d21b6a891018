"""The harness on the CPU: a throwaway configuration and cell (files and
entries only, no code edited) run end to end and print the contract's
result line; without a card the command prints no result."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from asr_bench import run
from asr_bench.tests.tiny import CELL, ROOT, make_tree, tiny_bands

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tmp_path, trace):
    root = make_tree(str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err), tiny_bands():
        run.run_and_report(root, CELL, 2 ** 31 + 17, 0.5, trace, "cpu")
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_throwaway_cell_runs_and_prints_the_contract_line(tmp_path):
    line, err = _run(tmp_path, trace=False)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}   # no card: no peak
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(tail, line["checks"].items()):
        assert text.startswith(f"check {name} = ") and repr(c["limit"]) in text


def test_traced_line_carries_the_breakdown(tmp_path):
    line, _ = _run(tmp_path, trace=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "dispatch_ms" in line["metrics"]


def test_without_a_card_there_is_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "asr_bench.run", "--workload",
                           "xception-b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.requires_cuda
def test_cell_on_the_card(cuda):
    """One short run of the first cell on the card (run on the chip)."""
    proc = subprocess.run([sys.executable, "-m", "asr_bench.run", "--workload",
                           "xception-b4", "--seed", "5", "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
