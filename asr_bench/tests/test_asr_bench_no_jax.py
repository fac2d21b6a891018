"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package.

One fresh interpreter imports every module of the benchmark, runs a tiny
cell end to end on the CPU (which imports what the run imports lazily, the
program's modules among them) and lists ``sys.modules``. Top-level names
are compared whole: the program's package name begins with the JAX
package's."""

import json
import os
import pkgutil
import subprocess
import sys

import asr_bench
from asr_bench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "deeplabv3plus_augmented_superresolution_tpu"}


def test_benchmark_imports_no_jax(tmp_path):
    modules = [m.name for m in pkgutil.walk_packages(asr_bench.__path__, "asr_bench.")
               if ".tests" not in m.name and not m.name.startswith("asr_bench.pil")]
    code = ("import importlib, io, json, sys, contextlib\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "from asr_bench.tests.tiny import make_tree, CELL\n"
            "from asr_bench import run\n"
            f"root = make_tree({str(tmp_path)!r})\n"
            "with contextlib.redirect_stdout(io.StringIO()), "
            "contextlib.redirect_stderr(io.StringIO()):\n"
            "    run.run_and_report(root, CELL, 3, 0.2, True, 'cpu')\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "asr_bench.run" in loaded and "asr_bench.metrics.mfu" in loaded
    assert "deeplabv3plus_augmented_superresolution_tpu_torch.cli.run_asr" in loaded
    offending = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not offending, offending
