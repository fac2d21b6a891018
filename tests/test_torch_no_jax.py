"""The port imports neither jax nor the JAX package.

The card's machine has no JAX, so a module of the port that imported it (or
any module of the JAX package, whose ``__init__`` imports jax) would fail
there. A fresh interpreter imports the port's entry points and its training
module and lists what was loaded.
"""

import json
import os
import subprocess
import sys

PORT = "deeplabv3plus_augmented_superresolution_tpu_torch"
JAX_PACKAGE = "deeplabv3plus_augmented_superresolution_tpu"
ENTRY_POINTS = [f"{PORT}.cli.run_asr", f"{PORT}.cli.train", f"{PORT}.models.train"]


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, json, sys\n"
            f"for name in {ENTRY_POINTS!r}:\n"
            "    importlib.import_module(name)\n"
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(ENTRY_POINTS) <= set(loaded)
    offending = [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == JAX_PACKAGE or m.startswith(JAX_PACKAGE + ".")]
    assert not offending, offending
