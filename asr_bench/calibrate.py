"""Readings that the check's limits are set from, on the card.

  python3 -m asr_bench.calibrate --workload <cell> --seeds <n> [--first <seed>]
      [--control_seeds <n>] [--fault_seeds <n>] [--out <file>]

For each seed, one run of the cell that serves a step (the cell's own
batch, classes and sizes) and checks the sampled images as every run does.
On the first ``--control_seeds`` seeds the control (the reference with its
network in float8, ``check.control``) is judged on the same images by the
same numbers and limits, and on the first ``--fault_seeds`` each fault of
``faults.FAULTS`` that the cell can have is planted under ``serve`` and the
same images served again and judged. One JSON line per seed (each variant's
numbers and ``correct``), then the largest program reading and the smallest
control and fault readings of each number. The benchmark's own runs never
run the control or a fault.
"""

import argparse
import json
import sys

from . import run
from .faults import FAULTS


def cell_faults(batch: int):
    """The faults a cell can have: half of a batch of one is the batch."""
    return [f for f in FAULTS if batch > 1 or f != "half_the_batch_left_out"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first", type=int, default=3_000_000_001)
    parser.add_argument("--control_seeds", type=int, default=3)
    parser.add_argument("--fault_seeds", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    batch = run.load_cell(run.ROOT, args.workload).workload["batch"]
    rows = []
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        res = run.run_cell(run.ROOT, args.workload, seed, 0.0, False, "cuda:0",
                           control=k < args.control_seeds, scene_count=batch,
                           faults=cell_faults(batch) if k < args.fault_seeds else ())
        detail = res["detail"]
        row = {"seed": seed, "correct": res["correct"], "classes": detail["classes"],
               "check_s": detail["check_s"], "reading": detail["reading"],
               "variants": detail["variants"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    for name in rows[0]["reading"]["numbers"]:
        line = [f"program max {max(r['reading']['numbers'][name] for r in rows)!r}"]
        for variant in rows[0]["variants"]:
            seen = [r["variants"][variant] for r in rows if variant in r["variants"]]
            line.append(f"{variant} min {min(v['numbers'][name] for v in seen)!r} "
                        f"(correct on {sum(v['correct'] for v in seen)} of {len(seen)})")
        print(f"{name}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
