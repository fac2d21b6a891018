"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root, the
configuration's file that it names, ``<paths[0]>/workloads/<cell>.json``
and ``asr_bench.metrics.<metric>``. Nothing here lists a cell, a
configuration or a metric: adding one is adding its files and its entries.
"""

import dataclasses
import importlib
import json
import os
from typing import Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, bench["paths"][0], "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    if workload.get("traffic", entry["traffic"]) != entry["traffic"]:
        raise SystemExit(f"{name}: traffic {workload.get('traffic')!r} in its file, "
                         f"{entry['traffic']!r} in BENCHMARK.json")
    return Cell(name=name, chips=entry["chips"], config=config, workload=workload,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(run)`` of ``asr_bench/metrics/<metric>.py``."""
    return importlib.import_module(f"asr_bench.metrics.{metric}").read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found something."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
