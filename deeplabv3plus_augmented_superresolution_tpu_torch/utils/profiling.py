"""Per-stage wall times, profiler traces and the device summary (port of the
JAX package's ``utils/profiling.StageTimer``, ``trace_to`` and
``device_summary``).

With ``sync_device`` set, each stage is bracketed by
``torch.cuda.synchronize(device)``, so its wall time covers the device work
it enqueued (serializing: for sequential profiling). Without it, stages
record pure wall time under a lock, safe inside overlapped pipelines.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    def __init__(self, sync_device: Optional[torch.device] = None):
        self.sync_device = sync_device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.maxes: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def _sync(self):
        if self.sync_device is not None and self.sync_device.type == "cuda":
            torch.cuda.synchronize(self.sync_device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] += elapsed
                self.counts[name] += 1
                self.maxes[name] = max(self.maxes[name], elapsed)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """max_s separates a slow first call: steady-state ms/call =
        (total_s - max_s) / (calls - 1) when calls > 1."""
        with self._lock:
            out = {}
            for name, total in self.totals.items():
                count, mx = self.counts[name], self.maxes[name]
                d = {"total_s": total, "calls": count,
                     "ms_per_call": total / max(count, 1) * 1000, "max_s": mx}
                if count > 1:
                    d["steady_ms_per_call"] = (total - mx) / (count - 1) * 1000
                out[name] = d
            return out


@contextlib.contextmanager
def trace_to(log_dir: str):
    """A torch.profiler trace of the block (host activity, and the card's
    when CUDA is available), written to ``log_dir/trace_<pid>.json`` as a
    Chrome trace (open with Perfetto) when the block exits; the card is
    synchronised first, so the trace holds the block's device work."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def device_summary() -> str:
    """The visible CUDA cards with the memory in use on each (torch's
    allocator) over its total, or the CPU when there is none."""
    if not torch.cuda.is_available():
        return "1 device(s), platform=cpu"
    count = torch.cuda.device_count()
    lines = [f"{count} device(s), platform=cuda"]
    for i in range(count):
        used = torch.cuda.memory_allocated(i) / 2**30
        total = torch.cuda.get_device_properties(i).total_memory / 2**30
        lines.append(f"  cuda:{i} {torch.cuda.get_device_name(i)}: "
                     f"{used:.2f}/{total:.2f} GiB in use")
    return "\n".join(lines)
