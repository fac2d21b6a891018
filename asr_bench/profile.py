"""The timer the benchmark hands to ``serve`` and the reduction of its trace.

``serve(timer=...)`` hands ``asr_step``'s stages (warp, forward, opm,
max_mean, b, solve_steps, threshold, standard) to ``timer.stage(name)``.
``StageRanges`` opens a ``torch.profiler.record_function`` range for each
and never synchronises. Given
``profile_steps = (first, count)`` it synchronises the card and starts the
profiler as step ``first`` begins, and synchronises and stops it as step
``first + count`` begins, so the trace holds exactly those steps' device
work. The trace stays in memory and is reduced at once (``reduce_trace``)
to per-stage device time and kernel counts, the union of the device's busy
intervals, the top device operations and the longest idle gaps.
"""

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

FIRST_STAGE = "warp"
STAGES = ("warp", "forward", "opm", "max_mean", "b", "solve_steps", "threshold",
          "standard")
NAME_CHARS = 160
# Host events of the CUDA runtime and driver APIs (the launches), and the
# device events that are copies or fills rather than kernels.
LAUNCH_PREFIXES = ("cuda", "cu")
COPY_PREFIXES = ("Memcpy", "Memset")


class StageRanges:
    def __init__(self, profile_steps: Optional[Tuple[int, int]] = None):
        self.profile_steps = profile_steps
        self.step = -1
        self.trace: Optional[dict] = None
        self._prof = None
        self._t_start = 0.0
        self._first = -1

    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _start(self):
        self._sync()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t_start = time.perf_counter()
        self._first = self.step

    def stop(self):
        """End the profiled stretch (if one is open) and reduce its trace."""
        if self._prof is None:
            return
        self._sync()
        window_s = time.perf_counter() - self._t_start
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self.trace = reduce_trace(events, window_s, self.step - self._first)
        self._prof = None

    @contextlib.contextmanager
    def stage(self, name: str):
        if name == FIRST_STAGE:
            self.step += 1
            if self.profile_steps is not None:
                first, count = self.profile_steps
                if self.step == first:
                    self._start()
                elif self.step == first + count:
                    self.stop()
        with record_function(name):
            yield

    def as_dict(self) -> Dict:
        return {}


def _is_annotation(event) -> bool:
    return bool(getattr(event, "is_user_annotation", lambda: False)())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def reduce_trace(events, window_s: float, steps: int) -> dict:
    """Per-stage device seconds and kernel counts, busy seconds, the top
    device operations and the longest idle gaps of one profiled stretch. A
    device event carries the correlation id of the runtime or driver call
    that launched it; the stage is the host range around that call."""
    ranges: List[Tuple[int, int, str]] = []
    launch_ns: Dict[int, int] = {}
    device: List[Tuple[int, int, str, int, bool]] = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name in STAGES:
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif name.startswith(LAUNCH_PREFIXES):
                launch_ns[e.correlation_id()] = e.start_ns()
        elif not (name in STAGES or _is_annotation(e)):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id(), not name.startswith(COPY_PREFIXES)))
    ranges.sort()
    starts = [r[0] for r in ranges]

    def stage_at(t_ns: Optional[int]) -> Optional[str]:
        if t_ns is None:
            return None
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and ranges[i][0] <= t_ns <= ranges[i][1]:
            return ranges[i][2]
        return None

    stage_s: Dict[str, float] = defaultdict(float)
    stage_kernels: Dict[str, int] = defaultdict(int)
    by_name: Dict[str, float] = defaultdict(float)
    for start, end, name, corr, is_kernel in device:
        stage = stage_at(launch_ns.get(corr)) or "outside"
        stage_s[stage] += (end - start) * 1e-9
        stage_kernels[stage] += is_kernel
        by_name[name[:NAME_CHARS]] += (end - start) * 1e-9
    busy = _union([(s, e) for s, e, *_ in device])
    gaps = [(busy[i + 1][0] - busy[i][1], stage_at((busy[i][1] + busy[i + 1][0]) // 2))
            for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: -g[0])
    return {
        "steps": steps,
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "stage_device_s": dict(stage_s),
        "stage_kernels": dict(stage_kernels),
        "kernels": sum(k for *_, k in device),
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[f"host in {stage or 'serve loop, outside asr_step'}", g * 1e-9]
                      for g, stage in gaps[:10]],
    }
