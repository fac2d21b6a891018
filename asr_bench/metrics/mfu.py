"""The profiled steps' FLOPs (``counts.step_flops``: the forward's
convolutions and resizes of every copy, the solve, the shear passes) over
the profiled stretch's length times the H100's dense bf16 peak, in %."""

from ..peaks import BF16_DENSE_FLOPS


def read(run):
    t = run.trace
    if not t or t["steps"] == 0 or t["busy_s"] <= 0:
        return None
    return run.flops_per_step * t["steps"] / (t["window_s"] * BF16_DENSE_FLOPS) * 100.0
