"""Least time of the aug solve, the larger of its operations over the
float32 peak and its bytes over the HBM bandwidth (``counts.solve``), over
the device time under the ``solve_steps`` stage, in %."""

from ..peaks import F32_FLOPS, HBM_BYTES_PER_S


def read(run):
    t = run.trace
    device_s = t["stage_device_s"].get("solve_steps") if t else None
    if not device_s:
        return None
    least = max(run.solve_ops_per_step / F32_FLOPS,
                run.solve_bytes_per_step / HBM_BYTES_PER_S)
    return least * t["steps"] / device_s * 100.0
