"""Least time of the copies' warp (``counts.copies_warp_bytes`` over the
HBM bandwidth) over the device time under the ``warp`` stage, in %."""

from ..peaks import HBM_BYTES_PER_S


def read(run):
    t = run.trace
    device_s = t["stage_device_s"].get("warp") if t else None
    if not device_s:
        return None
    return run.warp_bytes_per_step * t["steps"] / HBM_BYTES_PER_S / device_s * 100.0
