"""Device time of the kernels launched under the ``forward`` stage, ms per
image (device trace)."""


def read(run):
    t = run.trace
    if not t or t["steps"] == 0 or not t["stage_device_s"].get("forward"):
        return None
    return t["stage_device_s"]["forward"] * 1e3 / (t["steps"] * run.batch)
