"""Device time of the kernels launched under the ``solve_steps`` stage, ms
per image (device trace)."""


def read(run):
    t = run.trace
    if not t or t["steps"] == 0 or not t["stage_device_s"].get("solve_steps"):
        return None
    return t["stage_device_s"]["solve_steps"] * 1e3 / (t["steps"] * run.batch)
