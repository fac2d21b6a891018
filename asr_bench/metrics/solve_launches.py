"""Device kernels launched under the ``solve_steps`` stage, per image
(device trace)."""


def read(run):
    t = run.trace
    if not t or t["steps"] == 0 or not t["stage_kernels"].get("solve_steps"):
        return None
    return t["stage_kernels"]["solve_steps"] / (t["steps"] * run.batch)
