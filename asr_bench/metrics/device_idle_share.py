"""1 - the union of the device's busy intervals over the profiled stretch,
in % (device trace)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
