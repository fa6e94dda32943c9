"""Share (%) of the profiled steps' wall time in which no operation ran on
the device: 100 x (1 - union of the device intervals / wall time)."""


def read(run):
    p = run.profile
    if p is None or p.window_us <= 0 or not p.ops:
        return None
    return 100.0 * (1.0 - p.busy_us / p.window_us)
