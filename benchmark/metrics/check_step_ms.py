"""Mean wall time (ms, the harness's clock) of the window's steps on which
the world runs its overflow check: its step counter at a multiple of
``overflow_check_interval``."""


def read(run):
    vals = [s.wall_s for s in run.steps if s.check]
    return sum(vals) / len(vals) * 1e3 if vals else None
