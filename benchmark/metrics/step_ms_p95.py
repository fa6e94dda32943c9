"""The 95th percentile of the wall time of every step in the window, from
the step call to the synchronise (inclusive quantiles)."""

import statistics


def read(run):
    walls = [s.wall_s * 1e3 for s in run.steps]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
