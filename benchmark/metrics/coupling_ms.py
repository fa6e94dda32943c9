"""The port's coupling timers a step (``counters.cd.boundary_update_time``
plus ``coupling_transmit_time``; enabled in the traced run only), in ms,
averaged over the window."""


def read(run):
    vals = [s.coupling_s for s in run.steps if s.coupling_s is not None]
    return sum(vals) / len(vals) * 1e3 if vals else None
