"""Host reads of device values a step (``sync.*`` spans inside the port's
``world.step``, one per count of ``counters.HOST_SYNCS``), averaged over
the window's steps (``spans.py``)."""

from benchmark import spans


def read(run):
    steps = spans.window_steps(run)
    if steps is None:
        return None
    return sum(n for _, _, n in steps) / len(steps)
