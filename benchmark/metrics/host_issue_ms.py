"""Host ms a step spends issuing work: the port's ``world.step`` span less
the time of its ``sync.*`` spans (its reads of device values, each waiting
for the device), averaged over the window's steps (``spans.py``; the
counters are on in the traced run's window only)."""

from benchmark import spans


def read(run):
    steps = spans.window_steps(run)
    if steps is None:
        return None
    return sum(total - waits for total, waits, _ in steps) / len(steps) / 1e6
