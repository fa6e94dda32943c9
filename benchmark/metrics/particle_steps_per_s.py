"""Live fluid particles times the steps completed in the window, over the
whole window (episode restores included)."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.n_live * len(run.steps) / run.window_s
