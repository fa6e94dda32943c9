"""Share (%) of their roofline bound that the hand pair kernels (k_pass,
t_pass, hoist_ff, hoist_fb) reach over the profiled steps: the sum of
each call's bound (``roofline.py``) over the sum of their device time."""

from benchmark import roofline


def read(run):
    if run.profile is None:
        return None
    bound, time = roofline.kernels_roofline(run.profile)
    return 100.0 * bound / time if time > 0 else None
