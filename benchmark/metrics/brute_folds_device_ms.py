"""Device ms a profiled step of the operations launched while
``salva_tpu_torch/solver/full_folds.py`` was on the Python stack (the
brute tier's all-pairs folds)."""


def read(run):
    if run.stack_profile is None:
        return None
    return run.stack_profile.module_device_ms("salva_tpu_torch/solver/full_folds.py")
