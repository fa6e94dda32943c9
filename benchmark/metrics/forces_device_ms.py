"""Device ms a profiled step of the operations launched while
``salva_tpu_torch/solver/forces_dense.py`` was on the Python stack (the
dense non-pressure forces)."""


def read(run):
    if run.stack_profile is None:
        return None
    return run.stack_profile.module_device_ms("salva_tpu_torch/solver/forces_dense.py")
