"""Seconds from the start of the process to the start of the window:
imports, the device, the scene, the kernels' build on a first run, the
warm-up steps and the snapshot."""


def read(run):
    return run.setup_s
