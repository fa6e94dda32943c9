"""The files a configuration or a metric names, found by name under
``benchmark/``:

- ``scenes/<scene>.py``: the scene's geometry (the fluid from the seed, the
  colliders' posed wall samples, the fixed force scale, the domain) and
  ``build``, which makes it through the port's public API;
- ``solvers/<solver>.py``: the port's solver settings, the state a step
  carries, and the reference's step;
- ``reference/forces/<reference>.py``: the reference of one non-pressure
  force of the configuration's ``forces`` list;
- ``metrics/<metric>.py``: the reader of one metric.

A later configuration with another scene, solver or force adds files here
and edits none.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
_LOADED = {}


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under ``BENCH_DIR``."""
    path = BENCH_DIR / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind.replace('/', '_')}_{name.replace('.', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def scene(cfg):
    return load("scenes", cfg["scene"])


def solver(cfg):
    return load("solvers", cfg["solver"])


def reference_force(spec):
    return load("reference/forces", spec["reference"])
