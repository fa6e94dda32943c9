"""Host-side C++ of the port, loaded through ``ctypes``: the
triangle-mesh ray-cast sampler (``csrc/trimesh_sampler.cpp``), covering
the reference's ``shape_surface_ray_sample`` /
``shape_volume_ray_sample`` for meshes (``src/sampling/ray_sampling.rs``).

Port of ``salva_tpu.native`` with its own copy of the source. The library
builds with ``g++`` at first use (``ops._build.build_host``) into
``build/`` beside the CUDA kernels, never at import; a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_SOURCE = "trimesh_sampler.cpp"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    from .ops._build import build_host

    lib = ctypes.CDLL(str(build_host(_SOURCE)))
    for name in ("trimesh_surface_sample", "trimesh_volume_sample"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
    return lib


def _call_sampler(fn_name: str, vertices, indices, radius: float,
                  max_out: int) -> np.ndarray:
    lib = _load()
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(indices, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"vertices must be [V, 3], got {verts.shape}")
    if tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"indices must be [T, 3], got {tris.shape}")
    out = np.empty((max_out, 3), np.float32)
    n = getattr(lib, fn_name)(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(tris),
        ctypes.c_float(radius),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_out,
    )
    if n < 0:
        raise ValueError("invalid mesh or radius")
    return out[:n].copy()


def trimesh_surface_sample(vertices, indices, particle_radius: float,
                           max_out: int = 1_000_000) -> np.ndarray:
    """Surface boundary particles of a triangle mesh
    (`shape_surface_ray_sample` semantics, `ray_sampling.rs:27-88`)."""
    return _call_sampler(
        "trimesh_surface_sample", vertices, indices, particle_radius, max_out
    )


def trimesh_volume_sample(vertices, indices, particle_radius: float,
                          max_out: int = 4_000_000) -> np.ndarray:
    """Volume sample of a closed triangle mesh
    (`shape_volume_ray_sample` semantics, `ray_sampling.rs:91-164`)."""
    return _call_sampler(
        "trimesh_volume_sample", vertices, indices, particle_radius, max_out
    )
