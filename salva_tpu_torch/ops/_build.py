"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use — never
at import, so the package imports on machines without a GPU or a CUDA
toolkit — into ``build/salva_tpu_torch/<hash>/`` beside the package
(a git-ignored directory), keyed by a hash of the sources and the flags:
an edited source builds anew, an unchanged one loads the cached library.
The port is meant to run from a source checkout, where that directory
is ``build/`` at the checkout's root; an installed copy (which ships
``csrc/*.cu`` as package data) builds beside its install directory,
which must then be writable.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG_DIR / "csrc" / "pair_passes.cu",)
_BUILD_ROOT = _PKG_DIR.parent / "build" / "salva_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Argument types of every C entry point (pointers and the stream as
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints).
_SIGNATURES = {
    "salva_k_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _F, _F, _F, _F, _P],
    "salva_t_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _F, _F, _F, _F, _P],
    "salva_hoist_ff": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _F, _F, _F, _P],
}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(
            os.environ["CUDA_HOME"], "bin", "nvcc"
        ),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of salva_tpu_torch are built from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD_ROOT / _source_hash() / "libsalva_pair_passes.so"


def build() -> Path:
    """Compile the sources if the hashed library is missing; returns its
    path. The library is written to a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a partial
    file under the final name."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed building the salva_tpu_torch kernels:\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument and return types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
