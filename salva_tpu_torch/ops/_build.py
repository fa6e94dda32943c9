"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
host-side C++ of ``csrc/*.cpp`` (the triangle-mesh sampler, ``native``).

Each source compiles with ``nvcc`` into a shared library of its own with
a plain C interface, loaded with ``ctypes``; the ``nvcc`` processes of
all sources run at once. The build runs at first use — never at import,
so the package imports on machines without a GPU or a CUDA toolkit —
into ``build/salva_tpu_torch/<hash>/`` beside the package (a git-ignored
directory), keyed by a hash of the source and the flags: an edited
source builds anew, an unchanged one loads the cached library. The host
sources build the same way with ``g++`` (``build_host``), only when
first used.
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
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCES = (
    _PKG_DIR / "csrc" / "pair_passes.cu",
    _PKG_DIR / "csrc" / "expand.cu",
    _PKG_DIR / "csrc" / "rigid_solve.cu",
)
_BUILD_ROOT = _PKG_DIR.parent / "build" / "salva_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_NOT_LAUNCHED = -1  # the C entries' kNotLaunched: nothing to launch

# The slab path (parallel.LocalHalos) launches from one thread per slab:
# the first build and the launch counts are taken under these locks.
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Argument types of every C entry point (pointers and the stream as
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints).
# The pair passes take their SPH kernels as ids and their constants as a
# float array (``ops/pair.py``: ``_KERNEL_IDS``, ``_pair_params``).
_SIGNATURES = {
    "salva_k_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "salva_t_pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "salva_hoist_ff": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P],
    "salva_hoist_fb": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "salva_k_pass_v2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                        _P],
    "salva_visc_ff": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                      _I, _I, _I, _F, _P, _P],
    "salva_boundary_forces": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P, _P],
    "salva_expand": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "salva_rigid_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _F, _P],
    "salva_pass_tiling": [_I, _I, _I, _I, _I, _I, _P],
    "salva_pair_params": [],
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


def _source_hash(src: Path, flags=_FLAGS) -> str:
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(src: Path, flags=_FLAGS) -> Path:
    return _BUILD_ROOT / _source_hash(src, flags) / f"libsalva_{src.stem}.so"


def library_paths():
    return [library_path(src) for src in _SOURCES]


def build():
    """Compile every source whose hashed library is missing, all ``nvcc``
    processes at once; returns the library paths. Each library is written
    to a temporary name and renamed into place, so a concurrent or
    interrupted build never leaves a partial file under the final name."""
    jobs = []
    try:
        for src in _SOURCES:
            out = library_path(src)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [_nvcc(), *_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, proc, tmp, out))
        failed = []
        for cmd, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + log)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(
                "nvcc failed building the salva_tpu_torch kernels:\n"
                + "\n".join(failed)
            )
    finally:
        for cmd, proc, tmp, out in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return library_paths()


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>`` (host C++) with ``g++`` unless its hashed
    library exists; returns the library's path. A failed build raises
    with the compiler's output."""
    src = _PKG_DIR / "csrc" / name
    out = library_path(src, _HOST_FLAGS)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cxx, *_HOST_FLAGS, "-o", tmp, str(src)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"building {src.name} failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed: {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class _Kernels:
    """The C entry points of every kernel library, by name."""

    def __init__(self, libs):
        for lib in libs:
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is None:
                    continue
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name, fn)
        missing = [n for n in _SIGNATURES if not hasattr(self, n)]
        if missing:
            raise RuntimeError(f"kernel entry points not built: {missing}")


def load() -> _Kernels:
    """Build if needed, load once per process, and declare every entry
    point's argument and return types."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> _Kernels:
    return _Kernels([ctypes.CDLL(str(p)) for p in build()])


def launch(launches, name, fn, *args, device):
    """Call the C entry ``fn`` on ``device``'s current stream; add one to
    ``launches[name]`` unless the entry had nothing to launch (an empty
    grid or column list, whose outputs the wrapper already allocated
    complete). Raises if the launch was refused."""
    import torch

    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err == _NOT_LAUNCHED:
        return
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {err})")
    with _COUNT_LOCK:
        launches[name] += 1

