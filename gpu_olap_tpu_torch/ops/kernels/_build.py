"""Builds and loads the package's CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
to ``_build/<hash of the sources>/`` inside the package (listed in
``.gitignore``), so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the first wrapper that launches
a kernel on a CUDA tensor calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0

_P = ctypes.c_void_p
_SIGNATURES = {
    "olap_filter_agg_i32": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                             _P, _P, _P, _P, _P], ctypes.c_int),
    "olap_seg_agg_tile_rows": ([], ctypes.c_int),
    "olap_seg_agg_i32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P], ctypes.c_int),
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libolap_kernels.so")


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name and rename: a concurrent build or a
    # killed build never leaves a half-written library at ``out``
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def load():
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not os.path.exists(out):
                _compile(out)
            lib = ctypes.CDLL(out)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
