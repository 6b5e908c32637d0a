"""Builds and loads the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into ONE shared library with a plain
C interface, loaded with ``ctypes``.  The library goes
to ``_build/<hash of the sources>/`` inside the package (listed in
``.gitignore``), so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the first wrapper that launches
a kernel on a CUDA tensor calls :func:`load`.
"""

from __future__ import annotations

import collections
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
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: kernel launches by kernel name since the last ``launches.clear()``; each
#: wrapper adds one where it launches its kernel, so CPU calls never count
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_SIGNATURES = {
    "olap_stream_compact_tile": ([], ctypes.c_int),
    "olap_stream_compact_i32": ([_P, ctypes.c_longlong, _PP, _PP,
                                 ctypes.c_int, ctypes.c_longlong, _P, _P, _P,
                                 _P], ctypes.c_int),
    "olap_expand_fill_tile": ([], ctypes.c_int),
    "olap_expand_fill_i32": ([_P, ctypes.c_longlong, ctypes.c_longlong, _PP,
                              _PP, ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "olap_filter_agg_i32": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                             _P, _P, _P, _P, _P], ctypes.c_int),
    "olap_seg_agg_tile_rows": ([], ctypes.c_int),
    "olap_seg_agg_i32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P], ctypes.c_int),
    "olap_radix_hist_i32": ([_P, ctypes.c_longlong, ctypes.c_int, _P, _P],
                            ctypes.c_int),
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


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    # objects and the library go to a temporary directory and the library is
    # renamed into place: a concurrent or killed build never leaves a
    # half-written library at ``out``
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
                for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
                  for o, src in zip(objs, _sources())])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
