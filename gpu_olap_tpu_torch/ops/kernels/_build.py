"""Builds and loads the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into ONE shared library with a plain
C interface, loaded with ``ctypes``.  The library goes
to ``_build/<hash of the sources>/`` inside the package (listed in
``.gitignore``), so an edited source rebuilds and an unchanged one is
reused.  ``ptxas`` reports every kernel's registers and spills while it
compiles; :func:`ptxas_report` reads that log back.  Nothing here runs at
import time: the first wrapper that launches a kernel on a CUDA tensor calls
:func:`load`.

    python -m gpu_olap_tpu_torch.ops.kernels._build [SOURCE.cu ...]

compiles the given sources (default: the package's) with ``-Xptxas -v`` and
prints each kernel's registers and spills as JSON lines.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
PTXAS_LOG = "ptxas.log"

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
    "olap_filter_agg_partials_bytes": ([], ctypes.c_longlong),
    "olap_filter_agg_i32": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                             _P, _P, _P, _P, _P, _P, _P], ctypes.c_int),
    "olap_seg_agg_scratch_bytes": ([ctypes.c_longlong], ctypes.c_longlong),
    "olap_seg_agg_i32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                          _P, _P, _P, _P, _P], ctypes.c_int),
    "olap_radix_hist_scratch_bytes": ([], ctypes.c_longlong),
    "olap_radix_hist_wave_flush_keys": ([], ctypes.c_longlong),
    "olap_radix_hist_i32": ([_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
                             _P], ctypes.c_int),
    "olap_run_scan_tile": ([], ctypes.c_int),
    "olap_run_scan_i32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P],
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


def _run_all(cmds) -> list:
    """Run the commands in parallel; raise with the output of any failure,
    else return each command's standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed, errs = [], []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        errs.append(err)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return errs


def _compile_objects(nvcc: str, sources, out_dir: str) -> list:
    """One ``nvcc -c`` per source, all at once, with ``ptxas -v``; returns
    the objects and writes the ``ptxas`` output to ``out_dir/ptxas.log``."""
    objs = [os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
            for src in sources]
    errs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, src]
                     for o, src in zip(objs, sources)])
    with open(os.path.join(out_dir, PTXAS_LOG), "w") as f:
        for src, err in zip(sources, errs):
            f.write(f"== {os.path.basename(src)}\n{err}")
    return objs


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    # objects and the library go to a temporary directory and the library is
    # renamed into place: a concurrent or killed build never leaves a
    # half-written library at ``out``
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        nvcc = _nvcc()
        objs = _compile_objects(nvcc, _sources(), tmp)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(os.path.join(tmp, PTXAS_LOG),
                   os.path.join(os.path.dirname(out), PTXAS_LOG))
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


#: per (device index, stream handle): a zeroed int32 counter on the device
_DONE = {}


def done_counter(dev, stream):
    """The counter that orders the blocks of a last-block kernel on
    ``stream`` (``filter_agg``, ``radix_hist``): each block adds one when its
    partials are written, and the block that sees ``gridDim.x - 1`` folds
    them.  One counter serves every such kernel on the stream, so each
    launch of each of them must leave it zero (its last block sets it back);
    launches on one stream never overlap."""
    import torch

    key = (dev.index, stream.cuda_stream)
    if key not in _DONE:
        _DONE[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _DONE[key]


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptxas_report(log: str = None) -> list:
    """Registers, spill bytes and static shared memory of every kernel in
    a ``ptxas -v`` log (default: the log of the built library), one dict
    per kernel."""
    if log is None:
        log = os.path.join(os.path.dirname(library_path()), PTXAS_LOG)
    with open(log) as f:
        text = f.read()
    rows, source, fn = [], None, None
    for line in text.splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif (m := re.search(r"Compiling entry function '(\w+)'", line)):
            fn = {"source": source, "kernel": m.group(1)}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                    r"spill loads", line)):
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            fn["registers"] = int(m.group(1))
            # static shared memory only: a launch adds its dynamic bytes
            smem = re.search(r"(\d+) bytes smem", line)
            fn["smem_bytes"] = int(smem.group(1)) if smem else 0
            rows.append(fn)
            fn = None
    _demangle(rows)
    return rows


def _demangle(rows) -> None:
    """Kernel names in C++ form, with ``cu++filt`` where there is one."""
    tool = shutil.which("cu++filt")
    if tool is None:
        try:
            tool = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
        except RuntimeError:  # no toolkit: the names stay mangled
            return
    if not rows or not os.path.exists(tool):
        return
    res = subprocess.run([tool], input="\n".join(r["kernel"] for r in rows),
                         capture_output=True, text=True, timeout=60)
    names = res.stdout.splitlines()
    if res.returncode == 0 and len(names) == len(rows):
        for r, name in zip(rows, names):
            r["kernel"] = name


if __name__ == "__main__":
    srcs = [os.path.abspath(a) for a in sys.argv[1:]] or _sources()
    with tempfile.TemporaryDirectory() as tmp_dir:
        _compile_objects(_nvcc(), srcs, tmp_dir)
        for row in ptxas_report(os.path.join(tmp_dir, PTXAS_LOG)):
            print(json.dumps(row))
