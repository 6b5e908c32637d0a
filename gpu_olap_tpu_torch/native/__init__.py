"""Native (C++) helpers for host-side hot loops, loaded via ctypes.

Copy of ``gpu_olap_tpu/native``: string dictionary encoding
(``interop/arrow.py``), the zone-map scans of ``catalog.py``, FNV-1a string
hashes and Arrow validity-bitmap unpacking.  ``fastconv.cpp`` is built with ``g++`` at first use into
``gpu_olap_tpu_torch/_build/native-<hash of the source>/`` (listed in
``.gitignore``), never next to the source.  Every entry point returns None
when no toolchain is present, and its caller takes its NumPy path.  These
are host helpers, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastconv.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out_dir = os.path.join(_BUILD_ROOT, f"native-{digest}")
        so = os.path.join(out_dir, "_fastconv.so")
        if os.path.exists(so):
            return so
        os.makedirs(out_dir, exist_ok=True)
        # built under a temporary name and renamed into place, so a
        # concurrent or killed build never leaves a half-written library
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            lib = os.path.join(tmp, "lib.so")
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", lib,
                   _SRC]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(lib, so)
        return so
    except Exception:
        return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.fnv1a_hash64.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.dict_encode_utf8_build.restype = ctypes.c_void_p
            lib.dict_encode_utf8_build.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.dict_encode_utf8_finish.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.unpack_bitmap.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.int64_minmax.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.int64_unique_bounded.restype = ctypes.c_int
            lib.int64_unique_bounded.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def fnv1a_hash64(data: np.ndarray, offsets: np.ndarray) -> Optional[np.ndarray]:
    """FNV-1a 64-bit hash of Arrow-layout strings; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.int64)
    lib.fnv1a_hash64(_ptr(data), _ptr(np.ascontiguousarray(offsets, np.int64)),
                     n, _ptr(out))
    return out


def dict_encode_utf8(
    data: np.ndarray, offsets: np.ndarray, validity: Optional[np.ndarray]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Dictionary-encode Arrow-layout strings natively.

    Returns (int64 codes, object-array sorted dictionary), or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    vptr = None
    vbuf = None
    if validity is not None:
        vbuf = np.ascontiguousarray(validity, dtype=np.uint8)
        vptr = _ptr(vbuf)
    dict_n = ctypes.c_int64()
    dict_bytes = ctypes.c_int64()
    handle = lib.dict_encode_utf8_build(
        _ptr(data), _ptr(offsets), vptr, n,
        ctypes.byref(dict_n), ctypes.byref(dict_bytes),
    )
    if not handle:
        return None
    codes = np.empty(n, dtype=np.int64)
    doffs = np.empty(dict_n.value + 1, dtype=np.int64)
    dbytes = np.empty(max(dict_bytes.value, 1), dtype=np.uint8)
    lib.dict_encode_utf8_finish(handle, _ptr(codes), _ptr(doffs), _ptr(dbytes))
    raw = dbytes.tobytes()
    dictionary = np.array(
        [raw[doffs[i]:doffs[i + 1]].decode("utf-8", "replace")
         for i in range(dict_n.value)],
        dtype=object,
    )
    return codes, dictionary


def int64_minmax(data: np.ndarray) -> Optional[Tuple[int, int]]:
    """Parallel (min, max) of a contiguous int64 array; None without native."""
    lib = get_lib()
    if lib is None or data.dtype != np.int64 or len(data) == 0:
        return None
    data = np.ascontiguousarray(data)
    mn = ctypes.c_int64()
    mx = ctypes.c_int64()
    lib.int64_minmax(_ptr(data), len(data), ctypes.byref(mn), ctypes.byref(mx))
    return int(mn.value), int(mx.value)


def int64_unique_bounded(data: np.ndarray, lo: int, hi: int) -> Optional[bool]:
    """Bitmap uniqueness check with duplicate early-exit (O(n), no sort).

    Returns True/False, or None when native is unavailable or the span is
    too large for a bitmap (caller falls back to np.unique)."""
    lib = get_lib()
    if lib is None or data.dtype != np.int64:
        return None
    data = np.ascontiguousarray(data)
    r = lib.int64_unique_bounded(_ptr(data), len(data), lo, hi)
    if r < 0:
        return None
    return bool(r)


def unpack_bitmap(bits: np.ndarray, bit_offset: int, n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.uint8)
    lib.unpack_bitmap(_ptr(np.ascontiguousarray(bits, np.uint8)),
                      bit_offset, n, _ptr(out))
    return out.astype(bool)
