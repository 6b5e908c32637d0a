"""Buffer arena — the slab allocator analogue.

Port of ``gpu_olap_tpu/mem/arena.py``.  The reference pools GPU memory in
fixed size classes to avoid cudaMalloc churn (``slab_allocator.rs:24-130``:
smallest class >= size, O(1) free-list pop, bounded slabs per class).
PyTorch's caching allocator already pools device memory, so what this arena
pools is the host side of the transfer: bucket-shaped staging buffers that
chunks are copied into before their upload.  With ``pinned=True`` (the
streamer on a CUDA device) each buffer is a page-locked host tensor, handed
out as its numpy view, so its upload runs asynchronously on the feeder's
copy stream; otherwise a plain numpy array.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.dtypes import torch_dtype
from ..utils.tracing import get_logger

logger = get_logger(__name__)


def size_class(n_rows: int, growth: float = 2.0, minimum: int = 1024) -> int:
    """Smallest shape bucket >= n_rows (find_slab_class analogue,
    ``slab_allocator.rs:95-107``)."""
    b = minimum
    while b < n_rows:
        b = int(b * growth)
    return b


class BufferArena:
    """Pooled, bucket-shaped host staging buffers with a byte limit.

    ``acquire`` pops a free buffer of the right (bucket, dtype) class or
    allocates a new one within ``max_bytes`` (``slab_allocator.rs:50-68``);
    ``release`` returns it to the pool, or drops it when the class already
    holds ``max_buffers_per_class`` free buffers (``:71-93``)."""

    def __init__(self, max_bytes: int = 8 << 30, max_buffers_per_class: int = 16,
                 growth: float = 2.0, min_bucket: int = 1024,
                 pinned: bool = False):
        self.max_bytes = max_bytes
        self.max_buffers_per_class = max_buffers_per_class
        self.growth = growth
        self.min_bucket = min_bucket
        self.pinned = pinned
        self._free: Dict[Tuple[int, str], List[np.ndarray]] = collections.defaultdict(list)
        self._allocated_bytes = 0
        self._allocated_count: Dict[Tuple[int, str], int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def bucket(self, n_rows: int) -> int:
        return size_class(n_rows, self.growth, self.min_bucket)

    def acquire(self, n_rows: int, dtype) -> np.ndarray:
        rows = self.bucket(n_rows)
        key = (rows, np.dtype(dtype).str)
        with self._lock:
            pool = self._free[key]
            if pool:
                return pool.pop()
            nbytes = rows * np.dtype(dtype).itemsize
            if self._allocated_bytes + nbytes > self.max_bytes:
                raise MemoryError(
                    f"arena limit exceeded: {self._allocated_bytes + nbytes} "
                    f"> {self.max_bytes}"
                )
            self._allocated_bytes += nbytes
            self._allocated_count[key] += 1
        if self.pinned:
            # the numpy view keeps the page-locked tensor alive
            return torch.empty(rows, dtype=torch_dtype(dtype),
                               pin_memory=True).numpy()
        return np.empty(rows, dtype=dtype)

    def release(self, buf: np.ndarray) -> None:
        key = (buf.shape[0], buf.dtype.str)
        with self._lock:
            pool = self._free[key]
            if len(pool) < self.max_buffers_per_class:
                pool.append(buf)
            else:
                # pool full: drop (the reference cudaFrees here,
                # slab_allocator.rs:82-86)
                self._allocated_bytes -= buf.nbytes
                self._allocated_count[key] -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "allocated_bytes": self._allocated_bytes,
                "classes": {
                    f"{k[0]}x{k[1]}": {"allocated": self._allocated_count[k],
                                       "free": len(v)}
                    for k, v in self._free.items()
                },
            }
