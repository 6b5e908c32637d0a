"""Skew handling for the distributed shuffle (BASELINE config 5, Zipfian
keys).

Port of ``gpu_olap_tpu/parallel/skew.py``: the partition histogram that
plans shuffle capacity (on the ``radix_hist`` kernel above 32768 keys),
the capacity rule, host-side heavy-key detection and the device mask of
heavy rows.  The JAX module imports JAX at the top, so its two host NumPy
functions are copied here rather than imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hashing import partition_of
from ..ops.kernels.partition import radix_histogram_i32
from ..utils.metrics import GLOBAL_METRICS

#: JAX's gate for the radix-histogram kernel (``skew.py:37``)
HIST_KERNEL_MIN_KEYS = 32768


def partition_histogram(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Rows per hash partition (int64 (num_partitions,)), the signal that
    sizes shuffle buckets.  At least 32768 keys over at most 256 partitions
    count on the ``radix_hist`` kernel (a CUDA tensor launches it or
    raises); smaller inputs take a plain count, as JAX's ``segment_sum``.
    On a mesh over several processes each rank counts its own keys and the
    planner sums the counts with ``collectives.psum``."""
    dest = partition_of(keys, num_partitions)
    if keys.shape[0] >= HIST_KERNEL_MIN_KEYS and num_partitions <= 256:
        GLOBAL_METRICS.bump("torch_radix_hist_path")
        return radix_histogram_i32(dest, shift=0)[:num_partitions]
    return torch.bincount(dest.long(), minlength=num_partitions)


def recommend_capacity(hist: np.ndarray, ndev: int = 1,
                       headroom: float = 1.25, align: int = 128) -> int:
    """Per-(source, destination) shuffle bucket capacity from a full-table
    destination histogram: the hottest destination's rows split about
    evenly over the ndev sources, so a bucket holds about peak / ndev rows,
    times ``headroom``, rounded up to ``align``.  Rows clustered by key
    across shards can still overflow a bucket: callers check the flag."""
    peak = int(np.max(np.asarray(hist))) if len(hist) else 1
    cap = int(peak * headroom / max(ndev, 1)) + 1
    return ((cap + align - 1) // align) * align


def detect_heavy_keys(keys: np.ndarray, row_threshold: int,
                      max_heavy: int = 128) -> np.ndarray:
    """Keys whose frequency exceeds ``row_threshold`` (exact, host-side; run
    it on a sample for large inputs), the ``max_heavy`` most frequent."""
    uniq, counts = np.unique(np.asarray(keys), return_counts=True)
    heavy = uniq[counts > row_threshold]
    if len(heavy) > max_heavy:
        order = np.argsort(counts[counts > row_threshold])[::-1]
        heavy = heavy[order[:max_heavy]]
    return heavy.astype(np.int64)


def split_by_heavy(keys: torch.Tensor, heavy_keys: np.ndarray) -> torch.Tensor:
    """Boolean mask of the rows that carry a heavy key."""
    if len(heavy_keys) == 0:
        return torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    hk = torch.as_tensor(np.asarray(heavy_keys, dtype=np.int64),
                         device=keys.device)
    return torch.isin(keys.to(torch.int64), hk)
