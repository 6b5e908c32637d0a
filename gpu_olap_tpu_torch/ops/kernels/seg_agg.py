"""Post-sort segmented aggregation over co-sorted int32 lanes (kernel
``seg_agg``).

Port of ``gpu_olap_tpu/ops/pallas/seg_agg.py``.  ``seg_agg_sorted_i32``
launches ``csrc/seg_agg.cu`` for CUDA tensors; for CPU tensors it runs
``seg_agg_plain``, the plain PyTorch version with the same output contract.
"""

from __future__ import annotations

import torch

from . import _build

#: engagement threshold for the GROUP BY matcher: the JAX engine's one
#: superblock, kept so the same queries take the kernel
MIN_ROWS = 2048


def _empty_outputs(max_groups: int, device):
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros(max_groups, **i32), torch.zeros(max_groups, **i32),
            torch.zeros(max_groups, dtype=torch.int64, device=device),
            torch.zeros(max_groups, **i32), torch.zeros(max_groups, **i32))


def seg_agg_plain(keys_sorted: torch.Tensor, vals_sorted: torch.Tensor,
                  max_groups: int):
    """Plain PyTorch version of :func:`seg_agg_sorted_i32`: runs from
    ``unique_consecutive``, sums by ``index_add_``, MIN/MAX as each run's
    first/last value."""
    key_g, cnt_g, sum_g, mn_g, mx_g = _empty_outputs(max_groups,
                                                     keys_sorted.device)
    uk, counts = torch.unique_consecutive(keys_sorted, return_counts=True)
    ng = uk.shape[0]
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    gid = torch.repeat_interleave(torch.arange(ng, device=keys_sorted.device),
                                  counts)
    sums = torch.zeros(ng, dtype=torch.int64, device=keys_sorted.device)
    sums.index_add_(0, gid, vals_sorted.to(torch.int64))
    m = min(ng, max_groups)
    key_g[:m] = uk[:m]
    cnt_g[:m] = counts[:m].to(torch.int32)
    sum_g[:m] = sums[:m]
    mn_g[:m] = vals_sorted[starts[:m]]
    mx_g[:m] = vals_sorted[ends[:m] - 1]
    n_groups = torch.tensor(ng, dtype=torch.int32, device=keys_sorted.device)
    return key_g, cnt_g, sum_g, mn_g, mx_g, n_groups


def seg_agg_sorted_i32(keys_sorted: torch.Tensor, vals_sorted: torch.Tensor,
                       max_groups: int):
    """Dense group outputs from co-sorted (key, value) int32 lanes.

    ``keys_sorted`` ascends; ``vals_sorted`` ascends within each run of
    equal keys (ride-the-sort), so MIN is a run's first value and MAX its
    last.  Returns ``(key, cnt_i32, sum_i64, min_i32, max_i32, n_groups_i32)``
    where the first five have ``max_groups`` entries (entries at or past
    ``n_groups`` are zero) and ``n_groups`` is exact even when it exceeds
    ``max_groups``.  Padding rows masked to INT32_MAX form one trailing
    group like any other key.
    """
    n = keys_sorted.shape[0]
    for t in (keys_sorted, vals_sorted):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError("seg_agg takes int32 (n,) tensors of one length")
    if vals_sorted.device != keys_sorted.device:
        raise ValueError("seg_agg tensors must share a device")
    if n == 0 or n >= (1 << 31) - 1:
        raise ValueError(f"seg_agg takes 1 <= n < 2^31 - 1 rows, got {n}")
    max_groups = int(max_groups)
    if max_groups < 0:
        raise ValueError("max_groups must be >= 0")
    dev = keys_sorted.device
    if dev.type == "cpu":
        return seg_agg_plain(keys_sorted, vals_sorted, max_groups)
    if dev.type != "cuda":
        raise ValueError(f"seg_agg has no kernel for {dev}")
    if not (keys_sorted.is_contiguous() and vals_sorted.is_contiguous()):
        raise ValueError("seg_agg takes contiguous tensors")

    lib = _build.load()
    # no output is pre-filled: the kernel writes every slot below the group
    # count and a tail launch zeroes the rest
    i32 = dict(dtype=torch.int32, device=dev)
    key_g, cnt_g = torch.empty(max_groups, **i32), torch.empty(max_groups, **i32)
    sum_g = torch.empty(max_groups, dtype=torch.int64, device=dev)
    mn_g, mx_g = torch.empty(max_groups, **i32), torch.empty(max_groups, **i32)
    n_groups = torch.empty((), **i32)
    scratch = torch.empty(lib.olap_seg_agg_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.olap_seg_agg_i32(
            keys_sorted.data_ptr(), vals_sorted.data_ptr(), n, max_groups,
            scratch.data_ptr(), key_g.data_ptr(), cnt_g.data_ptr(),
            sum_g.data_ptr(), mn_g.data_ptr(), mx_g.data_ptr(),
            n_groups.data_ptr(), stream)
    _build.check(err, "seg_agg launch")
    _build.launches["seg_agg"] += 1
    return key_g, cnt_g, sum_g, mn_g, mx_g, n_groups
