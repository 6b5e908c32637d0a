"""Fused filter + global aggregation over int32 lanes (kernel ``filter_agg``).

Port of ``gpu_olap_tpu/ops/pallas/filter_agg.py``.  ``filter_agg_i32``
launches ``csrc/filter_agg.cu`` for CUDA tensors; for CPU tensors it runs
``filter_agg_plain``, the plain PyTorch version with the same output
contract.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: engagement threshold for the SQL matcher (the JAX engine's, kept so the
#: same queries take the kernel)
MIN_ROWS = 64 * 1024
#: value columns one launch takes (kMaxCols in csrc/filter_agg.cu: the
#: kernel keeps one register accumulator set per column)
MAX_COLS = 8

OPS = ("gt", "ge", "lt", "le", "eq", "ne")
_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)


def _cmp(op: str, f, thr: int):
    return {"gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
            "eq": torch.eq, "ne": torch.ne}[op](f, thr)


def _default_wants(n_cols):
    return ((True, True),) * n_cols


def filter_agg_plain(filt: torch.Tensor, op: str, threshold: int, cols,
                     n_valid=None, wants=None):
    """Plain PyTorch version of :func:`filter_agg_i32`: a mask, then int64
    ``sum`` and ``amin``/``amax`` with the kernel's sentinels."""
    if wants is None:
        wants = _default_wants(len(cols))
    n = filt.shape[0] if n_valid is None else int(n_valid)
    mask = _cmp(op, filt[:n], int(threshold))
    count = mask.sum(dtype=torch.int64)
    results = []
    for c, want in zip(cols, wants):
        v = c[:n]
        total = torch.zeros((), dtype=torch.int64, device=filt.device)
        mn = torch.full((), _I32_MAX, dtype=torch.int32, device=filt.device)
        mx = torch.full((), _I32_MIN, dtype=torch.int32, device=filt.device)
        if want[0]:
            total = torch.where(mask, v.to(torch.int64), 0).sum()
        if want[1] and n:
            mn = torch.where(mask, v, _I32_MAX).amin()
            mx = torch.where(mask, v, _I32_MIN).amax()
        results.append((total, mn, mx))
    return count, results


def filter_agg_i32(filt: torch.Tensor, op: str, threshold: int, cols,
                   n_valid=None, wants=None):
    """Fused ``WHERE filt <op> threshold`` global aggregation.

    ``filt`` and every entry of ``cols`` are contiguous int32 (n,) tensors on
    one device; a column that IS ``filt`` (same object) is read once.
    ``op`` is one of gt/ge/lt/le/eq/ne.  Rows at or past ``n_valid`` are
    ignored.  ``wants`` holds per-column ``(want_sum, want_minmax, ...)``
    flags; lanes not wanted keep their identities.

    Returns ``(count_i64, [(sum_i64, min_i32, max_i32), ...])`` as 0-d
    tensors; MIN/MAX are INT32_MAX/INT32_MIN when no row matches.
    """
    if op not in OPS:
        raise ValueError(f"unknown comparison {op!r}")
    cols = tuple(cols)
    if wants is None:
        wants = _default_wants(len(cols))
    if len(wants) != len(cols):
        raise ValueError("one wants entry per value column")
    n = filt.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside [0, {n}]")
    if not _I32_MIN <= int(threshold) <= _I32_MAX:
        raise ValueError("threshold must fit int32")
    for t in (filt,) + cols:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError("filter_agg takes int32 (n,) tensors of one length")
        if t.device != filt.device:
            raise ValueError("filter_agg tensors must share a device")
    if filt.device.type == "cpu":
        return filter_agg_plain(filt, op, threshold, cols, n_valid, wants)
    if filt.device.type != "cuda":
        raise ValueError(f"filter_agg has no kernel for {filt.device}")
    if len(cols) > MAX_COLS:
        raise ValueError(f"filter_agg takes at most {MAX_COLS} value columns")
    if not all(t.is_contiguous() for t in (filt,) + cols):
        raise ValueError("filter_agg takes contiguous tensors")

    dev = filt.device
    k = len(cols)
    i32 = dict(dtype=torch.int32, device=dev)
    if n_valid == 0:
        # no row to scan: the identities are the result, nothing launches
        sums = torch.zeros(max(k, 1), dtype=torch.int64, device=dev)
        mins = torch.full((max(k, 1),), _I32_MAX, **i32)
        maxs = torch.full((max(k, 1),), _I32_MIN, **i32)
        return (torch.zeros((), dtype=torch.int64, device=dev),
                [(sums[i], mins[i], maxs[i]) for i in range(k)])
    lib = _build.load()
    # nothing is pre-filled: the kernel's last block writes every output
    count = torch.empty(1, dtype=torch.int64, device=dev)
    sums = torch.empty(max(k, 1), dtype=torch.int64, device=dev)
    mins = torch.empty(max(k, 1), **i32)
    maxs = torch.empty(max(k, 1), **i32)
    partials = torch.empty(lib.olap_filter_agg_partials_bytes(),
                           dtype=torch.uint8, device=dev)
    # the kernel reads each distinct pointer once: a column aliasing the
    # filter or another column is not read again
    ptrs = (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in cols])
    want_sum = sum(1 << i for i, w in enumerate(wants) if w[0])
    want_mm = sum(1 << i for i, w in enumerate(wants) if w[1])
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        err = lib.olap_filter_agg_i32(
            filt.data_ptr(), ptrs, k, OPS.index(op), int(threshold), n_valid,
            want_sum, want_mm, partials.data_ptr(),
            _build.done_counter(dev, cur).data_ptr(), count.data_ptr(),
            sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(), cur.cuda_stream)
    _build.check(err, "filter_agg launch")
    _build.launches["filter_agg"] += 1
    return count[0], [(sums[i], mins[i], maxs[i]) for i in range(k)]


def filter_count_sum_i32(values: torch.Tensor, threshold, n_valid):
    """Fused ``COUNT(*), SUM(v) WHERE v > threshold`` over an int32 column
    (the one column is both filter and aggregate input); the sum as
    float64, as the JAX wrapper returns it."""
    count, ((total, _mn, _mx),) = filter_agg_i32(
        values, "gt", threshold, (values,), n_valid)
    return count, total.to(torch.float64)


def filter_count_sum_exact_i32(values: torch.Tensor, threshold, n_valid):
    """Exact int64 ``COUNT/SUM WHERE v > c`` for int32 values."""
    count, ((total, _mn, _mx),) = filter_agg_i32(
        values, "gt", threshold, (values,), n_valid)
    return count, total
