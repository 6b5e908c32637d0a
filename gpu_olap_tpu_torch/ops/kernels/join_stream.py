"""The sorted-space join's two streaming kernels: stable compaction
(``stream_compact``) and run-length expansion (``expand_fill``).

Port of ``gpu_olap_tpu/ops/pallas/join_stream.py``.  ``stream_compact_i32``
launches ``csrc/stream_compact.cu`` and ``expand_fill_i32`` launches
``csrc/expand_fill.cu`` for CUDA tensors; for CPU tensors each runs its
plain PyTorch version, which keeps the same output contract.  The TPU
kernels' padding rules (inputs and capacities in multiples of 2048, cap +
4096 compaction outputs, 2304 pad records behind the expansion's read
window) are gone: every length is exact.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

I32_MAX = (1 << 31) - 1


def _i32_streams(streams: Sequence[torch.Tensor], n: int, dev, what: str):
    for s in streams:
        if s.dtype != torch.int32 or s.dim() != 1 or s.shape[0] != n:
            raise ValueError(f"{what} streams must be int32 ({n},) tensors")
        if s.device != dev:
            raise ValueError(f"{what} tensors must share a device")


def _ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


# ---------------------------------------------------------------------------
# stream compaction
# ---------------------------------------------------------------------------

def stream_compact_plain(mask: torch.Tensor, streams: Sequence[torch.Tensor],
                         cap: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`stream_compact_i32`:
    ``mask.nonzero()`` and one gather per stream."""
    dev = mask.device
    idx = torch.nonzero(mask).reshape(-1)
    count = idx.shape[0]
    kept = idx[:min(count, cap)]
    outs = []
    for s in streams:
        o = torch.zeros(cap, dtype=torch.int32, device=dev)
        o[:kept.shape[0]] = s[kept]
        outs.append(o)
    return outs, torch.tensor(count, dtype=torch.int32, device=dev)


def stream_compact_i32(mask: torch.Tensor, streams: Sequence[torch.Tensor],
                       cap: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Dense prefix extraction: for every position where ``mask`` is
    nonzero, in order, each stream's value goes to the next free slot.

    ``mask``: bool (n,); ``streams``: int32 (n,) each.  Returns
    ``([out (cap,) per stream], count)`` with ``count`` an int32 0-d tensor.
    ``count`` is exact even when it exceeds ``cap``; only the first ``cap``
    kept elements are written, and every slot at or past ``count`` is 0.
    """
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise ValueError("stream_compact takes a bool (n,) mask")
    n = mask.shape[0]
    dev = mask.device
    _i32_streams(streams, n, dev, "stream_compact")
    cap = int(cap)
    if n >= I32_MAX or not 0 <= cap < (1 << 31):
        raise ValueError(f"stream_compact takes n < 2^31 - 1 and "
                         f"0 <= cap < 2^31, got n={n}, cap={cap}")
    if dev.type == "cpu":
        return stream_compact_plain(mask, streams, cap)
    if dev.type != "cuda":
        raise ValueError(f"stream_compact has no kernel for {dev}")
    if not (mask.is_contiguous() and all(s.is_contiguous() for s in streams)):
        raise ValueError("stream_compact takes contiguous tensors")

    outs = [torch.zeros(cap, dtype=torch.int32, device=dev) for _ in streams]
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return outs, count
    lib = _build.load()
    n_tiles = -(-n // lib.olap_stream_compact_tile())
    scratch = torch.empty(2 * n_tiles, dtype=torch.int32, device=dev)
    ins_p, outs_p = _ptr_array(streams), _ptr_array(outs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.olap_stream_compact_i32(
            mask.data_ptr(), n, ins_p, outs_p,
            len(streams), cap, scratch.data_ptr(),
            scratch[n_tiles:].data_ptr(), count.data_ptr(), stream)
    _build.check(err, "stream_compact launch")
    _build.launches["stream_compact"] += 1
    return outs, count



# ---------------------------------------------------------------------------
# run-length expansion
# ---------------------------------------------------------------------------

def expand_fill_plain(starts: torch.Tensor, streams: Sequence[torch.Tensor],
                      cap: int) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`expand_fill_i32`: each slot's record
    by ``searchsorted(starts, slot, right=True) - 1``, then gathers."""
    dev = starts.device
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    if starts.shape[0] == 0:
        return [slots] + [torch.zeros(cap, dtype=torch.int32, device=dev)
                          for _ in streams]
    rec = torch.searchsorted(starts, slots, right=True) - 1
    has = rec >= 0
    rec = torch.clamp(rec, min=0)
    off = slots - torch.where(has, starts[rec], 0)
    return [off] + [torch.where(has, s[rec], 0) for s in streams]


def _check_starts(starts: torch.Tensor) -> None:
    """Live starts must increase strictly, with INT32_MAX pads only after
    them.  Checked on CPU tensors only: on the card it would cost a device
    sync on the hot path."""
    if starts.shape[0] < 2:
        return
    nxt = starts[1:]
    ok = (nxt > starts[:-1]) | (nxt == I32_MAX)
    if not bool(ok.all()):
        raise ValueError("expand_fill: live starts must increase strictly "
                         "(INT32_MAX pads only at the end)")


def expand_fill_i32(starts: torch.Tensor, streams: Sequence[torch.Tensor],
                    cap: int) -> List[torch.Tensor]:
    """Run-length decode of match records into per-slot streams.

    ``starts``: int32 (m,), the output run start of each record, strictly
    increasing over the live records, which come first; pad records hold
    INT32_MAX.  ``streams``: int32 (m,) values replicated across each
    record's run.  Returns ``[off, fill(stream)...]``, each int32 (cap,):
    per slot, the offset inside its record's run and the record's values.
    Slots past the last live run replicate the last live record (callers
    mask with their own total); slots before every start, which exist only
    when no record starts at 0, get ``off = slot`` and zeros.
    """
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError("expand_fill takes int32 (m,) starts")
    m = starts.shape[0]
    dev = starts.device
    _i32_streams(streams, m, dev, "expand_fill")
    cap = int(cap)
    if m >= I32_MAX or not 0 <= cap < I32_MAX:
        raise ValueError(f"expand_fill takes m < 2^31 - 1 and "
                         f"0 <= cap < 2^31 - 1, got m={m}, cap={cap}")
    if dev.type == "cpu":
        _check_starts(starts)
        return expand_fill_plain(starts, streams, cap)
    if dev.type != "cuda":
        raise ValueError(f"expand_fill has no kernel for {dev}")
    if not (starts.is_contiguous() and all(s.is_contiguous() for s in streams)):
        raise ValueError("expand_fill takes contiguous tensors")

    outs = [torch.empty(cap, dtype=torch.int32, device=dev)
            for _ in range(len(streams) + 1)]
    if cap == 0:
        return outs
    lib = _build.load()
    n_blocks = -(-cap // lib.olap_expand_fill_tile())
    bound = torch.empty(n_blocks + 1, dtype=torch.int32, device=dev)
    ins_p, outs_p = _ptr_array(streams), _ptr_array(outs[1:])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.olap_expand_fill_i32(
            starts.data_ptr(), m, cap, ins_p, outs_p, len(streams),
            outs[0].data_ptr(), bound.data_ptr(), stream)
    _build.check(err, "expand_fill launch")
    _build.launches["expand_fill"] += 1
    return outs
