"""Device hash functions and the bucket layout of the distributed shuffle.

Port of ``gpu_olap_tpu/ops/hashing.py``: the MurmurHash3 finalizers, the
hash partition id of a key and the dense (bucket, slot) layout that a
shuffle sends.  Torch has no ``>>`` or ``%`` for ``uint32`` on the CPU, so
the 32-bit hash runs in int64 lanes holding values in [0, 2^32), masked
after every multiply; the 64-bit hash runs in int64 with wrapping
multiplies and its unsigned shifts masked into logical ones.  Both are
bit-exact with the JAX functions.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M63 = 0x7FFFFFFFFFFFFFFF


def _as_i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (the uint64 ``>>``)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 64-bit finalizer (fmix64) on int64 keys, as a
    non-negative int64 (the top bit cleared, as JAX returns it)."""
    h = x.to(torch.int64)
    h = h ^ _lsr(h, 33)
    h = h * _as_i64(0xFF51AFD7ED558CCD)
    h = h ^ _lsr(h, 33)
    h = h * _as_i64(0xC4CEB9FE1A85EC53)
    h = h ^ _lsr(h, 33)
    return h & _M63


def hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit MurmurHash3 finalizer over int64 keys whose high word is
    folded into the low one.  Returns the uint32 hash as int64 in
    [0, 2^32)."""
    x = x.to(torch.int64)
    u = (x & _M32) ^ ((x >> 32) & _M32)
    u = u ^ (u >> 16)
    u = (u * 0x85EBCA6B) & _M32
    u = u ^ (u >> 13)
    u = (u * 0xC2B2AE35) & _M32
    return u ^ (u >> 16)


def partition_of(key: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Hash partition id of each key (``hash32 % num_partitions``), int32."""
    return (hash32(key) % int(num_partitions)).to(torch.int32)


def bucket_layout(dest: torch.Tensor, row_valid, num_buckets: int,
                  bucket_cap: int):
    """Arrange rows into a (num_buckets, bucket_cap) dense layout.

    Returns (gather_idx (num_buckets, bucket_cap) int64, counts
    (num_buckets,) int64, overflow 0-d bool).  Row ``gather_idx[b, s]`` of
    the original order is the s-th row of bucket b for ``s < counts[b]``;
    rows keep their input order inside a bucket (a stable sort by
    destination).  Slots at or past ``counts[b]`` are padding: as in JAX,
    the clipped slot index points into the next bucket's rows."""
    n = dest.shape[0]
    dev = dest.device
    dest32 = dest.to(torch.int32)
    if row_valid is not None:
        # invalid rows go to a drop bucket past the last one
        dest32 = torch.where(row_valid, dest32, num_buckets)
    sorted_dest, sorted_rows = torch.sort(dest32, stable=True)
    bucket_ids = torch.arange(num_buckets + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(sorted_dest, bucket_ids, side="left")
    counts = bounds[1:] - bounds[:-1]
    overflow = counts.max() > bucket_cap
    slot = torch.arange(bucket_cap, dtype=torch.int64, device=dev)[None, :]
    src = torch.clamp(bounds[:-1, None] + slot, 0, max(n - 1, 0))
    gather_idx = sorted_rows[src] if n else torch.zeros(
        (num_buckets, bucket_cap), dtype=torch.int64, device=dev)
    return gather_idx, counts.to(torch.int64), overflow
