"""Distributed shuffle: hash partitioning of rows over the mesh.

Port of ``gpu_olap_tpu/parallel/shuffle.py``.  JAX runs the shuffle as one
``shard_map`` body with ``all_to_all`` in the middle; here it runs in
phases split at the exchange: every shard buckets its rows by destination
into fixed-capacity blocks (:func:`pack_buckets`), the blocks cross the mesh
(:func:`.collectives.all_to_all`), and every shard marks the received slots
valid from the received counts.  Fixed capacities and the overflow flag stay:
callers size buckets from ``skew.recommend_capacity`` and grow them when a
bucket overflowed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.hashing import bucket_layout, partition_of
from .collectives import all_to_all, pmax
from .mesh import Mesh


def pack_buckets(keys: torch.Tensor, payloads: Sequence[torch.Tensor],
                 row_valid: Optional[torch.Tensor], ndev: int, capacity: int):
    """One shard's half before the exchange: its rows laid out as ``ndev``
    destination blocks of ``capacity`` slots.  Returns (send_keys
    (ndev * capacity,), send_payloads, counts (ndev,) int64, overflow)."""
    dest = partition_of(keys, ndev)
    gather_idx, counts, overflow = bucket_layout(dest, row_valid, ndev,
                                                 capacity)
    flat = gather_idx.reshape(-1)
    return keys[flat], [p[flat] for p in payloads], counts, overflow


def shuffle_rows(mesh: Mesh, keys: Sequence[torch.Tensor],
                 payloads: Sequence[Sequence[torch.Tensor]],
                 row_valid: Sequence[Optional[torch.Tensor]], capacity: int):
    """Hash-shuffle every shard's rows by ``keys`` (int64 partition codes).

    Per-shard arguments, one entry per shard of this process:
    ``keys[i]``, ``payloads[i]`` (a list of lanes that travel with the key)
    and ``row_valid[i]`` (None = all valid).  Returns per-shard lists
    (recv_keys (ndev * capacity,), recv_payloads, recv_valid) and each
    shard's overflow flag (a send bucket past ``capacity``)."""
    ndev, n_local = mesh.size, len(mesh.local_devices)
    send_k, send_p, send_c, overflow = [], [], [], []
    for i in range(n_local):
        k, p, c, of = pack_buckets(keys[i], payloads[i], row_valid[i], ndev,
                                   capacity)
        send_k.append(k)
        send_p.append(p)
        send_c.append(c)
        overflow.append(of)
    recv_k = all_to_all(mesh, send_k)
    del send_k
    n_lanes = len(send_p[0]) if send_p else 0
    recv_lanes = []
    for j in range(n_lanes):
        lane = [send_p[i][j] for i in range(n_local)]
        for i in range(n_local):
            send_p[i][j] = None  # each send lane is freed once it is sent
        recv_lanes.append(all_to_all(mesh, lane))
        del lane
    recv_c = all_to_all(mesh, send_c)
    recv_p, recv_valid = [], []
    for d, dev in enumerate(mesh.local_devices):
        slot = torch.arange(capacity, dtype=torch.int64, device=dev)
        recv_valid.append((slot[None, :] < recv_c[d][:, None]).reshape(-1))
        recv_p.append([recv_lanes[j][d] for j in range(n_lanes)])
    return recv_k, recv_p, recv_valid, overflow


def make_shuffle(mesh: Mesh, n_payloads: int, capacity: int):
    """A sharded shuffle over ``mesh``: ``fn(keys, row_valid, *payloads)``
    over per-shard lists (this process's shards) returns ``(recv_keys,
    *recv_payloads, recv_valid, overflow)``, each a per-shard list except
    ``overflow``, the replicated int32 0/1 of any shard's bucket overflow
    (JAX's ``make_shuffle``)."""

    def _shuffle(keys, row_valid, *payloads):
        if len(payloads) != n_payloads:
            raise ValueError(f"expected {n_payloads} payloads, got "
                             f"{len(payloads)}")
        n_local = len(mesh.local_devices)
        per_shard = [[p[i] for p in payloads] for i in range(n_local)]
        rk, rp, rv, of = shuffle_rows(mesh, keys, per_shard, row_valid,
                                      capacity)
        lanes: List[List[torch.Tensor]] = [[rp[i][j] for i in range(n_local)]
                                           for j in range(n_payloads)]
        overflow = pmax(mesh, [o.to(torch.int32) for o in of])
        return (rk, *lanes, rv, overflow)

    return _shuffle
