"""Collectives over a :class:`~.mesh.Mesh` of per-shard tensors.

The counterparts of the ``jax.lax`` collectives that the JAX package's
``shard_map`` bodies call.  A sharded value is a list with one tensor per
shard of the calling process; a replicated value is one tensor on the
process's first shard's device.  Shards of one process exchange by slicing
and ``cat``, copying with ``.to(device, non_blocking=True)`` where their
devices differ.  Across the ranks of a mesh's process group, one
``torch.distributed`` call per collective carries every block at once; it
is issued on the current stream, so a host read of its result waits for
it as any other.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.metrics import GLOBAL_METRICS
from .mesh import Mesh

#: bytes this process's all-to-alls sent to other ranks
PEER_BYTES = "torch_all_to_all_peer_bytes"


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives carry it: a bool lane as its uint8 bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _exchange(mesh: Mesh, views: Sequence[torch.Tensor]) -> torch.Tensor:
    """The blocks of ``views`` (each (world, L, c, ...): source shard ``i``'s
    block for shard ``l`` of rank ``r`` at ``[r, l]``) that go to other
    ranks, through one ``all_to_all_single``.  Returns (world - 1, L, L, c,
    ...): ``[k, i, l]`` is the block that source shard ``i`` of the k-th
    other rank sent to local shard ``l``."""
    import torch.distributed as dist

    own, v0 = mesh.rank, views[0]
    send = torch.empty((mesh.world - 1, len(views)) + tuple(v0.shape[1:]),
                       dtype=v0.dtype, device=v0.device)
    for i, v in enumerate(views):
        if v.shape != v0.shape or v.dtype != v0.dtype:
            raise ValueError("all_to_all: the send buffers differ in shape "
                             f"or type ({v.shape} {v.dtype} vs {v0.shape} "
                             f"{v0.dtype})")
        send[:own, i] = v[:own]
        send[own:, i] = v[own + 1:]
    recv = torch.empty_like(send)
    splits = [0 if r == own else 1 for r in range(mesh.world)]
    dist.all_to_all_single(_wire(recv), _wire(send), splits, splits,
                           group=mesh.group)
    GLOBAL_METRICS.bump(PEER_BYTES, send.numel() * send.element_size())
    return recv


def all_to_all(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all-to-all along axis 0 (``lax.all_to_all(x, AXIS, 0, 0,
    tiled=True)``): every shard's (ndev * c, ...) send buffer splits into
    ndev blocks; shard ``d`` receives block ``d`` of every source,
    concatenated in source order.  Blocks for other ranks travel packed by
    destination rank, ``L * L * c`` rows a rank pair (L shards a rank)."""
    ndev, local = mesh.size, mesh.local_devices
    if len(blocks) != len(local):
        raise ValueError(f"all_to_all: {len(blocks)} send buffers for "
                         f"{len(local)} local shards")
    for b in blocks:
        if b.shape[0] % ndev:
            raise ValueError(f"all_to_all: {b.shape[0]} rows do not split "
                             f"into {ndev} blocks")
    views = [b.reshape((mesh.world, len(local), b.shape[0] // ndev)
                       + tuple(b.shape[1:])) for b in blocks]
    recv = _exchange(mesh, views) if mesh.world > 1 else None
    out = []
    for j, dev in enumerate(local):
        pieces = []
        for r in range(mesh.world):
            if r == mesh.rank:
                pieces += [_to(v[r, j], dev) for v in views]
            else:
                k = r - (r > mesh.rank)
                pieces += [recv[k, i, j] for i in range(len(local))]
        out.append(torch.cat(pieces))
    return out


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's part, concatenated in shard order, on every shard
    (``lax.all_gather(x, AXIS).reshape(-1, ...)``).  Shards on one device
    share one tensor: the result is read-only.  Across ranks the parts must
    have one shape."""
    if mesh.group is None:
        out, by_device = [], {}
        for dev in mesh.devices:
            if dev not in by_device:
                by_device[dev] = torch.cat([_to(p, dev) for p in parts])
            out.append(by_device[dev])
        return out
    import torch.distributed as dist

    dev = mesh.local_devices[0]
    mine = torch.cat([_to(p, dev) for p in parts])
    gathered = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather([_wire(g) for g in gathered], _wire(mine),
                    group=mesh.group)
    return [torch.cat(gathered)] * len(mesh.local_devices)


def _reduce(mesh: Mesh, values: Sequence[torch.Tensor], op,
            name: str) -> torch.Tensor:
    """``op`` folded over the local values, then across ranks with the
    ``ReduceOp`` named ``name``."""
    dev = mesh.local_devices[0]
    acc = _to(values[0], dev)
    for v in values[1:]:
        acc = op(acc, _to(v, dev))
    if mesh.group is None:
        return acc
    import torch.distributed as dist

    if acc is values[0]:
        acc = acc.clone()  # all_reduce writes in place
    dist.all_reduce(acc, op=getattr(dist.ReduceOp, name), group=mesh.group)
    return acc


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over shards, one replicated value (``lax.psum``)."""
    return _reduce(mesh, values, torch.add, "SUM")


def pmin(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Minimum over shards, one replicated value (``lax.pmin``)."""
    return _reduce(mesh, values, torch.minimum, "MIN")


def pmax(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Maximum over shards, one replicated value (``lax.pmax``)."""
    return _reduce(mesh, values, torch.maximum, "MAX")


def pany(mesh: Mesh, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whether any shard's flag is set, one replicated bool (JAX takes the
    ``pmax`` of the flags as int32)."""
    return pmax(mesh, [f.to(torch.int32) for f in flags]) > 0
