"""Collectives over a :class:`~.mesh.Mesh` of per-shard tensors.

The counterparts of the ``jax.lax`` collectives that the JAX package's
``shard_map`` bodies call.  A sharded value is a list with one tensor per
shard; a replicated value is one tensor on the mesh's first device.  Shards
on the same device exchange by slicing and ``cat``; shards on different
devices copy with ``.to(device, non_blocking=True)``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .mesh import Mesh


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def all_to_all(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all-to-all along axis 0 (``lax.all_to_all(x, AXIS, 0, 0,
    tiled=True)``): every shard's (ndev * c, ...) send buffer splits into
    ndev blocks; shard ``d`` receives block ``d`` of every source,
    concatenated in source order."""
    ndev = mesh.size
    for b in blocks:
        if b.shape[0] % ndev:
            raise ValueError(f"all_to_all: {b.shape[0]} rows do not split "
                             f"into {ndev} blocks")
    return [torch.cat([_to(b[d * (b.shape[0] // ndev):
                           (d + 1) * (b.shape[0] // ndev)], dev)
                       for b in blocks])
            for d, dev in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's part, concatenated in shard order, on every shard
    (``lax.all_gather(x, AXIS).reshape(-1, ...)``).  Shards on one device
    share one tensor: the result is read-only."""
    out, by_device = [], {}
    for dev in mesh.devices:
        if dev not in by_device:
            by_device[dev] = torch.cat([_to(p, dev) for p in parts])
        out.append(by_device[dev])
    return out


def _reduce(mesh: Mesh, values: Sequence[torch.Tensor], op) -> torch.Tensor:
    dev = mesh.devices[0]
    acc = _to(values[0], dev)
    for v in values[1:]:
        acc = op(acc, _to(v, dev))
    return acc


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over shards, one replicated value (``lax.psum``)."""
    return _reduce(mesh, values, torch.add)


def pmin(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Minimum over shards, one replicated value (``lax.pmin``)."""
    return _reduce(mesh, values, torch.minimum)


def pmax(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Maximum over shards, one replicated value (``lax.pmax``)."""
    return _reduce(mesh, values, torch.maximum)


def pany(mesh: Mesh, flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whether any shard's flag is set, one replicated bool (JAX takes the
    ``pmax`` of the flags as int32)."""
    return pmax(mesh, [f.to(torch.int32) for f in flags]) > 0
