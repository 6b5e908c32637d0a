"""The device mesh of the distributed path: a list of devices, in one process
or spread over the ranks of a ``torch.distributed`` process group.

Port of ``gpu_olap_tpu/parallel/mesh.py``.  JAX runs one ``shard_map``
program over a ``jax.sharding.Mesh``; the port keeps that shape with an
explicit list of ``torch.device``s under the axis name :data:`AXIS`.  A
sharded array is a Python list of per-shard tensors; a replicated value is
one tensor.  A device may repeat (``[cuda:0] * 8`` is eight logical shards
on one card, the counterpart of JAX's
``--xla_force_host_platform_device_count=8``), and is always named by the
caller.  Collectives live in :mod:`.collectives`.

Several processes (JAX's ``jax.distributed``): every rank calls
:func:`initialize_distributed`, then :func:`make_mesh` with the same global
device list and ``group=``.  With S shards over W ranks, rank ``r`` owns
the contiguous shards ``r * S // W`` to ``(r + 1) * S // W - 1``, as JAX's
global device order has it, and per-shard lists hold the calling rank's
shards only, in mesh order.  One process per card (NCCL), or gloo on the
CPU when the caller names ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..executor.device import _upload
from ..utils.torchenv import resolve_device

AXIS = "hosts"

#: how long a rank waits for the others to join or to reach a collective
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``i`` lives on ``devices[i]``.  Without a process
    group every shard is local; with one, rank ``rank`` of ``world`` owns
    the ``size // world`` shards of its block."""

    devices: Tuple[torch.device, ...]
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_indices(self) -> range:
        """The global indices of this process's shards, in mesh order."""
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        idx = self.local_indices
        return self.devices[idx.start:idx.stop]


def visible_devices(kind: str) -> List[torch.device]:
    """The devices of type ``kind`` ("cuda" or "cpu") this process sees."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {kind!r}: use 'cuda' or 'cpu'")


def _rank_device(group) -> torch.device:
    """The device :func:`initialize_distributed` gave this rank: its card
    under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "nccl":
        return resolve_device("cuda")
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unsupported process-group backend {backend!r}")


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, group=None) -> Mesh:
    """1-D mesh over ``devices`` (default: the visible CUDA devices), cut to
    the first ``num_devices``; raises when fewer are given or visible.

    With ``group`` (a process group) ``devices`` is the global list, the same
    on every rank; the shards split evenly over the ranks, and this rank's
    entries must name its own device (``cuda:0`` eight times for one rank
    on one card; ``cuda:0, cuda:0, cuda:1, cuda:1, ...`` for four ranks)."""
    if group is not None and devices is None:
        raise ValueError("a mesh over a process group needs the global "
                         "device list")
    if devices is None:
        devices = visible_devices("cuda")
    devices = list(devices)
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"need {num_devices} devices, have {len(devices)} "
                f"({[str(d) for d in devices]})")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        return Mesh(tuple(resolve_device(d) for d in devices))

    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if len(devices) % world:
        raise ValueError(f"{len(devices)} shards do not split evenly over "
                         f"{world} ranks")
    per, own = len(devices) // world, _rank_device(group)
    resolved = []
    for i, d in enumerate(devices):
        if i // per == rank:
            d = resolve_device(d)
            if d != own:
                raise ValueError(f"shard {i} belongs to rank {rank}, whose "
                                 f"device is {own}, not {d}")
        resolved.append(torch.device(d))
    return Mesh(tuple(resolved), group, rank, world)


def shard_rows(mesh: Mesh, host: np.ndarray, fill=0) -> List[torch.Tensor]:
    """Split a global host array into equal per-shard row blocks and upload
    this process's blocks, each to its shard's device: the counterpart of
    ``device_put`` with ``row_sharding``.  The tail is padded with ``fill``
    up to a multiple of the mesh size (``DistributedExecutor`` pads tables
    with zeros and an all-False row mask)."""
    per = -(-max(host.shape[0], 1) // mesh.size)
    out = []
    for i in mesh.local_indices:
        block = host[i * per:(i + 1) * per]
        if block.shape[0] < per:
            pad = np.full((per - block.shape[0],) + host.shape[1:], fill,
                          dtype=host.dtype)
            block = np.concatenate([block, pad])
        out.append(_upload(block, mesh.devices[i]))
    return out


def shards_from_numpy(mesh: Mesh, shards: Sequence[np.ndarray]
                      ) -> List[torch.Tensor]:
    """Every shard's numpy array, in mesh order (for example a JAX sharded
    array's ``addressable_shards``), as this process's per-shard tensors."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    return [_upload(np.asarray(shards[i]), mesh.devices[i])
            for i in mesh.local_indices]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda"):
    """Multi-process bring-up: the counterpart of ``jax.distributed.
    initialize``.  Returns the process group to pass to :func:`make_mesh`.

    A no-op (returns None) when ``num_processes`` is None, or 1 without a
    coordinator.  Otherwise it joins ``num_processes`` ranks at
    ``coordinator`` ("host:port", or any ``init_method`` URL such as
    ``file:///path``), at any size, 1 included.  ``device="cuda"`` gives
    rank ``process_id`` the card ``cuda:{process_id % device_count}`` and an
    NCCL group, and raises when that card is not there; ``device="cpu"``
    forms a gloo group.  Nothing falls back to another backend."""
    if num_processes is None or (num_processes <= 1 and coordinator is None):
        return None
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id!r} is not a rank of "
                         f"{num_processes}")
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        dev = resolve_device(f"cuda:{process_id % count}" if count else device)
        torch.cuda.set_device(dev)
        kwargs = {"backend": "nccl", "device_id": dev}
    elif kind == "cpu":
        kwargs = {"backend": "gloo"}
    else:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")

    import torch.distributed as dist

    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(init_method=init, world_size=num_processes,
                            rank=process_id, timeout=DEFAULT_TIMEOUT,
                            **kwargs)
    return dist.group.WORLD
