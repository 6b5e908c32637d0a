"""The device mesh of the distributed path: one process, a list of devices.

Port of ``gpu_olap_tpu/parallel/mesh.py``.  JAX runs one ``shard_map``
program over a ``jax.sharding.Mesh``; the port keeps that single-controller
shape with an explicit list of ``torch.device``s under the axis name
:data:`AXIS`.  A sharded array is a Python list of per-shard tensors, shard
``i`` on ``mesh.devices[i]``; a replicated value is one tensor.  A device
may repeat (``[cuda:0] * 8`` is eight logical shards on one card, the
counterpart of JAX's ``--xla_force_host_platform_device_count=8``), and is
always named by the caller.  Collectives live in :mod:`.collectives`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..executor.device import _upload
from ..utils.torchenv import resolve_device

AXIS = "hosts"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``i`` lives on ``devices[i]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(kind: str) -> List[torch.device]:
    """The devices of type ``kind`` ("cuda" or "cpu") this process sees."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {kind!r}: use 'cuda' or 'cpu'")


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: the visible CUDA devices), cut to
    the first ``num_devices``; raises when fewer are given or visible."""
    if devices is None:
        devices = visible_devices("cuda")
    devices = [resolve_device(d) for d in devices]
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"need {num_devices} devices, have {len(devices)} "
                f"({[str(d) for d in devices]})")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def shard_rows(mesh: Mesh, host: np.ndarray, fill=0) -> List[torch.Tensor]:
    """Split a host array into equal per-shard row blocks, each uploaded to
    its shard's device: the counterpart of ``device_put`` with
    ``row_sharding``.  The tail is padded with ``fill`` up to a multiple of
    the mesh size (``DistributedExecutor`` pads tables with zeros and an
    all-False row mask)."""
    n = host.shape[0]
    per = -(-max(n, 1) // mesh.size)
    padded = np.full(per * mesh.size, fill, dtype=host.dtype)
    padded[:n] = host
    return [_upload(padded[i * per:(i + 1) * per], d)
            for i, d in enumerate(mesh.devices)]


def shards_from_numpy(mesh: Mesh, shards: Sequence[np.ndarray]
                      ) -> List[torch.Tensor]:
    """Per-shard numpy arrays (for example a JAX sharded array's
    ``addressable_shards`` in mesh order) as the port's per-shard tensors."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    return [_upload(np.asarray(s), d) for s, d in zip(shards, mesh.devices)]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bring-up.  A no-op for one process; more processes are
    not ported (ROADMAP A11, multi-process and multi-host meshes)."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(
        "multi-process meshes are not ported (ROADMAP A11): the port runs "
        "one process over a list of devices")
