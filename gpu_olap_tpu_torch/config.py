"""Engine configuration: the options the port reads.

The port's counterpart of ``gpu_olap_tpu/config.py`` (this package imports
nothing of the JAX package), with the JAX package's names and defaults, so
one set of options drives both engines.  It keeps only the options the port
reads: it runs eagerly on tensors of data-dependent size, so JAX's
shape-bucketing, float32, radix and mesh-axis options have no counterpart
here.  ``from_kwargs`` takes the reference constructor's names
(``gpu-olap-core/src/lib.rs:20-43``) as aliases.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class EngineConfig:
    # --- capacity / memory (slab-allocator analogue) ---
    max_hbm_bytes: int = 8 * 1024**3          # reference default: 8 GB (lib.rs:35)
    num_feed_buffers: int = 8                 # reference: num_streams = 8 (lib.rs:36)
    batch_size: int = 1_000_000               # rows per streamed chunk (lib.rs:38)
    enable_cache: bool = True                 # compiled-plan cache (lib.rs:39)

    # --- device execution policy ---
    backend: str = "auto"                     # "auto" | "device" | "cpu" (numpy oracle)
    # The hand-written CUDA kernels in the execution path (the fused
    # filter+aggregate, ...); CPU tensors take their plain versions.
    # False = plain PyTorch everywhere.  The field names are the JAX
    # package's, so one config drives both engines.
    use_pallas: bool = True
    # The fused post-sort GROUP BY kernel (csrc/seg_agg.cu): None = auto = ON
    # when ``use_pallas`` is; False forces the plain post-sort pipeline.
    use_pallas_seg_agg: Optional[bool] = None

    # Hash-aggregate: max distinct groups a single pass can produce (padded output).
    max_groups: int = 1 << 21                 # 2M groups
    # Out-of-core streaming: when a streamed GROUP BY needs a group state
    # larger than this, the state is hash-partitioned across several
    # smaller per-partition states (chunks split by group-key hash on the
    # host).  It is the only streamed route past 2^24 groups, and it bounds
    # each step's merge sort to one partition's state instead of the whole
    # one.  The default is the JAX package's, so both engines take the same
    # route on the same query.
    stream_state_partition_groups: int = 1 << 21
    # Join: output capacity as a multiple of the probe side (padded match buffer).
    join_expansion: float = 2.0
    # Join strategy threshold: build sides <= this use broadcast join
    # (reference join_kernel.rs:71-77 uses 1M rows).
    broadcast_join_threshold: int = 1_000_000
    # Direct-address join: when zone-map stats bound the build key range to at
    # most this many distinct slots, probe via a dense offset table (2 gathers
    # per probe row) instead of binary search.
    direct_join_max_range: int = 1 << 26
    # Force a join strategy: None = cost/stats-based choice; "sort_merge"
    # disables the lookup/direct fast paths; "broadcast_hash"/"radix_hash"
    # keep them (reference JoinStrategy surface, join_kernel.rs:3-18).
    join_strategy: Optional[str] = None

    # --- distribution ---
    mesh_shape: Optional[Tuple[int, ...]] = None   # None = single device

    # --- catalog ---
    table_cache_threshold_rows: int = 10_000_000   # reference catalog.rs:50
    # grace-join spill partitioning (out-of-core joins where BOTH sides
    # exceed the cache threshold; reference PROJECT_SUMMARY.md:24,115-118)
    spill_dir: Optional[str] = None                # None = system temp dir
    spill_partitions: Optional[int] = None         # None = auto from sizes

    # --- compatibility aliases (reference Python ctor kwargs) ---
    @classmethod
    def from_kwargs(cls, **kwargs) -> "EngineConfig":
        alias = {
            "max_gpu_memory": "max_hbm_bytes",
            "num_streams": "num_feed_buffers",
        }
        # unified memory has nothing to switch: a table streams when it is
        # above table_cache_threshold_rows
        kwargs.pop("use_unified_memory", None)
        resolved = {}
        for key, value in kwargs.items():
            resolved[alias.get(key, key)] = value
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(resolved) - known
        if unknown:
            raise TypeError(f"Unknown EngineConfig options: {sorted(unknown)}")
        return cls(**resolved)

