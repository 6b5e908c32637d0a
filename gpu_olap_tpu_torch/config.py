"""Engine configuration.

The port's own copy of ``gpu_olap_tpu/config.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

TPU-native analogue of the reference's ``EngineConfig``
(``gpu-olap-core/src/lib.rs:20-43``): ``max_gpu_memory`` becomes ``max_hbm_bytes``,
``num_streams`` becomes ``num_feed_buffers`` (double/multi-buffered host->device
feeding slots), ``use_unified_memory`` becomes ``out_of_core`` (host-streamed scans),
and ``batch_size`` / ``enable_cache`` keep their roles.  We add TPU-specific knobs:
shape-bucketing policy (recompile avoidance), join/aggregate capacity policies, and
mesh shape for multi-host execution.  ``from_kwargs`` takes the reference's
names as aliases; the streamer's staging arena takes ``max_hbm_bytes`` as its
byte limit.  ``out_of_core`` (``use_unified_memory``) is accepted and read by
nothing, as in the JAX package: tables above ``table_cache_threshold_rows``
stream whatever it says.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class EngineConfig:
    # --- capacity / memory (slab-allocator analogue) ---
    max_hbm_bytes: int = 8 * 1024**3          # reference default: 8 GB (lib.rs:35)
    num_feed_buffers: int = 8                 # reference: num_streams = 8 (lib.rs:36)
    out_of_core: bool = True                  # reference: use_unified_memory (lib.rs:37)
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
    prefer_float32: bool = False              # use f32 compute for float cols (TPU fast path)
    # Static-shape bucketing: row counts are padded up to the next bucket so that
    # recompiles are bounded (the kernel-cache analogue of codegen.rs:36-47).
    shape_bucket_growth: float = 2.0
    min_shape_bucket: int = 1024

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
    # Radix partition fan-out for partitioned joins / shuffles (reference uses
    # 8-bit radix -> 256 partitions, join_kernels.cuh:22-23).
    radix_bits: int = 8
    # Direct-address join: when zone-map stats bound the build key range to at
    # most this many distinct slots, probe via a dense offset table (2 gathers
    # per probe row) instead of binary search.
    direct_join_max_range: int = 1 << 26
    # Force a join strategy: None = cost/stats-based choice; "sort_merge"
    # disables the lookup/direct fast paths; "broadcast_hash"/"radix_hash"
    # keep them (reference JoinStrategy surface, join_kernel.rs:3-18).
    join_strategy: Optional[str] = None
    # Sorted-space join aggregation (round 5): global/grouped aggregates
    # over inner joins reduce in merge-sorted key space without the
    # probe-order restore sort.  None/True = on; False = keep the
    # materialize/probe-order paths (A/B + escape hatch).
    use_sorted_join_agg: Optional[bool] = None

    # --- distribution ---
    mesh_shape: Optional[Tuple[int, ...]] = None   # None = single device
    mesh_axis_names: Tuple[str, ...] = ("hosts",)

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
            "use_unified_memory": "out_of_core",
        }
        resolved = {}
        for key, value in kwargs.items():
            resolved[alias.get(key, key)] = value
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(resolved) - known
        if unknown:
            raise TypeError(f"Unknown EngineConfig options: {sorted(unknown)}")
        return cls(**resolved)

