"""Out-of-core streamed execution.

Port of ``gpu_olap_tpu/executor/streaming.py``.  Aggregation pipelines over
uncached (larger-than-threshold) Parquet tables stream host chunks through
the feeder into a *partial-aggregate + merge* step against a
device-resident group state: transfers run on the feeder's copy stream
ahead of compute, peak device memory is a window of chunks plus the group
state, and results are exact for the mergeable aggregates
(SUM/COUNT/MIN/MAX, AVG as sum + count).

Three routes, as in the JAX package:

* one group state, merged chunk by chunk (optionally probing a cached,
  device-resident build side: the streamed join);
* hash-partitioned group states: chunks are split by group-key hash on the
  host, each sub-chunk merges into its partition's state, and the
  partitions' disjoint results concatenate (the only route past 2^24
  groups);
* the grace join: when both join sides exceed the cache threshold, both
  spill into k hash partitions on disk and each pair joins with a resident
  build side, all pairs merging into one group state.

The step is an eager function on tensors.  Its per-chunk overflow flags are
collected as device tensors and read once after the stream, and a chunk's
host staging buffers go back to the arena only after the step that read
them has finished (an event behind the step on CUDA; on the CPU the step's
tensors alias them and the step returns when done).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..interop import arrow as arrow_io
from ..interop.columnar import Column, ColumnBatch, DType
from ..mem.arena import BufferArena
from ..mem.feeder import DeviceFeeder
from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops import join as join_ops
from ..ops.dtypes import INT64_MIN, key_code, torch_dtype
from ..plan import physical as P
from ..utils.metrics import GLOBAL_METRICS
from ..utils import tracing
from ..utils.tracing import get_logger
from .device import DevBatch, DevCol, _gather_col, _np_kind, _upload
from .spill import SpillStore, choose_partitions, spill_hash

logger = get_logger(__name__)


class NotStreamable(Exception):
    """Plan shape not supported by the streaming path."""


@dataclasses.dataclass
class _StreamablePipeline:
    scan: P.TpuTableScan              # the streamed (probe) scan
    # operators between the streamed scan and the aggregate (or the join),
    # bottom-up order
    middle: List[P.PhysicalPlan]
    aggregate: P.TpuAggregate
    # streamed-join extension: probe chunks join a device-resident build side
    join: Optional[P.TpuHashJoin] = None
    agg_middle: List[P.PhysicalPlan] = dataclasses.field(default_factory=list)
    build_plan: Optional[P.PhysicalPlan] = None  # cached-side subtree
    # grace-join mode: BOTH sides exceed the memory threshold -> hash-spill
    # both into k partition pairs, join each pair with a resident build
    partitioned: bool = False


def _reject_known_nulls(catalog, scan: P.TpuTableScan) -> None:
    """Streamed chunk staging uploads DATA lanes only (no validity), so a
    scanned column with metadata-recorded nulls cannot stream correctly:
    the full-load device path runs instead, which carries validity masks
    end to end.  Unknown null counts (writer recorded none) stream."""
    stats = catalog.get_stats(scan.table_name) or {}
    nulls = stats.get("__nulls__")
    if not isinstance(nulls, dict):
        return
    sch = catalog.get_schema(scan.table_name)
    idxs = (scan.projection if scan.projection is not None
            else range(len(sch)))
    for i in idxs:
        nm = sch.field(i).name
        nc = nulls.get(nm)
        if nc is not None and nc > 0:
            raise NotStreamable(f"nulls in streamed column {nm!r}")


def _strip_middle(node: P.PhysicalPlan):
    middle: List[P.PhysicalPlan] = []
    while isinstance(node, (P.TpuFilter, P.TpuProjection)):
        middle.append(node)
        node = node.input
    return list(reversed(middle)), node


def split_above_aggregate(plan: P.PhysicalPlan):
    """Walk down single-input operators (SELECT-list projection, HAVING
    filter, ORDER BY, LIMIT, DISTINCT) to the aggregate subtree.

    The planner always places the SELECT-list ``TpuProjection`` above the
    aggregate, so matching strictly at the root would reject every real SQL
    plan.  The small post-aggregate operators run on the host over the
    (max_groups-bounded) group results instead.
    """
    node = plan
    seen_above = False
    while True:
        if isinstance(node, P.TpuAggregate):
            return node, seen_above
        kids = node.inputs()
        if len(kids) != 1:
            raise NotStreamable(type(node).__name__)
        seen_above = True
        node = kids[0]


def match_streamable(plan: P.PhysicalPlan, catalog) -> _StreamablePipeline:
    """Aggregate over (F|P)* over [Join(streamed probe, cached build) |
    streamed TableScan]."""
    if not isinstance(plan, P.TpuAggregate):
        raise NotStreamable(type(plan).__name__)
    if any(a.distinct for a in plan.aggs):
        raise NotStreamable("COUNT(DISTINCT) is not mergeable across chunks")
    middle, node = _strip_middle(plan.input)
    if isinstance(node, P.TpuTableScan):
        _reject_known_nulls(catalog, node)
        return _StreamablePipeline(node, middle, plan)
    if isinstance(node, P.TpuHashJoin):
        join = node
        if join.join_type != "inner":
            raise NotStreamable("streamed outer join")
        if len(join.left_keys) != 1:
            raise NotStreamable("streamed multi-key join")
        probe_middle, probe_leaf = _strip_middle(join.left)
        build_middle, build_leaf = _strip_middle(join.right)
        if not isinstance(probe_leaf, P.TpuTableScan) \
                or not isinstance(build_leaf, P.TpuTableScan):
            raise NotStreamable("streamed join requires scan leaves")
        if join.left_keys[0].dtype is DType.STRING:
            raise NotStreamable("string join keys while streaming")
        if catalog.is_cached(probe_leaf.table_name) \
                and catalog.is_cached(build_leaf.table_name):
            raise NotStreamable("both sides cached (in-memory path)")
        if catalog.is_cached(build_leaf.table_name):
            _reject_known_nulls(catalog, probe_leaf)
            return _StreamablePipeline(probe_leaf, probe_middle, plan,
                                       join=join, agg_middle=middle,
                                       build_plan=join.right)
        # build side above the memory threshold: grace-join partitioning
        # (reference PROJECT_SUMMARY.md:24,115-118).  Host partitioning
        # hashes raw table columns, so keys must be plain column refs and
        # both scans direct
        if probe_middle or build_middle:
            raise NotStreamable("partitioned join with per-side operators")
        if not isinstance(join.left_keys[0], P.ColumnRef) \
                or not isinstance(join.right_keys[0], P.ColumnRef):
            raise NotStreamable("partitioned join key must be a column")
        for leaf in (probe_leaf, build_leaf):
            sch = catalog.get_schema(leaf.table_name)
            idxs = (leaf.projection if leaf.projection is not None
                    else range(len(sch)))
            if any(sch.field(i).dtype is DType.STRING for i in idxs):
                raise NotStreamable("string columns in partitioned join")
        _reject_known_nulls(catalog, probe_leaf)
        return _StreamablePipeline(probe_leaf, probe_middle, plan,
                                   join=join, agg_middle=middle,
                                   build_plan=join.right, partitioned=True)
    raise NotStreamable(type(node).__name__)


def _prefetch_iter(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue: Parquet
    chunk decoding (which releases the interpreter lock) overlaps the
    staging and upload of earlier chunks."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def run():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # a consumer that stops early: unblock the reader and let it end
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(0.01)


class _StepClock:
    """CUDA events around each streamed step on the compute stream, read
    once after the stream (no per-step synchronization).  An interval also
    holds the device's idle time while the host launches the rest of its
    step (a merge step syncs twice, in ``groupby_aggregate``), so the sum
    is an upper bound on the device's busy time.  The event behind a step
    is also the marker that releases the step's staging buffers.  Off CUDA
    there is nothing to time and the markers are None."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.pairs = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        return self._event() if self.on else None

    def stop(self, started):
        if not self.on:
            return None
        done = self._event()
        self.pairs.append((started, done))
        return done

    def seconds(self) -> Optional[float]:
        """Summed step intervals on the device; call after the stream
        synced."""
        if not self.on:
            return None
        return sum(s.elapsed_time(e) for s, e in self.pairs) / 1e3


class StreamingAggregator:
    """Chunked scan -> filter/project -> partial group-by -> state merge."""

    def __init__(self, catalog, config: EngineConfig, interpreter_cls,
                 device: torch.device):
        self.catalog = catalog
        self.config = config
        self.device = torch.device(device)
        self._interpreter_cls = interpreter_cls
        # pooled host staging buffers for chunk upload (slab-allocator
        # analogue, slab_allocator.rs:24-130), page-locked on CUDA
        self.arena = BufferArena(max_bytes=config.max_hbm_bytes,
                                 pinned=self.device.type == "cuda")
        # grace-join spill partitions (cached per table version)
        self.spill = SpillStore(config.spill_dir)
        self._reset_stats()

    def _reset_stats(self) -> None:
        """Per-query stream statistics (summed over every stream the query
        runs: retries and grace-join partition pairs included)."""
        self.last_partitioned = False
        self.last_hash_parts = 1
        self.last_spill_partitions = 0
        self.last_stream_chunks = 0
        self.last_stream_rows = 0
        self.last_link_bytes = 0
        self.last_stream_seconds = 0.0
        # host seconds spent splitting chunks by group-key hash
        self.last_split_seconds = 0.0
        # summed step intervals on the device, an upper bound on its busy
        # time (CUDA only)
        self.last_step_interval_seconds = 0.0 if self.device.type == "cuda" \
            else None

    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        self._reset_stats()
        agg_root, has_above = split_above_aggregate(plan)
        with tracing.span(logger, "streamed_execute"):
            batch = self._execute_aggregate(agg_root)
            tracing.annotate(rows_in=self.last_stream_rows,
                             rows_out=batch.num_rows,
                             link_bytes=self.last_link_bytes)
        if has_above:
            # post-aggregate operators run on the host over the small
            # group-result batch (same mechanism as the distributed path)
            from .cpu import CpuExecutor

            cpu = CpuExecutor(self.catalog, self.config)
            cpu.leaf_results = {id(agg_root): batch}
            return cpu.execute(plan)
        return batch

    def _execute_aggregate(self, plan: P.TpuAggregate) -> ColumnBatch:
        pipe = match_streamable(plan, self.catalog)
        string_cols = _string_sources(pipe)
        agg = pipe.aggregate
        chunk_rows = self.config.batch_size
        partials = self._stream_partials(pipe)
        self.last_partitioned = pipe.partitioned

        max_groups = min(self.config.max_groups, 1 << 22)
        join_capacity = int(chunk_rows * self.config.join_expansion) \
            if pipe.join is not None else 0

        if pipe.partitioned:
            GLOBAL_METRICS.bump("torch_grace_join")
            return self._execute_partitioned(pipe, chunk_rows, max_groups,
                                             join_capacity, partials)

        if pipe.join is None and self._hash_state_keys(pipe) is not None \
                and max_groups > self.config.stream_state_partition_groups:
            GLOBAL_METRICS.bump("torch_streamed_hash_state")
            return self._execute_hash_state(pipe, chunk_rows, max_groups,
                                            partials)

        GLOBAL_METRICS.bump("torch_streamed_join" if pipe.join is not None
                            else "torch_streamed_scan")
        build = self._prepare_build(pipe) if pipe.join is not None else None
        # the resident build batch fixes each string value's dictionary for
        # the whole stream
        dicts = [None if j is None else build["batch"].cols[j].dictionary
                 for j in string_cols]
        if build is not None:
            # size the per-chunk match buffer from the build side's MEASURED
            # key duplication (2x headroom) instead of blind growth retries
            join_capacity = max(join_capacity, _dup_capacity(
                chunk_rows, build["avg_dup"]))

        key_narrow = self._key_narrow(pipe)
        for _attempt in range(5):
            state = _init_state(agg.group_exprs, partials, max_groups,
                                self.device, key_narrow)
            state, (j_ovf, g_ovf) = self._stream_part(
                pipe, build, chunk_rows, max_groups, join_capacity, partials,
                state, self._probe_chunks(pipe, chunk_rows))
            if not (j_ovf or g_ovf):
                return self._finalize(agg, state, partials, dicts)
            # grow ONLY the overflowing capacity
            if j_ovf:
                join_capacity *= 4
            if g_ovf:
                max_groups = min(max_groups * 4, 1 << 24)
            logger.warning("streamed pass overflowed (join=%s groups=%s); "
                           "retrying with join_capacity=%d max_groups=%d",
                           j_ovf, g_ovf, join_capacity, max_groups)
        raise RuntimeError("streaming capacities kept overflowing")

    def _stream_partials(self, pipe):
        """Partial layout, with dtype narrowing for the scan-only pipelines
        where zone maps prove it (see _partial_layout)."""
        agg = pipe.aggregate
        if pipe.join is not None or \
                any(isinstance(op, P.TpuProjection) for op in pipe.middle):
            return _partial_layout(agg)
        narrow = self._narrow_flags(pipe)
        ranges = {i: r for i, (ok, r) in enumerate(narrow) if r is not None}
        total = self.catalog.get_row_count(pipe.scan.table_name)
        return _partial_layout(agg, ranges, total)

    def _key_narrow(self, pipe):
        """Per-group-expr: key-code lanes stay int32 (chunk cols upload as
        int32 and the state lane matches), so the merge sorts int32 keys."""
        if pipe.join is not None or \
                any(isinstance(op, P.TpuProjection) for op in pipe.middle):
            return None
        narrow = self._narrow_flags(pipe)
        return tuple(
            isinstance(g, P.ColumnRef) and g.index < len(narrow)
            and narrow[g.index][0]
            for g in pipe.aggregate.group_exprs)

    def _probe_cols(self, pipe) -> List[str]:
        table_schema = self.catalog.get_schema(pipe.scan.table_name)
        return ([f.name for f in table_schema]
                if pipe.scan.projection is None
                else [table_schema.field(i).name
                      for i in pipe.scan.projection])

    def _probe_chunks(self, pipe, chunk_rows, path=None):
        cols = self._probe_cols(pipe)
        if path is not None:
            return arrow_io.iter_parquet_chunks(path, chunk_rows, cols)
        return self.catalog.iter_table_chunks(
            pipe.scan.table_name, chunk_rows, columns=cols)

    def _execute_partitioned(self, pipe, chunk_rows, max_groups,
                             join_capacity, partials) -> ColumnBatch:
        """Grace join: both sides spill into k hash partitions by join key;
        each pair joins with a device-resident build side, accumulating into
        ONE mergeable group state across all pairs (reference out-of-core
        contract, PROJECT_SUMMARY.md:24,115-118)."""
        agg = pipe.aggregate
        join = pipe.join
        _, build_scan = _strip_middle(pipe.build_plan)

        def raw_name(scan, pos):
            # scan schemas are table-qualified; spill chunks carry the raw
            # Parquet column names — map through the scan projection
            tsch = self.catalog.get_schema(scan.table_name)
            ti = pos if scan.projection is None else scan.projection[pos]
            return tsch.field(ti).name

        lname = raw_name(pipe.scan, join.left_keys[0].index)
        rname = raw_name(build_scan, join.right_keys[0].index)
        build_rows = self.catalog.get_row_count(build_scan.table_name)
        target = max(self.catalog.cache_threshold // 2, chunk_rows)
        k = self.config.spill_partitions or choose_partitions(build_rows,
                                                              target)
        self.last_spill_partitions = k
        bsch = self.catalog.get_schema(build_scan.table_name)
        bcols = ([f.name for f in bsch] if build_scan.projection is None
                 else [bsch.field(i).name for i in build_scan.projection])
        probe_paths = self.spill.partition_table(
            self.catalog, pipe.scan.table_name, lname, k, chunk_rows,
            self._probe_cols(pipe))
        build_paths = self.spill.partition_table(
            self.catalog, build_scan.table_name, rname, k, chunk_rows, bcols)

        for _attempt in range(5):
            state = _init_state(agg.group_exprs, partials, max_groups,
                                self.device)
            j_ovf = g_ovf = False
            n_parts = 0
            used_cap = join_capacity
            for pi in range(k):
                if not (os.path.exists(build_paths[pi])
                        and os.path.exists(probe_paths[pi])):
                    continue  # empty partition on either side: no matches
                host = arrow_io.read_parquet(build_paths[pi])
                build = self._prepare_build(pipe, host_batch=host)
                # per-partition match buffer from MEASURED key duplication
                cap_pi = max(join_capacity, _dup_capacity(
                    chunk_rows, build["avg_dup"]))
                used_cap = max(used_cap, cap_pi)
                state, (jo, go) = self._stream_part(
                    pipe, build, chunk_rows, max_groups, cap_pi,
                    partials, state,
                    self._probe_chunks(pipe, chunk_rows,
                                       path=probe_paths[pi]))
                j_ovf = j_ovf or jo
                g_ovf = g_ovf or go
                n_parts += 1
            logger.info("partitioned join: %d/%d partition pairs joined",
                        n_parts, k)
            if not (j_ovf or g_ovf):
                return self._finalize(agg, state, partials)
            if j_ovf:
                join_capacity = used_cap * 4
            if g_ovf:
                max_groups = min(max_groups * 4, 1 << 24)
            logger.warning("partitioned pass overflowed (join=%s groups=%s); "
                           "retrying with join_capacity=%d max_groups=%d",
                           j_ovf, g_ovf, join_capacity, max_groups)
        raise RuntimeError("partitioned join capacities kept overflowing")

    # ------------------------------------------------------------------
    # Hash-partitioned streamed group state: past
    # ``stream_state_partition_groups`` the state is split across P hash
    # partitions of <= part_cap groups each.  Chunks are hash-split BY GROUP
    # KEY on the host while staging; each sub-chunk merges into its
    # partition's state.  Group keys are disjoint across partitions, so the
    # finalized partitions simply concatenate — exact.
    # ------------------------------------------------------------------
    def _hash_state_keys(self, pipe) -> Optional[List[int]]:
        """Host chunk column positions of the group keys, or None when the
        pipeline shape does not support host-side key hashing: every group
        expr must be a plain ColumnRef into the scan schema and the scan ->
        aggregate middle must not reshape columns (filters are fine — they
        are row-local and run on the device after the split)."""
        agg = pipe.aggregate
        if not agg.group_exprs:
            return None
        if any(isinstance(op, P.TpuProjection) for op in pipe.middle):
            return None
        pos = []
        for g in agg.group_exprs:
            if not isinstance(g, P.ColumnRef):
                return None
            if g.index >= len(pipe.scan.schema):
                return None
            pos.append(g.index)
        return pos

    def _execute_hash_state(self, pipe, chunk_rows, max_groups,
                            partials) -> ColumnBatch:
        agg = pipe.aggregate
        key_pos = self._hash_state_keys(pipe)
        for _attempt in range(5):
            part_cap = self.config.stream_state_partition_groups >> 1
            n_parts = 1
            while (max_groups + n_parts - 1) // n_parts > (part_cap >> 1):
                n_parts <<= 1
            states = [_init_state(agg.group_exprs, partials, part_cap,
                                  self.device, self._key_narrow(pipe))
                      for _ in range(n_parts)]
            states, g_ovf = self._stream_hash_state(
                pipe, chunk_rows, part_cap, n_parts, partials, states,
                key_pos)
            if not g_ovf:
                self.last_hash_parts = n_parts
                return _concat_batches(
                    [self._finalize(agg, st, partials) for st in states],
                    agg.schema)
            max_groups = min(max_groups * 4, 1 << 26)
            logger.warning("hash-state pass overflowed; retrying with "
                           "max_groups=%d", max_groups)
        raise RuntimeError("hash-state group capacities kept overflowing")

    def _stream_hash_state(self, pipe, chunk_rows, part_cap, n_parts,
                           partials, states, key_pos):
        t_start = time.perf_counter()
        step = self._make_step(pipe, chunk_rows, part_cap, partials)
        narrow = self._narrow_flags(pipe)
        schema = pipe.scan.schema
        staged = collections.deque()    # (part, bufs) per in-flight sub-chunk

        def _col_dtype(i):
            ok, _rng = narrow[i]
            return np.int32 if ok else schema.field(i).dtype.numpy_dtype

        rows_in = [0]

        def host_iter():
            # per-partition accumulators: arena buffers filled from the hash
            # split; a full accumulator flushes as one padded sub-chunk
            ncols = len(schema)
            acc = [[self.arena.acquire(chunk_rows, _col_dtype(i))
                    for i in range(ncols)] for _ in range(n_parts)]
            fill = [0] * n_parts

            def flush(p):
                bufs = acc[p]
                n = fill[p]
                views = []
                for b in bufs:
                    v = b[:chunk_rows]
                    if n < chunk_rows:
                        v[n:] = 0
                    views.append(v)
                staged.append((p, bufs))
                acc[p] = [self.arena.acquire(chunk_rows, _col_dtype(i))
                          for i in range(ncols)]
                fill[p] = 0
                return (n,) + tuple(views)

            for batch in _prefetch_iter(self._probe_chunks(pipe, chunk_rows)):
                t_split = time.perf_counter()
                rows_in[0] += batch.num_rows
                # partition id per row from the raw group-key columns
                h = np.zeros(batch.num_rows, dtype=np.uint64)
                inval = None
                for kp in key_pos:
                    c = batch.columns[kp]
                    kv = np.asarray(c.data)
                    if kv.dtype.kind == "f":
                        kv = kv.astype(np.float64).view(np.int64)
                    h = h * np.uint64(0x100000001B3) ^ spill_hash(kv)
                    if c.validity is not None:
                        bad = ~np.asarray(c.validity)
                        inval = bad if inval is None else (inval | bad)
                pid = (h % np.uint64(n_parts)).astype(np.int64)
                if inval is not None:
                    pid[inval] = 0  # all-null key rows share one group
                full = []
                for p in range(n_parts):
                    idx = np.flatnonzero(pid == p)
                    pos = 0
                    while pos < idx.size:
                        take = min(chunk_rows - fill[p], idx.size - pos)
                        sel = idx[pos:pos + take]
                        for i, c in enumerate(batch.columns):
                            a = np.asarray(c.data)
                            acc[p][i][fill[p]:fill[p] + take] = a[sel]
                        fill[p] += take
                        pos += take
                        if fill[p] == chunk_rows:
                            full.append(flush(p))
                self.last_split_seconds += time.perf_counter() - t_split
                yield from full
            for p in range(n_parts):
                if fill[p]:
                    yield flush(p)
                # the accumulator left (a flush acquires a fresh one) goes
                # back to the pool
                for b in acc[p]:
                    self.arena.release(b)

        def step_one(dev_chunk, p):
            states[p], (_, g_o) = step(states[p], *dev_chunk)
            return (g_o,)

        flags, n_chunks, clock = self._drive(host_iter(), staged, step_one)
        logger.info("hash-state streamed %d sub-chunks x %d rows over %d "
                    "partitions (arena: %s)", n_chunks, chunk_rows, n_parts,
                    self.arena.stats())
        self._account(n_chunks, rows_in[0], n_chunks * sum(
            chunk_rows * np.dtype(_col_dtype(i)).itemsize
            for i in range(len(schema))), t_start, clock)
        return states, bool(flags and flags[0])

    def _drive(self, chunks, staged, step_one):
        """Upload the host ``chunks`` through the feeder and run
        ``step_one(dev_chunk, tag)`` on each; producing a chunk appends
        (tag, its arena buffers) to ``staged``.  ``step_one`` returns the
        step's overflow flags as device tensors: they are OR'd and read
        once, after the stream (a read per step would stall the feed
        window).  A chunk's buffers return to the arena once the step that
        read it has finished — on the CPU its tensors alias them, on CUDA
        the copy that read them precedes the step — at most
        ``num_feed_buffers`` steps behind.  Returns (flags OR'd over the
        steps or None without a chunk, chunks streamed, step clock)."""
        clock = _StepClock(self.device)
        feeder = DeviceFeeder(num_buffers=self.config.num_feed_buffers,
                              device=self.device)
        pending = collections.deque()  # (bufs, step-done marker)

        def drain(limit):
            while len(pending) > limit:
                bufs, done = pending.popleft()
                if done is not None:
                    done.synchronize()
                for buf in bufs:
                    self.arena.release(buf)

        flags = []
        for dev_chunk in feeder.feed(chunks):
            tag, bufs = staged.popleft()
            started = clock.start()
            flags.append(torch.stack(step_one(dev_chunk, tag)))
            pending.append((bufs, clock.stop(started)))
            drain(self.config.num_feed_buffers)
        any_flags = (torch.stack(flags).any(0).cpu().tolist() if flags
                     else None)
        drain(0)
        return any_flags, len(flags), clock

    def _account(self, n_chunks, rows, link_bytes, t_start, clock) -> None:
        self.last_stream_chunks += n_chunks
        self.last_stream_rows += rows
        self.last_link_bytes += link_bytes
        self.last_stream_seconds += time.perf_counter() - t_start
        dev_s = clock.seconds()
        if dev_s is not None:
            self.last_step_interval_seconds += dev_s

    def _stream_part(self, pipe, build, chunk_rows, max_groups,
                     join_capacity, partials, state, chunks):
        """Stream one probe source into the group state."""
        t_start = time.perf_counter()
        step = self._make_step(pipe, chunk_rows, max_groups, partials,
                               build, join_capacity)
        narrow = self._narrow_flags(pipe)
        staged = collections.deque()  # (None, bufs) per in-flight chunk
        rows_in = [0]
        link = [0]

        def host_iter():
            for batch in _prefetch_iter(chunks):
                bufs, padded = _stage_batch_arrays(batch, chunk_rows,
                                                   self.arena, narrow)
                rows_in[0] += batch.num_rows
                link[0] += sum(a.nbytes for a in padded[1:])
                staged.append((None, bufs))
                yield padded

        def step_one(dev_chunk, _tag):
            nonlocal state
            state, flags = step(state, *dev_chunk)
            return flags

        flags, n_chunks, clock = self._drive(host_iter(), staged, step_one)
        logger.info("streamed %d chunks of %d rows (arena: %s)",
                    n_chunks, chunk_rows, self.arena.stats())
        self._account(n_chunks, rows_in[0], link[0], t_start, clock)
        return state, tuple(flags) if flags else (False, False)

    # ------------------------------------------------------------------
    def _new_interpreter(self):
        return self._interpreter_cls(self.config, {}, {}, {
            "flag_names": [], "capacities": {}}, self.device)

    def _prepare_build(self, pipe: _StreamablePipeline, host_batch=None):
        """Build side onto the device: filtered/projected, keyed, sorted.
        ``host_batch``: an already-projected batch (a spill partition)."""
        interp = self._new_interpreter()
        build_middle, build_scan = _strip_middle(pipe.build_plan)
        if host_batch is not None:
            host = host_batch.to_numpy()
            indices = range(len(host.columns))
        else:
            host = self.catalog.get_table_data(build_scan.table_name).to_numpy()
            indices = (build_scan.projection
                       if build_scan.projection is not None
                       else range(len(host.columns)))
        n = host.num_rows
        cap = max(n, 1)  # an empty build side holds one invalid row
        cols = []
        for i in indices:
            c = host.columns[i]
            data = np.asarray(c.data)
            validity = c.validity
            if cap > n:
                data = np.zeros(cap, dtype=data.dtype)
                validity = None if validity is None else np.zeros(cap, bool)
            dictionary = c.dictionary
            if dictionary is not None:
                data, dictionary = _sorted_dictionary(data, dictionary)
            v = None if validity is None else _upload(validity, self.device)
            cols.append(DevCol(_upload(data, self.device), v, dictionary))
        row_valid = (torch.zeros(cap, dtype=torch.bool, device=self.device)
                     if cap > n else None)
        batch = DevBatch(build_scan.schema, cols, cap, row_valid)
        for op in build_middle:
            batch = _apply_one(interp, op, batch)
        key_expr = pipe.join.right_keys[0]
        d, v, _ = interp.eval_expr(key_expr, batch)
        code, null = key_code(d, v, _np_kind(key_expr.dtype))
        inv = null if batch.row_valid is None else (null | ~batch.row_valid)
        sk, srow, nbv = join_ops.build_sorted(code, inv)
        # measured key duplication (host-side, before the middle operators:
        # an upper bound) sizes the per-chunk match buffers up front.  Only
        # measurable when the middle does not RESHAPE columns (a projection
        # reorders the layout, and key_expr indexes the post-middle batch)
        avg_dup = 1.0
        idxs = list(indices)
        if any(isinstance(op, P.TpuProjection) for op in build_middle):
            idxs = []
        if isinstance(key_expr, P.ColumnRef) and key_expr.index < len(idxs) \
                and n > 0:
            key_host = np.asarray(host.columns[idxs[key_expr.index]].data)[:n]
            avg_dup = n / max(len(np.unique(key_host)), 1)
        return {"batch": batch, "sk": sk, "srow": srow, "nbv": nbv,
                "avg_dup": avg_dup}

    def _narrow_flags(self, pipe) -> tuple:
        """Per-probe-column (narrow_to_int32, (lo, hi)|None): Parquet
        metadata zone maps let int64 chunks stage and upload as int32 — half
        the bytes over the host-to-device link, and the step's sorts stay in
        int32."""
        stats = self.catalog.get_stats(pipe.scan.table_name) or {}
        lo32 = np.iinfo(np.int32).min + 4
        hi32 = np.iinfo(np.int32).max - 4
        out = []
        for f, nm in zip(pipe.scan.schema, self._probe_cols(pipe)):
            st = stats.get(nm)
            ok = bool(st is not None
                      and f.dtype.numpy_dtype == np.dtype(np.int64)
                      and lo32 < int(st[0]) and int(st[1]) < hi32)
            out.append((ok, tuple(int(x) for x in st) if st else None))
        return tuple(out)

    def _make_step(self, pipe: _StreamablePipeline, chunk_rows: int,
                   max_groups: int, partials, build=None,
                   join_capacity: int = 0):
        """``step(state, valid_rows, *chunk_columns) -> (state, (join
        overflow, group overflow))``: one chunk's partial aggregate merged
        with the group state in one grouped pass.  The build side, when
        there is one, is device-resident and closed over."""
        interp = self._new_interpreter()
        scan_schema = pipe.scan.schema
        table_schema = self.catalog.get_schema(pipe.scan.table_name)
        # dictionaries for string columns are built per chunk, so string
        # group keys / payloads are unsupported while streaming
        for f in (table_schema if pipe.scan.projection is None else
                  (table_schema.field(i) for i in pipe.scan.projection)):
            if f.dtype is DType.STRING:
                raise NotStreamable("string group keys/payloads while streaming")

        agg = pipe.aggregate
        join = pipe.join
        narrow = self._narrow_flags(pipe)
        key_narrow = self._key_narrow(pipe)
        dev = self.device
        chunk_pos = torch.arange(chunk_rows, device=dev)
        state_pos = torch.arange(max_groups, device=dev)
        no_flag = torch.zeros((), dtype=torch.bool, device=dev)
        allow_kernel = interp._seg_agg_on()

        def step(state, valid_rows, *arrays):
            cols = [DevCol(a, None, None, int32_ok=ok, value_range=rng)
                    for a, (ok, rng) in zip(arrays, narrow)]
            batch = DevBatch(scan_schema, cols, chunk_rows,
                             chunk_pos < valid_rows)
            for op in pipe.middle:
                batch = _apply_one(interp, op, batch)
            join_overflow = group_overflow = no_flag

            if join is not None:
                # probe this chunk against the resident sorted build side
                key_expr = join.left_keys[0]
                d, v, _ = interp.eval_expr(key_expr, batch)
                pcode, pnull = key_code(d, v, _np_kind(key_expr.dtype))
                pinv = pnull if batch.row_valid is None else \
                    (pnull | ~batch.row_valid)
                lo, cnt = join_ops.probe_counts(build["sk"], build["nbv"],
                                                pcode, pinv)
                li, ri, out_valid, _total, join_overflow = \
                    join_ops.expand_matches(cnt, lo, build["srow"],
                                            join_capacity)
                jcols = [_gather_col(c, li, out_valid) for c in batch.cols] \
                    + [_gather_col(c, ri, out_valid)
                       for c in build["batch"].cols]
                batch = DevBatch(join.schema, jcols, join_capacity, out_valid)
                if join.residual is not None:
                    data, valid, _ = interp.eval_expr(join.residual, batch)
                    mask = filter_ops.combine_mask(batch.row_valid, data, valid)
                    batch = DevBatch(join.schema, batch.cols, batch.capacity,
                                     mask)
                for op in pipe.agg_middle:
                    batch = _apply_one(interp, op, batch)

            rows = batch.capacity
            row_valid = batch.row_valid if batch.row_valid is not None \
                else torch.ones(rows, dtype=torch.bool, device=dev)
            # chunk keys/values + state keys/values -> one grouped pass
            chunk_keys = []
            for ki, g in enumerate(agg.group_exprs):
                d, v, _ = interp.eval_expr(g, batch)
                if key_narrow is not None and key_narrow[ki]:
                    # the int32 upload dtype IS the key code: the merged
                    # sort stays in int32
                    null = (torch.zeros(d.shape, dtype=torch.bool, device=dev)
                            if v is None else ~v)
                    chunk_keys.append((d, null))
                else:
                    chunk_keys.append(key_code(d, v, _np_kind(g.dtype)))

            state_keys, state_partials, state_valid = state
            keys = [(torch.cat([ck, sk]), torch.cat([cn, sn]))
                    for (ck, cn), (sk, sn) in zip(chunk_keys, state_keys)]
            all_valid = torch.cat([row_valid, state_valid])

            specs = []
            for spec_group, a in zip(partials, agg.aggs):
                if a.arg is not None:
                    data, valid, _ = interp.eval_expr(a.arg, batch)
                else:
                    data, valid = None, None
                for _pname, pfunc, pdtype in spec_group:
                    tdt = torch_dtype(pdtype)
                    if pfunc == "count":
                        cv = (valid.to(tdt) if data is not None
                              and valid is not None
                              else torch.ones(rows, dtype=tdt, device=dev))
                        cvalid = None
                    else:
                        cv = data.to(tdt)
                        cvalid = valid
                    sv = state_partials[len(specs)]
                    merged_valid = None
                    if cvalid is not None:
                        merged_valid = torch.cat([
                            cvalid, torch.ones(sv.shape[0], dtype=torch.bool,
                                               device=dev)])
                    specs.append({
                        "func": "sum" if pfunc == "count" else pfunc,
                        "values": torch.cat([cv, sv]), "valid": merged_valid,
                        "distinct": False, "acc_dtype": pdtype,
                        "np_kind": "f" if tdt.is_floating_point else "i",
                        "int32_ok": tdt == torch.int32,
                    })

            group_codes, results, n_groups, g_overflow = \
                agg_ops.groupby_aggregate(keys, all_valid, specs, max_groups,
                                          n_rows=rows + max_groups,
                                          allow_kernel=allow_kernel,
                                          device=dev)
            new_partials = [r[0] for r in results]
            if keys:
                group_overflow = g_overflow
                new_state = (group_codes, new_partials, state_pos < n_groups)
            else:
                # the one-row global state is valid once it has absorbed a
                # row: until then its lanes hold no value (a MIN over no
                # rows comes back as 0) and must stay out of the merge
                new_state = ([], new_partials,
                             state_valid | row_valid.any().reshape(1))
            return new_state, (join_overflow, group_overflow)

        return step

    # ------------------------------------------------------------------
    def _finalize(self, agg: P.TpuAggregate, state, partials,
                  dicts=None) -> ColumnBatch:
        """Group state -> host batch.  The valid groups form a prefix of the
        state, so each lane is sliced on the device and only ``n_groups``
        rows of it cross to the host.  ``dicts``: per group key, then per
        aggregate, the dictionary of a string value (``_string_sources``)."""
        if dicts is None:
            dicts = [None] * (len(agg.group_exprs) + len(agg.aggs))
        state_keys, state_partials, state_valid = state
        valid = state_valid.cpu().numpy()
        empty = not agg.group_exprs and not valid.any()
        if empty:
            # no row reached the state: a global aggregate still yields one
            # row, COUNT 0 and every other aggregate NULL
            valid = np.ones_like(valid)
        idx = np.nonzero(valid)[0]
        if idx.size and idx[-1] == idx.size - 1:
            n = int(idx.size)
            state_keys = [(c[:n], u[:n]) for c, u in state_keys]
            state_partials = [p[:n] for p in state_partials]
            idx = np.arange(n)

        cols: List[Column] = []
        for (code, null), g, dictionary in zip(state_keys, agg.group_exprs,
                                               dicts):
            data = code.cpu().numpy()[idx]
            null_h = null.cpu().numpy()[idx]
            if g.dtype is DType.BOOL:
                data = data.astype(bool)
            if data.dtype == np.int32 and \
                    g.dtype.numpy_dtype == np.dtype(np.int64):
                data = data.astype(np.int64)  # narrowed key lane widens here
            cols.append(Column(data, ~null_h if null_h.any() else None,
                               dictionary))

        p_i = 0
        for spec_group, a, dictionary in zip(partials, agg.aggs,
                                             dicts[len(agg.group_exprs):]):
            vals = {}
            for pname, _pfunc, _pdtype in spec_group:
                vals[pname] = state_partials[p_i].cpu().numpy()[idx]
                p_i += 1
            col = _finalize_agg(a, vals, dictionary)
            if empty and a.func != "count":
                col = Column(np.zeros_like(col.data), np.zeros(1, bool),
                             dictionary)
            cols.append(col)
        return ColumnBatch(agg.schema, cols, len(idx))


def _concat_batches(batches: List[ColumnBatch], schema) -> ColumnBatch:
    """Concatenate finalized per-partition group results (disjoint keys)."""
    if len(batches) == 1:
        return batches[0]
    cols = []
    for i in range(len(schema)):
        data = np.concatenate([np.asarray(b.columns[i].data) for b in batches])
        if any(b.columns[i].validity is not None for b in batches):
            validity = np.concatenate([
                np.asarray(b.columns[i].validity)
                if b.columns[i].validity is not None
                else np.ones(b.num_rows, dtype=bool)
                for b in batches])
        else:
            validity = None
        cols.append(Column(data, validity))
    return ColumnBatch(schema, cols, sum(b.num_rows for b in batches))


def _apply_one(interp, op, batch):
    """Apply one Filter/Projection physical operator to a DevBatch."""
    if isinstance(op, P.TpuFilter):
        data, valid, _ = interp.eval_expr(op.predicate, batch)
        mask = filter_ops.combine_mask(batch.row_valid, data, valid)
        return DevBatch(op.schema, batch.cols, batch.capacity, mask)
    ncols = []
    for e in op.exprs:
        d, v, dd = interp.eval_expr(e, batch)
        ncols.append(DevCol(d, v, dd))
    return DevBatch(op.schema, ncols, batch.capacity, batch.row_valid)


def _dup_capacity(chunk_rows: int, avg_dup: float) -> int:
    """Per-chunk join match-buffer size from measured build-side key
    duplication, with 2x headroom over the average (duplication varies by
    chunk), rounded up to a power of two."""
    est = int(chunk_rows * max(2.0 * avg_dup, 1.25)) + 1024
    return 1 << (est - 1).bit_length()


def _string_sources(pipe: _StreamablePipeline) -> List[Optional[int]]:
    """Per group key, then per aggregate: the column of the resident build
    batch whose dictionary a string value carries, or None for a value
    that is not a string.  The step merges string codes, so a string value
    streams only when one dictionary holds for the whole stream: that of a
    column of the build side, which is uploaded once.  Any other string
    value (a column of the streamed scan, a CASE over string literals, a
    string on the grace join's spilled build side) raises ``NotStreamable``
    before the first chunk."""
    agg = pipe.aggregate
    exprs = list(agg.group_exprs) + [
        a.arg if a.out_dtype is DType.STRING else None for a in agg.aggs]
    # join columns past the probe side's come from the build batch
    n_probe = (len(pipe.join.left.schema)
               if pipe.join is not None and not pipe.partitioned else None)
    out: List[Optional[int]] = []
    for e in exprs:
        if e is None or e.dtype is not DType.STRING:
            out.append(None)
            continue
        for op in reversed(pipe.agg_middle):
            if isinstance(op, P.TpuProjection) and isinstance(e, P.ColumnRef):
                e = op.exprs[e.index]
        if n_probe is None or not isinstance(e, P.ColumnRef) \
                or e.index < n_probe:
            raise NotStreamable("a string value that is not a column of the "
                                "cached build side")
        out.append(e.index - n_probe)
    return out


def _sorted_dictionary(codes: np.ndarray, dictionary):
    """(codes, dictionary) re-coded onto the sorted dictionary, so that the
    order of codes is the order of strings and a MIN/MAX over codes is the
    MIN/MAX over strings.  A sorted dictionary comes back as it is."""
    words = np.asarray(dictionary, dtype=object).astype(str)
    if words.size < 2 or bool((words[:-1] < words[1:]).all()):
        return codes, dictionary
    order = np.argsort(words, kind="stable")
    rank = np.empty(words.size, dtype=np.int64)
    rank[order] = np.arange(words.size)
    return rank[codes], np.asarray(dictionary, dtype=object)[order]


def _partial_layout(agg: P.TpuAggregate, ranges=None, total_rows=None):
    """Per output aggregate, the mergeable partial columns it needs.

    ``ranges``: optional per-scan-column (lo, hi) zone-map bounds (narrow
    flags) and ``total_rows`` the table row count — when provided, partial
    dtypes narrow where that is provably exact:
      * COUNT partials are float64 always (exact to 2^53 rows);
      * int SUM partials go float64 when total_rows * max|v| < 2^52;
      * int MIN/MAX partials go int32 when the argument's bound fits."""
    def arg_range(a):
        if ranges is None or not isinstance(a.arg, P.ColumnRef):
            return None
        return ranges.get(a.arg.index)

    i32max = (1 << 31) - 8
    out = []
    for a in agg.aggs:
        cnt_dt = np.float64 if ranges is not None else np.int64
        if a.func == "count":
            out.append([("count", "count", cnt_dt)])
        elif a.func == "avg":
            out.append([("sum", "sum", np.float64), ("count", "count", cnt_dt)])
        elif a.func == "sum":
            sum_dt = a.out_dtype.numpy_dtype
            r = arg_range(a)
            if (np.dtype(sum_dt) == np.dtype(np.int64) and r is not None
                    and total_rows is not None
                    and total_rows * max(abs(int(r[0])),
                                         abs(int(r[1]))) < (1 << 52)):
                sum_dt = np.float64
            lanes = [("sum", "sum", sum_dt)]
            if not _nullfree_arg(a, ranges):
                lanes.append(("count", "count", cnt_dt))
            out.append(lanes)
        elif a.func in ("min", "max"):
            mm_dt = a.out_dtype.numpy_dtype
            r = arg_range(a)
            if (np.dtype(mm_dt) == np.dtype(np.int64) and r is not None
                    and -i32max < int(r[0]) and int(r[1]) < i32max):
                mm_dt = np.int32
            lanes = [(a.func, a.func, mm_dt)]
            if not _nullfree_arg(a, ranges):
                lanes.append(("count", "count", cnt_dt))
            out.append(lanes)
        else:
            raise NotStreamable(a.func)
    return out


def _nullfree_arg(a, ranges) -> bool:
    """SUM/MIN/MAX over a PLAIN scan column in a streamed scan-only pipeline
    (``ranges is not None``) needs no count lane: staged chunk columns carry
    no validity, so every group has >= 1 value."""
    return ranges is not None and isinstance(a.arg, P.ColumnRef)


def _finalize_agg(a: P.AggSpec, vals, dictionary=None) -> Column:
    """Partials may be carried in narrowed dtypes (f64 counts/sums proven
    exact, int32 min/max) — cast back to the logical output dtype here.
    A string MIN/MAX is a code of ``dictionary``; a group without a value
    gets code 0 under its null."""
    out_np = a.out_dtype.numpy_dtype
    if a.func == "count":
        return Column(vals["count"].astype(np.int64))
    cnt = vals.get("count")
    if cnt is None:
        # null-free plain-column argument: every group has a value
        data = vals["sum" if a.func == "sum" else a.func]
        if data.dtype != out_np:
            data = data.astype(out_np)
        return Column(data, None, dictionary)
    has = cnt > 0
    if a.func == "avg":
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = vals["sum"] / np.maximum(cnt, 1)
        return Column(np.where(has, avg, 0.0), None if has.all() else has)
    key = "sum" if a.func == "sum" else a.func
    data = vals[key]
    if data.dtype != out_np:
        data = data.astype(out_np)
    if dictionary is not None:
        data = np.where(has, data, 0)
    return Column(data, None if has.all() else has, dictionary)


def _init_state(group_exprs, partials, max_groups: int, device,
                key_narrow=None):
    """Empty group state on ``device``: (key lanes, partial lanes, valid).
    ``key_narrow``: per-group-expr flag — int32 key-code lanes for
    zone-map-narrowed integer keys."""
    def full(n, fill, dtype):
        return torch.full((n,), fill, dtype=dtype, device=device)

    keys = []
    if group_exprs:
        for i, g in enumerate(group_exprs):
            if g.dtype is DType.FLOAT64:
                code = full(max_groups, float("-inf"), torch.float64)
            elif key_narrow is not None and key_narrow[i]:
                code = full(max_groups, int(np.iinfo(np.int32).min),
                            torch.int32)
            else:
                code = full(max_groups, INT64_MIN, torch.int64)
            keys.append((code, full(max_groups, False, torch.bool)))
        rows = max_groups
    else:
        rows = 1  # global aggregate: single-row mergeable state
    state_partials = []
    for spec_group in partials:
        for _pname, pfunc, pdtype in spec_group:
            if pfunc == "min":
                fill = (np.inf if np.dtype(pdtype).kind == "f"
                        else np.iinfo(np.dtype(pdtype)).max)
            elif pfunc == "max":
                fill = (-np.inf if np.dtype(pdtype).kind == "f"
                        else np.iinfo(np.dtype(pdtype)).min)
            else:
                fill = 0
            state_partials.append(full(rows, fill, torch_dtype(pdtype)))
    return (keys, state_partials, full(rows, False, torch.bool))


def _stage_batch_arrays(batch: ColumnBatch, chunk_rows: int,
                        arena: BufferArena, narrow=None):
    """Host batch -> (arena_buffers, (valid_rows, *staged arrays)).

    Each column is copied into a pooled arena buffer padded to
    ``chunk_rows``; the caller releases the buffers once the step that read
    them has finished.  ``narrow``: per-column (to_int32, range) from
    Parquet-metadata zone maps — int64 columns stage as int32, halving the
    bytes over the host-to-device link."""
    n = batch.num_rows
    out = [n]
    bufs = []
    for i, c in enumerate(batch.columns):
        a = np.asarray(c.data)
        if narrow is not None and narrow[i][0] and a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.shape[0] > chunk_rows:
            raise ValueError("chunk larger than batch_size")
        buf = arena.acquire(chunk_rows, a.dtype)
        view = buf[:chunk_rows]
        view[:n] = a
        if n < chunk_rows:
            view[n:] = 0
        bufs.append(buf)
        out.append(view)
    return bufs, tuple(out)
