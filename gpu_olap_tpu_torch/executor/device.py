"""Device executor on PyTorch.

Port of ``gpu_olap_tpu/executor/device.py`` for the single-device path:
scan, filter, project, join, aggregate (global and GROUP BY), sort, limit
and distinct.  The physical plan is interpreted eagerly, once per query, on
tensors of one explicit device; there is no trace or compile cache.

What the JAX executor does and this one keeps:

* filters carry row-validity masks instead of compacting; the host boundary
  compacts once;
* joins emit into fixed-capacity match buffers, and aggregation outputs are
  padded to ``max_groups`` with a group count; a match total or group count
  above its capacity grows that capacity by 4x and reruns the plan (the
  overflow -> regrow loop);
* zone-map statistics (``int32_ok``, value ranges, unique key columns) and
  the int32 shadow columns decide where the int32 kernels, the int32-folded
  merge probe and the lookup join may run; a proven-unique bounded key
  column keeps a dense key->row index on the device;
* the join routes of the JAX engine: lookup join, sorted-space streaming
  join (the ``stream_compact`` and ``expand_fill`` kernels), general sort
  join with outer extension, and the group-join rewrites;
* string expressions are lowered against the host-side sorted dictionaries.

UNION ALL concatenates its children on the device, as JAX does.

What it drops, because it served XLA's static shapes or the TPU: the
shape-bucket padding of tables (tables keep their row count), the int32
narrowing of results for the host link, and int32 arithmetic on
interval-proven expressions.  Cross joins raise :class:`DeviceUnsupported`,
and the engine answers them on the CPU oracle.

A plan that scans an uncached (out-of-core) table streams through
:mod:`.streaming` (``last_backend`` ``torch-streaming``, or
``torch-streaming-partitioned`` for the grace join); a plan the streamer
cannot take (``NotStreamable``) loads the table whole onto the device, as
the JAX executor does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..interop.columnar import Column, ColumnBatch, DType, Schema
from ..plan import physical as P
from ..utils.metrics import GLOBAL_METRICS, Timer
from ..utils import tracing
from ..utils.tracing import get_logger
from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops.dtypes import key_code, order_code, torch_dtype

logger = get_logger(__name__)

_LO32 = int(np.iinfo(np.int32).min) + 4
_HI32 = int(np.iinfo(np.int32).max) - 4
# join match buffers index their slots with int32
_MAX_JOIN_SLOTS = (1 << 31) - 2


class DeviceUnsupported(NotImplementedError):
    """Raised for plans the torch device path does not cover; the engine
    falls back to the CPU oracle."""


@dataclasses.dataclass
class DevCol:
    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dictionary: Optional[np.ndarray] = None  # host-side
    # zone-map statistics say every value fits int32 (with sentinel headroom)
    int32_ok: bool = False
    # (min, max) zone-map range when known
    value_range: Optional[Tuple[int, int]] = None
    # column proven duplicate-free (a join statistic)
    unique: bool = False
    # provenance (table name, table column index) for unfiltered scan columns
    source: Optional[Tuple[str, int]] = None
    # device-resident int32 copy, built once at table upload for int32_ok
    # columns: the int32 kernels read it directly
    narrow: Optional[torch.Tensor] = None

    def as_int32(self):
        """int32 view of the column: the upload-time shadow when present,
        else a narrowing copy."""
        if self.narrow is not None:
            return self.narrow
        return self.data.to(torch.int32)


@dataclasses.dataclass
class DevBatch:
    schema: Schema
    cols: List[DevCol]
    capacity: int
    row_valid: Optional[torch.Tensor]  # None = all rows valid
    # row_valid is exactly ``arange(capacity) < prefix_count`` with a device
    # scalar (aggregate/distinct group counts, sorted outputs): the host
    # boundary slices instead of compacting
    prefix_count: Optional[torch.Tensor] = None

    def count(self, device) -> torch.Tensor:
        """Number of valid rows, an int64 0-d tensor on ``device``."""
        if self.row_valid is None:
            return torch.tensor(self.capacity, dtype=torch.int64,
                                device=device)
        if self.prefix_count is not None:
            return self.prefix_count.to(torch.int64)
        return self.row_valid.sum(dtype=torch.int64)


def _np_kind(dtype: DType) -> str:
    return {"int64": "i", "float64": "f", "bool": "b", "string": "i",
            "timestamp_ms": "i", "date32": "i"}[dtype.value]


def _dicts_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is b:
        return True
    if a is None or b is None:
        return False
    return len(a) == len(b) and bool(np.array_equal(a, b))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    return torch.from_numpy(a).to(device, copy=True)


def _table_stats(catalog, config: EngineConfig, name: str, host: ColumnBatch):
    """Per-column (int32_ok, range, unique) statistics, as the JAX executor
    derives them (``_device_tables``)."""
    stats = catalog.get_stats(name) or {}
    int32_ok, ranges, uniques = [], [], []
    for f, col in zip(host.schema, host.columns):
        if col.dictionary is not None:
            int32_ok.append(len(col.dictionary) < _HI32)
            ranges.append((0, len(col.dictionary) - 1))
            uniques.append(False)
            continue
        st = stats.get(f.name)
        int32_ok.append(st is not None and _LO32 < st[0] and st[1] < _HI32)
        ranges.append(st)
        # uniqueness is worth computing only for plausible key columns:
        # bounded span no smaller than the row count
        uniq = False
        if st is not None:
            span = int(st[1]) - int(st[0]) + 1
            if host.num_rows <= span <= config.direct_join_max_range:
                uniq = catalog.ensure_unique_stat(name, f.name)
        uniques.append(uniq)
    return int32_ok, ranges, uniques


def tables_from_numpy(entry: dict, device) -> dict:
    """The port's table-cache entry from one entry of the JAX executor's
    table cache (``DeviceExecutor._device_tables``) whose arrays were turned
    into numpy.  JAX pads tables to a shape bucket; the port keeps the row
    count (at least one row), so the padding is cut off."""
    cap = max(int(entry["num_rows"]), 1)
    arrays = [(_upload(np.asarray(d)[:cap], device),
               None if v is None else _upload(np.asarray(v)[:cap], device))
              for d, v in entry["arrays"]]
    narrow = {i: _upload(np.asarray(a)[:cap], device)
              for i, a in entry["narrow"].items()}
    dense_idx = {i: _upload(np.asarray(a), device)
                 for i, a in entry["dense_idx"].items()}
    return {
        "arrays": arrays,
        "dicts": list(entry["dicts"]),
        "schema": entry["schema"],
        "num_rows": int(entry["num_rows"]),
        "capacity": cap,
        "int32_ok": list(entry["int32_ok"]),
        "ranges": list(entry["ranges"]),
        "uniques": list(entry["uniques"]),
        "narrow": narrow,
        "dense_idx": dense_idx,
    }


def _dense_index(host: ColumnBatch, stats: dict, uniques) -> dict:
    """Persistent join indexes: for each proven-unique bounded key column,
    the dense key->row table (-1 = no row), built host-side once per table
    version.  Lookup joins on an unfiltered build side read it instead of
    building the table per query."""
    dense_idx = {}
    for i, (f, col) in enumerate(zip(host.schema, host.columns)):
        if not uniques[i]:
            continue
        kmin, kmax = int(stats[f.name][0]), int(stats[f.name][1])
        dense = np.full(kmax - kmin + 1, -1, dtype=np.int32)
        keys = np.asarray(col.data).astype(np.int64)
        dense[keys - kmin] = np.arange(host.num_rows, dtype=np.int32)
        dense_idx[i] = dense
    return dense_idx


class DeviceExecutor:
    def __init__(self, catalog, config: EngineConfig, device: torch.device):
        self.catalog = catalog
        self.config = config
        self.device = device
        # device-resident table cache: name -> (catalog version, entry)
        self._table_cache: Dict[str, tuple] = {}
        # per-plan-node capacity overrides after overflow (node path -> rows)
        self._cap_override: Dict[tuple, int] = {}
        # out-of-core streamer, kept across queries so that its staging
        # arena pools chunk buffers
        self._streaming = None
        self.last_backend = f"torch-{device.type}"

    # ------------------------------------------------------------------
    # public entry
    # ------------------------------------------------------------------
    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        # the route this call took, for QueryResult.metrics["backend"]
        self.last_backend = f"torch-{self.device.type}"
        if self._has_uncached_scan(plan):
            # out-of-core: stream chunks through a partial-aggregate pipeline
            from .streaming import NotStreamable, StreamingAggregator

            try:
                if self._streaming is None:
                    self._streaming = StreamingAggregator(
                        self.catalog, self.config, _Interpreter, self.device)
                batch = self._streaming.execute(plan)
                self.last_backend = ("torch-streaming-partitioned"
                                     if self._streaming.last_partitioned
                                     else "torch-streaming")
                return batch
            except NotStreamable as e:
                logger.warning(
                    "plan not streamable (%s); loading the table whole onto "
                    "the device", e)
        tables = self._device_tables(plan)
        rows_in = sum(t["num_rows"] for t in tables.values())
        bytes_in = sum(
            t["capacity"] * sum(a[0].element_size() for a in t["arrays"])
            for t in tables.values()
        )
        for attempt in range(8):
            meta = {"flag_names": [], "capacities": {}, "out_dicts": None,
                    "out_schema": None}
            interp = _Interpreter(self.config, tables, self._cap_override,
                                  meta, self.device)
            with tracing.span(logger, "device_execute", attempt=attempt,
                              rows_in=rows_in), Timer() as t_exec:
                out = interp.run(plan)
                flags = {k: bool(v) for k, v in
                         zip(meta["flag_names"], out["flags"])}
                overflowed = [k for k, v in flags.items() if v]
                out["count"] = int(out["count"])  # waits for the device
                tracing.annotate(rows_out=out["count"],
                                 overflowed=len(overflowed))
            if not overflowed:
                batch = self._to_host(out, meta)
                GLOBAL_METRICS.record_span(
                    "device_execute", t_exec.seconds, rows_in=rows_in,
                    rows_out=batch.num_rows, bytes_accessed=bytes_in,
                    device=self.device)
                return batch
            # grow capacities and rerun (bounded geometric growth)
            for key in overflowed:
                cur = meta["capacities"][key]
                grown = int(cur * 4)
                if key[0] == "join":
                    if cur >= _MAX_JOIN_SLOTS:
                        raise RuntimeError(
                            f"join at {key} needs more than {_MAX_JOIN_SLOTS} "
                            "match slots (int32 slot indices)")
                    grown = min(grown, _MAX_JOIN_SLOTS)
                self._cap_override[key] = grown
                logger.warning("device capacity overflow at %s: growing %d -> %d",
                               key, cur, grown)
            GLOBAL_METRICS.bump("regrows")
        raise RuntimeError(
            "join/aggregate capacity kept overflowing after 8 growths")

    def _streaming_arena_stats(self) -> dict:
        """Staging-arena pool state of the out-of-core streamer (empty when
        no query has streamed)."""
        if self._streaming is None:
            return {"allocated_bytes": 0, "classes": {}}
        return self._streaming.arena.stats()

    def _has_uncached_scan(self, plan: P.PhysicalPlan) -> bool:
        if isinstance(plan, P.TpuTableScan) and \
                not self.catalog.is_cached(plan.table_name):
            return True
        return any(self._has_uncached_scan(k) for k in plan.inputs())

    # ------------------------------------------------------------------
    # tables -> device
    # ------------------------------------------------------------------
    def _device_tables(self, plan: P.PhysicalPlan):
        names = set()

        def walk(p):
            if isinstance(p, P.TpuTableScan):
                names.add(p.table_name)
            for k in p.inputs():
                walk(k)

        walk(plan)
        out = {}
        for name in sorted(names):
            # residency is keyed on the catalog's table version: a query
            # over an unchanged table uploads nothing
            ver = self.catalog.get_version(name)
            cached = self._table_cache.get(name)
            if cached is not None and cached[0] == ver:
                out[name] = cached[1]
                continue
            self._table_cache.pop(name, None)  # free the stale copy first
            with tracing.span(logger, "upload", GLOBAL_METRICS, table=name):
                out[name] = self._upload_table(name, ver)
        return out

    def _upload_table(self, name: str, ver) -> dict:
        """The table's device entry, from its host columns; cached."""
        host = self.catalog.get_table_data(name).to_numpy()
        cap = max(host.num_rows, 1)
        arrays = []
        dicts = []
        for col in host.columns:
            data = np.zeros(cap, dtype=col.data.dtype)
            data[: host.num_rows] = col.data
            valid = None
            if col.validity is not None:
                v = np.zeros(cap, dtype=bool)
                v[: host.num_rows] = col.validity
                valid = _upload(v, self.device)
            arrays.append((_upload(data, self.device), valid))
            dicts.append(col.dictionary)
        int32_ok, ranges, uniques = _table_stats(
            self.catalog, self.config, name, host)
        # int32 shadow copies of zone-map-proven-narrow int64 columns:
        # the int32 kernels read 4 B/row from them
        narrow = {i: data.to(torch.int32)
                  for i, (data, _v) in enumerate(arrays)
                  if int32_ok[i] and data.dtype == torch.int64}
        dense_idx = {i: _upload(d, self.device) for i, d in _dense_index(
            host, self.catalog.get_stats(name) or {}, uniques).items()}
        entry = {
            "arrays": arrays,
            "dicts": dicts,
            "schema": host.schema,
            "num_rows": host.num_rows,
            "capacity": cap,
            "int32_ok": int32_ok,
            "ranges": ranges,
            "uniques": uniques,
            "narrow": narrow,
            "dense_idx": dense_idx,
        }
        self._table_cache[name] = (ver, entry)
        tensors = [t for pair in arrays for t in pair if t is not None] \
            + list(narrow.values()) + list(dense_idx.values())
        tracing.annotate(rows=host.num_rows, bytes=sum(
            t.numel() * t.element_size() for t in tensors))
        return entry

    # ------------------------------------------------------------------
    def _to_host(self, out, meta) -> ColumnBatch:
        schema: Schema = meta["out_schema"]
        n = int(out["count"])
        nbytes = sum(n * (d.element_size() + (v is not None))
                     for d, v in out["cols"])
        with tracing.span(logger, "to_host", rows=n, bytes=nbytes):
            cols = []
            for (data, validity), dictionary, field in zip(
                    out["cols"], meta["out_dicts"], schema):
                d = data[:n].cpu().numpy()
                v = None if validity is None else validity[:n].cpu().numpy()
                if field.dtype is DType.BOOL and d.dtype != np.bool_:
                    d = d.astype(np.bool_)
                elif d.dtype == np.int32 \
                        and field.dtype.numpy_dtype == np.int64:
                    # int32 key/min/max lanes widen here
                    d = d.astype(np.int64)
                if v is not None and v.all():
                    # all-valid masks drop like the oracle's
                    # (_maybe_validity): downstream formatters floatify int
                    # columns that carry ANY validity mask, drifting dtypes
                    # vs the CPU backend
                    v = None
                cols.append(Column(d, v, dictionary))
        return ColumnBatch(schema, cols, n)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

#: the span each plan node runs under (``_Interpreter.exec``)
_OPERATOR_SPANS = {
    P.TpuTableScan: "scan", P.TpuFilter: "filter", P.TpuProjection: "project",
    P.TpuHashJoin: "join", P.TpuAggregate: "aggregate", P.TpuSort: "sort",
    P.TpuLimit: "limit", P.TpuDistinct: "distinct", P.TpuUnion: "union",
}


class _Interpreter:
    def __init__(self, config: EngineConfig, tables, cap_override, meta,
                 device: torch.device):
        self.config = config
        self.tables = tables
        self.cap_override = cap_override
        self.meta = meta
        self.device = device
        self.flags: List = []

    def run(self, plan: P.PhysicalPlan) -> dict:
        """Execute ``plan``; returns the result columns compacted to a valid
        prefix, its row count and the overflow flags (``meta`` is filled)."""
        batch = self.exec(plan, path=())
        self.meta["out_schema"] = batch.schema
        self.meta["out_dicts"] = [c.dictionary for c in batch.cols]
        rv = batch.row_valid
        if rv is None:
            # a device scalar even here: reading it waits for the device
            count = batch.count(self.device)
            cols_out = [(c.data, c.validity) for c in batch.cols]
        elif batch.prefix_count is not None:
            # valid rows already form a prefix: the host slice is the compaction
            count = batch.count(self.device)
            cols_out = [(c.data, c.validity) for c in batch.cols]
        else:
            gather_idx, count = filter_ops.compaction_indices(rv)
            cols_out = []
            for c in batch.cols:
                d = c.data[gather_idx]
                v = None if c.validity is None else c.validity[gather_idx]
                cols_out.append((d, v))
        return {"cols": cols_out, "count": count, "flags": tuple(self.flags)}

    def _seg_agg_on(self) -> bool:
        """The seg_agg kernel gate: ``config.use_pallas`` gates both kernels,
        ``config.use_pallas_seg_agg`` (None = on) this one."""
        flag = self.config.use_pallas_seg_agg
        if not self.config.use_pallas:
            return False
        return True if flag is None else bool(flag)

    # -- operators -----------------------------------------------------
    def exec(self, plan: P.PhysicalPlan, path: tuple) -> DevBatch:
        """``plan``'s node, under a span named by its operator."""
        with tracing.span(logger, _OPERATOR_SPANS.get(type(plan), "operator")):
            return self._exec(plan, path)

    def _exec(self, plan: P.PhysicalPlan, path: tuple) -> DevBatch:
        if isinstance(plan, P.TpuTableScan):
            return self._scan(plan)
        if isinstance(plan, P.TpuFilter):
            return self._filter(plan, path)
        if isinstance(plan, P.TpuProjection):
            return self._project(plan, path)
        if isinstance(plan, P.TpuHashJoin):
            return self._join(plan, path)
        if isinstance(plan, P.TpuAggregate):
            return self._aggregate(plan, path)
        if isinstance(plan, P.TpuSort):
            return self._sort(plan, path)
        if isinstance(plan, P.TpuLimit):
            return self._limit(plan, path)
        if isinstance(plan, P.TpuDistinct):
            return self._distinct(plan, path)
        if isinstance(plan, P.TpuUnion):
            return self._union(plan, path)
        raise DeviceUnsupported(type(plan).__name__)

    def _union(self, plan: P.TpuUnion, path) -> DevBatch:
        """UNION ALL: the children's columns concatenated; the row masks
        carry each child's invalid rows (no compaction).  String columns are
        re-coded onto the sorted union of their dictionaries; numeric
        columns promote to a common type, floats to float64."""
        batches = [self.exec(c, path + (i,))
                   for i, c in enumerate(plan.children)]
        cols: List[DevCol] = []
        for i, f in enumerate(plan.schema):
            parts = [b.cols[i] for b in batches]
            if f.dtype is DType.STRING:
                datas, dictionary = _onto_union(
                    [(c.data, c.dictionary) for c in parts], self.device)
                data = torch.cat(datas)
            else:
                common = parts[0].data.dtype
                for c in parts[1:]:
                    common = torch.promote_types(common, c.data.dtype)
                if np.dtype(f.dtype.numpy_dtype).kind == "f":
                    common = torch.promote_types(common, torch.float64)
                data = torch.cat([c.data.to(common) for c in parts])
                dictionary = None
            if all(c.validity is None for c in parts):
                valid = None
            else:
                valid = torch.cat([
                    self._ones(b.capacity) if c.validity is None
                    else c.validity for c, b in zip(parts, batches)])
            ranges = [c.value_range for c in parts]
            vrange = None
            if all(r is not None for r in ranges):
                vrange = (min(r[0] for r in ranges), max(r[1] for r in ranges))
            cols.append(DevCol(data, valid, dictionary,
                               all(c.int32_ok for c in parts), vrange))
        if all(b.row_valid is None for b in batches):
            row_valid = None
        else:
            row_valid = torch.cat([
                self._ones(b.capacity) if b.row_valid is None else b.row_valid
                for b in batches])
        return DevBatch(plan.schema, cols, sum(b.capacity for b in batches),
                        row_valid)

    def _scan(self, plan: P.TpuTableScan) -> DevBatch:
        t = self.tables[plan.table_name]
        arrays = t["arrays"]
        indices = (plan.projection if plan.projection is not None
                   else range(len(arrays)))
        cols = []
        for i in indices:
            data, validity = arrays[i]
            cols.append(DevCol(data, validity, t["dicts"][i],
                               bool(t["int32_ok"][i]), t["ranges"][i],
                               bool(t["uniques"][i]), (plan.table_name, i),
                               t["narrow"].get(i)))
        cap = t["capacity"]
        # an empty table holds one invalid row (capacity is at least 1)
        row_valid = (torch.zeros(cap, dtype=torch.bool, device=self.device)
                     if t["num_rows"] < cap else None)
        return DevBatch(plan.schema, cols, cap, row_valid)

    def _filter(self, plan: P.TpuFilter, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        data, valid, _ = self.eval_expr(plan.predicate, batch)
        mask = filter_ops.combine_mask(batch.row_valid, data, valid)
        return DevBatch(plan.schema, batch.cols, batch.capacity, mask)

    def _project(self, plan: P.TpuProjection, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        cols = []
        for e in plan.exprs:
            data, valid, dictionary = self.eval_expr(e, batch)
            src = batch.cols[e.index] if isinstance(e, P.ColumnRef) else None
            cols.append(DevCol(data, valid, dictionary,
                               src.int32_ok if src else False,
                               src.value_range if src else None,
                               src.unique if src else False,
                               src.source if src else None,
                               src.narrow if src and data is src.data else None))
        return DevBatch(plan.schema, cols, batch.capacity, batch.row_valid,
                        prefix_count=batch.prefix_count)

    # -- joins -----------------------------------------------------------
    def _join(self, plan: P.TpuHashJoin, path) -> DevBatch:
        left = self.exec(plan.left, path + (0,))
        right = self.exec(plan.right, path + (1,))
        nl, nr = left.capacity, right.capacity

        if plan.join_type == "cross":
            raise DeviceUnsupported("cross join on device")

        lkeys = [self._key_of(k, left) for k in plan.left_keys]
        rkeys = [self._key_of(k, right) for k in plan.right_keys]
        fold_range = self._fold_range(plan, lkeys, rkeys)
        # expansion-free lookup join: unique, range-bounded build key, the
        # right side's, else the left side's (a dimension named first).  An
        # explicit "sort_merge" strategy forces the sorted probe; the
        # auto-selected pre-sorted strategy keeps the lookup join
        if plan.strategy != "sort_merge" or plan.build_sorted_asc:
            lookup = self._try_lookup_join(plan, left, right, lkeys, rkeys)
            if lookup is not None:
                tracing.annotate(route="lookup")
                return lookup
            lookup = self._try_lookup_join(plan, left, right, lkeys, rkeys,
                                           build="left")
            if lookup is not None:
                GLOBAL_METRICS.bump("torch_join_lookup_left")
                tracing.annotate(route="lookup", build="left")
                return lookup

        lkeys, rkeys = self._unified_key_tuples(plan, left, right, lkeys, rkeys)

        cap_key = ("join", path)
        # the first guess covers FK-style joins (matches ~ probe rows); growth
        # is 4x to converge fast on expansive joins
        capacity = self.cap_override.get(
            cap_key, int((nl + nr) * self.config.join_expansion))
        if capacity > _MAX_JOIN_SLOTS:
            raise RuntimeError(f"join at {cap_key} asks for {capacity} match "
                               f"slots; at most {_MAX_JOIN_SLOTS} fit int32 "
                               "slot indices")
        self.meta["capacities"][cap_key] = capacity

        stream_cols = None
        li = None
        cnt = None
        if (plan.join_type == "inner" and self.config.use_pallas
                and len(lkeys) == 1 and fold_range is not None):
            lc, li_inv, rc, ri_inv = join_ops._prepare_codes(
                lkeys, left.row_valid, rkeys, right.row_valid, True)
            span_ok = (lc.dtype == torch.int32 and rc.dtype == torch.int32
                       and 2 * (int(fold_range[1]) - int(fold_range[0])) + 2
                       < np.iinfo(np.int32).max - 2)
            if span_ok and nl + nr >= (1 << 15):
                stream_cols, li, ri, out_valid, total, overflow = \
                    self._stream_join(plan, left, right, lc, li_inv, rc,
                                      ri_inv, capacity, fold_range)
        tracing.annotate(route="sort_merge" if li is None else "stream")
        if li is None:
            li, ri, out_valid, total, overflow, cnt = join_ops.inner_join(
                lkeys, left.row_valid, rkeys, right.row_valid, capacity,
                fold_range=fold_range,
                # stats-proven sorted build key on a direct scan: the build
                # sort is a sentinel mask
                build_presorted=plan.build_sorted_asc,
            )
        self._push_flag(cap_key, overflow)

        if plan.join_type in ("left", "right", "full"):
            li, ri, out_valid, total = join_ops.outer_extend(
                plan.join_type, li, ri, out_valid, total, cnt,
                left.row_valid, right.row_valid, nl, nr,
            )

        if stream_cols is None:
            cols = ([_gather_col(c, li, out_valid) for c in left.cols]
                    + [_gather_col(c, ri, out_valid) for c in right.cols])
        else:
            cols = stream_cols
        out_cap = out_valid.shape[0]
        out = DevBatch(plan.schema, cols, out_cap, out_valid)

        if plan.residual is not None:
            data, valid, _ = self.eval_expr(plan.residual, out)
            mask = filter_ops.combine_mask(out.row_valid, data, valid)
            if plan.join_type != "inner":
                mask = mask | (((li < 0) | (ri < 0)) & out_valid)
            out = DevBatch(plan.schema, cols, out_cap, mask)
        return out

    def _stream_join(self, plan, left, right, lc, li_inv, rc, ri_inv,
                     capacity, fold_range):
        """Sorted-space inner join on the ``stream_compact`` and
        ``expand_fill`` kernels.  Key columns are derived from the sorted
        key lane and null-free int32 probe columns ride the co-sort: both
        come out of the expansion as fills; only the other columns are
        gathered.  Returns (cols, li, ri, out_valid, total, overflow)."""
        lkey_ix = (plan.left_keys[0].index
                   if isinstance(plan.left_keys[0], P.ColumnRef) else None)
        rkey_ix = (plan.right_keys[0].index
                   if isinstance(plan.right_keys[0], P.ColumnRef) else None)
        pay_ix, pay_arrays = [], []
        for i, c in enumerate(left.cols):
            if i == lkey_ix:
                continue
            if (c.validity is None and c.dictionary is None
                    and (c.data.dtype == torch.int32
                         or (c.int32_ok and c.data.dtype == torch.int64))):
                pay_ix.append(i)
                pay_arrays.append(c.data if c.data.dtype == torch.int32
                                  else c.as_int32())
        need_ri = any(j != rkey_ix for j in range(len(right.cols)))
        res = join_ops.inner_join_stream(
            lc, li_inv, rc, ri_inv, capacity, fold_range,
            probe_payloads=pay_arrays,
            emit_key=(lkey_ix is not None or rkey_ix is not None),
            need_ri=need_ri)
        GLOBAL_METRICS.bump("torch_join_stream_path")
        li, ri = res["li"], res["ri"]
        out_valid = res["out_valid"]
        pay_pos = {ix: k for k, ix in enumerate(pay_ix)}

        def _keycol(c):
            return DevCol(res["key"], None, None,
                          int32_ok=c.int32_ok or c.data.dtype == torch.int32,
                          value_range=c.value_range or fold_range)

        cols = []
        for i, c in enumerate(left.cols):
            if i == lkey_ix and res["key"] is not None:
                cols.append(_keycol(c))
            elif i in pay_pos:
                cols.append(DevCol(
                    res["payloads"][pay_pos[i]], None, None,
                    int32_ok=c.int32_ok or c.data.dtype == torch.int32,
                    value_range=c.value_range))
            else:
                cols.append(_gather_col(c, li, out_valid))
        for j, c in enumerate(right.cols):
            if j == rkey_ix and res["key"] is not None:
                cols.append(_keycol(c))
            else:
                cols.append(_gather_col(c, ri, out_valid))
        return cols, li, ri, out_valid, res["total"], res["overflow"]

    @staticmethod
    def _build_keys(plan, side: str):
        """(build key, probe key) expressions with ``side`` as the build."""
        if side == "right":
            return plan.right_keys[0], plan.left_keys[0]
        return plan.left_keys[0], plan.right_keys[0]

    def _lookup_range(self, plan, build: DevBatch, side: str = "right"):
        """Lookup-join eligibility: single int key, the ``side`` side's
        proven unique with a stats-bounded range.  Returns (kmin, kmax) or
        None."""
        if len(plan.left_keys) != 1:
            return None
        bexpr, pexpr = self._build_keys(plan, side)
        if not isinstance(bexpr, P.ColumnRef):
            return None
        bcol = build.cols[bexpr.index]
        rng = bcol.value_range
        if not bcol.unique or rng is None:
            return None
        span = int(rng[1]) - int(rng[0]) + 1
        if not (0 < span <= self.config.direct_join_max_range):
            return None
        if pexpr.dtype in (DType.FLOAT64, DType.STRING) or \
                bexpr.dtype in (DType.FLOAT64, DType.STRING):
            return None
        return (int(rng[0]), int(rng[1]))

    def _cached_dense_index(self, plan, build: DevBatch, side: str = "right"):
        """The table's persistent dense join index for the ``side`` side's
        key, when that side is an unfiltered scan.  JAX also accepts its
        static scan-padding prefix (``prefix_rows``); the port's tables carry
        no padding, so an unfiltered scan is exactly ``row_valid is None``."""
        bexpr, _ = self._build_keys(plan, side)
        if not isinstance(bexpr, P.ColumnRef):
            return None
        bcol = build.cols[bexpr.index]
        if bcol.source is None or build.row_valid is not None:
            return None
        tname, ti = bcol.source
        tbl = self.tables.get(tname)
        if tbl is None:
            return None
        return tbl["dense_idx"].get(ti)

    def _try_lookup_join(self, plan, left: DevBatch, right: DevBatch,
                         lkeys, rkeys, build: str = "right"
                         ) -> Optional[DevBatch]:
        """The lookup join with the ``build`` side's unique key as the dense
        table and the other side as the probe.  The output has the probe's
        capacity and rows in their order: the probe's columns pass through
        as they are (each probe row appears at most once), the build's are
        gathered.  Inner joins, and the outer join that keeps every probe
        row."""
        if build == "right":
            probe, bside, outer = left, right, "left"
            pk, bk = lkeys[0], rkeys[0]
        else:
            probe, bside, outer = right, left, "right"
            pk, bk = rkeys[0], lkeys[0]
        if plan.join_type not in ("inner", outer):
            return None
        rng = self._lookup_range(plan, bside, build)
        if rng is None:
            return None

        binv = bk["null"] if bside.row_valid is None else (
            bk["null"] | ~bside.row_valid)
        pinv = pk["null"] if probe.row_valid is None else (
            pk["null"] | ~probe.row_valid)
        dense_row = self._cached_dense_index(plan, bside, build)
        if dense_row is not None:
            rel_c, inr = join_ops.dense_probe(rng[0], rng[1], pk["code"], pinv)
        else:
            dense_row, rel_c, inr = join_ops.lookup_slots(
                bk["code"], binv, rng[0], rng[1], pk["code"], pinv)

        # per-column dense VALUE tables (build-sized gathers) replace
        # per-probe-row gathers through dense_row.  A null-free int column
        # with zone-map stats gets a sentinel (range max + 1) in empty slots:
        # its one probe gather yields value AND matchedness
        nb = bside.capacity
        safe_dense = torch.clamp(dense_row, 0, nb - 1)
        slot_ok = dense_row >= 0
        # sentinel column: prefer a NON-key column (the key is rarely
        # referenced after the join)
        key_ix = self._build_keys(plan, build)[0].index
        sent_ix = None
        for i, c in enumerate(bside.cols):
            if (c.validity is None and c.dictionary is None
                    and c.value_range is not None
                    and c.data.dtype == torch.int64
                    and int(c.value_range[1]) < np.iinfo(np.int64).max):
                if sent_ix is None:
                    sent_ix = i
                if i != key_ix:
                    sent_ix = i
                    break

        matched = None
        dense_vals = []
        for i, c in enumerate(bside.cols):
            src = c.data
            if c.int32_ok and src.dtype == torch.int64:
                src = c.as_int32()  # int32 value tables where zone maps allow
            dv = src[safe_dense]
            dvalid = None if c.validity is None else (
                c.validity[safe_dense] & slot_ok)
            if i == sent_ix:
                sent = int(c.value_range[1]) + 1
                dv = torch.where(slot_ok, dv, torch.tensor(
                    sent, dtype=dv.dtype, device=dv.device))
                g = dv[rel_c]
                matched = inr & (g != sent)
                dense_vals.append((c, g, None, None))
            else:
                dense_vals.append((c, None, dv, dvalid))
        if matched is None:  # no sentinel-capable column: probe dense_row
            matched = inr & (dense_row[rel_c] >= 0)

        n = probe.capacity
        pvalid = probe.row_valid if probe.row_valid is not None else \
            torch.ones(n, dtype=torch.bool, device=self.device)
        # inner: matched probe rows; outer: every probe row survives
        out_valid = pvalid & matched if plan.join_type == "inner" else pvalid

        bcols = []
        for c, g, dv, dvalid in dense_vals:
            if g is None:
                g = dv[rel_c]
            valid = matched if dvalid is None else (dvalid[rel_c] & matched)
            bcols.append(DevCol(g, valid, c.dictionary, c.int32_ok,
                                c.value_range))
        # the schema's order: the left side's columns, then the right's
        cols = (list(probe.cols) + bcols if build == "right"
                else bcols + list(probe.cols))
        out = DevBatch(plan.schema, cols, n, out_valid)
        if plan.residual is not None:
            data, valid, _ = self.eval_expr(plan.residual, out)
            mask = filter_ops.combine_mask(out.row_valid, data, valid)
            if plan.join_type == outer:
                mask = mask | (~matched & out_valid)
            out = DevBatch(plan.schema, cols, n, mask)
        return out

    def _key_of(self, expr: P.PhysExpr, batch: DevBatch):
        data, valid, dictionary = self.eval_expr(expr, batch)
        code, null = key_code(data, valid, _np_kind(expr.dtype))
        if self._int32_ok(expr, batch) and code.dtype == torch.int64:
            code = self._narrow32(expr, batch, data)  # stats-backed fast path
        vrange = (batch.cols[expr.index].value_range
                  if isinstance(expr, P.ColumnRef) else None)
        return {"code": code, "null": null, "dict": dictionary,
                "dtype": expr.dtype, "range": vrange}

    @staticmethod
    def _fold_range(plan, lkeys, rkeys):
        """Union zone-map range over both key sides (single int key): lets the
        merge probe keep its folded key+tag lane in int32."""
        if len(lkeys) != 1 or len(rkeys) != 1:
            return None
        lr, rr = lkeys[0].get("range"), rkeys[0].get("range")
        if lr is None or rr is None:
            return None
        for k in (lkeys[0], rkeys[0]):
            # strings are excluded: dictionary unification can remap codes
            # past the registered (0, len(dict)-1) range
            if k["dtype"] in (DType.FLOAT64, DType.STRING):
                return None
        return (min(int(lr[0]), int(rr[0])), max(int(lr[1]), int(rr[1])))

    def _unified_key_tuples(self, plan, left, right, lkeys, rkeys):
        """Dictionary-unified, dtype-promoted (code, null) tuples per side."""
        lkeys, rkeys = self._unify_string_keys(plan, lkeys, rkeys)
        lout, rout = [], []
        for (lc, ln), (rc, rn) in zip(lkeys, rkeys):
            if lc.dtype != rc.dtype:
                common = torch.promote_types(lc.dtype, rc.dtype)
                lc, rc = lc.to(common), rc.to(common)
            lout.append((lc, ln))
            rout.append((rc, rn))
        return lout, rout

    @staticmethod
    def _unify_string_keys(plan, lkeys, rkeys):
        lout, rout = [], []
        for lk, rk, le, re_ in zip(lkeys, rkeys, plan.left_keys,
                                   plan.right_keys):
            if le.dtype is DType.STRING or re_.dtype is DType.STRING:
                (lc, rc), _ = _onto_union([(lk["code"], lk["dict"]),
                                           (rk["code"], rk["dict"])],
                                          lk["code"].device)
                lk, rk = dict(lk, code=lc), dict(rk, code=rc)
            lout.append((lk["code"], lk["null"]))
            rout.append((rk["code"], rk["null"]))
        return lout, rout

    # -- eager aggregation through joins (group-join) ---------------------
    def _join_match_counts(self, plan: P.TpuHashJoin, left: DevBatch,
                           right: DevBatch) -> torch.Tensor:
        """Per-probe-row match counts of an inner join, without
        materializing the match buffer."""
        lkeys = [self._key_of(k, left) for k in plan.left_keys]
        rkeys = [self._key_of(k, right) for k in plan.right_keys]
        if plan.strategy != "sort_merge":
            rng = self._lookup_range(plan, right)
            if rng is not None:
                lk, rk = lkeys[0], rkeys[0]
                rinv = (rk["null"] if right.row_valid is None
                        else (rk["null"] | ~right.row_valid))
                pinv = (lk["null"] if left.row_valid is None
                        else (lk["null"] | ~left.row_valid))
                dense_row = self._cached_dense_index(plan, right)
                if dense_row is not None:
                    rel_c, inr = join_ops.dense_probe(rng[0], rng[1],
                                                      lk["code"], pinv)
                    matched = inr & (dense_row[rel_c] >= 0)
                else:
                    _, matched = join_ops.lookup_join(
                        rk["code"], rinv, rng[0], rng[1], lk["code"], pinv)
                return matched.to(torch.int64)
        fold_range = self._fold_range(plan, lkeys, rkeys)
        lkeys_t, rkeys_t = self._unified_key_tuples(plan, left, right,
                                                    lkeys, rkeys)
        lcode, linv, rcode, rinv = join_ops._prepare_codes(
            lkeys_t, left.row_valid, rkeys_t, right.row_valid, True)
        _, cnt = join_ops.probe_ranges_merge(rcode, rinv, lcode, linv,
                                             fold_range=fold_range)
        return cnt

    def _try_join_aggregate(self, plan: P.TpuAggregate,
                            path) -> Optional[DevBatch]:
        """Aggregate over an inner join computed from match counts (the
        group-join / eager-aggregation rewrite).  Eligible when group keys
        and every aggregate argument are probe-side only and aggregates are
        COUNT(*) / SUM / COUNT / AVG / MIN / MAX: SUM and AVG weight rows by
        match multiplicity, COUNT sums multiplicities, MIN/MAX ignore them,
        and probe rows with no match drop out.  Global aggregates first try
        the sorted-space path, which also takes build-side and decomposable
        pair arguments.  No match buffer, so no capacity regrow."""
        join = plan.input
        if join.join_type != "inner" or join.residual is not None:
            return None
        n_left_cols = len(join.left.schema)
        # equi-key equivalence: on matched rows a right KEY column equals its
        # left key, so references to it rewrite to the left column
        subst = {}
        for lk, rk in zip(join.left_keys, join.right_keys):
            if isinstance(lk, P.ColumnRef) and isinstance(rk, P.ColumnRef) \
                    and lk.dtype == rk.dtype and lk.dtype in (
                        DType.INT64, DType.DATE32, DType.TIMESTAMP_MS,
                        DType.BOOL):
                subst[n_left_cols + rk.index] = P.ColumnRef(
                    lk.dtype, lk.index, lk.name)
        if subst:
            group_exprs = tuple(_subst_cols(g, subst)
                                for g in plan.group_exprs)
            aggs = tuple(
                dataclasses.replace(a, arg=_subst_cols(a.arg, subst))
                if a.arg is not None else a
                for a in plan.aggs)
            if group_exprs != tuple(plan.group_exprs) \
                    or aggs != tuple(plan.aggs):
                plan = dataclasses.replace(plan, group_exprs=group_exprs,
                                           aggs=aggs)
        for g in plan.group_exprs:
            if any(i >= n_left_cols for i in _expr_col_indices(g)):
                return None
        for a in plan.aggs:
            if a.distinct:
                return None
            if a.arg is None:
                if a.func != "count":
                    return None
                continue
            if a.func not in ("sum", "count", "avg", "min", "max"):
                return None

        reads_build = any(
            a.arg is not None
            and any(i >= n_left_cols for i in _expr_col_indices(a.arg))
            for a in plan.aggs)
        if plan.group_exprs and reads_build:
            return None
        left = self.exec(join.left, path + (0, 0))
        right = self.exec(join.right, path + (0, 1))
        if not plan.group_exprs:
            fast = self._sorted_global_join_agg(plan, join, left, right)
            if fast is not None:
                return fast
            if reads_build:
                return None

        with tracing.span(logger, "join", route="match_counts"):
            cnt = self._join_match_counts(join, left, right)
            participates = cnt > 0

        if plan.group_exprs:
            return self._grouped_join_aggregate(plan, path, left, cnt,
                                                participates)

        cols = []
        for a in plan.aggs:
            if a.arg is None:
                cols.append(DevCol(cnt.sum().reshape(1), None))
                continue
            data, valid, dictionary = self.eval_expr(a.arg, left)
            v_ok = participates if valid is None else (participates & valid)
            c = torch.where(v_ok, cnt, 0).sum()
            has = (c > 0).reshape(1)
            acc = a.out_dtype.numpy_dtype
            tacc = torch_dtype(acc)
            if a.func == "count":
                cols.append(DevCol(c.reshape(1), None))
            elif a.func == "sum":
                s = torch.where(v_ok, data.to(tacc) * cnt.to(tacc), 0).sum()
                cols.append(DevCol(s.reshape(1), has))
            elif a.func == "avg":
                s = torch.where(v_ok, data.to(torch.float64)
                                * cnt.to(torch.float64), 0.0).sum()
                avg = s / torch.clamp(c, min=1).to(torch.float64)
                cols.append(DevCol(torch.where(c > 0, avg, 0.0).reshape(1),
                                   has))
            else:  # min / max: multiplicity-independent masked reduction
                red = _masked_minmax(a.func, data.to(tacc), v_ok, acc)
                out = torch.where(c > 0, red, 0).reshape(1)
                dct = dictionary if a.out_dtype is DType.STRING else None
                cols.append(DevCol(out, has, dct))
        return DevBatch(plan.schema, cols, 1, None)

    def _sorted_global_join_agg(self, plan: P.TpuAggregate,
                                join: P.TpuHashJoin, left: DevBatch,
                                right: DevBatch) -> Optional[DevBatch]:
        """GLOBAL aggregate over an inner join, reduced in the merge-sorted
        key space (a reduction needs no probe-order restore).  Two argument
        families qualify:

        * KEY-DERIVED expressions (right-key refs included, through the
          equi-key substitution): recomputed from the sorted key lane;
        * DECOMPOSABLE pair expressions, top-level sums of side-pure terms
          (``SUM(l.v + r.w)``): the sum over matched pairs of f(probe) +
          g(build) is sum_i bcnt_i*f_i + sum_j pcnt_j*g_j, so each side-pure
          term rides the merge sort as ONE payload lane weighted by the
          per-element match multiplicities.  MIN/MAX take a single side-pure
          (or key) argument.
        """
        if len(join.left_keys) != 1:
            return None
        lk_expr = join.left_keys[0]
        if not isinstance(lk_expr, P.ColumnRef) or \
                _np_kind(lk_expr.dtype) != "i":
            return None
        n_left_cols = len(join.left.schema)
        # a STRING key lane holds codes of the two sides' unified dictionary,
        # which no expression reads: its column rides as a probe payload
        key_idx = set() if lk_expr.dtype is DType.STRING else {lk_expr.index}

        def side_of(e):
            idxs = set(_expr_col_indices(e))
            if idxs <= key_idx:
                return "key"
            if all(i < n_left_cols for i in idxs):
                return "probe"
            if all(i >= n_left_cols for i in idxs):
                return "build"
            return None

        def split_terms(e):
            sd = side_of(e)
            if sd is not None:
                return [(sd, e)]
            if isinstance(e, P.PhysBinary) and e.op == "+":
                lt = split_terms(e.left)
                rt = split_terms(e.right)
                if lt is None or rt is None:
                    return None
                return lt + rt
            return None

        def shift_right(e):
            mapping = {}
            for i in set(_expr_col_indices(e)):
                f = join.right.schema.field(i - n_left_cols)
                mapping[i] = P.ColumnRef(f.dtype, i - n_left_cols, f.name)
            return _subst_cols(e, mapping)

        payload_terms: List[tuple] = []   # (side, expr)

        def payload_slot(side, expr):
            for i, (s2, e2) in enumerate(payload_terms):
                if s2 == side and repr(e2) == repr(expr):
                    return i
            payload_terms.append((side, expr))
            return len(payload_terms) - 1

        agg_specs = []
        for a in plan.aggs:
            if a.arg is None:
                agg_specs.append(("total",))
                continue
            if a.func == "count":
                sd = side_of(a.arg)
                if sd is None:
                    return None
                if sd in ("probe", "build"):
                    # COUNT(col) == COUNT(*) only for null-free arguments
                    expr_, batch_ = (a.arg, left) if sd == "probe" else (
                        shift_right(a.arg), right)
                    if self.eval_expr(expr_, batch_)[1] is not None:
                        return None
                agg_specs.append(("count", sd, a.arg))
            elif a.func in ("sum", "avg"):
                terms = split_terms(a.arg)
                if terms is None:
                    return None
                agg_specs.append((a.func, [
                    (sd, e if sd == "key" else payload_slot(sd, e))
                    for sd, e in terms]))
            elif a.func in ("min", "max"):
                sd = side_of(a.arg)
                if sd is None:
                    return None
                agg_specs.append(("minmax", a.func, sd,
                                  a.arg if sd == "key"
                                  else payload_slot(sd, a.arg)))
            else:
                return None
        if len(payload_terms) > 3:
            return None  # each payload lane rides the whole merge sort
        if not payload_terms and join.strategy != "sort_merge" and \
                self._lookup_range(join, right) is not None:
            return None  # pure key shapes: lookup counting is cheaper

        with tracing.span(logger, "join", route="sorted_global"):
            lkeys = [self._key_of(k, left) for k in join.left_keys]
            rkeys = [self._key_of(k, right) for k in join.right_keys]
            fold_range = self._fold_range(join, lkeys, rkeys)
            lkeys_t, rkeys_t = self._unified_key_tuples(join, left, right,
                                                        lkeys, rkeys)
            lcode, linv, rcode, rinv = join_ops._prepare_codes(
                lkeys_t, left.row_valid, rkeys_t, right.row_valid, True)
            nb = rcode.shape[0]
            npr = lcode.shape[0]

            i32max = (1 << 31) - 8
            lanes = []
            # a string lane's codes keep its column's dictionary
            lane_dicts = []
            for sd, expr in payload_terms:
                if sd == "probe":
                    expr_, batch = expr, left
                else:
                    expr_, batch = shift_right(expr), right
                data, valid, dictionary = self.eval_expr(expr_, batch)
                lane_dicts.append(dictionary)
                if valid is not None:
                    return None  # nullable term: the general paths handle it
                rng = self._expr_range(expr_, batch)
                if data.dtype == torch.float64:
                    dt = torch.float64
                elif rng is not None and -i32max < int(rng[0]) \
                        and int(rng[1]) < i32max:
                    dt = torch.int32
                else:
                    dt = torch.int64
                data = data.to(dt)
                if sd == "probe":
                    lanes.append(torch.cat([torch.zeros(nb, dtype=dt,
                                                        device=self.device),
                                            data]))
                else:
                    lanes.append(torch.cat([data, torch.zeros(
                        npr, dtype=dt, device=self.device)]))

            probe_ok, key_sorted, cnt_elem, build_ok, pcnt_elem, pay_s = \
                join_ops.probe_counts_sorted(rcode, rinv, lcode, linv,
                                             fold_range=fold_range,
                                             payloads=tuple(lanes))

        # key-derived args evaluate on the sorted key lane, widened to the
        # column's logical dtype (expression arithmetic must not wrap)
        key_lane = key_sorted.to(torch.int64)
        fake = DevBatch(join.left.schema,
                        [DevCol(key_lane, None) for _ in left.cols],
                        key_lane.shape[0], None)

        cnt64 = cnt_elem.to(torch.int64)
        pcnt64 = pcnt_elem.to(torch.int64)
        total = cnt64.sum()
        has = (total > 0).reshape(1)
        probe_matched = probe_ok & (cnt_elem > 0)
        build_matched = build_ok & (pcnt_elem > 0)

        def term_sum(sd, ref, acc):
            tacc = torch_dtype(acc)
            if sd == "key":
                data = self.eval_expr(ref, fake)[0]
                return torch.where(probe_ok, data.to(tacc) * cnt64.to(tacc),
                                   0).sum()
            mult, ok = ((cnt64, probe_ok) if sd == "probe"
                        else (pcnt64, build_ok))
            return torch.where(ok, pay_s[ref].to(tacc) * mult.to(tacc),
                               0).sum()

        def term_lane(sd, ref):
            if sd == "key":
                return self.eval_expr(ref, fake)[0], probe_matched
            return pay_s[ref], (probe_matched if sd == "probe"
                                else build_matched)

        cols = []
        for spec, a in zip(agg_specs, plan.aggs):
            acc = a.out_dtype.numpy_dtype
            if spec[0] in ("total", "count"):
                # null-free arguments: COUNT(col) == COUNT(*)
                cols.append(DevCol(total.reshape(1), None))
            elif spec[0] == "sum":
                s = sum(term_sum(sd, ref, acc) for sd, ref in spec[1])
                cols.append(DevCol(s.reshape(1), has))
            elif spec[0] == "avg":
                s = sum(term_sum(sd, ref, np.float64) for sd, ref in spec[1])
                avg = s / torch.clamp(total, min=1).to(torch.float64)
                cols.append(DevCol(torch.where(total > 0, avg,
                                               0.0).reshape(1), has))
            else:  # minmax
                _tag, func, sd, ref = spec
                data, ok = term_lane(sd, ref)
                red = _masked_minmax(func, data.to(torch_dtype(acc)), ok, acc)
                dct = (lane_dicts[ref] if a.out_dtype is DType.STRING
                       else None)
                cols.append(DevCol(torch.where(total > 0, red,
                                               0).reshape(1), has, dct))
        GLOBAL_METRICS.bump("torch_sorted_global_join_agg")
        return DevBatch(plan.schema, cols, 1, None)

    def _grouped_join_aggregate(self, plan: P.TpuAggregate, path,
                                left: DevBatch, cnt, participates) -> DevBatch:
        """GROUP BY over probe-side keys with multiplicity-weighted
        aggregates (the grouped half of the group-join rewrite).  Unmatched
        probe rows (cnt == 0) drop out of grouping, as in an inner join."""
        keys, key_meta, packed_spec, max_groups = self._group_keys(
            plan.group_exprs, left, path)

        specs: List[dict] = []
        post = []
        for a in plan.aggs:
            acc = a.out_dtype.numpy_dtype
            if a.arg is None:  # COUNT(*) = sum of multiplicities
                specs.append({"func": "sum", "values": cnt, "valid": None,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_star",)})
                post.append(("count", len(specs) - 1, None))
                continue
            data, valid, dictionary = self.eval_expr(a.arg, left)
            dct = dictionary if a.out_dtype is DType.STRING else None
            if a.func == "count":
                specs.append({"func": "sum", "values": cnt, "valid": valid,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_cnt", a.arg)})
                post.append(("count", len(specs) - 1, None))
            elif a.func == "sum":
                tacc = torch_dtype(acc)
                specs.append({"func": "sum",
                              "values": data.to(tacc) * cnt.to(tacc),
                              "valid": valid, "distinct": False,
                              "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": ("gj_sum", a.arg)})
                post.append(("plain", len(specs) - 1, None))
            elif a.func == "avg":
                specs.append({"func": "sum",
                              "values": data.to(torch.float64)
                              * cnt.to(torch.float64),
                              "valid": valid, "distinct": False,
                              "acc_dtype": np.float64, "np_kind": "f",
                              "arg_id": ("gj_avg", a.arg)})
                specs.append({"func": "sum", "values": cnt, "valid": valid,
                              "distinct": False, "acc_dtype": np.int64,
                              "np_kind": "i", "arg_id": ("gj_cnt", a.arg)})
                post.append(("avg", len(specs) - 2, len(specs) - 1))
            else:  # min / max: multiplicity-independent
                specs.append({"func": a.func, "values": data, "valid": valid,
                              "distinct": False, "acc_dtype": acc,
                              "np_kind": _np_kind(a.arg.dtype),
                              "arg_id": a.arg,
                              "int32_ok": self._int32_ok(a.arg, left),
                              "dictionary": dct})
                post.append(("plain", len(specs) - 1, None))

        group_codes, results, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, participates, specs, max_groups, n_rows=left.capacity,
            allow_kernel=self._seg_agg_on(), device=self.device)
        self._push_flag(("agg", path), overflow)
        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        cols += _post_cols(post, results, specs)
        return self._grouped_batch(plan.schema, cols, max_groups, n_groups)

    _KERNEL_CMP = {">": "gt", ">=": "ge", "<": "lt", "<=": "le",
                   "=": "eq", "==": "eq", "!=": "ne", "<>": "ne"}

    def _try_filter_agg_kernel(self, plan: P.TpuAggregate,
                               path) -> Optional[DevBatch]:
        """The ``filter_agg`` kernel for a GLOBAL aggregate
        (COUNT/SUM/MIN/MAX/AVG over null-free int32-narrowable columns)
        directly over ``scan -> WHERE <col> <cmp> <int literal>``: one pass,
        4 B/row per distinct column, no mask materialized.  Counterpart of
        the JAX executor's ``_try_pallas_filter_agg``.  Returns None when the
        shape does not match; the caller takes the general mask path."""
        from ..ops.kernels.filter_agg import MAX_COLS, MIN_ROWS, filter_agg_i32

        if plan.group_exprs or not self.config.use_pallas:
            return None
        filt = plan.input
        if not isinstance(filt, P.TpuFilter) or \
                not isinstance(filt.input, P.TpuTableScan):
            return None
        pred = filt.predicate
        if not isinstance(pred, P.PhysBinary):
            return None
        op = self._KERNEL_CMP.get(pred.op)
        if op is None:
            return None
        lhs, rhs = pred.left, pred.right
        if isinstance(lhs, P.PhysLiteral) and isinstance(rhs, P.ColumnRef):
            # lit <cmp> col  ==  col <flipped-cmp> lit
            lhs, rhs = rhs, lhs
            op = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge",
                  "eq": "eq", "ne": "ne"}[op]
        if not (isinstance(lhs, P.ColumnRef) and isinstance(rhs, P.PhysLiteral)):
            return None
        if not isinstance(rhs.value, (int, np.integer)) or \
                isinstance(rhs.value, bool):
            return None
        lit = int(rhs.value)
        if not (np.iinfo(np.int32).min < lit < np.iinfo(np.int32).max):
            return None
        if self.tables[filt.input.table_name]["capacity"] < MIN_ROWS:
            return None  # tiny inputs: the general path is fine
        batch = self.exec(filt.input, path + (0, 0))

        def _col_ok(e):
            if not isinstance(e, P.ColumnRef) or _np_kind(e.dtype) != "i":
                return False
            c = batch.cols[e.index]
            return (c.validity is None and c.dictionary is None
                    and c.int32_ok and c.data.dtype == torch.int64)

        if not _col_ok(lhs):
            return None
        for a in plan.aggs:
            if a.distinct or a.func not in ("count", "sum", "min", "max", "avg"):
                return None
            if a.arg is not None and not _col_ok(a.arg):
                return None

        # value columns, deduped by table column index, with per-column
        # (sum, minmax) lane flags
        col_ix: List[int] = []
        want: Dict[int, List[bool]] = {}
        for a in plan.aggs:
            if a.arg is None:
                continue
            if a.arg.index not in col_ix:
                col_ix.append(a.arg.index)
                want[a.arg.index] = [False, False]
            if a.func in ("sum", "avg"):
                want[a.arg.index][0] = True
            elif a.func in ("min", "max"):
                want[a.arg.index][1] = True
        if len(col_ix) > MAX_COLS:
            return None  # more value columns than one launch takes
        filt32 = batch.cols[lhs.index].as_int32()
        cols32 = tuple(batch.cols[i].as_int32() for i in col_ix)
        wants = tuple((want[i][0], want[i][1]) for i in col_ix)
        count, per_col = filter_agg_i32(filt32, op, lit, cols32, wants=wants)
        has = (count > 0).reshape(1)

        cols = []
        for a in plan.aggs:
            acc = a.out_dtype.numpy_dtype
            if a.arg is None or a.func == "count":
                # COUNT(col) == COUNT(*) here: columns are proven null-free
                cols.append(DevCol(count.reshape(1), None))
                continue
            total, mn, mx = per_col[col_ix.index(a.arg.index)]
            if a.func == "sum":
                s = total if np.dtype(acc) == np.dtype(np.int64) \
                    else total.to(torch_dtype(acc))
                cols.append(DevCol(s.reshape(1), has))
            elif a.func == "avg":
                av = total.to(torch.float64) / torch.clamp(count, min=1)
                cols.append(DevCol(av.reshape(1), has))
            else:
                red = mn if a.func == "min" else mx
                red = torch.where(count > 0, red, 0)
                if np.dtype(acc) != np.dtype(np.int64):
                    red = red.to(torch_dtype(acc))  # int32 widens host-side
                cols.append(DevCol(red.reshape(1), has))
        GLOBAL_METRICS.bump("torch_filter_agg_path")
        return DevBatch(plan.schema, cols, 1, None)

    def _aggregate(self, plan: P.TpuAggregate, path) -> DevBatch:
        fast = self._try_filter_agg_kernel(plan, path)
        if fast is not None:
            tracing.annotate(route="filter_agg")
            return fast
        if isinstance(plan.input, P.TpuHashJoin):
            fast = self._try_join_aggregate(plan, path)
            if fast is not None:
                tracing.annotate(route="join_aggregate")
                return fast
        batch = self.exec(plan.input, path + (0,))
        if plan.group_exprs:
            keys, key_meta, packed_spec, max_groups = self._group_keys(
                plan.group_exprs, batch, path)
        else:
            keys, key_meta, packed_spec, max_groups = [], [], None, 1

        specs = []
        for a in plan.aggs:
            if a.arg is None:
                specs.append({"func": a.func, "values": None, "valid": None,
                              "distinct": a.distinct,
                              "acc_dtype": a.out_dtype.numpy_dtype})
                continue
            data, valid, dictionary = self.eval_expr(a.arg, batch)
            specs.append({
                "func": a.func, "values": data, "valid": valid,
                "distinct": a.distinct, "acc_dtype": a.out_dtype.numpy_dtype,
                "np_kind": _np_kind(a.arg.dtype),
                "int32_ok": self._int32_ok(a.arg, batch),
                # structural id of the argument expression: min/max specs over
                # the same argument share the ride-the-sort fast path
                "arg_id": a.arg,
                # min/max over string codes is exact because dictionaries are
                # sorted; the result column keeps the argument's dictionary
                "dictionary": dictionary if a.out_dtype is DType.STRING else None,
            })

        group_codes, results, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, batch.row_valid, specs, max_groups, n_rows=batch.capacity,
            allow_kernel=self._seg_agg_on(),
            device=self.device,
        )
        if plan.group_exprs:
            self._push_flag(("agg", path), overflow)

        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        i32max = (1 << 31) - 8
        for (data, valid), a, spec in zip(results, plan.aggs, specs):
            # provable-int32 result ranges: COUNT <= capacity; MIN/MAX stay
            # within the argument's zone-map range; SUM when
            # capacity * max|v| provably fits.  Downstream operators (HAVING,
            # ORDER BY, multi-key packing) read them like column statistics.
            ok32, rng32 = False, None
            if a.func == "count":
                ok32, rng32 = True, (0, batch.capacity)
            elif a.func in ("min", "max", "sum") and a.arg is not None \
                    and a.out_dtype.numpy_dtype == np.dtype(np.int64):
                vrange = self._expr_range(a.arg, batch)
                if vrange is not None:
                    lo, hi = int(vrange[0]), int(vrange[1])
                    if a.func in ("min", "max"):
                        ok32 = -i32max < lo and hi < i32max
                        rng32 = (lo, hi)
                    else:
                        bound = batch.capacity * max(abs(lo), abs(hi))
                        ok32 = bound < i32max
                        rng32 = (-bound, bound)
            cols.append(DevCol(data, valid, spec.get("dictionary"),
                               int32_ok=ok32, value_range=rng32))

        if plan.group_exprs:
            return self._grouped_batch(plan.schema, cols, max_groups,
                                       n_groups)
        return DevBatch(plan.schema, cols, 1, None)

    def _group_keys(self, group_exprs, batch: DevBatch, path):
        """The GROUP BY keys of ``group_exprs`` over ``batch``: the
        ``(code, null)`` key list for ``groupby_aggregate``, each key's
        ``(dtype, dictionary)``, ``_pack_keys``' packed spec, and the group
        capacity, recorded under ``("agg", path)`` for a regrow."""
        keys = []
        key_meta = []
        for g in group_exprs:
            data, valid, dictionary = self.eval_expr(g, batch)
            code, null = key_code(data, valid, _np_kind(g.dtype))
            if valid is None and _np_kind(g.dtype) != "f":
                null = None  # statically null-free: drops a sort operand
            if self._int32_ok(g, batch) and code.dtype == torch.int64:
                code = self._narrow32(g, batch, data)  # zone-map narrow path
            keys.append((code, null))
            key_meta.append((g.dtype, dictionary))
        keys, packed_spec = self._pack_keys(group_exprs, batch, keys,
                                            key_meta)
        cap_key = ("agg", path)
        max_groups = self.cap_override.get(
            cap_key, min(self.config.max_groups, batch.capacity))
        self.meta["capacities"][cap_key] = max_groups
        return keys, key_meta, packed_spec, max_groups

    def _grouped_batch(self, schema, cols, max_groups, n_groups) -> DevBatch:
        """A GROUP BY's output: ``max_groups`` rows, the first ``n_groups``
        of them valid."""
        row_valid = torch.arange(max_groups, device=self.device) < n_groups
        return DevBatch(schema, cols, max_groups, row_valid,
                        prefix_count=n_groups)

    def _pack_keys(self, group_exprs, batch, keys, key_meta):
        """Multi-key GROUP BY packing: when every key is statically null-free
        int-kind with zone-map bounds whose span PRODUCT fits int32, fold the
        tuple into ONE packed int32 code (sum of (k_i - lo_i) * stride_i), so
        multi-key GROUP BY takes the single-int32-key seg_agg path; outputs
        decode exactly on the group-sized result (_group_key_cols).

        Returns (keys, packed_spec|None)."""
        if len(keys) < 2 or any(null is not None for _, null in keys) \
                or any(_np_kind(g.dtype) != "i" for g in group_exprs):
            return keys, None

        def code_range(g, dictionary):
            # dictionary columns pack on their CODE space (0..len-1)
            if dictionary is not None:
                return (0, len(dictionary) - 1)
            return self._expr_range(g, batch)

        rngs = [code_range(g, dct) for g, (_dt, dct)
                in zip(group_exprs, key_meta)]
        if any(r is None for r in rngs):
            return keys, None
        spans = [int(r[1]) - int(r[0]) + 1 for r in rngs]
        prod = 1
        for s in spans:
            prod *= s
        if not (0 < prod < (1 << 31) - 8):
            return keys, None
        strides = []
        acc = 1
        for s in reversed(spans):
            strides.append(acc)
            acc *= s
        strides.reverse()
        packed = None
        for (code, _null), r, stride in zip(keys, rngs, strides):
            term = (code - int(r[0])).to(torch.int32) * stride
            packed = term if packed is None else packed + term
        return [(packed, None)], (rngs, strides)

    @staticmethod
    def _group_key_cols(group_codes, key_meta, packed_spec):
        """Group-key output columns, decoding a packed code when present
        (rows >= n_groups hold garbage and are sliced off host-side)."""
        cols = []
        if packed_spec is not None:
            rngs, strides = packed_spec
            rem = group_codes[0][0]
            for (dtype, dictionary), r, stride in zip(key_meta, rngs, strides):
                q = torch.div(rem, stride, rounding_mode="floor")
                rem = rem - q * stride
                cols.append(_decode_key(q + int(r[0]), None, dtype, dictionary))
            return cols
        for (code, null), (dtype, dictionary) in zip(group_codes, key_meta):
            cols.append(_decode_key(code, null, dtype, dictionary))
        return cols

    def _narrow32(self, expr: P.PhysExpr, batch: DevBatch, wide):
        """int32 operand for a zone-map-narrowable int64 expression: the
        table's upload-time shadow for a bare scan column, else a copy."""
        if isinstance(expr, P.ColumnRef):
            c = batch.cols[expr.index]
            if c.narrow is not None and wide is c.data:
                return c.narrow
        return wide.to(torch.int32)

    def _int32_ok(self, expr: P.PhysExpr, batch: DevBatch) -> bool:
        if (isinstance(expr, P.ColumnRef)
                and batch.cols[expr.index].int32_ok
                and expr.dtype is not DType.FLOAT64):
            return True
        rng = self._expr_range(expr, batch)
        return rng is not None and _LO32 < rng[0] and rng[1] < _HI32

    def _expr_range(self, e: P.PhysExpr, batch: DevBatch):
        """Interval propagation: (lo, hi) bound on an integer expression's
        valid values, from zone-map column statistics."""
        if isinstance(e, P.ColumnRef):
            c = batch.cols[e.index]
            if (c.value_range is None or e.dtype is DType.FLOAT64
                    or e.dtype is DType.STRING or c.dictionary is not None):
                return None
            return (int(c.value_range[0]), int(c.value_range[1]))
        if isinstance(e, P.PhysLiteral):
            return ((int(e.value), int(e.value))
                    if isinstance(e.value, (int, np.integer))
                    and not isinstance(e.value, bool) else None)
        if isinstance(e, P.PhysUnary) and e.op == "-":
            r = self._expr_range(e.operand, batch)
            return None if r is None else (-r[1], -r[0])
        if isinstance(e, P.PhysBinary) and e.op in ("+", "-", "*"):
            lr = self._expr_range(e.left, batch)
            rr = self._expr_range(e.right, batch)
            if lr is None or rr is None:
                return None
            if e.op == "+":
                return (lr[0] + rr[0], lr[1] + rr[1])
            if e.op == "-":
                return (lr[0] - rr[1], lr[1] - rr[0])
            prods = [lr[0] * rr[0], lr[0] * rr[1], lr[1] * rr[0], lr[1] * rr[1]]
            return (min(prods), max(prods))
        return None

    def _sort_keys(self, keys, batch: DevBatch):
        out = []
        for k in keys:
            data, valid, dictionary = self.eval_expr(k.expr, batch)
            if self._int32_ok(k.expr, batch) and data.dtype == torch.int64:
                data = self._narrow32(k.expr, batch, data)
            codes = order_code(data, _np_kind(k.expr.dtype))
            nulls = None if valid is None else ~valid
            out.append({"codes": codes, "nulls": nulls,
                        "ascending": k.ascending, "nulls_last": k.nulls_last})
        return out

    def _sort(self, plan: P.TpuSort, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        keys = self._sort_keys(plan.keys, batch)
        perm = sort_ops.order_by_permutation(keys, batch.row_valid,
                                             batch.capacity)
        count = batch.count(self.device)
        cols = []
        for c in batch.cols:
            cols.append(DevCol(
                c.data[perm],
                None if c.validity is None else c.validity[perm],
                c.dictionary, c.int32_ok, c.value_range,
            ))
        n = batch.capacity
        limit = plan.limit if plan.limit is not None else n
        pc = torch.clamp(count, max=limit)
        row_valid = torch.arange(n, device=self.device) < pc
        return DevBatch(plan.schema, cols, n, row_valid, prefix_count=pc)

    def _limit(self, plan: P.TpuLimit, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        rv = batch.row_valid
        if rv is None:
            rv = torch.ones(batch.capacity, dtype=torch.bool, device=self.device)
        pos = torch.cumsum(rv.to(torch.int64), 0)
        lo = plan.offset
        hi = lo + plan.limit if plan.limit is not None else None
        mask = rv & (pos > lo)
        if hi is not None:
            mask = mask & (pos <= hi)
        pc = None
        if lo == 0 and (batch.row_valid is None
                        or batch.prefix_count is not None):
            base = batch.count(self.device)
            pc = base if hi is None else torch.clamp(base, max=hi)
        return DevBatch(plan.schema, batch.cols, batch.capacity, mask,
                        prefix_count=pc)

    def _distinct(self, plan: P.TpuDistinct, path) -> DevBatch:
        batch = self.exec(plan.input, path + (0,))
        keys = []
        key_meta = []
        for f, c in zip(batch.schema, batch.cols):
            code, null = key_code(c.data, c.validity, _np_kind(f.dtype))
            if c.validity is None and _np_kind(f.dtype) != "f":
                null = None  # statically null-free: drops a sort operand
            if c.int32_ok and f.dtype is not DType.FLOAT64 \
                    and code.dtype == torch.int64:
                code = c.as_int32()
            keys.append((code, null))
            key_meta.append((f.dtype, c.dictionary))
        # same multi-key packing as GROUP BY
        exprs = [P.ColumnRef(f.dtype, i, f.name)
                 for i, f in enumerate(batch.schema)]
        keys, packed_spec = self._pack_keys(exprs, batch, keys, key_meta)
        cap_key = ("distinct", path)
        max_groups = self.cap_override.get(cap_key, batch.capacity)
        self.meta["capacities"][cap_key] = max_groups
        group_codes, _, n_groups, overflow = agg_ops.groupby_aggregate(
            keys, batch.row_valid, [], max_groups, n_rows=batch.capacity,
            allow_kernel=self._seg_agg_on(),
            device=self.device,
        )
        self._push_flag(cap_key, overflow)
        cols = self._group_key_cols(group_codes, key_meta, packed_spec)
        return self._grouped_batch(plan.schema, cols, max_groups, n_groups)

    def _push_flag(self, cap_key, flag):
        self.meta["flag_names"].append(cap_key)
        self.flags.append(flag)

    # ------------------------------------------------------------------
    # expression evaluation: returns (data, validity|None, dictionary|None)
    # ------------------------------------------------------------------
    def eval_expr(self, e: P.PhysExpr, batch: DevBatch):
        if isinstance(e, P.ColumnRef):
            c = batch.cols[e.index]
            return c.data, c.validity, c.dictionary
        if isinstance(e, P.PhysLiteral):
            return self._literal(e, batch.capacity)
        if isinstance(e, P.PhysBinary):
            return self._binary(e, batch)
        if isinstance(e, P.PhysUnary):
            data, valid, _ = self.eval_expr(e.operand, batch)
            if e.op == "NOT":
                return ~data.to(torch.bool), valid, None
            if e.op == "-":
                return -data, valid, None
            raise DeviceUnsupported(e.op)
        if isinstance(e, P.PhysIsNull):
            data, valid, _ = self.eval_expr(e.operand, batch)
            isnull = (torch.zeros(data.shape, dtype=torch.bool,
                                  device=self.device)
                      if valid is None else ~valid)
            return (~isnull if e.negated else isnull), None, None
        if isinstance(e, P.PhysInList):
            return self._in_list(e, batch)
        if isinstance(e, P.PhysCase):
            return self._case(e, batch)
        if isinstance(e, P.PhysFunc):
            return self._func(e, batch)
        raise DeviceUnsupported(type(e).__name__)

    def _literal(self, e: P.PhysLiteral, n: int):
        dt = torch_dtype(e.dtype.numpy_dtype)
        if e.value is None:
            return (torch.zeros(n, dtype=dt, device=self.device),
                    torch.zeros(n, dtype=torch.bool, device=self.device), None)
        if isinstance(e.value, str):
            return (torch.zeros(n, dtype=torch.int64, device=self.device), None,
                    np.array([e.value], dtype=object))
        return torch.full((n,), e.value, dtype=dt, device=self.device), None, None

    def _ones(self, shape):
        return torch.ones(shape, dtype=torch.bool, device=self.device)

    def _binary(self, e: P.PhysBinary, batch: DevBatch):
        if e.op in ("AND", "OR"):
            ld, lv, _ = self.eval_expr(e.left, batch)
            rd, rv, _ = self.eval_expr(e.right, batch)
            ld = ld.to(torch.bool)
            rd = rd.to(torch.bool)
            lvv = self._ones(ld.shape) if lv is None else lv
            rvv = self._ones(rd.shape) if rv is None else rv
            if e.op == "AND":
                val = ld & rd
                valid = (lvv & rvv) | (lvv & ~ld) | (rvv & ~rd)
                return val & valid, (None if (lv is None and rv is None) else valid), None
            val = ld | rd
            valid = (lvv & rvv) | (lvv & ld) | (rvv & rd)
            return val, (None if (lv is None and rv is None) else valid), None

        ld, lv, ldict = self.eval_expr(e.left, batch)
        rd, rv, rdict = self.eval_expr(e.right, batch)
        valid = _and_valid(lv, rv)

        if e.left.dtype is DType.STRING or e.right.dtype is DType.STRING:
            if e.op == "||":
                raise DeviceUnsupported("string concatenation on device")
            (ld, rd), _ = _onto_union([(ld, ldict), (rd, rdict)], self.device)
            return _cmp(e.op, ld, rd), valid, None

        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            return _cmp(e.op, ld, rd), valid, None

        out = torch_dtype(e.dtype.numpy_dtype)
        if e.op == "+":
            return ld.to(out) + rd.to(out), valid, None
        if e.op == "-":
            return ld.to(out) - rd.to(out), valid, None
        if e.op == "*":
            return ld.to(out) * rd.to(out), valid, None
        if e.op == "/":
            nonzero = rd != 0
            valid = nonzero if valid is None else (valid & nonzero)
            safe = torch.where(nonzero, rd, 1)
            if not out.is_floating_point:
                # integer division truncating toward zero (executor.rs:434)
                return (torch.div(ld.to(torch.int64), safe.to(torch.int64),
                                  rounding_mode="trunc"), valid, None)
            return ld.to(torch.float64) / safe.to(torch.float64), valid, None
        if e.op == "%":
            nonzero = rd != 0
            valid = nonzero if valid is None else (valid & nonzero)
            safe = torch.where(nonzero, rd, 1)
            if not out.is_floating_point:
                # C/Rust remainder semantics (sign of the dividend)
                return torch.fmod(ld, safe), valid, None
            return (torch.where(nonzero, ld - torch.trunc(ld / safe) * safe, 0.0),
                    valid, None)
        raise DeviceUnsupported(e.op)

    def _lut(self, lut: np.ndarray, codes):
        """Look host-side per-dictionary-code values up for device codes."""
        t = torch.as_tensor(lut, device=self.device)
        return t[torch.clamp(codes, 0, len(lut) - 1)]

    def _in_list(self, e: P.PhysInList, batch: DevBatch):
        data, valid, dictionary = self.eval_expr(e.operand, batch)
        if e.operand.dtype is DType.STRING:
            lut = np.isin(np.asarray(dictionary, dtype=str),
                          [str(v) for v in e.values])
            mask = self._lut(lut, data)
        else:
            mask = torch.zeros(data.shape, dtype=torch.bool, device=self.device)
            for v in e.values:
                if v is None:
                    continue
                mask = mask | (data == v)
        if e.negated:
            mask = ~mask
        return mask, valid, None

    def _case(self, e: P.PhysCase, batch: DevBatch):
        n = batch.capacity
        out = torch_dtype(e.dtype.numpy_dtype)
        result = torch.zeros(n, dtype=out, device=self.device)
        out_valid = torch.zeros(n, dtype=torch.bool, device=self.device)
        decided = torch.zeros(n, dtype=torch.bool, device=self.device)
        conds = [self.eval_expr(cond, batch) for cond, _ in e.branches]
        values = [self.eval_expr(val, batch) for _, val in e.branches]
        if e.default is not None:
            values.append(self.eval_expr(e.default, batch))
        dictionary = None
        if e.dtype is DType.STRING:
            # each string branch carries its own dictionary
            datas, dictionary = _onto_union(
                [(vd, d) for vd, _, d in values], self.device)
            values = [(vd, vv, d) for vd, (_, vv, d) in zip(datas, values)]
        for (cd, cv, _), (vd, vv, _) in zip(conds, values):
            cmask = cd.to(torch.bool) & (~decided)
            if cv is not None:
                cmask = cmask & cv
            result = torch.where(cmask, vd.to(out), result)
            out_valid = torch.where(cmask, self._ones(n) if vv is None else vv,
                                    out_valid)
            decided = decided | cmask
        if e.default is not None:
            vd, vv, _ = values[-1]
            result = torch.where(decided, result, vd.to(out))
            out_valid = torch.where(decided, out_valid,
                                    self._ones(n) if vv is None else vv)
        return result, out_valid, dictionary

    def _func(self, e: P.PhysFunc, batch: DevBatch):
        if e.func == "date_part":
            part, ts = e.args
            if not isinstance(part, P.PhysLiteral):
                raise DeviceUnsupported("date_part with a computed part")
            data, valid, _ = self.eval_expr(ts, batch)
            return _date_part(str(part.value).lower(), data), valid, None
        if e.func == "like":
            target, pat = e.args
            if not isinstance(pat, P.PhysLiteral):
                raise DeviceUnsupported("LIKE with a computed pattern")
            data, valid, dictionary = self.eval_expr(target, batch)
            regex = re.compile(
                "^" + re.escape(str(pat.value)).replace("%", ".*").replace("_", ".") + "$",
                re.DOTALL,
            )
            lut = np.array([bool(regex.match(str(s))) for s in np.asarray(dictionary)])
            return self._lut(lut, data), valid, None
        if e.func == "cast":
            data, valid, _ = self.eval_expr(e.args[0], batch)
            return data.to(torch_dtype(e.dtype.numpy_dtype)), valid, None
        if e.func == "abs":
            data, valid, _ = self.eval_expr(e.args[0], batch)
            return torch.abs(data), valid, None
        if e.func in ("round", "floor", "ceil", "sqrt", "ln", "log", "exp"):
            data, valid, _ = self.eval_expr(e.args[0], batch)
            fn = {"round": torch.round, "floor": torch.floor, "ceil": torch.ceil,
                  "sqrt": torch.sqrt, "ln": torch.log, "log": torch.log10,
                  "exp": torch.exp}[e.func]
            return (fn(data.to(torch.float64)).to(torch_dtype(e.dtype.numpy_dtype)),
                    valid, None)
        if e.func == "coalesce":
            out = torch_dtype(e.dtype.numpy_dtype)
            parts = [self.eval_expr(a, batch) for a in e.args]
            data = parts[0][0].to(out)
            valid = parts[0][1]
            vv = self._ones(data.shape) if valid is None else valid
            for d2, v2, _ in parts[1:]:
                v2v = self._ones(data.shape) if v2 is None else v2
                take = (~vv) & v2v
                data = torch.where(take, d2.to(out), data)
                vv = vv | v2v
            return data, vv, None
        if e.func == "power":
            a, av, _ = self.eval_expr(e.args[0], batch)
            b, bv, _ = self.eval_expr(e.args[1], batch)
            return (torch.pow(a.to(torch.float64), b.to(torch.float64)),
                    _and_valid(av, bv), None)
        raise DeviceUnsupported(e.func)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cmp(op, ld, rd):
    return {"=": torch.eq, "!=": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op](ld, rd)


def _onto_union(cols, device):
    """String code columns, given as (codes, dictionary) pairs, re-coded onto
    the sorted union of their dictionaries: (code tensors, dictionary).  A
    column without a dictionary, or with an empty one (a NULL literal), keeps
    its codes; its rows are invalid.  Columns that share one dictionary keep
    their codes and that dictionary."""
    first = cols[0][1]
    if all(_dicts_equal(d, first) for _, d in cols[1:]):
        return [c for c, _ in cols], first
    union = np.unique(np.concatenate([np.asarray(d, dtype=str)
                                      for _, d in cols if d is not None]))
    out = []
    for codes, d in cols:
        if d is not None and len(d):
            lut = torch.as_tensor(
                np.searchsorted(union, np.asarray(d, dtype=str)), device=device)
            codes = lut[torch.clamp(codes, 0, len(d) - 1)]
        out.append(codes)
    return out, union.astype(object)


def _gather_col(c: DevCol, idx, out_valid) -> DevCol:
    """Gather a join-side column by row indices; -1 marks the null-padded
    side of an outer join.  int32-narrowable columns are gathered in int32
    (half the bytes of the random gather) and widen at the host boundary."""
    nb = c.data.shape[0]
    pad = idx < 0
    safe = torch.clamp(idx, 0, nb - 1)
    src = c.data
    if c.int32_ok and src.dtype == torch.int64 and (
            c.narrow is not None or idx.shape[0] * 256 >= nb):
        src = c.as_int32()
    valid = ~pad if c.validity is None else (c.validity[safe] & ~pad)
    return DevCol(src[safe], valid, c.dictionary, c.int32_ok, c.value_range)


def _masked_minmax(func: str, data, ok, acc):
    """MIN or MAX of ``data`` where ``ok``, with the accumulator's identity
    elsewhere (the caller masks the empty case)."""
    if np.dtype(acc).kind == "f":
        ident = np.inf if func == "min" else -np.inf
    else:
        ident = (np.iinfo(np.int64).max if func == "min"
                 else np.iinfo(np.int64).min)
    masked = torch.where(ok, data, torch.tensor(ident, dtype=data.dtype,
                                                device=data.device))
    return masked.min() if func == "min" else masked.max()


def _post_cols(post, results, specs) -> List[DevCol]:
    """Aggregate output columns of the group-join paths: counts, AVG as a
    float sum over a count, and plain results."""
    cols = []
    for kind, i, j in post:
        if kind == "count":
            cols.append(DevCol(results[i][0], None))
        elif kind == "avg":
            num, den = results[i][0], results[j][0]
            avg = torch.where(den > 0, num / torch.clamp(
                den.to(torch.float64), min=1.0), 0.0)
            cols.append(DevCol(avg, den > 0))
        else:
            data, valid = results[i]
            cols.append(DevCol(data, valid, specs[i].get("dictionary")))
    return cols


def _subst_cols(expr: P.PhysExpr, mapping) -> P.PhysExpr:
    """Rewrite ColumnRefs per ``mapping`` (index -> replacement ColumnRef)."""
    if isinstance(expr, P.ColumnRef):
        return mapping.get(expr.index, expr)
    if isinstance(expr, P.PhysBinary):
        return dataclasses.replace(expr, left=_subst_cols(expr.left, mapping),
                                   right=_subst_cols(expr.right, mapping))
    if isinstance(expr, (P.PhysUnary, P.PhysIsNull, P.PhysInList)):
        return dataclasses.replace(
            expr, operand=_subst_cols(expr.operand, mapping))
    if isinstance(expr, P.PhysCase):
        return dataclasses.replace(
            expr,
            branches=tuple((_subst_cols(c, mapping), _subst_cols(v, mapping))
                           for c, v in expr.branches),
            default=None if expr.default is None
            else _subst_cols(expr.default, mapping))
    if isinstance(expr, P.PhysFunc):
        return dataclasses.replace(
            expr, args=tuple(_subst_cols(a, mapping) for a in expr.args))
    return expr


def _expr_col_indices(expr: P.PhysExpr) -> List[int]:
    """All ColumnRef indices referenced by a physical expression."""
    out: List[int] = []

    def walk(e):
        if isinstance(e, P.ColumnRef):
            out.append(e.index)
        elif isinstance(e, P.PhysBinary):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, (P.PhysUnary, P.PhysIsNull, P.PhysInList)):
            walk(e.operand)
        elif isinstance(e, P.PhysCase):
            for cond, val in e.branches:
                walk(cond)
                walk(val)
            if e.default is not None:
                walk(e.default)
        elif isinstance(e, P.PhysFunc):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def _decode_key(code, null, dtype: DType, dictionary) -> DevCol:
    # key operands keep their own space (float keys stay f64); int32 codes
    # stay int32 and widen at the host boundary
    data = code.to(torch.bool) if dtype is DType.BOOL else code
    return DevCol(data, None if null is None else ~null, dictionary,
                  int32_ok=code.dtype == torch.int32)


_DAY_MS = 86_400_000


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _date_part(part: str, ms):
    """Calendar decomposition of epoch-ms (civil-from-days, branch-free)."""
    days = _floordiv(ms, _DAY_MS)
    ms_in_day = ms - days * _DAY_MS
    if part == "hour":
        return _floordiv(ms_in_day, 3_600_000).to(torch.int64)
    if part == "minute":
        return (_floordiv(ms_in_day, 60_000) % 60).to(torch.int64)
    if part == "second":
        return (_floordiv(ms_in_day, 1000) % 60).to(torch.int64)
    if part in ("dow", "dayofweek"):
        return ((days + 4) % 7).to(torch.int64)
    # civil-from-days (Hinnant's algorithm, integer-only)
    z = days + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + torch.where(m <= 2, 1, 0)
    if part == "year":
        return y.to(torch.int64)
    if part == "month":
        return m.to(torch.int64)
    if part == "day":
        return d.to(torch.int64)
    raise DeviceUnsupported(f"date_part({part!r})")
