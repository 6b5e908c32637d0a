"""Device executor on PyTorch.

Port of ``gpu_olap_tpu/executor/device.py`` for the single-table path:
scan, filter, project, aggregate (global and GROUP BY), sort, limit and
distinct.  The physical plan is interpreted eagerly, once per query, on
tensors of one explicit device; there is no trace or compile cache.

What the JAX executor does and this one keeps:

* filters carry row-validity masks instead of compacting; the host boundary
  compacts once;
* aggregation outputs are padded to ``max_groups`` with a group count, and a
  group count above the capacity grows it by 4x and reruns the plan (the
  overflow -> regrow loop);
* zone-map statistics (``int32_ok``, value ranges) and the int32 shadow
  columns decide where the int32 kernels may run;
* string expressions are lowered against the host-side sorted dictionaries.

What it drops, because it served XLA's static shapes or the TPU: the
shape-bucket padding of tables (tables keep their row count), the int32
narrowing of results for the host link, and int32 arithmetic on
interval-proven expressions.  Joins, UNION and out-of-core scans raise
:class:`DeviceUnsupported`, and the engine answers them on the CPU oracle.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpu_olap_tpu.config import EngineConfig
from gpu_olap_tpu.interop.columnar import Column, ColumnBatch, DType, Schema
from gpu_olap_tpu.plan import physical as P
from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS, Timer
from gpu_olap_tpu.utils.tracing import get_logger

from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops import sort as sort_ops
from ..ops.dtypes import key_code, order_code, torch_dtype

logger = get_logger(__name__)

_LO32 = int(np.iinfo(np.int32).min) + 4
_HI32 = int(np.iinfo(np.int32).max) - 4


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
    }


class DeviceExecutor:
    def __init__(self, catalog, config: EngineConfig, device: torch.device):
        self.catalog = catalog
        self.config = config
        self.device = device
        # device-resident table cache: name -> (catalog version, entry)
        self._table_cache: Dict[str, tuple] = {}
        # per-plan-node capacity overrides after overflow (node path -> rows)
        self._cap_override: Dict[tuple, int] = {}
        self.last_backend = f"torch-{device.type}"

    # ------------------------------------------------------------------
    # public entry
    # ------------------------------------------------------------------
    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        if self._has_uncached_scan(plan):
            raise DeviceUnsupported("out-of-core scan (streaming is not ported)")
        tables = self._device_tables(plan)
        rows_in = sum(t["num_rows"] for t in tables.values())
        bytes_in = sum(
            t["capacity"] * sum(a[0].element_size() for a in t["arrays"])
            for t in tables.values()
        )
        for _attempt in range(8):
            meta = {"flag_names": [], "capacities": {}, "out_dicts": None,
                    "out_schema": None}
            interp = _Interpreter(self.config, tables, self._cap_override,
                                  meta, self.device)
            with Timer() as t_exec:
                out = interp.run(plan)
                flags = {k: bool(v) for k, v in
                         zip(meta["flag_names"], out["flags"])}
                overflowed = [k for k, v in flags.items() if v]
                out["count"] = int(out["count"])  # waits for the device
            if not overflowed:
                batch = self._to_host(out, meta)
                GLOBAL_METRICS.record_span(
                    "device_execute", t_exec.seconds, rows_in=rows_in,
                    rows_out=batch.num_rows, bytes_accessed=bytes_in)
                return batch
            # grow capacities and rerun (bounded geometric growth)
            for key in overflowed:
                cur = meta["capacities"][key]
                self._cap_override[key] = int(cur * 4)
                logger.warning("device capacity overflow at %s: growing %d -> %d",
                               key, cur, self._cap_override[key])
        raise RuntimeError("aggregate capacity kept overflowing after 8 growths")

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
            }
            self._table_cache[name] = (ver, entry)
            out[name] = entry
        return out

    # ------------------------------------------------------------------
    def _to_host(self, out, meta) -> ColumnBatch:
        schema: Schema = meta["out_schema"]
        n = int(out["count"])
        cols = []
        for (data, validity), dictionary, field in zip(
                out["cols"], meta["out_dicts"], schema):
            d = data[:n].cpu().numpy()
            v = None if validity is None else validity[:n].cpu().numpy()
            if field.dtype is DType.BOOL and d.dtype != np.bool_:
                d = d.astype(np.bool_)
            elif d.dtype == np.int32 and field.dtype.numpy_dtype == np.int64:
                d = d.astype(np.int64)  # int32 key/min/max lanes widen here
            if v is not None and v.all():
                # all-valid masks drop like the oracle's (_maybe_validity):
                # downstream formatters floatify int columns that carry ANY
                # validity mask, drifting dtypes vs the CPU backend
                v = None
            cols.append(Column(d, v, dictionary))
        return ColumnBatch(schema, cols, n)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


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
        if isinstance(plan, P.TpuTableScan):
            return self._scan(plan)
        if isinstance(plan, P.TpuFilter):
            return self._filter(plan, path)
        if isinstance(plan, P.TpuProjection):
            return self._project(plan, path)
        if isinstance(plan, P.TpuAggregate):
            return self._aggregate(plan, path)
        if isinstance(plan, P.TpuSort):
            return self._sort(plan, path)
        if isinstance(plan, P.TpuLimit):
            return self._limit(plan, path)
        if isinstance(plan, P.TpuDistinct):
            return self._distinct(plan, path)
        # joins and UNION are not ported yet
        raise DeviceUnsupported(type(plan).__name__)

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
            return fast
        batch = self.exec(plan.input, path + (0,))
        keys = []
        key_meta = []
        for g in plan.group_exprs:
            data, valid, dictionary = self.eval_expr(g, batch)
            code, null = key_code(data, valid, _np_kind(g.dtype))
            if valid is None and _np_kind(g.dtype) != "f":
                null = None  # statically null-free: drops a sort operand
            if self._int32_ok(g, batch) and code.dtype == torch.int64:
                code = self._narrow32(g, batch, data)  # zone-map narrow path
            keys.append((code, null))
            key_meta.append((g.dtype, dictionary))

        keys, packed_spec = self._pack_keys(plan.group_exprs, batch, keys,
                                            key_meta)

        cap_key = ("agg", path)
        if plan.group_exprs:
            max_groups = self.cap_override.get(
                cap_key, min(self.config.max_groups, batch.capacity)
            )
        else:
            max_groups = 1
        self.meta["capacities"][cap_key] = max_groups

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
            self._push_flag(cap_key, overflow)

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

        out_cap = max_groups if plan.group_exprs else 1
        if plan.group_exprs:
            row_valid = torch.arange(out_cap, device=self.device) < n_groups
            return DevBatch(plan.schema, cols, out_cap, row_valid,
                            prefix_count=n_groups)
        return DevBatch(plan.schema, cols, out_cap, None)

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
        row_valid = torch.arange(max_groups, device=self.device) < n_groups
        return DevBatch(plan.schema, cols, max_groups, row_valid,
                        prefix_count=n_groups)

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
            ld, rd = _align_string_codes(ld, ldict, rd, rdict)
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
        for cond, val in e.branches:
            cd, cv, _ = self.eval_expr(cond, batch)
            cmask = cd.to(torch.bool) & (~decided)
            if cv is not None:
                cmask = cmask & cv
            vd, vv, _ = self.eval_expr(val, batch)
            result = torch.where(cmask, vd.to(out), result)
            out_valid = torch.where(cmask, self._ones(n) if vv is None else vv,
                                    out_valid)
            decided = decided | cmask
        if e.default is not None:
            vd, vv, _ = self.eval_expr(e.default, batch)
            result = torch.where(decided, result, vd.to(out))
            out_valid = torch.where(decided, out_valid,
                                    self._ones(n) if vv is None else vv)
        return result, out_valid, None

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


def _align_string_codes(ld, ldict, rd, rdict):
    """Remap two string-code columns into a shared sorted dictionary space."""
    if _dicts_equal(ldict, rdict):
        return ld, rd
    union = np.unique(np.concatenate([
        np.asarray(ldict, dtype=str), np.asarray(rdict, dtype=str)
    ]))
    lmap = torch.as_tensor(np.searchsorted(union, np.asarray(ldict, dtype=str)),
                           device=ld.device)
    rmap = torch.as_tensor(np.searchsorted(union, np.asarray(rdict, dtype=str)),
                           device=rd.device)
    return (lmap[torch.clamp(ld, 0, len(lmap) - 1)],
            rmap[torch.clamp(rd, 0, len(rmap) - 1)])


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
