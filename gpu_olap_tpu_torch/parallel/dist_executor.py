"""Distributed plan executor: SQL pipelines over a device mesh.

Port of ``gpu_olap_tpu/parallel/dist_executor.py``.  Tables are row-sharded
over the mesh (one block of rows per shard, zero-padded, with a row mask)
and each pipeline runs the JAX executor's ``shard_map`` program as phases
split at its collectives: local scan/filter/projection on every shard,
hash-partition shuffle, then the local join and aggregate kernels of the
port, one shard at a time.

Supported pipeline shapes (the BASELINE workload set):
  * Aggregate over (Filter|Projection)* over Scan        -- shuffle group-by
    (two-phase combiner; DISTINCT aggregates shuffle raw rows by group key;
    a global aggregate merges per-shard partials without a shuffle)
  * Aggregate over (Filter|Projection)* over an inner Join of two scan
    pipelines                                          -- shuffle join, with
    heavy probe keys broadcast (skew)
  * [Projection] [Limit] Sort (Filter|Projection)* Scan with a LIMIT
                                                       -- local top-k
Anything else raises ``NotDistributable`` and the engine takes the
single-device path.  Operators above the aggregate (HAVING / ORDER BY /
LIMIT / final projection) run on the gathered groups in the host executor.

What differs from JAX: the sharded tables stay resident per catalog version
(JAX re-uploads them per query), a shard's join output is cut to its live
prefix before the aggregation, and the combiner's MIN/MAX partials carry
their argument's kind, so float MIN/MAX stay exact (ROADMAP C).  As in JAX
(whose executor places whole host arrays and reads results back with
``np.asarray``), the engine over a mesh is single-process: a mesh over a
process group is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..executor.cpu import CpuExecutor
from ..interop.columnar import Column, ColumnBatch, DType
from ..plan import physical as P
from ..utils.metrics import GLOBAL_METRICS
from ..utils.tracing import get_logger
from ..executor.device import (DevBatch, DevCol, _decode_key, _gather_col,
                               _masked_minmax, _np_kind)
from ..ops import aggregate as agg_ops
from ..ops import filter as filter_ops
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops.dtypes import key_code, order_code, torch_dtype
from .collectives import all_gather, pany, pmax, pmin, psum
from .mesh import Mesh, shard_rows
from .shuffle import shuffle_rows
from .skew import detect_heavy_keys, recommend_capacity, split_by_heavy

logger = get_logger(__name__)


class NotDistributable(Exception):
    pass


@dataclasses.dataclass
class _ScanPipeline:
    scan: P.TpuTableScan
    middle: List[P.PhysicalPlan]  # bottom-up filters/projections


def _strip_fp(node: P.PhysicalPlan) -> P.PhysicalPlan:
    while isinstance(node, (P.TpuFilter, P.TpuProjection)):
        node = node.input
    return node


def _match_scan_pipeline(node: P.PhysicalPlan) -> _ScanPipeline:
    middle: List[P.PhysicalPlan] = []
    while isinstance(node, (P.TpuFilter, P.TpuProjection)):
        middle.append(node)
        node = node.input
    if not isinstance(node, P.TpuTableScan):
        raise NotDistributable(type(node).__name__)
    return _ScanPipeline(node, list(reversed(middle)))


@dataclasses.dataclass
class _DistPlan:
    aggregate: P.TpuAggregate
    agg_middle: List[P.PhysicalPlan]   # filters/projections between agg and join
    join: Optional[P.TpuHashJoin]
    left: Optional[_ScanPipeline]
    right: Optional[_ScanPipeline]
    single: Optional[_ScanPipeline]


def match_distributable(plan: P.PhysicalPlan) -> _DistPlan:
    if not isinstance(plan, P.TpuAggregate):
        raise NotDistributable(type(plan).__name__)
    if any(a.distinct for a in plan.aggs) and \
            isinstance(_strip_fp(plan.input), P.TpuHashJoin):
        # DISTINCT over a join output would need a second row shuffle by
        # group key after the join
        raise NotDistributable("DISTINCT aggregate over distributed join")
    middle: List[P.PhysicalPlan] = []
    node = plan.input
    while isinstance(node, (P.TpuFilter, P.TpuProjection)):
        middle.append(node)
        node = node.input
    middle = list(reversed(middle))
    if isinstance(node, P.TpuHashJoin):
        if node.join_type != "inner" or node.residual is not None:
            raise NotDistributable("non-inner or residual join")
        if len(node.left_keys) != 1:
            raise NotDistributable("multi-key distributed join")
        return _DistPlan(plan, middle, node,
                         _match_scan_pipeline(node.left),
                         _match_scan_pipeline(node.right), None)
    return _DistPlan(plan, [], None, None, None,
                     _match_scan_pipeline(plan.input))


# a shard's output of a grouped pipeline: ([(code, null)], [(data, has)],
# group_valid), every tensor padded to the pipeline's max_groups
_Groups = Tuple[list, list, torch.Tensor]


class DistributedExecutor:
    """Runs distributable plans over ``mesh``; raises NotDistributable
    otherwise.  ``interpreter_cls`` is the port's ``_Interpreter``: one
    instance per shard evaluates expressions on that shard's device."""

    def __init__(self, catalog, config: EngineConfig, interpreter_cls,
                 mesh: Mesh):
        if mesh.group is not None:
            raise ValueError(
                "the SQL engine over a mesh is single-process, as the JAX "
                "package's is: build its mesh without group= (this one "
                f"spans {mesh.world} process(es)); the parallel.dist_ops "
                "steps run over a process group")
        self.catalog = catalog
        self.config = config
        self._interp_cls = interpreter_cls
        self.mesh = mesh
        self.ndev = mesh.size
        # sharded table cache: name -> (catalog version, columns, row masks)
        self._table_cache: Dict[str, tuple] = {}

    # -- table sharding ----------------------------------------------------
    def _sharded_table(self, scan: P.TpuTableScan):
        """The scan's columns as per-shard tensors: ([(data shards,
        validity shards | None)], row-mask shards, rows per shard)."""
        name = scan.table_name
        ver = self.catalog.get_version(name)
        cached = self._table_cache.get(name)
        if cached is None or cached[0] != ver:
            self._table_cache.pop(name, None)  # free the stale copy first
            host = self.catalog.get_table_data(name).to_numpy()
            cols = []
            for f, col in zip(host.schema, host.columns):
                if f.dtype is DType.STRING:
                    cols.append(None)
                    continue
                valid = (None if col.validity is None
                         else shard_rows(self.mesh, col.validity, False))
                cols.append((shard_rows(self.mesh, col.data), valid))
            rowmask = shard_rows(self.mesh, np.ones(host.num_rows, bool), False)
            cached = (ver, cols, rowmask)
            self._table_cache[name] = cached
        _, cols, rowmask = cached
        indices = (scan.projection if scan.projection is not None
                   else range(len(cols)))
        arrays = []
        for i in indices:
            if cols[i] is None:
                raise NotDistributable("string columns in distributed pipeline")
            arrays.append(cols[i])
        return arrays, rowmask, rowmask[0].shape[0]

    def _interps(self):
        return [self._interp_cls(self.config, {}, {},
                                 {"flag_names": [], "capacities": {}}, dev)
                for dev in self.mesh.devices]

    def _scan_batches(self, sp: _ScanPipeline, interps):
        """Every shard's batch of the scan pipeline, middle applied."""
        arrays, rowmask, per_dev = self._sharded_table(sp.scan)
        batches = []
        for i, interp in enumerate(interps):
            cols = [DevCol(d[i], None if v is None else v[i], None)
                    for d, v in arrays]
            batch = DevBatch(sp.scan.schema, cols, per_dev, rowmask[i])
            batches.append(_apply_middle(interp, sp.middle, batch))
        return batches, per_dev

    # -- execution ---------------------------------------------------------
    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        try:
            dp, above = _split_above_aggregate(plan)
        except NotDistributable:
            return self._run_topk(plan)  # ORDER BY ... LIMIT pipelines
        batch = self._execute_aggregate(dp)
        if above:
            cpu = CpuExecutor(self.catalog, self.config)
            cpu.leaf_results = {id(dp.aggregate): batch}
            return cpu.execute(plan)
        return batch

    # ------------------------------------------------------------------
    def _run_topk(self, plan: P.PhysicalPlan) -> ColumnBatch:
        """``[Projection]* [Limit] Sort (F|P)* Scan`` with a LIMIT: every
        shard keeps its local top k (every global top-k row is in some
        shard's), and the gathered candidates replay through the host
        executor for the exact final order, limit and projection.  A full
        ORDER BY without LIMIT would ship every row: not distributed."""
        node = plan
        k = None
        while isinstance(node, P.TpuProjection):
            node = node.input
        if isinstance(node, P.TpuLimit):
            if node.limit is None:
                raise NotDistributable("OFFSET without LIMIT")
            k = node.offset + node.limit
            node = node.input
        if not isinstance(node, P.TpuSort):
            raise NotDistributable(type(node).__name__)
        sort = node
        if sort.limit is not None:
            k = sort.limit if k is None else min(k, sort.limit)
        if k is None:
            raise NotDistributable("full distributed sort (no LIMIT)")
        sp = _match_scan_pipeline(sort.input)
        interps = self._interps()
        batches, per_dev = self._scan_batches(sp, interps)
        k_local = max(1, min(int(k), per_dev))
        mid_schema = (sp.middle[-1].schema if sp.middle else sp.scan.schema)

        datas = [[] for _ in mid_schema]
        valids = [[] for _ in mid_schema]
        n_cand = 0
        for interp, batch in zip(interps, batches):
            keys = []
            for sk in sort.keys:
                data, valid, _ = interp.eval_expr(sk.expr, batch)
                keys.append({"codes": order_code(data, _np_kind(sk.expr.dtype)),
                             "nulls": None if valid is None else ~valid,
                             "ascending": sk.ascending,
                             "nulls_last": sk.nulls_last})
            take = sort_ops.order_by_permutation(keys, batch.row_valid,
                                                 batch.capacity)[:k_local]
            keep = batch.row_valid[take].cpu().numpy()
            n_cand += int(keep.sum())
            for j, c in enumerate(batch.cols):
                datas[j].append(c.data[take].cpu().numpy()[keep])
                valids[j].append(np.ones(int(keep.sum()), bool)
                                 if c.validity is None
                                 else c.validity[take].cpu().numpy()[keep])
        cols = []
        for d, v in zip(datas, valids):
            vv = np.concatenate(v)
            cols.append(Column(np.concatenate(d), None if vv.all() else vv))
        candidates = ColumnBatch(mid_schema, cols, n_cand)
        GLOBAL_METRICS.bump("torch_dist_topk")

        # exact final order/limit/projection over the small candidate set
        cpu = CpuExecutor(self.catalog, self.config)
        cpu.leaf_results = {id(sort.input): candidates}
        return cpu.execute(plan)

    def _execute_aggregate(self, dp: _DistPlan) -> ColumnBatch:
        if dp.join is None:
            return self._run_groupby_pipeline(dp)
        return self._run_join_pipeline(dp)

    # ------------------------------------------------------------------
    def _run_groupby_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Two-phase GROUP BY (combiner): local pre-aggregation, a shuffle
        of partial group rows only, then the merge aggregation.  Shuffle
        traffic is O(groups), and a hot group key costs one partial row per
        shard whatever its row count."""
        agg = dp.aggregate
        if any(a.distinct for a in agg.aggs):
            return self._run_distinct_groupby(dp)
        if not agg.group_exprs:
            return self._run_global_pipeline(dp)
        interps = self._interps()
        batches, per_dev = self._scan_batches(dp.single, interps)
        key_pairs = [_group_keys(interp, agg, b)
                     for interp, b in zip(interps, batches)]
        ndev = self.ndev
        max_groups = min(self.config.max_groups, per_dev * ndev, 1 << 20)
        part_cap = max(max_groups // max(ndev, 1) * 2, 1024)
        for _attempt in range(4):
            local = [_local_partials(interp, agg, kp, b, b.row_valid,
                                     max_groups)
                     for interp, kp, b in zip(interps, key_pairs, batches)]
            groups, overflow = _merge_partials(self.mesh, agg, local,
                                               max_groups, part_cap)
            if not bool(overflow):
                GLOBAL_METRICS.bump("torch_dist_groupby")
                return _gather_groups(agg, groups)
            part_cap *= 4
            max_groups = min(max_groups * 4, 1 << 22)
            logger.warning("distributed groupby overflow; retrying with "
                           "max_groups=%d part_cap=%d", max_groups, part_cap)
        raise NotDistributable("distributed groupby kept overflowing")

    # ------------------------------------------------------------------
    def _run_distinct_groupby(self, dp: _DistPlan) -> ColumnBatch:
        """DISTINCT aggregates, exact: raw rows shuffle by the group key's
        hash (or by the distinct argument for a global aggregate), so each
        group (or distinct value) lives on one shard and the local
        aggregation is exact.  Shuffle traffic is O(rows)."""
        sp = dp.single
        agg = dp.aggregate
        grouped = bool(agg.group_exprs)
        if not grouped:
            # all distinct arguments must be colocated by ONE shuffle key
            dargs = [a.arg for a in agg.aggs if a.distinct]
            if any(a is None for a in dargs) or \
                    len({repr(a) for a in dargs}) != 1:
                raise NotDistributable(
                    "global DISTINCT aggregates need one common argument")
            dist_arg = dargs[0]
        if not grouped and any(a.func == "avg" for a in agg.aggs):
            raise NotDistributable("global AVG(DISTINCT) merge")
        interps = self._interps()
        batches, per_dev = self._scan_batches(sp, interps)
        ndev = self.ndev
        part_expr = agg.group_exprs[0] if grouped else dist_arg

        parts, lanes, row_valid = [], [], []
        for interp, batch in zip(interps, batches):
            d, v, _ = interp.eval_expr(part_expr, batch)
            parts.append(_partition_key(key_code(d, v,
                                                 _np_kind(part_expr.dtype))))
            shard_lanes = []
            for c in batch.cols:
                shard_lanes.append(c.data)
                shard_lanes.append(_ones_if_none(c.validity, c.data.shape[0],
                                                 c.data.device))
            lanes.append(shard_lanes)
            row_valid.append(batch.row_valid)

        shuffle_cap = max(-(-per_dev * 2 // ndev), 128)
        if isinstance(part_expr, P.ColumnRef) and \
                _np_kind(part_expr.dtype) == "i":
            # size the first pass from the partition column's real
            # destination histogram (a host replica of partition_of)
            host = self.catalog.get_table_data(sp.scan.table_name).to_numpy()
            ci = (part_expr.index if sp.scan.projection is None
                  else sp.scan.projection[part_expr.index])
            hist = np_partition_hist(np.asarray(host.columns[ci].data), ndev)
            shuffle_cap = max(shuffle_cap,
                              recommend_capacity(hist, ndev, headroom=1.5))
        max_groups = min(self.config.max_groups, 1 << 20)
        for _attempt in range(4):
            groups, overflow = self._distinct_attempt(
                interps, agg, batches, parts, lanes, row_valid, grouped,
                shuffle_cap, max_groups)
            if not bool(overflow):
                GLOBAL_METRICS.bump("torch_dist_distinct")
                return _gather_groups(agg, groups)
            shuffle_cap *= 2
            max_groups = min(max_groups * 4, 1 << 22)
            logger.warning("distributed distinct overflow; retrying with "
                           "shuffle_cap=%d max_groups=%d",
                           shuffle_cap, max_groups)
        raise NotDistributable("distributed distinct kept overflowing")

    def _distinct_attempt(self, interps, agg, batches, parts, lanes,
                          row_valid, grouped, shuffle_cap, max_groups):
        ndev = self.ndev
        rk, shipped, svalid, sh_of = shuffle_rows(self.mesh, parts, lanes,
                                                  row_valid, shuffle_cap)
        mg = max_groups if grouped else 1
        out, flags = [], []
        for i, (interp, dev) in enumerate(zip(interps, self.mesh.devices)):
            it = iter(shipped[i])
            cols2 = [DevCol(next(it), next(it).to(torch.bool), None)
                     for _c in batches[i].cols]
            b2 = DevBatch(batches[i].schema, cols2, ndev * shuffle_cap,
                          svalid[i])
            key_pairs = _group_keys(interp, agg, b2)
            specs = []
            for a in agg.aggs:
                if a.arg is None:
                    specs.append({"func": a.func, "values": None,
                                  "valid": None, "distinct": a.distinct,
                                  "acc_dtype": np.int64})
                    continue
                d, v, _ = interp.eval_expr(a.arg, b2)
                specs.append({
                    "func": a.func, "values": d, "valid": v,
                    "distinct": a.distinct,
                    "acc_dtype": (np.float64 if a.func == "avg"
                                  else a.out_dtype.numpy_dtype),
                    "np_kind": _np_kind(a.arg.dtype)})
            codes, results, n_groups, g_of = agg_ops.groupby_aggregate(
                key_pairs, svalid[i], specs, mg, n_rows=ndev * shuffle_cap,
                device=dev)
            codes = [(c, _zeros_if_none(n, c.shape[0], dev)) for c, n in codes]
            results = [(d, _ones_if_none(h, d.shape[0], dev))
                       for d, h in results]
            out.append((codes, results,
                        torch.arange(mg, device=dev) < n_groups))
            flags.append(sh_of[i] | g_of)
        overflow = pany(self.mesh, flags)
        if grouped:
            return out, overflow
        # merge the per-shard global partials: rows were shuffled by the
        # distinct argument, so distinct count/sum partials are over
        # disjoint value sets
        merged = []
        for j, a in enumerate(agg.aggs):
            datas = [o[1][j][0] for o in out]
            hs = [o[1][j][1] for o in out]
            anyh = pany(self.mesh, hs)
            if a.func == "count":
                s = psum(self.mesh, datas)
                merged.append((s, torch.ones(s.shape, dtype=torch.bool,
                                             device=s.device)))
            elif a.func == "sum":
                merged.append((psum(self.mesh, [
                    torch.where(h, d, 0) for d, h in zip(datas, hs)]), anyh))
            elif a.func in ("min", "max"):
                ident = _ident_for(datas[0].dtype, a.func == "min")
                red = pmin if a.func == "min" else pmax
                merged.append((red(self.mesh, [
                    torch.where(h, d, ident) for d, h in zip(datas, hs)]),
                    anyh))
            else:
                # AVG is finalized locally and not mergeable (gated above)
                raise NotDistributable("avg merge")
        dev0 = self.mesh.devices[0]
        return [([], merged, torch.ones(1, dtype=torch.bool, device=dev0))], \
            overflow

    # ------------------------------------------------------------------
    def _run_global_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Global aggregate (no GROUP BY): per-shard partials merged by
        psum / pmin / pmax, no shuffle."""
        agg = dp.aggregate
        interps = self._interps()
        batches, _ = self._scan_batches(dp.single, interps)
        mesh = self.mesh
        rvs = [_ones_if_none(b.row_valid, b.capacity, interp.device)
               for interp, b in zip(interps, batches)]
        cols = []
        for a in agg.aggs:
            if a.arg is None:
                cnt = psum(mesh, [rv.sum(dtype=torch.int64) for rv in rvs])
                cols.append(Column(cnt.reshape(1).cpu().numpy(), None))
                continue
            acc = torch_dtype(a.out_dtype.numpy_dtype)
            args = [interp.eval_expr(a.arg, b)[:2]
                    for interp, b in zip(interps, batches)]
            valids = [rv if v is None else (rv & v)
                      for rv, (_d, v) in zip(rvs, args)]
            cnt = psum(mesh, [v.sum(dtype=torch.int64) for v in valids])
            if a.func == "count":
                cols.append(Column(cnt.reshape(1).cpu().numpy(), None))
                continue
            if a.func == "sum":
                out = psum(mesh, [torch.where(v, d.to(acc), 0).sum(dtype=acc)
                                  for (d, _), v in zip(args, valids)])
            elif a.func == "avg":
                s = psum(mesh, [torch.where(v, d.to(torch.float64), 0.0).sum()
                                for (d, _), v in zip(args, valids)])
                out = s / torch.clamp(cnt, min=1)
            elif a.func in ("min", "max"):
                red = pmin if a.func == "min" else pmax
                out = torch.where(cnt > 0, red(mesh, [
                    _masked_minmax(a.func, d.to(acc), v,
                                   a.out_dtype.numpy_dtype)
                    for (d, _), v in zip(args, valids)]), 0)
            else:
                raise NotDistributable(a.func)
            has = bool(cnt > 0)
            cols.append(Column(out.reshape(1).cpu().numpy(),
                               None if has else np.zeros(1, bool)))
        GLOBAL_METRICS.bump("torch_dist_global")
        return ColumnBatch(agg.schema, cols, 1)

    # ------------------------------------------------------------------
    def _detect_join_skew(self, dp: _DistPlan, l_per_dev: int) -> np.ndarray:
        """Host-side heavy-hitter detection on the probe-side join key
        (BASELINE config 5, Zipfian keys): heavy key codes (np.int64,
        possibly empty).  Only plain integer column keys under filter-only
        middles are sampled; other shapes skip skew handling (broadcasting
        keys is an optimization, never needed for correctness)."""
        key = dp.join.left_keys[0]
        if not isinstance(key, P.ColumnRef):
            return np.zeros(0, np.int64)
        if any(not isinstance(m, P.TpuFilter) for m in dp.left.middle):
            return np.zeros(0, np.int64)
        host = self.catalog.get_table_data(dp.left.scan.table_name).to_numpy()
        cat_idx = (key.index if dp.left.scan.projection is None
                   else dp.left.scan.projection[key.index])
        col = np.asarray(host.columns[cat_idx].data)
        if col.dtype.kind not in "iu":
            return np.zeros(0, np.int64)
        stride = max(1, col.shape[0] // 1_000_000)
        sample = col[::stride]
        # heavy = a key whose full-table probe mass exceeds half a shard's
        # uniform share (it would pile onto one shard's shuffle bucket)
        rate = sample.shape[0] / max(col.shape[0], 1)
        thresh = max(1, int(max(256, l_per_dev // 2) * rate))
        heavy = detect_heavy_keys(sample, row_threshold=thresh)
        if heavy.size:
            logger.info("join skew: %d heavy probe keys detected", heavy.size)
        return heavy

    def _run_join_pipeline(self, dp: _DistPlan) -> ColumnBatch:
        """Distributed join + aggregation: both sides shuffled by join-key
        hash (heavy probe keys skip the shuffle: their build rows are
        broadcast with all_gather, their probe rows stay), the local
        sort-probe join on every shard, then the two-phase combiner."""
        agg = dp.aggregate
        if not agg.group_exprs:
            raise NotDistributable("distributed join + global aggregate "
                                   "(group keys required)")
        interps = self._interps()
        lbs, l_per_dev = self._scan_batches(dp.left, interps)
        rbs, r_per_dev = self._scan_batches(dp.right, interps)
        heavy_keys = self._detect_join_skew(dp, l_per_dev)
        ndev = self.ndev

        # per-(src, dst) bucket rows: each shard's rows split over ndev
        # destination buckets (~per_dev/ndev uniform; 2x headroom, heavy keys
        # go through the broadcast side, an overflow retries doubled)
        caps = {"shuffle": max(-(-max(l_per_dev, r_per_dev) * 2 // ndev), 128),
                "join": max(int((l_per_dev + r_per_dev)
                                * self.config.join_expansion), 256),
                "max_groups": min(self.config.max_groups, 1 << 20),
                "heavy_build": (max(1024, 16 * int(heavy_keys.size))
                                if heavy_keys.size else 8)}
        caps["part"] = max(caps["max_groups"] // max(ndev, 1) * 2, 1024)
        for _attempt in range(4):
            groups, overflow = self._join_attempt(interps, dp, lbs, rbs,
                                                  heavy_keys, caps)
            if not bool(overflow):
                GLOBAL_METRICS.bump("torch_dist_join")
                if heavy_keys.size:
                    GLOBAL_METRICS.bump("torch_dist_skew_broadcast")
                return _gather_groups(agg, groups)
            caps["shuffle"] *= 2
            caps["join"] *= 4
            caps["part"] *= 4
            caps["heavy_build"] *= 4
            caps["max_groups"] = min(caps["max_groups"] * 4, 1 << 22)
            logger.warning(
                "distributed join overflow; retrying with shuffle_cap=%d "
                "join_cap=%d max_groups=%d", caps["shuffle"], caps["join"],
                caps["max_groups"])
        raise NotDistributable("distributed join kept overflowing")

    def _join_attempt(self, interps, dp, lbs, rbs, heavy_keys, caps):
        agg, join = dp.aggregate, dp.join
        lb2, lkey, of1 = self._keyed_shuffle(interps, lbs, join.left_keys[0],
                                             False, heavy_keys, caps)
        rb2, rkey, of2 = self._keyed_shuffle(interps, rbs, join.right_keys[0],
                                             True, heavy_keys, caps)
        local, flags = [], []
        for i, interp in enumerate(interps):
            li, ri, out_valid, total, of3, _cnt = join_ops.inner_join(
                [lkey[i]], lb2[i].row_valid, [rkey[i]], rb2[i].row_valid,
                caps["join"])
            # the live pairs are a prefix of the match buffer: only it is
            # gathered and aggregated (one invalid slot when there is none)
            m = min(int(total), caps["join"])
            live = max(m, 1)
            li, ri = li[:live], ri[:live]
            ov = out_valid[:live]
            jcols = ([_gather_col(c, li, ov) for c in lb2[i].cols]
                     + [_gather_col(c, ri, ov) for c in rb2[i].cols])
            jb = DevBatch(join.schema, jcols, live, None if m else ov)
            jb = _apply_middle(interp, dp.agg_middle, jb)
            local.append(_local_partials(interp, agg,
                                         _group_keys(interp, agg, jb), jb,
                                         jb.row_valid, caps["max_groups"]))
            flags.append(of1[i] | of2[i] | of3)
        groups, agg_of = _merge_partials(self.mesh, agg, local,
                                         caps["max_groups"], caps["part"])
        return groups, pany(self.mesh, flags) | agg_of

    def _keyed_shuffle(self, interps, batches, key_expr, build: bool,
                       heavy_keys, caps):
        """Light rows hash-shuffle; heavy build rows are broadcast; heavy
        probe rows stay on their shard (appended after the shuffled block).
        Returns per-shard (DevBatch, (code, null), overflow)."""
        mesh = self.mesh
        parts, lanes, light_valid, heavy = [], [], [], []
        for interp, batch in zip(interps, batches):
            d, v, _ = interp.eval_expr(key_expr, batch)
            code, null = key_code(d, v, _np_kind(key_expr.dtype))
            rvalid = _ones_if_none(batch.row_valid, code.shape[0], code.device)
            shard_lanes = [code, null]
            for c in batch.cols:
                shard_lanes.append(c.data)
                shard_lanes.append(_ones_if_none(c.validity, c.data.shape[0],
                                                 c.data.device))
            lanes.append(shard_lanes)
            if heavy_keys.size:
                h = split_by_heavy(code, heavy_keys) & ~null & rvalid
                heavy.append(h)
                light_valid.append(rvalid & ~h)
            else:
                light_valid.append(rvalid)
            parts.append(_partition_key((code, null)))
        _rk, shipped, svalid, sh_of = shuffle_rows(mesh, parts, lanes,
                                                   light_valid, caps["shuffle"])
        of = list(sh_of)
        if heavy and build:
            # compact every shard's heavy build rows, replicate them to all
            extra, evalid = [], []
            cap = caps["heavy_build"]
            for i, dev in enumerate(mesh.devices):
                gidx, hcount = filter_ops.compaction_indices(heavy[i])
                slots = torch.arange(cap, device=dev)
                src = gidx[torch.clamp(slots, 0, gidx.shape[0] - 1)]
                evalid.append(slots < torch.clamp(hcount, max=gidx.shape[0]))
                of[i] = of[i] | (hcount > cap)
                extra.append([lane[src] for lane in lanes[i]])
            gathered = [all_gather(mesh, [e[j] for e in extra])
                        for j in range(len(lanes[0]))]
            evalid = all_gather(mesh, evalid)
            for i in range(mesh.size):
                shipped[i] = [torch.cat([s, g[i]])
                              for s, g in zip(shipped[i], gathered)]
                svalid[i] = torch.cat([svalid[i], evalid[i]])
        elif heavy:
            # heavy probe rows join locally against the broadcast build rows
            for i in range(mesh.size):
                shipped[i] = [torch.cat([s, lane])
                              for s, lane in zip(shipped[i], lanes[i])]
                svalid[i] = torch.cat([svalid[i], heavy[i]])
        out_batches, keys = [], []
        for i, batch in enumerate(batches):
            it = iter(shipped[i])
            code2 = next(it)
            null2 = next(it).to(torch.bool)
            cols2 = [DevCol(next(it), next(it).to(torch.bool), None)
                     for _c in batch.cols]
            out_batches.append(DevBatch(batch.schema, cols2, code2.shape[0],
                                        svalid[i]))
            keys.append((code2, null2))
        return out_batches, keys, of


# ---------------------------------------------------------------------------
# the combiner
# ---------------------------------------------------------------------------

def _group_keys(interp, agg, batch):
    """The (code, null) key pair of every group expression on ``batch``."""
    pairs = []
    for g in agg.group_exprs:
        d, v, _ = interp.eval_expr(g, batch)
        pairs.append(key_code(d, v, _np_kind(g.dtype)))
    return pairs


def _local_partial_specs(interp, agg, batch):
    """Evaluate aggregate arguments on the local batch and lay out the
    partial-aggregate columns (combiner phase 1).

    Returns (local_specs, plan); plan entries describe how to merge the
    shipped partials and finalize each output aggregate:
      ("count", j)                  -- merge: SUM of partial counts
      ("sum", j, acc)               -- merge: SUM, valid = any valid partial
      ("minmax", j, func, acc, kind)-- merge: same func over partials
      ("avg", js, jc)               -- merge: SUM f64 + SUM count, divide
    """
    specs, plan = [], []
    for a in agg.aggs:
        acc = a.out_dtype.numpy_dtype
        if a.arg is None:
            specs.append({"func": "count", "values": None, "valid": None,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("count", len(specs) - 1))
            continue
        d, v, _ = interp.eval_expr(a.arg, batch)
        if a.func == "count":
            specs.append({"func": "count", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("count", len(specs) - 1))
        elif a.func == "sum":
            specs.append({"func": "sum", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": acc})
            plan.append(("sum", len(specs) - 1, acc))
        elif a.func in ("min", "max"):
            # the argument's kind keeps float MIN/MAX exact (JAX leaves it
            # out and the sort ride truncates floats to int64)
            kind = _np_kind(a.arg.dtype)
            specs.append({"func": a.func, "values": d, "valid": v,
                          "distinct": False, "acc_dtype": acc,
                          "np_kind": kind})
            plan.append(("minmax", len(specs) - 1, a.func, acc, kind))
        elif a.func == "avg":
            specs.append({"func": "sum", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.float64})
            specs.append({"func": "count", "values": d, "valid": v,
                          "distinct": False, "acc_dtype": np.int64})
            plan.append(("avg", len(specs) - 2, len(specs) - 1))
        else:
            raise NotDistributable(a.func)
    return specs, plan


def _local_partials(interp, agg, key_pairs, batch, row_valid, max_groups):
    """Combiner phase 1 on one shard: local partial aggregation, laid out
    as the lanes to ship by the first group key's hash.  Returns (part,
    lanes, lane_valid, overflow, plan)."""
    dev = interp.device
    local_specs, plan = _local_partial_specs(interp, agg, batch)
    lg_codes, lg_results, lg_n, lg_of = agg_ops.groupby_aggregate(
        key_pairs, row_valid, local_specs, max_groups, n_rows=batch.capacity,
        device=dev)
    ship = []
    for code, null in lg_codes:
        ship.append(code)
        ship.append(_zeros_if_none(null, max_groups, dev))
    for data, has in lg_results:
        ship.append(data)
        ship.append(_ones_if_none(has, max_groups, dev))
    k0_code, k0_null = lg_codes[0]
    part = _partition_key((k0_code, _zeros_if_none(k0_null, max_groups, dev)))
    lg_valid = torch.arange(max_groups, device=dev) < lg_n
    return part, ship, lg_valid, lg_of, plan


def _merge_partials(mesh: Mesh, agg, local, max_groups, part_cap):
    """Combiner phases 2 and 3: shuffle every shard's partial group rows by
    the first key's hash, then merge them on the receiving shard.  Returns
    (per-shard groups, replicated overflow)."""
    plan = local[0][4]
    rk, shipped, rvalid, sh_of = shuffle_rows(
        mesh, [loc[0] for loc in local], [loc[1] for loc in local],
        [loc[2] for loc in local], part_cap)
    n_partials = sum(2 if e[0] == "avg" else 1 for e in plan)
    out, flags = [], []
    for i, dev in enumerate(mesh.devices):
        it = iter(shipped[i])
        keys2 = [(next(it), next(it).to(torch.bool)) for _g in agg.group_exprs]
        partials = [(next(it), next(it).to(torch.bool))
                    for _r in range(n_partials)]
        merge_specs = []
        for entry in plan:
            kind = entry[0]
            if kind == "count":
                merge_specs.append({"func": "sum",
                                    "values": partials[entry[1]][0],
                                    "valid": None, "distinct": False,
                                    "acc_dtype": np.int64})
            elif kind == "sum":
                d, h = partials[entry[1]]
                merge_specs.append({"func": "sum", "values": d, "valid": h,
                                    "distinct": False, "acc_dtype": entry[2]})
            elif kind == "minmax":
                d, h = partials[entry[1]]
                merge_specs.append({"func": entry[2], "values": d, "valid": h,
                                    "distinct": False, "acc_dtype": entry[3],
                                    "np_kind": entry[4]})
            else:  # avg
                merge_specs.append({"func": "sum",
                                    "values": partials[entry[1]][0],
                                    "valid": None, "distinct": False,
                                    "acc_dtype": np.float64})
                merge_specs.append({"func": "sum",
                                    "values": partials[entry[2]][0],
                                    "valid": None, "distinct": False,
                                    "acc_dtype": np.int64})
        mg_codes, mg_results, mg_n, mg_of = agg_ops.groupby_aggregate(
            keys2, rvalid[i], merge_specs, max_groups, n_rows=rk[i].shape[0],
            device=dev)
        results = []
        mi = 0
        for entry in plan:
            kind = entry[0]
            if kind == "count":
                results.append((mg_results[mi][0],
                                torch.ones(max_groups, dtype=torch.bool,
                                           device=dev)))
                mi += 1
            elif kind in ("sum", "minmax"):
                data, has = mg_results[mi]
                results.append((data, _ones_if_none(has, max_groups, dev)))
                mi += 1
            else:  # avg
                s = mg_results[mi][0]
                c = mg_results[mi + 1][0]
                has = c > 0
                results.append((torch.where(
                    has, s / torch.clamp(c, min=1).to(torch.float64), 0.0),
                    has))
                mi += 2
        codes = [(c, _zeros_if_none(n, max_groups, dev)) for c, n in mg_codes]
        out.append((codes, results,
                    torch.arange(max_groups, device=dev) < mg_n))
        flags.append(local[i][3] | sh_of[i] | mg_of)
    return out, pany(mesh, flags)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def np_partition_hist(col: np.ndarray, ndev: int) -> np.ndarray:
    """Host-side replica of ``ops.hashing.partition_of`` destination counts
    (MurmurHash3 finalizer over folded int64): sizes shuffle buckets from
    the real distribution instead of a uniform guess."""
    x = col.astype(np.int64, copy=False)
    u = x.astype(np.uint32) ^ (x >> np.int64(32)).astype(np.uint32)
    u = u ^ (u >> np.uint32(16))
    u = u * np.uint32(0x85EBCA6B)
    u = u ^ (u >> np.uint32(13))
    u = u * np.uint32(0xC2B2AE35)
    u = u ^ (u >> np.uint32(16))
    dest = (u % np.uint32(ndev)).astype(np.int64)
    return np.bincount(dest, minlength=ndev)


def _ident_for(dtype, is_min: bool):
    """Reduction identity for masked pmin/pmax lanes (a torch dtype)."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _partition_key(key_pair):
    """The int64 shuffle key of a (code, null) pair: floats map to ints
    consistently (not collision-free), nulls to -1."""
    code, null = key_pair
    if code.dtype == torch.float64:
        scaled = torch.where(code.abs() < 1e15, code * 4096.0, code)
        icode = scaled.to(torch.int64)
    else:
        icode = code.to(torch.int64)
    return torch.where(null, -1, icode)


def _ones_if_none(t, n: int, device):
    return torch.ones(n, dtype=torch.bool, device=device) if t is None else t


def _zeros_if_none(t, n: int, device):
    return torch.zeros(n, dtype=torch.bool, device=device) if t is None else t


def _apply_middle(interp, middle, batch):
    for op in middle:
        if isinstance(op, P.TpuFilter):
            data, valid, _ = interp.eval_expr(op.predicate, batch)
            mask = filter_ops.combine_mask(batch.row_valid, data, valid)
            batch = DevBatch(op.schema, batch.cols, batch.capacity, mask)
        else:
            ncols = []
            for e in op.exprs:
                d, v, dd = interp.eval_expr(e, batch)
                ncols.append(DevCol(d, v, dd))
            batch = DevBatch(op.schema, ncols, batch.capacity, batch.row_valid)
    return batch


def _gather_groups(agg: P.TpuAggregate, groups: List[_Groups]) -> ColumnBatch:
    """Every shard's valid groups on the host, in shard order."""
    idxs = [np.nonzero(gvalid.cpu().numpy())[0] for _c, _r, gvalid in groups]
    cols: List[Column] = []
    for gi, g in enumerate(agg.group_exprs):
        datas, valids = [], []
        for (codes, _r, _v), idx in zip(groups, idxs):
            code, null = codes[gi]
            dc = _decode_key(code, null, g.dtype, None)
            datas.append(dc.data.cpu().numpy()[idx])
            valids.append(dc.validity.cpu().numpy()[idx])
        v = np.concatenate(valids)
        cols.append(Column(np.concatenate(datas), None if v.all() else v))
    for ai, a in enumerate(agg.aggs):
        d = np.concatenate([r[ai][0].cpu().numpy()[idx]
                            for (_c, r, _v), idx in zip(groups, idxs)])
        h = np.concatenate([r[ai][1].cpu().numpy()[idx]
                            for (_c, r, _v), idx in zip(groups, idxs)])
        cols.append(Column(d, None if (h.all() or a.func == "count") else h))
    return ColumnBatch(agg.schema, cols, sum(len(i) for i in idxs))


def _split_above_aggregate(plan: P.PhysicalPlan) -> Tuple[_DistPlan, bool]:
    """Find the aggregate subtree; report whether operators sit above it."""
    if isinstance(plan, P.TpuAggregate):
        return match_distributable(plan), False
    node = plan
    while True:
        if isinstance(node, P.TpuAggregate):
            return match_distributable(node), True
        kids = node.inputs()
        if len(kids) != 1:
            raise NotDistributable(type(node).__name__)
        node = kids[0]
