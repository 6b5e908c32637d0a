"""CPU oracle executor.

The port's own copy of ``gpu_olap_tpu/executor/cpu.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

The reference executor doubles as a CPU fallback but stubs out scan/join/sort
(``executor.rs:110-155,255-265,361-370``).  Here the CPU path is a *complete and
correct* NumPy interpreter over the physical plan — it defines the engine's SQL
semantics (3-valued logic, null-skipping aggregates, null keys never joining)
and serves as the parity oracle for the TPU executor, per SURVEY.md §4.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import EngineConfig
from ..interop.columnar import Column, ColumnBatch, DType
from ..plan import physical as P
from ..utils.tracing import get_logger

logger = get_logger(__name__)


def _valid_of(col: Column) -> np.ndarray:
    if col.validity is None:
        return np.ones(len(col), dtype=bool)
    return np.asarray(col.validity)


def _maybe_validity(valid: np.ndarray) -> Optional[np.ndarray]:
    return None if valid.all() else valid


def _decode_strings(col: Column) -> np.ndarray:
    return np.asarray(col.dictionary, dtype=object)[np.clip(col.data, 0, None)]


class CpuExecutor:
    """Recursive interpreter over the physical plan (``executor.rs:37-104`` role)."""

    def __init__(self, catalog, config: EngineConfig):
        self.catalog = catalog
        self.config = config
        # pre-computed results for subtrees (used by the distributed executor
        # to run post-aggregate operators on gathered group results)
        self.leaf_results: dict = {}

    def execute(self, plan: P.PhysicalPlan) -> ColumnBatch:
        batch = self._exec(plan)
        assert len(batch.schema) == len(plan.schema)
        return batch

    # ------------------------------------------------------------------
    def _exec(self, plan: P.PhysicalPlan) -> ColumnBatch:
        pre = self.leaf_results.get(id(plan))
        if pre is not None:
            return pre
        if isinstance(plan, P.TpuTableScan):
            return self._scan(plan)
        if isinstance(plan, P.TpuFilter):
            return self._filter(plan)
        if isinstance(plan, P.TpuProjection):
            return self._project(plan)
        if isinstance(plan, P.TpuHashJoin):
            return self._join(plan)
        if isinstance(plan, P.TpuAggregate):
            return self._aggregate(plan)
        if isinstance(plan, P.TpuSort):
            return self._sort(plan)
        if isinstance(plan, P.TpuLimit):
            return self._limit(plan)
        if isinstance(plan, P.TpuDistinct):
            return self._distinct(plan)
        if isinstance(plan, P.TpuUnion):
            return self._union(plan)
        raise NotImplementedError(type(plan).__name__)

    # -- scan ----------------------------------------------------------
    def _scan(self, plan: P.TpuTableScan) -> ColumnBatch:
        batch = self.catalog.get_table_data(plan.table_name).to_numpy()
        if plan.projection is not None:
            batch = batch.select(list(plan.projection))
        return ColumnBatch(plan.schema, batch.columns, batch.num_rows)

    # -- filter --------------------------------------------------------
    def _filter(self, plan: P.TpuFilter) -> ColumnBatch:
        batch = self._exec(plan.input)
        mask_col = self.eval_expr(plan.predicate, batch)
        mask = np.asarray(mask_col.data, dtype=bool) & _valid_of(mask_col)
        return _take(batch, np.nonzero(mask)[0])

    # -- projection ----------------------------------------------------
    def _project(self, plan: P.TpuProjection) -> ColumnBatch:
        batch = self._exec(plan.input)
        cols = [self.eval_expr(e, batch) for e in plan.exprs]
        return ColumnBatch(plan.schema, cols, batch.num_rows)

    # -- join ----------------------------------------------------------
    def _join(self, plan: P.TpuHashJoin) -> ColumnBatch:
        left = self._exec(plan.left)
        right = self._exec(plan.right)

        if plan.join_type == "cross":
            li = np.repeat(np.arange(left.num_rows), right.num_rows)
            ri = np.tile(np.arange(right.num_rows), left.num_rows)
        else:
            lkeys = [self.eval_expr(k, left) for k in plan.left_keys]
            rkeys = [self.eval_expr(k, right) for k in plan.right_keys]
            li, ri = _equi_join_indices(lkeys, rkeys, plan.join_type)

        out_cols: List[Column] = []
        lvalid_pad = li < 0  # -1 marks padded (unmatched outer) rows
        rvalid_pad = ri < 0
        for c in left.columns:
            out_cols.append(_gather_with_null(c, li, lvalid_pad))
        for c in right.columns:
            out_cols.append(_gather_with_null(c, ri, rvalid_pad))
        out = ColumnBatch(plan.schema, out_cols, len(li))

        if plan.residual is not None:
            mask_col = self.eval_expr(plan.residual, out)
            mask = np.asarray(mask_col.data, dtype=bool) & _valid_of(mask_col)
            if plan.join_type == "inner":
                out = _take(out, np.nonzero(mask)[0])
            else:
                # outer joins: residual only removes matched rows, null-padded
                # rows stay (SQL semantics for ON-clause residuals are subtle;
                # we apply residual as a post-filter for inner joins only)
                out = _take(out, np.nonzero(mask | lvalid_pad | rvalid_pad)[0])
        return out

    # -- aggregate -----------------------------------------------------
    def _aggregate(self, plan: P.TpuAggregate) -> ColumnBatch:
        batch = self._exec(plan.input)
        n = batch.num_rows

        if plan.group_exprs:
            key_cols = [self.eval_expr(g, batch) for g in plan.group_exprs]
            gid, rep_idx, n_groups = _factorize(key_cols, n)
        else:
            gid = np.zeros(n, dtype=np.int64)
            rep_idx = np.zeros(1 if True else 0, dtype=np.int64)
            n_groups = 1

        cols: List[Column] = []
        # group key outputs: representative row per group
        for kc in (self.eval_expr(g, batch) for g in plan.group_exprs):
            if n == 0:
                cols.append(Column(kc.data[:0], None, kc.dictionary))
            else:
                v = None if kc.validity is None else kc.validity[rep_idx]
                cols.append(Column(kc.data[rep_idx], v, kc.dictionary))

        for spec in plan.aggs:
            cols.append(self._eval_agg(spec, batch, gid, n_groups))

        # global aggregate over empty input still yields one row
        out_rows = n_groups if (plan.group_exprs and n > 0) else (0 if plan.group_exprs else 1)
        if not plan.group_exprs and n == 0:
            # recompute aggs for the empty single group
            pass
        return ColumnBatch(plan.schema, cols, out_rows)

    def _eval_agg(self, spec: P.AggSpec, batch: ColumnBatch, gid: np.ndarray,
                  n_groups: int) -> Column:
        n = batch.num_rows
        if spec.func == "count" and spec.arg is None:
            counts = np.zeros(n_groups, dtype=np.int64)
            np.add.at(counts, gid, 1)
            return Column(counts)

        arg = self.eval_expr(spec.arg, batch)
        valid = _valid_of(arg)
        vgid = gid[valid]
        vals = np.asarray(arg.data)[valid]

        if spec.distinct:
            if len(vals):
                pairs = np.stack([vgid, vals.view(np.int64) if vals.dtype != object else vals.astype(np.int64)], axis=1) \
                    if vals.dtype != object else None
                # distinct per group: unique (gid, value) pairs
                order = np.lexsort((vals, vgid))
                sg, sv = vgid[order], vals[order]
                newflag = np.ones(len(sg), dtype=bool)
                newflag[1:] = (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1])
                vgid = sg[newflag]
                vals = sv[newflag]
            # fallthrough with deduped values

        if spec.func == "count":
            counts = np.zeros(n_groups, dtype=np.int64)
            np.add.at(counts, vgid, 1)
            return Column(counts)

        out_np = spec.out_dtype.numpy_dtype
        has_any = np.zeros(n_groups, dtype=bool)
        has_any[vgid] = True

        if spec.func == "sum":
            acc = np.zeros(n_groups, dtype=out_np)
            np.add.at(acc, vgid, vals.astype(out_np))
            return Column(acc, _maybe_validity(has_any))
        if spec.func == "avg":
            acc = np.zeros(n_groups, dtype=np.float64)
            np.add.at(acc, vgid, vals.astype(np.float64))
            cnt = np.zeros(n_groups, dtype=np.int64)
            np.add.at(cnt, vgid, 1)
            with np.errstate(invalid="ignore", divide="ignore"):
                avg = acc / cnt
            return Column(np.where(cnt > 0, avg, 0.0), _maybe_validity(cnt > 0))
        if spec.func in ("min", "max"):
            if spec.arg.dtype is DType.STRING:
                # operate on decoded strings, re-encode afterwards
                dec = np.asarray(arg.dictionary, dtype=object)[np.clip(np.asarray(arg.data), 0, None)][valid]
                if spec.distinct:
                    pass  # distinct irrelevant for min/max
                out = np.empty(n_groups, dtype=object)
                order = np.argsort(dec.astype(str), kind="stable")
                if spec.func == "max":
                    order = order[::-1]
                # last write wins -> iterate in reverse priority
                out[vgid[order[::-1]]] = dec[order[::-1]]
                from ..interop.columnar import dict_encode_strings
                safe = np.where(has_any, out, "")
                codes, dictionary, _ = dict_encode_strings(safe.astype(object))
                return Column(codes, _maybe_validity(has_any), dictionary)
            ident = (np.iinfo(np.int64).max if out_np == np.int64 else np.inf)
            if spec.func == "max":
                ident = (np.iinfo(np.int64).min if out_np == np.int64 else -np.inf)
            acc = np.full(n_groups, ident, dtype=out_np)
            if spec.func == "min":
                np.minimum.at(acc, vgid, vals.astype(out_np))
            else:
                np.maximum.at(acc, vgid, vals.astype(out_np))
            acc = np.where(has_any, acc, 0)
            return Column(acc.astype(out_np), _maybe_validity(has_any))
        raise NotImplementedError(spec.func)

    # -- sort / limit / distinct --------------------------------------
    def _sort(self, plan: P.TpuSort) -> ColumnBatch:
        batch = self._exec(plan.input)
        perm = np.arange(batch.num_rows)
        for key in reversed(plan.keys):
            col = self.eval_expr(key.expr, batch)
            codes = _sort_codes(col, key.expr.dtype)
            if not key.ascending:
                codes = -codes
            if key.nulls_last:
                codes = np.where(_valid_of(col), codes, np.iinfo(np.int64).max)
            else:
                codes = np.where(_valid_of(col), codes, np.iinfo(np.int64).min)
            order = np.argsort(codes[perm], kind="stable")
            perm = perm[order]
        if plan.limit is not None:
            perm = perm[: plan.limit]
        return _take(batch, perm)

    def _limit(self, plan: P.TpuLimit) -> ColumnBatch:
        batch = self._exec(plan.input)
        start = plan.offset
        stop = None if plan.limit is None else start + plan.limit
        return _take(batch, np.arange(batch.num_rows)[start:stop])

    def _distinct(self, plan: P.TpuDistinct) -> ColumnBatch:
        batch = self._exec(plan.input)
        _, rep_idx, _ = _factorize(list(batch.columns), batch.num_rows)
        return _take(batch, np.sort(rep_idx))

    def _union(self, plan: P.TpuUnion) -> ColumnBatch:
        """UNION ALL: concatenate children by column position (dictionaries
        re-encoded into a shared sorted union dictionary)."""
        batches = [self._exec(c) for c in plan.children]
        cols: List[Column] = []
        for i, f in enumerate(plan.schema):
            parts = [b.columns[i] for b in batches]
            if f.dtype is DType.STRING:
                datas, dictionary = _onto_union(parts)
                cols.append(Column(np.concatenate(datas),
                                   _concat_validity(parts), dictionary))
                continue
            data = np.concatenate([
                np.asarray(c.data).astype(f.dtype.numpy_dtype) for c in parts
            ])
            cols.append(Column(data, _concat_validity(parts)))
        return ColumnBatch(plan.schema, cols,
                           sum(b.num_rows for b in batches))

    # ------------------------------------------------------------------
    # Expression evaluation (returns Column of physical data + validity)
    # ------------------------------------------------------------------
    def eval_expr(self, e: P.PhysExpr, batch: ColumnBatch) -> Column:
        n = batch.num_rows
        if isinstance(e, P.ColumnRef):
            return batch.columns[e.index]
        if isinstance(e, P.PhysLiteral):
            return _broadcast_literal(e, n)
        if isinstance(e, P.PhysBinary):
            return self._eval_binary(e, batch)
        if isinstance(e, P.PhysUnary):
            operand = self.eval_expr(e.operand, batch)
            if e.op == "NOT":
                return Column(~np.asarray(operand.data, dtype=bool), operand.validity)
            if e.op == "-":
                return Column(-np.asarray(operand.data), operand.validity)
            raise NotImplementedError(e.op)
        if isinstance(e, P.PhysIsNull):
            isnull = ~_valid_of(self.eval_expr(e.operand, batch))
            return Column(~isnull if e.negated else isnull)
        if isinstance(e, P.PhysInList):
            operand = self.eval_expr(e.operand, batch)
            if e.dtype and e.operand.dtype is DType.STRING:
                dec = _decode_strings(operand)
                mask = np.isin(dec.astype(str), [str(v) for v in e.values])
            else:
                mask = np.isin(np.asarray(operand.data), list(e.values))
            if e.negated:
                mask = ~mask
            return Column(mask, operand.validity)
        if isinstance(e, P.PhysCase):
            return self._eval_case(e, batch)
        if isinstance(e, P.PhysFunc):
            return self._eval_func(e, batch)
        raise NotImplementedError(type(e).__name__)

    def _eval_binary(self, e: P.PhysBinary, batch: ColumnBatch) -> Column:
        if e.op in ("AND", "OR"):
            left = self.eval_expr(e.left, batch)
            right = self.eval_expr(e.right, batch)
            lv, rv = _valid_of(left), _valid_of(right)
            ld = np.asarray(left.data, dtype=bool)
            rd = np.asarray(right.data, dtype=bool)
            if e.op == "AND":
                val = ld & rd
                # 3VL: valid if any-definite-false or both valid
                valid = (lv & rv) | (lv & ~ld) | (rv & ~rd)
            else:
                val = ld | rd
                valid = (lv & rv) | (lv & ld) | (rv & rd)
            return Column(val & valid if e.op == "AND" else val, _maybe_validity(valid))

        left = self.eval_expr(e.left, batch)
        right = self.eval_expr(e.right, batch)
        lv, rv = _valid_of(left), _valid_of(right)
        valid = lv & rv

        # string comparison paths
        if e.left.dtype is DType.STRING or e.right.dtype is DType.STRING:
            ld = _string_side(e.left, left)
            rd = _string_side(e.right, right)
            if e.op == "||":
                vals = np.char.add(ld.astype(str), rd.astype(str)).astype(object)
                from ..interop.columnar import dict_encode_strings
                codes, dictionary, _ = dict_encode_strings(vals)
                return Column(codes, _maybe_validity(valid), dictionary)
            op = {"=": np.equal, "!=": np.not_equal, "<": np.less,
                  "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}[e.op]
            return Column(op(ld.astype(str), rd.astype(str)), _maybe_validity(valid))

        ld = np.asarray(left.data)
        rd = np.asarray(right.data)
        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            op = {"=": np.equal, "!=": np.not_equal, "<": np.less,
                  "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}[e.op]
            return Column(op(ld, rd), _maybe_validity(valid))
        out_np = e.dtype.numpy_dtype
        if e.op == "+":
            vals = ld.astype(out_np) + rd.astype(out_np)
        elif e.op == "-":
            vals = ld.astype(out_np) - rd.astype(out_np)
        elif e.op == "*":
            vals = ld.astype(out_np) * rd.astype(out_np)
        elif e.op == "/":
            if out_np == np.int64:
                safe = np.where(rd == 0, 1, rd)
                vals = (ld // safe).astype(np.int64)
                # match Rust i64 division (truncate toward zero, executor.rs:434)
                trunc = np.trunc(ld / np.where(rd == 0, 1, rd).astype(np.float64)).astype(np.int64)
                vals = trunc
                valid = valid & (rd != 0)
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    vals = ld.astype(np.float64) / rd.astype(np.float64)
                valid = valid & (rd != 0)
                vals = np.where(rd == 0, 0.0, vals)
        elif e.op == "%":
            safe = np.where(rd == 0, 1, rd)
            vals = np.fmod(ld, safe).astype(out_np)
            valid = valid & (rd != 0)
        else:
            raise NotImplementedError(e.op)
        return Column(vals, _maybe_validity(valid))

    def _eval_case(self, e: P.PhysCase, batch: ColumnBatch) -> Column:
        n = batch.num_rows
        out_valid = np.zeros(n, dtype=bool)
        decided = np.zeros(n, dtype=bool)
        out_np = e.dtype.numpy_dtype
        result = np.zeros(n, dtype=out_np)
        conds = [self.eval_expr(cond, batch) for cond, _ in e.branches]
        values = [self.eval_expr(val, batch) for _, val in e.branches]
        if e.default is not None:
            values.append(self.eval_expr(e.default, batch))
        dictionary = None
        if e.dtype is DType.STRING:
            # each string branch carries its own dictionary
            datas, dictionary = _onto_union(values)
        else:
            datas = [np.asarray(v.data) for v in values]
        for c, v, d in zip(conds, values, datas):
            cmask = np.asarray(c.data, dtype=bool) & _valid_of(c) & ~decided
            result = np.where(cmask, d.astype(out_np), result)
            out_valid = np.where(cmask, _valid_of(v), out_valid)
            decided |= cmask
        if e.default is not None:
            result = np.where(~decided, datas[-1].astype(out_np), result)
            out_valid = np.where(~decided, _valid_of(values[-1]), out_valid)
        return Column(result, _maybe_validity(out_valid), dictionary)

    def _eval_func(self, e: P.PhysFunc, batch: ColumnBatch) -> Column:
        if e.func == "date_part":
            part_lit, ts_expr = e.args
            assert isinstance(part_lit, P.PhysLiteral)
            ts = self.eval_expr(ts_expr, batch)
            ms = np.asarray(ts.data).astype("datetime64[ms]")
            part = str(part_lit.value).lower()
            if part == "year":
                vals = ms.astype("datetime64[Y]").astype(np.int64) + 1970
            elif part == "month":
                vals = ms.astype("datetime64[M]").astype(np.int64) % 12 + 1
            elif part == "day":
                vals = (ms.astype("datetime64[D]") - ms.astype("datetime64[M]").astype("datetime64[D]")).astype(np.int64) + 1
            elif part == "hour":
                vals = ms.astype("datetime64[h]").astype(np.int64) % 24
            elif part == "minute":
                vals = ms.astype("datetime64[m]").astype(np.int64) % 60
            elif part == "second":
                vals = ms.astype("datetime64[s]").astype(np.int64) % 60
            elif part in ("dow", "dayofweek"):
                vals = (ms.astype("datetime64[D]").astype(np.int64) + 4) % 7
            else:
                raise NotImplementedError(f"date_part({part!r})")
            return Column(vals.astype(np.int64), ts.validity)
        if e.func == "like":
            target = self.eval_expr(e.args[0], batch)
            pat = e.args[1]
            assert isinstance(pat, P.PhysLiteral)
            import re
            regex = re.compile(
                "^" + re.escape(str(pat.value)).replace("%", ".*").replace("_", ".") + "$",
                re.DOTALL,
            )
            dec = _decode_strings(target)
            mask = np.array([bool(regex.match(str(s))) for s in dec])
            return Column(mask, target.validity)
        if e.func == "cast":
            operand = self.eval_expr(e.args[0], batch)
            return Column(np.asarray(operand.data).astype(e.dtype.numpy_dtype), operand.validity)
        if e.func == "abs":
            operand = self.eval_expr(e.args[0], batch)
            return Column(np.abs(np.asarray(operand.data)), operand.validity)
        if e.func in ("round", "floor", "ceil", "sqrt", "ln", "log", "exp"):
            operand = self.eval_expr(e.args[0], batch)
            fn = {"round": np.round, "floor": np.floor, "ceil": np.ceil,
                  "sqrt": np.sqrt, "ln": np.log, "log": np.log10, "exp": np.exp}[e.func]
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = fn(np.asarray(operand.data).astype(np.float64))
            return Column(vals.astype(e.dtype.numpy_dtype), operand.validity)
        if e.func == "coalesce":
            cols = [self.eval_expr(a, batch) for a in e.args]
            out = np.asarray(cols[0].data).astype(e.dtype.numpy_dtype).copy()
            valid = _valid_of(cols[0]).copy()
            for c in cols[1:]:
                take = ~valid & _valid_of(c)
                out[take] = np.asarray(c.data)[take]
                valid |= _valid_of(c)
            return Column(out, _maybe_validity(valid))
        if e.func == "power":
            a = self.eval_expr(e.args[0], batch)
            b = self.eval_expr(e.args[1], batch)
            vals = np.power(np.asarray(a.data, dtype=np.float64), np.asarray(b.data, dtype=np.float64))
            return Column(vals, _maybe_validity(_valid_of(a) & _valid_of(b)))
        raise NotImplementedError(e.func)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _concat_validity(parts) -> Optional[np.ndarray]:
    if all(c.validity is None for c in parts):
        return None
    return np.concatenate([
        np.ones(len(c), dtype=bool) if c.validity is None
        else np.asarray(c.validity)
        for c in parts
    ])


def _take(batch: ColumnBatch, idx: np.ndarray) -> ColumnBatch:
    cols = []
    for c in batch.columns:
        v = None if c.validity is None else np.asarray(c.validity)[idx]
        cols.append(Column(np.asarray(c.data)[idx], v, c.dictionary))
    return ColumnBatch(batch.schema, cols, len(idx))


def _gather_with_null(col: Column, idx: np.ndarray, is_pad: np.ndarray) -> Column:
    safe = np.where(is_pad, 0, idx)
    data = np.asarray(col.data)[safe]
    valid = _valid_of(col)[safe] & ~is_pad
    return Column(data, _maybe_validity(valid), col.dictionary)


def _onto_union(cols: List[Column]):
    """String columns re-coded onto the sorted union of their dictionaries:
    (code arrays, union dictionary).  A column without a dictionary (a NULL
    literal) keeps its codes; its rows are invalid."""
    dicts = [np.asarray(c.dictionary, dtype=str) for c in cols
             if c.dictionary is not None]
    if not dicts:
        return [np.asarray(c.data) for c in cols], None
    union = np.unique(np.concatenate(dicts))
    out = []
    for c in cols:
        data = np.asarray(c.data)
        if c.dictionary is not None and len(c.dictionary):
            lut = np.searchsorted(union, np.asarray(c.dictionary, dtype=str))
            data = lut[np.clip(data, 0, len(lut) - 1)]
        out.append(data)
    return out, union.astype(object)


def _broadcast_literal(e: P.PhysLiteral, n: int) -> Column:
    if e.value is None:
        return Column(np.zeros(n, dtype=e.dtype.numpy_dtype), np.zeros(n, dtype=bool))
    if isinstance(e.value, str):
        # single-entry dictionary
        return Column(np.zeros(n, dtype=np.int64), None,
                      np.array([e.value], dtype=object))
    if isinstance(e.value, bool):
        return Column(np.full(n, e.value, dtype=np.bool_))
    if isinstance(e.value, int):
        return Column(np.full(n, e.value, dtype=np.int64))
    return Column(np.full(n, e.value, dtype=np.float64))


def _string_side(expr: P.PhysExpr, col: Column) -> np.ndarray:
    if col.dictionary is not None:
        return _decode_strings(col)
    return np.asarray(col.data).astype(str)


def _key_code_column(col: Column) -> np.ndarray:
    """Map a key column to int64 codes where null -> INT64_MIN sentinel."""
    data = np.asarray(col.data)
    if data.dtype == np.float64:
        # treat float keys by bit pattern (exact equality)
        codes = data.view(np.int64)
        # normalize -0.0 to 0.0
        codes = np.where(data == 0.0, np.float64(0.0).view(np.int64) * np.ones_like(codes), codes)
    elif data.dtype == np.bool_:
        codes = data.astype(np.int64)
    else:
        codes = data.astype(np.int64)
    valid = _valid_of(col)
    return np.where(valid, codes, np.iinfo(np.int64).min)


def _factorize(key_cols: List[Column], n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Return (group_id per row, representative row per group, n_groups).

    Groups are ordered by first appearance (stable), matching typical engine
    output; null keys form their own group (SQL GROUP BY semantics).
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0
    mat = np.stack([_key_code_column(c) for c in key_cols], axis=1)
    _, rep_idx, inv = np.unique(mat, axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    # reorder groups by first appearance
    order = np.argsort(rep_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    gid = rank[inv]
    rep_sorted = rep_idx[order]
    return gid.astype(np.int64), rep_sorted.astype(np.int64), len(rep_sorted)


def _sort_codes(col: Column, dtype: DType) -> np.ndarray:
    """Map column to int64 codes whose ascending order == SQL ordering."""
    data = np.asarray(col.data)
    if dtype is DType.STRING:
        dec = _decode_strings(col).astype(str)
        # rank via sorted unique
        uniq, inv = np.unique(dec, return_inverse=True)
        return inv.astype(np.int64).reshape(-1)
    if dtype is DType.FLOAT64:
        # order-preserving map float64 -> int64: positives keep their bit
        # pattern, negatives are bit-complemented then sign-flipped
        # (NaN is SQL NULL and handled via validity upstream)
        bits = data.view(np.int64)
        imin = np.int64(np.iinfo(np.int64).min)
        codes = np.where(bits >= 0, bits, np.bitwise_xor(~bits, imin))
    elif dtype is DType.BOOL:
        codes = data.astype(np.int64)
    else:
        codes = data.astype(np.int64)
    # clip so descending negation and null sentinels cannot overflow/collide
    return np.clip(codes, np.iinfo(np.int64).min + 2, np.iinfo(np.int64).max - 1)


def _equi_join_indices(lkeys: List[Column], rkeys: List[Column], join_type: str):
    """Multi-key equi-join -> (left_idx, right_idx) with -1 padding for outer."""
    lmat = np.stack([_key_code_column(c) for c in lkeys], axis=1)
    rmat = np.stack([_key_code_column(c) for c in rkeys], axis=1)
    # string keys: unify dictionary space
    for j, (lc, rc) in enumerate(zip(lkeys, rkeys)):
        if lc.dictionary is not None or rc.dictionary is not None:
            ldec = _decode_strings(lc).astype(str)
            rdec = _decode_strings(rc).astype(str)
            uniq, inv = np.unique(np.concatenate([ldec, rdec]), return_inverse=True)
            lmat[:, j] = np.where(_valid_of(lc), inv[: len(ldec)], np.iinfo(np.int64).min)
            rmat[:, j] = np.where(_valid_of(rc), inv[len(ldec):], np.iinfo(np.int64).min)

    lvalid = ~(lmat == np.iinfo(np.int64).min).any(axis=1)
    rvalid = ~(rmat == np.iinfo(np.int64).min).any(axis=1)

    # factorize combined key rows
    allmat = np.concatenate([lmat, rmat], axis=0)
    _, inv = np.unique(allmat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    lcode = inv[: len(lmat)]
    rcode = inv[len(lmat):]

    # sort right codes, binary-search from left (sort-merge, the TPU design too)
    rorder = np.argsort(rcode[rvalid], kind="stable")
    rrows = np.nonzero(rvalid)[0][rorder]
    rsorted = rcode[rvalid][rorder]

    lrows_all = np.arange(len(lcode))
    lmask = lvalid
    lo = np.searchsorted(rsorted, lcode, side="left")
    hi = np.searchsorted(rsorted, lcode, side="right")
    cnt = np.where(lmask, hi - lo, 0)

    li = np.repeat(lrows_all, cnt)
    starts = np.cumsum(cnt) - cnt
    offs = np.arange(cnt.sum()) - np.repeat(starts, cnt)
    ri = rrows[np.repeat(lo, cnt) + offs]

    if join_type in ("left", "full"):
        unmatched_l = np.nonzero(cnt == 0)[0]
        li = np.concatenate([li, unmatched_l])
        ri = np.concatenate([ri, np.full(len(unmatched_l), -1, dtype=np.int64)])
    if join_type in ("right", "full"):
        matched_r = np.zeros(len(rcode), dtype=bool)
        matched_r[ri[ri >= 0]] = True
        unmatched_r = np.nonzero(~matched_r)[0]
        li = np.concatenate([li, np.full(len(unmatched_r), -1, dtype=np.int64)])
        ri = np.concatenate([ri, unmatched_r])
    return li.astype(np.int64), ri.astype(np.int64)
