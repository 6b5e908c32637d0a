"""Physical plan + planner.

The port's own copy of ``gpu_olap_tpu/plan/physical.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

TPU-native analogue of ``gpu-olap-core/src/physical_plan.rs``: the ``Gpu*``
operator enum (``physical_plan.rs:11-64``) becomes ``Tpu*`` dataclasses, and —
unlike the reference — join and aggregate output schemas are derived for real
(the reference returns empty schemas, ``physical_plan.rs:250-265``), join key
extraction handles arbitrary conjunctions of equalities with residual filters
(reference handles only a single ``left = right``, ``:235-248``), and join
strategy is actually selected (broadcast <= 1M build rows per
``join_kernel.rs:71-77``, else radix-partitioned hash; reference always picks
hash join, ``:140-155``).
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..config import EngineConfig
from ..interop.columnar import DType, Field, Schema
from . import logical as L
from .logical import strip_alias


class PlanError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Physical expressions (index-resolved, typed)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhysExpr:
    dtype: DType


@dataclasses.dataclass(frozen=True)
class ColumnRef(PhysExpr):
    index: int
    name: str


@dataclasses.dataclass(frozen=True)
class PhysLiteral(PhysExpr):
    value: object


@dataclasses.dataclass(frozen=True)
class PhysBinary(PhysExpr):
    op: str
    left: PhysExpr
    right: PhysExpr


@dataclasses.dataclass(frozen=True)
class PhysUnary(PhysExpr):
    op: str  # NOT | -
    operand: PhysExpr


@dataclasses.dataclass(frozen=True)
class PhysIsNull(PhysExpr):
    operand: PhysExpr
    negated: bool


@dataclasses.dataclass(frozen=True)
class PhysCase(PhysExpr):
    branches: Tuple[Tuple[PhysExpr, PhysExpr], ...]
    default: Optional[PhysExpr]


@dataclasses.dataclass(frozen=True)
class PhysFunc(PhysExpr):
    func: str
    args: Tuple[PhysExpr, ...]


@dataclasses.dataclass(frozen=True)
class PhysInList(PhysExpr):
    operand: PhysExpr
    # literal values only (non-literal IN lists are lowered to OR chains)
    values: Tuple[object, ...]
    negated: bool


# Aggregate spec (reference AggregateExpr, physical_plan.rs:77-84)
@dataclasses.dataclass(frozen=True)
class AggSpec:
    func: str               # sum | count | min | max | avg
    arg: Optional[PhysExpr]  # None for count(*)
    distinct: bool
    out_name: str
    out_dtype: DType


# ---------------------------------------------------------------------------
# Physical operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    schema: Schema

    def inputs(self) -> Tuple["PhysicalPlan", ...]:
        return ()

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        return "\n".join([pad + self._label()] + [i.display(indent + 1) for i in self.inputs()])

    def _label(self) -> str:
        return type(self).__name__

    def __str__(self):
        return self.display()


@dataclasses.dataclass(frozen=True)
class TpuTableScan(PhysicalPlan):
    table_name: str
    projection: Optional[Tuple[int, ...]]  # indices into the catalog schema
    alias: Optional[str] = None
    # pushed-down scan predicate (fused into the scan kernel)
    predicate: Optional[PhysExpr] = None

    def _label(self):
        p = f" projection={list(self.projection)}" if self.projection is not None else ""
        f = f" pred={type(self.predicate).__name__}" if self.predicate is not None else ""
        return f"TpuTableScan: {self.table_name}{p}{f}"


@dataclasses.dataclass(frozen=True)
class TpuFilter(PhysicalPlan):
    input: PhysicalPlan
    predicate: PhysExpr

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class TpuProjection(PhysicalPlan):
    input: PhysicalPlan
    exprs: Tuple[PhysExpr, ...]

    def inputs(self):
        return (self.input,)


JOIN_STRATEGIES = ("broadcast_hash", "radix_hash", "sort_merge")


@dataclasses.dataclass(frozen=True)
class TpuHashJoin(PhysicalPlan):
    left: PhysicalPlan
    right: PhysicalPlan
    left_keys: Tuple[PhysExpr, ...]
    right_keys: Tuple[PhysExpr, ...]
    join_type: str      # inner | left | right | full | cross
    strategy: str       # one of JOIN_STRATEGIES
    residual: Optional[PhysExpr] = None  # non-equi conjuncts evaluated post-join
    # statistics-proven: the build key column is already sorted ascending
    # (null-free) — the executor skips the build-side sort entirely
    build_sorted_asc: bool = False

    def inputs(self):
        return (self.left, self.right)

    def _label(self):
        return f"TpuHashJoin[{self.strategy}]: {self.join_type}"


@dataclasses.dataclass(frozen=True)
class TpuAggregate(PhysicalPlan):
    input: PhysicalPlan
    group_exprs: Tuple[PhysExpr, ...]
    aggs: Tuple[AggSpec, ...]

    def inputs(self):
        return (self.input,)

    def _label(self):
        return f"TpuAggregate: {len(self.group_exprs)} keys, {len(self.aggs)} aggs"


@dataclasses.dataclass(frozen=True)
class PhysSortKey:
    expr: PhysExpr
    ascending: bool
    nulls_last: bool = True


@dataclasses.dataclass(frozen=True)
class TpuSort(PhysicalPlan):
    input: PhysicalPlan
    keys: Tuple[PhysSortKey, ...]
    limit: Optional[int] = None  # fused top-k when Sort is directly under Limit

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class TpuLimit(PhysicalPlan):
    input: PhysicalPlan
    limit: Optional[int]
    offset: int

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class TpuDistinct(PhysicalPlan):
    input: PhysicalPlan

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class TpuUnion(PhysicalPlan):
    """UNION ALL: children concatenated by column position; dtypes unified
    at plan time (ints promote to float where mixed)."""
    children: Tuple[PhysicalPlan, ...]

    def inputs(self):
        return self.children


# ---------------------------------------------------------------------------
# Expression lowering / type inference
# ---------------------------------------------------------------------------

_NUMERIC_FUNCS = {"abs", "round", "floor", "ceil", "sqrt", "ln", "log", "exp", "power"}


def _arith_result(op: str, lt: DType, rt: DType) -> DType:
    if op in ("=", "!=", "<", "<=", ">", ">=", "AND", "OR"):
        return DType.BOOL
    if lt is DType.FLOAT64 or rt is DType.FLOAT64:
        return DType.FLOAT64
    if op == "/":
        # match reference executor semantics: i64 / i64 stays integral
        # (executor.rs:411-441)
        return DType.INT64
    return DType.INT64


def _literal_dtype(value) -> DType:
    if isinstance(value, bool):
        return DType.BOOL
    if isinstance(value, int):
        return DType.INT64
    if isinstance(value, float):
        return DType.FLOAT64
    if isinstance(value, str):
        return DType.STRING
    if value is None:
        return DType.INT64  # typed later by context
    raise PlanError(f"Unsupported literal {value!r}")


_COMPARISONS = ("=", "!=", "<", "<=", ">", ">=")
# the resolution of each temporal column type, as a numpy datetime64 unit
_TEMPORAL_UNIT = {DType.TIMESTAMP_MS: "ms", DType.DATE32: "D"}


def _temporal_value(text: str, dtype: DType) -> int:
    """A date string read by numpy's ``datetime64`` rules, as the int64 a
    column of ``dtype`` holds: milliseconds or days since the epoch.  A
    string that does not parse, names no instant (``NaT``), carries a time
    zone, or is finer than the column's resolution raises ``PlanError``."""
    unit = _TEMPORAL_UNIT[dtype]
    try:
        with warnings.catch_warnings():
            # numpy only warns on a time-zone suffix
            warnings.simplefilter("error")
            parsed = np.datetime64(text)
    except (ValueError, UserWarning, DeprecationWarning) as exc:
        raise PlanError(f"{text!r} is not a date or time: {exc}") from None
    if np.isnat(parsed):
        raise PlanError(f"{text!r} is not a date or time")
    value = parsed.astype(f"datetime64[{unit}]")
    if value != parsed:
        raise PlanError(f"{text!r} is finer than the {dtype.value} "
                        f"column's resolution ({unit})")
    return int(value.astype(np.int64))


# the text of an untyped literal that PostgreSQL reads as a BIGINT, or as a
# DOUBLE PRECISION number (surrounding spaces allowed)
_INTEGER_TEXT = re.compile(r"\s*[+-]?[0-9]+\s*")
_DECIMAL_TEXT = re.compile(
    r"\s*[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\s*")


def _literal_as(value, dtype: DType):
    """A literal's value, typed by the expression of type ``dtype`` it is
    compared with.  A string against an INT64, FLOAT64 or temporal
    expression becomes that type's value; a number against a STRING
    expression becomes its text (``str(value)``, the text the oracle
    compares with).  A string that does not read as the type, and a BOOL
    against a string, raise ``PlanError``.  Other values (NULL, and any
    pair that is not string against non-string) stay as they are."""
    if value is None or (dtype is DType.STRING) == isinstance(value, str):
        return value
    if dtype is DType.STRING:
        if isinstance(value, bool):
            raise PlanError(f"cannot compare a string with {value!r}")
        return str(value)
    if dtype in _TEMPORAL_UNIT:
        return _temporal_value(value, dtype)
    if dtype is DType.INT64 and _INTEGER_TEXT.fullmatch(value):
        number = int(value)
        if np.iinfo(np.int64).min <= number <= np.iinfo(np.int64).max:
            return number
    elif dtype is DType.FLOAT64 and _DECIMAL_TEXT.fullmatch(value):
        number = float(value)
        if np.isfinite(number):
            return number
    raise PlanError(f"{value!r} is not a {dtype.value} value")


def _typed_comparison(left: PhysExpr, right: PhysExpr):
    """A comparison of a string with a non-string expression: the side that
    is a literal takes the other side's type (``_literal_as``), a string
    literal first; two non-literals raise ``PlanError``.  So no comparison
    the executors see has a STRING side facing a non-STRING one."""
    if (left.dtype is DType.STRING) == (right.dtype is DType.STRING):
        return left, right
    string, number = (left, right) if left.dtype is DType.STRING \
        else (right, left)
    if isinstance(string, PhysLiteral):
        string = PhysLiteral(number.dtype,
                             _literal_as(string.value, number.dtype))
    elif isinstance(number, PhysLiteral):
        number = PhysLiteral(DType.STRING,
                             _literal_as(number.value, DType.STRING))
    else:
        raise PlanError(f"cannot compare {number.dtype.value} with a "
                        "string expression")
    return (string, number) if left.dtype is DType.STRING \
        else (number, string)


def lower_expr(e: L.Expr, schema: Schema) -> PhysExpr:
    e = strip_alias(e)
    if isinstance(e, L.Column):
        idx = schema.index_of(e.ident)
        f = schema.field(idx)
        return ColumnRef(f.dtype, idx, f.name)
    if isinstance(e, L.Literal):
        return PhysLiteral(_literal_dtype(e.value), e.value)
    if isinstance(e, L.BinaryOp):
        left = lower_expr(e.left, schema)
        right = lower_expr(e.right, schema)
        # a string literal against a string column stays a STRING literal
        # (mapped into dictionary space at execution time)
        if e.op in _COMPARISONS:
            left, right = _typed_comparison(left, right)
        return PhysBinary(_arith_result(e.op, left.dtype, right.dtype), e.op, left, right)
    if isinstance(e, L.UnaryOp):
        operand = lower_expr(e.operand, schema)
        dtype = DType.BOOL if e.op == "NOT" else operand.dtype
        return PhysUnary(dtype, e.op, operand)
    if isinstance(e, L.Between):
        inner = L.BinaryOp("AND",
                           L.BinaryOp(">=", e.expr, e.low),
                           L.BinaryOp("<=", e.expr, e.high))
        if e.negated:
            inner = L.UnaryOp("NOT", inner)
        return lower_expr(inner, schema)
    if isinstance(e, L.InList):
        if all(isinstance(i, L.Literal) for i in e.items):
            operand = lower_expr(e.expr, schema)
            values = tuple(_literal_as(i.value, operand.dtype)
                           for i in e.items)
            return PhysInList(DType.BOOL, operand, values, e.negated)
        ors: L.Expr = L.BinaryOp("=", e.expr, e.items[0])
        for item in e.items[1:]:
            ors = L.BinaryOp("OR", ors, L.BinaryOp("=", e.expr, item))
        if e.negated:
            ors = L.UnaryOp("NOT", ors)
        return lower_expr(ors, schema)
    if isinstance(e, L.IsNull):
        return PhysIsNull(DType.BOOL, lower_expr(e.expr, schema), e.negated)
    if isinstance(e, L.Case):
        branches = tuple(
            (lower_expr(c, schema), lower_expr(v, schema)) for c, v in e.branches
        )
        default = None if e.default is None else lower_expr(e.default, schema)
        out_dtype = branches[0][1].dtype
        if any(b[1].dtype is DType.FLOAT64 for b in branches) or (
            default is not None and default.dtype is DType.FLOAT64
        ):
            out_dtype = DType.FLOAT64
        return PhysCase(out_dtype, branches, default)
    if isinstance(e, L.Cast):
        operand = lower_expr(e.expr, schema)
        target = {
            "int": DType.INT64, "integer": DType.INT64, "bigint": DType.INT64,
            "int64": DType.INT64, "float": DType.FLOAT64, "double": DType.FLOAT64,
            "float64": DType.FLOAT64, "real": DType.FLOAT64, "bool": DType.BOOL,
            "boolean": DType.BOOL,
        }.get(e.target)
        if target is None:
            raise PlanError(f"Unsupported CAST target {e.target!r}")
        return PhysFunc(target, "cast", (operand,))
    if isinstance(e, L.FuncCall):
        if e.func in L.AGGREGATE_FUNCTIONS:
            raise PlanError(
                f"Aggregate {e.func}() outside of aggregation context"
            )
        args = tuple(lower_expr(a, schema) for a in e.args)
        if e.func == "date_part":
            return PhysFunc(DType.INT64, "date_part", args)
        if e.func == "like":
            return PhysFunc(DType.BOOL, "like", args)
        if e.func in _NUMERIC_FUNCS:
            dt = DType.FLOAT64 if e.func in ("sqrt", "ln", "log", "exp", "power") \
                else args[0].dtype
            return PhysFunc(dt, e.func, args)
        if e.func == "coalesce":
            return PhysFunc(args[0].dtype, "coalesce", args)
        raise PlanError(f"Unknown function {e.func!r}")
    if isinstance(e, L.Star):
        raise PlanError("* is only valid at the top of a SELECT list")
    raise PlanError(f"Cannot lower expression {e!r}")


def _agg_out_dtype(func: str, arg: Optional[PhysExpr]) -> DType:
    if func == "count":
        return DType.INT64
    if func == "avg":
        return DType.FLOAT64
    assert arg is not None
    if func in ("min", "max"):
        return arg.dtype
    # sum
    return DType.FLOAT64 if arg.dtype is DType.FLOAT64 else DType.INT64


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


def create_physical_plan(plan: L.LogicalPlan, catalog, config: EngineConfig) -> PhysicalPlan:
    """Logical -> physical (reference ``create_physical_plan``, ``physical_plan.rs:87-195``)."""
    return _Planner(catalog, config).plan(plan)


class _Planner:
    def __init__(self, catalog, config: EngineConfig):
        self.catalog = catalog
        self.config = config

    def plan(self, node: L.LogicalPlan) -> PhysicalPlan:
        if isinstance(node, L.TableScan):
            return self._plan_scan(node)
        if isinstance(node, L.SubqueryAlias):
            child = self.plan(node.input)
            return dataclasses.replace(
                child, schema=child.schema.unqualify().qualify(node.alias)
            )
        if isinstance(node, L.Projection):
            return self._plan_projection(node)
        if isinstance(node, L.Filter):
            child = self.plan(node.input)
            pred = lower_expr(node.predicate, child.schema)
            return TpuFilter(child.schema, child, pred)
        if isinstance(node, L.Join):
            return self._plan_join(node)
        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)
        if isinstance(node, L.Sort):
            child = self.plan(node.input)
            keys = tuple(
                PhysSortKey(lower_expr(k.expr, child.schema), k.ascending, k.nulls_last)
                for k in node.keys
            )
            return TpuSort(child.schema, child, keys)
        if isinstance(node, L.Limit):
            child = self.plan(node.input)
            if isinstance(child, TpuSort) and node.offset == 0 and node.limit is not None:
                child = dataclasses.replace(child, limit=node.limit)
                return TpuLimit(child.schema, child, node.limit, 0)
            return TpuLimit(child.schema, child, node.limit, node.offset)
        if isinstance(node, L.Distinct):
            child = self.plan(node.input)
            return TpuDistinct(child.schema, child)
        if isinstance(node, L.Union):
            return self._plan_union(node)
        raise PlanError(f"Cannot plan {type(node).__name__}")

    def _plan_union(self, node: L.Union) -> PhysicalPlan:
        kids = [self.plan(c) for c in node.children]
        first = kids[0].schema
        for k in kids[1:]:
            if len(k.schema) != len(first):
                raise PlanError(
                    f"UNION inputs have {len(first)} vs {len(k.schema)} columns")
        fields = []
        for i, f in enumerate(first):
            dts = {k.schema.field(i).dtype for k in kids}
            if len(dts) == 1:
                dt = f.dtype
            elif dts <= {DType.INT64, DType.FLOAT64}:
                dt = DType.FLOAT64
            else:
                raise PlanError(
                    f"UNION column {f.name!r} mixes incompatible types {dts}")
            fields.append(dataclasses.replace(f, dtype=dt))
        from ..interop.columnar import Schema as _Schema

        return TpuUnion(_Schema(tuple(fields)).unqualify(), tuple(kids))

    # -- scan --------------------------------------------------------------
    def _plan_scan(self, node: L.TableScan) -> PhysicalPlan:
        table_schema: Schema = self.catalog.get_schema(node.table_name)
        if node.projection is not None:
            # the optimizer's pruning may speculatively route unqualified
            # columns to both join sides — names this table doesn't have are
            # simply not projected here (resolution errors surface when the
            # expression itself is lowered)
            indices = []
            for c in node.projection:
                try:
                    indices.append(table_schema.index_of(c))
                except KeyError:
                    continue
            indices = tuple(sorted(set(indices))) or None
        else:
            indices = None
        out = table_schema if indices is None else table_schema.project(indices)
        qualifier = node.alias or node.table_name
        return TpuTableScan(out.qualify(qualifier), node.table_name, indices, node.alias)

    # -- projection --------------------------------------------------------
    def _plan_projection(self, node: L.Projection) -> PhysicalPlan:
        child = self.plan(node.input)
        exprs: List[PhysExpr] = []
        fields: List[Field] = []
        for e in node.exprs:
            base = strip_alias(e)
            if isinstance(base, L.Star):
                cschema = child.schema
                for i, f in enumerate(cschema):
                    if base.qualifier is not None and not f.name.startswith(base.qualifier + "."):
                        continue
                    exprs.append(ColumnRef(f.dtype, i, f.name))
                    fields.append(Field(_display_name(f.name), f.dtype))
                continue
            pe = lower_expr(e, child.schema)
            fields.append(Field(_output_name(e), pe.dtype))
            exprs.append(pe)
        return TpuProjection(Schema(fields), child, tuple(exprs))

    # -- join --------------------------------------------------------------
    def _plan_join(self, node: L.Join) -> PhysicalPlan:
        left = self.plan(node.left)
        right = self.plan(node.right)
        out_schema = left.schema.merge(right.schema)

        left_keys: List[PhysExpr] = []
        right_keys: List[PhysExpr] = []
        residual: List[L.Expr] = []
        if node.on is not None:
            from .optimizer import split_conjunction
            for conj in split_conjunction(node.on):
                pair = self._equi_pair(conj, left.schema, right.schema)
                if pair is not None:
                    lk, rk = pair
                    left_keys.append(lk)
                    right_keys.append(rk)
                else:
                    residual.append(conj)
        if node.join_type != "cross" and not left_keys:
            raise PlanError(
                f"JOIN ON clause has no equi-join keys: {node.on.name() if node.on else None}"
            )
        residual_expr = None
        if residual:
            from .optimizer import conjoin
            residual_expr = lower_expr(conjoin(residual), out_schema)

        presorted = self._build_key_sorted(right, right_keys)
        strategy = self._choose_join_strategy(left, right, presorted)
        return TpuHashJoin(
            out_schema, left, right, tuple(left_keys), tuple(right_keys),
            node.join_type, strategy, residual_expr,
            build_sorted_asc=presorted,
        )

    def _build_key_sorted(self, right: PhysicalPlan,
                          right_keys: List[PhysExpr]) -> bool:
        """Sortedness statistic for the build key (single plain column on a
        direct scan): reference ``join_kernel.rs:10-14`` documents
        SortMergeJoin "for pre-sorted data" but has no statistic; here the
        catalog proves it lazily and the executor skips the build sort."""
        if len(right_keys) != 1 or not isinstance(right, TpuTableScan):
            return False
        rk = right_keys[0]
        if not isinstance(rk, ColumnRef):
            return False
        sch = self.catalog.get_schema(right.table_name)
        ti = (rk.index if right.projection is None
              else right.projection[rk.index])
        try:
            return self.catalog.ensure_sorted_stat(right.table_name,
                                                   sch.field(ti).name)
        except Exception:
            return False

    def _equi_pair(self, e: L.Expr, lschema: Schema, rschema: Schema):
        if not (isinstance(e, L.BinaryOp) and e.op == "="):
            return None

        def try_side(expr: L.Expr, schema: Schema) -> Optional[PhysExpr]:
            try:
                return lower_expr(expr, schema)
            except (KeyError, PlanError):
                return None

        ll = try_side(e.left, lschema)
        rr = try_side(e.right, rschema)
        if ll is not None and rr is not None:
            return _typed_comparison(ll, rr)
        lr = try_side(e.right, lschema)
        rl = try_side(e.left, rschema)
        if lr is not None and rl is not None:
            return _typed_comparison(lr, rl)
        return None

    def _choose_join_strategy(self, left: PhysicalPlan, right: PhysicalPlan,
                              presorted: bool = False) -> str:
        """Strategy choice (reference ``join_kernel.rs:71-77`` thresholds;
        pre-sorted build keys auto-select sort-merge per
        ``join_kernel.rs:10-14``)."""
        if self.config.join_strategy is not None:
            if self.config.join_strategy not in JOIN_STRATEGIES:
                raise PlanError(f"Unknown join strategy {self.config.join_strategy!r}")
            return self.config.join_strategy
        build_rows = self._estimate_rows(right)
        if build_rows is not None and build_rows <= self.config.broadcast_join_threshold:
            return "broadcast_hash"
        if presorted:
            return "sort_merge"
        return "radix_hash"

    def _estimate_rows(self, plan: PhysicalPlan) -> Optional[int]:
        if isinstance(plan, TpuTableScan):
            try:
                return self.catalog.get_row_count(plan.table_name)
            except Exception:
                return None
        if isinstance(plan, (TpuFilter, TpuProjection)):
            return self._estimate_rows(plan.input)
        if isinstance(plan, TpuLimit) and plan.limit is not None:
            return plan.limit
        return None

    # -- aggregate ---------------------------------------------------------
    def _plan_aggregate(self, node: L.Aggregate) -> PhysicalPlan:
        child = self.plan(node.input)
        group_exprs = tuple(lower_expr(g, child.schema) for g in node.group_by)
        fields: List[Field] = [
            Field(_output_name(g), ge.dtype)
            for g, ge in zip(node.group_by, group_exprs)
        ]
        aggs: List[AggSpec] = []
        for a in node.aggr_exprs:
            func = a.func
            if func == "count" and (not a.args or isinstance(a.args[0], L.Star)):
                arg = None
            else:
                if len(a.args) != 1:
                    raise PlanError(f"{func}() takes exactly one argument")
                arg = lower_expr(a.args[0], child.schema)
            dtype = _agg_out_dtype(func, arg)
            aggs.append(AggSpec(func, arg, a.distinct, a.name(), dtype))
            fields.append(Field(a.name(), dtype))
        return TpuAggregate(Schema(fields), child, group_exprs, tuple(aggs))


def _output_name(e: L.Expr) -> str:
    if isinstance(e, L.Alias):
        return e.alias
    if isinstance(e, L.Column):
        return _display_name(e.ident)
    return e.name()


def _display_name(qualified: str) -> str:
    """Output column names drop their table qualifier (SQL output convention)."""
    return qualified.rsplit(".", 1)[-1]
