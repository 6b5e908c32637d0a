"""Logical plan IR.

The port's own copy of ``gpu_olap_tpu/plan/logical.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

Covers the reference's ``logical_plan.rs:5-119`` operator/expression surface
(TableScan, Projection, Filter, Join, Aggregate, Sort, Limit; Column/Literal/
BinaryExpr/AggregateFunction/Alias/Wildcard) and extends it with the nodes the
reference's own example queries need but its parser could not produce: Distinct,
SubqueryAlias (derived tables), HAVING (as Filter over Aggregate), IN/BETWEEN/
IS NULL/CASE expressions, and real aggregate extraction (the reference leaves
``aggr_exprs`` empty with a TODO at ``parser.rs:89``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

AGGREGATE_FUNCTIONS = {"sum", "count", "min", "max", "avg"}


@dataclasses.dataclass(frozen=True)
class Expr:
    def name(self) -> str:
        """Canonical SQL-ish name used for output columns and structural matching."""
        raise NotImplementedError

    def children(self) -> Tuple["Expr", ...]:
        return ()

    def contains_aggregate(self) -> bool:
        if isinstance(self, FuncCall) and self.func in AGGREGATE_FUNCTIONS:
            return True
        return any(c.contains_aggregate() for c in self.children())

    def column_refs(self) -> List[str]:
        out: List[str] = []

        def walk(e: Expr):
            if isinstance(e, Column):
                out.append(e.ident)
            for c in e.children():
                walk(c)

        walk(self)
        return out


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    ident: str  # possibly qualified: "t.a" or "a"

    def name(self) -> str:
        return self.ident


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None

    def name(self) -> str:
        if self.value is None:
            return "NULL"
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return str(self.value)


@dataclasses.dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= AND OR
    left: Expr
    right: Expr

    def name(self) -> str:
        return f"{self.left.name()} {self.op} {self.right.name()}"

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # NOT, -
    operand: Expr

    def name(self) -> str:
        return f"{self.op} {self.operand.name()}"

    def children(self):
        return (self.operand,)


@dataclasses.dataclass(frozen=True)
class FuncCall(Expr):
    func: str  # lowercase
    args: Tuple[Expr, ...]
    distinct: bool = False

    def name(self) -> str:
        inner = ", ".join(a.name() for a in self.args)
        if self.distinct:
            inner = f"DISTINCT {inner}"
        return f"{self.func}({inner})"

    def children(self):
        return self.args


@dataclasses.dataclass(frozen=True)
class Alias(Expr):
    expr: Expr
    alias: str

    def name(self) -> str:
        return self.alias

    def children(self):
        return (self.expr,)


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    qualifier: Optional[str] = None  # "t.*" -> "t"

    def name(self) -> str:
        return f"{self.qualifier}.*" if self.qualifier else "*"


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def name(self) -> str:
        n = " NOT" if self.negated else ""
        return f"{self.expr.name()}{n} BETWEEN {self.low.name()} AND {self.high.name()}"

    def children(self):
        return (self.expr, self.low, self.high)


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: Tuple[Expr, ...]
    negated: bool = False

    def name(self) -> str:
        n = " NOT" if self.negated else ""
        return f"{self.expr.name()}{n} IN ({', '.join(i.name() for i in self.items)})"

    def children(self):
        return (self.expr,) + self.items


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def name(self) -> str:
        return f"{self.expr.name()} IS {'NOT ' if self.negated else ''}NULL"

    def children(self):
        return (self.expr,)


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    # CASE WHEN cond THEN val ... ELSE default END (searched form)
    branches: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr] = None

    def name(self) -> str:
        parts = " ".join(f"WHEN {c.name()} THEN {v.name()}" for c, v in self.branches)
        tail = f" ELSE {self.default.name()}" if self.default is not None else ""
        return f"CASE {parts}{tail} END"

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    target: str  # "int64" | "float64" | ...

    def name(self) -> str:
        return f"CAST({self.expr.name()} AS {self.target})"

    def children(self):
        return (self.expr,)


def strip_alias(e: Expr) -> Expr:
    return e.expr if isinstance(e, Alias) else e


def map_expr(e: Expr, fn) -> Expr:
    """Bottom-up expression rewrite: ``fn`` is applied to every rebuilt node."""
    if isinstance(e, BinaryOp):
        e = BinaryOp(e.op, map_expr(e.left, fn), map_expr(e.right, fn))
    elif isinstance(e, UnaryOp):
        e = UnaryOp(e.op, map_expr(e.operand, fn))
    elif isinstance(e, FuncCall):
        e = FuncCall(e.func, tuple(map_expr(a, fn) for a in e.args), e.distinct)
    elif isinstance(e, Alias):
        e = Alias(map_expr(e.expr, fn), e.alias)
    elif isinstance(e, Between):
        e = Between(map_expr(e.expr, fn), map_expr(e.low, fn), map_expr(e.high, fn), e.negated)
    elif isinstance(e, InList):
        e = InList(map_expr(e.expr, fn), tuple(map_expr(i, fn) for i in e.items), e.negated)
    elif isinstance(e, IsNull):
        e = IsNull(map_expr(e.expr, fn), e.negated)
    elif isinstance(e, Case):
        e = Case(
            tuple((map_expr(c, fn), map_expr(v, fn)) for c, v in e.branches),
            None if e.default is None else map_expr(e.default, fn),
        )
    elif isinstance(e, Cast):
        e = Cast(map_expr(e.expr, fn), e.target)
    return fn(e)


def collect_aggregates(e: Expr) -> List[FuncCall]:
    """All aggregate FuncCall nodes in ``e`` (dedup by structural equality)."""
    out: List[FuncCall] = []

    def walk(node: Expr):
        if isinstance(node, FuncCall) and node.func in AGGREGATE_FUNCTIONS:
            if node not in out:
                out.append(node)
            return  # no nested aggregates
        for c in node.children():
            walk(c)

    walk(e)
    return out


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    def inputs(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = pad + self._label()
        return "\n".join([line] + [i.display(indent + 1) for i in self.inputs()])

    def _label(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.display()


@dataclasses.dataclass(frozen=True)
class TableScan(LogicalPlan):
    table_name: str
    alias: Optional[str] = None
    projection: Optional[Tuple[str, ...]] = None  # column names, None = all

    def _label(self) -> str:
        proj = f" projection={list(self.projection)}" if self.projection is not None else ""
        ali = f" AS {self.alias}" if self.alias else ""
        return f"TableScan: {self.table_name}{ali}{proj}"


@dataclasses.dataclass(frozen=True)
class SubqueryAlias(LogicalPlan):
    input: LogicalPlan
    alias: str

    def inputs(self):
        return (self.input,)

    def _label(self):
        return f"SubqueryAlias: {self.alias}"


@dataclasses.dataclass(frozen=True)
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: Tuple[Expr, ...]

    def inputs(self):
        return (self.input,)

    def _label(self):
        return "Projection: " + ", ".join(e.name() for e in self.exprs)


@dataclasses.dataclass(frozen=True)
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr

    def inputs(self):
        return (self.input,)

    def _label(self):
        return f"Filter: {self.predicate.name()}"


@dataclasses.dataclass(frozen=True)
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    join_type: str  # inner | left | right | full | cross
    on: Expr = None  # join condition expression (equalities extracted by planner)

    def inputs(self):
        return (self.left, self.right)

    def _label(self):
        cond = f" ON {self.on.name()}" if self.on is not None else ""
        return f"Join: {self.join_type.upper()}{cond}"


@dataclasses.dataclass(frozen=True)
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_by: Tuple[Expr, ...]
    aggr_exprs: Tuple[FuncCall, ...]

    def inputs(self):
        return (self.input,)

    def _label(self):
        g = ", ".join(e.name() for e in self.group_by)
        a = ", ".join(e.name() for e in self.aggr_exprs)
        return f"Aggregate: groupBy=[{g}] aggr=[{a}]"


@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: Expr
    ascending: bool = True
    nulls_last: bool = True


@dataclasses.dataclass(frozen=True)
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: Tuple[SortKey, ...]

    def inputs(self):
        return (self.input,)

    def _label(self):
        ks = ", ".join(
            f"{k.expr.name()} {'ASC' if k.ascending else 'DESC'}" for k in self.keys
        )
        return f"Sort: {ks}"


@dataclasses.dataclass(frozen=True)
class Limit(LogicalPlan):
    input: LogicalPlan
    limit: Optional[int]
    offset: int = 0

    def inputs(self):
        return (self.input,)

    def _label(self):
        return f"Limit: {self.limit}" + (f" OFFSET {self.offset}" if self.offset else "")


@dataclasses.dataclass(frozen=True)
class Distinct(LogicalPlan):
    input: LogicalPlan

    def inputs(self):
        return (self.input,)


@dataclasses.dataclass(frozen=True)
class Union(LogicalPlan):
    """UNION ALL of queries with compatible schemas (column-position
    semantics; UNION-distinct parses to Distinct(Union(...)))."""
    children: Tuple[LogicalPlan, ...]

    def inputs(self):
        return self.children

    def _label(self):
        return f"Union: {len(self.children)} inputs"


def map_plan(plan: LogicalPlan, fn) -> LogicalPlan:
    """Bottom-up plan rewrite."""
    kids = plan.inputs()
    if kids:
        new_kids = tuple(map_plan(k, fn) for k in kids)
        if isinstance(plan, (Projection, Filter, Aggregate, Sort, Limit, Distinct, SubqueryAlias)):
            plan = dataclasses.replace(plan, input=new_kids[0])
        elif isinstance(plan, Join):
            plan = dataclasses.replace(plan, left=new_kids[0], right=new_kids[1])
        elif isinstance(plan, Union):
            plan = dataclasses.replace(plan, children=new_kids)
    return fn(plan)
