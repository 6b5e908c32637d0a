"""Rule-based logical optimizer.

The port's own copy of ``gpu_olap_tpu/plan/optimizer.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

Mirrors the reference's fixed pass pipeline (``optimizer.rs:12-22``):
1. predicate pushdown  (``optimizer.rs:27-41`` — extended with the join-side
   splitting the reference acknowledges but never implemented, ``:44-53``)
2. projection pushdown / column pruning (``:97-117``)
3. filter merging (``:149-178``)
4. constant folding (real, not the identity stub at ``:181-185``)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from .logical import (
    Aggregate, Alias, Between, BinaryOp, Column, Distinct, Expr, Filter, FuncCall,
    InList, IsNull, Join, Limit, Literal, LogicalPlan, Projection, Sort, Star,
    SubqueryAlias, TableScan, UnaryOp, map_expr, map_plan, strip_alias,
)


def optimize(plan: LogicalPlan) -> LogicalPlan:
    plan = fold_constants(plan)
    plan = pushdown_predicates(plan)
    plan = merge_filters(plan)
    plan = pushdown_projections(plan)
    return plan


# ---------------------------------------------------------------------------
# 1. Constant folding
# ---------------------------------------------------------------------------

_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "%": lambda a, b: a % b,
}
_CMP = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def fold_expr(e: Expr) -> Expr:
    def fold(node: Expr) -> Expr:
        if isinstance(node, BinaryOp):
            l, r = node.left, node.right
            if isinstance(l, Literal) and isinstance(r, Literal):
                if l.value is None or r.value is None:
                    if node.op in _ARITH or node.op in _CMP or node.op == "/":
                        return Literal(None)
                elif node.op in _ARITH and not isinstance(l.value, str):
                    try:
                        return Literal(_ARITH[node.op](l.value, r.value))
                    except ZeroDivisionError:
                        return node
                elif node.op == "/" and not isinstance(l.value, str):
                    if r.value != 0:
                        # SQL integer division stays integral
                        if isinstance(l.value, int) and isinstance(r.value, int):
                            return Literal(int(l.value / r.value))
                        return Literal(l.value / r.value)
                elif node.op in _CMP and type(l.value) == type(r.value):
                    return Literal(bool(_CMP[node.op](l.value, r.value)))
            if node.op == "AND":
                if isinstance(l, Literal) and isinstance(l.value, bool):
                    return r if l.value else Literal(False)
                if isinstance(r, Literal) and isinstance(r.value, bool):
                    return l if r.value else Literal(False)
            if node.op == "OR":
                if isinstance(l, Literal) and isinstance(l.value, bool):
                    return Literal(True) if l.value else r
                if isinstance(r, Literal) and isinstance(r.value, bool):
                    return Literal(True) if r.value else l
        elif isinstance(node, UnaryOp):
            if isinstance(node.operand, Literal):
                v = node.operand.value
                if node.op == "NOT" and isinstance(v, bool):
                    return Literal(not v)
                if node.op == "-" and isinstance(v, (int, float)):
                    return Literal(-v)
        elif isinstance(node, Between):
            if all(isinstance(x, Literal) for x in (node.expr, node.low, node.high)):
                v, lo, hi = node.expr.value, node.low.value, node.high.value
                if None not in (v, lo, hi):
                    res = lo <= v <= hi
                    return Literal((not res) if node.negated else res)
        return node

    return map_expr(e, fold)


def _fold_plan_node(plan: LogicalPlan) -> LogicalPlan:
    if isinstance(plan, Filter):
        return Filter(plan.input, fold_expr(plan.predicate))
    if isinstance(plan, Projection):
        return Projection(plan.input, tuple(fold_expr(e) for e in plan.exprs))
    if isinstance(plan, Join) and plan.on is not None:
        return dataclasses.replace(plan, on=fold_expr(plan.on))
    if isinstance(plan, Aggregate):
        return Aggregate(
            plan.input,
            tuple(fold_expr(g) for g in plan.group_by),
            tuple(fold_expr(a) for a in plan.aggr_exprs),
        )
    return plan


def fold_constants(plan: LogicalPlan) -> LogicalPlan:
    return map_plan(plan, _fold_plan_node)


# ---------------------------------------------------------------------------
# 2. Predicate pushdown
# ---------------------------------------------------------------------------


def split_conjunction(e: Expr) -> List[Expr]:
    if isinstance(e, BinaryOp) and e.op == "AND":
        return split_conjunction(e.left) + split_conjunction(e.right)
    return [e]


def conjoin(exprs: List[Expr]) -> Expr:
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryOp("AND", out, e)
    return out


def _qualifiers(plan: LogicalPlan) -> Set[str]:
    """Table aliases / names visible from a subtree (for join-side routing)."""
    if isinstance(plan, TableScan):
        return {plan.alias or plan.table_name}
    if isinstance(plan, SubqueryAlias):
        return {plan.alias}
    out: Set[str] = set()
    for k in plan.inputs():
        out |= _qualifiers(k)
    return out


def _push_filter(pred: Expr, plan: LogicalPlan) -> LogicalPlan:
    """Push a single predicate as far down as legal; returns plan with the
    predicate applied somewhere inside."""
    if isinstance(plan, Projection):
        # substitute aliases so the predicate speaks the child's language
        alias_map = {e.alias: e.expr for e in plan.exprs if isinstance(e, Alias)}
        refs = pred.column_refs()
        computed = {e.name() for e in plan.exprs if not isinstance(e, (Column, Star))
                    and not (isinstance(e, Alias) and isinstance(e.expr, Column))}
        if any(r in computed for r in refs):
            # references a computed non-column output we can't see through cheaply
            rewritten = map_expr(
                pred,
                lambda n: alias_map.get(n.ident, n) if isinstance(n, Column) else n,
            )
            return Projection(_push_filter(rewritten, plan.input), plan.exprs)
        rewritten = map_expr(
            pred, lambda n: alias_map.get(n.ident, n) if isinstance(n, Column) else n
        )
        return Projection(_push_filter(rewritten, plan.input), plan.exprs)
    if isinstance(plan, Filter):
        return Filter(_push_filter(pred, plan.input), plan.predicate)
    if isinstance(plan, SubqueryAlias):
        # strip the alias qualifier from columns before descending
        alias = plan.alias

        def strip_q(n: Expr) -> Expr:
            if isinstance(n, Column) and n.ident.startswith(alias + "."):
                return Column(n.ident[len(alias) + 1:])
            return n

        inner = map_expr(pred, strip_q)
        return SubqueryAlias(_push_filter(inner, plan.input), alias)
    if isinstance(plan, Join):
        refs = pred.column_refs()
        quals = {r.rsplit(".", 1)[0] for r in refs if "." in r}
        if quals and plan.join_type in ("inner", "left", "right"):
            lq, rq = _qualifiers(plan.left), _qualifiers(plan.right)
            if quals <= lq and plan.join_type in ("inner", "left"):
                return dataclasses.replace(plan, left=_push_filter(pred, plan.left))
            if quals <= rq and plan.join_type in ("inner", "right"):
                return dataclasses.replace(plan, right=_push_filter(pred, plan.right))
        return Filter(plan, pred)
    if isinstance(plan, Aggregate):
        # safe only if predicate references group-by keys exclusively
        group_names = {g.name() for g in plan.group_by}
        if pred.column_refs() and all(r in group_names for r in pred.column_refs()) \
                and not pred.contains_aggregate():
            return Aggregate(_push_filter(pred, plan.input), plan.group_by, plan.aggr_exprs)
        return Filter(plan, pred)
    if isinstance(plan, (Sort, Limit, Distinct)):
        # Limit: NOT safe to push below; Sort/Distinct: safe
        if isinstance(plan, Limit):
            return Filter(plan, pred)
        return dataclasses.replace(plan, input=_push_filter(pred, plan.input))
    return Filter(plan, pred)


def pushdown_predicates(plan: LogicalPlan) -> LogicalPlan:
    def rewrite(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Filter):
            out = node.input
            for pred in split_conjunction(node.predicate):
                out = _push_filter(pred, out)
            return out
        return node

    return map_plan(plan, rewrite)


# ---------------------------------------------------------------------------
# 3. Filter merging (optimizer.rs:149-178)
# ---------------------------------------------------------------------------


def merge_filters(plan: LogicalPlan) -> LogicalPlan:
    def rewrite(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Filter) and isinstance(node.input, Filter):
            inner = node.input
            return Filter(inner.input, BinaryOp("AND", node.predicate, inner.predicate))
        return node

    return map_plan(plan, rewrite)


# ---------------------------------------------------------------------------
# 4. Projection pushdown / column pruning (optimizer.rs:97-117)
# ---------------------------------------------------------------------------


def _required_from_exprs(exprs) -> Optional[Set[str]]:
    req: Set[str] = set()
    for e in exprs:
        if isinstance(strip_alias(e), Star):
            return None  # needs everything
        req.update(e.column_refs())
    return req


def _prune(plan: LogicalPlan, required: Optional[Set[str]]) -> LogicalPlan:
    """Top-down: ``required`` = column idents the parent needs (None = all)."""
    if isinstance(plan, TableScan):
        if required is None:
            return plan
        qual = (plan.alias or plan.table_name) + "."
        local = sorted({r[len(qual):] if r.startswith(qual) else r
                        for r in required if "." not in r or r.startswith(qual)})
        if not local:
            return plan
        return dataclasses.replace(plan, projection=tuple(local))
    if isinstance(plan, Projection):
        child_req = _required_from_exprs(plan.exprs)
        return Projection(_prune(plan.input, child_req), plan.exprs)
    if isinstance(plan, Filter):
        child_req = None
        if required is not None:
            child_req = set(required) | set(plan.predicate.column_refs())
        return Filter(_prune(plan.input, child_req), plan.predicate)
    if isinstance(plan, Aggregate):
        child_req: Set[str] = set()
        for g in plan.group_by:
            child_req |= set(g.column_refs())
        for a in plan.aggr_exprs:
            child_req |= set(a.column_refs())
        return Aggregate(_prune(plan.input, child_req or None), plan.group_by, plan.aggr_exprs)
    if isinstance(plan, Join):
        child_req = None
        if required is not None:
            child_req = set(required)
            if plan.on is not None:
                child_req |= set(plan.on.column_refs())
        if child_req is None:
            return dataclasses.replace(plan, left=_prune(plan.left, None),
                                       right=_prune(plan.right, None))
        lq = _qualifiers(plan.left)
        rq = _qualifiers(plan.right)
        lreq = {r for r in child_req if "." not in r or r.rsplit(".", 1)[0] in lq}
        rreq = {r for r in child_req if "." not in r or r.rsplit(".", 1)[0] in rq}
        return dataclasses.replace(
            plan, left=_prune(plan.left, lreq or None), right=_prune(plan.right, rreq or None)
        )
    if isinstance(plan, Sort):
        child_req = None
        if required is not None:
            child_req = set(required)
            for k in plan.keys:
                child_req |= set(k.expr.column_refs())
        return Sort(_prune(plan.input, child_req), plan.keys)
    if isinstance(plan, SubqueryAlias):
        inner_req = None
        if required is not None:
            qual = plan.alias + "."
            inner_req = {r[len(qual):] if r.startswith(qual) else r for r in required}
        return SubqueryAlias(_prune(plan.input, inner_req), plan.alias)
    if isinstance(plan, (Limit, Distinct)):
        return dataclasses.replace(plan, input=_prune(plan.input, required))
    return plan


def pushdown_projections(plan: LogicalPlan) -> LogicalPlan:
    # also merge Projection(Projection(x)) when outer refers only to inner outputs
    def merge(node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Projection) and isinstance(node.input, Projection):
            inner = node.input
            inner_map = {}
            ok = True
            for e in inner.exprs:
                if isinstance(strip_alias(e), Star):
                    ok = False
                    break
                inner_map[e.name()] = strip_alias(e)
            if ok:
                def sub(n: Expr) -> Expr:
                    if isinstance(n, Column) and n.ident in inner_map:
                        return inner_map[n.ident]
                    return n
                merged = tuple(
                    Alias(map_expr(e.expr, sub), e.alias) if isinstance(e, Alias)
                    else map_expr(e, sub)
                    for e in node.exprs
                )
                return Projection(inner.input, merged)
        return node

    plan = map_plan(plan, merge)
    return _prune(plan, None)
