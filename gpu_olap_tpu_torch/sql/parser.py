"""SQL -> LogicalPlan parser.

The port's own copy of ``gpu_olap_tpu/sql/parser.py``: this package imports
nothing of the JAX package, and ``tests/test_torch_standalone.py``
holds the copy against the original.

Role of the reference's ``gpu-olap-core/src/parser.rs`` (``parse_sql`` at
``parser.rs:9-22``) with the gaps fixed that SURVEY.md §2.5 calls out:

* aggregate expressions are actually extracted from the projection / HAVING /
  ORDER BY lists (reference leaves them empty, TODO at ``parser.rs:89``), and the
  Aggregate node is placed *below* the final Projection;
* HAVING is supported (Filter over Aggregate);
* DISTINCT / COUNT(DISTINCT x), derived tables in FROM, BETWEEN / IN / IS NULL /
  CASE / CAST, ORDER BY aliases & ordinals, LIMIT ... OFFSET are supported —
  all of which appear in the reference's own example workloads
  (``examples/python_usage.py:226-245,275-284``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..plan.logical import (
    Aggregate, Alias, Between, BinaryOp, Case, Cast, Column, Distinct, Expr, Filter,
    FuncCall, InList, IsNull, Join, Limit, Literal, LogicalPlan, Projection, Sort,
    SortKey, Star, SubqueryAlias, TableScan, UnaryOp, Union, collect_aggregates,
    map_expr, strip_alias,
)
from .tokenizer import SqlError, Token, tokenize

# Pratt binding powers
_CMP_OPS = {"=", "!=", "<>", "<", "<=", ">", ">="}
_ADD_OPS = {"+", "-", "||"}
_MUL_OPS = {"*", "/", "%"}


class Parser:
    def __init__(self, sql: str):
        self.tokens: List[Token] = tokenize(sql)
        self.pos = 0
        # WITH-clause common table expressions in scope: name -> LogicalPlan
        self.ctes: dict = {}

    # -- token helpers -----------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.pos + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.kind != "eof":
            self.pos += 1
        return tok

    def accept_kw(self, *words: str) -> bool:
        tok = self.peek()
        if tok.kind == "keyword" and tok.value in words:
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise SqlError(f"Expected {word.upper()} but found {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        tok = self.peek()
        if tok.kind == "op" and tok.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"Expected {op!r} but found {self.peek().value!r}")

    # -- entry -------------------------------------------------------------
    def parse_statement(self) -> LogicalPlan:
        plan = self.parse_query()
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise SqlError(f"Trailing input at {self.peek().pos}: {self.peek().value!r}")
        return plan

    def parse_query(self) -> LogicalPlan:
        if self.accept_kw("with"):
            # CTEs (beyond the reference, which supports none —
            # README.md:406-414); each CTE sees the ones before it
            saved = dict(self.ctes)
            while True:
                tok = self.next()
                if tok.kind != "ident":
                    raise SqlError(f"Expected CTE name, found {tok.value!r}")
                name = tok.value
                self.expect_kw("as")
                self.expect_op("(")
                self.ctes[name] = self.parse_query()
                self.expect_op(")")
                if not self.accept_op(","):
                    break
            plan = self._parse_set_expr()
            self.ctes = saved
            return plan
        return self._parse_set_expr()

    def _parse_set_expr(self) -> LogicalPlan:
        plan = self.parse_select()
        while self.accept_kw("union"):
            is_all = self.accept_kw("all")
            if not is_all:
                self.accept_kw("distinct")
            right = self.parse_select()
            plan = Union((plan, right))
            if not is_all:
                plan = Distinct(plan)
        return plan

    # -- SELECT ------------------------------------------------------------
    def parse_select(self) -> LogicalPlan:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        if distinct:
            self.accept_kw("all")

        select_exprs = [self.parse_select_item()]
        while self.accept_op(","):
            select_exprs.append(self.parse_select_item())

        plan: LogicalPlan
        if self.accept_kw("from"):
            plan = self.parse_table_ref()
            while True:
                jt = self.parse_join_type()
                if jt is None:
                    break
                right = self.parse_table_ref()
                on = None
                if self.accept_kw("on"):
                    on = self.parse_expr()
                elif jt != "cross":
                    raise SqlError("JOIN requires an ON clause")
                plan = Join(plan, right, jt, on)
        else:
            raise SqlError("SELECT without FROM is not supported")

        if self.accept_kw("where"):
            plan = Filter(plan, self.parse_expr())

        group_by: List[Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())

        having = self.parse_expr() if self.accept_kw("having") else None

        order_keys: List[Tuple[Expr, bool]] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                else:
                    self.accept_kw("asc")
                order_keys.append((e, asc))
                if not self.accept_op(","):
                    break

        limit = offset = None
        if self.accept_kw("limit"):
            tok = self.next()
            if tok.kind != "number":
                raise SqlError(f"LIMIT expects a number, found {tok.value!r}")
            limit = int(tok.value)
            if self.accept_kw("offset"):
                tok = self.next()
                if tok.kind != "number":
                    raise SqlError(f"OFFSET expects a number, found {tok.value!r}")
                offset = int(tok.value)

        return build_select(plan, select_exprs, group_by, having, order_keys,
                            limit, offset or 0, distinct)

    def parse_select_item(self) -> Expr:
        if self.accept_op("*"):
            return Star()
        # qualified star: ident . *
        if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).value == "." and self.peek(2).kind == "op"
                and self.peek(2).value == "*"):
            qualifier = self.next().value
            self.next()  # .
            self.next()  # *
            return Star(qualifier)
        expr = self.parse_expr()
        if self.accept_kw("as"):
            tok = self.next()
            if tok.kind not in ("ident", "keyword", "string"):
                raise SqlError(f"Expected alias after AS, found {tok.value!r}")
            return Alias(expr, tok.value)
        if self.peek().kind == "ident":
            return Alias(expr, self.next().value)
        return expr

    def parse_join_type(self) -> Optional[str]:
        if self.accept_kw("join"):
            return "inner"
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return "inner"
        for jt in ("left", "right", "full"):
            if self.accept_kw(jt):
                self.accept_kw("outer")
                self.expect_kw("join")
                return jt
        if self.accept_kw("cross"):
            self.expect_kw("join")
            return "cross"
        return None

    def parse_table_ref(self) -> LogicalPlan:
        if self.accept_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            self.accept_kw("as")
            tok = self.next()
            if tok.kind != "ident":
                raise SqlError("Derived table requires an alias")
            return SubqueryAlias(sub, tok.value)
        tok = self.next()
        if tok.kind != "ident":
            raise SqlError(f"Expected table name, found {tok.value!r}")
        name = tok.value
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek().kind == "ident":
            alias = self.next().value
        if name in self.ctes:
            return SubqueryAlias(self.ctes[name], alias or name)
        return TableScan(name, alias)

    # -- expressions (Pratt) -----------------------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = BinaryOp("OR", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = BinaryOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return UnaryOp("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        tok = self.peek()
        if tok.kind == "op" and tok.value in _CMP_OPS:
            op = self.next().value
            if op == "<>":
                op = "!="
            return BinaryOp(op, left, self.parse_additive())
        if tok.kind == "keyword" and tok.value in ("between", "in", "is", "like", "not"):
            negated = self.accept_kw("not")
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                return Between(left, low, high, negated)
            if self.accept_kw("in"):
                self.expect_op("(")
                items = [self.parse_expr()]
                while self.accept_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                return InList(left, tuple(items), negated)
            if self.accept_kw("like"):
                pattern = self.parse_additive()
                e = FuncCall("like", (left, pattern))
                return UnaryOp("NOT", e) if negated else e
            if negated:
                raise SqlError("Expected BETWEEN/IN/LIKE after NOT")
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                return IsNull(left, neg)
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            tok = self.peek()
            if tok.kind == "op" and tok.value in _ADD_OPS:
                op = self.next().value
                left = BinaryOp(op, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            tok = self.peek()
            if tok.kind == "op" and tok.value in _MUL_OPS:
                op = self.next().value
                left = BinaryOp(op, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            operand = self.parse_unary()
            if isinstance(operand, Literal) and isinstance(operand.value, (int, float)):
                return Literal(-operand.value)
            return UnaryOp("-", operand)
        self.accept_op("+")
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        tok = self.peek()
        if tok.kind == "number":
            self.next()
            text = tok.value
            if "." in text or "e" in text or "E" in text:
                return Literal(float(text))
            return Literal(int(text))
        if tok.kind == "string":
            self.next()
            return Literal(tok.value)
        if tok.kind == "keyword":
            if self.accept_kw("null"):
                return Literal(None)
            if self.accept_kw("true"):
                return Literal(True)
            if self.accept_kw("false"):
                return Literal(False)
            if self.accept_kw("case"):
                return self.parse_case()
            if self.accept_kw("cast"):
                self.expect_op("(")
                inner = self.parse_expr()
                self.expect_kw("as")
                ttok = self.next()
                self.expect_op(")")
                return Cast(inner, ttok.value.lower())
            raise SqlError(f"Unexpected keyword {tok.value!r} in expression")
        if tok.kind == "op" and tok.value == "(":
            self.next()
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if tok.kind == "ident":
            return self.parse_ident_expr()
        raise SqlError(f"Unexpected token {tok.value!r} in expression at {tok.pos}")

    def parse_case(self) -> Expr:
        branches = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            branches.append((cond, val))
        default = self.parse_expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        if not branches:
            raise SqlError("CASE requires at least one WHEN branch")
        return Case(tuple(branches), default)

    def parse_ident_expr(self) -> Expr:
        name = self.next().value
        # function call
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()
            distinct = self.accept_kw("distinct")
            args: List[Expr] = []
            if self.accept_op("*"):
                args.append(Star())
            elif not (self.peek().kind == "op" and self.peek().value == ")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            return FuncCall(name.lower(), tuple(args), distinct)
        # qualified column a.b(.c)
        parts = [name]
        while self.peek().kind == "op" and self.peek().value == "." and self.peek(1).kind == "ident":
            self.next()
            parts.append(self.next().value)
        return Column(".".join(parts))


# ---------------------------------------------------------------------------
# Select planning (aggregate extraction, HAVING, ORDER BY resolution)
# ---------------------------------------------------------------------------


def build_select(
    plan: LogicalPlan,
    select_exprs: List[Expr],
    group_by: List[Expr],
    having: Optional[Expr],
    order_keys: List[Tuple[Expr, bool]],
    limit: Optional[int],
    offset: int,
    distinct: bool,
) -> LogicalPlan:
    # resolve aliases usable in GROUP BY / HAVING / ORDER BY
    alias_map = {e.alias: e.expr for e in select_exprs if isinstance(e, Alias)}

    def resolve_alias(e: Expr) -> Expr:
        def sub(node: Expr) -> Expr:
            if isinstance(node, Column) and node.ident in alias_map:
                return alias_map[node.ident]
            return node
        return map_expr(e, sub)

    group_by = [resolve_alias(g) for g in group_by]
    if having is not None:
        having = resolve_alias(having)
    order_keys = [(resolve_alias(e), asc) for e, asc in order_keys]

    has_star = any(isinstance(strip_alias(e), Star) for e in select_exprs)

    # collect aggregates across select + having + order by
    aggs: List[FuncCall] = []
    for e in select_exprs:
        for a in collect_aggregates(e):
            if a not in aggs:
                aggs.append(a)
    if having is not None:
        for a in collect_aggregates(having):
            if a not in aggs:
                aggs.append(a)
    for e, _ in order_keys:
        for a in collect_aggregates(e):
            if a not in aggs:
                aggs.append(a)

    is_aggregate_query = bool(group_by) or bool(aggs)

    if is_aggregate_query:
        if has_star:
            raise SqlError("SELECT * cannot be combined with GROUP BY / aggregates")
        agg_plan = Aggregate(plan, tuple(group_by), tuple(aggs))
        # After aggregation, group keys and agg results are addressable by name.
        group_names = {g.name() for g in group_by}
        agg_names = {a.name() for a in aggs}

        def rewrite_post_agg(e: Expr) -> Expr:
            def sub(node: Expr) -> Expr:
                if node.name() in agg_names and isinstance(node, FuncCall):
                    return Column(node.name())
                if node.name() in group_names and not isinstance(node, Column):
                    return Column(node.name())
                return node
            # top-level exact matches first (so whole group expr maps to a column)
            if e.name() in group_names or (isinstance(e, FuncCall) and e.name() in agg_names):
                return Column(e.name())
            return map_expr(e, sub)

        new_select = []
        for e in select_exprs:
            if isinstance(e, Alias):
                new_select.append(Alias(rewrite_post_agg(e.expr), e.alias))
            else:
                new_select.append(rewrite_post_agg(e))
        plan = agg_plan
        if having is not None:
            plan = Filter(plan, rewrite_post_agg(having))
        order_keys = [(rewrite_post_agg(e), asc) for e, asc in order_keys]
        select_exprs = new_select

    plan = Projection(plan, tuple(select_exprs))

    if distinct:
        plan = Distinct(plan)

    if order_keys:
        # ORDER BY may reference output columns by alias or ordinal
        out_names = [e.name() for e in select_exprs]
        keys = []
        for e, asc in order_keys:
            if isinstance(e, Literal) and isinstance(e.value, int):
                if not (1 <= e.value <= len(out_names)):
                    raise SqlError(f"ORDER BY ordinal {e.value} out of range")
                e = Column(out_names[e.value - 1])
            else:
                # prefer output column when expression matches a projected expr
                for sel in select_exprs:
                    if strip_alias(sel).name() == e.name() or sel.name() == e.name():
                        e = Column(sel.name())
                        break
            keys.append(SortKey(e, asc))
        plan = Sort(plan, tuple(keys))

    if limit is not None or offset:
        plan = Limit(plan, limit, offset)

    return plan


def parse_sql(sql: str) -> LogicalPlan:
    """Parse a single SELECT statement into a LogicalPlan (``parser.rs:9-22``)."""
    return Parser(sql).parse_statement()
