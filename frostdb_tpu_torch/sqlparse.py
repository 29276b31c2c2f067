"""Experimental SQL frontend (reference: sqlparse/{parser,visitor}.go; the
JAX package's frostdb_tpu/sqlparse.py, copied with its imports rewritten).

A recursive-descent parser for the reference's SQL subset (the TiDB-parser
surface actually used: SELECT fields, WHERE with and/or/parens, comparisons,
regexp / like, GROUP BY, LIMIT, DISTINCT(...), EXPLAIN, aggregate functions,
second(), convert()). Plan construction replicates the reference visitor's
pre/post-projection split around aggregations (visitor.go:57-155) so the
resulting plans — and their explain strings — are identical.

North-star surface beyond the reference (whose sqlparse has no FROM/JOIN/
ORDER BY/IN/HAVING — verified by grep): FROM <table>, [INNER|LEFT [OUTER]|
SEMI|ANTI] JOIN <table> ON <col> [= <col>] / USING(<col>) lowered onto the
engine's join (and the round-5 groupjoin fusion), IN (...) value lists
lowered to OR/AND CNF (fast-tier friendly), HAVING as a post-aggregation
filter over the result columns, and ORDER BY col [ASC|DESC] via the
Sorter operator.

HAVING applies with or without GROUP BY: without it, it filters the
projected (or distinct) output rows as MySQL does. The JAX package's copy
drops a HAVING that has no GROUP BY.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from .query import expr as E


class SQLParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<number>\d+\.\d+|\d+)
    | (?P<string>'(?:[^']*)')
    | (?P<op><=|>=|!=|<>|=|<|>|\(|\)|,|\*|/|\+|-)
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z0-9_]+)*)
    )""",
    re.VERBOSE,
)


def tokenize(sql: str) -> list[tuple[str, str]]:
    # '#' starts a comment to end of line (mysql-style, used in goldens).
    lines = []
    for line in sql.split("\n"):
        i = line.find("#")
        if i >= 0:
            line = line[:i]
        lines.append(line)
    sql = " ".join(lines)
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            if sql[pos:].strip() == "":
                break
            raise SQLParseError(f"unexpected character at {sql[pos:]!r}")
        pos = m.end()
        if m.lastgroup == "number":
            tokens.append(("number", m.group("number")))
        elif m.lastgroup == "string":
            tokens.append(("string", m.group("string")[1:-1]))
        elif m.lastgroup == "op":
            tokens.append(("op", m.group("op")))
        else:
            tokens.append(("ident", m.group("ident")))
    return tokens


AGG_FUNCS = {
    "sum": E.Sum,
    "min": E.Min,
    "max": E.Max,
    "count": E.Count,
    "avg": E.Avg,
}


@dataclass
class ParseResult:
    explain: bool
    plan: object  # LocalQueryBuilder


def _resolve_having(e: E.Expr) -> E.Expr:
    """Rewrite aggregate-function nodes in a HAVING predicate to column
    references on their result names (the aggregation already emitted
    them)."""
    if isinstance(e, E.AggregationFunction):
        return E.Col(e.name())
    if isinstance(e, E.BinaryExpr):
        return E.BinaryExpr(
            _resolve_having(e.left), e.op, _resolve_having(e.right)
        )
    return e


class Parser:
    """reference: sqlparse/parser.go:30 ExperimentalParse."""

    def parse(self, query_builder, dyn_col_names: list[str], sql: str) -> ParseResult:
        p = _Parser(tokenize(sql), set(dyn_col_names))
        return p.parse_statement(query_builder)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]], dyn_cols: set[str]):
        self.tokens = tokens
        self.pos = 0
        self.dyn_cols = dyn_cols

    # -- token helpers ----------------------------------------------------

    def peek(self) -> Optional[tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        t = self.peek()
        if t is None:
            raise SQLParseError("unexpected end of input")
        self.pos += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t is not None and t[0] == "ident" and t[1].lower() in kws:
            self.pos += 1
            return t[1].lower()
        return None

    def expect_kw(self, kw: str) -> None:
        if self.accept_kw(kw) is None:
            raise SQLParseError(f"expected {kw!r} at {self.peek()}")

    def accept_op(self, *ops: str) -> Optional[str]:
        t = self.peek()
        if t is not None and t[0] == "op" and t[1] in ops:
            self.pos += 1
            return t[1]
        return None

    def expect_op(self, op: str) -> None:
        if self.accept_op(op) is None:
            raise SQLParseError(f"expected {op!r} at {self.peek()}")

    # -- grammar ----------------------------------------------------------

    def parse_statement(self, builder) -> ParseResult:
        explain = self.accept_kw("explain") is not None
        self.expect_kw("select")

        distinct = False
        fields: list[E.Expr] = []
        if self.accept_kw("distinct"):
            distinct = True
            self.expect_op("(")
            fields.append(self.parse_expr())
            while self.accept_op(","):
                fields.append(self.parse_expr())
            self.expect_op(")")
        else:
            fields.append(self.parse_field())
            while self.accept_op(","):
                fields.append(self.parse_field())

        from_table = None
        join_spec = None  # (how, table, key)
        if self.accept_kw("from"):
            t = self.next()
            if t[0] != "ident":
                raise SQLParseError(f"expected table name, got {t}")
            from_table = t[1]
            how = None
            if self.accept_kw("inner"):
                how = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                how = "left_outer"
            elif self.accept_kw("semi"):
                how = "semi"
            elif self.accept_kw("anti"):
                how = "anti"
            if self.accept_kw("join"):
                how = how or "inner"
                t2 = self.next()
                if t2[0] != "ident":
                    raise SQLParseError(f"expected join table, got {t2}")
                if self.accept_kw("using"):
                    self.expect_op("(")
                    kt = self.next()
                    self.expect_op(")")
                    key = kt[1]
                elif self.accept_kw("on"):
                    kt = self.next()
                    if kt[0] != "ident":
                        raise SQLParseError(f"expected join key, got {kt}")
                    key = kt[1]
                    if self.accept_op("="):
                        kt2 = self.next()
                        if kt2[1] != key:
                            raise SQLParseError(
                                "join keys must be the same column name"
                            )
                else:
                    raise SQLParseError("join needs ON <col> or USING(<col>)")
                join_spec = (how, t2[1], key)
            elif how is not None:
                raise SQLParseError("expected 'join'")

        where_expr = None
        if self.accept_kw("where"):
            where_expr = self.parse_or()

        group_by: Optional[list[E.Expr]] = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by = []
            if self.accept_op("("):
                group_by.append(self.parse_expr())
                while self.accept_op(","):
                    group_by.append(self.parse_expr())
                self.expect_op(")")
            else:
                group_by.append(self.parse_expr())
                while self.accept_op(","):
                    group_by.append(self.parse_expr())

        having_expr = None
        if self.accept_kw("having"):
            having_expr = self.parse_or()

        order_keys: Optional[list] = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_keys = []
            while True:
                t = self.next()
                if t[0] != "ident":
                    raise SQLParseError(f"expected order column, got {t}")
                direction = "asc"
                if self.accept_kw("desc"):
                    direction = "desc"
                else:
                    self.accept_kw("asc")
                order_keys.append((t[1], direction))
                if self.accept_op(",") is None:
                    break

        limit: Optional[int] = None
        if self.accept_kw("limit"):
            t = self.next()
            if t[0] != "number":
                raise SQLParseError(f"expected limit count, got {t}")
            limit = int(t[1])

        if self.peek() is not None:
            raise SQLParseError(f"unexpected trailing tokens: {self.peek()}")

        # -- plan construction (visitor.go:44-160 Enter) -------------------
        if from_table is not None:
            engine = getattr(builder, "engine", None)
            if engine is None:
                raise SQLParseError("FROM requires an engine-bound builder")
            builder = engine.scan_table(from_table)
            if join_spec is not None:
                how, right_name, key = join_spec
                builder = builder.join(
                    engine.scan_table(right_name), on=[key], how=how
                )
        if where_expr is not None:
            builder = builder.filter(where_expr)

        no_preproject = from_table is not None and join_spec is not None
        if group_by is not None:
            pre: list[E.Expr] = []
            post: list[E.Expr] = []
            aggs: list[E.AggregationFunction] = []
            included_pre: set[str] = set()
            for f in fields:
                found: list[E.AggregationFunction] = []

                def visit(e: E.Expr, found=found) -> bool:
                    if isinstance(e, E.AggregationFunction):
                        found.append(e)
                    return True

                f.accept(visit)
                if found:
                    for agg in found:
                        if agg.expr.name() not in included_pre:
                            pre.append(agg.expr)
                            included_pre.add(agg.expr.name())
                        aggs.append(agg)
                    post.append(f)
                else:
                    pre.append(f)
                    if isinstance(f, (E.DynamicColumn, E.DurationExpr)):
                        # Projected by matcher semantics (DynCol) / window
                        # alignment (Duration — physeval's DurationExpr
                        # projection emits the aligned "timestamp" key);
                        # a plain Col(f.name()) would match nothing.
                        post.append(f)
                    else:
                        post.append(E.Col(f.name()))
            for g in group_by:
                if not any(g.name() == p.name() for p in pre):
                    pre.append(g)
            if not no_preproject:
                # joined queries skip the pre-projection: it would apply
                # ABOVE the join and drop build-side columns the
                # aggregation reads
                builder = builder.project(*pre)
            builder = builder.aggregate(aggs, group_by)
            builder = builder.project(*post)
        elif distinct:
            builder = builder.project(*fields)
            builder = builder.distinct(*fields)
        else:
            builder = builder.project(*fields)
        if having_expr is not None:
            # HAVING = a filter over the output columns; aggregate-function
            # references resolve BY RESULT NAME against the emitted batch
            # (count(value) -> the "count(value)" column), evaluated by the
            # generic PredicateFilter on the result rows
            builder = builder.filter(_resolve_having(having_expr))
        if order_keys is not None:
            builder = builder.order_by(*order_keys)
        if limit is not None:
            builder = builder.limit(E.Literal(limit))

        return ParseResult(explain=explain, plan=builder)

    def parse_field(self) -> E.Expr:
        e = self.parse_expr()
        if self.accept_kw("as"):
            t = self.next()
            if t[0] != "ident":
                raise SQLParseError(f"expected alias name, got {t}")
            e = e.alias(t[1])
        return e

    # Precedence: or < and < comparison < add/sub < mul/div < primary.

    def parse_or(self) -> E.Expr:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = E.BinaryExpr(e, E.OP_OR, self.parse_and())
        return e

    def parse_and(self) -> E.Expr:
        e = self.parse_comparison()
        while self.accept_kw("and"):
            e = E.BinaryExpr(e, E.OP_AND, self.parse_comparison())
        return e

    def parse_expr(self) -> E.Expr:
        return self.parse_comparison()

    def parse_comparison(self) -> E.Expr:
        left = self.parse_additive()
        op = self.accept_op("=", "!=", "<>", "<", "<=", ">", ">=")
        if op is not None:
            right = self.parse_additive()
            opmap = {
                "=": E.OP_EQ,
                "!=": E.OP_NOT_EQ,
                "<>": E.OP_NOT_EQ,
                "<": E.OP_LT,
                "<=": E.OP_LT_EQ,
                ">": E.OP_GT,
                ">=": E.OP_GT_EQ,
            }
            return E.BinaryExpr(left, opmap[op], right)
        # [not] regexp / like (visitor.go PatternRegexpExpr / LikeExpr: the
        # left side is rewritten to a concrete Column reference) and
        # [not] in (...) value lists, lowered to OR-of-eq / AND-of-neq —
        # the CNF shapes every fast tier accepts.
        negate = False
        save = self.pos
        if self.accept_kw("not"):
            negate = True
        if self.accept_kw("in"):
            self.expect_op("(")
            lits = [self.parse_additive()]
            while self.accept_op(","):
                lits.append(self.parse_additive())
            self.expect_op(")")
            op_ = E.OP_NOT_EQ if negate else E.OP_EQ
            e = None
            for lit in lits:
                leaf = E.BinaryExpr(left, op_, lit)
                if e is None:
                    e = leaf
                elif negate:
                    e = E.BinaryExpr(e, E.OP_AND, leaf)
                else:
                    e = E.BinaryExpr(e, E.OP_OR, leaf)
            return e
        kw = self.accept_kw("regexp", "like")
        if kw is None:
            if negate:
                self.pos = save
            return left
        right = self.parse_additive()
        if kw == "regexp":
            op_ = E.OP_REGEX_NOT_MATCH if negate else E.OP_REGEX_MATCH
        else:
            op_ = E.OP_NOT_CONTAINS if negate else E.OP_CONTAINS
        return E.BinaryExpr(E.Col(left.name()), op_, right)

    def parse_additive(self) -> E.Expr:
        e = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-")
            if op is None:
                return e
            e = E.BinaryExpr(
                e, E.OP_ADD if op == "+" else E.OP_SUB, self.parse_multiplicative()
            )

    def parse_multiplicative(self) -> E.Expr:
        e = self.parse_primary()
        while True:
            op = self.accept_op("*", "/")
            if op is None:
                return e
            e = E.BinaryExpr(
                e, E.OP_MUL if op == "*" else E.OP_DIV, self.parse_primary()
            )

    def parse_primary(self) -> E.Expr:
        t = self.peek()
        if t is None:
            raise SQLParseError("unexpected end of expression")
        kind, val = t
        if kind == "op" and val == "(":
            self.next()
            e = self.parse_or()
            self.expect_op(")")
            return e
        if kind == "number":
            self.next()
            if "." in val:
                return E.Literal(float(val))
            return E.Literal(int(val))
        if kind == "string":
            self.next()
            return E.Literal(val)
        if kind == "ident":
            low = val.lower()
            if low == "null":
                self.next()
                return E.Literal(None)
            if low in ("true", "false"):
                self.next()
                return E.Literal(low == "true")
            if low in AGG_FUNCS:
                # function call?
                if self._is_call():
                    self.next()
                    self.expect_op("(")
                    inner = self.parse_expr()
                    self.expect_op(")")
                    return AGG_FUNCS[low](inner)
            if low == "second" and self._is_call():
                self.next()
                self.expect_op("(")
                n = self.parse_expr()
                self.expect_op(")")
                if not isinstance(n, E.Literal):
                    raise SQLParseError("second() requires a literal")
                return E.Duration(int(n.value) * 1000)
            if low == "convert" and self._is_call():
                self.next()
                self.expect_op("(")
                inner = self.parse_expr()
                self.expect_op(",")
                tt = self.next()
                self.expect_op(")")
                from .columnbatch import KIND_FLOAT64, KIND_INT64

                type_map = {"float": KIND_FLOAT64, "double": KIND_FLOAT64, "int": KIND_INT64}
                if tt[1].lower() not in type_map:
                    raise SQLParseError(f"unhandled cast type {tt[1]}")
                return E.Convert(inner, type_map[tt[1].lower()])
            self.next()
            base = val.split(".")[0]
            if val in self.dyn_cols or (base in self.dyn_cols and "." not in val):
                return E.DynCol(val)
            return E.Col(val)
        raise SQLParseError(f"unexpected token {t}")

    def _is_call(self) -> bool:
        nxt = (
            self.tokens[self.pos + 1] if self.pos + 1 < len(self.tokens) else None
        )
        return nxt is not None and nxt == ("op", "(")
