"""Logical expression tree (reference: query/logicalplan/expr.go).

Expression ``name()`` strings reproduce the reference's ``Expr.Name()``
exactly — they are load-bearing: physical column matching, aggregation result
naming ("sum(value)", expr.go:701), and the explain diagrams compared by the
plan logictests all key off these strings.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

# Binary operators (reference: expr.go:13-33; String() at expr.go:35).
OP_EQ = "=="
OP_NOT_EQ = "!="
OP_LT = "<"
OP_LT_EQ = "<="
OP_GT = ">"
OP_GT_EQ = ">="
OP_REGEX_MATCH = "=~"
OP_REGEX_NOT_MATCH = "!~"
OP_AND = "&&"
OP_OR = "||"
OP_ADD = "+"
OP_SUB = "-"
OP_MUL = "*"
OP_DIV = "/"
OP_CONTAINS = "contains"
OP_NOT_CONTAINS = "not contains"

COMPARE_OPS = {OP_EQ, OP_NOT_EQ, OP_LT, OP_LT_EQ, OP_GT, OP_GT_EQ}
ARITH_OPS = {OP_ADD, OP_SUB, OP_MUL, OP_DIV}

# Aggregation functions (reference: expr.go:731 AggFunc.String).
AGG_SUM = "sum"
AGG_MIN = "min"
AGG_MAX = "max"
AGG_COUNT = "count"
AGG_AVG = "avg"
AGG_UNIQUE = "unique"
AGG_AND = "and"


class Expr:
    def name(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.name()

    def alias(self, alias: str) -> "AliasExpr":
        return AliasExpr(self, alias)

    def children(self) -> Sequence["Expr"]:
        return ()

    def accept(self, fn: Callable[["Expr"], bool]) -> None:
        """Pre-order visit; fn returning False prunes the subtree."""
        if fn(self):
            for c in self.children():
                c.accept(fn)

    def columns_used(self) -> list["Expr"]:
        """Column-matcher expressions used anywhere in this expr
        (reference: expr.go ColumnsUsedExprs)."""
        out: list[Expr] = []

        def visit(e: Expr) -> bool:
            if isinstance(e, (Column, DynamicColumn, AllExpr)):
                out.append(e)
            elif isinstance(e, DurationExpr):
                # Windowed keys read the timestamp column (reference:
                # expr.go DurationExpr.ColumnsUsedExprs).
                out.append(Column("timestamp"))
            return True

        self.accept(visit)
        return out

    def matches_column(self, concrete_name: str) -> bool:
        """Does this expr (as a matcher) match the given concrete column?"""
        return False

    # sugar for building binary expressions
    def _bin(self, op: str, other) -> "BinaryExpr":
        return BinaryExpr(self, op, _lit(other))

    def __mul__(self, other):
        return self._bin(OP_MUL, other)

    def __truediv__(self, other):
        return self._bin(OP_DIV, other)

    def __add__(self, other):
        return self._bin(OP_ADD, other)

    def __sub__(self, other):
        return self._bin(OP_SUB, other)


def _lit(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


class Column(Expr):
    """Concrete column reference (reference: expr.go:330)."""

    def __init__(self, name: str):
        self.column_name = name

    def name(self) -> str:
        return self.column_name

    def matches_column(self, concrete_name: str) -> bool:
        return concrete_name == self.column_name

    def eq(self, other):
        return self._bin(OP_EQ, other)

    def not_eq(self, other):
        return self._bin(OP_NOT_EQ, other)

    def gt(self, other):
        return self._bin(OP_GT, other)

    def gt_eq(self, other):
        return self._bin(OP_GT_EQ, other)

    def lt(self, other):
        return self._bin(OP_LT, other)

    def lt_eq(self, other):
        return self._bin(OP_LT_EQ, other)

    def regex_match(self, pattern: str):
        return BinaryExpr(self, OP_REGEX_MATCH, Literal(pattern))

    def regex_not_match(self, pattern: str):
        return BinaryExpr(self, OP_REGEX_NOT_MATCH, Literal(pattern))

    def contains(self, s: str):
        return BinaryExpr(self, OP_CONTAINS, Literal(s))

    def not_contains(self, s: str):
        return BinaryExpr(self, OP_NOT_CONTAINS, Literal(s))


def Col(name: str) -> Column:
    return Column(name)


class DynamicColumn(Expr):
    """Dynamic column family reference, matches every concrete instantiation
    (reference: expr.go:518 DynCol)."""

    def __init__(self, family: str):
        self.column_name = family

    def name(self) -> str:
        return self.column_name

    def matches_column(self, concrete_name: str) -> bool:
        return concrete_name == self.column_name or concrete_name.startswith(
            self.column_name + "."
        )


def DynCol(name: str) -> DynamicColumn:
    return DynamicColumn(name)


class AllExpr(Expr):
    """Wildcard matcher (reference: expr.go:1139)."""

    def name(self) -> str:
        return "all"

    def matches_column(self, concrete_name: str) -> bool:
        return True


class Literal(Expr):
    """Literal value (reference: expr.go:586 LiteralExpr). ``value`` is a
    Python value: int, float, str, bool or None (null)."""

    def __init__(self, value):
        self.value = value

    def name(self) -> str:
        v = self.value
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float):
            # arrow scalar Float64 String() prints the shortest repr
            return repr(v)
        return str(v)


class BinaryExpr(Expr):
    """reference: expr.go:105; Name at :182 — no parentheses, children joined
    with the op symbol (goldens rely on this, e.g. "timestamp / 1000 * 1000")."""

    def __init__(self, left: Expr, op: str, right: Expr):
        self.left = left
        self.op = op
        self.right = right

    def name(self) -> str:
        return f"{self.left.name()} {self.op} {self.right.name()}"

    def children(self):
        return (self.left, self.right)

    def alias(self, alias: str) -> "AliasExpr":
        return AliasExpr(self, alias)


def And(*exprs: Expr) -> Expr:
    """reference: expr.go And() — left-fold into OpAnd binary exprs."""
    return _fold(OP_AND, exprs)


def Or(*exprs: Expr) -> Expr:
    return _fold(OP_OR, exprs)


def _fold(op: str, exprs: Sequence[Expr]) -> Expr:
    assert exprs
    e = exprs[0]
    for nxt in exprs[1:]:
        e = BinaryExpr(e, op, nxt)
    return e


class AggregationFunction(Expr):
    """reference: expr.go:648; Name "func(expr)" at :701."""

    def __init__(self, func: str, expr: Expr):
        self.func = func
        self.expr = expr

    def name(self) -> str:
        return f"{self.func}({self.expr.name()})"

    def children(self):
        return (self.expr,)

    def alias(self, alias: str) -> "AliasExpr":
        return AliasExpr(self, alias)


def Sum(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_SUM, e)


def Min(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_MIN, e)


def Max(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_MAX, e)


def Count(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_COUNT, e)


def Avg(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_AVG, e)


def Unique(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_UNIQUE, e)


def AndAgg(e: Expr) -> AggregationFunction:
    return AggregationFunction(AGG_AND, e)


class AliasExpr(Expr):
    """reference: expr.go:1000; Name() is the alias, String() is
    "expr as alias" (expr.go:1033)."""

    def __init__(self, expr: Expr, alias_name: str):
        self.expr = expr
        self.alias_name = alias_name

    def name(self) -> str:
        return self.alias_name

    def __str__(self) -> str:
        return f"{self.expr} as {self.alias_name}"

    def children(self):
        return (self.expr,)


class ConvertExpr(Expr):
    """reference: expr.go:207; Name "convert(expr, type)" at :267.
    ``to_type`` is a column kind (columnbatch.KIND_*)."""

    def __init__(self, expr: Expr, to_type: str):
        self.expr = expr
        self.to_type = to_type

    def name(self) -> str:
        return f"convert({self.expr.name()}, {self.to_type})"

    def children(self):
        return (self.expr,)


def Convert(e: Expr, to_type: str) -> ConvertExpr:
    return ConvertExpr(e, to_type)


class IsNullExpr(Expr):
    """reference: expr.go:801."""

    def __init__(self, expr: Expr):
        self.expr = expr

    def name(self) -> str:
        return f"isnull({self.expr.name()})"

    def children(self):
        return (self.expr,)


class IfExpr(Expr):
    """reference: expr.go:880."""

    def __init__(self, cond: Expr, then: Expr, els: Expr):
        self.cond = cond
        self.then = then
        self.els = els

    def name(self) -> str:
        return f"if({self.cond.name()}, {self.then.name()}, {self.els.name()})"

    def children(self):
        return (self.cond, self.then, self.els)


class DurationExpr(Expr):
    """Windowed-aggregation key (reference: expr.go:1072). Groups rows into
    fixed windows of ``milliseconds`` over the timestamp column."""

    def __init__(self, milliseconds: int):
        self.milliseconds = milliseconds

    def name(self) -> str:
        return f"second({self.milliseconds // 1000})"

    def matches_column(self, concrete_name: str) -> bool:
        return concrete_name == "timestamp"


def Duration(milliseconds: int) -> DurationExpr:
    return DurationExpr(milliseconds)


class NotExpr(Expr):
    """reference: expr.go:1219. As a column matcher, matches whatever the
    inner matcher does not (used for the default physical projection
    Not(DynCol("hashed")), optimize.go:12)."""

    def __init__(self, expr: Expr):
        self.expr = expr

    def name(self) -> str:
        return f"not({self.expr.name()})"

    def children(self):
        return (self.expr,)

    def matches_column(self, concrete_name: str) -> bool:
        return not self.expr.matches_column(concrete_name)
