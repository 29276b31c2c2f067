"""Expression evaluation over column batches.

Two evaluators mirroring the reference's physical expression machinery:

- ``filter_mask``: logical predicate -> boolean row mask (reference:
  query/physicalplan/filter.go booleanExpr + binaryscalarexpr.go +
  regexpfilter.go, including the missing-column semantics of
  BinaryScalarExpr.Eval, binaryscalarexpr.go:41-75).
- ``project_expr``: projection expr -> output Columns (reference:
  query/physicalplan/project.go projectionFromExpr :757).

String predicates are evaluated on the table-global dictionary host-side and
turned into code-membership lookups on device (the vectorized generalization of
DictionaryArrayScalarEqual, binaryscalarexpr.go:194).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from . import expr as E
from ..columnbatch import (
    Column,
    ColumnBatch,
    KIND_BOOL,
    KIND_DICT,
    KIND_FLOAT64,
    KIND_INT64,
    KIND_UINT64,
)


class EvalError(Exception):
    pass


def missing_column_all_true(op: str, lit) -> bool:
    """Missing-dynamic-column semantics for one ``col <op> literal`` leaf —
    THE single source of truth (reference: binaryscalarexpr.go:47-72,
    regexpfilter.go:23-33). True means the predicate matches every row of a
    batch/part lacking the column; False means it matches none. Shared by
    the generic mask evaluator (_binary_scalar_mask), the scan pruner
    (lsm.prune_part) and the compiled/mesh fast paths
    (compiled._missing_leaf_all_true), so the byte-identical parity contract
    between the paths cannot drift. Raises ``re.error`` for an invalid regex
    literal — callers decide (generic path surfaces it, pruning treats it as
    not-provable, compiled paths fall back to the generic engine)."""
    if op in (E.OP_REGEX_MATCH, E.OP_REGEX_NOT_MATCH):
        empty_match = (
            re.compile(lit if lit is not None else "").search("") is not None
        )
        return (op == E.OP_REGEX_MATCH) == empty_match
    if op == E.OP_EQ:
        return not (lit is not None and isinstance(lit, str) and lit != "")
    if op == E.OP_NOT_EQ:
        return lit is not None
    if op in (E.OP_LT, E.OP_LT_EQ, E.OP_GT, E.OP_GT_EQ):
        return False
    # OpContains etc. fall through to all-match (binaryscalarexpr.go:71).
    return True


# ---------------------------------------------------------------------------
# Filter masks


def filter_mask(batch: ColumnBatch, expr: E.Expr) -> np.ndarray:
    """Boolean mask of rows matching the predicate."""
    n = batch.num_rows
    if isinstance(expr, E.BinaryExpr):
        if expr.op == E.OP_AND:
            left = filter_mask(batch, expr.left)
            if not left.any():  # short-circuit (filter.go:174)
                return left
            return left & filter_mask(batch, expr.right)
        if expr.op == E.OP_OR:
            return filter_mask(batch, expr.left) | filter_mask(batch, expr.right)
        return _binary_scalar_mask(batch, expr)
    raise EvalError(f"unsupported boolean expression {expr!r}")


def _left_column_name(expr: E.Expr) -> Optional[str]:
    """First Column in pre-order (filter.go:82)."""
    found: list[str] = []

    def visit(e: E.Expr) -> bool:
        if found:
            return False
        if isinstance(e, (E.Column, E.DynamicColumn)):
            found.append(e.column_name)
            return False
        return True

    expr.accept(visit)
    return found[0] if found else None


def _right_literal(expr: E.Expr):
    found: list = []

    def visit(e: E.Expr) -> bool:
        if found:
            return False
        if isinstance(e, E.Literal):
            found.append(e.value)
            return False
        return True

    expr.accept(visit)
    return found[0] if found else None


def _binary_scalar_mask(batch: ColumnBatch, expr: E.BinaryExpr) -> np.ndarray:
    n = batch.num_rows
    col_name = _left_column_name(expr.left)
    lit = _right_literal(expr.right)
    if col_name is None:
        raise EvalError("left side of binary expression must be a column")
    col = batch.column(col_name)
    op = expr.op

    if col is None:
        # Missing column semantics (binaryscalarexpr.go:47-72 and
        # regexpfilter.go:23-33) via the shared helper.
        if missing_column_all_true(op, lit):
            return np.ones(n, dtype=np.bool_)
        return np.zeros(n, dtype=np.bool_)

    if col.kind == KIND_DICT:
        return _dict_mask(col, op, lit)

    # Numeric / bool columns.
    if lit is None:
        # Arrow compute comparisons against null yield all-null -> empty
        # bitmap (binaryscalarexpr.go ArrayScalarCompute skips nulls).
        return np.zeros(n, dtype=np.bool_)
    if op in (E.OP_REGEX_MATCH, E.OP_REGEX_NOT_MATCH, E.OP_CONTAINS, E.OP_NOT_CONTAINS):
        raise EvalError(f"unsupported operator {op} for {col.kind} column")
    vals = col.values
    if col.kind == KIND_BOOL and isinstance(lit, str):
        lit = lit == "true"
    if col.kind == KIND_UINT64:
        lit = np.uint64(lit)
    cmp = _np_compare(vals, lit, op)
    return cmp & col.validity


def _np_compare(vals: np.ndarray, lit, op: str) -> np.ndarray:
    if op == E.OP_EQ:
        return vals == lit
    if op == E.OP_NOT_EQ:
        return vals != lit
    if op == E.OP_LT:
        return vals < lit
    if op == E.OP_LT_EQ:
        return vals <= lit
    if op == E.OP_GT:
        return vals > lit
    if op == E.OP_GT_EQ:
        return vals >= lit
    raise EvalError(f"unsupported compare op {op}")


def _dict_mask(col: Column, op: str, lit) -> np.ndarray:
    d = col.dictionary
    codes = col.values
    valid = col.validity
    if op in (E.OP_EQ, E.OP_NOT_EQ) and lit is None:
        # = null / != null (DictionaryArrayScalarEqual null special case,
        # binaryscalarexpr.go:205).
        return ~valid if op == E.OP_EQ else valid.copy()
    if op == E.OP_EQ:
        code = d.lookup(str(lit))
        if code is None:
            return np.zeros(len(col), dtype=np.bool_)
        return (codes == code) & valid
    if op == E.OP_NOT_EQ:
        code = d.lookup(str(lit))
        if code is None:
            return valid.copy()
        return (codes != code) & valid
    if op in (E.OP_REGEX_MATCH, E.OP_REGEX_NOT_MATCH):
        rx = re.compile(str(lit))
        lut = np.fromiter(
            (rx.search(v) is not None for v in d.values),
            dtype=np.bool_,
            count=len(d.values),
        )
        if op == E.OP_REGEX_NOT_MATCH:
            lut = ~lut
        if len(lut) == 0:
            return np.zeros(len(col), dtype=np.bool_)
        return lut[codes] & valid
    if op in (E.OP_CONTAINS, E.OP_NOT_CONTAINS):
        s = str(lit)
        lut = np.fromiter(
            (s in v for v in d.values), dtype=np.bool_, count=len(d.values)
        )
        if op == E.OP_NOT_CONTAINS:
            lut = ~lut
        if len(lut) == 0:
            return np.zeros(len(col), dtype=np.bool_)
        return lut[codes] & valid
    # Ordering comparisons on strings: compare dictionary values.
    s = str(lit)
    lut = np.fromiter(
        (_np_str_compare(v, s, op) for v in d.values),
        dtype=np.bool_,
        count=len(d.values),
    )
    if len(lut) == 0:
        return np.zeros(len(col), dtype=np.bool_)
    return lut[codes] & valid


def _np_str_compare(v: str, s: str, op: str) -> bool:
    if op == E.OP_LT:
        return v < s
    if op == E.OP_LT_EQ:
        return v <= s
    if op == E.OP_GT:
        return v > s
    if op == E.OP_GT_EQ:
        return v >= s
    raise EvalError(f"unsupported string compare {op}")


# ---------------------------------------------------------------------------
# Projections


def project_expr(batch: ColumnBatch, expr: E.Expr) -> list[Column]:
    """Evaluate a projection expr into zero or more output columns."""
    if isinstance(expr, E.AllExpr):
        return list(batch.columns)
    if isinstance(expr, E.AliasExpr):
        cols = project_expr(batch, expr.expr)
        return [
            Column(expr.alias_name, c.kind, c.values, c.validity, c.dictionary)
            for c in cols
        ]
    if isinstance(expr, E.DynamicColumn):
        fam = expr.column_name
        return [
            c
            for c in batch.columns
            if c.name == fam or c.name.startswith(fam + ".")
        ]
    if isinstance(expr, E.Column):
        c = batch.column(expr.column_name)
        return [c] if c is not None else []
    if isinstance(expr, E.Literal):
        return [_literal_column(expr, batch.num_rows)]
    if isinstance(expr, E.ConvertExpr):
        # Partially computed upstream? (project.go convertProjection)
        c = batch.column(expr.name())
        if c is not None:
            return [c]
        inner = _eval_value(batch, expr.expr)
        if inner is None:
            return []
        return [_convert(inner, expr.to_type, expr.name())]
    if isinstance(expr, E.AggregationFunction):
        c = batch.column(expr.name())
        return [c] if c is not None else []
    if isinstance(expr, E.BinaryExpr):
        c = batch.column(expr.name())
        if c is not None:
            return [c]
        if expr.op in E.COMPARE_OPS or expr.op in (
            E.OP_AND,
            E.OP_OR,
            E.OP_REGEX_MATCH,
            E.OP_REGEX_NOT_MATCH,
            E.OP_CONTAINS,
            E.OP_NOT_CONTAINS,
        ):
            # boolExprProjection (project.go:405): dense true/false, no nulls.
            mask = filter_mask(batch, expr)
            return [
                Column(
                    expr.name(),
                    KIND_BOOL,
                    mask,
                    np.ones(batch.num_rows, dtype=np.bool_),
                )
            ]
        out = _eval_value(batch, expr)
        if out is None:
            return []
        return [out]
    if isinstance(expr, E.IfExpr):
        # reference: project.go:615 ifExprProjection
        cond = filter_mask(batch, expr.cond)
        then_col = _eval_value(batch, expr.then)
        else_col = _eval_value(batch, expr.els)
        if then_col is None and else_col is None:
            return []
        template = then_col or else_col
        import numpy as _np

        n2 = batch.num_rows
        tvals = then_col.values if then_col is not None else _np.zeros(n2, template.values.dtype)
        tvalid = then_col.validity if then_col is not None else _np.zeros(n2, bool)
        evals = else_col.values if else_col is not None else _np.zeros(n2, template.values.dtype)
        evalid = else_col.validity if else_col is not None else _np.zeros(n2, bool)
        return [
            Column(
                expr.name(),
                template.kind,
                _np.where(cond, tvals, evals),
                _np.where(cond, tvalid, evalid),
                template.dictionary,
            )
        ]
    if isinstance(expr, E.IsNullExpr):
        inner = _eval_value(batch, expr.expr)
        if inner is None:
            valid = np.zeros(batch.num_rows, dtype=np.bool_)
        else:
            valid = inner.validity
        return [
            Column(
                expr.name(),
                KIND_BOOL,
                ~valid,
                np.ones(batch.num_rows, dtype=np.bool_),
            )
        ]
    if isinstance(expr, E.DurationExpr):
        # Window-key projection (the avg rewrite appends group exprs to the
        # post-aggregation projection, builder.go:190 — the reference's
        # projectionFromExpr has NO DurationExpr case and errors on this
        # shape; here the key passes through): truncate "timestamp" to the
        # window. Post-aggregation the values are already aligned, so the
        # truncation is idempotent.
        ts = batch.column("timestamp")
        if ts is None:
            return []
        w = max(expr.milliseconds, 1)
        return [
            Column(
                "timestamp",
                ts.kind,
                (ts.values // w) * w,
                ts.validity,
                ts.dictionary,
            )
        ]
    raise EvalError(f"unsupported projection expr {expr!r}")


def _literal_column(expr: E.Literal, n: int) -> Column:
    v = expr.value
    name = expr.name()
    if v is None:
        return Column.all_null(name, KIND_INT64, n)
    if isinstance(v, bool):
        return Column(
            name, KIND_BOOL, np.full(n, v, dtype=np.bool_), np.ones(n, dtype=np.bool_)
        )
    if isinstance(v, float):
        return Column(
            name,
            KIND_FLOAT64,
            np.full(n, v, dtype=np.float64),
            np.ones(n, dtype=np.bool_),
        )
    if isinstance(v, str):
        from ..columnbatch import Dictionary

        d = Dictionary()
        code = d.code(v)
        return Column(
            name,
            KIND_DICT,
            np.full(n, code, dtype=np.int32),
            np.ones(n, dtype=np.bool_),
            d,
        )
    return Column(
        name, KIND_INT64, np.full(n, v, dtype=np.int64), np.ones(n, dtype=np.bool_)
    )


def _convert(c: Column, to_kind: str, name: str) -> Column:
    if to_kind == KIND_FLOAT64:
        return Column(name, KIND_FLOAT64, c.values.astype(np.float64), c.validity)
    if to_kind == KIND_INT64:
        return Column(name, KIND_INT64, c.values.astype(np.int64), c.validity)
    raise EvalError(f"unsupported convert target {to_kind}")


def _eval_value(batch: ColumnBatch, expr: E.Expr) -> Optional[Column]:
    """Evaluate an expr into a single value column (arithmetic tree)."""
    n = batch.num_rows
    # Passthrough: a column computed upstream carries the expr's name.
    c = batch.column(expr.name()) if not isinstance(expr, E.Literal) else None
    if c is not None:
        return c
    if isinstance(expr, E.Column):
        return None  # missing -> caller decides (all-null / skip)
    if isinstance(expr, E.Literal):
        return _literal_column(expr, n)
    if isinstance(expr, E.AliasExpr):
        inner = _eval_value(batch, expr.expr)
        if inner is None:
            return None
        return Column(
            expr.alias_name, inner.kind, inner.values, inner.validity, inner.dictionary
        )
    if isinstance(expr, E.ConvertExpr):
        inner = _eval_value(batch, expr.expr)
        if inner is None:
            return None
        return _convert(inner, expr.to_type, expr.name())
    if isinstance(expr, E.BinaryExpr) and expr.op in E.ARITH_OPS:
        left = _eval_value(batch, expr.left)
        right = _eval_value(batch, expr.right)
        if left is None or right is None:
            return None
        return _arith(left, right, expr.op, expr.name(), n)
    raise EvalError(f"unsupported value expr {expr!r}")


def _arith(left: Column, right: Column, op: str, name: str, n: int) -> Column:
    lk, rk = left.kind, right.kind
    if KIND_FLOAT64 in (lk, rk):
        lv = left.values.astype(np.float64)
        rv = right.values.astype(np.float64)
        kind = KIND_FLOAT64
    elif KIND_UINT64 in (lk, rk):
        lv = left.values.astype(np.uint64)
        rv = right.values.astype(np.uint64)
        if op == "/":
            # unsigned division on the host (torch has no uint64 division)
            zero = rv == 0
            valid = left.validity & right.validity & ~zero
            out = lv // np.where(zero, np.uint64(1), rv)
            return Column(name, KIND_UINT64, out, valid)
        # wrapping uint64 +, -, * are int64 ops on the same bits
        lv = lv.view(np.int64)
        rv = rv.view(np.int64)
        kind = KIND_UINT64
    else:
        lv = left.values.astype(np.int64)
        rv = right.values.astype(np.int64)
        kind = KIND_INT64

    from ..ops import kernels as K

    out, valid = K.arith(lv, left.validity, rv, right.validity, op)
    out = out.numpy()
    if kind == KIND_UINT64:
        out = out.view(np.uint64)
    return Column(name, kind, out, valid.numpy())
