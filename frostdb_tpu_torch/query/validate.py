"""Plan validation (reference: query/logicalplan/validate.go).

Checks that each node carries exactly one field and that aggregations /
filter comparisons are well-typed for the scanned schema.
"""

from __future__ import annotations

from . import expr as E
from ..columnbatch import KIND_DICT, KIND_FLOAT64, KIND_INT64
from .logical import LogicalPlan


class PlanValidationError(Exception):
    pass


def validate(plan: LogicalPlan) -> None:
    node = plan
    while node is not None:
        _validate_node(node)
        node = node.input


def _validate_node(node: LogicalPlan) -> None:
    fields = [
        f
        for f in (
            node.table_scan,
            node.schema_scan,
            node.filter,
            node.projection,
            node.distinct,
            node.aggregation,
            node.limit,
            node.sample,
            node.join,
            node.order_by,
        )
        if f is not None
    ]
    if len(fields) != 1:
        raise PlanValidationError(
            f"plan node must have exactly one field, found {len(fields)}"
        )
    if node.aggregation is not None:
        _validate_aggregation(node)
    if node.join is not None:
        _validate_join(node)
    if node.filter is not None:
        _validate_filter_expr(node, node.filter.expr)


def _find_expr(e: E.Expr, cls):
    """First sub-expression of the given class, pre-order (reference:
    validate.go:457 findExpressionForTypeVisitor)."""
    found = []

    def visit(x):
        if not found and isinstance(x, cls):
            found.append(x)
        return not found

    e.accept(visit)
    return found[0] if found else None


def _validate_filter_expr(node: LogicalPlan, e: E.Expr) -> None:
    """Filter type validation (reference: validate.go:334-455): AND/OR
    subtrees recurse; comparison leaves check the literal's type against
    the column's storage layout, so an ill-typed filter raises
    PlanValidationError at plan time instead of a runtime EvalError."""
    if not isinstance(e, E.BinaryExpr):
        return
    if e.op in (E.OP_AND, E.OP_OR):
        sides = []
        for side, sub in (("left", e.left), ("right", e.right)):
            try:
                _validate_filter_expr(node, sub)
            except PlanValidationError as err:
                sides.append((side, err))
        if sides:
            raise PlanValidationError(
                "invalid children: "
                + " ".join(f"{s} ({err})" for s, err in sides)
            )
        return
    col = _find_expr(e.left, E.Column)
    if col is None or isinstance(col, E.DynamicColumn):
        raise PlanValidationError(
            "left side of binary expression must be a column"
        )
    schema = node.input_schema()
    if schema is None:
        return
    cdef = schema.column_by_name(col.column_name)
    if cdef is None:
        return  # dynamic/unknown columns tolerated (validate.go:366 found)
    lit = _find_expr(e.right, E.Literal)
    if lit is None:
        return
    _validate_comparing_types(cdef.layout.type, lit.value, e)


def _validate_comparing_types(col_type: str, value, e: E.Expr) -> None:
    """reference: validate.go:385 ValidateComparingTypes."""
    if value is None:
        return  # ==/!= null compares validity, any column type
    if col_type == "string":
        if isinstance(value, bool) or isinstance(value, (int, float)):
            raise PlanValidationError(
                "incompatible types: string column cannot be compared "
                f"with numeric literal ({e.left.name()} {e.op} {value!r})"
            )
    elif col_type in ("int64", "double", "uint64", "int32"):
        if isinstance(value, str):
            raise PlanValidationError(
                "incompatible types: numeric column cannot be compared "
                f"with string literal ({e.left.name()} {e.op} {value!r})"
            )
    elif col_type == "bool":
        # str literals coerce at eval time ('true'/'false' — the reference
        # parser produces a Boolean scalar before validation, so its nil-
        # logical-type check never sees them, logictest exec/projection/bool)
        if not isinstance(value, (bool, str)):
            raise PlanValidationError(
                "incompatible types: bool column cannot be compared "
                f"with {type(value).__name__} literal"
            )


def _validate_join(node: LogicalPlan) -> None:
    from .logical import JOIN_MODES

    join = node.join
    if join.how not in JOIN_MODES:
        raise PlanValidationError(f"unknown join mode {join.how!r}")
    if not join.on:
        raise PlanValidationError("join needs at least one key column")
    if join.right is None:
        raise PlanValidationError("join needs a right-side plan")
    validate(join.right)


def _validate_aggregation(node: LogicalPlan) -> None:
    # No sum/max/min of string columns (reference: validate.go aggregation
    # type checks).
    for agg in node.aggregation.agg_exprs:
        if agg.func in (E.AGG_SUM, E.AGG_MIN, E.AGG_MAX, E.AGG_AVG):
            kind = node.data_type_for_expr(agg.expr)
            if kind == KIND_DICT:
                raise PlanValidationError(
                    f"cannot {agg.func} over string column {agg.expr.name()}"
                )
