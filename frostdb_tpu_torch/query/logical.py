"""Logical plan nodes and builder (reference: query/logicalplan/
{logicalplan.go, builder.go}).

Plan nodes are single-input (logicalplan.go:17); the builder produces the
same node chains as the reference, including the avg rewrite into
sum/count + post-projection (builder.go:203 resolveAggregation — the plan
logictest golden "Projection (stacktrace, sum(value) / count(value) as
avg(value))" depends on it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from . import expr as E
from ..columnbatch import KIND_BOOL, KIND_DICT, KIND_FLOAT64, KIND_INT64, KIND_UINT64
from ..schema import Schema


@dataclass
class TableScan:
    provider: object  # TableProvider
    table_name: str
    # Pushed-down options (reference: logicalplan.go TableScan fields set by
    # the optimizers, optimize.go).
    physical_projection: list[E.Expr] = field(default_factory=list)
    filter: Optional[E.Expr] = None
    distinct_columns: list[E.Expr] = field(default_factory=list)
    projection: list[E.Expr] = field(default_factory=list)


@dataclass
class SchemaScan:
    provider: object
    table_name: str
    physical_projection: list[E.Expr] = field(default_factory=list)
    filter: Optional[E.Expr] = None
    distinct_columns: list[E.Expr] = field(default_factory=list)
    projection: list[E.Expr] = field(default_factory=list)


@dataclass
class Filter:
    expr: E.Expr


@dataclass
class Projection:
    exprs: list[E.Expr]


@dataclass
class Distinct:
    exprs: list[E.Expr]


@dataclass
class Aggregation:
    group_exprs: list[E.Expr]
    agg_exprs: list[E.AggregationFunction]


@dataclass
class Join:
    """Equi-join against an independent right-side subplan.

    The reference has no join operator (verified by grep over query/ —
    SURVEY.md §2.8 makes the distributed hash join a north-star extension,
    seeded by the serialized-plan federation protocol,
    reference proto/frostdb/storage/v1alpha1/storage.proto:6). Semantics:
    SQL equi-join on the named columns; null keys never match; output rows
    are ordered (left stream row, right row) — deterministic on any device
    count.
    """

    right: "LogicalPlan"
    on: list[str]
    how: str = "inner"  # inner | left_outer | semi | anti


JOIN_MODES = ("inner", "left_outer", "semi", "anti")


@dataclass
class OrderBy:
    """Sorted emission of the output stream (north-star SQL surface; the
    reference's sqlparse has no ORDER BY — verified by grep — but its sort
    machinery exists as pqarrow/arrowutils/sort.go SortRecord, which this
    node's physical Sorter mirrors). ``keys`` is a list of
    (column_name, direction) with direction "asc" | "desc"; ties keep
    stream order (stable sort), nulls sort last."""

    keys: list  # [(name, "asc"|"desc"), ...]


@dataclass
class Limit:
    expr: E.Expr  # literal row count


@dataclass
class Sample:
    expr: E.Expr  # sample size
    limit: E.Expr  # byte budget


class LogicalPlan:
    """One node + its input (reference: logicalplan.go LogicalPlan)."""

    def __init__(self, input_: Optional["LogicalPlan"] = None, **kwargs):
        self.input = input_
        self.table_scan: Optional[TableScan] = kwargs.get("table_scan")
        self.schema_scan: Optional[SchemaScan] = kwargs.get("schema_scan")
        self.filter: Optional[Filter] = kwargs.get("filter")
        self.projection: Optional[Projection] = kwargs.get("projection")
        self.distinct: Optional[Distinct] = kwargs.get("distinct")
        self.aggregation: Optional[Aggregation] = kwargs.get("aggregation")
        self.limit: Optional[Limit] = kwargs.get("limit")
        self.sample: Optional[Sample] = kwargs.get("sample")
        self.join: Optional[Join] = kwargs.get("join")
        self.order_by: Optional[OrderBy] = kwargs.get("order_by")

    def accept_post(self, fn) -> bool:
        """Post-order traversal (reference: PostPlanVisitorFunc)."""
        if self.input is not None:
            if not self.input.accept_post(fn):
                return False
        return fn(self)

    def accept_pre(self, fn) -> bool:
        if not fn(self):
            return False
        if self.input is not None:
            return self.input.accept_pre(fn)
        return True

    def scan_node(self):
        node = self
        while node is not None:
            if node.table_scan is not None:
                return node.table_scan
            if node.schema_scan is not None:
                return node.schema_scan
            node = node.input
        return None

    def input_schema(self) -> Optional[Schema]:
        scan = self.scan_node()
        if scan is None:
            return None
        table = scan.provider.get_table(scan.table_name)
        if table is None:
            return None
        return table.schema()

    # ------------------------------------------------------------------
    # Type inference (reference: logicalplan.go DataTypeForExpr).

    def data_type_for_expr(self, expr: E.Expr) -> str:
        schema = self.input_schema()

        def col_kind(name: str) -> str:
            if schema is None:
                return KIND_INT64
            c = schema.column_by_name(name)
            if c is None:
                return KIND_INT64
            from ..columnbatch import kind_for_layout

            return kind_for_layout(c.layout)

        def infer(e: E.Expr) -> str:
            if isinstance(e, (E.Column, E.DynamicColumn)):
                return col_kind(e.column_name)
            if isinstance(e, E.Literal):
                v = e.value
                if isinstance(v, bool):
                    return KIND_BOOL
                if isinstance(v, float):
                    return KIND_FLOAT64
                if isinstance(v, str) or v is None:
                    return KIND_DICT
                return KIND_INT64
            if isinstance(e, E.AggregationFunction):
                if e.func == E.AGG_COUNT:
                    return KIND_INT64
                return infer(e.expr)
            if isinstance(e, E.AliasExpr):
                return infer(e.expr)
            if isinstance(e, E.ConvertExpr):
                return e.to_type
            if isinstance(e, E.BinaryExpr):
                if e.op in E.COMPARE_OPS or e.op in (
                    E.OP_AND,
                    E.OP_OR,
                    E.OP_REGEX_MATCH,
                    E.OP_REGEX_NOT_MATCH,
                    E.OP_CONTAINS,
                    E.OP_NOT_CONTAINS,
                ):
                    return KIND_BOOL
                lk = infer(e.left)
                rk = infer(e.right)
                if KIND_FLOAT64 in (lk, rk):
                    return KIND_FLOAT64
                return lk if lk != KIND_INT64 else rk
            if isinstance(e, E.IsNullExpr):
                return KIND_BOOL
            if isinstance(e, E.DurationExpr):
                return KIND_INT64
            return KIND_INT64

        return infer(expr)


class Builder:
    """Immutable fluent plan builder (reference: builder.go:10)."""

    def __init__(self, plan: Optional[LogicalPlan] = None, err: Exception | None = None):
        self.plan = plan
        self.err = err

    def _next(self, **kwargs) -> "Builder":
        return Builder(LogicalPlan(self.plan, **kwargs), self.err)

    def scan(self, provider, table_name: str) -> "Builder":
        return Builder(
            LogicalPlan(None, table_scan=TableScan(provider, table_name)), self.err
        )

    def schema_scan(self, provider, table_name: str) -> "Builder":
        return Builder(
            LogicalPlan(None, schema_scan=SchemaScan(provider, table_name)), self.err
        )

    def filter(self, expr: E.Expr) -> "Builder":
        return self._next(filter=Filter(expr))

    def distinct(self, *exprs: E.Expr) -> "Builder":
        return self._next(distinct=Distinct(list(exprs)))

    def project(self, *exprs: E.Expr) -> "Builder":
        return self._next(projection=Projection(list(exprs)))

    def limit(self, expr: E.Expr) -> "Builder":
        return self._next(limit=Limit(expr))

    def order_by(self, *keys) -> "Builder":
        """Sorted emission: each key is a column name (ascending) or a
        (name, "asc"|"desc") pair."""
        norm = []
        for k in keys:
            if isinstance(k, str):
                norm.append((k, "asc"))
            else:
                name, direction = k
                if direction not in ("asc", "desc"):
                    return Builder(
                        self.plan,
                        ValueError(f"order_by direction {direction!r}"),
                    )
                norm.append((name, direction))
        return self._next(order_by=OrderBy(norm))

    def sample(self, expr: E.Expr, limit: E.Expr) -> "Builder":
        return self._next(sample=Sample(expr, limit))

    def join(self, right, on, how: str = "inner") -> "Builder":
        """Equi-join this plan (the probe/left side) with ``right`` (another
        Builder or LogicalPlan; the build side) on the named key columns."""
        rplan = right.plan if isinstance(right, Builder) else right
        if isinstance(on, str):
            on = [on]
        return self._next(join=Join(rplan, list(on), how))

    def aggregate(
        self,
        agg_exprs: Sequence[E.AggregationFunction],
        group_exprs: Sequence[E.Expr],
    ) -> "Builder":
        """reference: builder.go:151 Aggregate — rewrites avg into sum+count
        plus a post-projection ``sum(x)/count(x) as avg(x)``."""
        resolved: list[E.AggregationFunction] = []
        projections: list[E.Expr] = []
        needs_post = False
        for agg in agg_exprs:
            if agg.func == E.AGG_AVG:
                needs_post = True
                s = E.Sum(agg.expr)
                c = E.Count(agg.expr)
                count_expr: E.Expr = c
                agg_type = (
                    self.plan.data_type_for_expr(agg.expr)
                    if self.plan is not None
                    else KIND_INT64
                )
                if agg_type != KIND_INT64:
                    count_expr = E.Convert(c, agg_type)
                div = E.BinaryExpr(s, E.OP_DIV, count_expr).alias(agg.name())
                resolved.extend([s, c])
                projections.append(div)
            else:
                resolved.append(agg)
                projections.append(agg)

        agg_plan = LogicalPlan(
            self.plan,
            aggregation=Aggregation(list(group_exprs), resolved),
        )
        if not needs_post:
            # Keep the original (unresolved) agg exprs, like the reference.
            agg_plan.aggregation = Aggregation(list(group_exprs), list(agg_exprs))
            return Builder(agg_plan, self.err)
        proj_plan = LogicalPlan(
            agg_plan, projection=Projection(list(group_exprs) + projections)
        )
        return Builder(proj_plan, self.err)

    def build(self) -> LogicalPlan:
        if self.err is not None:
            raise self.err
        from .validate import validate

        validate(self.plan)
        return self.plan
