"""Plan optimizers (reference: query/logicalplan/optimize.go).

Four top-down passes annotating the scan node in place:
- PhysicalProjectionPushDown (optimize.go:27)
- FilterPushDown (optimize.go:81)
- DistinctPushDown (optimize.go:113)
- AggFuncPushDown (optimize.go:166)
"""

from __future__ import annotations

from typing import Optional

from . import expr as E
from .logical import LogicalPlan

HASHED_MATCH = "hashed"


def default_optimizers():
    return [
        PhysicalProjectionPushDown([E.NotExpr(E.DynCol(HASHED_MATCH))]),
        FilterPushDown(),
        DistinctPushDown(),
        AggFuncPushDown(),
    ]


def optimize(plan: LogicalPlan) -> LogicalPlan:
    for o in default_optimizers():
        plan = o.optimize(plan)
    # Join right-side subplans are independent pipelines: optimize each
    # recursively. The right output feeds the join in full, so its physical
    # projection starts from keep-all rather than the empty set (a bare
    # ``scan.filter(...)`` right side must not be pruned to its filter
    # columns).
    node = plan
    while node is not None:
        if node.join is not None:
            node.join.right = _optimize_join_right(node.join.right)
        node = node.input
    return plan


def _optimize_join_right(plan: LogicalPlan) -> LogicalPlan:
    keep_all = [E.NotExpr(E.DynCol(HASHED_MATCH))]
    pp = PhysicalProjectionPushDown(keep_all)
    pp._walk(plan, list(keep_all))
    for o in (FilterPushDown(), DistinctPushDown(), AggFuncPushDown()):
        plan = o.optimize(plan)
    node = plan
    while node is not None:
        if node.join is not None:
            node.join.right = _optimize_join_right(node.join.right)
        node = node.input
    return plan


class PhysicalProjectionPushDown:
    def __init__(self, default_projections):
        self.default_projections = list(default_projections)

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        self._walk(plan, [])
        return plan

    def _walk(self, plan: LogicalPlan, used: list) -> None:
        if plan.schema_scan is not None:
            plan.schema_scan.physical_projection = self.default_projections + used
        elif plan.table_scan is not None:
            plan.table_scan.physical_projection = self.default_projections + used
        elif plan.filter is not None:
            self.default_projections = []
            used = used + plan.filter.expr.columns_used()
        elif plan.distinct is not None:
            used = []
            for e in plan.distinct.exprs:
                used += e.columns_used()
        elif plan.projection is not None:
            used = []
            for e in plan.projection.exprs:
                used += e.columns_used()
        elif plan.aggregation is not None:
            used = []
            for e in plan.aggregation.group_exprs:
                used += e.columns_used()
            for e in plan.aggregation.agg_exprs:
                used += e.columns_used()
            self.default_projections = []
            used = used + [E.DynCol(HASHED_MATCH)]
        elif plan.join is not None:
            # The join emits every left column; keep-all below this point
            # (the right side is optimized separately, optimize()).
            self.default_projections = []
            used = [E.NotExpr(E.DynCol(HASHED_MATCH))]
        if plan.input is not None:
            self._walk(plan.input, used)


class FilterPushDown:
    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        self._walk(plan, [])
        return plan

    def _walk(self, plan: LogicalPlan, exprs: list) -> None:
        if plan.schema_scan is not None:
            if exprs:
                plan.schema_scan.filter = E.And(*exprs)
        elif plan.table_scan is not None:
            if exprs:
                plan.table_scan.filter = E.And(*exprs)
        elif plan.filter is not None:
            exprs = exprs + [plan.filter.expr]
        elif plan.join is not None:
            # A filter above a join may reference right-side (or
            # join-produced null) columns — never push it past the join; the
            # PredicateFilter operator still applies it post-join.
            exprs = []
        if plan.input is not None:
            self._walk(plan.input, exprs)


def _exprs_equal(a: list, b: list) -> bool:
    if len(a) != len(b):
        return False
    return all(x.name() == y.name() for x, y in zip(a, b))


class DistinctPushDown:
    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        self._walk(plan, [])
        return plan

    def _walk(self, plan: LogicalPlan, cols: list) -> None:
        if plan.table_scan is not None:
            if cols:
                plan.table_scan.distinct_columns = cols
        elif plan.distinct is not None:
            cols = cols + plan.distinct.exprs
        elif plan.projection is not None:
            if not _exprs_equal(cols, plan.projection.exprs):
                cols = []
        else:
            cols = []
        if plan.input is not None:
            self._walk(plan.input, cols)


class AggFuncPushDown:
    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        self._walk(plan, None)
        return plan

    def _walk(self, plan: LogicalPlan, filter_expr: Optional[E.Expr]) -> None:
        if plan.table_scan is not None:
            if filter_expr is not None:
                plan.table_scan.filter = filter_expr
        elif plan.aggregation is not None:
            if (
                len(plan.aggregation.group_exprs) == 0
                and len(plan.aggregation.agg_exprs) == 1
            ):
                filter_expr = plan.aggregation.agg_exprs[0]
            else:
                filter_expr = None
        else:
            filter_expr = None
        if plan.input is not None:
            self._walk(plan.input, filter_expr)
