"""Compiled distinct serving (port of ``frostdb_tpu/compiled_distinct.py``;
the Parca Types/Values headline shapes, reference bench_test.go:107,123).

``scan.distinct(cols...)`` is a group-by with no aggregations: the fused
whole-query program (compiled.py) already computes per-code counts and
first-occurrence order, and ``emit_output`` with an empty aggregation list
emits exactly the distinct key rows in the generic Distinction's
first-occurrence stream order (distinct.go; physeval.distinct_rows). On
the device that is one count-only sum/count kernel pass (no value plane): K2
(``group_sum_count``) over the selection plane, K1 where the filter is a
band of range compares, K4 where it is one int ``==``/``!=``.

Beyond plain dict/int64 columns, distinct exprs may be comparison
expressions (``value > N`` — the Types query's projected compare): the
generic boolExprProjection emits a dense true/false key with no nulls
(project.go:405), which is exactly a filter leaf's mask — so comparison
keys lower as 2-code "bool" group columns evaluated by the same leaf
machinery as CNF filters.

Null keys (dict/int columns with invalid slots) fall back to the generic
engine, which emits the null-key group.
"""

from __future__ import annotations

from .compiled import CompiledFilterAggregate, NotCompilable
from .query import expr as E


class CompiledDistinct(CompiledFilterAggregate):
    """Distinct = the fused group machinery with zero aggregations."""

    # (the base class allows 4 group columns; kept explicit here)
    MAX_GROUP_COLS = 4
    SPAN = "compiled_distinct/execute"


def match_plan_distinct(plan, exec_options=None) -> CompiledDistinct:
    """Match: TableScan <- [Filter] <- [pass-through Projections] <-
    Distinct. Distinct exprs: plain columns (dict/int64 per schema) or
    ``col <op> literal`` comparisons."""
    node = plan
    if node is None or node.distinct is None:
        raise NotCompilable("root is not a distinct")
    exprs = list(node.distinct.exprs)
    node = node.input

    filt = None
    pre_sets: list[tuple[set, list, bool]] = []
    while node is not None and (
        node.filter is not None or node.projection is not None
    ):
        if node.projection is not None:
            names: set = set()
            dyns: list = []
            has_all = False
            for e in node.projection.exprs:
                if type(e) is E.Column:
                    names.add(e.column_name)
                elif isinstance(e, E.DynamicColumn):
                    dyns.append(e.column_name)
                elif isinstance(e, E.AllExpr):
                    has_all = True
                elif isinstance(e, E.BinaryExpr):
                    # computed distinct keys arrive pre-projected (the
                    # sqlparse path); they also project by name
                    names.add(e.name())
                else:
                    raise NotCompilable("computed pre-projection")
            pre_sets.append((names, dyns, has_all))
        else:
            if filt is not None:
                raise NotCompilable("multiple filter nodes")
            filt = node.filter.expr
        node = node.input
    if node is None or node.table_scan is None:
        raise NotCompilable("input is not a plain table scan")
    scan = node.table_scan
    table = scan.provider.get_table(scan.table_name)
    if table is None:
        raise NotCompilable(f"table not found: {scan.table_name}")

    specs: list = []
    # each entry: alternatives — ANY surviving the pre-projection suffices
    # (a computed bool key may flow as its projected column by name).
    needed: list[tuple] = []
    seen: set = set()
    for e in exprs:
        if type(e) is E.Column:
            if e.column_name in seen:
                continue  # generic dedups by name, first wins
            seen.add(e.column_name)
            specs.append(e.column_name)
            needed.append((e.column_name,))
        elif (
            isinstance(e, E.BinaryExpr)
            and e.op in E.COMPARE_OPS
            and type(e.left) is E.Column
            and isinstance(e.right, E.Literal)
        ):
            name = e.name()
            if name in seen:
                continue
            seen.add(name)
            specs.append(
                ("bool", e.left.column_name, e.op, e.right.value, name)
            )
            needed.append((e.left.column_name, name))
        else:
            raise NotCompilable("distinct expr not compiled")
    if not specs:
        raise NotCompilable("no distinct keys")

    # CNF filter flattening — same shape as match_plan.
    filter_spec = None
    if filt is not None:
        conjuncts: list = []

        def flatten(x) -> None:
            if isinstance(x, E.BinaryExpr) and x.op == E.OP_AND:
                flatten(x.left)
                flatten(x.right)
                return
            conjuncts.append(x)

        def leaf_tuple(x):
            if not (
                isinstance(x, E.BinaryExpr)
                and type(x.left) is E.Column
                and isinstance(x.right, E.Literal)
            ):
                raise NotCompilable("filter is not a CNF of col <op> literal")
            return (x.left.column_name, x.op, x.right.value)

        def flatten_or(x, out: list) -> None:
            if isinstance(x, E.BinaryExpr) and x.op == E.OP_OR:
                flatten_or(x.left, out)
                flatten_or(x.right, out)
                return
            out.append(leaf_tuple(x))

        flatten(filt)
        filter_spec = []
        for x in conjuncts:
            if isinstance(x, E.BinaryExpr) and x.op == E.OP_OR:
                ors: list = []
                flatten_or(x, ors)
                filter_spec.append(ors)
            else:
                filter_spec.append(leaf_tuple(x))
        needed += [
            (t[0],)
            for cl in filter_spec
            for t in (cl if isinstance(cl, list) else [cl])
        ]

    if pre_sets:

        def projected(name: str) -> bool:
            for names, dyns, has_all in pre_sets:
                if has_all or name in names:
                    continue
                if any(
                    name == d or name.startswith(d + ".") for d in dyns
                ):
                    continue
                return False
            return True

        for alts in needed:
            if not any(projected(name) for name in alts):
                raise NotCompilable(
                    f"pre-projection drops {alts[0]} (generic semantics)"
                )

    return CompiledDistinct(
        table,
        specs,
        [],  # no aggregations: counts + first-occurrence only
        filter_spec,
        None,
        filter_expr=filt,
    )


def lower_plan_distinct(plan, exec_options=None) -> CompiledDistinct:
    return match_plan_distinct(plan, exec_options)
