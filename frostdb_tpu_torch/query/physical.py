"""Physical plan: push-based operator DAG + planner + explain diagrams.

Reference: query/physicalplan/physicalplan.go. Operators implement
``callback(batch)`` / ``finish()`` / ``set_next`` / ``draw`` exactly like the
reference's PhysicalPlan interface (physicalplan.go:24-30). The planner
(``build_physical``) performs the same post-order walk with scan fan-out,
synchronizer barriers, two-phase aggregation and limit-of-limits /
distinct-of-distincts final stages (physicalplan.go:287-516), so the explain
diagrams are string-identical to the reference's plan logictest goldens.

Execution semantics: operator chains are lanes. Small scans push every batch
down lane 0; large scans split the part stream across lane THREADS in
contiguous chunks (Table._iterate), with the Synchronizer barrier flushing
lane buffers in lane order so the merged stream — and every downstream
result — is byte-identical to serial execution (the reference achieves
per-stream determinism only for single-record scans and marks multi-record
tests "unordered").

Device: the accumulating operators (aggregation, distinct, the join's match
expansion) run their kernels on the scanned table's torch device
(``Table.device``), which the planner threads from the scan node into every
such operator.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import expr as E
from .logical import LogicalPlan
from .physeval import EvalError, filter_mask, project_expr, _eval_value
from ..columnbatch import Column, ColumnBatch, Dictionary, concat_batches
from ..columnbatch import KIND_BOOL, KIND_DICT, KIND_FLOAT64, KIND_INT64
from ..columnbatch import KIND_UINT64
from ..ops import kernels as K


class Diagram:
    def __init__(self, details: str, child: Optional["Diagram"] = None):
        self.details = details
        self.child = child

    def string(self) -> str:
        if self.child is None:
            return self.details
        child = self.child.string()
        if not child:
            return self.details
        return f"{self.details} - {child}"


class PhysicalOperator:
    def __init__(self):
        self.next: Optional[PhysicalOperator] = None

    def set_next(self, nxt: "PhysicalOperator") -> None:
        self.next = nxt

    def callback(self, batch: ColumnBatch) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        if self.next is not None:
            self.next.finish()

    def close(self) -> None:
        if self.next is not None:
            self.next.close()

    def draw(self) -> Diagram:
        raise NotImplementedError


class NoopOperator(PhysicalOperator):
    """reference: physicalplan.go noopOperator."""

    def callback(self, batch: ColumnBatch) -> None:
        if self.next is not None:
            self.next.callback(batch)

    def draw(self) -> Diagram:
        if self.next is not None:
            return self.next.draw()
        return Diagram("")


class OutputPlan(PhysicalOperator):
    """Terminal operator delivering batches to the user callback
    (reference: physicalplan.go:40 OutputPlan)."""

    def __init__(self):
        super().__init__()
        self.scan = None
        self._callback: Optional[Callable[[ColumnBatch], None]] = None

    def set_next_callback(self, cb) -> None:
        self._callback = cb

    def callback(self, batch: ColumnBatch) -> None:
        if self._callback is not None and batch.num_rows >= 0:
            self._callback(batch)

    def finish(self) -> None:
        pass

    def close(self) -> None:
        pass

    def draw(self) -> Diagram:
        return Diagram("")

    def draw_string(self) -> str:
        return self.scan.draw().string()

    def execute(self, callback) -> None:
        self._callback = callback
        self.scan.execute()


# ---------------------------------------------------------------------------
# Scans


def _lit_value(e: E.Expr):
    if isinstance(e, E.Literal):
        return e.value
    raise EvalError(f"expected literal, got {e!r}")


class TableScanExec:
    def __init__(self, options, plans: list[PhysicalOperator]):
        self.options = options
        self.plans = plans

    def draw(self) -> Diagram:
        details = "TableScan"
        child = None
        if self.plans:
            child = self.plans[0].draw()
            if len(self.plans) > 1:
                details += " [concurrent]"
        return Diagram(details, child)

    def execute(self) -> None:
        table = self.options.provider.get_table(self.options.table_name)
        if table is None:
            raise RuntimeError(f"table not found: {self.options.table_name}")
        try:

            def run(tx):
                table.iterator(
                    tx,
                    [p.callback for p in self.plans],
                    physical_projection=self.options.physical_projection,
                    filter=self.options.filter,
                    distinct_columns=self.options.distinct_columns,
                    projection=self.options.projection,
                )

            table.view(run)
            for p in self.plans:
                p.finish()
        finally:
            for p in self.plans:
                p.close()


class SchemaScanExec:
    def __init__(self, options, plans: list[PhysicalOperator]):
        self.options = options
        self.plans = plans

    def draw(self) -> Diagram:
        details = "SchemaScan"
        child = None
        if self.plans:
            child = self.plans[0].draw()
            if len(self.plans) > 1:
                details += " [concurrent]"
        return Diagram(details, child)

    def execute(self) -> None:
        table = self.options.provider.get_table(self.options.table_name)
        if table is None:
            raise RuntimeError(f"table not found: {self.options.table_name}")
        try:

            def run(tx):
                table.schema_iterator(
                    tx,
                    [p.callback for p in self.plans],
                    filter=self.options.filter,
                )

            table.view(run)
            for p in self.plans:
                p.finish()
        finally:
            for p in self.plans:
                p.close()


# ---------------------------------------------------------------------------
# Filter


def _physical_filter_string(expr: E.Expr) -> str:
    """Physical BooleanExpression String (reference: AndExpr/OrExpr String
    filter.go:192,217; BinaryScalarExpr String binaryscalarexpr.go:78;
    RegExpFilter String regexpfilter.go:42)."""
    if isinstance(expr, E.BinaryExpr):
        if expr.op == E.OP_AND:
            return (
                "("
                + _physical_filter_string(expr.left)
                + " AND "
                + _physical_filter_string(expr.right)
                + ")"
            )
        if expr.op == E.OP_OR:
            return (
                "("
                + _physical_filter_string(expr.left)
                + " OR "
                + _physical_filter_string(expr.right)
                + ")"
            )
        left = expr.left.name()
        if expr.op in (E.OP_REGEX_MATCH, E.OP_REGEX_NOT_MATCH):
            pat = expr.right.name()
            sym = "=~" if expr.op == E.OP_REGEX_MATCH else "!~"
            return f'{left} {sym} "{pat}"'
        return f"{left} {expr.op} {expr.right.name()}"
    return expr.name()


class PredicateFilter(PhysicalOperator):
    """reference: query/physicalplan/filter.go PredicateFilter. Evaluates the
    predicate to a row mask and materializes matching rows."""

    def __init__(self, expr: E.Expr, allocator=None):
        super().__init__()
        self.expr = expr
        self.allocator = allocator

    def callback(self, batch: ColumnBatch) -> None:
        mask = filter_mask(batch, self.expr)
        if not mask.any():
            return  # empty results are not propagated (filter.go:276)
        filtered = batch.select_mask(mask)
        if self.allocator is not None:
            # Transient flow accounting (query/memory.go:17): charged while
            # the materialized copy is in flight; a downstream accumulator
            # re-charges whatever it retains.
            nbytes = _batch_bytes(filtered)
            self.allocator.allocate(nbytes)
            try:
                self.next.callback(filtered)
            finally:
                self.allocator.free(nbytes)
            return
        self.next.callback(filtered)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        return Diagram(
            f"PredicateFilter ({_physical_filter_string(self.expr)})", child
        )


# ---------------------------------------------------------------------------
# Projection


class Projection(PhysicalOperator):
    """reference: query/physicalplan/project.go."""

    def __init__(self, exprs: Sequence[E.Expr], allocator=None):
        super().__init__()
        self.exprs = list(exprs)
        self.allocator = allocator

    def callback(self, batch: ColumnBatch) -> None:
        cols: list[Column] = []
        seen: set[str] = set()
        for e in self.exprs:
            for c in project_expr(batch, e):
                if c.name in seen:
                    continue
                seen.add(c.name)
                cols.append(c)
        out = ColumnBatch(cols, batch.num_rows)
        if self.allocator is not None:
            nbytes = _batch_bytes(out)
            self.allocator.allocate(nbytes)
            try:
                self.next.callback(out)
            finally:
                self.allocator.free(nbytes)
            return
        self.next.callback(out)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        details = "Projection (" + ", ".join(str(e) for e in self.exprs) + ")"
        return Diagram(details, child)


# ---------------------------------------------------------------------------
# Synchronizer


class _SyncLane(PhysicalOperator):
    """Per-lane inlet of a Synchronizer barrier. Each scan lane owns one, so
    concurrent lane threads never touch shared downstream state: callbacks
    buffer into the lane's private list, and the barrier flushes the buffers
    in lane order on the last finish. Because the scan assigns parts to
    lanes in *contiguous chunks* (Table._iterate), lane-ordered flushing
    reproduces the exact serial stream order — output stays byte-identical
    to single-lane execution (the reference instead documents multi-lane
    output as unordered, synchronize.go:16)."""

    def __init__(self, sync: "Synchronizer", i: int):
        super().__init__()
        self.sync = sync
        self.i = i

    def callback(self, batch: ColumnBatch) -> None:
        self.sync._buffers[self.i].append(batch)

    def finish(self) -> None:
        self.sync.finish()

    def close(self) -> None:
        self.sync.close()

    def draw(self) -> Diagram:
        return self.sync.draw()


class Synchronizer(PhysicalOperator):
    """Fan-in barrier (reference: synchronize.go:16). Lane inlets buffer
    their streams; the last finish flushes all buffers in lane order and
    cascades downstream — deterministic regardless of lane-thread timing."""

    def __init__(self, arity: int):
        super().__init__()
        self.arity = arity
        self._finished = 0
        self._closed = 0
        self._buffers: list[list[ColumnBatch]] = [[] for _ in range(arity)]
        self._lanes = [_SyncLane(self, i) for i in range(arity)]

    def lane(self, i: int) -> _SyncLane:
        return self._lanes[i]

    def callback(self, batch: ColumnBatch) -> None:
        # Direct (non-lane) use: treat as lane 0.
        self._buffers[0].append(batch)

    def _flush(self) -> None:
        bufs = self._buffers
        self._buffers = [[] for _ in range(self.arity)]
        for buf in bufs:
            for b in buf:
                self.next.callback(b)

    def finish(self) -> None:
        self._finished += 1
        if self._finished == self.arity:
            self._flush()
            self.next.finish()

    def close(self) -> None:
        self._closed += 1
        if self._closed == self.arity:
            self.next.close()

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        return Diagram("Synchronizer", child)


# ---------------------------------------------------------------------------
# Batch unification (reference: pqarrow/arrowutils/schema.go EnsureSameSchema)


def unify_concat(batches: list[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches, backfilling missing columns with virtual nulls,
    columns ordered alphabetically."""
    if len(batches) == 1:
        return batches[0]
    specs: dict[str, Column] = {}
    for b in batches:
        for c in b.columns:
            if c.name not in specs:
                specs[c.name] = c
    names = sorted(specs)
    conformed = []
    for b in batches:
        cols = []
        for name in names:
            tmpl = specs[name]
            c = b.column(name)
            if c is None:
                c = Column.all_null(
                    name, tmpl.kind, b.num_rows, tmpl.dictionary,
                    template=tmpl,
                )
            cols.append(c)
        conformed.append(ColumnBatch(cols, b.num_rows))
    return concat_batches(conformed)


def _batch_bytes(b: ColumnBatch) -> int:
    return sum(c.values.nbytes + c.validity.nbytes for c in b.columns)


def _np(t) -> np.ndarray:
    """A kernel result on the host."""
    return t.cpu().numpy()


_U64_FLIP = np.uint64(1 << 63)


def _host_values(kind: str, vals: np.ndarray) -> np.ndarray:
    """Device values of a column back in host form: uint64 columns live on
    the device sign-flipped (device.py)."""
    if kind == "uint64":
        return vals.astype(np.int64).view(np.uint64) ^ _U64_FLIP
    return vals


def _kernel_src(func: str, src: Column) -> Column:
    """The column an aggregation reduces on the device. uint64 sums reduce
    the raw two's-complement bits (wrapping int64 adds give the uint64 sum
    mod 2^64, as the reference's wrapping uint64 adds do); every other
    reduction takes the column as uploaded."""
    if func == E.AGG_SUM and src.kind == KIND_UINT64:
        return Column(
            f"{src.name}#bits", KIND_INT64, src.values.view(np.int64),
            src.validity,
        )
    return src


def _agg_result(func: str, src: Column, vals: np.ndarray) -> np.ndarray:
    """A reduction's host result in the source column's dtype."""
    if src.kind == KIND_UINT64 and func != E.AGG_SUM:
        vals = _host_values(KIND_UINT64, vals)
    return vals.astype(src.values.dtype)


# ---------------------------------------------------------------------------
# Hash aggregation


_FINAL_AGG_FUNC = {
    # Final-stage re-aggregation of partials (reference: aggregate.go
    # runAggregation chooses sum for count in the final stage).
    E.AGG_SUM: K.AGG_SUM,
    E.AGG_COUNT: K.AGG_SUM,
    E.AGG_MIN: K.AGG_MIN,
    E.AGG_MAX: K.AGG_MAX,
    E.AGG_UNIQUE: K.AGG_UNIQUE,
    E.AGG_AND: K.AGG_AND,
}

_PARTIAL_AGG_FUNC = {
    E.AGG_SUM: K.AGG_SUM,
    E.AGG_COUNT: K.AGG_COUNT,
    E.AGG_MIN: K.AGG_MIN,
    E.AGG_MAX: K.AGG_MAX,
    E.AGG_UNIQUE: K.AGG_UNIQUE,
    E.AGG_AND: K.AGG_AND,
}


class HashAggregate(PhysicalOperator):
    """Grouped aggregation (reference: aggregate.go HashAggregate).

    Accumulates input batches, then runs the exact sort+segment group kernel
    once over the unified stream — groups are emitted in first-occurrence
    stream order, matching the reference's insertion-ordered group map.
    """

    def __init__(
        self, aggregations, group_exprs, final_stage: bool, allocator=None,
        device=None,
    ):
        super().__init__()
        self.device = device
        # aggregations: list of (func, inner_expr, result_name); duplicates
        # preserved for draw parity, deduped for execution (the reference
        # dedups in the final stage, aggregate.go:973).
        self.aggregations = list(aggregations)
        self.group_exprs = list(group_exprs)
        self.final_stage = final_stage
        self.allocator = allocator
        self._allocated = 0
        self._batches: list[ColumnBatch] = []

    def callback(self, batch: ColumnBatch) -> None:
        if self.allocator is not None:
            nbytes = sum(
                c.values.nbytes + c.validity.nbytes for c in batch.columns
            )
            self.allocator.allocate(nbytes)
            self._allocated += nbytes
        self._batches.append(batch)

    def finish(self) -> None:
        out = self._aggregate()
        if self.allocator is not None and self._allocated:
            self.allocator.free(self._allocated)
            self._allocated = 0
        if out is not None:
            self.next.callback(out)
        self.next.finish()

    def _aggregate(self) -> Optional[ColumnBatch]:
        if not self._batches:
            return None
        batch = unify_concat(self._batches)
        self._batches = []
        n = batch.num_rows
        if n == 0:
            return None

        # Resolve group key columns.
        group_cols: list[Column] = []
        seen: set[str] = set()
        for ge in self.group_exprs:
            matched = [
                c
                for c in batch.columns
                if ge.matches_column(c.name) and c.name not in seen
            ]
            if isinstance(ge, E.DurationExpr):
                # Window key: timestamp truncated to the window size.
                ts = batch.column("timestamp")
                if ts is not None:
                    w = self.milliseconds_window(ge)
                    vals = (ts.values // w) * w
                    matched = [Column("timestamp", KIND_INT64, vals, ts.validity)]
            for c in matched:
                seen.add(c.name)
                group_cols.append(c)

        # Resolve aggregation inputs (dedup by result name).
        agg_specs = []
        seen_aggs = set()
        for func, inner, result_name in self.aggregations:
            if result_name in seen_aggs:
                continue
            seen_aggs.add(result_name)
            src = batch.column(result_name) if self.final_stage else None
            # Whether the input already IS a partial result decides the op
            # per spec: a final stage over raw rows (single-stage float-sum
            # plans, concurrency=1) must COUNT rows, not sum partial counts.
            from_partial = src is not None
            if src is None:
                src = _eval_value(batch, inner)
            if src is None:
                src = Column.all_null(result_name, KIND_INT64, n)
            agg_specs.append((func, src, result_name, from_partial))

        # Exact float64 sums (floatsum.py): a gated float sum input expands
        # into four int64 digit-plane columns summed exactly by the kernel
        # and recombined host-side with ONE rounding. spec_map records each
        # original spec's kernel slots. Outside the gate (non-finite /
        # subnormal / overwide) the IEEE float reduction applies unchanged.
        from ..floatsum import column_meta, decompose_np, make_plan, recombine

        kernel_specs = []  # (func, src col) rows actually fed to the kernel
        spec_map = []  # per agg_spec: ("plain", i) | ("planes", [i*4], plan)
        for func, src, result_name, from_partial in agg_specs:
            if func in (E.AGG_MIN, E.AGG_MAX) and src.kind == "float64":
                kernel_specs.append(
                    (
                        func,
                        Column(
                            f"{result_name}#ord",
                            KIND_INT64,
                            _float_ord_encode(src.values),
                            src.validity,
                        ),
                        from_partial,
                    )
                )
                spec_map.append(("fminmax", len(kernel_specs) - 1))
                continue
            if func == E.AGG_SUM and src.kind == "float64":
                fplan = make_plan([column_meta(src.values)], n)
                if fplan is not None:
                    planes = decompose_np(src.values, fplan)
                    idxs = []
                    for pi, pv in enumerate(planes):
                        idxs.append(len(kernel_specs))
                        kernel_specs.append(
                            (
                                E.AGG_SUM,
                                Column(
                                    f"{result_name}#p{pi}",
                                    KIND_INT64,
                                    pv,
                                    src.validity,
                                ),
                                False,
                            )
                        )
                    spec_map.append(("planes", idxs, fplan))
                    continue
            spec_map.append(("plain", len(kernel_specs)))
            kernel_specs.append((func, _kernel_src(func, src), from_partial))

        from ..device import DeviceBatch

        dev = DeviceBatch(batch, self.device)
        sel = dev.row_valid_mask()
        key_vals = []
        key_valid = []
        for c in group_cols:
            dc = dev.column(c.name) if batch.column(c.name) is c else dev._upload(c)
            key_vals.append(dc.data)
            key_valid.append(dc.validity)
        agg_vals = []
        agg_valid = []
        ops = []
        for func, src, from_partial in kernel_specs:
            if batch.column(src.name) is src:
                dc = dev.column(src.name)
            else:
                dc = dev._upload(src)
            agg_vals.append(dc.data)
            agg_valid.append(dc.validity)
            table = _FINAL_AGG_FUNC if from_partial else _PARTIAL_AGG_FUNC
            ops.append(table[func])

        ng, _first, gk, gkv, av, avv = K.group_aggregate(
            tuple(key_vals),
            tuple(key_valid),
            tuple(agg_vals),
            tuple(agg_valid),
            sel,
            tuple(ops),
        )
        ng = int(ng)

        out_cols: list[Column] = []
        first_rows = None
        for c, v, va in zip(group_cols, gk, gkv):
            if c.kind == "list":
                # List keys group by their content hash; materialize each
                # group's payload from its first row.
                if first_rows is None:
                    first_rows = np.clip(
                        _np(_first)[:ng], 0, max(len(c) - 1, 0)
                    )
                lc = c.take(first_rows)
                out_cols.append(
                    Column(
                        c.name, c.kind,
                        _np(v)[:ng].astype(c.values.dtype),
                        _np(va)[:ng],
                        c.dictionary, c.layout,
                        offsets=lc.offsets, child=lc.child,
                    )
                )
                continue
            out_cols.append(
                Column(
                    c.name,
                    c.kind,
                    _host_values(c.kind, _np(v)[:ng]).astype(c.values.dtype),
                    _np(va)[:ng],
                    c.dictionary,
                )
            )
        for (func, src, result_name, _fp), m in zip(agg_specs, spec_map):
            if m[0] == "fminmax":
                i = m[1]
                vals = _float_ord_decode(_np(av[i])[:ng])
                out_cols.append(
                    Column(
                        result_name,
                        "float64",
                        vals,
                        _np(avv[i])[:ng],
                    )
                )
                continue
            if m[0] == "planes":
                _tag, idxs, fplan = m
                plane_sums = [_np(av[i])[:ng] for i in idxs]
                vals = recombine(plane_sums, fplan)
                out_cols.append(
                    Column(
                        result_name,
                        "float64",
                        vals,
                        np.ones(ng, dtype=np.bool_),
                    )
                )
                continue
            i = m[1]
            v, va = av[i], avv[i]
            kind = src.kind
            vals = _np(v)[:ng]
            if func == E.AGG_COUNT:
                kind = KIND_INT64
                vals = vals.astype(np.int64)
            elif func == E.AGG_AND:
                kind = KIND_BOOL
                vals = vals.astype(np.bool_)
            else:
                vals = _agg_result(func, src, vals)
            out_cols.append(Column(result_name, kind, vals, _np(va)[:ng]))
        return ColumnBatch(out_cols, ng)

    @staticmethod
    def milliseconds_window(ge: E.DurationExpr) -> int:
        return max(ge.milliseconds, 1)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        names = ",".join(rn for _f, _e, rn in self.aggregations)
        groupings = ",".join(g.name() for g in self.group_exprs)
        return Diagram(f"HashAggregate ({names} by {groupings})", child)


class OrderedAggregate(HashAggregate):
    """Streaming aggregation over sorted input (reference:
    ordered_aggregate.go). Groups are emitted in key order; the grouping pass
    is sort-free (``ordered_group_ids``) when the input arrived as a single
    sorted stream, falling back to sort + group when multiple out-of-order
    parts were merged (the reference's Finish-time MergeRecords +
    re-aggregation, ordered_aggregate.go:163)."""

    def _aggregate(self):
        if not self._batches:
            return None
        single_sorted = len(self._batches) == 1
        out = None
        if single_sorted:
            out = self._aggregate_ordered(self._batches[0])
            self._batches = []
        if out is None:
            # Fall back to the exact sorted-group kernel; sort emission by
            # key order to match ordered semantics.
            out = super()._aggregate()
            if out is not None and self.group_exprs:
                names = [
                    c.name
                    for c in out.columns
                    if any(g.matches_column(c.name) for g in self.group_exprs)
                ]
                from ..schema import SortingColumnDef

                sorting = [(n, SortingColumnDef(n, "asc", True)) for n in names]
                out = out.sort_by(sorting)
        return out

    def _aggregate_ordered(self, batch: ColumnBatch):
        n = batch.num_rows
        if n == 0:
            return None
        group_cols: list[Column] = []
        seen: set[str] = set()
        for ge in self.group_exprs:
            for c in batch.columns:
                if ge.matches_column(c.name) and c.name not in seen:
                    seen.add(c.name)
                    group_cols.append(c)
        agg_specs = []
        seen_aggs = set()
        for func, inner, result_name in self.aggregations:
            if result_name in seen_aggs:
                continue
            seen_aggs.add(result_name)
            src = batch.column(result_name) if self.final_stage else None
            from_partial = src is not None
            if src is None:
                src = _eval_value(batch, inner)
            if src is None:
                src = Column.all_null(result_name, KIND_INT64, n)
            agg_specs.append((func, src, result_name, from_partial))

        import torch

        from ..device import DeviceBatch

        dev = DeviceBatch(batch, self.device)
        sel = dev.row_valid_mask()
        key_vals = []
        key_valid = []
        for c in group_cols:
            dc = dev.column(c.name) if batch.column(c.name) is c else dev._upload(c)
            key_vals.append(dc.data)
            key_valid.append(dc.validity)
        ng, seg, first_row = K.ordered_group_ids(
            tuple(key_vals), tuple(key_valid), sel
        )
        ng = int(ng)
        identity = torch.arange(dev.n_pad, dtype=torch.int32, device=dev.device)
        out_cols: list[Column] = []
        fr = np.minimum(_np(first_row), dev.n_pad - 1)[:ng]
        for c in group_cols:
            out_cols.append(
                Column(
                    c.name,
                    c.kind,
                    c.values[fr[fr < n]] if ng else c.values[:0],
                    c.validity[fr[fr < n]] if ng else c.validity[:0],
                    c.dictionary,
                )
            )
        for func, src, result_name, from_partial in agg_specs:
            if func in (E.AGG_MIN, E.AGG_MAX) and src.kind == "float64":
                dc = dev._upload(
                    Column(
                        f"{result_name}#ord",
                        KIND_INT64,
                        _float_ord_encode(src.values),
                        src.validity,
                    )
                )
                o, vo = K.segment_agg(
                    dc.data,
                    dc.validity,
                    identity,
                    sel,
                    seg,
                    identity,
                    (_FINAL_AGG_FUNC if from_partial else _PARTIAL_AGG_FUNC)[
                        func
                    ],
                )
                out_cols.append(
                    Column(
                        result_name,
                        "float64",
                        _float_ord_decode(_np(o)[:ng]),
                        _np(vo)[:ng],
                    )
                )
                continue
            # Exact float64 sums (floatsum.py) — same gate/planes as the
            # unordered aggregate so both emit the identical value.
            if func == E.AGG_SUM and src.kind == "float64":
                from ..floatsum import (
                    column_meta,
                    decompose_np,
                    make_plan,
                    recombine,
                )

                fplan = make_plan([column_meta(src.values)], n)
                if fplan is not None:
                    planes = decompose_np(src.values, fplan)
                    plane_sums = []
                    for pi, pv in enumerate(planes):
                        dc = dev._upload(
                            Column(
                                f"{result_name}#p{pi}",
                                KIND_INT64,
                                pv,
                                src.validity,
                            )
                        )
                        o, _vo = K.segment_agg(
                            dc.data,
                            dc.validity,
                            identity,
                            sel,
                            seg,
                            identity,
                            K.AGG_SUM,
                        )
                        plane_sums.append(_np(o)[:ng])
                    out_cols.append(
                        Column(
                            result_name,
                            "float64",
                            recombine(plane_sums, fplan),
                            np.ones(ng, dtype=np.bool_),
                        )
                    )
                    continue
            ksrc = _kernel_src(func, src)
            if batch.column(ksrc.name) is ksrc:
                dc = dev.column(ksrc.name)
            else:
                dc = dev._upload(ksrc)
            table = _FINAL_AGG_FUNC if from_partial else _PARTIAL_AGG_FUNC
            o, vo = K.segment_agg(
                dc.data, dc.validity, identity, sel, seg, identity, table[func]
            )
            vals = _np(o)[:ng]
            valid = _np(vo)[:ng]
            kind = src.kind
            if func == E.AGG_COUNT:
                kind = KIND_INT64
                vals = vals.astype(np.int64)
            else:
                vals = _agg_result(func, src, vals)
            out_cols.append(Column(result_name, kind, vals, valid))
        return ColumnBatch(out_cols, ng)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        names = ",".join(rn for _f, _e, rn in self.aggregations)
        groupings = ",".join(g.name() for g in self.group_exprs)
        return Diagram(f"OrderedAggregate ({names} by {groupings})", child)


class OrderedSynchronizer(Synchronizer):
    """Ordered fan-in: merges sorted lane outputs (reference:
    ordered_synchronizer.go). Single-host lanes are sequential so batches
    are collected and k-way merged at the barrier."""

    def __init__(self, arity: int, order_by: Sequence[E.Expr]):
        super().__init__(arity)
        self.order_by = list(order_by)

    def _flush(self) -> None:
        batches = [b for buf in self._buffers for b in buf]
        self._buffers = [[] for _ in range(self.arity)]
        if batches:
            merged = unify_concat(batches)
            names: list[str] = []
            for e in self.order_by:
                for c in merged.columns:
                    if e.matches_column(c.name):
                        names.append(c.name)
            from ..schema import SortingColumnDef

            sorting = [(n, SortingColumnDef(n, "asc", True)) for n in names]
            merged = merged.sort_by(sorting)
            self.next.callback(merged)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        return Diagram("OrderedSynchronizer", child)


def make_aggregate(
    aggregation, final_stage: bool, ordered: bool = False, allocator=None,
    device=None,
):
    aggs = []
    for agg in aggregation.agg_exprs:
        aggs.append((agg.func, agg.expr, agg.name()))
    cls = OrderedAggregate if ordered else HashAggregate
    return cls(aggs, aggregation.group_exprs, final_stage, allocator, device)


# ---------------------------------------------------------------------------
# Distinct


class Distinction(PhysicalOperator):
    """reference: query/physicalplan/distinct.go."""

    def __init__(self, exprs: Sequence[E.Expr], allocator=None, device=None):
        super().__init__()
        self.exprs = list(exprs)
        self.allocator = allocator
        self.device = device
        self._allocated = 0
        self._batches: list[ColumnBatch] = []

    def callback(self, batch: ColumnBatch) -> None:
        if self.allocator is not None:
            nbytes = sum(
                c.values.nbytes + c.validity.nbytes for c in batch.columns
            )
            self.allocator.allocate(nbytes)
            self._allocated += nbytes
        self._batches.append(batch)

    def finish(self) -> None:
        out = self._distinct()
        if self.allocator is not None and self._allocated:
            self.allocator.free(self._allocated)
            self._allocated = 0
        if out is not None and out.num_rows > 0:
            self.next.callback(out)
        self.next.finish()

    def _distinct(self) -> Optional[ColumnBatch]:
        if not self._batches:
            return None
        batch = unify_concat(self._batches)
        self._batches = []
        if batch.num_rows == 0:
            return None

        cols: list[Column] = []
        seen: set[str] = set()
        for e in self.exprs:
            for c in project_expr(batch, e):
                if c.name not in seen:
                    seen.add(c.name)
                    cols.append(c)
        if not cols:
            return None

        from ..device import DeviceBatch

        key_batch = ColumnBatch(cols, batch.num_rows)
        dev = DeviceBatch(key_batch, self.device)
        sel = dev.row_valid_mask()
        key_vals = []
        key_valid = []
        for c in cols:
            dc = dev.column(c.name)
            key_vals.append(dc.data)
            key_valid.append(dc.validity)
        ng, rows = K.distinct_rows(tuple(key_vals), tuple(key_valid), sel)
        ng = int(ng)
        idx = _np(rows)[:ng]
        return key_batch.take(idx)

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        columns = ",".join(e.name() for e in self.exprs)
        return Diagram(f"Distinction ({columns})", child)


# ---------------------------------------------------------------------------
# Hash join (north-star component, SURVEY.md §2.8 — no reference analogue)


class HashJoin(PhysicalOperator):
    """Equi-join operator: accumulates the probe (left) stream, runs the
    build (right) subplan at finish time, and joins via the shared-code CSR
    expansion (query/join.py) on the scanned left table's device. Output is
    canonically ordered (left stream row, right row)."""

    def __init__(self, join, options, right_output: "OutputPlan", device=None):
        super().__init__()
        self.join = join
        self.options = options
        self.right_output = right_output
        self.device = device
        self._batches: list[ColumnBatch] = []
        self._allocated = 0

    def callback(self, batch: ColumnBatch) -> None:
        if self.options.allocator is not None:
            nbytes = _batch_bytes(batch)
            self.options.allocator.allocate(nbytes)
            self._allocated += nbytes
        self._batches.append(batch)

    def finish(self) -> None:
        out = self._join()
        if self.options.allocator is not None and self._allocated:
            self.options.allocator.free(self._allocated)
            self._allocated = 0
        if out is not None and out.num_rows > 0:
            self.next.callback(out)
        self.next.finish()

    def _join(self) -> Optional[ColumnBatch]:
        if not self._batches:
            return None
        left = unify_concat(self._batches)
        self._batches = []
        if left.num_rows == 0:
            return None
        right_batches: list[ColumnBatch] = []
        self.right_output.execute(right_batches.append)
        right = unify_concat(right_batches) if right_batches else None
        from .join import join_batches

        return join_batches(
            left,
            right,
            self.join.on,
            self.join.how,
            device=self.device,
            mesh=self.options.mesh,
            mesh_axis=self.options.mesh_axis,
        )

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        keys = ",".join(self.join.on)
        rdesc = self.right_output.draw_string()
        return Diagram(
            f"HashJoin ({self.join.how} on {keys}) [build: {rdesc}]", child
        )


# ---------------------------------------------------------------------------
# Limit


class Sorter(PhysicalOperator):
    """ORDER BY: accumulate the stream, emit one batch sorted by the key
    list (stable — ties keep stream order; nulls last). Mirrors the
    reference's record sort (pqarrow/arrowutils/sort.go SortRecord) as an
    operator; the reference exposes no ORDER BY surface."""

    def __init__(self, keys, allocator=None):
        super().__init__()
        self.keys = list(keys)  # [(name, "asc"|"desc")]
        self.allocator = allocator
        self._allocated = 0
        self._batches: list[ColumnBatch] = []

    def callback(self, batch: ColumnBatch) -> None:
        if self.allocator is not None:
            nbytes = _batch_bytes(batch)
            self.allocator.allocate(nbytes)
            self._allocated += nbytes
        self._batches.append(batch)

    def finish(self) -> None:
        try:
            out = None
            if self._batches:
                batch = unify_concat(self._batches)
                self._batches = []
                if batch.num_rows:
                    from ..schema import SortingColumnDef

                    sorting = [
                        (name, SortingColumnDef(name, direction, False))
                        for name, direction in self.keys
                    ]
                    out = batch.sort_by(sorting)
        finally:
            # free even when the sort raises (bad key dtype etc.) — a
            # leaked reservation poisons every later limited query
            if self.allocator is not None and self._allocated:
                self.allocator.free(self._allocated)
                self._allocated = 0
        if out is not None and out.num_rows > 0:
            self.next.callback(out)
        self.next.finish()

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        ks = ",".join(
            n if d == "asc" else f"{n} desc" for n, d in self.keys
        )
        return Diagram(f"OrderBy ({ks})", child)


class Limiter(PhysicalOperator):
    """reference: query/physicalplan/limit.go."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit = limit
        self._remaining = limit

    def callback(self, batch: ColumnBatch) -> None:
        if self._remaining <= 0:
            return
        if batch.num_rows <= self._remaining:
            self._remaining -= batch.num_rows
            self.next.callback(batch)
        else:
            self.next.callback(batch.slice(0, self._remaining))
            self._remaining = 0

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        return Diagram(f"Limit({self.limit})", child)


# ---------------------------------------------------------------------------
# Reservoir sampler (reference: query/physicalplan/sampler.go, Algorithm L)


class ReservoirSampler(PhysicalOperator):
    def __init__(self, size: int, byte_limit: int, seed: int = 0, allocator=None):
        super().__init__()
        self.size = size
        self.byte_limit = byte_limit
        self.allocator = allocator
        self._charged = 0
        self._rng = np.random.default_rng(seed if seed else None)
        self._rows: list[tuple[ColumnBatch, int]] = []
        self._n_seen = 0
        self._w = np.exp(np.log(self._rng.random()) / max(size, 1))
        self._next_i = size + int(
            np.floor(np.log(self._rng.random()) / np.log(1 - self._w))
        ) + 1
        self.materializations = 0

    @staticmethod
    def _batch_bytes(b: ColumnBatch) -> int:
        return sum(c.values.nbytes + c.validity.nbytes for c in b.columns)

    def _pinned_bytes(self) -> int:
        seen: dict[int, int] = {}
        for b, _i in self._rows:
            seen[id(b)] = self._batch_bytes(b)
        return sum(seen.values())

    def _maybe_materialize(self) -> None:
        """Copy the reservoir's rows into one owned batch when the input
        batches pinned by row references exceed the byte budget (reference:
        sampler.go:18-289 materializes at sampleBufferSize for exactly this
        reason — a reservoir of row refs can pin the entire scanned stream
        alive)."""
        if not self.byte_limit or self._pinned_bytes() <= self.byte_limit:
            return
        by_batch: dict[int, tuple[ColumnBatch, list[tuple[int, int]]]] = {}
        for slot, (b, i) in enumerate(self._rows):
            by_batch.setdefault(id(b), (b, []))[1].append((i, slot))
        takes = []
        slot_order: list[int] = []
        for b, pairs in by_batch.values():
            idxs = np.asarray([i for i, _s in pairs], dtype=np.int64)
            takes.append(b.take(idxs))
            slot_order.extend(s for _i, s in pairs)
        merged = unify_concat(takes)
        # Restore reservoir slot order so future replacements behave
        # identically to the un-materialized run.
        inv = np.empty(len(slot_order), dtype=np.int64)
        inv[np.asarray(slot_order, dtype=np.int64)] = np.arange(
            len(slot_order), dtype=np.int64
        )
        self._rows = [(merged, int(j)) for j in inv]
        self.materializations += 1

    def callback(self, batch: ColumnBatch) -> None:
        touched = False
        for i in range(batch.num_rows):
            self._n_seen += 1
            if len(self._rows) < self.size:
                self._rows.append((batch, i))
                touched = True
            elif self._n_seen == self._next_i:
                j = self._rng.integers(0, self.size)
                self._rows[j] = (batch, i)
                touched = True
                self._w *= np.exp(np.log(self._rng.random()) / self.size)
                self._next_i += (
                    int(np.floor(np.log(self._rng.random()) / np.log(1 - self._w))) + 1
                )
        if touched:
            self._maybe_materialize()
            if self.allocator is not None:
                pinned = self._pinned_bytes()
                if pinned > self._charged:
                    self.allocator.allocate(pinned - self._charged)
                    self._charged = pinned
                elif pinned < self._charged:
                    self.allocator.free(self._charged - pinned)
                    self._charged = pinned

    def finish(self) -> None:
        by_batch: dict[int, tuple[ColumnBatch, list[int]]] = {}
        for b, i in self._rows:
            by_batch.setdefault(id(b), (b, []))[1].append(i)
        for b, idxs in by_batch.values():
            self.next.callback(b.take(np.asarray(sorted(idxs), dtype=np.int64)))
        if self.allocator is not None and self._charged:
            self.allocator.free(self._charged)
            self._charged = 0
        self.next.finish()

    def draw(self) -> Diagram:
        child = self.next.draw() if self.next is not None else None
        return Diagram(f"ReservoirSampler (size={self.size})", child)


# ---------------------------------------------------------------------------
# Planner (reference: physicalplan.go:287 Build)

DEFAULT_CONCURRENCY = 4  # logical lanes (reference: GOMAXPROCS fan-out)


class ExecOptions:
    def __init__(
        self,
        concurrency: int = DEFAULT_CONCURRENCY,
        ordered_aggregations: bool = False,
        allocator=None,
        compiled_serving: bool = True,
        mesh=None,
        mesh_axis: str = "shards",
        tracer=None,
        metrics=None,
    ):
        self.concurrency = concurrency
        # Tracer for per-query span trees (reference: query/engine.go:36
        # WithTracer); None disables tracing with zero overhead.
        self.tracer = tracer
        self.ordered_aggregations = ordered_aggregations
        # LimitAllocator for per-query memory limiting (reference:
        # query/memory.go; wired into the accumulate points).
        self.allocator = allocator
        # Lower scan->filter->group-aggregate plans onto the fused device
        # kernels when the pattern is provable (compiled.lower_plan); the
        # generic operator DAG is the fallback and the semantic oracle.
        self.compiled_serving = compiled_serving
        # Distributed execution over a device mesh
        # (parallel/mesh.make_mesh): the mesh serving tier and the
        # HashJoin's mesh expansion.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        # Optional MetricsRegistry: the engine counts queries per serving
        # tier (queries_served_{mesh,compiled,dense,generic}) on it.
        self.metrics = metrics


def _expr_is_floatish(e, schema) -> bool:
    """Minimal static type inference for sum inputs (the reference's
    DataTypeForExpr role, logicalplan.go): could this expr evaluate to
    float64? Unknown/dynamic columns surface as int64 all-null in the
    aggregate, so they count as int."""
    if type(e) is E.Column:
        cdef = schema.column_by_name(e.column_name) if schema else None
        return cdef is not None and cdef.layout.type == "double"
    if isinstance(e, E.Literal):
        return isinstance(e.value, float)
    if isinstance(e, E.AliasExpr):
        return _expr_is_floatish(e.expr, schema)
    if isinstance(e, E.BinaryExpr):
        if e.op in E.COMPARE_OPS or e.op in (E.OP_AND, E.OP_OR):
            return False
        return _expr_is_floatish(e.left, schema) or _expr_is_floatish(
            e.right, schema
        )
    if isinstance(e, E.ConvertExpr):
        return e.to_type == "float64"
    if isinstance(e, E.IfExpr):
        return _expr_is_floatish(e.then, schema) or _expr_is_floatish(
            e.els, schema
        )
    return True  # unknown expr kinds: assume float (exactness-safe)


_ORD_MASK = np.int64(0x7FFFFFFFFFFFFFFF)


def _float_ord_encode(values: np.ndarray) -> np.ndarray:
    """Monotone int64 keys for float64 ordering: k = bits ^ ((bits >> 63)
    & 0x7FF..F). Float min/max order via exact int64 reductions (the
    reference's choice, kept so every tier agrees bit for bit); the
    transform is self-inverse."""
    b = np.ascontiguousarray(values, dtype=np.float64).view(np.int64)
    return b ^ ((b >> 63) & _ORD_MASK)


def _float_ord_decode(keys: np.ndarray) -> np.ndarray:
    k = np.asarray(keys, dtype=np.int64)
    return (k ^ ((k >> 63) & _ORD_MASK)).view(np.float64)


def _agg_needs_single_stage(node) -> bool:
    """True when the aggregation contains a sum whose input may be float64:
    exact float sums (floatsum.py) cannot round per-lane partials, so the
    whole stream aggregates in one final stage."""
    schema = node.input_schema()
    for a in node.aggregation.agg_exprs:
        inner = a.expr if isinstance(a, E.AliasExpr) else a
        if (
            isinstance(inner, E.AggregationFunction)
            and inner.func == E.AGG_SUM
        ):
            if _expr_is_floatish(inner.expr, schema):
                return True
    return False


def _should_plan_ordered(opts: ExecOptions, ordering_ok: bool, node) -> bool:
    """reference: physicalplan.go:518 shouldPlanOrderedAggregate."""
    if not opts.ordered_aggregations or not ordering_ok:
        return False
    agg = node.aggregation
    if len(agg.agg_exprs) > 1:
        return False
    schema = node.input_schema()
    if schema is None:
        return False
    ordering = list(schema.sorting_columns())
    for ge in agg.group_exprs:
        cols = ge.columns_used()
        if len(cols) != 1 or not ordering:
            return False
        oc = ordering.pop(0)
        cdef = schema.column_by_name(oc.name)
        name = oc.name + "." if (cdef is not None and cdef.dynamic) else oc.name
        if not (
            cols[0].matches_column(oc.name)
            or cols[0].name().startswith(name)
            or cols[0].name() == oc.name
        ):
            return False
    return True


def build_physical(plan: LogicalPlan, options: ExecOptions | None = None) -> OutputPlan:
    opts = options or ExecOptions()
    output = OutputPlan()
    prev: list[PhysicalOperator] = []
    visit_err: list[Exception] = []
    # planOrderingInfo analogue (planordering.go): does stream order still
    # reflect the schema's sorting columns at this node?
    ordering_ok = False

    # The scanned table's torch device: the accumulating operators run their
    # group kernels there.
    device = None

    def visit(node: LogicalPlan) -> bool:
        nonlocal prev, ordering_ok, device
        if node.table_scan is not None or node.schema_scan is not None:
            scan = node.table_scan or node.schema_scan
            table = scan.provider.get_table(scan.table_name)
            device = table.device if table is not None else None
            plans = [NoopOperator() for _ in range(opts.concurrency)]
            if node.table_scan is not None:
                output.scan = TableScanExec(node.table_scan, plans)
                ordering_ok = True
            else:
                output.scan = SchemaScanExec(node.schema_scan, plans)
            prev = list(plans)
        elif node.projection is not None:
            ordering_ok = False
            # Wildcard projections are handled by projection pushdown
            # (physicalplan.go:349).
            if any(e.name() == "all" for e in node.projection.exprs):
                return True
            for i in range(len(prev)):
                p = Projection(node.projection.exprs, opts.allocator)
                prev[i].set_next(p)
                prev[i] = p
        elif node.distinct is not None:
            ordering_ok = False
            sync = Synchronizer(len(prev)) if len(prev) > 1 else None
            for i in range(len(prev)):
                d = Distinction(node.distinct.exprs, opts.allocator, device)
                prev[i].set_next(d)
                prev[i] = d
                if sync is not None:
                    d.set_next(sync.lane(i))
            if sync is not None:
                d = Distinction(node.distinct.exprs, opts.allocator, device)
                sync.set_next(d)
                prev = [d]
        elif node.order_by is not None:
            ordering_ok = False
            sync = Synchronizer(len(prev)) if len(prev) > 1 else None
            if sync is not None:
                for i in range(len(prev)):
                    prev[i].set_next(sync.lane(i))
            s = Sorter(node.order_by.keys, opts.allocator)
            if sync is not None:
                sync.set_next(s)
            else:
                prev[0].set_next(s)
            prev = [s]
        elif node.limit is not None:
            limit = int(_lit_value(node.limit.expr))
            sync = Synchronizer(len(prev)) if len(prev) > 1 else None
            for i in range(len(prev)):
                l = Limiter(limit)
                prev[i].set_next(l)
                prev[i] = l
                if sync is not None:
                    l.set_next(sync.lane(i))
            if sync is not None:
                l = Limiter(limit)
                sync.set_next(l)
                prev = [l]
        elif node.filter is not None:
            for i in range(len(prev)):
                f = PredicateFilter(node.filter.expr, opts.allocator)
                prev[i].set_next(f)
                prev[i] = f
        elif node.aggregation is not None:
            ordered = _should_plan_ordered(opts, ordering_ok, node)
            # Float64 sums are EXACT (correctly-rounded true sums,
            # floatsum.py): per-lane float partials would round once per
            # lane and break that, so they aggregate single-stage — lanes
            # feed the barrier directly and ONE aggregate sees the whole
            # stream.
            single_stage = _agg_needs_single_stage(node)
            if len(prev) > 1:
                if ordered and node.aggregation.group_exprs:
                    sync = OrderedSynchronizer(
                        len(prev), node.aggregation.group_exprs
                    )
                else:
                    sync = Synchronizer(len(prev))
            else:
                sync = None
            if sync is not None and single_stage:
                for i in range(len(prev)):
                    prev[i].set_next(sync.lane(i))
                a = make_aggregate(
                    node.aggregation,
                    final_stage=True,
                    ordered=ordered,
                    allocator=opts.allocator,
                    device=device,
                )
                sync.set_next(a)
                prev = [a]
            else:
                for i in range(len(prev)):
                    a = make_aggregate(
                        node.aggregation,
                        final_stage=sync is None,
                        ordered=ordered,
                        allocator=opts.allocator,
                        device=device,
                    )
                    prev[i].set_next(a)
                    prev[i] = a
                    if sync is not None:
                        a.set_next(sync.lane(i))
                if sync is not None:
                    a = make_aggregate(
                        node.aggregation,
                        final_stage=True,
                        ordered=ordered,
                        allocator=opts.allocator,
                        device=device,
                    )
                    sync.set_next(a)
                    prev = [a]
            ordering_ok = bool(ordered)
        elif node.join is not None:
            ordering_ok = False
            # Build side: an independent physical pipeline, executed by the
            # operator at finish time. Probe lanes synchronize into one join
            # (the accumulate-then-kernel pattern of HashAggregate), which
            # expands its matches on the probe table's device.
            right_output = build_physical(node.join.right, opts)
            j = HashJoin(node.join, opts, right_output, device)
            if len(prev) > 1:
                sync = Synchronizer(len(prev))
                for i in range(len(prev)):
                    prev[i].set_next(sync.lane(i))
                sync.set_next(j)
            else:
                prev[0].set_next(j)
            prev = [j]
        elif node.sample is not None:
            v = int(_lit_value(node.sample.expr))
            limit = int(_lit_value(node.sample.limit))
            per = v // len(prev)
            per_limit = limit // len(prev)
            r = v % len(prev)
            for i in range(len(prev)):
                adjust = 1 if i < r else 0
                s = ReservoirSampler(per + adjust, per_limit, allocator=opts.allocator)
                prev[i].set_next(s)
                prev[i] = s
        else:
            visit_err.append(RuntimeError("unsupported plan node"))
            return False
        return True

    plan.accept_post(visit)
    if visit_err:
        raise visit_err[0]

    if len(prev) > 1:
        sync = Synchronizer(len(prev))
        for j, p in enumerate(prev):
            p.set_next(sync.lane(j))
        sync.set_next(output)
    else:
        prev[0].set_next(output)
    return output
