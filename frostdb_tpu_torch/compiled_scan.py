"""Device-resident filter -> project serving (port of
``frostdb_tpu/compiled_scan.py``).

Non-aggregate row retrieval — ``scan.filter(...).project(...)`` — runs its
O(n) part on the table's device: the compiled CNF selection mask is built
over the cached superpart planes with tensor ops, and the hand-written
block-compaction kernel (``ops/agg_kernels.block_compact``) turns it into
per-8192-row-block selected counts and the first ``capb`` selected row
offsets (the selection-mask -> row-materialization step the reference
performs with roaring bitmaps + IndexRanges,
query/physicalplan/filter.go:276-354). ``[counts | offsets]`` reach the
host in ONE int32 copy. The host then materializes ONLY the selected rows
per part (numpy ``take`` on O(selected) rows, dictionary codes decode
host-side) and applies the projection with the SAME ``project_expr``
evaluation the generic Projection operator uses — so emitted rows, row
order, per-part batch boundaries, and missing-dynamic-column semantics are
byte-identical to the generic engine.

The per-block capacity starts small and escalates to the next power of
two when a query selects more rows in a block (the counts ride in the same
copy, so the common low-selectivity serving case pays one dispatch + one
small copy); the capacity a structure settled on is cached per table.

The 8192-row blocks tile the flat planes, not the parts: parts occupy
their power-of-two padded sizes (compiled.py ``_superpart``), so a block
may straddle two parts and the last block may be partial.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiled import CompiledFilterAggregate, NotCompilable, _copy_to_host, _leaf_mask
from .query import expr as E
from .tracing import annotate, count, span as _span

# Per-block compaction capacity: starts small (low-selectivity serving),
# escalates by powers of two; past _CAPB_MAX the host evaluates just the
# overflowing blocks (bounded work — see _selected_rows).
_CAPB0 = 16
_CAPB_MAX = 1024


def _scan_blob(structure, capb: int, xs) -> np.ndarray:
    """Selection plane + per-block compaction for one query structure (a
    tuple of clauses, each a tuple of ``_leaf_sig`` tuples); ``xs`` is the
    row-validity plane followed by every leaf's args. Returns the host
    array [bc (n_blocks) | idx (n_blocks * capb)] int32."""
    from .ops import agg_kernels as AK

    sel = xs[0]
    i = 1
    for cl in structure:
        cmask = None
        for leaf in cl:
            m, i = _leaf_mask(leaf, xs, i)
            cmask = m if cmask is None else torch.maximum(cmask, m)
        sel = sel * cmask
    bc, idx = AK.block_compact(sel.to(torch.int32).contiguous(), capb)
    # The single device-to-host copy of the dispatch.
    return _copy_to_host(torch.cat([bc, idx.reshape(-1)]))


class CompiledScan(CompiledFilterAggregate):
    """Filter -> project over one table's device-cached parts. Shares the
    aggregate path's leaf validation, CNF clause layout, part pruning,
    dictionary LUTs, and superpart plane caches; only the program and the
    host materialization differ."""

    SPAN = "compiled_scan/execute"

    def __init__(
        self,
        table,
        projection_exprs,
        physical_projection,
        filter_spec,
        filter_expr,
        limit: int | None = None,
    ):
        self.limit = limit  # first-n truncation (limit.go:17 semantics)
        self.table = table
        self.device = table.device
        self.projection_exprs = projection_exprs  # None = no Projection node
        self.physical_projection = list(physical_projection or ())
        # No group keys on this path; parent helpers expect the fields.
        self._gplan = []
        self.group_cols = []
        self.group_dicts = []
        self.value_plans = {}
        self.aggs = []
        schema = table.schema()
        self.filters = []
        self.clauses = []
        self.filter_expr = filter_expr
        for clause in filter_spec:
            leaves = [clause] if isinstance(clause, tuple) else list(clause)
            idxs = []
            for fcol, fop, lit in leaves:
                idxs.append(len(self.filters))
                self.filters.append(self._make_leaf(schema, fcol, fop, lit))
            self.clauses.append(idxs)
        if not self.clauses:
            # An unfiltered scan selects everything: the device saves no
            # bytes and the host materializes all rows anyway.
            raise NotCompilable("unfiltered scan (generic path)")

    # -- device selection --------------------------------------------------

    def _scan_structure(self, sp) -> tuple:
        return tuple(
            tuple(self._leaf_sig(sp, self.filters[i]) for i in idxs)
            for idxs in self.clauses
        )

    def _scan_args(self, sp) -> list:
        args = [self._sp_plane(sp, "rowvalid", None)]
        for idxs in self.clauses:
            for i in idxs:
                args.extend(self._leaf_args(sp, self.filters[i], i))
        return args

    def _run_scan_program(self, sp, capb: int) -> np.ndarray:
        return _scan_blob(self._scan_structure(sp), capb, self._scan_args(sp))

    def _selected_rows(self, sp, parts) -> np.ndarray:
        """Global selected row positions (ascending) over the superpart
        plane space. Three regimes per block: fully selected blocks need
        no per-row data (an arange), blocks within the per-block capacity
        come from the device compaction, and oversized partial blocks
        either escalate the capacity (one more dispatch) or — past
        _CAPB_MAX — are re-filtered HOST-side over just those blocks' rows
        (bounded: range predicates have <= 2 boundary blocks per part)."""
        from .ops.agg_kernels import BLOCK_ROWS as RB

        offsets = sp["row_offsets"]
        n_rows = int(offsets[-1])
        n_blocks = -(-n_rows // RB)
        # Start at the capacity the LAST query with this structure settled
        # on (cached per table): serving workloads repeat their shapes, and
        # a capacity escalation costs a second device dispatch.
        cache = getattr(self.table, "_scan_capb_cache", None)
        if cache is None:
            cache = self.table._scan_capb_cache = {}
        ckey = self._scan_structure(sp)
        capb = min(max(cache.get(ckey, _CAPB0), _CAPB0), _CAPB_MAX)
        blob = self._run_scan_program(sp, capb)
        dispatches = 1
        bc = blob[:n_blocks]
        idx2d = blob[n_blocks:].reshape(n_blocks, capb)
        partial = (bc > capb) & (bc < RB)
        if partial.any():
            mx = int(bc[partial].max())
            if mx <= _CAPB_MAX:
                capb = 1 << (mx - 1).bit_length()
                blob = self._run_scan_program(sp, capb)
                dispatches = 2
                bc = blob[:n_blocks]
                idx2d = blob[n_blocks:].reshape(n_blocks, capb)
        cache[ckey] = capb
        pieces: list[np.ndarray] = []
        blocks = np.nonzero(bc > 0)[0]
        refiltered = 0
        for b in blocks:
            base = int(b) * RB
            n_sel = int(bc[b])
            if n_sel == RB:
                pieces.append(np.arange(base, base + RB, dtype=np.int64))
            elif n_sel <= idx2d.shape[1]:
                pieces.append(idx2d[b, :n_sel].astype(np.int64) + base)
            else:
                pieces.extend(self._refilter_block(parts, offsets, base))
                refiltered += 1
        if refiltered:
            count(
                "scan_blocks_refiltered_total",
                "compiled_scan blocks re-filtered on the host",
                refiltered,
            )
        annotate(blocks=len(blocks), refiltered=refiltered, capb=capb, dispatches=dispatches)
        if not pieces:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(pieces)

    def _refilter_block(self, parts, offsets, base: int) -> list:
        """Host re-filter of one block's real rows with the generic
        engine's own mask evaluation — identical semantics. The block may
        straddle parts: each part's rows in it are filtered on their own,
        in part order."""
        from .ops.agg_kernels import BLOCK_ROWS as RB
        from .query.physeval import filter_mask

        end = min(base + RB, int(offsets[-1]))
        out = []
        pi = int(np.searchsorted(offsets, base, side="right")) - 1
        while pi < len(parts) and int(offsets[pi]) < end:
            start = int(offsets[pi])
            p = parts[pi]
            lo = max(base - start, 0)
            hi = min(end - start, p.batch.num_rows)
            if hi > lo:
                rows = p.batch.take(np.arange(lo, hi, dtype=np.int64))
                mask = filter_mask(rows, self.filter_expr)
                out.append(np.flatnonzero(mask).astype(np.int64) + start + lo)
            pi += 1
        return out

    # -- execution ---------------------------------------------------------

    def execute_into(self, callback) -> None:
        with _span(self.SPAN, table=self.table.name):
            self._execute_into(callback)

    def _execute_into(self, callback) -> None:
        from .columnbatch import KIND_DICT, KIND_INT64

        parts = self._serving_parts()
        # Column-kind validation against the leaves (the aggregate path's
        # gate minus group/value checks).
        for p in parts:
            for leaf in self.filters:
                f = p.batch.column(leaf.column)
                if f is None:
                    continue
                if leaf.kind == "int":
                    if f.kind != KIND_INT64:
                        raise NotCompilable("filter column kind mismatch")
                elif f.kind != KIND_DICT:
                    raise NotCompilable("filter column kind mismatch")
        if not parts:
            return
        sp = self._superpart(parts)
        with _span("scan/blocks"):
            idx = self._selected_rows(sp, parts)
        charged = 0
        if self.allocator is not None:
            # selected-position transient (query/memory.go:17); charged
            # BEFORE the limit slice (the full vector was materialized) and
            # freed in a finally so neither the early empty-return nor an
            # epilogue error can leak the reservation
            charged = int(idx.nbytes)
            self.allocator.allocate(charged)
        try:
            with _span("result/epilogue") as span:
                rows = self._materialize(sp, parts, idx, callback)
                if span is not None:
                    span.attributes["rows"] = rows
        finally:
            if self.allocator is not None and charged:
                self.allocator.free(charged)

    def _materialize(self, sp, parts, idx, callback) -> int:
        """Emit the selected rows, batch by part; returns how many."""
        from .columnbatch import ColumnBatch
        from .query.physeval import project_expr

        if self.limit is not None:
            # Selected positions are ascending stream order, so the first n
            # are exactly what the generic Limiter chain emits (per-lane
            # Limiters then the post-Synchronizer Limiter slice the ordered
            # stream, limit.go:17) — host materialization is bounded by n.
            idx = idx[: max(self.limit, 0)]
        if len(idx) == 0:
            return 0
        offsets = sp["row_offsets"]
        # Split global positions into per-part local rows; emit one batch
        # per part with >= 1 selected row, in part-stream order — exactly
        # the generic lane-ordered filter -> projection emission.
        bounds = np.searchsorted(idx, offsets[1:-1])
        pieces = np.split(idx, bounds)
        for pi, (p, local) in enumerate(zip(parts, pieces)):
            if len(local) == 0:
                continue
            local = local - int(offsets[pi])
            batch = p.batch.take(local.astype(np.int64))
            if self.physical_projection:
                batch = self.table._apply_physical_projection(
                    batch, self.physical_projection
                )
            if self.projection_exprs is not None:
                cols = []
                seen: set[str] = set()
                for e in self.projection_exprs:
                    for c in project_expr(batch, e):
                        if c.name in seen:
                            continue
                        seen.add(c.name)
                        cols.append(c)
                batch = ColumnBatch(cols, batch.num_rows)
            if self.allocator is not None:
                # transient flow accounting, like PredicateFilter: charged
                # while the materialized batch is in flight
                nbytes = sum(
                    c.values.nbytes + c.validity.nbytes
                    for c in batch.columns
                )
                self.allocator.allocate(nbytes)
                try:
                    callback(batch)
                finally:
                    self.allocator.free(nbytes)
                continue
            callback(batch)
        return len(idx)


def match_plan_scan(plan, exec_options=None) -> CompiledScan:
    """Match an optimized non-aggregate plan: TableScan <- Filter
    [<- Projection] [<- Limit]. Anything else (distinct, sample, joins,
    aggregations, unfiltered scans) stays on the generic engine."""
    node = plan
    limit = None
    if node is not None and node.limit is not None:
        lim_e = node.limit.expr
        if not isinstance(lim_e, E.Literal) or not isinstance(
            lim_e.value, int
        ):
            raise NotCompilable("limit is not an int literal")
        limit = int(lim_e.value)
        node = node.input
    proj_exprs = None
    if node is not None and node.projection is not None:
        proj_exprs = list(node.projection.exprs)
        node = node.input
    filt = None
    while node is not None and node.filter is not None:
        if filt is not None:
            raise NotCompilable("multiple filter nodes")
        filt = node.filter.expr
        node = node.input
    if node is None or node.table_scan is None:
        raise NotCompilable("input is not a plain filtered table scan")
    if filt is None:
        raise NotCompilable("unfiltered scan (generic path)")
    scan = node.table_scan
    table = scan.provider.get_table(scan.table_name)
    if table is None:
        raise NotCompilable(f"table not found: {scan.table_name}")

    # CNF flattening — the same shape match_plan applies.
    conjuncts: list = []

    def flatten(e) -> None:
        if isinstance(e, E.BinaryExpr) and e.op == E.OP_AND:
            flatten(e.left)
            flatten(e.right)
            return
        conjuncts.append(e)

    def leaf_tuple(e):
        if not (
            isinstance(e, E.BinaryExpr)
            and type(e.left) is E.Column
            and isinstance(e.right, E.Literal)
        ):
            raise NotCompilable("filter is not a CNF of col <op> literal")
        return (e.left.column_name, e.op, e.right.value)

    def flatten_or(e, out: list) -> None:
        if isinstance(e, E.BinaryExpr) and e.op == E.OP_OR:
            flatten_or(e.left, out)
            flatten_or(e.right, out)
            return
        out.append(leaf_tuple(e))

    flatten(filt)
    filter_spec: list = []
    for e in conjuncts:
        if isinstance(e, E.BinaryExpr) and e.op == E.OP_OR:
            ors: list = []
            flatten_or(e, ors)
            filter_spec.append(ors)
        else:
            filter_spec.append(leaf_tuple(e))

    return CompiledScan(
        table,
        proj_exprs,
        scan.physical_projection,
        filter_spec,
        filt,
        limit=limit,
    )


def lower_plan_scan(plan, exec_options=None) -> CompiledScan:
    obj = match_plan_scan(plan, exec_options)
    if exec_options is not None:
        obj.allocator = exec_options.allocator
    return obj
