"""The fused filter + group-by aggregate past the compiled tier's 2048
codes: the engine's ``dense`` tier on one device and its ``mesh`` tier
across shards (reference: frostdb_tpu/parallel/mesh_exec.py).

The compiled tier's matched query shape (``compiled.match_plan``) executes
part by part as int64 reductions over dense group codes —

  per part:    selection mask (the full compiled filter envelope: AND of
               OR-clauses of int64 compares, dict/string predicates as
               boolean-LUT gathers, ==/!= null via validity) -> dense
               [K] partials (the non-final HashAggregate, aggregate.go:124)
  across parts: the partials fold on the device by their reduction; one
               result blob comes back per query.

Each aggregation turns into zero or more partial slots (``partial_slots``),
one [K] int64 vector each with its reduction (sum, min or max) and the
value an empty group holds. A count has none: it re-emits the group
counts. Sums, min/max and integral float64 columns reduce natively;
non-integral float64 sums ride four exact digit planes (floatsum.py);
float64 min/max reduce the monotone int64 ordering key ``bits ^ ((bits >>
63) & 0x7FF..F)``. Every stage reads the one slot list, and one host
decoder (``_decode``) turns the slot rows back into result columns.

The route is chosen once per query (``dense_route``) from the code count K
of the group remap and the slots' reductions: the segment route up to 4096
codes (``dense_segment_sum_count``, the card's one-pass kernel, and
``kernels.dense_group_reduce``); up to 2^20 the table route where every
slot is a sum (``dense_table_sum_count``, one pass into [K] tables in
device memory) and the sorted route otherwise
(``kernels.sorted_group_reduce``: one sort and prefix sums); and the
shuffle route up to 2^27: a sparse sort-reduce of each part's selected
rows into (code, count, first, partials) pairs, scattered into [K] tables
carried across parts. Past that the generic engine serves.

Results are identical to the generic engine's, group emission order
included: each part reduces the exact first selected row per code, parts
accumulate the minimum stream position (a part's rows start at the sum of
the live rows of the parts before it; padding rows never select), and
groups emit in that first-occurrence order (or key order under
ordered_aggregations). On the segment, table and sorted routes that order
is sorted on the device and every [K] partial gathered into it before the
query's one copy, so the host epilogue only slices.

``DenseLocalAggregate`` is the engine's ``dense`` tier, between
``compiled_join`` and ``compiled_distinct``: it reads the compiled tier's
``part.device()`` cache on the table's device. ``MeshFilterAggregate``
(``ExecOptions(mesh=)``, tried first) extends it: each part row-sharded
over the mesh (``Part.device_sharded``, one mirror per (mesh, axis) until
the part is dropped, so an insert uploads only the new part), constants
replicated, the local tier's reduction run per shard and combined by
psum / pmin / pmax (collectives.py; the final-stage Synchronizer,
synchronize.go:16). On more than one shard the shuffle route sends the
pairs to their owner shard ``code % n_shards`` through fixed-capacity
buckets and an ``all_to_all`` (overflow detected exactly, capacity doubled
and retried), and each owner scatters into [K / n_shards] tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..compiled import (
    CompiledFilterAggregate,
    NotCompilable,
    _CMP_OPS,
    _copy_to_host,
    _take_clip,
    emit_output,
)
from ..device import ShardedTensor
from ..ops import agg_kernels as AK
from ..ops import kernels as K
from ..query import expr as E
from ..tracing import annotate as _annotate, span as _span
from . import collectives as C
from .shuffle import bucket_slots

# Sentinel for "no selected row yet" stream positions / min partials — the
# headroom convention of ops/kernels.sorted_group_reduce (values past 2^62
# fall back to the generic engine, see _execute's range guard).
_BIG = 2**62
_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)

# Past this many codes a part reduces into [K] tables in device memory
# (the table route) or via sort + prefix sums (the sorted route) instead of
# segment reductions.
_SORTED_THRESHOLD = 4096

# Shuffle-route ceiling: up to 2^27 combined codes aggregate through the
# sparse pair reduce into [K] tables; beyond that the generic engine
# serves.
SHUFFLE_MAX_CODES = 1 << 27

# Each reduction as a fold of two tensors (across parts), a cross-shard
# collective, and a scatter's ``reduce``.
_FOLD = {K.AGG_SUM: torch.add, K.AGG_MIN: torch.minimum, K.AGG_MAX: torch.maximum}
_COMBINE = {K.AGG_SUM: C.psum, K.AGG_MIN: C.pmin, K.AGG_MAX: C.pmax}
_REDUCE = {K.AGG_SUM: "sum", K.AGG_MIN: "amin", K.AGG_MAX: "amax"}

# The shuffle route's pair exchanges since the last reset (multi-shard
# meshes): exchanges run, live pairs sent to another shard, bucket bytes
# sent to another shard (padding slots included: the all_to_all moves
# whole buckets), and the oversubscription the last query ended at.
EXCHANGE_STATS = {"exchanges": 0, "pairs": 0, "bytes": 0, "oversub": 0.0}


class Slot(NamedTuple):
    """One [K] int64 partial of an aggregation."""

    agg: int  # the aggregation's index in ``aggs``
    # The aggregation's inputs: its values and validity (2), or an exact
    # float sum's four digit planes (4).
    width: int
    # The input this slot reduces, by index, or "and": ``valid ? v : 1``
    # (nulls are true-neutral, aggregate.go:798).
    src: object
    op: str  # K.AGG_SUM, K.AGG_MIN or K.AGG_MAX
    ident: int  # an empty group's value: the shuffle route's table fill
    # Monotone float keys span the whole int64 range, so an empty group
    # must hold the int64 extreme on every route.
    fmm: bool = False


def partial_slots(aggs, value_plans) -> tuple:
    """The query's partial slots, aggregation by aggregation."""
    slots = []
    for j, spec in enumerate(aggs):
        if spec.func == E.AGG_COUNT:
            continue  # re-emits the group counts
        plan = value_plans[spec.column]
        if spec.func == E.AGG_SUM and plan.fexact is not None:
            slots += [Slot(j, 4, p, K.AGG_SUM, 0) for p in range(4)]
        elif spec.func == E.AGG_UNIQUE:
            # unique = (min == max) & (valid-slot count == group count),
            # combined by the host decoder
            slots += [
                Slot(j, 2, 0, K.AGG_MIN, _BIG),
                Slot(j, 2, 0, K.AGG_MAX, -_BIG),
                Slot(j, 2, 1, K.AGG_SUM, 0),
            ]
        elif spec.func == E.AGG_AND:
            slots.append(Slot(j, 2, "and", K.AGG_MIN, _BIG))
        elif spec.func == E.AGG_MIN:
            slots.append(Slot(j, 2, 0, K.AGG_MIN, _I64_MAX if plan.fmm else _BIG, plan.fmm))
        elif spec.func == E.AGG_MAX:
            slots.append(Slot(j, 2, 0, K.AGG_MAX, _I64_MIN if plan.fmm else -_BIG, plan.fmm))
        else:
            slots.append(Slot(j, 2, 0, K.AGG_SUM, 0))
    return tuple(slots)


def _unpack_inputs(xs, gshape, clause_sigs, slots, shard: int = 0):
    """One shard's inputs of a part, from the flat list ``_part_args``
    lays out: the group codes (dict remaps / window codes), the CNF
    selection mask, the shard's part-row positions (``shard * per_shard +
    arange``) and one int64 value vector per partial slot. Returns
    (gcodes, sel, rows, vlist)."""
    n = xs[0]
    i = 1
    gcodes = None
    gvalid = None
    for kind, has_remap, k in gshape:
        if kind == "int":
            raw, v, win, base = xs[i], xs[i + 1], xs[i + 2], xs[i + 3]
            i += 4
            # floor division: window codes of negative values round down
            c = torch.div(raw, win, rounding_mode="floor") - base
            c = torch.clamp(c, 0, k - 1).to(torch.int32)
        else:
            c, v = xs[i], xs[i + 1]
            i += 2
            if has_remap:
                c = _take_clip(xs[i], c)
                i += 1
        gcodes = c if gcodes is None else gcodes * k + c
        gvalid = v if gvalid is None else gvalid & v
    m = gcodes.shape[0]
    rows = shard * m + torch.arange(m, dtype=torch.int64, device=gcodes.device)
    sel = gvalid & (rows < n)
    for clause_sig in clause_sigs:
        if clause_sig == "true":
            continue
        if clause_sig == "false":
            sel = torch.zeros_like(sel)
            continue
        cmask = None
        for leaf_sig in clause_sig:
            if leaf_sig[0] == "int":
                fv, fvalid, lit = xs[i], xs[i + 1], xs[i + 2]
                i += 3
                lm = _CMP_OPS[leaf_sig[1]](fv, lit) & fvalid
            elif leaf_sig[0] == "nulllit":
                fvalid = xs[i]
                i += 1
                lm = fvalid if leaf_sig[1] == E.OP_NOT_EQ else ~fvalid
            else:
                fcodes, fvalid, lut = xs[i], xs[i + 1], xs[i + 2]
                i += 3
                lm = (_take_clip(lut, fcodes) != 0) & fvalid
            cmask = lm if cmask is None else (cmask | lm)
        sel = sel & cmask
    vlist = []
    agg = None
    for slot in slots:
        if slot.agg != agg:
            agg, ins = slot.agg, xs[i : i + slot.width]
            i += slot.width
        if slot.src == "and":
            vlist.append(torch.where(ins[1], ins[0].to(torch.int64), 1))
        else:
            vlist.append(ins[slot.src].to(torch.int64))
    return gcodes, sel, rows, vlist


def dense_route(num_codes: int, slots, max_codes: int) -> str:
    """The dense tier's route for a query of ``num_codes`` combined codes
    and these partial slots: "segment" up to ``_SORTED_THRESHOLD`` codes;
    up to ``max_codes``, "table" where every slot is a sum (counts come
    with every route) and "sorted" otherwise; past it "shuffle"."""
    if num_codes > max_codes:
        return "shuffle"
    if num_codes <= _SORTED_THRESHOLD:
        return "segment"
    return "table" if all(slot.op == K.AGG_SUM for slot in slots) else "sorted"


def _live_rows(n, shard: int, m: int) -> tuple:
    """(row_base, live): the first part row of shard ``shard`` of ``m``
    rows, and how many of its rows lie below the part's ``n`` live rows."""
    row_base = shard * m
    return row_base, min(max(int(n) - row_base, 0), m)


def _segment_reduce(n, shard: int, c32, sel, vlist, slots, num_codes: int):
    """One shard's segment-route reduction: (counts, first, partials). The
    counts, the first rows and the first sum come from one
    ``dense_segment_sum_count`` pass over the shard's live rows, each
    further sum from one more. Min and max take
    ``kernels.dense_group_reduce``, which reduces full-range int64 keys
    exactly and leaves an empty group at the int64 extreme, an fmm slot's
    identity."""
    row_base, live = _live_rows(n, shard, c32.shape[0])
    c32 = c32.to(torch.int32).contiguous()
    sums = [i for i, slot in enumerate(slots) if slot.op == K.AGG_SUM]
    partials = [None] * len(slots)
    values = vlist[sums[0]].contiguous() if sums else None
    counts, first, s0 = AK.dense_segment_sum_count(
        c32, sel, values, live, row_base, num_codes
    )
    if sums:
        partials[sums[0]] = s0
    for i in sums[1:]:
        partials[i] = AK.dense_segment_sum_count(
            c32, sel, vlist[i].contiguous(), live, row_base, num_codes
        )[2]
    for i, slot in enumerate(slots):
        if slot.op != K.AGG_SUM:
            partials[i] = K.dense_group_reduce(c32, vlist[i], sel, num_codes, slot.op)
    return counts, first, partials


def _table_reduce(n, shard: int, c32, sel, vlist, num_codes: int):
    """One shard's table-route reduction (every slot a sum): (counts,
    first, partials) from one ``dense_table_sum_count`` call over the
    shard's live rows."""
    row_base, live = _live_rows(n, shard, c32.shape[0])
    counts, first, sums = AK.dense_table_sum_count(
        c32.to(torch.int32).contiguous(), sel, tuple(v.contiguous() for v in vlist),
        live, row_base, num_codes,
    )
    return counts, first, list(sums)


def _sparse_pairs(gcodes, sel, rows, vlist, slots, num_codes: int) -> list:
    """Local sparse reduce of one shard's selected rows: a stable sort of
    the rows by code puts the selected rows first, each code's rows in
    stream order; only that prefix is reduced (one host sync), into one
    (code, count, first row, partials...) pair per distinct code, codes
    ascending. ``rows`` ascend. Returns the pair columns as int64 tensors.
    fmm ordering keys reduce like any int64, since no identity competes
    inside a pair."""
    n_sel = int(sel.sum())
    if n_sel == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=gcodes.device)
        return [empty] * (3 + len(vlist))
    keyv = torch.where(sel, gcodes.to(torch.int64), num_codes)
    order = torch.sort(keyv, stable=True).indices[:n_sel]
    ks = keyv[order]
    head = K._diffs(ks)
    starts = torch.nonzero(head).squeeze(1)
    seg = torch.cumsum(head.to(torch.int32), 0) - 1
    n_pairs = starts.shape[0]
    cols = [
        ks[starts],
        torch.diff(starts, append=starts.new_full((1,), n_sel)),
        rows[order[starts]],
    ]
    for v, slot in zip(vlist, slots):
        cols.append(K._segment(v[order], seg, n_pairs, _REDUCE[slot.op]))
    return cols


def _scatter_pairs(tabs, at, cols, slots) -> None:
    """Owner scatter of pair columns (code, count, first, partials...) into
    the carried tables (counts, first, one per slot) at ``at``."""
    tabs[0].index_add_(0, at, cols[1])
    tabs[1].scatter_reduce_(0, at, cols[2], reduce="amin")
    for t, part, slot in zip(tabs[2:], cols[3:], slots):
        if slot.op == K.AGG_SUM:
            t.index_add_(0, at, part)
        else:
            t.scatter_reduce_(0, at, part, reduce=_REDUCE[slot.op])


class DenseLocalAggregate(CompiledFilterAggregate):
    """One matched query over one table on the table's device: the dense
    tier between the compiled tier and the generic engine. Group-bys past
    the kernels' 2048-code ceiling (up to 2^20 compact codes, and to 2^27
    on the shuffle route) stay device-resident across queries (the role of
    aggregate.go's unbounded group map).

    Inherits the compiled tier's plan validation, part pruning
    (_filter_parts), dictionary LUTs (_leaf_lut_np) and output emission;
    only the device execution differs."""

    MAX_CODES = 1 << 20
    SPAN = "dense/execute"

    def __init__(self, spec):
        super().__init__(
            spec.table,
            spec.group_col,
            spec.aggs,
            spec.filter,
            spec.output_projection,
            ordered=spec.ordered,
            filter_expr=spec.filter_expr,
        )

    def _part_data(self, part):
        # Share the compiled tier's per-part device cache: one upload
        # serves both tiers.
        return part.device()

    def _replicated(self, t: torch.Tensor):
        """A constant (LUT, remap) where every shard reads it: the one
        device's tensor as it is."""
        return t

    def _shard_inputs(self, sig, args, shard: int = 0):
        """Shard ``shard``'s unpacked inputs of a part: here the part's
        own."""
        clause_sigs, gshape = sig
        return _unpack_inputs(args, gshape, clause_sigs, self._slots, shard)

    # ------------------------------------------------------------------

    def _clause_layout(self, part) -> list:
        """Per-part static resolution of the CNF clauses: each entry is
        "true" (a missing all-true leaf makes the whole OR clause a no-op),
        "false" (every leaf missing and false — unreachable through
        _filter_parts, kept for direct callers), or a list of
        (leaf_index, sig) for the leaves present in the part."""
        from ..compiled import _missing_leaf_all_true

        layout = []
        for idxs in self.clauses:
            static_true = False
            present: list = []
            for i in idxs:
                leaf = self.filters[i]
                if part.batch.column(leaf.column) is None:
                    if _missing_leaf_all_true(leaf):
                        static_true = True
                        break
                    continue
                if leaf.kind == "int":
                    present.append((i, ("int", leaf.op)))
                elif leaf.lit is None:
                    present.append((i, ("nulllit", leaf.op)))
                else:
                    present.append((i, ("dict",)))
            if static_true:
                layout.append("true")
            elif not present:
                layout.append("false")
            else:
                layout.append(present)
        return layout

    def _part_signature(self, part) -> tuple:
        """Static structure of one part's inputs: the clause layout (which
        filter leaves are present — missing dynamic columns resolve
        statically) and the group-key plan shape. The value inputs follow
        the query's partial slots."""
        clause_sigs = tuple(
            lay
            if isinstance(lay, str)
            else tuple(sig for _i, sig in lay)
            for lay in self._clause_layout(part)
        )
        gshape = tuple(
            (gcol.kind, gcol.remap is not None, gcol.k)
            for gcol in self._gplan
        )
        return (clause_sigs, gshape)

    def _part_args(self, part, sp) -> list:
        """Flat argument list matching ``_part_signature``'s layout, then
        each non-count aggregation's inputs (``Slot.width``)."""
        args = [part.batch.num_rows]
        for gcol in self._gplan:
            g = sp.column(gcol.name)
            if gcol.kind == "int":
                args += [g.data, g.validity, gcol.window, gcol.base]
            else:
                args += [g.data, g.validity]
                if gcol.remap is not None:
                    args.append(self._replicated(self._remap_dev(gcol)))
        for lay in self._clause_layout(part):
            if isinstance(lay, str):
                continue
            for i, _sig in lay:
                leaf = self.filters[i]
                f = sp.column(leaf.column)
                if leaf.kind == "int":
                    args += [f.data, f.validity, leaf.lit]
                elif leaf.lit is None:
                    args += [f.validity]
                else:
                    args += [f.data, f.validity, self._replicated(self._leaf_lut_dev(i))]
        for spec in self.aggs:
            if spec.func == E.AGG_COUNT:
                continue
            v = sp.column(spec.column)
            if v is None:
                raise NotCompilable(f"part lacks {spec.column}")
            plan = self.value_plans[spec.column]
            if spec.func in (E.AGG_MIN, E.AGG_MAX) and plan.fmm:
                # monotone int64 key plane (host-transformed, cached):
                # k = bits ^ ((bits >> 63) & 0x7FF..F) orders exactly like
                # the doubles; decode inverts the same transform.
                col = spec.column

                def mk_fmm(col=col, part=part):
                    def compute():
                        from ..columnbatch import Column as _HC

                        c = part.batch.column(col)
                        b = np.ascontiguousarray(
                            c.values, dtype=np.float64
                        ).view(np.int64)
                        k = b ^ ((b >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))
                        return _HC(
                            f"{col}#fmm",
                            "int64",
                            k,
                            np.ones(len(k), dtype=np.bool_),
                        )

                    return compute

                dc = sp.derived(f"{col}#fmm", mk_fmm())
                args += [dc.data, dc.validity]
                continue
            if spec.func == E.AGG_SUM and plan.fexact is not None:
                # Four host-decomposed digit planes (floatsum.decompose_np),
                # uploaded once per part via the derived-column cache (top
                # plane stays SIGNED — int64-native sums).
                from ..columnbatch import Column as _HC
                from ..floatsum import decompose_np

                col = spec.column
                scale = plan.fexact.scale

                def mk(pi, col=col, scale=scale, part=part, plan=plan):
                    def compute():
                        c = part.batch.column(col)
                        planes = decompose_np(c.values, plan.fexact)
                        return _HC(
                            f"{col}#fx{pi}@{scale}",
                            "int64",
                            planes[pi],
                            np.ones(len(planes[pi]), dtype=np.bool_),
                        )

                    return compute

                for pi in range(4):
                    dc = sp.derived(f"{col}#fx{pi}@{scale}", mk(pi))
                    args.append(dc.data)
            else:
                args += [v.data, v.validity]
        return args

    def _reduce_part(self, route, sig, args, num_codes: int, shard: int = 0):
        """One shard's (counts, first, partials) of a part as [num_codes]
        int64 tensors on the segment, table or sorted route: here the
        part's whole reduction."""
        gcodes, sel, rows, vlist = self._shard_inputs(sig, args, shard)
        if route == "segment":
            return _segment_reduce(args[0], shard, gcodes, sel, vlist, self._slots, num_codes)
        if route == "table":
            return _table_reduce(args[0], shard, gcodes, sel, vlist, num_codes)
        # One sort + prefix sums. Its min/max take a segment's first or
        # last sorted element, so fmm keys reduce exactly, but an empty
        # group holds +-2^62, which such keys can pass: it takes the
        # slot's int64-extreme identity.
        counts, first, outs = K.sorted_group_reduce(
            gcodes, sel, rows, tuple(vlist), num_codes, tuple(s.op for s in self._slots)
        )
        return counts, first, [
            torch.where(counts > 0, out, slot.ident) if slot.fmm else out
            for out, slot in zip(outs, self._slots)
        ]

    # ------------------------------------------------------------------

    def _execute(self):
        parts = self._serving_parts()
        ranges = self._check_parts_common(parts)
        for plan in self.value_plans.values():
            vmin, vmax = ranges.get(plan.column, (None, None))
            if plan.need_minmax and vmax is not None:
                if vmax >= _BIG or vmin <= -_BIG:
                    # Values past the reductions' +-2^62 identity headroom
                    # — generic engine territory.
                    raise NotCompilable("min/max values near int64 sentinel")
        self._slots = partial_slots(self.aggs, self.value_plans)
        self._gplan, num_codes = self._group_remap(parts, max_codes=SHUFFLE_MAX_CODES)
        route = dense_route(num_codes, self._slots, self.MAX_CODES)
        if route == "shuffle":
            # Past the [K] partials' ceiling: sparse pairs into tables of
            # O(K / shards) per shard (the role of aggregate.go:430-470's
            # overflow splitting, distributed).
            return self._execute_shuffle(parts, num_codes)
        return self._execute_dense(parts, num_codes, route)

    def _execute_dense(self, parts, num_codes: int, route: str):
        """The segment, table or sorted route: each part's [K] partials
        folded across parts on the device, the groups' emission order
        sorted there, and the rows copied once in that order."""
        result_names = [spec.result_name for spec in self.aggs]
        if not parts:
            empty = np.asarray([], dtype=np.int64)
            return emit_output(
                self._emitted_group_cols(empty),
                empty,
                result_names,
                {n: np.zeros(num_codes, np.int64) for n in result_names},
                self.output_projection,
            )

        counts = torch.zeros((num_codes,), dtype=torch.int64, device=self.device)
        first = torch.full((num_codes,), _BIG, dtype=torch.int64, device=self.device)
        acc = [None] * len(self._slots)
        offset = 0
        with _span("dense/parts", parts=len(parts), route=route):
            for p in parts:
                counts_p, first_p, partials = self._reduce_part(
                    route, self._part_signature(p), self._part_args(p, self._part_data(p)), num_codes
                )
                counts = counts + counts_p
                first = torch.minimum(
                    first, torch.where(counts_p > 0, first_p + offset, _BIG)
                )
                acc = [
                    out if a is None else _FOLD[slot.op](a, out)
                    for a, out, slot in zip(acc, partials, self._slots)
                ]
                # live rows only: padding rows never select
                offset += p.batch.num_rows

        # Group emission order = first occurrence among selected rows of the
        # concatenated part stream (matching kernels.group_ids), absent
        # codes last. Each row has exactly one code, so present codes'
        # positions are distinct and any sort gives that one order; they
        # lie below ``offset``, the sentinel, which narrows the keys to
        # int32 (half the radix passes) whenever it fits.
        key = torch.where(counts > 0, first, offset)
        if offset < 2**31:
            key = key.to(torch.int32)
        perm = torch.sort(key).indices
        # Every [K] row gathered into that order, the permutation in the
        # place of ``first``; ONE device-to-host copy for the query.
        rows = torch.index_select(torch.stack([counts, first, *acc]), 1, perm)
        rows[1] = perm
        blob = _copy_to_host(rows.reshape(-1))
        return self._finish(blob, self._dense_epilogue, blob, num_codes)

    def _execute_shuffle(self, parts, num_codes: int):
        """The shuffle route: each part's selected rows reduced into sparse
        (code, count, first, partials) pairs, scattered into [num_codes]
        tables carried across parts (one owner: slot == code)."""
        tabs = [
            torch.full((num_codes,), f, dtype=torch.int64, device=self.device)
            for f in (0, _BIG, *(slot.ident for slot in self._slots))
        ]
        offset = 0
        with _span("dense/parts", parts=len(parts), route="shuffle"):
            for p in parts:
                gcodes, sel, rows, vlist = self._shard_inputs(
                    self._part_signature(p), self._part_args(p, self._part_data(p))
                )
                # The tables accumulate ACROSS parts, so each part's rows
                # shift by its offset in the concatenated stream.
                cols = _sparse_pairs(gcodes, sel, rows + offset, vlist, self._slots, num_codes)
                _scatter_pairs(tabs, cols[0], cols, self._slots)
                offset += p.batch.num_rows
        blob = _copy_to_host(torch.cat(tabs))
        return self._finish(blob, self._shuffle_epilogue, blob.reshape(-1, num_codes))

    def _finish(self, blob, epilogue, *args):
        """``epilogue(*args)`` with the result blob's bytes reserved (the
        per-query transient, query/memory.go:17) and released once, also
        when the epilogue raises. (The reference's shuffle epilogue
        released it a second time, so a second query's bytes went with
        it.)"""
        if self.allocator is not None:
            self.allocator.allocate(int(blob.nbytes))
        try:
            return self._run_epilogue(epilogue, *args)
        finally:
            if self.allocator is not None:
                self.allocator.free(int(blob.nbytes))

    def _decode(self, counts, partials) -> dict:
        """Every route's host decoder: the result columns by name from the
        group counts and the slot rows (``partials[i]`` is slot i's,
        aligned with ``counts``)."""
        rows_of: dict = {}
        for row, slot in zip(partials, self._slots):
            rows_of.setdefault(slot.agg, []).append(row)
        by_name: dict[str, np.ndarray] = {}
        for j, spec in enumerate(self.aggs):
            name = spec.result_name
            if spec.func == E.AGG_COUNT:
                by_name[name] = counts
                continue
            plan = self.value_plans[spec.column]
            rows = rows_of[j]
            if spec.func == E.AGG_SUM and plan.fexact is not None:
                from ..floatsum import recombine

                by_name[name] = recombine(rows, plan.fexact)
            elif spec.func == E.AGG_UNIQUE:
                mn, mx, vc = rows
                uvalid = (mn == mx) & (vc == counts)
                by_name[name] = (np.where(uvalid, mn, 0), uvalid)
            elif spec.func == E.AGG_AND:
                by_name[name] = (rows[0] > 0).astype(np.bool_)
            elif spec.func in (E.AGG_MIN, E.AGG_MAX) and plan.fmm:
                # invert the monotone transform, reinterpret as float64
                k = rows[0].astype(np.int64)
                b = k ^ ((k >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))
                by_name[name] = b.view(np.float64)
            elif plan.is_float:
                by_name[name] = rows[0].astype(np.float64)
            else:
                by_name[name] = rows[0]
        return by_name

    def _dense_epilogue(self, blob, num_codes: int):
        # The rows arrive in emission order (see _execute_dense), the
        # present codes first: row 1 holds the codes themselves.
        _annotate(order="device")
        rows = blob.reshape(-1, num_codes)
        n = int(np.count_nonzero(rows[0]))
        rows = rows[:, :n]
        pos = self._ordered_positions(rows[1])
        if pos is not None:
            rows = rows[:, pos]
        return emit_output(
            self._emitted_group_cols(rows[1]),
            None,
            [spec.result_name for spec in self.aggs],
            self._decode(rows[0], rows[2:]),
            self.output_projection,
            ordered_rows=n,
        )

    def _shuffle_epilogue(self, tables):
        # tables: [2 + slots, num_codes] in code order; the emission order
        # is sorted here, on the host.
        counts, first = tables[0], tables[1]
        present = np.nonzero(counts > 0)[0]
        order_arr = present[np.argsort(first[present], kind="stable")]
        order_arr = self._ordered_sort(order_arr.astype(np.int64))
        return emit_output(
            self._emitted_group_cols(order_arr),
            order_arr,
            [spec.result_name for spec in self.aggs],
            self._decode(counts, tables[2:]),
            self.output_projection,
        )


def lower_plan_dense(plan, exec_options) -> DenseLocalAggregate:
    """The engine's large-K fallback: same matched shape, dense int64
    reductions on the table's device."""
    from ..compiled import match_plan

    obj = DenseLocalAggregate(match_plan(plan, exec_options))
    if exec_options is not None:
        obj.allocator = exec_options.allocator
    return obj


# ---------------------------------------------------------------------------
# Mesh tier: the dense tier across the shards of a mesh


class MeshFilterAggregate(DenseLocalAggregate):
    """One matched query over one table, executed across the mesh: each
    part row-sharded, constants replicated, the dense tier's reduction run
    on every shard and combined by collectives, and past 2^20 codes the
    pair exchange to owner shards."""

    SPAN = "mesh/execute"

    def __init__(self, spec, mesh, axis: str = "shards"):
        super().__init__(spec)
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.devices = tuple(mesh.devices)
        # constants upload to, and partials gather on, shard 0's device
        self.device = self.devices[0]

    def _part_data(self, part):
        """The part's device mirror: row-sharded over the mesh (cached per
        (mesh, axis) on the part)."""
        return part.device_sharded(self.mesh, self.axis)

    def _replicated(self, t: torch.Tensor) -> ShardedTensor:
        """A constant (LUT, remap) with one copy on each shard's device."""
        return ShardedTensor(t.to(d) for d in self.devices)

    def _shard_inputs(self, sig, args, shard: int = 0):
        """Shard ``shard``'s inputs: its shard of each ShardedTensor, every
        other argument as it is. A tensor on another device than the
        shard's raises: no shard runs anywhere but on its own device."""
        dev = self.devices[shard]
        xs = [a[shard] if isinstance(a, ShardedTensor) else a for a in args]
        for a in xs:
            if isinstance(a, torch.Tensor) and a.device != dev:
                raise RuntimeError(
                    f"shard {shard} runs on {dev}, but an input lies on {a.device}"
                )
        return super()._shard_inputs(sig, xs, shard)

    def _reduce_part(self, route, sig, args, num_codes: int):
        """Every shard's reduction, combined across shards by each
        partial's collective on shard 0's device. A shard's fmm min/max is
        its exact int64 key (or the int64 extreme when empty), so the
        combine needs no second pass."""
        local = super()._reduce_part
        shards = [
            local(route, sig, args, num_codes, s) for s in C.axis_index(self.n_shards)
        ]
        counts = C.psum([sh[0] for sh in shards])[0]
        first = C.pmin([sh[1] for sh in shards])[0]
        return counts, first, [
            _COMBINE[slot.op]([sh[2][i] for sh in shards])[0]
            for i, slot in enumerate(self._slots)
        ]

    def _execute_shuffle(self, parts, num_codes: int):
        if self.n_shards == 1:
            # One owner: the dense tier's route, with no exchange (the
            # reference exchanges on one shard too).
            return super()._execute_shuffle(parts, num_codes)
        with _span("dense/parts", parts=len(parts), route="shuffle"):
            blob, k_per = self._mesh_shuffle_blob(parts, num_codes)
        # table t is [n_shards * k_per]: slot j * k_per + s (shard j's
        # slot s) holds code s * n_shards + j
        codes = np.arange(num_codes, dtype=np.int64)
        g_of_code = (codes % self.n_shards) * k_per + codes // self.n_shards
        tables = blob.reshape(-1, k_per * self.n_shards)[:, g_of_code]
        return self._finish(blob, self._shuffle_epilogue, tables)

    def _shuffle_program(self, sig, num_codes, k_per: int, cap: int):
        """One part's shuffle-route program over the mesh: each shard's
        local sparse reduce into (code, count, first, partials) pairs (each
        key at most once per sender, so a heavy key cannot overflow a
        destination), the pair exchange to owner shard ``code % n_shards``
        (gather-packed [n_shards, cap] buckets, an exact overflow ``pmax``,
        ``all_to_all``), then each owner's scatter into its carried
        [k_per] tables at slot ``code // n_shards`` — per-shard memory
        O(K / n_shards), never a replicated [K] table. Returns (tables,
        overflowed); an overflowed exchange leaves the tables as they
        were."""
        n_shards = self.n_shards

        def step(*args, tabs, offset):
            pairs = []
            for s in C.axis_index(n_shards):
                gcodes, sel, rows, vlist = self._shard_inputs(sig, args, s)
                pairs.append(
                    _sparse_pairs(gcodes, sel, rows + offset, vlist, self._slots, num_codes)
                )
            packs = [bucket_slots(cols[0] % n_shards, n_shards, cap) for cols in pairs]
            over = C.pmax([(pk[3] > cap).any().to(torch.int32) for pk in packs])
            if bool(over[0]):
                return tabs, True
            # packed slots hold valid pairs exactly where in_bucket
            recv = []
            for j in range(len(pairs[0])):
                packed = []
                for cols, (order, src, in_bucket, _n) in zip(pairs, packs):
                    c = cols[j]
                    c_s = c[order][src] if c.shape[0] else torch.zeros_like(src)
                    packed.append(
                        torch.where(in_bucket, c_s, 0).reshape(n_shards, cap)
                    )
                recv.append([x.reshape(-1) for x in C.all_to_all(packed)])
            r_valid = C.all_to_all([pk[2].reshape(n_shards, cap) for pk in packs])
            for d in C.axis_index(n_shards):
                # invalid slots scatter into the drop slot k_per, which the
                # blob leaves out
                at = torch.where(
                    r_valid[d].reshape(-1), recv[0][d] // n_shards, k_per
                )
                _scatter_pairs(tabs[d], at, [col[d] for col in recv], self._slots)
            crossed = sum(
                int(pk[3].sum() - pk[3][s]) for s, pk in enumerate(packs)
            )
            EXCHANGE_STATS["exchanges"] += 1
            EXCHANGE_STATS["pairs"] += crossed
            EXCHANGE_STATS["bytes"] += (
                n_shards * (n_shards - 1) * cap * (8 * len(recv) + 1)
            )
            return tabs, False

        return step

    def _mesh_shuffle_blob(self, parts, num_codes: int):
        """The shuffle route across shards: per-shard [k_per] owner tables
        (k_per = K / n_shards rounded up to 128) carried across parts; an
        overflowed pair exchange restarts the query with the bucket
        capacity's oversubscription doubled, four attempts in all. Returns
        (the tables as one host blob, shard after shard; k_per)."""
        n_shards = self.n_shards
        fills = (0, _BIG, *(slot.ident for slot in self._slots))
        k_per = -(-num_codes // n_shards)
        k_per = ((k_per + 127) // 128) * 128
        oversub = 2.0
        for _attempt in range(4):
            max_rows = max((p.batch.num_rows for p in parts), default=1)
            per_shard = -(-max_rows // n_shards)
            cap = max(int(np.ceil(per_shard / n_shards * oversub / 128)) * 128, 128)
            # one drop slot past each shard's k_per (sliced off below)
            tabs = [
                [torch.full((k_per + 1,), f, dtype=torch.int64, device=d) for f in fills]
                for d in self.devices
            ]
            over = False
            offset = 0
            for p in parts:
                prog = self._shuffle_program(
                    self._part_signature(p), num_codes, k_per, cap
                )
                tabs, over = prog(
                    *self._part_args(p, self._part_data(p)), tabs=tabs, offset=offset
                )
                if over:
                    break
                offset += p.batch.num_rows
            if not over:
                break
            oversub *= 2.0
        else:
            raise NotCompilable("shuffle-tier pair exchange overflow")
        EXCHANGE_STATS["oversub"] = oversub
        dev0 = self.devices[0]
        blob = torch.cat([
            shard_tabs[ti][:k_per].to(dev0)
            for ti in range(len(fills))
            for shard_tabs in tabs
        ])
        return _copy_to_host(blob), k_per


def lower_plan_mesh(plan, exec_options) -> MeshFilterAggregate:
    """Match an optimized plan onto the mesh executor; raises NotCompilable
    when the shape doesn't hold (the engine falls back to the local tiers
    and the generic DAG)."""
    from ..compiled import match_plan

    spec = match_plan(plan, exec_options)
    obj = MeshFilterAggregate(spec, exec_options.mesh, exec_options.mesh_axis)
    obj.allocator = exec_options.allocator
    return obj
