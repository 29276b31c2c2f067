"""Mesh execution of the fused filter + group-by aggregate: the engine's
``mesh`` tier and its ``dense`` tier (reference:
frostdb_tpu/parallel/mesh_exec.py).

The compiled tier's matched query shape (``compiled.match_plan``) executes
part by part as int64 programs over dense group codes, each part
row-sharded over the mesh —

  per shard:   selection mask (the full compiled filter envelope: AND of
               OR-clauses of int64 compares, dict/string predicates as
               boolean-LUT gathers, ==/!= null via validity) -> dense
               per-code partials (segment reductions below 4096 codes,
               sort + prefix sums above; the non-final HashAggregate,
               aggregate.go:124)
  cross-shard: psum / pmin / pmax over the mesh (collectives.py; the
               final-stage Synchronizer, synchronize.go:16)
  across parts: the [K] partials accumulate on the device; one result
               blob comes back per query.

A shard program is a sequence of phases over the list of shards, split at
each collective (the float min/max two-pass reduce combines its hi halves
across shards before the lo pass). Results are identical to the generic
engine's on any shard count, group emission order included: each part
program reduces the exact first selected row per code (pmin across
shards; shard ``s`` holds part rows ``[s * per_shard, (s + 1) *
per_shard)``), parts accumulate the minimum global stream position (a
part's rows start at the sum of the live rows of the parts before it;
padding rows never select and never move an offset), and groups emit in
that first-occurrence order (or key order under ordered_aggregations). The
order is sorted on the device and every [K] partial is gathered into it
before the query's one copy, so the host epilogue only slices.

Scan state is incremental per part: each immutable part caches one
row-sharded mirror per (mesh, axis) (``Part.device_sharded``) until the
part is dropped, so an insert between two queries uploads only the new
part's columns.

Value columns reduce natively in int64: sums, min/max and integral
float64 columns. Non-integral float64 sums ride four exact digit planes
(floatsum.py) recombined on the host; float64 min/max reduce the monotone
int64 ordering key ``bits ^ ((bits >> 63) & 0x7FF..F)``, inverted on the
host.

Past 2^20 codes the query takes the shuffle route: a local sparse
sort-reduce of each shard's selected rows into (code, count, first,
partials) pairs; on more than one shard the pairs go to their owner shard
``code % n_shards`` through fixed-capacity buckets and an ``all_to_all``
(overflow detected exactly, capacity doubled and retried), and each owner
scatters them into [K / n_shards] tables carried across parts, up to 2^27
codes. Past that the generic engine serves.

``lower_plan_mesh`` is the engine's ``mesh`` tier (``ExecOptions(mesh=)``,
tried first); ``DenseLocalAggregate`` — the engine's ``dense`` tier
between ``compiled_join`` and ``compiled_distinct`` — runs the same
programs on a one-shard mesh over the compiled tier's ``part.device()``
cache. Every reduction is a torch op on its shard's device.
"""

from __future__ import annotations

from typing import Optional

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
from ..tracing import annotate as _annotate, count, span as _span
from . import collectives as C
from .shuffle import bucket_slots

# Sentinel for "no selected row yet" stream positions / min partials — the
# headroom convention of ops/kernels.sorted_group_reduce (values past 2^62
# fall back to the generic engine, see _execute's range guard).
_BIG = 2**62
_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)

# Past this many codes the program reduces via sort + prefix sums
# (kernels.sorted_group_reduce) instead of scatter segment reductions.
_SORTED_THRESHOLD = 4096

# Shuffle-route ceiling: up to 2^27 combined codes aggregate through the
# sparse pair reduce into [K] owner tables; beyond that the generic engine
# serves.
SHUFFLE_MAX_CODES = 1 << 27

# The cross-shard combine of each partial's reduction.
_COMBINE = {K.AGG_SUM: C.psum, K.AGG_MIN: C.pmin, K.AGG_MAX: C.pmax}

# The shuffle route's pair exchanges since the last reset (multi-shard
# meshes): exchanges run, live pairs sent to another shard, bucket bytes
# sent to another shard (padding slots included: the all_to_all moves
# whole buckets), and the oversubscription the last query ended at.
EXCHANGE_STATS = {"exchanges": 0, "pairs": 0, "bytes": 0, "oversub": 0.0}


def _op_width(func, fexact: bool) -> int:
    """Number of [K] partial vectors one aggregation spec contributes:
    exact-float sums carry 4 digit planes; unique carries (min, max,
    valid-count); everything else (incl. count, which re-emits the shared
    counts) carries one."""
    if fexact:
        return 4
    if func == E.AGG_UNIQUE:
        return 3
    return 1


def _unpack_inputs(xs, gshape, clause_sigs, ops, shard: int = 0):
    """Shared input unpacking for one shard of the dense and shuffle part
    programs: group-code build (dict remaps / window codes), CNF selection
    mask, the shard's part-row positions (``shard * per_shard + arange``),
    and the per-aggregation value list (incl. exact-float digit planes).
    Returns (next_arg_index, gcodes, sel, rows, vlist, vops, vfmm)."""
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
    vops = []
    vfmm = []
    for func, _is_float, fexact, fmm in ops:
        if func == E.AGG_COUNT:
            continue
        if fexact:
            for _p in range(4):
                vlist.append(xs[i].to(torch.int64))
                vops.append(K.AGG_SUM)
                vfmm.append(False)
                i += 1
            continue
        v, vvalid = xs[i], xs[i + 1]
        i += 2
        if func == E.AGG_UNIQUE:
            # unique = (min == max) & (valid-slot count == group count);
            # three plain reductions (kernels.segment_agg AGG_UNIQUE
            # decomposed), combined in the host epilogue.
            v64 = v.to(torch.int64)
            vlist += [v64, v64, vvalid.to(torch.int64)]
            vops += [K.AGG_MIN, K.AGG_MAX, K.AGG_SUM]
            vfmm += [False, False, False]
            continue
        if func == E.AGG_AND:
            # and = per-group min of (valid ? v : 1) — nulls true-neutral
            # (aggregate.go:798).
            vlist.append(torch.where(vvalid, v.to(torch.int64), 1))
            vops.append(K.AGG_MIN)
            vfmm.append(False)
            continue
        vlist.append(v.to(torch.int64))
        vops.append(func)
        vfmm.append(fmm)
    return i, gcodes, sel, rows, vlist, vops, vfmm


def _segment_reduce(n, shard: int, c32, sel, vlist, vops, vfmm, num_codes: int):
    """One shard's segment-route reduction: (counts, first, per-op
    partials). The counts, the first rows and the first int64 sum come from
    one ``dense_segment_sum_count`` pass over the shard's live rows, each
    further sum plane from one more; min/max/and stay on
    ``kernels.dense_group_reduce``; fmm partials are left to the caller
    (None)."""
    m = c32.shape[0]
    row_base = shard * m
    live = min(max(int(n) - row_base, 0), m)
    c32 = c32.to(torch.int32).contiguous()
    sums = [
        i
        for i, (func, fmm) in enumerate(zip(vops, vfmm))
        if func == K.AGG_SUM and not fmm
    ]
    partials = [None] * len(vlist)
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
    for i, (v, func, fmm) in enumerate(zip(vlist, vops, vfmm)):
        if func != K.AGG_SUM and not fmm:
            partials[i] = K.dense_group_reduce(c32, v, sel, num_codes, func)
    return counts, first, partials


def _sparse_pairs(gcodes, sel, rows, vlist, vops, num_codes: int) -> list:
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
    for v, func in zip(vlist, vops):
        reduce = {K.AGG_SUM: "sum", K.AGG_MIN: "amin"}.get(func, "amax")
        cols.append(K._segment(v[order], seg, n_pairs, reduce))
    return cols


def _scatter_pairs(tabs, slot, cols, vops) -> None:
    """Owner scatter of pair columns (code, count, first, partials...) into
    the carried tables (counts, first, per-value partials) at ``slot``."""
    tabs[0].index_add_(0, slot, cols[1])
    tabs[1].scatter_reduce_(0, slot, cols[2], reduce="amin")
    for vi, func in enumerate(vops):
        t, part = tabs[2 + vi], cols[3 + vi]
        if func == K.AGG_SUM:
            t.index_add_(0, slot, part)
        else:
            t.scatter_reduce_(
                0, slot, part, reduce="amin" if func == K.AGG_MIN else "amax"
            )


class MeshFilterAggregate(CompiledFilterAggregate):
    """One matched query over one table, executed across the mesh.

    Inherits the compiled path's plan validation, part pruning
    (_filter_parts), dictionary LUTs (_leaf_lut_np) and output emission;
    only the device execution differs: row-sharded parts, per-shard
    programs with int64 reductions, cross-shard collectives. On a
    one-shard mesh every collective is the identity.
    """

    MAX_CODES = 1 << 20
    SPAN = "mesh/execute"

    def __init__(self, spec, mesh, axis: str = "shards"):
        super().__init__(
            spec.table,
            spec.group_col,
            spec.aggs,
            spec.filter,
            spec.output_projection,
            ordered=spec.ordered,
            filter_expr=spec.filter_expr,
        )
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.trivial = self.n_shards == 1
        self.devices = tuple(mesh.devices)

    def _part_data(self, part):
        """The part's device mirror: row-sharded over the mesh (cached per
        (mesh, axis) on the part). The local dense tier overrides this to
        share the compiled tier's ``part.device()`` cache."""
        return part.device_sharded(self.mesh, self.axis)

    def _replicated(self, t: torch.Tensor) -> ShardedTensor:
        """A constant (LUT, remap) with one copy on each shard's device."""
        return ShardedTensor(t.to(d) for d in self.devices)

    def _shard_args(self, args, s: int) -> list:
        """Shard ``s``'s view of a program's flat arguments: its shard of
        each ShardedTensor, every other argument as it is. A tensor on
        another device than the shard's raises: no shard runs anywhere but
        on its own device."""
        dev = self.devices[s]
        out = []
        for a in args:
            if isinstance(a, ShardedTensor):
                a = a[s]
            if isinstance(a, torch.Tensor) and a.device != dev:
                raise RuntimeError(
                    f"shard {s} runs on {dev}, but an input lies on {a.device}"
                )
            out.append(a)
        return out

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
        """Static program structure for one part: the clause layout (which
        filter leaves are present — missing dynamic columns resolve
        statically), the group-key plan shape, and the aggregation op
        list."""
        clause_sigs = tuple(
            lay
            if isinstance(lay, str)
            else tuple(sig for _i, sig in lay)
            for lay in self._clause_layout(part)
        )
        ops = tuple(
            (
                spec.func,
                self.value_plans[spec.column].is_float,
                spec.func == E.AGG_SUM
                and self.value_plans[spec.column].fexact is not None,
                spec.func in (E.AGG_MIN, E.AGG_MAX)
                and self.value_plans[spec.column].fmm,
            )
            if spec.func != E.AGG_COUNT
            else (E.AGG_COUNT, False, False, False)
            for spec in self.aggs
        )
        gshape = tuple(
            (gcol.kind, gcol.remap is not None, gcol.k)
            for gcol in self._gplan
        )
        return (clause_sigs, ops, gshape)

    def _program(self, sig: tuple, num_codes: int):
        """One part's dense program: (counts, first, per-agg partials) as
        [num_codes] int64 tensors, combined across shards, on shard 0's
        device. Plain torch ops: there is nothing to compile, so programs
        are not cached."""
        clause_sigs, ops, gshape = sig
        sorted_path = num_codes > _SORTED_THRESHOLD

        def local(xs, s):
            # xs layout: n, then per group col (dict: codes, valid, [remap]
            # | int: values, valid, window, base), then per present leaf
            # (int: fvals,fvalid,lit | nulllit: fvalid | dict:
            # fcodes,fvalid,lut), then per non-count agg (vals, vvalid /
            # fexact: 4 digit planes) — unpacked by _unpack_inputs.
            _i, c32, sel, rows, vlist, vops, vfmm = _unpack_inputs(
                xs, gshape, clause_sigs, ops, s
            )
            if sorted_path:
                # Large K: one sort + prefix sums. Its min/max take the
                # segment's first/last SORTED element, so full-range
                # monotone float keys (fmm) are sentinel-safe — but EMPTY
                # groups hold the +-2^62 identity, which transformed keys
                # can exceed; widen those slots to the int64 extremes
                # before the cross-shard combine.
                counts, first, outs_l = K.sorted_group_reduce(
                    c32, sel, rows, tuple(vlist), num_codes, tuple(vops)
                )
                partials = list(outs_l)
                for vi2, (func, fmm) in enumerate(zip(vops, vfmm)):
                    if fmm:
                        ident = _I64_MAX if func == K.AGG_MIN else _I64_MIN
                        partials[vi2] = torch.where(
                            counts > 0, partials[vi2], ident
                        )
            else:
                counts, first, partials = _segment_reduce(
                    xs[0], s, c32, sel, vlist, vops, vfmm, num_codes
                )
            return c32, sel, vlist, vops, counts, first, partials

        def fmm_reduce(shards, vi, func):
            # Monotone float keys span the full int64 range; reduce
            # lexicographically as (hi, lo) int32-range halves (the
            # compiled wide-min/max pattern): the hi pass is combined
            # across shards before each shard's lo pass selects the rows
            # that hold the global hi.
            combine = C.pmin if func == K.AGG_MIN else C.pmax
            his = [sh[2][vi] >> 32 for sh in shards]
            g_hi = combine([
                K.dense_group_reduce(sh[0], hi, sh[1], num_codes, func)
                for sh, hi in zip(shards, his)
            ])
            g_lo = combine([
                K.dense_group_reduce(
                    sh[0],
                    sh[2][vi] & 0xFFFFFFFF,
                    sh[1] & (hi == _take_clip(g, sh[0])),
                    num_codes,
                    func,
                )
                for sh, hi, g in zip(shards, his, g_hi)
            ])
            return (g_hi[0] << 32) | g_lo[0]

        def step(*args):
            shards = [
                local(self._shard_args(args, s), s)
                for s in C.axis_index(self.n_shards)
            ]
            if not sorted_path:
                count(
                    "dense_segment_fused_total",
                    "dense-tier parts whose counts, first rows and sums took "
                    "one dense_segment_sum_count pass",
                )
            vops = shards[0][3]
            counts = C.psum([sh[4] for sh in shards])[0]
            first = C.pmin([sh[5] for sh in shards])[0]
            outs = [counts, first]
            vi = 0
            for func, _is_float, fexact, fmm in ops:
                if func == E.AGG_COUNT:
                    outs.append(counts)
                    continue
                if fmm and not sorted_path:
                    # empty groups clamp so the cross-part accumulate never
                    # sees wrapped sentinels
                    ident = _I64_MAX if func == E.AGG_MIN else _I64_MIN
                    g = fmm_reduce(shards, vi, vops[vi])
                    outs.append(torch.where(counts > 0, g, ident))
                    vi += 1
                    continue
                for _w in range(_op_width(func, fexact)):
                    outs.append(
                        _COMBINE[vops[vi]]([sh[6][vi] for sh in shards])[0]
                    )
                    vi += 1
            return tuple(outs)

        return step

    def _part_args(self, part, sp) -> list:
        """Flat argument list matching ``_part_signature``'s layout."""
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

    # ------------------------------------------------------------------

    def _table_fills(self) -> list:
        """The shuffle route's carried tables and their identities: counts,
        first, then per aggregation op (fmm ordering keys span full int64
        -> int64-extreme identities)."""
        fills = [0, _BIG]
        for spec in self.aggs:
            if spec.func == E.AGG_COUNT:
                continue
            plan2 = self.value_plans[spec.column]
            if plan2.fexact is not None:
                fills += [0] * 4
            elif spec.func == E.AGG_UNIQUE:
                fills += [_BIG, -_BIG, 0]
            elif spec.func == E.AGG_AND:
                fills.append(_BIG)
            elif spec.func == E.AGG_MIN:
                fills.append(_I64_MAX if plan2.fmm else _BIG)
            elif spec.func == E.AGG_MAX:
                fills.append(_I64_MIN if plan2.fmm else -_BIG)
            else:
                fills.append(0)
        return fills

    def _local_shuffle_program(self, sig, num_codes: int):
        """One part's shuffle-route program on a one-shard mesh: the local
        sparse reduce (``_sparse_pairs``), then a scatter into the carried
        [num_codes] tables (one owner: slot == code)."""
        clause_sigs, ops, gshape = sig

        def step(*args, tabs, offset):
            _i, gcodes, sel, rows, vlist, vops, _vfmm = _unpack_inputs(
                self._shard_args(args, 0), gshape, clause_sigs, ops
            )
            # Global stream position: the tables accumulate ACROSS parts,
            # so each part's rows shift by its offset in the concatenated
            # stream (the dense path adds it outside).
            cols = _sparse_pairs(gcodes, sel, rows + offset, vlist, vops, num_codes)
            _scatter_pairs(tabs, cols[0], cols, vops)
            return tabs

        return step

    def _shuffle_program(self, sig, num_codes: int, k_per: int, cap: int):
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
        clause_sigs, ops, gshape = sig
        n_shards = self.n_shards

        def step(*args, tabs, offset):
            pairs = []
            vops = None
            for s in C.axis_index(n_shards):
                _i, gcodes, sel, rows, vlist, vops, _vfmm = _unpack_inputs(
                    self._shard_args(args, s), gshape, clause_sigs, ops, s
                )
                pairs.append(
                    _sparse_pairs(gcodes, sel, rows + offset, vlist, vops, num_codes)
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
                slot = torch.where(
                    r_valid[d].reshape(-1), recv[0][d] // n_shards, k_per
                )
                _scatter_pairs(tabs[d], slot, [col[d] for col in recv], vops)
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

    def _execute_shuffle(self, parts, num_codes: int):
        fills = self._table_fills()
        if self.trivial:
            k_per = num_codes
            tabs = [
                torch.full((num_codes,), f, dtype=torch.int64, device=self.devices[0])
                for f in fills
            ]
            offset = 0
            with _span("dense/parts", parts=len(parts), route="shuffle"):
                for p in parts:
                    prog = self._local_shuffle_program(self._part_signature(p), num_codes)
                    prog(*self._part_args(p, self._part_data(p)), tabs=tabs, offset=offset)
                    offset += p.batch.num_rows
            blob = _copy_to_host(torch.cat(tabs))
        else:
            with _span("dense/parts", parts=len(parts), route="shuffle"):
                blob, k_per = self._mesh_shuffle_blob(parts, num_codes, fills)
        if self.allocator is not None:
            self.allocator.allocate(int(blob.nbytes))
        try:
            return self._run_epilogue(self._shuffle_epilogue, blob, num_codes, k_per)
        finally:
            # the one release of the reservation (the reference's epilogue
            # released it too, so a second query's bytes went with it)
            if self.allocator is not None:
                self.allocator.free(int(blob.nbytes))

    def _mesh_shuffle_blob(self, parts, num_codes: int, fills):
        """The shuffle route across shards: per-shard [k_per] owner tables
        (k_per = K / n_shards rounded up to 128) carried across parts; an
        overflowed pair exchange restarts the query with the bucket
        capacity's oversubscription doubled, four attempts in all. Returns
        (the tables as one host blob, shard after shard; k_per)."""
        n_shards = self.n_shards
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

    def _shuffle_epilogue(self, blob, num_codes, k_per):
        # table ti is [n_shards * k_per]: global slot g = j * k_per + slot
        # on shard j holds code slot * n_shards + j
        k_pad = k_per * self.n_shards
        g_of_code = None
        if not self.trivial:
            codes = np.arange(num_codes, dtype=np.int64)
            g_of_code = (codes % self.n_shards) * k_per + codes // self.n_shards

        def table(ti):
            t = blob[ti * k_pad : (ti + 1) * k_pad]
            return t if g_of_code is None else t[g_of_code]

        counts_np = table(0)
        first_np = table(1)
        by_name: dict[str, np.ndarray] = {}
        ti = 2
        for spec in self.aggs:
            name = spec.result_name
            if spec.func == E.AGG_COUNT:
                by_name[name] = counts_np
                continue
            plan = self.value_plans[spec.column]
            if plan.fexact is not None:
                from ..floatsum import recombine

                pls = [table(ti + pi) for pi in range(4)]
                ti += 4
                by_name[name] = recombine(pls, plan.fexact)
                continue
            if spec.func == E.AGG_UNIQUE:
                mn, mx, vc = table(ti), table(ti + 1), table(ti + 2)
                ti += 3
                uvalid = (mn == mx) & (vc == counts_np)
                by_name[name] = (np.where(uvalid, mn, 0), uvalid)
                continue
            if spec.func == E.AGG_AND:
                vals = table(ti)
                ti += 1
                by_name[name] = (vals > 0).astype(np.bool_)
                continue
            vals = table(ti)
            ti += 1
            if spec.func in (E.AGG_MIN, E.AGG_MAX) and plan.fmm:
                # invert the monotone transform, reinterpret as float64
                k2 = vals.astype(np.int64)
                b = k2 ^ ((k2 >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))
                by_name[name] = b.view(np.float64)
                continue
            if plan.is_float:
                vals = vals.astype(np.float64)
            by_name[name] = vals

        present = np.nonzero(counts_np > 0)[0]
        order_arr = present[np.argsort(first_np[present], kind="stable")]
        order_arr = self._ordered_sort(order_arr.astype(np.int64))
        return emit_output(
            self._emitted_group_cols(order_arr),
            order_arr,
            [spec.result_name for spec in self.aggs],
            by_name,
            self.output_projection,
        )

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
        try:
            self._gplan, num_codes = self._group_remap(parts)
        except NotCompilable as e:
            if "group code space" not in str(e):
                raise
            # Shuffle route: past the replicated-[K] ceiling, aggregate via
            # local sparse reduce + pair exchange + owner tables of
            # O(K/shards) memory per shard (the role of
            # aggregate.go:430-470's overflow splitting, distributed).
            self._gplan, num_codes = self._group_remap(
                parts, max_codes=SHUFFLE_MAX_CODES
            )
            return self._execute_shuffle(parts, num_codes)

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

        dev = self.devices[0]
        counts_total = torch.zeros((num_codes,), dtype=torch.int64, device=dev)
        global_first = torch.full(
            (num_codes,), _BIG, dtype=torch.int64, device=dev
        )
        acc: dict[str, Optional[object]] = {n: None for n in result_names}
        offset = 0
        route = "sorted" if num_codes > _SORTED_THRESHOLD else "segment"
        with _span("dense/parts", parts=len(parts), route=route):
            for p in parts:
                sp = self._part_data(p)
                sig = self._part_signature(p)
                prog = self._program(sig, num_codes)
                outs = prog(*self._part_args(p, sp))
                counts_p, first_p = outs[0], outs[1]
                counts_total = counts_total + counts_p
                global_first = torch.minimum(
                    global_first, torch.where(counts_p > 0, first_p + offset, _BIG)
                )
                oi = 2
                for spec in self.aggs:
                    name = spec.result_name
                    prev = acc[name]
                    if (
                        spec.func == E.AGG_SUM
                        and self.value_plans[spec.column].fexact is not None
                    ):
                        planes = list(outs[oi : oi + 4])
                        oi += 4
                        acc[name] = (
                            planes
                            if prev is None
                            else [a + b for a, b in zip(prev, planes)]
                        )
                        continue
                    if spec.func == E.AGG_UNIQUE:
                        mn_p, mx_p, vc_p = outs[oi : oi + 3]
                        oi += 3
                        acc[name] = (
                            [mn_p, mx_p, vc_p]
                            if prev is None
                            else [
                                torch.minimum(prev[0], mn_p),
                                torch.maximum(prev[1], mx_p),
                                prev[2] + vc_p,
                            ]
                        )
                        continue
                    out_p = outs[oi]
                    oi += 1
                    if prev is None:
                        acc[name] = out_p
                    elif spec.func in (E.AGG_SUM, E.AGG_COUNT):
                        acc[name] = prev + out_p
                    elif spec.func in (E.AGG_MIN, E.AGG_AND):
                        acc[name] = torch.minimum(prev, out_p)
                    else:
                        acc[name] = torch.maximum(prev, out_p)
                # live rows only: padding rows never select
                offset += p.batch.num_rows

        # Group emission order = first occurrence among selected rows of the
        # concatenated part stream (matching kernels.group_ids), absent
        # codes last. Each row has exactly one code, so present codes'
        # positions are distinct and any sort gives that one order; they
        # lie below ``offset``, the sentinel, which narrows the keys to
        # int32 (half the radix passes) whenever it fits.
        key = torch.where(counts_total > 0, global_first, offset)
        if offset < 2**31:
            key = key.to(torch.int32)
        perm = torch.sort(key).indices
        count(
            "dense_device_order_total",
            "dense-tier queries whose emission order was computed on the device",
        )
        # Every [K] row gathered into that order, the permutation in the
        # place of ``global_first``; ONE device-to-host copy for the query.
        blob_entries = [counts_total, global_first]
        for n in result_names:
            a = acc[n]
            blob_entries.extend(a if isinstance(a, list) else [a])
        rows = torch.index_select(torch.stack(blob_entries), 1, perm)
        rows[1] = perm
        blob = _copy_to_host(rows.reshape(-1))
        if self.allocator is not None:
            # per-query transient accounting (query/memory.go:17); freed in
            # a finally so an epilogue error cannot leak the reservation
            self.allocator.allocate(int(blob.nbytes))
        try:
            return self._run_epilogue(self._dense_epilogue, blob, num_codes, result_names)
        finally:
            if self.allocator is not None:
                self.allocator.free(int(blob.nbytes))

    def _dense_epilogue(self, blob, num_codes, result_names):
        # The rows arrive in emission order (see _execute), the present
        # codes first: row 1 holds the codes themselves.
        _annotate(order="device")
        rows = blob.reshape(-1, num_codes)
        n = int(np.count_nonzero(rows[0]))
        rows = rows[:, :n]
        pos = self._ordered_positions(rows[1])
        if pos is not None:
            rows = rows[:, pos]
        counts_np = rows[0]
        by_name: dict[str, np.ndarray] = {}
        ri = 2
        for j, name in enumerate(result_names):
            spec = self.aggs[j]
            plan = (
                self.value_plans.get(spec.column)
                if spec.func != E.AGG_COUNT
                else None
            )
            if (
                spec.func == E.AGG_SUM
                and plan is not None
                and plan.fexact is not None
            ):
                from ..floatsum import recombine

                by_name[name] = recombine(rows[ri : ri + 4], plan.fexact)
                ri += 4
                continue
            if spec.func == E.AGG_UNIQUE:
                mn, mx, vc = rows[ri], rows[ri + 1], rows[ri + 2]
                ri += 3
                uvalid = (mn == mx) & (vc == counts_np)
                by_name[name] = (np.where(uvalid, mn, 0), uvalid)
                continue
            vals = rows[ri]
            ri += 1
            if spec.func == E.AGG_AND:
                by_name[name] = (vals > 0).astype(np.bool_)
                continue
            if (
                spec.func in (E.AGG_MIN, E.AGG_MAX)
                and plan is not None
                and plan.fmm
            ):
                # invert the monotone transform and reinterpret as f64
                k = vals.astype(np.int64)
                b = k ^ ((k >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))
                by_name[name] = b.view(np.float64)
                continue
            if plan is not None and plan.is_float:
                vals = vals.astype(np.float64)
            by_name[name] = vals

        return emit_output(
            self._emitted_group_cols(rows[1]),
            None,
            result_names,
            by_name,
            self.output_projection,
            ordered_rows=n,
        )


def lower_plan_mesh(plan, exec_options) -> MeshFilterAggregate:
    """Match an optimized plan onto the mesh executor; raises NotCompilable
    when the shape doesn't hold (the engine falls back to the local tiers
    and the generic DAG)."""
    from ..compiled import match_plan

    spec = match_plan(plan, exec_options)
    obj = MeshFilterAggregate(spec, exec_options.mesh, exec_options.mesh_axis)
    obj.allocator = exec_options.allocator
    return obj


# ---------------------------------------------------------------------------
# Local dense tier: the single-device large-K path


class DenseLocalAggregate(MeshFilterAggregate):
    """Single-device dense tier between the compiled tier and the generic
    engine: the int64 program above over the table's ``part.device()``
    cache, so group-bys past the kernels' 2048-code ceiling (up to 2^20
    compact codes, and to 2^27 on the shuffle route) stay device-resident
    across queries (the role of aggregate.go's unbounded group map)."""

    SPAN = "dense/execute"

    def __init__(self, spec):
        from .mesh import make_mesh

        super().__init__(spec, make_mesh(1, device=spec.table.device), "shards")

    def _part_data(self, part):
        # Share the compiled tier's per-part device cache: one upload
        # serves both tiers.
        return part.device()


def lower_plan_dense(plan, exec_options) -> DenseLocalAggregate:
    """The engine's large-K fallback: same matched shape, dense int64
    reductions on the table's device."""
    from ..compiled import match_plan

    obj = DenseLocalAggregate(match_plan(plan, exec_options))
    if exec_options is not None:
        obj.allocator = exec_options.allocator
    return obj
