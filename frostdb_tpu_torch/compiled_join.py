"""Compiled join->aggregate serving: the groupjoin (eager aggregation)
decomposition executed on the hand-written CUDA kernels (ops/agg_kernels.py).

The generic engine executes ``Aggregate(Join(L, R))`` by materializing every
join pair on the host and aggregating them (query/physical.py HashJoin ->
HashAggregate). But an inner equi-join feeding a group-aggregate
whose group keys come from the probe (left) side never needs the pairs at
all: for any left row with key code c,

    sum over its pairs of w_right  =  S[c]      (per-code build-side sum)
    count of its pairs             =  CNT[c]
    min/max over its pairs         =  MIN[c] / MAX[c]
    sum over its pairs of v_left   =  v_left * CNT[c]

so the whole query collapses to a plain filtered group-aggregate over the
LEFT table — exactly the shape the compiled tier already serves on the
sum/count and min/max kernels — with three extensions (implemented as hooks
in compiled.py):

- an ``in_lut`` filter leaf: match mask = lut[key codes] (CNT > 0 for
  inner/semi, CNT == 0 for anti), one gather per row like any dict leaf;
- ``("gather", key)`` virtual value planes: per-key-code build-side
  partials (S/CNT/MIN/MAX as [dict]-sized LUTs) gathered on the device;
- ``("mul", key, src)`` virtual planes: probe value x match count.

Pairs never exist anywhere — not in device memory, not on the host. The
build side (usually a small dimension table) runs through the generic
engine and reduces to the LUTs in O(|R|) host work.

Exactness: every identity above is modular-arithmetic-exact (int64 sums
wrap identically on both paths), and group emission order is preserved —
the joined pair stream is ordered (left row asc, right row asc), so the
first pair of each group belongs to the first selected+matched left row,
which is precisely the fused kernel's first-occurrence machinery with the
match leaf folded into the selection mask.

Reference role: the two-phase aggregation contract of
query/physicalplan/aggregate.go:124 applied to the north-star distributed
join (SURVEY.md §2.8); the build-side reduction plays aggregate.go:718's
per-array partials.
"""

from __future__ import annotations

import numpy as np

from .columnbatch import KIND_DICT, KIND_INT64
from .compiled import (
    CompiledFilterAggregate,
    NotCompilable,
    OP_IN_LUT,
    _FilterLeaf,
    match_plan,
)
from .query import expr as E
from .query.logical import LogicalPlan

_I64_MAX = np.int64(2**63 - 1)
_I64_MIN = np.int64(-(2**63))


# (id(right dict), len, id(left dict), len) -> (right dict, left dict,
# right code -> left code (or -1)). Dictionaries are append-only, so
# (id, len) versions an entry — but ONLY while both objects stay alive:
# the cache therefore holds strong references, or a recycled address with
# an equal length would silently serve a stale mapping.
_R2L_CACHE: dict = {}


def _right_to_left_codes(rdict, ldict) -> np.ndarray:
    key = (id(rdict), len(rdict), id(ldict), len(ldict))
    hit = _R2L_CACHE.get(key)
    if hit is None or hit[0] is not rdict or hit[1] is not ldict:
        if len(_R2L_CACHE) > 256:
            _R2L_CACHE.clear()
        out = np.full(max(len(rdict), 1), -1, dtype=np.int64)
        for code, v in enumerate(rdict.value_array()):
            lc = ldict.lookup(v)
            if lc is not None:
                out[code] = lc
        hit = _R2L_CACHE[key] = (rdict, ldict, out)
    return hit[2]


class CompiledJoinAggregate(CompiledFilterAggregate):
    """``Aggregate(Join(left_scan+filter, right_subplan))`` on the fused
    kernels; see the module docstring for the decomposition. ``virtuals``
    maps pseudo value-column names to their build-side reduction:
    ("cnt", None) | ("rsum", col) | ("rmin", col) | ("rmax", col) |
    ("mul", col)."""

    SPAN = "compiled_join/execute"

    def __init__(
        self,
        spec,
        key: str,
        how: str,
        right_plan,
        virtuals: dict,
        exec_options,
    ):
        super().__init__(
            spec.table,
            spec.group_col,
            spec.aggs,
            spec.filter,
            spec.output_projection,
            ordered=False,  # generic joins always plan HashAggregate
            filter_expr=spec.filter_expr,
        )
        schema = spec.table.schema()
        kdef = schema.column_by_name(key)
        if kdef is None or kdef.layout.type not in ("string", "int64"):
            raise NotCompilable(
                "join fusion needs a dict-coded or int64 key column"
            )
        self._jkey = key
        self._how = how
        self._right_plan = right_plan
        self._opts = exec_options
        self._int_key = kdef.layout.type == "int64"
        if self._int_key and how == "left_outer":
            # left_outer's gatherv planes read the dict codes machinery;
            # the int-key variant is not wired (null-key rows are rare on
            # id joins anyway)
            raise NotCompilable("left_outer int-key joins are generic")
        self._jdict = (
            None
            if self._int_key
            else spec.table.dictionary(key.split(".", 1)[0])
        )
        # The match leaf: lut[key code] gathered like any dict predicate;
        # appended AFTER __init__ so the synthesized pruning expr (built
        # from the user's filter clauses only) never sees it. left_outer
        # keeps EVERY probe row (unmatched rows emit with null build
        # columns), so it has no leaf — and no null-key exemption either
        # (null-key rows survive, so a null-bearing key group column would
        # need the generic engine's null-key group).
        self._match_idx = None
        if how != "left_outer":
            if self._int_key:
                # intlut leaf: lit = (base, bool lut over the range-dense
                # key space), set per execute once the visible parts' key
                # range is known (_virtual_ranges)
                leaf = _FilterLeaf(
                    key, OP_IN_LUT, (0, np.zeros(1, np.bool_)), "intlut"
                )
            else:
                leaf = _FilterLeaf(key, OP_IN_LUT, None, "dict", self._jdict)
            self._match_idx = len(self.filters)
            self.filters.append(leaf)
            self.clauses.append([self._match_idx])
            # Null join keys never survive inner/semi (no match) or anti
            # (query/join.py drops them: ``lvalid & (mc == 0)``), and the
            # selection mask already excludes them — so a null-bearing key
            # column may serve as a group key (base class gate exception).
            self._null_ok_group_cols = frozenset(
                g for g in self.group_cols if g == key
            )
        for pseudo, v in virtuals.items():
            plan = self.value_plans[pseudo]
            if self._int_key:
                # base filled per execute (_virtual_ranges) from the
                # visible parts' key range
                plan.source = (
                    ("mul_i", key, 0, v[1])
                    if v[0] == "mul"
                    else ("gather_i", key, 0)
                )
            elif v[0] == "mul":
                plan.source = ("mul", key, v[1])
            elif v[0] == "mulv":
                plan.source = ("mulv", key, v[1])
            elif how == "left_outer":
                # null-key rows contribute 1 to the row count, 0 to value
                # partials (their build columns are null -> zero slots)
                else_v = 1 if v[0] == "cnt1" else 0
                plan.source = (f"gatherv{else_v}", key)
            else:
                plan.source = ("gather", key)
            plan._jkind = v
        self._cnt: np.ndarray | None = None
        if exec_options is not None:
            self.allocator = exec_options.allocator

    # ------------------------------------------------------------------
    # Build side -> LUTs

    def _prepare_right(self) -> None:
        from .query.physical import build_physical, unify_concat

        out: list = []
        build_physical(self._right_plan, self._opts).execute(out.append)
        right = unify_concat(out) if out else None

        if self._int_key:
            self._right_batch = right
            self._cnt = np.zeros(1, dtype=np.int64)  # rebuilt per parts
            self._lut_cache = {}
            return

        L = max(len(self._jdict), 1)
        cnt = np.zeros(L, dtype=np.int64)
        rc = np.zeros(0, dtype=np.int64)
        sel = np.zeros(0, dtype=np.bool_)
        if right is not None and right.num_rows:
            kc = right.column(self._jkey)
            if kc is not None:
                if kc.kind != KIND_DICT:
                    raise NotCompilable(
                        "join fusion needs dict keys on both sides"
                    )
                sel = kc.validity.copy()
                rd = kc.dictionary
                if rd is self._jdict:
                    rc = kc.values.astype(np.int64)
                elif rd is not None and len(rd):
                    r2l = _right_to_left_codes(rd, self._jdict)
                    rc = r2l[
                        np.clip(kc.values.astype(np.int64), 0, len(r2l) - 1)
                    ]
                    sel &= rc >= 0
                else:
                    sel[:] = False
                rc = np.clip(rc, 0, L - 1)
            np.add.at(cnt, rc[sel], 1)
        self._cnt = cnt
        self._build_value_luts(rc, sel, right, L, cnt)
        if self._match_idx is not None:
            # Match mask for the leaf (content changes per execute; the
            # device LUT cache keys on the array identity).
            self.filters[self._match_idx].lit = (
                (cnt == 0) if self._how == "anti" else (cnt > 0)
            )
        self._lut_cache = {}

    def _build_value_luts(self, rc, sel, right, L, cnt) -> None:
        for plan in self.value_plans.values():
            if plan.source is None:
                continue
            kind, col = plan._jkind
            if kind == "cnt":
                plan.lut = cnt
                continue
            if kind == "cnt1":
                plan.lut = np.maximum(cnt, 1)  # left_outer row multiplier
                continue
            if kind == "mul":
                plan.lut = cnt  # device multiplies probe values by it
                continue
            if kind == "mulv":
                plan.lut = np.maximum(cnt, 1)
                continue
            # Build-side value reductions. A right column the build output
            # lacks behaves as all-null (the generic engine aggregates an
            # all-null int64 column: sums 0, min/max over zero slots) —
            # LUT contents mirror that with zero-filled values.
            w0 = np.zeros(0, dtype=np.int64)
            if right is not None and right.num_rows:
                wc = right.column(col)
                if (
                    wc is None
                    and col.endswith("_right")
                    and self.table.schema().column_by_name(col[:-6])
                    is not None
                ):
                    # The joined batch renames build columns that collide
                    # with probe names (query/join.py join_batches ``name +
                    # "_right"``); an agg on the renamed name reads the
                    # build side's original column.
                    wc = right.column(col[:-6])
                if wc is not None:
                    if wc.kind != KIND_INT64:
                        raise NotCompilable(
                            "join fusion aggregates int64 build columns"
                        )
                    # Null slots participate as zero — exactly the joined
                    # batch's re-zeroed null slots (query/join.py
                    # join_batches) fed to the generic kernels' raw-buffer
                    # reductions.
                    w0 = np.where(wc.validity, wc.values, np.int64(0))
                else:
                    w0 = np.zeros(right.num_rows, dtype=np.int64)
            if kind == "rsum":
                lut = np.zeros(L, dtype=np.int64)
                if len(w0):
                    np.add.at(lut, rc[sel], w0[sel])
            elif kind == "rmin":
                lut = np.full(L, _I64_MAX, dtype=np.int64)
                if len(w0):
                    np.minimum.at(lut, rc[sel], w0[sel])
            else:  # rmax
                lut = np.full(L, _I64_MIN, dtype=np.int64)
                if len(w0):
                    np.maximum.at(lut, rc[sel], w0[sel])
            if self._how == "left_outer":
                # unmatched (cnt==0) codes ARE reachable: their joined rows
                # carry null build values = zero slots in the generic
                # kernels
                lut = np.where(cnt > 0, lut, 0)
            plan.lut = lut

    # ------------------------------------------------------------------
    # Compiled-tier hooks

    _INT_KEY_MAX_SPAN = 1 << 21  # LUT slots (16 MB int64) per value plan

    def _prepare_int_key(self, parts) -> None:
        """Int-key joins: the code space is the RANGE-DENSE span of the
        visible probe parts' key values ((v - base) covers every probe
        slot including zero-filled nulls, so no in-range mask is needed);
        build rows map by subtraction, out-of-span rows can match nothing.
        Runs per execute once the pruned part set is known."""
        kmin = kmax = None
        for p in parts:
            r = p.raw_range(self._jkey)
            if r is None:
                raise NotCompilable(f"{self._jkey} lacks a zone range")
            kmin = r[0] if kmin is None else min(kmin, r[0])
            kmax = r[1] if kmax is None else max(kmax, r[1])
        if kmin is None:
            kmin, kmax = 0, 0
        L = int(kmax - kmin + 1)
        if L > self._INT_KEY_MAX_SPAN:
            raise NotCompilable(
                f"int join-key span {L} exceeds the LUT ceiling"
            )
        right = self._right_batch
        cnt = np.zeros(L, dtype=np.int64)
        rc = np.zeros(0, dtype=np.int64)
        sel = np.zeros(0, dtype=np.bool_)
        if right is not None and right.num_rows:
            kc = right.column(self._jkey)
            if kc is not None:
                if kc.kind != KIND_INT64:
                    raise NotCompilable(
                        "int-key join fusion needs int64 keys on both sides"
                    )
                rk = kc.values.astype(np.int64)
                sel = kc.validity & (rk >= kmin) & (rk <= kmax)
                rc = np.clip(rk - kmin, 0, L - 1)
            np.add.at(cnt, rc[sel], 1)
        self._cnt = cnt
        self._build_value_luts(rc, sel, right, L, cnt)
        if self._match_idx is not None:
            self.filters[self._match_idx].lit = (
                int(kmin),
                (cnt == 0) if self._how == "anti" else (cnt > 0),
            )
        # fill the per-execute base into the virtual sources
        for plan in self.value_plans.values():
            if plan.source is None:
                continue
            if plan.source[0] == "gather_i":
                plan.source = ("gather_i", self._jkey, int(kmin))
            elif plan.source[0] == "mul_i":
                plan.source = (
                    "mul_i", self._jkey, int(kmin), plan.source[3]
                )

    def _virtual_ranges(self, parts, ranges) -> None:
        if self._int_key:
            self._prepare_int_key(parts)
        present = self._cnt > 0
        cmax = int(self._cnt.max()) if len(self._cnt) else 0
        for plan in self.value_plans.values():
            if plan.source is None:
                continue
            if plan.source[0].startswith("gatherv"):
                # left_outer: EVERY lut slot is reachable (no match
                # filter), plus the null-key else value; the bias must
                # stay 0 (the else branch bypasses the shift), so
                # negative partials fall back to the generic engine.
                else_v = int(plan.source[0][-1])
                vmin = int(min(plan.lut.min(), else_v)) if len(plan.lut) else 0
                vmax = int(max(plan.lut.max(), else_v)) if len(plan.lut) else 0
                if vmin < 0:
                    raise NotCompilable(
                        "left_outer fusion needs non-negative partials"
                    )
                ranges[plan.column] = (0, vmax)
                continue
            if plan.source[0] in ("gather", "gather_i"):
                if present.any():
                    lut = plan.lut[present]
                    ranges[plan.column] = (int(lut.min()), int(lut.max()))
                continue
            # ("mul"/"mulv", key, src): candidate bounds of v*c over the
            # corner products of [vmin, vmax] x [lo_c, hi_c] (bilinear =>
            # extremes at corners; exact in Python ints, the 59-bit gate
            # rejects overwide spans downstream). mulv multipliers are in
            # [1, max(cnt,1)] — null-key rows multiply by 1.
            src = (
                plan.source[3]
                if plan.source[0] == "mul_i"
                else plan.source[2]
            )
            lo = hi = None
            for p in parts:
                c = p.batch.column(src)
                if c is None:
                    raise NotCompilable(f"part lacks {src}")
                if c.kind != KIND_INT64:
                    raise NotCompilable("join fusion sums int64 probe columns")
                r = p.raw_range(src)
                if r is None:
                    continue
                lo = r[0] if lo is None else min(lo, r[0])
                hi = r[1] if hi is None else max(hi, r[1])
            if lo is None:
                continue
            if plan.source[0] == "mulv":
                cmax1 = max(cmax, 1)
                cands = (lo, hi, lo * cmax1, hi * cmax1)
            else:
                cands = (0, lo * cmax, hi * cmax)
            ranges[plan.column] = (min(cands), max(cands))

    def _fused_args(self, sp, plans) -> list:
        for plan in plans:
            if plan.source is None:
                continue
            kind0 = plan.source[0]
            if kind0 in ("mul", "mulv", "mul_i"):
                plan.lut_dev = self._put(plan.lut.astype(np.int64))
                continue
            if kind0.startswith("gatherv"):
                # bias is pinned to 0 (_virtual_ranges reports vmin=0);
                # absent codes were folded at build time
                assert plan.bias == 0, plan.bias
                dt = np.int64 if plan.wide else np.int32
                plan.lut_dev = self._put(plan.lut.astype(dt))
                continue
            # Bias-shifted LUT; absent codes (never selected thanks to the
            # match leaf / zero count) hold 0 so every gathered plane value
            # sits in [0, span] for the digit kernels.
            shifted = np.where(self._cnt > 0, plan.lut - plan.bias, 0)
            dt = np.int64 if plan.wide else np.int32
            plan.lut_dev = self._put(shifted.astype(dt))
        return super()._fused_args(sp, plans)

    def _filter_parts(self, parts) -> list:
        parts = super()._filter_parts(parts)
        if self._how in ("anti", "left_outer") or self._int_key:
            return parts
        # Build-side pruning: a part none of whose PRESENT key codes match
        # contributes no joined row (code_presence covers valid slots only;
        # null keys never match) — the in-memory analogue of the
        # reference's dictionary-page pruning, binaryscalarexpr.go:104.
        lut = self.filters[self._match_idx].lit
        out = []
        metrics = getattr(self.table, "metrics", None)
        for p in parts:
            cp = p.code_presence(self._jkey)
            if cp is not None and (
                len(cp) == 0
                or not lut[np.clip(cp, 0, len(lut) - 1)].any()
            ):
                if metrics is not None:
                    metrics.parts_pruned.inc()
                continue
            out.append(p)
        return out

    def _execute(self):
        self._prepare_right()
        return super()._execute()


# ---------------------------------------------------------------------------
# Planner lowering


def lower_plan_join_agg(plan, exec_options=None) -> CompiledJoinAggregate:
    """Pattern-match an *optimized* plan of shape
    ``[Projection] <- Aggregation <- Join <- left chain`` onto the fused
    groupjoin decomposition. The left chain + aggregation reuse
    compiled.match_plan against a synthetic plan (same filter CNF,
    pre-projection and avg-rewrite handling); the aggs are then classified
    by side and rewritten onto virtual value planes."""
    node = plan
    proj = None
    if (
        node is not None
        and node.projection is not None
        and node.aggregation is None
    ):
        proj = node
        node = node.input
    if node is None or node.aggregation is None:
        raise NotCompilable("root is not an aggregation")
    agg_node = node
    jnode = node.input
    # Filters between the aggregation and the join: a predicate over
    # probe-side columns commutes with inner/semi/anti equi-joins (joined
    # rows carry the probe columns unchanged; output rows of semi/anti ARE
    # probe rows), so it lowers as a probe-side filter. Column membership
    # is validated against the probe schema below once the scan is known.
    above_filters: list = []
    while jnode is not None and jnode.filter is not None:
        above_filters.append(jnode.filter.expr)
        jnode = jnode.input
    if jnode is None or jnode.join is None:
        raise NotCompilable("no join below the aggregation")
    join = jnode.join
    if join.how not in ("inner", "left_outer", "semi", "anti"):
        raise NotCompilable(f"join fusion: mode {join.how} is generic")
    if len(join.on) != 1:
        raise NotCompilable("join fusion: single-key joins only")
    key = join.on[0]

    # Synthetic plan: the aggregation applied directly to the left chain —
    # match_plan validates the scan/filter/projection shape and flattens
    # the CNF exactly as the non-join compiled tier does. ordered is forced
    # False (exec_options withheld): stream order never survives a join, so
    # the generic planner always picks HashAggregate here.
    from .query.logical import Filter as _LFilter

    chain = jnode.input
    for fe in reversed(above_filters):
        chain = LogicalPlan(chain, filter=_LFilter(fe))
    synth = LogicalPlan(chain, aggregation=agg_node.aggregation)
    if proj is not None:
        synth = LogicalPlan(synth, projection=proj.projection)
    spec = match_plan(synth, None)

    if above_filters:
        # The commute is only valid for probe-side predicates: every
        # referenced column must resolve on the probe schema (a build-side
        # name would read the joined batch's build values).
        schema0 = spec.table.schema()
        for fe in above_filters:
            for c in fe.columns_used():
                if (
                    type(c) is not E.Column
                    or schema0.column_by_name(c.column_name) is None
                ):
                    raise NotCompilable(
                        "post-join filter references a build-side column"
                    )

    if join.how in ("semi", "anti"):
        # The joined stream IS the filtered left stream (one row per
        # surviving left row): plain aggs + the match/anti leaf. Exotic
        # references (e.g. build-side columns, which the generic engine
        # would see as all-null) fall back via the part-lacks checks.
        return CompiledJoinAggregate(
            spec, key, join.how, join.right, {}, exec_options
        )

    table = spec.table
    schema = table.schema()
    lo = join.how == "left_outer"
    virtuals: dict = {}
    rewritten: list = []
    for func, col, name in spec.aggs:
        if func == E.AGG_COUNT:
            # count over joined rows (nulls included, aggregate.go:934):
            # inner = sum of match counts; left_outer = max(cnt,1) for
            # valid keys and 1 for null-key rows (each emits one row).
            virtuals.setdefault("#jcnt", ("cnt1" if lo else "cnt", None))
            rewritten.append((E.AGG_SUM, "#jcnt", name))
            continue
        if schema.column_by_name(col) is not None:
            # Probe-side value: min/max ignore pair multiplicity (plain
            # plane); sums multiply by the row multiplier.
            if func == E.AGG_SUM:
                pseudo = f"#jl:{col}"
                virtuals.setdefault(pseudo, ("mulv" if lo else "mul", col))
                rewritten.append((E.AGG_SUM, pseudo, name))
            else:
                rewritten.append((func, col, name))
            continue
        # Build-side value: per-key-code reduction gathered by probe codes.
        # left_outer: unmatched/null-key rows carry NULL build values,
        # which the generic kernels see as zero slots — the LUT folds
        # cnt==0 codes to 0 and null-key rows take the else=0 branch.
        if func == E.AGG_SUM:
            pseudo, kind = f"#jr:{col}", "rsum"
        elif func == E.AGG_MIN:
            pseudo, kind = f"#jrmin:{col}", "rmin"
        else:
            pseudo, kind = f"#jrmax:{col}", "rmax"
        virtuals.setdefault(pseudo, (kind, col))
        rewritten.append((func, pseudo, name))
    spec.aggs = rewritten
    return CompiledJoinAggregate(
        spec, key, join.how, join.right, virtuals, exec_options
    )
