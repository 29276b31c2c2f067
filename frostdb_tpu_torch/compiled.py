"""Compiled serving queries: filter + group-aggregate lowered onto the
hand-written CUDA kernels (ops/agg_kernels.py) over a table's device-cached
parts.

This is the serving path for the engine's hot query shape (the reference's
Merge/Range queries, bench_test.go:299): the generic operator pipeline
(query/physical.py) is exact and fully general; this layer applies when the
planner can PROVE the fast pattern:

- group keys are table-global dictionary codes (or int64 / window / bool
  keys) with a combined code space <= 2048 (the kernels' shared-memory
  per-code table),
- aggregations are sum/count/min/max over any number of value columns;
  int64 columns are shifted by the global raw minimum on device and
  reconstructed exactly as ``kernel_sum + bias * count`` (the shift is
  order-preserving, so min/max just add the bias back). Shifted spans up
  to 59 bits split into two int32 planes (lo 28 bits / hi 31 bits) summed
  by two kernel passes — nanosecond-timestamp sums stay on the fast path.
  float64 columns ride the integer path when every visible value is
  integral and the cumulative magnitude bound stays within 2^53 (both the
  float and integer sums are then exact and equal),
- min/max additionally require the shifted span to fit one int32 plane,
- the filter is a CNF of ``col <op> literal`` leaves: int64 columns compare
  at full 64-bit width (the compare feeds the kernel's selection plane, so
  filter columns have no 32-bit envelope); dict/string columns evaluate
  ==/!=/=~/!~/contains/ordering through a boolean LUT over the table-global
  dictionary (one gather per row — the reference's per-dictionary-page
  predicate evaluation, binaryscalarexpr.go:104) plus ==/!= against null
  via validity. Range/band conjunctions and a single int ==/!= are
  evaluated inside the kernel (_fastcmp_sig). Parts a leaf or zone map
  proves empty are skipped before any device work (lsm.prune_part; missing
  dynamic columns resolve statically to the generic engine's
  missing-column semantics),
- no null group keys (those fall back to the generic engine, which emits
  the null-key group).

The engine integrates this automatically: ``lower_plan`` pattern-matches an
optimized logical plan and ``LocalQueryBuilder.execute`` falls back to the
generic operator pipeline on ``NotCompilable``.

Results are EXACTLY the generic engine's, including group emission order:
the engine emits groups by first occurrence among *selected* (post-filter)
rows of the concatenated part stream, and the kernels return each code's
exact first selected row.

Parts stay device-resident between queries (lsm.Part.device() caches the
upload), and their planes concatenate once into a cached "superpart"; each
query runs one fused pass set over it and copies one int64 result blob to
the host. On a CPU table the same program runs the kernels' plain versions,
so results are identical on both devices.

Not ported here: the join fusion (compiled_join.py's gather/mul value
planes, which come with the join slice) and the per-part fallback.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from .query import expr as E
from .query.physeval import missing_column_all_true

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1


class NotCompilable(Exception):
    """The query does not match the compiled fast pattern; callers fall back
    to the generic engine."""


@dataclass
class _AggSpec:
    func: str  # "sum" | "count" | "min" | "max"
    column: str
    result_name: str


@dataclass
class _FilterLeaf:
    """One conjunct of the compiled filter (the plan's AND tree flattens
    into a list; each leaf multiplies into the kernel's selection mask).

    kind "int":  an int64-column comparison fused as int32 compares.
    kind "dict": a string predicate on a dict-coded column, reduced to a
    boolean LUT over the table-global dictionary values (the reference
    evaluates string predicates once per parquet dictionary page,
    binaryscalarexpr.go:104) and applied as one gather per row.
    """

    column: str
    op: str
    lit: object
    kind: str  # "int" | "dict"
    dictionary: object = None  # table-global dictionary for "dict" leaves


def _missing_leaf_all_true(leaf: _FilterLeaf) -> bool:
    """Missing-column semantics for one filter leaf via the shared helper
    (physeval.missing_column_all_true — the single source of truth across
    the generic/pruning/compiled paths). True means the leaf matches every
    row of a part lacking the column; False means it matches none (the part
    is skipped). An invalid regex literal falls back to the generic engine
    (which may never evaluate it thanks to AND short-circuiting,
    filter.go:174) instead of crashing the compiled path."""
    import re

    try:
        return missing_column_all_true(leaf.op, leaf.lit)
    except re.error:
        raise NotCompilable("invalid regex literal (generic engine path)")


_DICT_FILTER_OPS = (
    E.OP_EQ,
    E.OP_NOT_EQ,
    E.OP_REGEX_MATCH,
    E.OP_REGEX_NOT_MATCH,
    E.OP_CONTAINS,
    E.OP_NOT_CONTAINS,
    E.OP_LT,
    E.OP_LT_EQ,
    E.OP_GT,
    E.OP_GT_EQ,
)


@dataclass
class _GroupCol:
    """One group-key column's code plan: the (possibly remapped) per-column
    code space that multiplies into the combined dense key.

    kind "dict": a dict-coded string column; codes are (possibly compact-
    remapped) table-global dictionary codes.
    kind "int": an int64 column windowed by ``window`` (plain int64 group
    keys are the window=1 case; ``second(timestamp)`` is window=1000*s —
    the reference's DurationExpr, expr.go:1072). The per-column code is the
    absolute window index ``value // window`` shifted by ``base`` (the
    minimum window index over the visible parts, clamped by same-column
    filter leaves), so the code space is range-dense: k = max_win - base + 1.
    """

    name: str
    dictionary: object
    remap: Optional[np.ndarray] = None  # family code -> compact, or None
    inv: Optional[np.ndarray] = None  # compact -> family code
    k: int = 0  # per-column code count (len(inv) or len(dictionary))
    kind: str = "dict"  # "dict" | "int" | "bool"
    window: int = 1  # int kind: window width in the column's units
    base: int = 0  # int kind: minimum window index (code 0)
    # int kind, projection-computed keys: the emitted column name (the
    # ``(col / k) * k as alias`` pre-projection binding,
    # reference project.go:405 binaryExprProjection) and whether the
    # division is Go-TRUNCATING (requires a provably-nonnegative range:
    # floor == trunc only there — gated per execute in _int_group_plan).
    out: Optional[str] = None
    trunc: bool = False
    # bool kind: the comparison leaf whose mask IS the 2-code key (the
    # generic boolExprProjection emits dense true/false with no nulls,
    # project.go:405 — so bool keys never carry null-key semantics).
    leaf: object = None


@dataclass
class _ValuePlan:
    """Per-value-column kernel plan computed from part metadata."""

    column: str
    bias: int = 0
    num_digits: int = 2  # digits for the single-plane case / the lo plane
    wide: bool = False  # two int32 planes: lo 28 bits, hi = span >> 28
    hi_digits: int = 0
    is_float: bool = False  # integral float64 riding the int path
    need_sum: bool = False
    need_minmax: bool = False
    # Non-integral float64 sums: a floatsum.FloatSumPlan — the column
    # decomposes on device into 3 base-2^28 digit planes + a biased top
    # plane, summed exactly and recombined host-side with ONE rounding
    # (VERDICT r3 item 5; the reference accumulates sequentially,
    # aggregate.go:778).
    fexact: object = None
    fexact_top_digits: int = 1
    # Non-integral float64 min/max: order via the monotone int64 bit
    # transform (k = bits ^ ((bits >> 63) & 0x7FF..F)) — served by the
    # int64-native dense/mesh tiers (not ported); the compiled tier declines.
    fmm: bool = False
    # unique(col): needs min/max planes (reused) + a per-group count of
    # VALID value slots; valid = (min == max) & (validcnt == groupcount)
    # (kernels.segment_agg AGG_UNIQUE semantics / aggregate.go:712).
    need_unique: bool = False
    # and(col) over a bool column: per-group min of (valid ? v : 1)
    # (nulls are true-neutral, aggregate.go:798 AndAgg).
    need_and: bool = False


# lo-plane width for wide (two-plane) sums: 28 bits = 4 base-128 digits.
_LO_BITS = 28
_LO_MASK = (1 << _LO_BITS) - 1
_EXACT_F64 = 1 << 53


def _digits_for(max_value: int) -> int:
    d = 1
    lim = 127
    while lim < max_value:
        lim = lim * 128 + 127
        d += 1
    if d > 7:
        raise NotCompilable("value range needs >7 base-128 digits")
    return d


class CompiledFilterAggregate:
    """Compiled ``select <aggs> where <conjunctive filter> group by
    <dict col>`` over one table. ``filter`` is one ``(col, op, lit)``
    comparison or a list of them (an AND conjunction); int64 columns
    compare against int literals, dict/string columns accept
    ==/!=/=~/!~/contains/ordering against string literals (and ==/!=
    against null)."""

    # Dense group-code space ceiling: the kernels' per-block shared-memory
    # table (int64 sum and count, int32 first row per code: 40 KB).
    MAX_CODES = 2048
    # Group-key columns per query; the combined code space is gated by
    # MAX_CODES regardless.
    MAX_GROUP_COLS = 4

    def __init__(
        self,
        table,
        group_col: str,
        aggs: Sequence[tuple],  # (func, column[, result_name])
        filter=None,  # (col, op, lit) | [(col, op, lit), ...] | None
        output_projection: Optional[Sequence[tuple]] = None,
        ordered: bool = False,
        filter_expr=None,  # original expr tree (part pruning); synthesized
        # from the leaves when absent
    ):
        # ordered: emit groups in key order (string-value asc) instead of
        # first-occurrence order — set exactly when the generic planner
        # would pick OrderedAggregate (physical._should_plan_ordered), so
        # results stay byte-identical to the operator DAG either way.
        self.ordered = ordered
        # output_projection: post-aggregation output spec (the avg rewrite's
        # ``sum(x)/count(x) as avg(x)`` projection, builder.go:152-238):
        #   ("group",)                     the group column
        #   ("col", out_name, src_name)    an agg result, possibly renamed
        #   ("div", out_name, sum, count)  truncating int division on the
        #                                  [K]-sized host partials
        self.output_projection = (
            list(output_projection) if output_projection is not None else None
        )
        self.table = table
        # Every plane and kernel of this query runs on the table's device:
        # the CUDA kernels for a CUDA table, their plain versions on the CPU.
        self.device = table.device
        # 1..MAX_GROUP_COLS group columns, each either dict-coded (string),
        # int64, or a comparison ("bool") key; int64 columns are
        # (optionally windowed — DurationExpr / second(), expr.go:1072,
        # visitor.go:332). Specs: a plain name (kind decided by schema
        # type) or ("int", name, window). Two columns combine into one
        # dense pair-code space (per-column code counts multiplied) so
        # (second(timestamp), labels.x) group-bys stay fast.
        specs = (
            [group_col]
            if isinstance(group_col, (str, tuple))
            else list(group_col)
        )
        if not 1 <= len(specs) <= self.MAX_GROUP_COLS:
            raise NotCompilable(
                f"compiled path groups by 1..{self.MAX_GROUP_COLS} columns"
            )

        schema = table.schema()
        self.group_cols: list[str] = []  # column names (both kinds)
        self._gplan = []
        for spec in specs:
            if isinstance(spec, tuple) and spec[0] == "bool":
                # ("bool", col, op, lit, out_name): a comparison key.
                _k, bcol, bop, blit, out_name = spec
                if out_name in self.group_cols:
                    raise NotCompilable(f"duplicate group column {out_name}")
                leaf = self._make_leaf(schema, bcol, bop, blit)
                self._gplan.append(
                    _GroupCol(out_name, None, kind="bool", k=2, leaf=leaf)
                )
                self.group_cols.append(out_name)
                continue
            out_name = None
            trunc = False
            if isinstance(spec, tuple):
                _kind, gc, window, *rest = spec
                if rest:
                    out_name = rest[0]
                    trunc = bool(rest[1]) if len(rest) > 1 else False
            else:
                gc, window = spec, None
            if (out_name or gc) in self.group_cols:
                # Degenerate duplicate key (e.g. timestamp AND
                # second(timestamp)) — generic engine semantics apply.
                raise NotCompilable(f"duplicate group column {gc}")
            gdef = schema.column_by_name(gc)
            if gdef is None:
                raise NotCompilable(f"group column {gc} not in schema")
            if gdef.layout.type == "string":
                if window is not None:
                    raise NotCompilable("window over a non-int64 column")
                fam = gc.split(".", 1)[0]
                d = table.dictionary(fam)
                # NB: no code-space gate here — the effective code count is
                # a property of the visible parts, decided per execute() by
                # _group_remap (which replaces this direct-code default).
                self._gplan.append(_GroupCol(gc, d, k=max(len(d), 1)))
            elif gdef.layout.type == "int64":
                self._gplan.append(
                    _GroupCol(
                        gc,
                        None,
                        kind="int",
                        window=max(int(window or 1), 1),
                        k=1,
                        out=out_name,
                        trunc=trunc,
                    )
                )
            else:
                raise NotCompilable(
                    f"group column {gc} is neither dict-coded nor int64"
                )
            self.group_cols.append(out_name or gc)
        self.group_col = self.group_cols[0]
        self.group_dicts = [g.dictionary for g in self._gplan]
        self.dictionary = next(
            (d for d in self.group_dicts if d is not None), None
        )

        self.aggs = []
        # Distinct value columns in first-use order; each gets its own
        # kernel plan (digits/bias/planes) in _check_parts.
        self.value_plans: dict[str, _ValuePlan] = {}
        for spec in aggs:
            func, col = spec[0], spec[1]
            result_name = spec[2] if len(spec) > 2 else f"{func}({col})"
            if func not in (
                E.AGG_SUM,
                E.AGG_COUNT,
                E.AGG_MIN,
                E.AGG_MAX,
                E.AGG_UNIQUE,
                E.AGG_AND,
            ):
                raise NotCompilable(f"agg {func} not in compiled set")
            if func == E.AGG_AND:
                vdef = schema.column_by_name(col)
                if vdef is not None and vdef.layout.type != "bool":
                    raise NotCompilable("and() aggregates bool columns")
                plan = self.value_plans.setdefault(col, _ValuePlan(col))
                plan.need_and = True
            elif func == E.AGG_UNIQUE:
                vdef = schema.column_by_name(col)
                if vdef is not None and vdef.layout.type != "int64":
                    # float/string unique stays generic (the reference's
                    # uniqueInt64arrays covers int64, aggregate.go:712).
                    raise NotCompilable("unique() compiles int64 columns")
                plan = self.value_plans.setdefault(col, _ValuePlan(col))
                plan.need_unique = True
                plan.need_minmax = True
            elif func != E.AGG_COUNT:
                vdef = schema.column_by_name(col)
                if vdef is not None and vdef.layout.type not in (
                    "int64",
                    "double",
                ):
                    raise NotCompilable("compiled aggs are int/float columns")
                plan = self.value_plans.setdefault(col, _ValuePlan(col))
                plan.is_float = vdef is not None and vdef.layout.type == "double"
                if func == E.AGG_SUM:
                    plan.need_sum = True
                else:
                    plan.need_minmax = True
            self.aggs.append(_AggSpec(func, col, result_name))
        # CNF filter: an AND of OR-clauses (reference filter.go:167-229
        # AndExpr/OrExpr trees). ``filters`` is the flat leaf list (LUT
        # caches key by leaf index); ``clauses`` holds leaf indices per
        # conjunct — a single-leaf clause is the plain comparison case.
        self.filters: list[_FilterLeaf] = []
        self.clauses: list[list[int]] = []
        self.filter_expr = filter_expr
        if filter:
            if isinstance(filter, tuple):
                filter = [filter]
            for clause in filter:
                leaves = [clause] if isinstance(clause, tuple) else list(clause)
                idxs = []
                for fcol, fop, lit in leaves:
                    idxs.append(len(self.filters))
                    self.filters.append(self._make_leaf(schema, fcol, fop, lit))
                self.clauses.append(idxs)
        if self.filter_expr is None and self.clauses:
            # Synthesize the expr tree so direct compile_filter_aggregate
            # callers get the same TrueNegativeFilter part pruning the
            # engine path gets (lsm.prune_part handles OR soundly: prune
            # only when every branch proves empty).
            e = None
            for idxs in self.clauses:
                t = None
                for i in idxs:
                    leaf = self.filters[i]
                    le = E.BinaryExpr(
                        E.Column(leaf.column), leaf.op, E.Literal(leaf.lit)
                    )
                    t = le if t is None else E.BinaryExpr(t, E.OP_OR, le)
                e = t if e is None else E.BinaryExpr(e, E.OP_AND, t)
            self.filter_expr = e

    def _make_leaf(self, schema, fcol, fop, lit) -> _FilterLeaf:
        fdef = schema.column_by_name(fcol)
        if fdef is None:
            raise NotCompilable(f"unknown filter column {fcol}")
        if fdef.layout.type == "string":
            if fop not in _DICT_FILTER_OPS:
                raise NotCompilable(f"filter op {fop} not on string columns")
            if lit is None:
                if fop not in (E.OP_EQ, E.OP_NOT_EQ):
                    raise NotCompilable("null literal needs ==/!=")
            elif not isinstance(lit, str):
                # The generic dict path str()-coerces; keep the
                # compiled envelope to provably-identical shapes.
                raise NotCompilable("string filter literal not str")
            ffam = fcol.split(".", 1)[0]
            return _FilterLeaf(
                fcol, fop, lit, "dict", self.table.dictionary(ffam)
            )
        if fdef.layout.type == "int64":
            if fop not in _COMPARE_FILTER_OPS:
                raise NotCompilable(f"filter op {fop} not comparable")
            if not isinstance(lit, int) or isinstance(lit, bool):
                raise NotCompilable("filter literal is not an int")
            if not (-(2**63) <= lit < 2**63):
                raise NotCompilable("filter literal outside int64 range")
            return _FilterLeaf(fcol, fop, lit, "int")
        raise NotCompilable("compiled filters compare int or dict columns")

    # ------------------------------------------------------------------

    def _check_parts_common(
        self, parts
    ) -> dict[str, tuple[Optional[int], Optional[int]]]:
        """Host-metadata validation over the visible parts, shared by the
        single-chip compiled path and the mesh executor: null-group-key /
        column-kind gating, the float-integral + cumulative-magnitude gate
        (both paths reduce integral float64 columns exactly on the integer
        path; past 2^53 the float64 sum could round while the integer sum
        stays exact, so the paths could disagree with the generic engine),
        and raw (min, max) range collection per value column. All checks
        read cached per-part ranges / validity flags, never full columns
        per query."""
        ranges: dict[str, tuple[Optional[int], Optional[int]]] = {
            c: (None, None) for c in self.value_plans
        }
        float_bounds: dict[str, int] = {}
        float_nonintegral: set = set()
        for plan in self.value_plans.values():
            plan.fexact = None  # re-derived per execute (part sets change)
            plan.fmm = False
        total_rows = 0
        for p in parts:
            total_rows += p.num_rows()
            for gcol in self._gplan:
                if gcol.kind == "bool":
                    # The key is the leaf's mask: missing columns resolve
                    # statically, null inputs yield key False — no null-key
                    # or presence requirements (project.go:405 semantics).
                    f = p.batch.column(gcol.leaf.column)
                    if f is not None:
                        if gcol.leaf.kind == "int":
                            if f.kind != KIND_INT64:
                                raise NotCompilable(
                                    "bool key column kind mismatch"
                                )
                        elif f.kind != KIND_DICT:
                            raise NotCompilable(
                                "bool key column kind mismatch"
                            )
                    continue
                g = p.batch.column(gcol.name)
                if g is None:
                    raise NotCompilable(f"part lacks {gcol.name}")
                if gcol.kind == "int":
                    if g.kind != KIND_INT64:
                        raise NotCompilable(
                            f"group column {gcol.name} kind mismatch"
                        )
                elif g.kind != KIND_DICT:
                    raise NotCompilable(
                        f"group column {gcol.name} kind mismatch"
                    )
                if not p.all_valid(gcol.name):
                    # The generic engine emits a null-key group for these
                    # rows (kernels.group_ids keys on validity); fall back.
                    raise NotCompilable("null group keys (generic engine path)")
            for plan in self.value_plans.values():
                c = p.batch.column(plan.column)
                if c is None:
                    raise NotCompilable(f"part lacks {plan.column}")
                if plan.need_and:
                    if c.kind != "bool":
                        raise NotCompilable("and() aggregates bool columns")
                    continue  # values are 0/1; no range/digit planning
                if plan.need_unique and c.kind != KIND_INT64:
                    raise NotCompilable("unique() compiles int64 columns")
                if c.kind == KIND_INT64:
                    if plan.is_float:
                        raise NotCompilable("mixed int/float value column")
                elif c.kind == "float64":
                    plan.is_float = True
                    if not p.float_integral(plan.column):
                        float_nonintegral.add(plan.column)
                else:
                    raise NotCompilable("compiled aggs are int/float columns")
                if plan.is_float and plan.column in float_nonintegral:
                    continue  # ranges irrelevant on the fexact path
                r = p.raw_range(plan.column)
                if r is not None:
                    # Raw buffer bounds: null slots participate in sums
                    # exactly like the reference's raw-buffer sum
                    # (aggregate.go:763), so they bound the digits too.
                    vmin, vmax = ranges[plan.column]
                    vmin = r[0] if vmin is None else min(vmin, r[0])
                    vmax = r[1] if vmax is None else max(vmax, r[1])
                    ranges[plan.column] = (vmin, vmax)
                    if plan.is_float:
                        float_bounds[plan.column] = float_bounds.get(
                            plan.column, 0
                        ) + p.num_rows() * max(abs(r[0]), abs(r[1]))
        # Non-integral float64 columns: sums ride the exact-decomposition
        # path (floatsum.py); min/max ordering stays generic for them.
        for plan in self.value_plans.values():
            if plan.column not in float_nonintegral:
                continue
            if plan.need_minmax:
                # The monotone-int64 ordering key (k = bits ^ ((bits >> 63)
                # & 0x7FF..F)) is the SAME transform the generic engine
                # reduces with (physical._float_ord_encode), so IEEE total
                # order — incl. -0.0 < +0.0, inf, and NaN-largest — agrees
                # byte-for-byte on every tier; no gate needed (VERDICT r4
                # item 5).
                plan.fmm = True
            if not plan.need_sum:
                continue
            from .floatsum import make_plan as _fs_make_plan

            fplan = _fs_make_plan(
                [p.float_sum_meta(plan.column) for p in parts], total_rows
            )
            if fplan is None:
                raise NotCompilable(
                    "float values outside the exact-sum gate"
                )
            plan.fexact = fplan
            top_span = max(fplan.top_max - fplan.top_min, 1)
            plan.fexact_top_digits = _digits_for(top_span)
        # Filter-column kind checks run per PART (they had drifted into the
        # float loop above, checking only the last part).
        for p in parts:
            for leaf in self.filters:
                f = p.batch.column(leaf.column)
                if f is None:
                    # Statically resolved per part in _filter_parts:
                    # all-false parts were skipped, all-true leaves are
                    # no-ops on this part.
                    continue
                if leaf.kind == "int":
                    if f.kind != KIND_INT64:
                        raise NotCompilable("filter column kind mismatch")
                elif f.kind != KIND_DICT:
                    raise NotCompilable("filter column kind mismatch")
        for col, bound in float_bounds.items():
            if col in float_nonintegral:
                continue  # served by the exact-decomposition path
            if bound >= _EXACT_F64:
                # Past this bound a float64 sum can round while the int64
                # sum stays exact — the paths could disagree; generic.
                raise NotCompilable("float sum magnitude bound exceeds 2^53")
        # Integral float columns ride the int path, which collapses -0.0
        # to +0.0 — but the generic total order emits -0.0 as the minimum
        # of the (-0.0, +0.0) pair. Escalate -0.0-bearing columns' min/max
        # to the ordering-key path (dense/mesh serve it; found by a
        # round-5 parity probe, the round-4 lesson generalized).
        for plan in self.value_plans.values():
            if (
                plan.is_float
                and plan.need_minmax
                and not plan.fmm
                and any(
                    p.float_minmax_meta(plan.column)[1] for p in parts
                )
            ):
                plan.fmm = True
        return ranges

    # Memory limiting (reference query/memory.go:17 LimitAllocator): the
    # fast tiers account their per-query transient — the host-fetched
    # result blob — instead of forfeiting to the generic DAG (VERDICT r4
    # weak #3). Set by the lower_plan* entry points from ExecOptions.
    allocator = None

    def _check_parts(self, parts) -> None:
        """Common validation plus the kernel digit plan per value column.

        ``bias`` is the global raw minimum: the kernel sums ``v - bias``
        (always non-negative, often far fewer base-128 digits — e.g.
        nanosecond timestamps) and the exact sum is reconstructed as
        ``kernel_sum + bias * count``. Shifted spans past one int32 plane
        split into a 28-bit lo plane and a hi plane (two kernel passes,
        ``sum = lo + (hi << 28) + bias*count``), admitting spans up to 59
        bits."""
        ranges = self._check_parts_common(parts)
        for plan in self.value_plans.values():
            if plan.fmm:
                raise NotCompilable(
                    "float min/max needs the int64-native dense tier"
                )
            if plan.fexact is not None:
                continue  # exact-decomposition planes plan themselves
            vmin, vmax = ranges[plan.column]
            plan.bias = 0
            plan.wide = False
            plan.num_digits = 2
            if vmin is None:
                continue
            # Bias only when needed (negative values, or values past the
            # kernel's int32 input range); zero-bias keeps sums independent
            # of counts for columns that are already small non-negative ints.
            if vmin < 0 or vmax > _INT32_MAX:
                plan.bias = vmin
            span = vmax - plan.bias
            if span > _INT32_MAX:
                # The hi plane must stay strictly below the int32 sentinel
                # (the wide min/max's lexicographic combine relies on
                # _INT32_MAX/_INT32_MIN being unreachable hi values).
                if span >> _LO_BITS >= _INT32_MAX:
                    raise NotCompilable("value span exceeds 59 bits")
                plan.wide = True
                plan.num_digits = _digits_for(_LO_MASK)
                plan.hi_digits = _digits_for(max(span >> _LO_BITS, 1))
            else:
                plan.num_digits = _digits_for(max(span, 1))

    # Family dictionaries are append-only and shared across ALL columns of
    # the family (e.g. every ``labels.*`` column), so their size says
    # nothing about one group column's code count. Past this threshold the
    # group column's codes are remapped to a compact per-column space built
    # from the parts' code-presence sets — the fix for the "2048-dictionary
    # serving cliff" (VERDICT r2 weak 3): forty node names in a 5000-value
    # label family group-by on the compiled path again.
    REMAP_THRESHOLD = 2048

    def _col_presence(self, parts, name: str) -> np.ndarray:
        pres: Optional[np.ndarray] = None
        for p in parts:
            cp = p.code_presence(name)
            if cp is None:
                raise NotCompilable(f"{name} lacks code presence")
            pres = cp if pres is None else np.union1d(pres, cp)
        return pres if pres is not None else np.zeros(0, dtype=np.int64)

    def _int_group_plan(self, parts, gcol0: _GroupCol) -> _GroupCol:
        """Range-dense code plan for an int64 (possibly windowed) group
        column: codes are ``value // window - base`` where [base, max_win]
        is the window-index range over the visible parts' zone maps,
        CLAMPED by same-column int filter leaves (the Parca Range shape
        filters the timestamp to a narrow interval of a long-lived table —
        without the clamp the raw range would blow the code-space gate).
        Rows outside the clamp are filtered out before accumulation, so
        their (clipped) codes never land. Truncating-division keys
        (projection-computed ``(col / k) * k``) additionally require the
        effective range to be nonnegative: Go division truncates toward
        zero while the window code floor-divides — they agree exactly on
        [0, inf) (the filter clamp counts: clamped-away negatives never
        accumulate)."""
        gc, window = gcol0.name, gcol0.window
        gmin = gmax = None
        for p in parts:
            r = p.raw_range(gc)
            if r is None:
                raise NotCompilable(f"{gc} lacks a zone range")
            gmin = r[0] if gmin is None else min(gmin, r[0])
            gmax = r[1] if gmax is None else max(gmax, r[1])
        if gmin is None:
            return _GroupCol(
                gc, None, kind="int", window=window, k=1,
                out=gcol0.out, trunc=gcol0.trunc,
            )
        lo_w, hi_w = gmin // window, gmax // window
        for idxs in self.clauses:
            if len(idxs) != 1:
                # A leaf inside an OR clause does not constrain all rows.
                continue
            leaf = self.filters[idxs[0]]
            if leaf.kind != "int" or leaf.column != gc:
                continue
            lit = leaf.lit
            if leaf.op == ">=":
                lo_w = max(lo_w, lit // window)
            elif leaf.op == ">":
                lo_w = max(lo_w, (lit + 1) // window)
            elif leaf.op == "<=":
                hi_w = min(hi_w, lit // window)
            elif leaf.op == "<":
                hi_w = min(hi_w, (lit - 1) // window)
            elif leaf.op == "==":
                lo_w = max(lo_w, lit // window)
                hi_w = min(hi_w, lit // window)
        k = max(int(hi_w - lo_w + 1), 1)
        # Pad to a power of two: k is part of the fused-program cache key
        # (the [K] partial shapes), and the filter clamp moves with
        # per-query literals — padding keeps cached programs reused across
        # a sliding time range. Codes >= the actual range never
        # accumulate, so the pad slots stay zero and are never emitted.
        k = 1 << (k - 1).bit_length()
        if gcol0.trunc and lo_w < 0:
            raise NotCompilable(
                "truncating-division key over a negative range"
            )
        return _GroupCol(
            gc, None, kind="int", window=window, base=int(lo_w), k=k,
            out=gcol0.out, trunc=gcol0.trunc,
        )

    def _group_remap(self, parts, max_codes=None) -> tuple[list[_GroupCol], int]:
        """Per-group-column code plans + the combined dense code count.

        A single dict group column uses family codes directly while the
        family dictionary is small; past REMAP_THRESHOLD (and always for
        the multi-column pair space, whose size is the per-column product)
        codes remap through compact per-column LUTs built from the parts'
        code-presence sets. int64/window columns get range-dense plans
        (_int_group_plan). Raises NotCompilable when the combined count
        exceeds MAX_CODES."""
        cols: list[_GroupCol] = []
        n_dict = sum(1 for g in self._gplan if g.kind == "dict")
        for gcol in self._gplan:
            gc, d = gcol.name, gcol.dictionary
            if gcol.kind == "bool":
                cols.append(
                    _GroupCol(gc, None, kind="bool", k=2, leaf=gcol.leaf)
                )
                continue
            if gcol.kind == "int":
                cols.append(self._int_group_plan(parts, gcol))
                continue
            if (
                len(self.group_cols) == 1
                and n_dict == 1
                and len(d) <= self.REMAP_THRESHOLD
            ):
                cols.append(_GroupCol(gc, d, k=max(len(d), 1)))
                continue
            pres = self._col_presence(parts, gc)
            remap = np.zeros(max(len(d), 1), dtype=np.int32)
            remap[pres] = np.arange(len(pres), dtype=np.int32)
            cols.append(
                _GroupCol(
                    gc,
                    d,
                    remap=remap,
                    inv=pres.astype(np.int64),
                    k=max(len(pres), 1),
                )
            )
        num_codes = 1
        for c in cols:
            num_codes *= c.k
        limit = self.MAX_CODES if max_codes is None else max_codes
        if num_codes > limit:
            raise NotCompilable(
                f"group code space {num_codes} > {limit}"
            )
        return cols, num_codes

    def _remap_dev(self, gcol: _GroupCol):
        """Device-resident remap LUT, cached per (dictionary, presence)
        version — presence can grow between queries without the family
        dictionary growing (a new part using existing values)."""
        key = (gcol.name, len(gcol.remap), hash(gcol.inv.tobytes()))
        cache = getattr(self, "_remap_dev_cache", None)
        if cache is None:
            cache = self._remap_dev_cache = {}
        hit = cache.get(gcol.name)
        if hit is not None and hit[0] == key:
            return hit[1]
        dev = self._put(gcol.remap)
        cache[gcol.name] = (key, dev)
        return dev

    def _put(self, arr: np.ndarray):
        """A host constant (LUT) as a tensor on the table's device."""
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _filter_parts(self, parts) -> list:
        """Drop parts that provably contain no selected rows before any
        device work: zone-map / code-presence pruning (lsm.prune_part — the
        reference's TrueNegativeFilter row-group skipping, store.go:243 +
        binaryscalarexpr.go:104) plus parts where a leaf on a missing
        dynamic column statically matches nothing."""
        if not self.filters:
            return list(parts)
        from .lsm import prune_part

        memo: dict = {}
        metrics = getattr(self.table, "metrics", None)
        out = []
        for p in parts:
            skip = self.filter_expr is not None and prune_part(
                p, self.filter_expr, memo
            )
            if not skip:
                # Per-clause static resolution on missing dynamic columns:
                # a missing all-true leaf makes its whole OR clause true
                # for the part; a clause whose leaves are ALL missing and
                # all false selects nothing — the part is skipped.
                for idxs in self.clauses:
                    clause_true = False
                    any_present = False
                    for i in idxs:
                        leaf = self.filters[i]
                        if p.batch.column(leaf.column) is None:
                            if _missing_leaf_all_true(leaf):
                                clause_true = True
                                break
                        else:
                            any_present = True
                    if clause_true:
                        continue
                    if not any_present:
                        skip = True
                        break
            if skip:
                if metrics is not None:
                    metrics.parts_pruned.inc()
                continue
            out.append(p)
        return out

    def _leaf_lut_np(self, idx: int) -> np.ndarray:
        """Boolean LUT over the leaf's table-global dictionary values —
        the exact reduction the generic engine applies per dict column
        (physeval._dict_mask); memoized per query instance. An empty
        dictionary pads to one slot so device gathers stay well-formed
        (no valid row can carry a code then, and the mask ANDs with
        validity, so the pad value matching _dict_mask's empty-LUT
        branches is only for exactness on all-null parts)."""
        from .lsm import _dict_match_lut

        cache = getattr(self, "_lut_cache", None)
        if cache is None:
            cache = self._lut_cache = {}
        leaf = self.filters[idx]
        key = (idx, len(leaf.dictionary))
        lut = cache.get(key)
        if lut is None:
            import re

            try:
                lut = _dict_match_lut(leaf.dictionary, leaf.op, leaf.lit, None)
            except re.error:
                # Invalid regex: the generic engine may complete the query
                # via AND short-circuit without ever compiling it
                # (filter.go:174); preserve that by falling back.
                raise NotCompilable(
                    "invalid regex literal (generic engine path)"
                )
            if lut is None:  # every _DICT_FILTER_OPS op reduces to a LUT
                raise NotCompilable(f"filter op {leaf.op} has no dict LUT")
            if len(lut) == 0:
                lut = np.asarray([leaf.op == E.OP_NOT_EQ], dtype=np.bool_)
            cache[key] = lut
        return lut

    def _leaf_lut_dev(self, idx: int):
        cache = getattr(self, "_lut_dev_cache", None)
        if cache is None:
            cache = self._lut_dev_cache = {}
        leaf = self.filters[idx]
        key = (idx, len(leaf.dictionary))
        lut = cache.get(key)
        if lut is None:
            lut = self._put(self._leaf_lut_np(idx).astype(np.int32))
            cache[key] = lut
        return lut

    # ------------------------------------------------------------------
    # Superpart: the whole part set as one concatenated device layout.
    #
    # Serving tables hold many immutable parts. Since parts are immutable
    # and the dictionaries are table-global, their padded planes concatenate
    # once (cached on the Table keyed by the part identity tuple) and every
    # query runs ONE fused pass over the whole table. Group emission order
    # is preserved exactly: the kernels return each code's exact first
    # selected row in the concatenated stream, which is first occurrence in
    # the part stream (parts occupy disjoint, ordered row ranges).

    _SUPERPART_CACHE_ENTRIES = 4

    def _superpart(self, parts):
        key = tuple(id(p) for p in parts)
        cache = getattr(self.table, "_superpart_cache", None)
        if cache is None:
            cache = {}
            self.table._superpart_cache = cache
        sp = cache.get(key)
        if sp is None:
            sp = {
                "parts": list(parts),  # pin ids
                "planes": {},
            }
            while len(cache) >= self._SUPERPART_CACHE_ENTRIES:
                cache.pop(next(iter(cache)))
            cache[key] = sp
        return sp

    def _sp_plane(self, sp, kind: str, name):
        """Cached concatenated flat plane across the part set (each part
        contributes its padded ``n_pad`` rows). Kinds: rowvalid | codes |
        valid | int64 (column required) and codes_m | valid_m | int64_m |
        has (missing column tolerated: zero planes + has=0)."""
        k = (kind, name)
        out = sp["planes"].get(k)
        if out is not None:
            return out
        arrs = []
        for p in sp["parts"]:
            dev = p.device()
            if kind == "rowvalid":
                arrs.append(dev.row_valid_mask().to(torch.int32))
                continue
            c = dev.column(name)
            if c is None:
                if kind == "has" or kind.endswith("_m"):
                    dtype = torch.int64 if kind.startswith("int64") else torch.int32
                    arrs.append(
                        torch.zeros(dev.n_pad, dtype=dtype, device=dev.device)
                    )
                    continue
                raise NotCompilable(f"part lacks {name}")
            if kind == "has":
                arrs.append(
                    torch.ones(dev.n_pad, dtype=torch.int32, device=dev.device)
                )
            elif kind.startswith("codes"):
                arrs.append(c.data.to(torch.int32))
            elif kind.startswith("valid"):
                arrs.append(c.validity.to(torch.int32))
            else:  # int64 planes
                arrs.append(c.data.to(torch.int64))
        out = torch.cat(arrs)
        sp["planes"][k] = out
        return out

    def _sp_basesel(self, sp, gplan):
        """Cached base selection plane: row-validity AND every group
        column's validity, folded ONCE per (part set, group col set) —
        per-query programs then read one plane instead of 1 + n_group."""
        k = ("basesel", tuple(g.name for g in gplan if g.kind != "bool"))
        out = sp["planes"].get(k)
        if out is None:
            out = self._sp_plane(sp, "rowvalid", None)
            for gcol in gplan:
                if gcol.kind == "bool":
                    continue  # bool keys are dense true/false, never null
                out = out * self._sp_plane(sp, "valid", gcol.name)
            sp["planes"][k] = out
        return out

    def _sp_value_i32(self, sp, column: str, bias: int):
        """Cached pre-shifted int32 value plane for non-wide columns: the
        bias subtract + narrowing cast run once per (part set, bias), not
        per query — halving the kernel pass's value-read bytes."""
        k = ("vi32", column, int(bias))
        out = sp["planes"].get(k)
        if out is None:
            v64 = self._sp_plane(sp, "int64", column)
            out = (v64 - int(bias)).to(torch.int32)
            sp["planes"][k] = out
        return out

    def _sp_i32_m(self, sp, column: str):
        """Cached int32 copy of a filter column whose part-set range fits
        int32 (missing parts zero-filled): comparing in int32 halves both
        read bytes and op count."""
        k = ("i32m", column)
        out = sp["planes"].get(k)
        if out is None:
            out = self._sp_plane(sp, "int64_m", column).to(torch.int32)
            sp["planes"][k] = out
        return out

    def _sp_fplanes(self, sp, column: str, fplan):
        """Cached float-sum digit planes over the superpart: decompose_np
        runs on the host per part and the planes upload once per (part set,
        scale). Digit planes are in [0, 2^28); the top plane is biased by
        -top_min so the digit kernel sees non-negative values."""
        from .floatsum import decompose_np

        key = ("fpl", column, fplan.scale, fplan.top_min)
        out = sp["planes"].get(key)
        if out is None:
            per_plane = [[] for _ in range(4)]
            for p in sp["parts"]:
                dev = p.device()
                c = p.batch.column(column)
                if c is None:
                    raise NotCompilable(f"part lacks {column}")
                planes = decompose_np(c.values, fplan)
                planes[3] = planes[3] - fplan.top_min
                for pi in range(4):
                    full = np.zeros(dev.n_pad, dtype=np.int32)
                    full[: p.batch.num_rows] = planes[pi].astype(np.int32)
                    per_plane[pi].append(self._put(full))
            out = [torch.cat(arrs) for arrs in per_plane]
            sp["planes"][key] = out
        return out

    def _sp_int_range(self, sp, column: str):
        """Part-set (min, max) over a column's raw ranges, cached on the
        superpart; None when no part carries the column."""
        ranges = sp.setdefault("col_ranges", {})
        if column in ranges:
            return ranges[column]
        lo = hi = None
        for p in sp["parts"]:
            r = p.raw_range(column)
            if r is None:
                continue
            lo = r[0] if lo is None else min(lo, r[0])
            hi = r[1] if hi is None else max(hi, r[1])
        out = None if lo is None else (lo, hi)
        ranges[column] = out
        return out

    @staticmethod
    def _emission_order_concat(
        counts_np: np.ndarray, first_np: np.ndarray
    ) -> np.ndarray:
        """Emission order: codes with selected rows, by their exact first
        selected row in the concatenated stream."""
        ks = [int(k) for k in np.nonzero(counts_np > 0)[0]]
        ks.sort(key=lambda k: int(first_np[k]))
        return np.asarray(ks, dtype=np.int64)

    # ------------------------------------------------------------------
    # Fused superpart program: the ENTIRE per-query device computation —
    # group-code build (remap gathers / window codes), CNF selection mask,
    # value-plane shifts, every kernel pass, min/max lexicographic combine,
    # and the result-blob concatenation — built once per query structure
    # (_build_fused_program) and ending in ONE device-to-host copy. Filter
    # literals, window bases and value biases ride as runtime arguments.

    def _leaf_i32_ok(self, sp, leaf) -> bool:
        """Whether an int filter leaf can compare in int32: the column's
        part-set range and the literal both fit."""
        if not (_INT32_MIN <= leaf.lit <= _INT32_MAX):
            return False
        r = self._sp_int_range(sp, leaf.column)
        return r is None or (_INT32_MIN <= r[0] and r[1] <= _INT32_MAX)

    def _leaf_sig(self, sp, leaf) -> tuple:
        static = _missing_leaf_all_true(leaf)
        if leaf.kind == "int":
            return ("int", leaf.op, static, self._leaf_i32_ok(sp, leaf))
        if leaf.lit is None:
            return ("nulllit", leaf.op, static)
        return ("dict", static)

    def _fastcmp_sig(self, sp, plans):
        """The serving hot shape's in-kernel-compare gate: exactly one
        single-leaf int clause (i32 range, column present in every part)
        and sum/count-only value plans — the kernel then evaluates the
        predicate itself against a cached int8 base-validity plane,
        skipping the selection plane's round trip through device memory.
        Range predicates go further:
        validity folds into a cached SENTINEL-masked compare plane
        (invalid rows hold INT32_MIN / INT32_MAX, which the predicate can
        never satisfy), so the kernel reads exactly the raw-kernel's three
        4B planes per row. Returns (op, "sent_lo"|"sent_hi"|"base8") or
        None."""
        if not 1 <= len(self.clauses) <= 3:
            return None
        for p in plans:
            if (
                p.wide
                or p.fexact is not None
                or p.need_minmax
                or p.need_unique
                or p.need_and
            ):
                return None
        leaves = []
        for idxs in self.clauses:
            if len(idxs) != 1:
                return None
            leaf = self.filters[idxs[0]]
            if leaf.kind == "dict":
                # dict equality reduces to a CODE compare (codes ==
                # lookup(lit)): sentinel-maskable like any range leaf
                if leaf.op != E.OP_EQ or not isinstance(leaf.lit, str):
                    return None
            elif leaf.kind != "int" or not self._leaf_i32_ok(sp, leaf):
                return None
            if not all(
                p.batch.column(leaf.column) is not None
                for p in sp["parts"]
            ):
                return None
            leaves.append(leaf)
        ops = []
        for leaf in leaves:
            if leaf.kind == "dict":
                # codes >= 0 and the (possibly missing -> -1) literal can
                # never equal the INT32_MIN sentinel
                ops.append("==")
            elif leaf.op == ">" or (
                leaf.op == ">=" and leaf.lit > _INT32_MIN
            ):
                ops.append(leaf.op)
            elif leaf.op == "<" or (
                leaf.op == "<=" and leaf.lit < _INT32_MAX
            ):
                ops.append(leaf.op)
            elif leaf.op in ("==", "!=") and len(leaves) == 1:
                # int ==/!= have no unsatisfiable sentinel; single-clause
                # only via the int8 base plane
                return (leaf.op, "base8")
            else:
                # boundary-literal >=/<= (sentinel would satisfy the op)
                return None
        return ("band", tuple(ops))

    def _sp_cmpmask(self, sp, gplan, leafcol: str, sentinel: int):
        """Sentinel-masked i32 compare plane: the filter column's values
        with every invalid row (padding, null group key, null filter slot)
        replaced by a predicate-unsatisfiable sentinel — cached once per
        (part set, group cols, column, side)."""
        k = (
            "cmpmask",
            tuple(g.name for g in gplan if g.kind != "bool"),
            leafcol,
            int(sentinel),
        )
        out = sp["planes"].get(k)
        if out is None:
            base = self._sp_basesel(sp, gplan) * self._sp_plane(
                sp, "valid", leafcol
            )
            vals = self._sp_i32_m(sp, leafcol)
            out = torch.where(base == 1, vals, sentinel).to(torch.int32)
            sp["planes"][k] = out
        return out

    def _sp_cmpmask_dict(self, sp, gplan, leafcol: str):
        """Sentinel-masked i32 CODES plane for dict-equality band clauses
        (invalid rows hold INT32_MIN, which no code or literal equals)."""
        k = (
            "cmpmaskd",
            tuple(g.name for g in gplan if g.kind != "bool"),
            leafcol,
        )
        out = sp["planes"].get(k)
        if out is None:
            base = self._sp_basesel(sp, gplan) * self._sp_plane(
                sp, "valid", leafcol
            )
            vals = self._sp_plane(sp, "codes_m", leafcol)
            out = torch.where(base == 1, vals, _INT32_MIN).to(torch.int32)
            sp["planes"][k] = out
        return out

    def _sp_basesel8(self, sp, gplan, leafcol: str):
        """int8 base-validity plane: row validity x group validity x the
        filter column's validity, folded once per (part set, cols) — the
        fused-compare kernel's 1B/row mask input."""
        k = (
            "basesel8",
            tuple(g.name for g in gplan if g.kind != "bool"),
            leafcol,
        )
        out = sp["planes"].get(k)
        if out is None:
            base = self._sp_basesel(sp, gplan)
            base = base * self._sp_plane(sp, "valid", leafcol)
            out = base.to(torch.int8)
            sp["planes"][k] = out
        return out

    def _fused_structure(self, sp, plans, num_codes) -> tuple:
        g = tuple(
            ("bool", self._leaf_sig(sp, gc.leaf))
            if gc.kind == "bool"
            else (gc.kind, gc.remap is not None, gc.k, gc.window)
            for gc in self._gplan
        )
        cl = []
        for idxs in self.clauses:
            cl.append(
                tuple(self._leaf_sig(sp, self.filters[i]) for i in idxs)
            )
        vp = tuple(
            (
                p.need_sum,
                p.need_minmax,
                p.wide,
                p.num_digits,
                p.hi_digits,
                p.fexact_top_digits if p.fexact is not None else None,
                p.need_unique,
                p.need_and,
            )
            for p in plans
        )
        return (
            g,
            tuple(cl),
            vp,
            num_codes,
            self._fastcmp_sig(sp, plans),
        )

    def _leaf_args(self, sp, leaf, lut_idx: Optional[int]) -> list:
        """Args for one comparison leaf (shared by filter clauses and bool
        group keys); layout must match _leaf_sig."""
        if leaf.kind == "int":
            plane = (
                self._sp_i32_m(sp, leaf.column)
                if self._leaf_i32_ok(sp, leaf)
                else self._sp_plane(sp, "int64_m", leaf.column)
            )
            return [
                plane,
                self._sp_plane(sp, "valid_m", leaf.column),
                self._sp_plane(sp, "has", leaf.column),
                int(leaf.lit),
            ]
        if leaf.lit is None:
            return [
                self._sp_plane(sp, "valid_m", leaf.column),
                self._sp_plane(sp, "has", leaf.column),
            ]
        return [
            self._sp_plane(sp, "codes_m", leaf.column),
            self._sp_plane(sp, "valid_m", leaf.column),
            self._sp_plane(sp, "has", leaf.column),
            self._leaf_lut_dev(lut_idx)
            if lut_idx is not None
            else self._gkey_lut_dev(leaf),
        ]

    def _gkey_lut_dev(self, leaf):
        """Device LUT for a bool GROUP key's dict leaf (filter-leaf LUTs
        cache by filter index; group leaves cache by leaf identity)."""
        from .lsm import _dict_match_lut

        cache = getattr(self, "_gkey_lut_cache", None)
        if cache is None:
            cache = self._gkey_lut_cache = {}
        key = (id(leaf), len(leaf.dictionary))
        lut = cache.get(key)
        if lut is None:
            import re

            try:
                lut_np = _dict_match_lut(
                    leaf.dictionary, leaf.op, leaf.lit, None
                )
            except re.error:
                raise NotCompilable("invalid regex literal (generic path)")
            if lut_np is None:
                raise NotCompilable(f"op {leaf.op} has no dict LUT")
            if len(lut_np) == 0:
                lut_np = np.asarray(
                    [leaf.op == E.OP_NOT_EQ], dtype=np.bool_
                )
            lut = self._put(lut_np.astype(np.int32))
            cache[key] = lut
        return lut

    def _fused_args(self, sp, plans) -> list:
        args = []
        for gcol in self._gplan:
            if gcol.kind == "bool":
                args.extend(self._leaf_args(sp, gcol.leaf, None))
            elif gcol.kind == "int":
                args.append(self._sp_plane(sp, "int64", gcol.name))
                args.append(int(gcol.base))
            else:
                args.append(self._sp_plane(sp, "codes", gcol.name))
                if gcol.remap is not None:
                    args.append(self._remap_dev(gcol))
        fastcmp = self._fastcmp_sig(sp, plans)
        if fastcmp is not None and fastcmp[0] == "band":
            for idxs, op in zip(self.clauses, fastcmp[1]):
                leaf = self.filters[idxs[0]]
                if leaf.kind == "dict":
                    args.append(
                        self._sp_cmpmask_dict(sp, self._gplan, leaf.column)
                    )
                else:
                    sent = (
                        _INT32_MIN if op in (">", ">=") else _INT32_MAX
                    )
                    args.append(
                        self._sp_cmpmask(
                            sp, self._gplan, leaf.column, sent
                        )
                    )
            for idxs in self.clauses:
                leaf = self.filters[idxs[0]]
                if leaf.kind == "dict":
                    # dictionary code of the literal; -1 (matches nothing)
                    # when the value has never been seen
                    code = leaf.dictionary.lookup(leaf.lit)
                    args.append(-1 if code is None else int(code))
                else:
                    args.append(int(leaf.lit))
        elif fastcmp is not None:
            leaf = self.filters[self.clauses[0][0]]
            args.append(self._sp_basesel8(sp, self._gplan, leaf.column))
            args.append(self._sp_i32_m(sp, leaf.column))
            args.append(int(leaf.lit))
        else:
            args.append(self._sp_basesel(sp, self._gplan))
            for idxs in self.clauses:
                for i in idxs:
                    args.extend(self._leaf_args(sp, self.filters[i], i))
        for plan in plans:
            if plan.fexact is not None:
                # Four host-decomposed digit planes (_sp_fplanes), uploaded
                # once per part set.
                args.extend(self._sp_fplanes(sp, plan.column, plan.fexact))
            elif plan.wide:
                args.append(self._sp_plane(sp, "int64", plan.column))
                args.append(int(plan.bias))
            else:
                args.append(
                    self._sp_value_i32(sp, plan.column, plan.bias)
                )
            if plan.need_unique or plan.need_and:
                # validity plane: the unique() valid-slot count / the and()
                # null-neutral fill
                args.append(self._sp_plane(sp, "valid", plan.column))
        return args

    def _fused_blob(self, sp, plans, num_codes) -> np.ndarray:
        structure = self._fused_structure(sp, plans, num_codes)
        prog = _FUSED_CACHE.get(structure)
        if prog is None:
            prog = _FUSED_CACHE[structure] = _build_fused_program(structure)
        # The single device-to-host copy of the query.
        return prog(*self._fused_args(sp, plans)).cpu().numpy()

    # ------------------------------------------------------------------

    def _decode_codes(self, codes: np.ndarray) -> list[np.ndarray]:
        """Combined dense codes -> per-group-column FAMILY codes (dict
        columns) or absolute window indices value//window (int columns)."""
        gplan = self._gplan
        out = []
        rest = np.asarray(codes, dtype=np.int64)
        for i, gcol in enumerate(gplan):
            div = 1
            for later in gplan[i + 1 :]:
                div *= later.k
            c = (rest // div) % gcol.k
            if gcol.kind == "int":
                fam = c + gcol.base
            else:
                fam = gcol.inv[c] if gcol.inv is not None else c
            out.append(fam.astype(np.int64))
        return out

    # ------------------------------------------------------------------

    def execute(self) -> ColumnBatch:
        from .tracing import span as _span

        with _span(
            "compiled/execute", table=self.table.name, group=self.group_col
        ):
            return self._execute()

    def _execute(self) -> ColumnBatch:
        tx = (
            self.table.db.high_watermark()
            if self.table.db is not None
            else 2**63
        )
        parts = self.table.collect_parts(tx)
        parts = self._filter_parts(parts)
        self._check_parts(parts)
        self._gplan, num_codes = self._group_remap(parts)
        plans = list(self.value_plans.values())
        if parts:
            # The WHOLE query — code build, CNF mask, every kernel pass and
            # the result-blob concat — runs over the cached concatenation
            # of all parts, then ONE device-to-host copy.
            sp = self._superpart(parts)
            blob = self._fused_blob(sp, plans, num_codes)
        else:
            # No visible part: no group is emitted; the blob only keeps
            # the epilogue's layout.
            sp = None
            blob = np.zeros(
                _blob_rows(plans, with_first=False) * num_codes,
                dtype=np.int64,
            )
        if self.allocator is not None:
            # per-query transient accounting (query/memory.go:17); raises
            # MemoryLimitExceeded through to the caller — NOT NotCompilable
            self.allocator.allocate(int(blob.nbytes))
        try:
            return self._epilogue(sp, blob, plans, num_codes)
        finally:
            # free even when the epilogue raises — a leaked reservation
            # would fail every later memory-limited query
            if self.allocator is not None:
                self.allocator.free(int(blob.nbytes))

    def _epilogue(self, sp, blob, plans, num_codes):
        off = 0
        counts_np = blob[off : off + num_codes]; off += num_codes
        sums_np: dict[str, np.ndarray] = {}
        mins_np: dict[str, np.ndarray] = {}
        maxs_np: dict[str, np.ndarray] = {}
        uniq_cnt_np: dict[str, np.ndarray] = {}
        and_np: dict[str, np.ndarray] = {}
        for plan in plans:
            if plan.need_sum:
                if plan.fexact is not None:
                    from .floatsum import recombine

                    pls = []
                    for _pi in range(4):
                        pls.append(blob[off : off + num_codes])
                        off += num_codes
                    sums_np[plan.column] = recombine(
                        pls,
                        plan.fexact,
                        top_bias=plan.fexact.top_min,
                        counts=counts_np,
                    )
                    continue
                s = blob[off : off + num_codes]; off += num_codes
                if plan.wide:
                    hi = blob[off : off + num_codes]; off += num_codes
                    s = s + (hi << _LO_BITS)
                if plan.bias:
                    # Exact reconstruction of the unbiased sums
                    # (see _check_parts).
                    s = s + plan.bias * counts_np
                sums_np[plan.column] = (
                    s.astype(np.float64) if plan.is_float else s
                )
            if plan.need_unique:
                uniq_cnt_np[plan.column] = blob[off : off + num_codes]
                off += num_codes
            if plan.need_and:
                and_np[plan.column] = (
                    blob[off : off + num_codes] > 0
                ).astype(np.bool_)
                off += num_codes
            if plan.need_minmax:
                # Sentinels only survive for codes with no selected rows,
                # which are never emitted; the bias shift is
                # order-preserving.
                mn = blob[off : off + num_codes] + plan.bias; off += num_codes
                mx = blob[off : off + num_codes] + plan.bias; off += num_codes
                if plan.is_float:
                    mn = mn.astype(np.float64)
                    mx = mx.astype(np.float64)
                mins_np[plan.column] = mn
                maxs_np[plan.column] = mx
        if sp is not None:
            first_np = blob[off : off + num_codes]
            off += num_codes
            order_arr = self._emission_order_concat(counts_np, first_np)
        else:
            order_arr = np.asarray([], dtype=np.int64)
        order_arr = self._ordered_sort(order_arr)

        by_name = {}
        for spec in self.aggs:
            if spec.func == E.AGG_COUNT:
                by_name[spec.result_name] = counts_np
            elif spec.func == E.AGG_SUM:
                by_name[spec.result_name] = sums_np[spec.column]
            elif spec.func == E.AGG_UNIQUE:
                mn, mx = mins_np[spec.column], maxs_np[spec.column]
                uvalid = (mn == mx) & (
                    uniq_cnt_np[spec.column] == counts_np
                )
                by_name[spec.result_name] = (
                    np.where(uvalid, mn, 0),
                    uvalid,
                )
            elif spec.func == E.AGG_AND:
                by_name[spec.result_name] = and_np[spec.column]
            elif spec.func == E.AGG_MIN:
                by_name[spec.result_name] = mins_np[spec.column]
            else:
                by_name[spec.result_name] = maxs_np[spec.column]
        return emit_output(
            self._emitted_group_cols(order_arr),
            order_arr,
            [spec.result_name for spec in self.aggs],
            by_name,
            self.output_projection,
        )

    def _ordered_sort(self, order_arr: np.ndarray) -> np.ndarray:
        """Key-order re-sort under ordered_aggregations: OrderedAggregate
        emits groups sorted by the group key tuple's string values
        (ColumnBatch.sort_indices ranks dict codes via sort_ranks); keys
        are unique so a stable lexicographic re-sort of the emitted codes
        reproduces that order exactly."""
        if not self.ordered or not len(order_arr):
            return order_arr
        fams = self._decode_codes(order_arr)
        keys = [
            fam
            if gcol.kind != "dict"
            else gcol.dictionary.sort_ranks()[fam]
            for gcol, fam in zip(self._gplan, fams)
        ]
        # np.lexsort sorts by the LAST key first.
        return order_arr[np.lexsort(tuple(reversed(keys)))]

    def _emitted_group_cols(self, order_arr: np.ndarray) -> list[tuple]:
        """emit_output's group-column spec: per column (name, dictionary,
        family codes in emission order); int/window columns emit as
        (name, None, key values) — the generic engine's (ts // w) * w."""
        fams = self._decode_codes(order_arr)
        out = []
        for gcol, fam in zip(self._gplan, fams):
            if gcol.kind == "bool":
                out.append((gcol.name, None, fam, "bool"))
            elif gcol.kind == "int":
                out.append((gcol.out or gcol.name, None, fam * gcol.window))
            else:
                out.append((gcol.name, gcol.dictionary, fam))
        return out


# (structure) -> whole-query program; see _fused_blob. Structure keys are
# small tuples.
_FUSED_CACHE: dict = {}


def _blob_rows(plans, with_first: bool = True) -> int:
    """[K]-sized rows in a query's result blob (the epilogue's layout)."""
    rows = 1  # counts
    for p in plans:
        if p.need_sum:
            rows += 4 if p.fexact is not None else (2 if p.wide else 1)
        rows += int(p.need_unique) + int(p.need_and) + 2 * int(p.need_minmax)
    return rows + int(with_first)


def _take_clip(table, idx):
    """``table[idx]`` with indices clamped into range (jnp.take's clip
    mode; an out-of-range index would be a device-side assert on CUDA)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


_CMP_OPS = {
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
    "==": torch.eq,
    "!=": torch.ne,
}


def _build_fused_program(structure):
    """The whole-query function for one query structure: tensor ops around
    the kernels of ops/agg_kernels.py (which launch their CUDA kernels for
    CUDA tensors and run their plain versions for CPU tensors), ending in
    one int64 result blob."""
    from .ops import agg_kernels as AK

    gshape, clauses, vps, num_codes, fastcmp = structure

    def fn(*xs):
        i = 0

        def eval_leaf(leaf):
            """One comparison leaf's 0/1 int32 mask plane; consumes its
            args. Missing columns resolve statically per row range via the
            cached ``has`` plane."""
            nonlocal i
            if leaf[0] == "int":
                fv, fvalid, has, lit = xs[i], xs[i + 1], xs[i + 2], xs[i + 3]
                i += 4
                m = _CMP_OPS[leaf[1]](fv, lit).to(torch.int32) * fvalid
                static = leaf[2]
            elif leaf[0] == "nulllit":
                fvalid, has = xs[i], xs[i + 1]
                i += 2
                m = fvalid if leaf[1] == E.OP_NOT_EQ else (1 - fvalid)
                static = leaf[2]
            else:
                fcodes, fvalid, has, lut = xs[i], xs[i + 1], xs[i + 2], xs[i + 3]
                i += 4
                m = _take_clip(lut, fcodes) * fvalid
                static = leaf[1]
            return torch.where(has == 1, m, 1 if static else 0).to(torch.int32)

        combined = None
        for entry in gshape:
            if entry[0] == "bool":
                # The key IS the leaf mask (boolExprProjection semantics).
                c = eval_leaf(entry[1])
                k = 2
            else:
                kind, has_remap, k, window = entry
                cplane = xs[i]
                i += 1
                if kind == "int":
                    base = xs[i]
                    i += 1
                    c = torch.clamp(
                        torch.div(cplane, window, rounding_mode="floor") - base,
                        0,
                        k - 1,
                    ).to(torch.int32)
                else:
                    c = cplane
                    if has_remap:
                        c = _take_clip(xs[i], c)
                        i += 1
            combined = c if combined is None else combined * k + c
        codes = combined.to(torch.int32).contiguous()
        sel = None
        if fastcmp is not None:
            # The predicate is evaluated inside the kernel: range-predicate
            # conjunctions read one sentinel-masked plane per clause
            # (validity pre-folded), ==/!= read int8 base + values. No
            # selection plane is materialized.
            if fastcmp[0] == "band":
                fc_ops = fastcmp[1]
                n_cl = len(fc_ops)
                fc_planes = tuple(xs[i : i + n_cl])
                i += n_cl
                fc_lits = tuple(xs[i : i + n_cl])
                i += n_cl
            else:
                fc_op, _mode = fastcmp
                base8, tsv, lit = xs[i], xs[i + 1], xs[i + 2]
                i += 3
        else:
            # Pre-folded row-validity x group-validity plane (_sp_basesel).
            sel = xs[i]
            i += 1
            for cl in clauses:
                cmask = None
                for leaf in cl:
                    m = eval_leaf(leaf)
                    cmask = m if cmask is None else torch.maximum(cmask, m)
                sel = sel * cmask
            sel = sel.to(torch.int32).contiguous()

        # per value column: list of (plane, num_digits) kernel passes
        value_planes = []
        _fd = _digits_for(_LO_MASK)  # 28-bit digit planes

        def wide_split(vdata, nd, hd):
            lo = torch.bitwise_and(vdata, _LO_MASK).to(torch.int32)
            hi = (vdata >> _LO_BITS).to(torch.int32)
            return [(lo, nd), (hi, hd)]

        vvalid_planes: dict = {}  # vi -> validity plane (unique/and plans)
        for vi0, (
            need_sum, need_mm, wide, nd, hd, ftd, uniq, andf,
        ) in enumerate(vps):
            if ftd is not None:
                # Exact float64 sums (floatsum.py): 3 base-2^28 digit
                # planes + the top plane (biased non-negative), decomposed
                # host-side and cached (_sp_fplanes).
                value_planes.append(
                    [
                        (xs[i], _fd),
                        (xs[i + 1], _fd),
                        (xs[i + 2], _fd),
                        (xs[i + 3], ftd),
                    ]
                )
                i += 4
            elif wide:
                vdata = xs[i] - xs[i + 1]  # bias shift
                i += 2
                value_planes.append(wide_split(vdata, nd, hd))
            else:
                # Pre-shifted int32 plane (_sp_value_i32).
                value_planes.append([(xs[i], nd)])
                i += 1
            if uniq or andf:
                vvalid_planes[vi0] = xs[i]
                i += 1

        def sum_count(vals, digits):
            if fastcmp is None:
                return AK.group_sum_count(codes, vals, sel, num_codes, digits)
            if fastcmp[0] == "band":
                return AK.fused_band_group_sum_count(
                    codes, vals, fc_planes, fc_lits, num_codes, digits, fc_ops
                )
            return AK.fused_cmp_group_sum_count(
                codes, vals, tsv, base8, lit, num_codes, digits, fc_op
            )

        counts = first = None
        sums: dict = {}
        usums: dict = {}  # vi -> valid-slot count partials (unique)
        passes = []
        for vi, (need_sum, *_rest) in enumerate(vps):
            if need_sum:
                for vals, digits in value_planes[vi]:
                    passes.append((vi, vals, digits))
        for vi, vp_t in enumerate(vps):
            if vp_t[6]:  # unique: count VALID slots per group
                passes.append((("u", vi), vvalid_planes[vi], 1))
        if not passes:
            passes.append((None, torch.zeros_like(codes), 1))
        for idx, (vi, vals, digits) in enumerate(passes):
            s, c, f = sum_count(vals.to(torch.int32).contiguous(), digits)
            if idx == 0:
                counts, first = c, f
            if isinstance(vi, tuple):
                usums[vi[1]] = s
            elif vi is not None:
                sums.setdefault(vi, []).append(s)

        def mm(vals, sel2):
            return AK.group_min_max(
                codes,
                vals.to(torch.int32).contiguous(),
                sel2.to(torch.int32).contiguous(),
                num_codes,
            )

        blob = [counts]
        for vi, (need_sum, need_mm, wide, *_rest, uniq, andf) in enumerate(
            vps
        ):
            if need_sum:
                blob.extend(sums[vi])
            if uniq:
                blob.append(usums[vi])
            if andf:
                # and() = per-group min of (valid ? v : 1); nulls are
                # true-neutral (aggregate.go:798)
                (v01,) = [v for v, _d in value_planes[vi]]
                andp = torch.where(vvalid_planes[vi] == 1, v01, 1)
                mn, _mx = mm(andp, sel)
                blob.append(mn.to(torch.int64))
            if not need_mm:
                continue
            planes = [v for v, _d in value_planes[vi]]
            if not wide:
                (vals,) = planes
                mn, mx = mm(vals, sel)
                blob.append(mn.to(torch.int64))
                blob.append(mx.to(torch.int64))
                continue
            # Two-plane lexicographic min/max: pass 1 reduces the hi plane;
            # passes 2/3 reduce the lo plane over just the rows whose hi
            # equals their code's extreme (one [K]-gather per row).
            lo, hi = planes
            mn_hi, mx_hi = mm(hi, sel)
            sel_min = sel * (hi == _take_clip(mn_hi, codes)).to(torch.int32)
            mn_lo, _ = mm(lo, sel_min)
            sel_max = sel * (hi == _take_clip(mx_hi, codes)).to(torch.int32)
            _, mx_lo = mm(lo, sel_max)
            blob.append((mn_hi.to(torch.int64) << _LO_BITS) + mn_lo.to(torch.int64))
            blob.append((mx_hi.to(torch.int64) << _LO_BITS) + mx_lo.to(torch.int64))
        blob.append(first.to(torch.int64))
        return torch.cat(blob)

    return fn


def emit_output(
    group_cols: list,
    order_arr: np.ndarray,
    result_names: Sequence[str],
    by_name: dict,
    output_projection,
) -> ColumnBatch:
    """Materialize the output batch from dense [K] host partials + the group
    emission order — shared by the compiled and mesh executors so both emit
    byte-identical batches. ``order_arr`` indexes the [K] partials;
    ``group_cols`` is a list of (name, dictionary, family_codes) — the
    emitted group key columns in plan order (family codes differ from
    order_arr when the kernel ran in a compact/combined code space)."""
    n = len(order_arr)

    def group_column(i):
        name, dictionary, codes, *rest = group_cols[i]
        if rest and rest[0] == "bool":
            # comparison group key: dense true/false (project.go:405).
            from .columnbatch import KIND_BOOL

            return Column(
                name,
                KIND_BOOL,
                np.asarray(codes).astype(np.bool_),
                np.ones(n, dtype=bool),
            )
        if dictionary is None:
            # int/window group key: emitted values, not dict codes.
            return Column(
                name,
                KIND_INT64,
                np.asarray(codes).astype(np.int64),
                np.ones(n, dtype=bool),
            )
        return Column(
            name,
            KIND_DICT,
            np.asarray(codes).astype(np.int32),
            np.ones(n, dtype=bool),
            dictionary,
        )

    def agg_column(out_name, src):
        validity = None
        if isinstance(src, tuple):  # (values, validity): unique() results
            src, validity = src
        if src.dtype == np.bool_:
            kind = "bool"  # and() results
        elif np.issubdtype(src.dtype, np.floating):
            kind = "float64"
        else:
            kind = KIND_INT64
        return Column(
            out_name,
            kind,
            src[order_arr] if n else src[:0],
            (validity[order_arr] if n else validity[:0])
            if validity is not None
            else np.ones(n, dtype=bool),
        )

    if output_projection is None:
        cols = [group_column(i) for i in range(len(group_cols))]
        for name in result_names:
            cols.append(agg_column(name, by_name[name]))
        return ColumnBatch(cols, n)

    # Post-aggregation projection (the avg rewrite): evaluated on the
    # [K]-sized host partials; the generic engine's Projection dedups
    # output names first-wins, mirror that.
    cols = []
    seen: set[str] = set()
    for item in output_projection:
        if item[0] == "group":
            col = group_column(item[1] if len(item) > 1 else 0)
        elif item[0] == "col":
            _, out_name, src_name = item
            col = agg_column(out_name, by_name[src_name])
        else:  # ("div", out, sum_name, count_name)
            _, out_name, s_name, c_name = item
            s = by_name[s_name][order_arr] if n else by_name[s_name][:0]
            c = by_name[c_name][order_arr] if n else by_name[c_name][:0]
            # Go-style truncation toward zero; division by zero emits
            # null — exactly ops/kernels.arith's integer "/" semantics.
            valid = c != 0
            safe_c = np.where(valid, c, 1)
            q = s // safe_c
            r = s - q * safe_c
            q = q + ((s < 0) != (safe_c < 0)) * (r != 0)
            col = Column(out_name, KIND_INT64, q, valid)
        if col.name in seen:
            continue
        seen.add(col.name)
        cols.append(col)
    return ColumnBatch(cols, n)


def compile_filter_aggregate(table, group_col, aggs, filter=None):
    """Try to build a compiled query; raises NotCompilable when the pattern
    doesn't hold (callers fall back to the generic engine)."""
    return CompiledFilterAggregate(table, group_col, aggs, filter)


# ---------------------------------------------------------------------------
# Planner lowering (engine integration)

_COMPARE_FILTER_OPS = ("<", "<=", ">", ">=", "==", "!=")


@dataclass
class FastPlanSpec:
    """A plan matched onto the fused filter+group-aggregate shape — shared
    by the single-chip compiled path (CompiledFilterAggregate) and the
    distributed mesh path (parallel/mesh_exec.MeshFilterAggregate)."""

    table: object
    group_col: str
    aggs: list  # (func, column, result_name)
    filter: Optional[list]  # AND conjunction: [(col, op, literal), ...]
    output_projection: Optional[list]
    ordered: bool
    filter_expr: object = None  # the plan's filter expr (part pruning)


def lower_plan(plan, exec_options=None) -> CompiledFilterAggregate:
    """Pattern-match an *optimized* logical plan onto the compiled fast
    path. The engine calls this before building the generic operator DAG
    and falls back on ``NotCompilable``."""
    s = match_plan(plan, exec_options)
    obj = CompiledFilterAggregate(
        s.table,
        s.group_col,
        s.aggs,
        s.filter,
        s.output_projection,
        ordered=s.ordered,
        filter_expr=s.filter_expr,
    )
    if exec_options is not None:
        obj.allocator = exec_options.allocator
    return obj


def match_plan(plan, exec_options=None) -> FastPlanSpec:
    """Match an *optimized* logical plan onto the fused fast shape.

    Matched shape: TableScan <- [Filter(col cmp int-literal)] <- Aggregation
    <- [Projection] where the optional projection is the avg rewrite's
    post-aggregation ``sum(x)/count(x) as avg(x)`` (builder.go:152-238) —
    evaluated here as a truncating division on the [K]-sized host partials.
    """
    node = plan
    proj_node = None
    if (
        node is not None
        and node.projection is not None
        and node.aggregation is None
    ):
        proj_node = node
        node = node.input
    if node is None or node.aggregation is None:
        raise NotCompilable("root is not an aggregation")
    agg_node = node
    agg = node.aggregation
    node = node.input
    filt = None
    # Pass-through pre-projections below the aggregation (the sqlparse
    # visitor splits pre/post projections around aggregations,
    # visitor.go:57-155): pure column selections narrow the visible column
    # set without computing anything, so the fused path can look through
    # them — provided every column it reads survives the narrowing
    # (checked at the end; a dropped column means the generic engine's
    # missing-column semantics apply and the plan stays generic).
    pre_sets: list[tuple[set, list, bool]] = []  # (names, dyn prefixes, all)
    # Projection-computed group-key bindings: ``(col / k) * k as alias``
    # (the logictest timestamp_bucket shape; reference project.go:405
    # binaryExprProjection used as a group key). alias -> (src col, k,
    # index of the defining pre_set).
    bindings: dict = {}
    filter_col_depth: list = []  # (col, #projections above the filter)

    def _truncdiv(e):
        """Return (src_col, k) when e is ``(Column / k) * k`` with matching
        positive int literals, else None."""
        if not (
            isinstance(e, E.BinaryExpr)
            and e.op == E.OP_MUL
            and isinstance(e.right, E.Literal)
            and isinstance(e.left, E.BinaryExpr)
            and e.left.op == E.OP_DIV
            and type(e.left.left) is E.Column
            and isinstance(e.left.right, E.Literal)
        ):
            return None
        k1, k2 = e.left.right.value, e.right.value
        if (
            not isinstance(k1, int)
            or isinstance(k1, bool)
            or k1 != k2
            or k1 <= 0
        ):
            return None
        return (e.left.left.column_name, k1)

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
                elif isinstance(e, E.DurationExpr):
                    names.add("timestamp")
                elif isinstance(e, E.DynamicColumn):
                    dyns.append(e.column_name)
                elif isinstance(e, E.AllExpr):
                    has_all = True
                elif isinstance(e, E.AliasExpr) and (
                    _truncdiv(e.expr) is not None
                ):
                    src, kk = _truncdiv(e.expr)
                    bindings[e.alias_name] = (src, kk, len(pre_sets))
                    names.add(e.alias_name)
                else:
                    raise NotCompilable("computed pre-projection")
            pre_sets.append((names, dyns, has_all))
        else:
            # Stacked PredicateFilters are an AND conjunction (each
            # operator masks independently) — combine into one CNF. A
            # filter reads its columns from BELOW it, so only projections
            # DEEPER in the chain (walked after this node) can drop them —
            # record how many sets were already walked (those sit above).
            for c in node.filter.expr.columns_used():
                if type(c) is E.Column:
                    filter_col_depth.append((c.column_name, len(pre_sets)))
            filt = (
                node.filter.expr
                if filt is None
                else E.BinaryExpr(node.filter.expr, E.OP_AND, filt)
            )
        node = node.input
    if node is None or node.table_scan is None:
        raise NotCompilable("input is not a plain table scan")

    def _projected(name: str, sets=None) -> bool:
        for names, dyns, has_all in (pre_sets if sets is None else sets):
            if has_all or name in names:
                continue
            if any(
                name == d or name.startswith(d + ".") for d in dyns
            ):
                continue
            return False
        return True
    scan = node.table_scan
    table = scan.provider.get_table(scan.table_name)
    if table is None:
        raise NotCompilable(f"table not found: {scan.table_name}")

    if not agg.group_exprs:
        raise NotCompilable("compiled path needs concrete group columns")
    group_cols: list[str] = []  # names (projection indexing below)
    group_specs: list = []  # str | ("int", name, window)
    for ge in agg.group_exprs:
        if type(ge) is E.Column:
            # the generic engine matches each column once (first expr wins)
            if ge.column_name not in group_cols:
                group_cols.append(ge.column_name)
                if ge.column_name in bindings:
                    src, kk, _j = bindings[ge.column_name]
                    group_specs.append(
                        ("int", src, kk, ge.column_name, True)
                    )
                else:
                    group_specs.append(ge.column_name)
        elif isinstance(ge, E.DurationExpr):
            # Windowed aggregation key (the Parca Range query's
            # second(timestamp), reference expr.go:1072 DurationExpr,
            # sqlparse/visitor.go:332): an int64 "timestamp" key truncated
            # to the window. The generic engine appends the window column
            # even when "timestamp" was already grouped; that degenerate
            # duplicate stays generic (CompiledFilterAggregate rejects it).
            group_cols.append("timestamp")
            group_specs.append(
                ("int", "timestamp", max(ge.milliseconds, 1))
            )
        else:
            raise NotCompilable("compiled path needs concrete group columns")
    if len(group_specs) > 4:
        raise NotCompilable("compiled path groups by at most 4 columns")
    group_col = group_specs[0] if len(group_specs) == 1 else group_specs

    aggs: list[tuple[str, str, str]] = []
    seen_names: set[str] = set()
    for a in agg.agg_exprs:
        result_name = None
        inner = a
        if isinstance(inner, E.AliasExpr):
            result_name = inner.alias_name
            inner = inner.expr
        if not isinstance(inner, E.AggregationFunction):
            raise NotCompilable("non-aggregation expression")
        if type(inner.expr) is not E.Column:
            raise NotCompilable("aggregation input is not a plain column")
        name = result_name or inner.name()
        if name in seen_names:
            continue  # the generic final stage dedups too (aggregate.go:973)
        seen_names.add(name)
        aggs.append((inner.func, inner.expr.column_name, name))

    filter_spec = None
    if filt is not None:
        # Flatten the AND tree into conjuncts; each conjunct is a plain
        # ``col <op> literal`` comparison or an OR tree of them (the CNF
        # the reference's BooleanExpression compiler evaluates,
        # filter.go:167-229). AND under OR is not CNF — generic path.
        # Per-leaf type/op validation happens in
        # CompiledFilterAggregate.__init__ against the schema.
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
                raise NotCompilable(
                    "filter is not a CNF of col <op> literal"
                )
            return (e.left.column_name, e.op, e.right.value)

        def flatten_or(e, out: list) -> None:
            if isinstance(e, E.BinaryExpr) and e.op == E.OP_OR:
                flatten_or(e.left, out)
                flatten_or(e.right, out)
                return
            out.append(leaf_tuple(e))

        flatten(filt)
        filter_spec = []
        for e in conjuncts:
            if isinstance(e, E.BinaryExpr) and e.op == E.OP_OR:
                ors: list = []
                flatten_or(e, ors)
                filter_spec.append(ors)
            else:
                filter_spec.append(leaf_tuple(e))

    output_projection = None
    if proj_node is not None:
        agg_names = {name for _f, _c, name in aggs}
        output_projection = []
        for e in proj_node.projection.exprs:
            if type(e) is E.Column:
                if e.column_name not in group_cols:
                    raise NotCompilable("projection of a non-group column")
                output_projection.append(
                    ("group", group_cols.index(e.column_name))
                )
            elif isinstance(e, E.DurationExpr):
                spec = ("int", "timestamp", max(e.milliseconds, 1))
                if spec not in group_specs:
                    raise NotCompilable("window projection without its key")
                output_projection.append(
                    ("group", group_specs.index(spec))
                )
            elif isinstance(e, E.AggregationFunction):
                name = e.name()
                if name not in agg_names:
                    raise NotCompilable(f"projection references {name}")
                output_projection.append(("col", name, name))
            elif isinstance(e, E.AliasExpr):
                inner = e.expr
                if isinstance(inner, E.AggregationFunction):
                    name = inner.name()
                    if name not in agg_names:
                        raise NotCompilable(f"projection references {name}")
                    output_projection.append(("col", e.alias_name, name))
                elif (
                    isinstance(inner, E.BinaryExpr)
                    and inner.op == E.OP_DIV
                    and isinstance(inner.left, E.AggregationFunction)
                    and isinstance(inner.right, E.AggregationFunction)
                ):
                    s_name, c_name = inner.left.name(), inner.right.name()
                    if s_name not in agg_names or c_name not in agg_names:
                        raise NotCompilable("division over unknown partials")
                    output_projection.append(
                        ("div", e.alias_name, s_name, c_name)
                    )
                else:
                    # e.g. ConvertExpr counts (float avg) — generic path.
                    raise NotCompilable("projection expr not compiled")
            else:
                raise NotCompilable("projection expr not compiled")

    if pre_sets:
        # Coverage check for the pass-through pre-projections: every column
        # the fused query reads must survive the narrowing, else the
        # generic engine's missing-column semantics differ from reading
        # the raw parts. A binding alias must survive the sets ABOVE its
        # defining projection, and its SOURCE column the sets BELOW it
        # (the defining projection consumes the source).
        needed = list(group_cols) + [c for _f, c, _n in aggs]
        for name, d in filter_col_depth:
            if not _projected(name, pre_sets[d:]):
                raise NotCompilable(
                    f"pre-projection drops {name} (generic semantics)"
                )
        for name in needed:
            if name in bindings:
                src, _kk, j = bindings[name]
                ok = _projected(name, pre_sets[: j + 1]) and _projected(
                    src, pre_sets[j + 1 :]
                )
            else:
                ok = _projected(name)
            if not ok:
                raise NotCompilable(
                    f"pre-projection drops {name} (generic semantics)"
                )

    # Mirror the generic planner's operator choice: when it would pick
    # OrderedAggregate (physical._should_plan_ordered with ordering_ok=True —
    # only scan/filter nodes sit below the aggregation in this pattern, and
    # neither resets stream ordering), emit groups in key order.
    ordered = False
    if exec_options is not None and exec_options.ordered_aggregations:
        from .query.physical import _should_plan_ordered

        ordered = _should_plan_ordered(exec_options, True, agg_node)

    return FastPlanSpec(
        table,
        group_col,
        aggs,
        filter_spec,
        output_projection,
        ordered,
        filter_expr=filt,
    )
