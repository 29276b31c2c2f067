"""Cross-tier differential fuzz of the port on a device.

The port of the JAX package's differential fuzz (its test module
``test_differential_fuzz``): random schemas and data (null group keys,
negative values, bool columns, the float edge values ±0.0, ±inf, NaN,
1e300 and 5e-324; 1-3 parts, sorted or not) and random query shapes (CNF
filters of range, ``==``/``!=``, regex and OR-band leaves; every
aggregation; multi, windowed and (label, window) group keys; scans with a
limit; ORDER BY + LIMIT epilogues; inner, left_outer, semi and anti joins
on a dictionary key and on an int64 key) go through the engine with the
fast tiers on, on a 4-shard mesh and on the generic operator DAG, and all
must agree byte for byte. The generators make the reference's draws, call
for call, so a seed gives the reference's tables and queries.

Scenarios and seeds are the reference's: aggregates (seeds 1000-1019, three
queries each: generic, compiled and mesh), scan and epilogue (5000-5007),
joins on ``g`` (9000-9005) and int-key joins on ``ts`` (13000-13003). The
directed shapes of the port's engine tests follow: each must be served by
its tier and, on a GPU, launch the kernels it is built for.

Per query it records the fast run's tier and fallback reasons, its kernel
launches (``agg_kernels.LAUNCHES``) and the rows, encoded as the reference
encodes them (float reprs and the sign of NaN kept).

``--against-cpu`` builds every table a second time on the CPU from the same
seed and runs every query there too: the rows, tiers and reasons must equal
the device's. One difference is allowed, and counted: a float sum outside
the exact-sum gate, which the generic DAG adds by a fixed binary tree on a
GPU (``ops/kernels.ordered_segment_sum``) and in row order on the CPU; the
device's value must then equal the tree over the group's selected values in
stream order, bit for bit (a NaN takes the sign the port's NaN rule gives).

    python -m frostdb_tpu_torch.tools.fuzz [--device cuda|cpu]
        [--rows-scale N] [--extra-seeds N] [--against-cpu]

``--rows-scale`` multiplies each part's 200-1500 rows; ``--extra-seeds N``
runs aggregate seeds 1020 ... 1020+N-1 after the reference's. Prints one
line per scenario and exits non-zero at the first mismatch, printing the
seed, the query and both row lists.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..columnbatch import Column, ColumnBatch, KIND_BOOL, KIND_DICT, KIND_FLOAT64, KIND_INT64
from ..config import resolve_device
from ..db import ColumnStore
from ..ops import agg_kernels as AK
from ..parallel.mesh import make_mesh
from ..query import expr as E
from ..query.engine import LocalEngine
from ..query.physical import ExecOptions
from ..schema import (
    ColumnDef,
    ENCODING_RLE_DICTIONARY,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    TYPE_BOOL,
    TYPE_DOUBLE,
    TYPE_INT64,
    TYPE_STRING,
)
from ..table import TableConfig
from .verify import _encode_draws

FLOAT_EDGE = np.array(
    [-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, np.nan, 1e300, 5e-324, 3.0]
)
SPAN = 10**5
MESH_SHARDS = 4
# Group key columns of the fuzz schema (a window key has no column here:
# the table has no ``timestamp``).
KEY_COLUMNS = ("g", "h")
# Rows printed of each side of a mismatch.
SHOW_ROWS = 8


def _dict_layout():
    return StorageLayout(TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY)


def _schema():
    return SchemaDef(
        "t",
        (
            ColumnDef("g", _dict_layout()),
            ColumnDef("h", _dict_layout()),
            ColumnDef("ts", StorageLayout(TYPE_INT64)),
            ColumnDef("v", StorageLayout(TYPE_INT64, nullable=True)),
            ColumnDef("f", StorageLayout(TYPE_DOUBLE, nullable=True)),
            ColumnDef("b", StorageLayout(TYPE_BOOL, nullable=True)),
        ),
        (SortingColumnDef("g", "asc", True),),
    )


def build_db(rng, device, rows_scale: int = 1):
    """The reference's random fact table ``t`` on ``device``: 1-3 parts of
    200-1500 rows (times ``rows_scale``). Each distinct label is encoded
    once, in order of first occurrence, which gives the codes of encoding
    row by row."""
    store = ColumnStore(device=device)
    db = store.db("fz")
    t = db.table("t", TableConfig(schema=_schema()))
    dg = t.dictionary("g")
    dh = t.dictionary("h")
    n_parts = int(rng.integers(1, 4))
    for _ in range(n_parts):
        n = int(rng.integers(200, 1500)) * rows_scale
        gkinds = int(rng.integers(2, 9))
        gc, gv = _encode_draws(dg, rng.integers(0, gkinds, n), "g{}")
        if rng.random() < 0.3:  # sometimes null group keys
            gv = gv & (rng.random(n) > 0.05)
            gc = np.where(gv, gc, 0)
        hc, hv = _encode_draws(dh, rng.integers(0, 3, n), "h{}")
        span = 10 ** int(rng.integers(2, 6))
        ts = rng.integers(0, span, n).astype(np.int64)
        vscale = 10 ** int(rng.integers(1, 9))
        v = rng.integers(-vscale, vscale, n).astype(np.int64)
        vv = rng.random(n) > (0.15 if rng.random() < 0.5 else 0.0)
        f = FLOAT_EDGE[rng.integers(0, len(FLOAT_EDGE), n)]
        fv = rng.random(n) > 0.1
        b = rng.random(n) > 0.4
        bv = rng.random(n) > 0.2
        t.insert_record(
            ColumnBatch(
                [
                    Column("g", KIND_DICT, gc, gv, dg),
                    Column("h", KIND_DICT, hc, hv, dh),
                    Column("ts", KIND_INT64, ts, np.ones(n, bool)),
                    Column("v", KIND_INT64, np.where(vv, v, 0), vv),
                    Column("f", KIND_FLOAT64, np.where(fv, f, 0.0), fv),
                    Column("b", KIND_BOOL, np.where(bv, b, False), bv),
                ],
                n,
            ),
            sort=bool(rng.random() < 0.7),
        )
    t.sync()
    return store, db


def random_filter(rng, span):
    leaves = []
    n_cl = int(rng.integers(0, 4))
    for _ in range(n_cl):
        kind = rng.random()
        if kind < 0.5:
            op = rng.choice(["<", "<=", ">", ">=", "==", "!="])
            lit = int(rng.integers(-span // 10, span))
            leaves.append(E.BinaryExpr(E.Col("ts"), str(op), E.Literal(lit)))
        elif kind < 0.8:
            val = f"g{int(rng.integers(0, 10))}"
            op = rng.choice([E.OP_EQ, E.OP_NOT_EQ, E.OP_REGEX_MATCH])
            lit = val if op != E.OP_REGEX_MATCH else f"^g[{int(rng.integers(0, 5))}-9]"
            leaves.append(E.BinaryExpr(E.Col("g"), str(op), E.Literal(lit)))
        else:
            # OR clause of two int leaves
            a = int(rng.integers(0, span))
            b = int(rng.integers(0, span))
            leaves.append(E.Or(E.Col("ts").lt(min(a, b)), E.Col("ts").gt_eq(max(a, b))))
    if not leaves:
        return None
    e = leaves[0]
    for leaf in leaves[1:]:
        e = E.And(e, leaf)
    return e


def random_aggs(rng):
    pool = [
        E.Sum(E.Col("v")),
        E.Count(E.Col("v")),
        E.Min(E.Col("v")),
        E.Max(E.Col("v")),
        E.Avg(E.Col("v")),
        E.Sum(E.Col("f")),
        E.Min(E.Col("f")),
        E.Max(E.Col("f")),
        E.Unique(E.Col("v")),
        E.AndAgg(E.Col("b")),
    ]
    k = int(rng.integers(1, 5))
    idx = rng.choice(len(pool), size=k, replace=False)
    return [pool[i] for i in idx]


def random_groups(rng):
    r = rng.random()
    if r < 0.4:
        return [E.Col("g")]
    if r < 0.6:
        return [E.Col("g"), E.Col("h")]
    if r < 0.8:
        return [E.Duration(int(rng.integers(1, 50)) * 1000)]
    return [E.Col("h"), E.Duration(int(rng.integers(1, 20)) * 1000)]


def encode_float(val: float) -> str:
    """A float as ``rows`` encodes it: its repr, and "/n" where its sign
    bit is set (so -0.0 and the sign of NaN show)."""
    return repr(val) + ("/n" if np.signbit(val) else "")


def rows(bs):
    out = []
    for b in bs:
        for i in range(b.num_rows):
            row = []
            for c in b.columns:
                val = c.py_value(i)
                if isinstance(val, float):
                    val = encode_float(val)
                row.append((c.name, val))
            out.append(tuple(row))
    return out


# ---------------------------------------------------------------------------
# Scenarios


@dataclasses.dataclass
class Query:
    """One query of a scenario: ``make(engine)`` builds it, ``tiers`` are
    the runs that must agree; ``float_sums`` maps each result column that
    sums a float column to that column, and ``sum_filter`` is the filter
    ahead of those sums (None: every row)."""

    text: str
    make: Callable
    tiers: tuple = ("generic", "compiled")
    float_sums: dict = dataclasses.field(default_factory=dict)
    sum_filter: object = None


def _names(exprs) -> str:
    return "[" + ", ".join(e.name() for e in exprs) + "]"


def _float_sums(aggs) -> dict:
    return {
        a.name(): a.expr.name()
        for a in aggs
        if a.func == E.AGG_SUM and a.expr.name() == "f"
    }


def aggregate_queries(rng) -> list:
    out = []
    for _q in range(3):
        filt = random_filter(rng, SPAN)
        aggs = random_aggs(rng)
        groups = random_groups(rng)

        def make(e, filt=filt, aggs=aggs, groups=groups):
            q = e.scan_table("t")
            if filt is not None:
                q = q.filter(filt)
            return q.aggregate(aggs, groups)

        text = (f"aggregate {_names(aggs)} by {_names(groups)}"
                f" where {filt.name() if filt is not None else 'true'}")
        out.append(Query(text, make, ("generic", "compiled", "mesh"), _float_sums(aggs), filt))
    return out


def scan_queries(rng) -> list:
    # filter -> project (-> limit): the compiled_scan envelope
    filt = random_filter(rng, SPAN) or E.Col("ts").gt_eq(0)
    lim = int(rng.integers(0, 50))

    def make_scan(e):
        q = e.scan_table("t").filter(filt).project(E.Col("g"), E.Col("v"), E.Col("f"))
        if lim:
            q = q.limit(E.Literal(lim))
        return q

    # aggregate -> order_by -> limit: the epilogue peel
    aggs = random_aggs(rng)
    ord_filt = E.Col("ts").gt_eq(int(rng.integers(0, SPAN)))

    def make_ord(e):
        return (
            e.scan_table("t")
            .filter(ord_filt)
            .aggregate(aggs, [E.Col("g")])
            .order_by("g")
            .limit(E.Literal(3))
        )

    return [
        Query(f"scan g, v, f where {filt.name()} limit {lim}", make_scan),
        Query(f"aggregate {_names(aggs)} by [g] where {ord_filt.name()} order by g limit 3",
              make_ord, float_sums=_float_sums(aggs), sum_filter=ord_filt),
    ]


def join_setup(rng, device, rows_scale):
    store, db = build_db(rng, device, rows_scale)
    # build side over a subset of g values, with duplicates and nulls
    dims = db.table(
        "dims",
        TableConfig(
            schema=SchemaDef(
                "dims",
                (
                    ColumnDef("g", _dict_layout()),
                    ColumnDef("w", StorageLayout(TYPE_INT64, nullable=True)),
                ),
                (SortingColumnDef("g", "asc", True),),
            )
        ),
    )
    dd = dims.dictionary("g")
    vals = [f"g{int(i)}" for i in rng.integers(0, 10, int(rng.integers(2, 12)))]
    codes, valid = dd.encode(vals)
    m = len(codes)
    wv = rng.random(m) > 0.2
    lo = -50 if rng.random() < 0.5 else 0
    dims.insert_record(
        ColumnBatch(
            [
                Column("g", KIND_DICT, codes, valid, dd),
                Column(
                    "w",
                    KIND_INT64,
                    np.where(wv, rng.integers(lo, 100, m), 0).astype(np.int64),
                    wv,
                ),
            ],
            m,
        )
    )
    return store, db


def join_queries(_rng) -> list:
    out = []
    for how in ("inner", "left_outer", "semi", "anti"):
        aggs = (
            [E.Sum(E.Col("w")), E.Count(E.Col("v")), E.Min(E.Col("w"))]
            if how in ("inner", "left_outer")
            else [E.Sum(E.Col("v")), E.Count(E.Col("v"))]
        )

        def make(e, how=how, aggs=aggs):
            return (
                e.scan_table("t")
                .join(e.scan_table("dims"), on=["g"], how=how)
                .aggregate(aggs, [E.Col("g")])
            )

        out.append(Query(f"t {how} join dims on g, aggregate {_names(aggs)} by [g]", make))
    return out


def int_join_setup(rng, device, rows_scale):
    store, db = build_db(rng, device, rows_scale)
    dims = db.table(
        "idims",
        TableConfig(
            schema=SchemaDef(
                "idims",
                (
                    ColumnDef("ts", StorageLayout(TYPE_INT64, nullable=True)),
                    ColumnDef("w", StorageLayout(TYPE_INT64, nullable=True)),
                ),
                (),
            )
        ),
    )
    m = int(rng.integers(5, 300))
    dv = rng.random(m) > 0.1
    dims.insert_record(
        ColumnBatch(
            [
                Column(
                    "ts",
                    KIND_INT64,
                    np.where(dv, rng.integers(0, 10**5, m), 0).astype(np.int64),
                    dv,
                ),
                Column(
                    "w",
                    KIND_INT64,
                    rng.integers(0, 50, m).astype(np.int64),
                    rng.random(m) > 0.2,
                ),
            ],
            m,
        )
    )
    return store, db


def int_join_queries(_rng) -> list:
    out = []
    for how in ("inner", "semi", "anti"):
        aggs = (
            [E.Sum(E.Col("w")), E.Count(E.Col("v"))] if how == "inner" else [E.Sum(E.Col("v"))]
        )

        def make(e, how=how, aggs=aggs):
            return (
                e.scan_table("t")
                .join(e.scan_table("idims"), on=["ts"], how=how)
                .aggregate(aggs, [E.Col("g")])
            )

        out.append(Query(f"t {how} join idims on ts, aggregate {_names(aggs)} by [g]", make))
    return out


@dataclasses.dataclass(frozen=True)
class Scenario:
    """``setup(rng, device, rows_scale) -> (store, db)`` draws the tables,
    then ``queries(rng)`` draws the queries, from ``default_rng(base +
    seed)`` for each of ``seeds`` seeds."""

    name: str
    base: int
    seeds: int
    setup: Callable
    queries: Callable


SCENARIOS = (
    Scenario("aggregates", 1000, 20, build_db, aggregate_queries),
    Scenario("scan and epilogue", 5000, 8, build_db, scan_queries),
    Scenario("joins", 9000, 6, join_setup, join_queries),
    Scenario("int-key joins", 13000, 4, int_join_setup, int_join_queries),
)


# ---------------------------------------------------------------------------
# Directed shapes: each forces one kernel path of its tier


def directed_setup(device):
    """Two tables of the fuzz schema, drawn from ``default_rng(42)``: ``t``
    with small values and ``tn`` with nanosecond-scale values (a wide,
    two-plane column), 3 parts of 3000 rows each."""
    rng = np.random.default_rng(42)
    store = ColumnStore(device=device)
    db = store.db("directed")
    for name, vbase, vspan in (("t", 0, 10_000), ("tn", 1_700_000_000 * 10**9, 2**40)):
        t = db.table(name, TableConfig(schema=_schema()))
        dg, dh = t.dictionary("g"), t.dictionary("h")
        for _part in range(3):
            n = 3000
            gc, gv = dg.encode([f"g{int(i)}" for i in rng.integers(0, 40, n)])
            hc, hv = dh.encode([f"h{int(i)}" for i in rng.integers(0, 3, n)])
            v = vbase + rng.integers(0, vspan, n, dtype=np.int64)
            # null slots hold 0 and bound the value span, so the wide
            # table has none
            vv = rng.random(n) > (0.1 if vbase == 0 else 0.0)
            ts = rng.integers(0, 1000, n).astype(np.int64)
            t.insert_record(
                ColumnBatch(
                    [
                        Column("g", KIND_DICT, gc, gv, dg),
                        Column("h", KIND_DICT, hc, hv, dh),
                        Column("ts", KIND_INT64, ts, np.ones(n, bool)),
                        Column("v", KIND_INT64, np.where(vv, v, 0), vv),
                    ],
                    n,
                )
            )
        t.sync()
    return store, db


def _agg_shape(table, filt, aggs):
    def make(e):
        q = e.scan_table(table)
        if filt is not None:
            q = q.filter(filt)
        return q.aggregate(aggs, [E.Col("g")])

    return make


SUM_COUNT_KERNELS = {"group_sum_count", "fused_band_group_sum_count", "fused_cmp_group_sum_count"}

# name -> (query, the tier that serves it, the kernels it launches on a
# GPU). The count-only shapes (nothing to sum: the sum/count kernel runs
# with no value plane) take any of the sum/count kernels; the others
# launch exactly their set.
DIRECTED = {
    "band_1": (
        _agg_shape("t", E.Col("ts").gt_eq(500), [E.Sum(E.Col("v")), E.Count(E.Col("v"))]),
        "compiled", {"fused_band_group_sum_count"},
    ),
    "band_3_dict_eq": (
        _agg_shape(
            "t",
            E.And(E.And(E.Col("ts").gt_eq(100), E.Col("ts").lt(800)), E.Col("h").eq("h1")),
            [E.Sum(E.Col("v"))],
        ),
        "compiled", {"fused_band_group_sum_count"},
    ),
    "int_eq": (
        _agg_shape("t", E.Col("ts").eq(77), [E.Sum(E.Col("v")), E.Count(E.Col("v"))]),
        "compiled", {"fused_cmp_group_sum_count"},
    ),
    "int_not_eq": (
        _agg_shape("t", E.Col("ts").not_eq(77), [E.Sum(E.Col("v"))]),
        "compiled", {"fused_cmp_group_sum_count"},
    ),
    "or": (
        _agg_shape(
            "t", E.Or(E.Col("ts").lt(100), E.Col("ts").gt(900)),
            [E.Sum(E.Col("v")), E.Count(E.Col("v"))],
        ),
        "compiled", {"group_sum_count"},
    ),
    "min_max": (
        _agg_shape("t", E.Col("ts").gt_eq(300), [E.Min(E.Col("v")), E.Max(E.Col("v"))]),
        "compiled", {"group_sum_count", "group_min_max"},
    ),
    "wide_max_ns": (
        _agg_shape("tn", None, [E.Max(E.Col("v")), E.Sum(E.Col("v"))]),
        "compiled", {"group_sum_count", "group_min_max"},
    ),
}
COUNT_ONLY = {
    "count_only_min_max": DIRECTED["min_max"],
    "count_only_distinct": (
        lambda e: e.scan_table("t").distinct(E.Col("g")),
        "compiled_distinct", SUM_COUNT_KERNELS,
    ),
    "count_only_distinct_band": (
        lambda e: e.scan_table("t").filter(E.Col("ts").gt_eq(500)).distinct(
            E.Col("g"), E.Col("h")),
        "compiled_distinct", SUM_COUNT_KERNELS,
    ),
    "count_only_distinct_bool_key": (
        lambda e: e.scan_table("t").distinct(E.Col("h"), E.Col("ts").gt(400)),
        "compiled_distinct", SUM_COUNT_KERNELS,
    ),
}


# ---------------------------------------------------------------------------
# Running and checking


class Mismatch(AssertionError):
    """A query whose runs disagree (or a tier or kernel check that failed)."""


@dataclasses.dataclass
class Run:
    rows: list
    path: str
    reasons: dict
    launches: dict  # kernel -> launches
    templates: dict  # "kernel[variant]" -> launches


@dataclasses.dataclass
class Stats:
    """What one fuzz run saw: queries, the tiers that served the fast and
    mesh runs, kernel launches by kernel and by template variant, the
    out-of-gate float sums that differed from the CPU's, the largest fact
    table's rows, and seconds in the cycle collector."""

    queries: int = 0
    served: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    templates: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    float_sum_cases: int = 0
    max_rows: int = 0
    collect_s: float = 0.0


def tier_options(device) -> dict:
    return {
        "generic": ExecOptions(compiled_serving=False),
        "compiled": ExecOptions(compiled_serving=True),
        "mesh": ExecOptions(mesh=make_mesh(MESH_SHARDS, device=device)),
    }


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n > before.get(k, 0)}


def run_tier(db, opts, make) -> Run:
    engine = LocalEngine(db.table_provider(), exec_options=opts)
    before, before_t = dict(AK.LAUNCHES), dict(AK.TEMPLATE_LAUNCHES)
    out = []
    make(engine).execute(out.append)
    return Run(rows(out), engine.last_serving_path, dict(engine.last_fallback_reasons),
               _delta(AK.LAUNCHES, before), _delta(AK.TEMPLATE_LAUNCHES, before_t))


def _cut(rows_list) -> str:
    shown = [repr(r) for r in rows_list[:SHOW_ROWS]]
    if len(rows_list) > SHOW_ROWS:
        shown.append(f"... ({len(rows_list)} rows)")
    return "\n    ".join(shown) or "(no rows)"


def mismatch(where: str, text: str, what: str, a_name, a, b_name, b) -> Mismatch:
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return Mismatch(
        f"{where}: {what}\n  query: {text}\n  first difference at row {first}\n"
        f"  {a_name} ({len(a)} rows):\n    {_cut(a[first:])}\n"
        f"  {b_name} ({len(b)} rows):\n    {_cut(b[first:])}"
    )


def pairwise_sum(v) -> float:
    """The generic DAG's float sum on a GPU for one group
    (``ops/kernels.ordered_segment_sum``): a binary tree over the group's
    values in stream order, rooted at the first, then + 0.0."""
    v = np.array(v, dtype=np.float64)
    s = 1
    with np.errstate(invalid="ignore", over="ignore"):
        while s < len(v):
            v[0:len(v) - s:2 * s] += v[s::2 * s]
            s *= 2
        return float((v[0] if len(v) else 0.0) + 0.0)


def tree_sum(v) -> float:
    """``pairwise_sum`` with a NaN result signed as the port signs every
    NaN float sum (``ops/kernels._nan_sign_like_reference``): as the last
    NaN input, or negative where no input is NaN (``inf + -inf``)."""
    s = pairwise_sum(v)
    if not math.isnan(s):
        return s
    nans = np.flatnonzero(np.isnan(v))
    neg = bool(np.signbit(v[nans[-1]])) if len(nans) else True
    return math.copysign(math.nan, -1.0 if neg else 1.0)


def selected_stream(db, filt) -> dict:
    """Column name -> values of the rows ``filt`` selects from ``db``'s
    table ``t``, in stream order, from the generic DAG: the group keys as
    Python values, the float column ``f`` raw (a null slot's stored
    value)."""
    engine = LocalEngine(db.table_provider(), exec_options=ExecOptions(compiled_serving=False))
    q = engine.scan_table("t")
    if filt is not None:
        q = q.filter(filt)
    out = []
    q.project(*(E.Col(c) for c in (*KEY_COLUMNS, "f"))).execute(out.append)
    cols: dict = collections.defaultdict(list)
    for b in out:
        for c in b.columns:
            if c.name in KEY_COLUMNS:
                cols[c.name].extend(c.py_value(i) for i in range(b.num_rows))
            else:
                cols[c.name].append(np.asarray(c.values))
    return {k: (np.array(v, dtype=object) if k in KEY_COLUMNS else np.concatenate(v))
            for k, v in cols.items()}


def float_sum_cases(where, q: Query, dev_rows, cpu_rows, cpu_db) -> int:
    """Holds the device's rows to the CPU's, where the only difference
    allowed is an out-of-gate float sum equal to ``tree_sum`` over its
    group's selected values in stream order. Returns how many such sums
    differed; raises Mismatch on any other difference."""
    if dev_rows == cpu_rows:
        return 0
    fail = mismatch(where, q.text, "device rows differ from the CPU's", "device", dev_rows,
                    "cpu", cpu_rows)
    if len(dev_rows) != len(cpu_rows) or not q.float_sums:
        raise fail
    stream = None
    cases = 0
    for a, b in zip(dev_rows, cpu_rows):
        if a == b:
            continue
        if [n for n, _v in a] != [n for n, _v in b]:
            raise fail
        for (name, va), (_n, vb) in zip(a, b):
            if va == vb:
                continue
            if name not in q.float_sums or not isinstance(va, str):
                raise fail
            if stream is None:
                stream = selected_stream(cpu_db, q.sum_filter)
            m = np.ones(len(stream[q.float_sums[name]]), dtype=bool)
            for key, kv in a:
                if key in KEY_COLUMNS and key in stream:
                    m &= np.array([x == kv for x in stream[key]], dtype=bool)
            want = encode_float(tree_sum(stream[q.float_sums[name]][m]))
            if va != want:
                raise Mismatch(
                    f"{where}: out-of-gate float sum {name} of group {a} is {va} on the "
                    f"device, {vb} on the CPU, {want} by the pairwise tree\n  query: {q.text}"
                )
            cases += 1
    return cases


def check_query(where, q: Query, db, opts, cpu_db, cpu_opts, stats: Stats) -> dict:
    """Runs ``q`` on every tier of ``q.tiers`` on ``db`` (and on ``cpu_db``
    when given): every tier's rows must equal the generic DAG's; the CPU's
    tiers, paths and reasons the device's, its rows up to the float-sum
    rule. Returns the device's runs by tier."""
    runs = {tier: run_tier(db, opts[tier], q.make) for tier in q.tiers}
    for tier, r in runs.items():
        if r.rows != runs["generic"].rows:
            raise mismatch(where, q.text, f"{tier} (served by {r.path}) differs from the "
                           "generic DAG", tier, r.rows, "generic", runs["generic"].rows)
    stats.queries += 1
    for tier in q.tiers[1:]:
        stats.served[runs[tier].path] += 1
    for r in runs.values():
        stats.launches.update(r.launches)
        stats.templates.update(r.templates)
    if cpu_db is not None:
        cpu = {tier: run_tier(cpu_db, cpu_opts[tier], q.make) for tier in q.tiers}
        for tier, r in cpu.items():
            if r.rows != cpu["generic"].rows:
                raise mismatch(where, q.text, f"on the CPU, {tier} differs from the generic DAG",
                               tier, r.rows, "generic", cpu["generic"].rows)
            if (r.path, r.reasons) != (runs[tier].path, runs[tier].reasons):
                raise Mismatch(
                    f"{where}: {tier} served by {runs[tier].path} ({runs[tier].reasons}) on "
                    f"the device, by {r.path} ({r.reasons}) on the CPU\n  query: {q.text}")
        stats.float_sum_cases += float_sum_cases(
            where, q, runs["generic"].rows, cpu["generic"].rows, cpu_db)
    return runs


def run_seed(scn: Scenario, seed: int, device, rows_scale: int, against_cpu: bool,
             stats: Stats) -> None:
    rng = np.random.default_rng(scn.base + seed)
    store, db = scn.setup(rng, device, rows_scale)
    cpu_store = cpu_db = None
    if against_cpu:
        cpu_store, cpu_db = scn.setup(np.random.default_rng(scn.base + seed), "cpu", rows_scale)
    opts, cpu_opts = tier_options(device), tier_options("cpu")
    stats.max_rows = max(stats.max_rows, table_rows(db, "t"))
    try:
        for i, q in enumerate(scn.queries(rng)):
            where = f"{scn.name} seed {scn.base + seed} query {i}"
            check_query(where, q, db, opts, cpu_db, cpu_opts, stats)
    finally:
        close(store, cpu_store)


def table_rows(db, name: str) -> int:
    return sum(p.num_rows() for p in db.get_table(name).collect_parts(db.high_watermark()))


def close(*stores) -> None:
    for store in stores:
        if store is not None:
            store.close()


def run_directed(device, against_cpu: bool, stats: Stats) -> None:
    """The directed shapes: each served by its tier, equal to the generic
    DAG (and to the CPU's rows), and on a GPU launching its kernels."""
    store, db = directed_setup(device)
    cpu_store = cpu_db = None
    if against_cpu:
        cpu_store, cpu_db = directed_setup("cpu")
    opts, cpu_opts = tier_options(device), tier_options("cpu")
    on_gpu = torch.device(device).type == "cuda"
    stats.max_rows = max(stats.max_rows, table_rows(db, "t"), table_rows(db, "tn"))
    try:
        for name, (make, tier, kernels) in {**DIRECTED, **COUNT_ONLY}.items():
            q = Query(name, make)
            where = f"directed {name}"
            runs = check_query(where, q, db, opts, cpu_db, cpu_opts, stats)
            fast = runs["compiled"]
            if fast.path != tier or not fast.rows:
                raise Mismatch(f"{where}: served by {fast.path} ({fast.reasons}) with "
                               f"{len(fast.rows)} rows, not by {tier}")
            if on_gpu:
                launched = set(fast.launches)
                if kernels is SUM_COUNT_KERNELS:
                    ok = bool(launched) and launched <= kernels
                else:
                    ok = launched == kernels
                if not ok:
                    raise Mismatch(f"{where}: launched {sorted(launched)}, not {sorted(kernels)}")
                if name == "wide_max_ns" and fast.launches["group_min_max"] != 3:
                    raise Mismatch(f"{where}: {fast.launches['group_min_max']} min/max "
                                   "launches, not 3 (hi plane + two lo passes)")
    finally:
        close(store, cpu_store)


def run(device="cuda", rows_scale: int = 1, extra_seeds: int = 0, against_cpu: bool = False,
        seeds: Optional[dict] = None, directed: bool = True, log=print) -> Stats:
    """Every scenario at its seeds (``seeds`` maps a scenario's name to
    how many of its seeds to run; default all, with ``extra_seeds`` more
    aggregate seeds), then the directed shapes. Prints one line per
    scenario; raises Mismatch at the first disagreement."""
    dev = resolve_device(device)
    stats = Stats()
    for scn in SCENARIOS:
        n = scn.seeds if seeds is None else seeds.get(scn.name, 0)
        if scn.name == "aggregates":
            n += extra_seeds
        if n:
            with _scenario(scn.name, stats, log):
                for seed in range(n):
                    run_seed(scn, seed, dev, rows_scale, against_cpu, stats)
                    collect(dev, stats)
    if directed:
        with _scenario("directed shapes", stats, log):
            run_directed(dev, against_cpu, stats)
        collect(dev, stats)
    return stats


def collect(dev, stats: Stats) -> None:
    """Tables and their parts refer to each other, so a closed store's
    device memory goes only when the cycle collector runs: on a GPU, run it
    before the next store is built."""
    if dev.type == "cuda":
        t0 = time.perf_counter()
        gc.collect()
        stats.collect_s += time.perf_counter() - t0


@contextlib.contextmanager
def _scenario(name, stats: Stats, log):
    """Times the body and prints its line: queries, the tiers that served
    them, launches by kernel and by template variant, seconds."""
    q0, served0, rows0 = stats.queries, stats.served.copy(), stats.max_rows
    launches0, templates0 = stats.launches.copy(), stats.templates.copy()
    stats.max_rows = 0
    t0 = time.perf_counter()
    yield
    seconds = time.perf_counter() - t0
    largest, stats.max_rows = stats.max_rows, max(rows0, stats.max_rows)
    served = dict(stats.served - served0)
    launched = dict((stats.launches - launches0) + (stats.templates - templates0))
    log(f"{name}: {stats.queries - q0} queries, served {served}, launches "
        f"{launched or 'none'}, largest table {largest} rows, "
        f"{seconds:.2f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--rows-scale", type=int, default=1,
                    help="multiplies the rows per part (200-1500 at 1)")
    ap.add_argument("--extra-seeds", type=int, default=0,
                    help="aggregate seeds run after the reference's 20")
    ap.add_argument("--against-cpu", action="store_true",
                    help="run every query on a CPU copy of the tables too")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = ""
    if dev.type == "cuda":
        AK.build()
        name = f" ({torch.cuda.get_device_name(dev)})"
    print(f"device: {dev}{name}, rows scale {args.rows_scale}", flush=True)
    t0 = time.perf_counter()
    try:
        stats = run(dev, args.rows_scale, args.extra_seeds, args.against_cpu,
                    log=lambda line: print(line, flush=True))
    except Mismatch as e:
        print(f"FAIL: {e}")
        return 1
    print(f"{stats.queries} queries in {time.perf_counter() - t0:.1f} s; "
          f"{stats.float_sum_cases} out-of-gate float sums equal to the pairwise tree")
    print("PASS: every tier agrees with the generic DAG")
    return 0


if __name__ == "__main__":
    sys.exit(main())
