"""Part pruning in the port (``frostdb_tpu_torch/lsm.py``'s ``prune_part``
and the engine's min/max push-down) against the JAX package:
tests/test_pruning.py's scenarios run through both packages (the port
through ``port_view``, with the reference's own assertions), and each query
must give the same rows, the same serving tier and reasons, and the same
``parts_pruned`` / ``parts_scanned`` counters: as the reference writes it
(a global aggregate, which the generic DAG serves), and grouped by
``example_type`` with the compiled tiers on (the ``compiled`` tier prunes
before any device work) and off. The fuzz case holds the two packages'
``prune_part`` decisions equal part by part and predicate by predicate.
"""

import numpy as np
import pytest

import test_differential_fuzz as FZ
import test_pruning as TP
from frostdb_tpu.query.physeval import filter_mask as j_filter_mask
from frostdb_tpu.query.physical import ExecOptions as JOptions
from test_torch_engine import port_view

from frostdb_tpu_torch.query.physeval import filter_mask as p_filter_mask
from frostdb_tpu_torch.query.physical import ExecOptions as POptions

PP = port_view(TP)
MODS = (TP, PP)
OPTIONS = {TP: JOptions, PP: POptions}
FILTER_MASK = {TP: j_filter_mask, PP: p_filter_mask}


def counters(table):
    m = table.metrics
    return (m.parts_pruned.value(), m.parts_scanned.value())


# variant -> (group by example_type, compiled tiers on)
VARIANTS = {"global": (False, True), "grouped": (True, True), "grouped_generic": (True, False)}


def query(M, db, table, flt, aggs, variant):
    """Rows, serving tier, reasons and the table's counters after one
    ``filter(flt).aggregate(aggs, groups)`` query of module M's package."""
    grouped, compiled = VARIANTS[variant]
    eng = M.LocalEngine(db.table_provider(), OPTIONS[M](compiled_serving=compiled))
    q = eng.scan_table("t")
    if flt is not None:
        q = q.filter(flt)
    out = []
    q.aggregate(aggs, [M.E.Col("example_type")] if grouped else []).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons, counters(table)


def parity(scenario, variant):
    """``scenario(M, variant)`` for the reference module and its port
    view; the two must return the same list."""
    got = [scenario(M, variant) for M in MODS]
    assert got[0] == got[1]
    path = {"global": "generic", "grouped": "compiled", "grouped_generic": "generic"}[variant]
    assert {r[1] for r in got[1]} == {path}
    return got[1]


def _sum(E):
    return [E.Sum(E.Col("value"))]


def label_equality(M, variant):
    _s, db, table = M._mk_table()
    for i in range(8):
        M._insert_label_part(table, f"l{i}", [i + 1] * 10, ts0=i * 10)
    E = M.E
    return [
        query(M, db, table, E.Col("labels.label1").eq(lit), _sum(E), variant)
        for lit in ("l3", "nope", "l7")
    ]


def regex(M, variant):
    _s, db, table = M._mk_table()
    for i in range(6):
        M._insert_label_part(table, f"env{i}", [1] * 5, ts0=i * 5)
    E = M.E
    return [
        query(M, db, table, E.Col("labels.label1").regex_match(p), _sum(E), variant)
        for p in ("env[01]$", "^env5", "zzz")
    ]


def missing_dyncol(M, variant):
    _s, db, table = M._mk_table()
    M._insert_label_part(table, "x", [5] * 4)
    n = 3
    d_et = table.dictionary("example_type")
    d_st = table.dictionary("stacktrace")
    ones = np.ones(n, dtype=bool)
    table.insert_record(
        M.ColumnBatch(
            [
                M.Column("example_type", M.KIND_DICT, *d_et.encode(["cpu"] * n), d_et),
                M.Column("stacktrace", M.KIND_DICT, *d_st.encode(["s"] * n), d_st),
                M.Column("timestamp", M.KIND_INT64, np.arange(100, 100 + n, dtype=np.int64), ones),
                M.Column("value", M.KIND_INT64, np.full(n, 7, dtype=np.int64), ones),
            ],
            n,
        ),
        sort=True,
    )
    E, col = M.E, M.E.Col("labels.label1")
    return [
        query(M, db, table, f, _sum(E), variant)
        for f in (col.eq("x"), col.regex_match(".*"), col.regex_match("^x$"), col.eq(""))
    ]


def pushdown(M, variant):
    _s, db, table = M._mk_table()
    for i in range(6):
        M._insert_label_part(table, "x", list(range(i * 100, i * 100 + 10)), ts0=i * 10)
    E, v = M.E, M.E.Col("value")
    return [
        query(M, db, table, None, [agg], variant)
        for agg in (E.Max(v), E.Min(v), E.Sum(v), E.Count(v))
    ]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_label_equality_prunes_parts(variant):
    PP.test_label_equality_prunes_parts()
    got = parity(label_equality, variant)
    assert [r[3][0] for r in got] == [7, 15, 22]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_regex_prunes_parts(variant):
    PP.test_regex_prunes_parts()
    got = parity(regex, variant)
    assert [r[3][0] for r in got] == [4, 9, 15]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_missing_dyncol_semantics_preserved(variant):
    PP.test_missing_dyncol_semantics_preserved()
    parity(missing_dyncol, variant)


def test_prune_part_parity_fuzz():
    """Both packages' prune_part, on the same random parts (built from the
    same seed in each package), decide alike for every predicate; neither
    prunes a part with a matching row."""
    PP.test_prune_part_parity_fuzz()
    decisions = []
    for M in MODS:
        rng = np.random.default_rng(5)
        _s, db, table = M._mk_table()
        d_l = table.dictionary("labels")
        labels = [f"v{i}" for i in range(12)]
        parts = []
        for _ in range(20):
            n = int(rng.integers(1, 30))
            lv, lvv = d_l.encode([labels[int(rng.integers(0, 12))] for _ in range(n)])
            lvv = lvv & (rng.random(n) > 0.2)
            ones = np.ones(n, dtype=bool)
            batch = M.ColumnBatch(
                [
                    M.Column("labels.label1", M.KIND_DICT, lv, lvv, d_l),
                    M.Column("value", M.KIND_INT64, rng.integers(-50, 50, n).astype(np.int64), ones),
                ],
                n,
            )
            tx = table.insert_record(batch)
            parts.append(table.active_block.index.scan(tx)[0])
        E, col = M.E, M.E.Col("labels.label1")
        preds = [
            col.eq("v3"), col.eq("absent"), col.regex_match("v[0-2]"),
            col.regex_not_match("v.*"), E.And(col.eq("v1"), E.Col("value").gt(0)),
            E.Or(col.eq("v1"), E.Col("value").gt(1000)), col.gt("v8"),
            E.Col("value").lt_eq(-51), col.not_eq("v4"), E.Col("value").gt_eq(49),
        ]
        memo: dict = {}
        got = []
        for pred in preds:
            row = []
            for part in parts:
                pruned = bool(M.prune_part(part, pred, memo))
                if pruned:
                    assert not FILTER_MASK[M](part.batch, pred).any(), pred
                row.append(pruned)
            got.append(row)
        decisions.append(got)
    assert decisions[0] == decisions[1]
    assert any(any(r) for r in decisions[1]) and not all(all(r) for r in decisions[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_agg_pushdown_minmax_skips_parts(variant):
    PP.test_agg_pushdown_minmax_skips_parts()
    got = parity(pushdown, variant)
    pruned = [r[3][0] for r in got]
    # The push-down skips parts of a global max only.
    skipped = [5, 0, 0, 0] if variant == "global" else [0, 0, 0, 0]
    assert [b - a for a, b in zip([0] + pruned, pruned)] == skipped
