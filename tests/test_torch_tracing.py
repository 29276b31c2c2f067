"""Tracing and metrics in the port against the JAX package:
tests/test_tracing_integration.py's cases run through the port
(``port_view``, with the reference's own assertions), and the same traced
query in each package must give the same rows, the same span tree (names
and nesting) with the same deterministic attributes (serving tier, plan
text, parts scanned, fallback reasons), the same ``queries_served_*``
counters, and after WAL, snapshot, compaction and rotation work the same
durability metrics and the same exposed metric names.
"""

import re

import test_differential_fuzz as FZ
import test_tracing_integration as TTI
from frostdb_tpu.metrics import MetricsRegistry as JRegistry
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.snapshot import write_snapshot as j_write_snapshot
from test_torch_engine import port_view

from frostdb_tpu_torch.metrics import MetricsRegistry as PRegistry
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.snapshot import write_snapshot as p_write_snapshot

PTI = port_view(TTI)
MODS = (TTI, PTI)
OPTIONS = {TTI: JOptions, PTI: POptions}
REGISTRY = {TTI: JRegistry, PTI: PRegistry}
WRITE_SNAPSHOT = {TTI: j_write_snapshot, PTI: p_write_snapshot}

# Attributes whose values are the same on every run (durations and byte
# sizes of a run are not compared; their keys are).
STABLE = ("path", "plan", "fallback_reasons", "parts_scanned", "table", "group")


def tree(span):
    """(name, attribute keys, stable attribute values, children)."""
    attrs = span.attributes
    return (
        span.name,
        sorted(attrs),
        {k: attrs[k] for k in STABLE if k in attrs},
        [tree(c) for c in span.children],
    )


def agg_q(eng, E):
    return eng.scan_table("t").aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")])


def filtered_agg_q(eng, E):
    return eng.scan_table("t").filter(E.Col("timestamp").gt_eq(10)).aggregate(
        [E.Sum(E.Col("value"))], [E.Col("labels.label1")]
    )


def sorted_projection_q(eng, E):
    return eng.scan_table("t").project(E.Col("value")).order_by("value")


def scan_q(eng, E):
    return eng.scan_table("t").filter(E.Col("timestamp").gt(40)).project(
        E.Col("labels.label1"), E.Col("value")
    )


def distinct_q(eng, E):
    return eng.scan_table("t").distinct(E.Col("labels.label1"))


def traced(M, queries, compiled=True):
    """Each query through module M's engine with one tracer and one
    metrics registry: per query (rows, path, reasons, span tree), then the
    counters."""
    _s, db, _t = M._mk()
    tracer, registry = M.Tracer(), REGISTRY[M]()
    eng = M.LocalEngine(
        db.table_provider(),
        OPTIONS[M](compiled_serving=compiled, tracer=tracer, metrics=registry),
    )
    got = []
    for make_q in queries:
        out = []
        make_q(eng, M.E).execute(out.append)
        got.append(
            (FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons, tree(tracer.roots[-1]))
        )
    assert len(tracer.roots) == len(queries)
    counters = {
        path: registry.counter(f"queries_served_{path}").value()
        for path in ("compiled", "compiled_scan", "compiled_distinct", "generic")
    }
    return got, counters


def both(*args, **kw):
    ref, got = (traced(M, *args, **kw) for M in MODS)
    assert got == ref
    return got


def test_query_span_tree_generic_path():
    PTI.test_query_span_tree_generic_path()
    (q,), counters = both([filtered_agg_q], compiled=False)
    assert q[1] == "generic" and counters["generic"] == 1


def test_query_span_tree_compiled_path():
    PTI.test_query_span_tree_compiled_path()
    (q,), counters = both([agg_q])
    assert q[1] == "compiled" and counters["compiled"] == 1
    assert "compiled/execute" in str(q[3])


def test_untraced_query_has_no_overhead_path():
    PTI.test_untraced_query_has_no_overhead_path()
    rows = []
    for M in MODS:
        _s, db, _t = M._mk()
        eng = M.LocalEngine(db.table_provider())
        out = []
        agg_q(eng, M.E).execute(out.append)
        rows.append((FZ.rows(out), eng.last_serving_path))
    assert rows[0] == rows[1]


def test_fallback_reasons_surfaced():
    PTI.test_fallback_reasons_surfaced()
    got, counters = both([sorted_projection_q, agg_q, scan_q, distinct_q])
    assert [q[1] for q in got] == ["generic", "compiled", "compiled_scan", "compiled_distinct"]
    assert got[0][2]["compiled"]
    assert counters == {"compiled": 1, "compiled_scan": 1, "compiled_distinct": 1, "generic": 1}


METRIC_LINE = re.compile(r"^([a-z_]+)(\{[^}]*\})? ")


def durability_work(M, root):
    store, db, table = M._mk(root)
    table.active_block.index.compact_level(0)
    WRITE_SNAPSHOT[M](db, db.snapshot_dir)
    table.rotate_block()
    m = store.metrics
    values = {
        "wal_records_logged": m.wal_records_logged.value(),
        "snapshots_total": m.snapshots_total.value(),
        "wal_truncations": m.wal_truncations.value(),
        "lsm_compactions_0": m.lsm_compactions(0).value(),
        "rotations": table.metrics.rotations.value(),
        "snapshot_bytes_positive": m.snapshot_bytes.value() > 0,
    }
    names = sorted(
        {METRIC_LINE.match(line).group(1) for line in m.expose().splitlines()
         if METRIC_LINE.match(line)}
    )
    store.close()
    return values, names


def test_durability_metrics_nonzero(tmp_path):
    PTI.test_durability_metrics_nonzero(tmp_path / "ref")
    ref, got = (durability_work(M, tmp_path / M.__name__) for M in MODS)
    assert got == ref
    assert got[0]["rotations"] == 1 and "frostdb_tpu_snapshots_total" in got[1]


def test_chip_smoke_trace_trees_are_the_reference_trees():
    """chip_smoke.py's phase 9 holds the card's span trees to TRACE_TREES;
    those are the JAX package's trees for the same two queries on the same
    table, and the port's on the CPU."""
    import chip_smoke as CS

    from frostdb_tpu_torch.db import ColumnStore

    _s, jdb, _t = TTI._mk()
    ref = {}
    for name, make_q, compiled in CS.trace_queries(TTI.E):
        tracer = TTI.Tracer()
        eng = TTI.LocalEngine(jdb.table_provider(), JOptions(compiled_serving=compiled, tracer=tracer))
        out = []
        make_q(eng).execute(out.append)
        ref[name] = (CS.as_rows(out), eng.last_serving_path, CS.span_names(tracer.roots[0]))
    db = ColumnStore(device="cpu").db("tr")
    CS.trace_table(db)
    got, served = CS.traced_run(db)
    assert {name: (rows, path, tree) for name, rows, path, tree, _a in got} == ref
    assert {name: tree for name, (_r, _p, tree) in ref.items()} == CS.TRACE_TREES
    assert served == {"compiled": 1, "generic": 1}
