"""Tracing and metrics in the port against the JAX package:
tests/test_tracing_integration.py's cases run through the port
(``port_view``, with the reference's own assertions), and the same traced
query in each package must give the same rows, the same span tree (names
and nesting) with the same deterministic attributes (serving tier, plan
text, parts scanned, fallback reasons), the same ``queries_served_*``
counters, and after WAL, snapshot, compaction and rotation work the same
durability metrics and the same exposed metric names.

The port's trees pass through ``reference_view`` first: it drops the spans
and attribute keys only the port emits (tracing.PORT_ONLY_SPANS, lifting
their children, and PORT_ONLY_KEYS) and renames the port's tier spans to
the reference's ``compiled/execute``. Everything the reference emits is
still compared exactly, and a span the port adds without listing it fails.
The port's own trees, with every attribute, are pinned per serving tier
below (TIER_TREES), with the clock the spans share with torch.profiler.
"""

import re
import time

import numpy as np
import pytest

import test_differential_fuzz as FZ
import test_tracing_integration as TTI
from frostdb_tpu.metrics import MetricsRegistry as JRegistry
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.snapshot import write_snapshot as j_write_snapshot
from test_torch_engine import port_view

from frostdb_tpu_torch import compiled as PC
from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu_torch.db import ColumnStore
from frostdb_tpu_torch.metrics import MetricsRegistry as PRegistry
from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.schema import sample_definition
from frostdb_tpu_torch.snapshot import write_snapshot as p_write_snapshot
from frostdb_tpu_torch.table import TableConfig
from frostdb_tpu_torch.tracing import PORT_ONLY_KEYS, PORT_ONLY_SPANS, REFERENCE_TIER_SPAN, Tracer

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


def reference_view(span) -> list:
    """A port span as ``tree`` gives the reference's: port-only spans
    dropped with their children lifted, port-only keys dropped, tier spans
    renamed. A list: the span's tree, or a dropped span's children's."""
    children = [t for c in span.children for t in reference_view(c)]
    if span.name in PORT_ONLY_SPANS:
        return children
    drop = PORT_ONLY_KEYS.get(span.name, ())
    attrs = {k: v for k, v in span.attributes.items() if k not in drop}
    return [(
        REFERENCE_TIER_SPAN.get(span.name, span.name),
        sorted(attrs),
        {k: attrs[k] for k in STABLE if k in attrs},
        children,
    )]


def compared_tree(M, span):
    if M is TTI:
        return tree(span)
    (t,) = reference_view(span)
    return t


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
            (FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons,
             compared_tree(M, tracer.roots[-1]))
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


# ---------------------------------------------------------------------------
# The port's own trees: every span and attribute, per serving tier.


def tier_table(db):
    """Two sorted inserts of 1,500 rows (timestamps 0-2999, one stack per
    row, three labels): two parts, so a time filter prunes one."""
    t = db.table("t", TableConfig(schema=sample_definition()))
    d_et, d_l, d_st = (t.dictionary(f) for f in ("example_type", "labels", "stacktrace"))
    n = 1500
    ones = np.ones(n, dtype=bool)
    for lo in (0, n):
        t.insert_record(ColumnBatch([
            Column("example_type", KIND_DICT, *d_et.encode(["cpu"] * n), d_et),
            Column("labels.label1", KIND_DICT, *d_l.encode([f"l{i % 3}" for i in range(n)]), d_l),
            Column("stacktrace", KIND_DICT, *d_st.encode([f"s{lo + i}" for i in range(n)]), d_st),
            Column("timestamp", KIND_INT64, np.arange(lo, lo + n, dtype=np.int64), ones),
            Column("value", KIND_INT64, np.ones(n, dtype=np.int64), ones),
        ], n), sort=True)


TIER_QUERIES = {
    "compiled": lambda e: e.scan_table("t").filter(PE.Col("timestamp").gt_eq(2000)).aggregate(
        [PE.Sum(PE.Col("value"))], [PE.Col("labels.label1")]),
    "compiled_distinct": lambda e: e.scan_table("t").distinct(PE.Col("labels.label1")),
    # 3,000 stacks: past the compiled tier's 2,048 codes, on the dense
    # tier's segment route.
    "dense": lambda e: e.scan_table("t").aggregate([PE.Sum(PE.Col("value"))], [PE.Col("stacktrace")]),
    "compiled_scan": lambda e: e.scan_table("t").filter(PE.Col("timestamp").gt(2990)).project(
        PE.Col("value")),
    "schema_meta": lambda e: e.scan_schema("t").distinct(PE.Col("name")),
    "generic": lambda e: e.scan_table("t").project(PE.Col("value")).order_by("value"),
}

COUNTERS = ("planes_built_total", "programs_built_total", "scan_blocks_refiltered_total")


def port_tree(span):
    """(name, attributes but the drawn plan[, children])."""
    attrs = {k: v for k, v in span.attributes.items() if k != "plan"}
    return (span.name, attrs, [port_tree(c) for c in span.children]) if span.children else (
        span.name, attrs)


def names(span):
    return (span.name, [names(c) for c in span.children])


def counted(registry) -> dict:
    """The registry's serving counters that moved: served, declined, built."""
    out = {}
    for line in registry.expose().splitlines():
        name, value = line.split()
        if name.startswith(("queries_served_", "queries_declined_")) or name in COUNTERS:
            out[name] = float(value)
    return out


# Per tier: the first query's tree (cache misses: the superpart, its
# planes, the fused program) and the second's names (caches hit; the
# per-query LUTs and remaps are built again).
TIER_TREES = {'compiled': (('query/execute',
                            {'path': 'compiled', 'query': 0},
                            [('plan/optimize', {}),
                             ('compiled/lower', {}),
                             ('compiled/execute',
                              {'group': 'labels.label1', 'parts': 1, 'parts_pruned': 1, 'table': 't'},
                              [('groups/remap', {'codes': 3}),
                               ('planes/build', {'bytes': 0, 'kind': 'superpart'}),
                               ('program/build',
                                {'structure': "groups ['dict'], 1 clauses, 1 value plans, K 3, cmp ('band', "
                                              "('>=',))"}),
                               ('planes/build', {'bytes': 8192, 'kind': 'codes'}),
                               ('planes/build',
                                {'bytes': 8192, 'kind': 'cmpmask'},
                                [('planes/build',
                                  {'bytes': 8192, 'kind': 'basesel'},
                                  [('planes/build', {'bytes': 8192, 'kind': 'rowvalid'}),
                                   ('planes/build', {'bytes': 8192, 'kind': 'valid'})]),
                                 ('planes/build', {'bytes': 8192, 'kind': 'valid'}),
                                 ('planes/build',
                                  {'bytes': 8192, 'kind': 'i32m'},
                                  [('planes/build', {'bytes': 16384, 'kind': 'int64_m'})])]),
                               ('planes/build',
                                {'bytes': 8192, 'kind': 'vi32'},
                                [('planes/build', {'bytes': 16384, 'kind': 'int64'})]),
                               ('result/copy', {'bytes': 72}),
                               ('result/epilogue', {'rows': 3})])]),
                           ('query/execute',
                            [('plan/optimize', []),
                             ('compiled/lower', []),
                             ('compiled/execute',
                              [('groups/remap', []), ('result/copy', []), ('result/epilogue', [])])])),
              'compiled_distinct': (('query/execute',
                                     {'fallback_reasons': {'compiled': 'root is not an aggregation',
                                                           'compiled_join': 'root is not an aggregation',
                                                           'dense': 'root is not an aggregation'},
                                      'path': 'compiled_distinct',
                                      'query': 0},
                                     [('plan/optimize', {}),
                                      ('compiled/lower', {'declined': 'root is not an aggregation'}),
                                      ('compiled_join/lower', {'declined': 'root is not an aggregation'}),
                                      ('dense/lower', {'declined': 'root is not an aggregation'}),
                                      ('compiled_distinct/lower', {}),
                                      ('compiled_distinct/execute',
                                       {'group': 'labels.label1', 'parts': 2, 'parts_pruned': 0, 'table': 't'},
                                       [('groups/remap', {'codes': 3}),
                                        ('planes/build', {'bytes': 0, 'kind': 'superpart'}),
                                        ('program/build',
                                         {'structure': "groups ['dict'], 0 clauses, 0 value plans, K 3, cmp "
                                                       'None'}),
                                        ('planes/build', {'bytes': 16384, 'kind': 'codes'}),
                                        ('planes/build',
                                         {'bytes': 16384, 'kind': 'basesel'},
                                         [('planes/build', {'bytes': 16384, 'kind': 'rowvalid'}),
                                          ('planes/build', {'bytes': 16384, 'kind': 'valid'})]),
                                        ('result/copy', {'bytes': 48}),
                                        ('result/epilogue', {'rows': 3})])]),
                                    ('query/execute',
                                     [('plan/optimize', []),
                                      ('compiled/lower', []),
                                      ('compiled_join/lower', []),
                                      ('dense/lower', []),
                                      ('compiled_distinct/lower', []),
                                      ('compiled_distinct/execute',
                                       [('groups/remap', []), ('result/copy', []), ('result/epilogue', [])])])),
              'compiled_scan': (('query/execute',
                                 {'fallback_reasons': {'compiled': 'root is not an aggregation',
                                                       'compiled_distinct': 'root is not a distinct',
                                                       'compiled_join': 'root is not an aggregation',
                                                       'dense': 'root is not an aggregation',
                                                       'schema_meta': 'schema tier serves distinct+filters '
                                                                      'only'},
                                  'path': 'compiled_scan',
                                  'query': 0},
                                 [('plan/optimize', {}),
                                  ('compiled/lower', {'declined': 'root is not an aggregation'}),
                                  ('compiled_join/lower', {'declined': 'root is not an aggregation'}),
                                  ('dense/lower', {'declined': 'root is not an aggregation'}),
                                  ('compiled_distinct/lower', {'declined': 'root is not a distinct'}),
                                  ('schema_meta/lower',
                                   {'declined': 'schema tier serves distinct+filters only'}),
                                  ('compiled_scan/lower', {}),
                                  ('compiled_scan/execute',
                                   {'parts': 1, 'parts_pruned': 1, 'table': 't'},
                                   [('planes/build', {'bytes': 0, 'kind': 'superpart'}),
                                    ('scan/blocks',
                                     {'blocks': 1, 'capb': 16, 'dispatches': 1, 'refiltered': 0},
                                     [('planes/build', {'bytes': 8192, 'kind': 'rowvalid'}),
                                      ('planes/build',
                                       {'bytes': 8192, 'kind': 'i32m'},
                                       [('planes/build', {'bytes': 16384, 'kind': 'int64_m'})]),
                                      ('planes/build', {'bytes': 8192, 'kind': 'valid_m'}),
                                      ('planes/build', {'bytes': 8192, 'kind': 'has'}),
                                      ('result/copy', {'bytes': 68})]),
                                    ('result/epilogue', {'rows': 9})])]),
                                ('query/execute',
                                 [('plan/optimize', []),
                                  ('compiled/lower', []),
                                  ('compiled_join/lower', []),
                                  ('dense/lower', []),
                                  ('compiled_distinct/lower', []),
                                  ('schema_meta/lower', []),
                                  ('compiled_scan/lower', []),
                                  ('compiled_scan/execute',
                                   [('scan/blocks', [('result/copy', [])]), ('result/epilogue', [])])])),
              'dense': (('query/execute',
                         {'fallback_reasons': {'compiled': 'group code space 3000 > 2048',
                                               'compiled_join': 'no join below the aggregation'},
                          'path': 'dense',
                          'query': 0},
                         [('plan/optimize', {}),
                          ('compiled/lower', {}),
                          ('compiled/execute',
                           {'declined': 'group code space 3000 > 2048',
                            'group': 'stacktrace',
                            'parts': 2,
                            'parts_pruned': 0,
                            'table': 't'},
                           [('groups/remap', {'codes': 3000, 'declined': 'group code space 3000 > 2048'})]),
                          ('compiled_join/lower', {'declined': 'no join below the aggregation'}),
                          ('dense/lower', {}),
                          ('dense/execute',
                           {'group': 'stacktrace', 'parts': 2, 'parts_pruned': 0, 'table': 't'},
                           [('groups/remap', {'codes': 3000}),
                            ('dense/parts',
                             {'parts': 2, 'route': 'segment'},
                             [('planes/build', {'bytes': 12000, 'kind': 'remap'})]),
                            ('result/copy', {'bytes': 72000}),
                            ('result/epilogue', {'order': 'device', 'rows': 3000})])]),
                        ('query/execute',
                         [('plan/optimize', []),
                          ('compiled/lower', []),
                          ('compiled/execute', [('groups/remap', [])]),
                          ('compiled_join/lower', []),
                          ('dense/lower', []),
                          ('dense/execute',
                           [('groups/remap', []),
                            ('dense/parts', [('planes/build', [])]),
                            ('result/copy', []),
                            ('result/epilogue', [])])])),
              'generic': (('query/execute',
                           {'fallback_reasons': {'compiled': 'root is not an aggregation',
                                                 'compiled_distinct': 'root is not a distinct',
                                                 'compiled_join': 'root is not an aggregation',
                                                 'compiled_scan': 'unfiltered scan (generic path)',
                                                 'dense': 'root is not an aggregation',
                                                 'schema_meta': 'schema tier serves distinct+filters only'},
                            'path': 'generic',
                            'query': 0},
                           [('plan/optimize', {}),
                            ('compiled/lower', {'declined': 'root is not an aggregation'}),
                            ('compiled_join/lower', {'declined': 'root is not an aggregation'}),
                            ('dense/lower', {'declined': 'root is not an aggregation'}),
                            ('compiled_distinct/lower', {'declined': 'root is not a distinct'}),
                            ('schema_meta/lower', {'declined': 'schema tier serves distinct+filters only'}),
                            ('compiled_scan/lower', {'declined': 'unfiltered scan (generic path)'}),
                            ('physical/build', {}),
                            ('physical/execute',
                             {},
                             [('table/iterator',
                               {'parts_pruned': 0, 'parts_scanned': 2, 'table': 't', 'tx': 3})])]),
                          ('query/execute',
                           [('plan/optimize', []),
                            ('compiled/lower', []),
                            ('compiled_join/lower', []),
                            ('dense/lower', []),
                            ('compiled_distinct/lower', []),
                            ('schema_meta/lower', []),
                            ('compiled_scan/lower', []),
                            ('physical/build', []),
                            ('physical/execute', [('table/iterator', [])])])),
              'schema_meta': (('query/execute',
                               {'fallback_reasons': {'compiled': 'root is not an aggregation',
                                                     'compiled_distinct': 'input is not a plain table scan',
                                                     'compiled_join': 'root is not an aggregation',
                                                     'dense': 'root is not an aggregation'},
                                'path': 'schema_meta',
                                'query': 0},
                               [('plan/optimize', {}),
                                ('compiled/lower', {'declined': 'root is not an aggregation'}),
                                ('compiled_join/lower', {'declined': 'root is not an aggregation'}),
                                ('dense/lower', {'declined': 'root is not an aggregation'}),
                                ('compiled_distinct/lower', {'declined': 'input is not a plain table scan'}),
                                ('schema_meta/lower', {}),
                                ('schema_meta/execute', {'table': 't'})]),
                              ('query/execute',
                               [('plan/optimize', []),
                                ('compiled/lower', []),
                                ('compiled_join/lower', []),
                                ('dense/lower', []),
                                ('compiled_distinct/lower', []),
                                ('schema_meta/lower', []),
                                ('schema_meta/execute', [])]))}

# Per tier, the counters after both queries.
TIER_COUNTERS = {
    "compiled": {"planes_built_total": 11, "programs_built_total": 1,
                 "queries_served_compiled": 2},
    "compiled_distinct": {"planes_built_total": 5, "programs_built_total": 1,
                          "queries_declined_compiled": 2, "queries_declined_compiled_join": 2,
                          "queries_declined_dense": 2, "queries_served_compiled_distinct": 2},
    "dense": {"planes_built_total": 2, "queries_declined_compiled": 2,
              "queries_declined_compiled_join": 2, "queries_served_dense": 2},
    "compiled_scan": {"planes_built_total": 6, "queries_declined_compiled": 2,
                      "queries_declined_compiled_distinct": 2, "queries_declined_compiled_join": 2,
                      "queries_declined_dense": 2, "queries_declined_schema_meta": 2,
                      "queries_served_compiled_scan": 2},
    "schema_meta": {"queries_declined_compiled": 2, "queries_declined_compiled_distinct": 2,
                    "queries_declined_compiled_join": 2, "queries_declined_dense": 2,
                    "queries_served_schema_meta": 2},
    "generic": {"queries_declined_compiled": 2, "queries_declined_compiled_distinct": 2,
                "queries_declined_compiled_join": 2, "queries_declined_compiled_scan": 2,
                "queries_declined_dense": 2, "queries_declined_schema_meta": 2,
                "queries_served_generic": 2},
}


def run_tier(tier, tracer, monkeypatch):
    """Two runs of the tier's query on a fresh table and a fresh fused
    program cache; returns (paths, counters)."""
    monkeypatch.setattr(PC, "_FUSED_CACHE", {})
    db = ColumnStore(device="cpu").db("tr")
    tier_table(db)
    registry = PRegistry()
    eng = PEngine(db.table_provider(), POptions(tracer=tracer, metrics=registry))
    paths = []
    for _ in range(2):
        TIER_QUERIES[tier](eng).execute(lambda b: None)
        paths.append(eng.last_serving_path)
    return paths, counted(registry)


@pytest.mark.parametrize("tier", sorted(TIER_QUERIES))
def test_port_span_tree_of_each_tier(tier, monkeypatch):
    tracer = Tracer()
    paths, counters = run_tier(tier, tracer, monkeypatch)
    assert paths == [tier, tier]
    first, second = tracer.roots
    assert (port_tree(first), names(second)) == TIER_TREES[tier]
    assert counters == TIER_COUNTERS[tier]
    # The same counters without a tracer: a registry alone counts.
    assert run_tier(tier, None, monkeypatch)[1] == counters


def test_shuffle_route_orders_on_the_host(monkeypatch):
    """The dense tier's shuffle route keeps its host emission order: no
    ``order`` on its epilogue span, with the same rows as the dense route
    over the same table, and the group remap built once."""
    from frostdb_tpu_torch.parallel import mesh_exec as ME

    rows = {}
    for route in ("segment", "shuffle"):
        if route == "shuffle":
            # 3,000 stacks past the tier's code ceiling: the shuffle route
            monkeypatch.setattr(ME.DenseLocalAggregate, "MAX_CODES", 2048)
        tracer = Tracer()
        out = []
        db = ColumnStore(device="cpu").db("tr")
        tier_table(db)
        eng = PEngine(db.table_provider(), POptions(tracer=tracer))
        TIER_QUERIES["dense"](eng).execute(out.append)
        assert eng.last_serving_path == "dense"
        (root,) = tracer.roots
        (dense,) = [c for c in root.children if c.name == "dense/execute"]
        parts, epilogue = (
            next(c for c in dense.children if c.name == name)
            for name in ("dense/parts", "result/epilogue")
        )
        rows[route] = FZ.rows(out)
        assert parts.attributes["route"] == route
        assert [c.name for c in dense.children].count("groups/remap") == 1
        if route == "shuffle":
            assert "order" not in epilogue.attributes
        else:
            assert epilogue.attributes["order"] == "device"
    assert rows["shuffle"] == rows["segment"]
    assert len(rows["shuffle"]) == 3000


@pytest.mark.parametrize("route", ["segment", "sorted", "table"])
def test_dense_segment_fused_counts_each_segment_route_part(route, monkeypatch):
    """The ``dense/parts`` span names the route and counts the parts: the
    tier table's two parts on the segment route (3,000 stacks), whose
    counts, first rows and sums take one ``dense_segment_sum_count`` call
    a part (K7 on the card); past the segment route's threshold, on the
    table route, one ``dense_table_sum_count`` call a part (K8 on the
    card) for the sum, or, with a min beside it, on the sorted route,
    which calls neither; the same rows on every route."""
    from frostdb_tpu_torch.parallel import mesh_exec as ME

    if route != "segment":
        # 3,000 stacks past the segment route's threshold
        monkeypatch.setattr(ME, "_SORTED_THRESHOLD", 2048)
    calls = {"dense_segment_sum_count": [], "dense_table_sum_count": []}
    for name, seen in calls.items():
        one_pass = getattr(ME.AK, name)
        monkeypatch.setattr(ME.AK, name,
                            lambda *a, f=one_pass, seen=seen: seen.append(a[-1]) or f(*a))
    tracer = Tracer()
    db = ColumnStore(device="cpu").db("tr")
    tier_table(db)
    eng = PEngine(db.table_provider(), POptions(tracer=tracer))
    out = []
    aggs = [PE.Sum(PE.Col("value"))] + ([PE.Min(PE.Col("value"))] if route == "sorted" else [])
    eng.scan_table("t").aggregate(aggs, [PE.Col("stacktrace")]).execute(out.append)
    assert eng.last_serving_path == "dense"
    (root,) = tracer.roots
    (dense,) = [c for c in root.children if c.name == "dense/execute"]
    parts = next(c for c in dense.children if c.name == "dense/parts")
    assert (parts.attributes["route"], parts.attributes["parts"]) == (route, 2)
    assert calls == {
        "dense_segment_sum_count": [3000, 3000] if route == "segment" else [],
        "dense_table_sum_count": [3000, 3000] if route == "table" else [],
    }
    assert [r[1] for r in FZ.rows(out)] == [("sum(value)", 1)] * 3000


def test_reference_view_keeps_an_unlisted_span():
    """A span the port adds without listing it stays in the compared tree,
    so the comparison with the reference fails until it is listed."""
    tracer = Tracer()
    with tracer.span("query/execute", query=0):
        with tracer.span("dense/execute", table="t", parts=1, parts_pruned=0):
            with tracer.span("groups/remap", codes=3):
                with tracer.span("unlisted/work"):
                    pass
    (root,) = tracer.roots
    assert reference_view(root) == [("query/execute", [], {}, [
        ("compiled/execute", ["table"], {"table": "t"}, [("unlisted/work", [], {}, [])])])]


def test_span_clock_is_the_profilers():
    """A span's start and end lie within 1 ms of its record_function
    event's in torch.profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("clock/probe"):
            time.sleep(0.005)
    (s,) = tracer.roots
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock/probe"]
    assert abs(e.start_ns() - s.start_ns) < 1_000_000
    assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000
    assert s.duration == (s.end_ns - s.start_ns) / 1e9 >= 0.005
