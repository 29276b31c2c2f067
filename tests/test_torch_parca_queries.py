"""Parca's query shapes (Types, Labels, Values, Merge, Range) in the port
against the JAX package: tests/test_parca_queries.py's cases run through
the port (``port_view``, with the reference's own assertions), and each
query, built by the reference module's ``_setup`` in each package, must
give the same rows in the same order, the same serving tier and the same
decline reasons, with the compiled tiers on and off.
"""

import pytest

import test_differential_fuzz as FZ
import test_parca_queries as TPQ
from frostdb_tpu.query.physical import ExecOptions as JOptions
from test_torch_engine import port_view

from frostdb_tpu_torch.query.physical import ExecOptions as POptions

PPQ = port_view(TPQ)
OPTIONS = {TPQ: JOptions, PPQ: POptions}


def types_q(eng, E):
    return eng.scan_table("stacktraces").distinct(E.Col("example_type"), E.Col("value").gt(6))


def labels_q(eng, E):
    return eng.scan_schema("stacktraces").distinct(E.Col("name")).filter(
        E.Col("name").regex_match(r"^labels\..+$")
    )


def values_q(eng, E):
    return eng.scan_table("stacktraces").distinct(E.Col("labels.node"))


def merge_q(eng, E):
    return eng.scan_table("stacktraces").filter(
        E.And(
            E.Col("example_type").eq("cpu"),
            E.Col("timestamp").gt(9),
            E.Col("timestamp").lt(13),
        )
    ).aggregate([E.Sum(E.Col("value"))], [E.Col("stacktrace")])


def range_q(eng, E):
    return eng.scan_table("stacktraces").filter(E.Col("example_type").eq("cpu")).aggregate(
        [E.Sum(E.Col("value"))], [E.DynCol("labels"), E.Col("timestamp")]
    )


QUERIES = {
    "types": (types_q, "test_types_query"),
    "labels": (labels_q, "test_labels_query_schema_scan"),
    "values": (values_q, "test_values_query"),
    "merge": (merge_q, "test_merge_query"),
    "range": (range_q, "test_range_query"),
}


def run(M, make_q, compiled):
    _s, db, _engine = M._setup()
    eng = M.LocalEngine(db.table_provider(), OPTIONS[M](compiled_serving=compiled))
    out = []
    make_q(eng, M.E).execute(out.append)
    return FZ.rows(out), [b.num_rows for b in out], eng.last_serving_path, eng.last_fallback_reasons


@pytest.mark.parametrize("compiled", [True, False])
@pytest.mark.parametrize("name", list(QUERIES))
def test_parca_query(name, compiled):
    make_q, reference_test = QUERIES[name]
    getattr(PPQ, reference_test)()
    ref, got = run(TPQ, make_q, compiled), run(PPQ, make_q, compiled)
    assert got == ref
    assert got[0], name
