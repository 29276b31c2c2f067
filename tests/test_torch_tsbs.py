"""TSBS devops (gpubench's ``tsbs_devops`` configuration) on the port, cut to
40 hosts and 3 hours with the real schema and all ten fields: every shape
of the ``tsbs_queries`` mix goes through LocalEngine on the CPU, equals the
plain numpy reference (``gpubench/reference/numpy_ref.py``) over the same
rows and the port's generic DAG row for row, and is served by the tier the
mix names. The compiled tier's min/max passes open ``compiled/minmax`` and
count ``minmax_passes_total``, one per K3 launch.

At 4,000 hosts ``double_groupby_all`` groups 4,000 hosts x 16 hours (12
held, padded to a power of two) = 64,000 codes: past the compiled tier's
2,048 and past the dense tier's segment route's 4,096, so the dense tier
serves it on its sorted route. The cut table has 40 x 4 codes; the tests
cut both ceilings to 128 so that the same tier and route serve it."""

import os
import sys

import pytest

GPUBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gpubench")
for _p in (GPUBENCH, os.path.join(GPUBENCH, "tests")):
    if _p not in sys.path:
        sys.path.append(_p)

import tsbs_cut  # noqa: E402
from harness import client, datagen, judge, spec  # noqa: E402
from reference import numpy_ref  # noqa: E402

from frostdb_tpu_torch import compiled as PC  # noqa: E402
from frostdb_tpu_torch.db import ColumnStore  # noqa: E402
from frostdb_tpu_torch.metrics import MetricsRegistry  # noqa: E402
from frostdb_tpu_torch.parallel import mesh_exec as ME  # noqa: E402
from frostdb_tpu_torch.query.engine import LocalEngine  # noqa: E402
from frostdb_tpu_torch.query.physical import ExecOptions  # noqa: E402
from frostdb_tpu_torch.schema import TSBS_CPU_FIELDS, tsbs_cpu_definition  # noqa: E402
from frostdb_tpu_torch.tracing import Tracer  # noqa: E402

HOSTS, HOURS = 40, 3
SEED = 2**33 + 16
QUERIES_PER_SHAPE = 3
_BENCH, _CELL, CONFIG, MIX = tsbs_cut.cut(HOSTS, HOURS)
SHAPES = list(MIX["cycle"])


@pytest.fixture(scope="module")
def cut_table():
    """(rows, db): the cut table, synced, on a CPU store."""
    rows = datagen.generate(CONFIG, SEED)
    db = ColumnStore(device="cpu").db("tsbs")
    client.fill_table(db, CONFIG, rows.batches(), rows.dicts).sync()
    return rows, db


@pytest.fixture
def full_size_ceilings(monkeypatch):
    monkeypatch.setattr(PC.CompiledFilterAggregate, "MAX_CODES", 128)
    monkeypatch.setattr(ME, "_SORTED_THRESHOLD", 128)


def queries(shape: str) -> list:
    """The shape's first queries of the seed's stream."""
    stream = spec.Stream(MIX, SEED)
    out = []
    while len(out) < QUERIES_PER_SHAPE:
        name, _params, q = stream.next()
        if name == shape:
            out.append(q)
    return out


def run(engine, q) -> tuple:
    """(result batches, the rows as Python values in order)."""
    batches = []
    client.build(engine, CONFIG["table"], q).execute(batches.append)
    rows = []
    for b in batches:
        cols = [client._decoded(c) for c in b.columns]
        rows.extend(zip(*cols))
    return batches, rows


def test_schema_is_the_configurations():
    schema = tsbs_cpu_definition()
    assert CONFIG["schema"] == "tsbs_cpu_definition"
    assert [c.name for c in schema.columns] == ["labels", "timestamp", *TSBS_CPU_FIELDS]
    assert all(c.layout.type == "int64" for c in schema.columns[1:])
    assert [(s.name, s.direction, s.nulls_first) for s in schema.sorting_columns] == [
        ("labels", "asc", True), ("timestamp", "asc", False)]
    assert list(CONFIG["columns"]) == ["labels.hostname", "timestamp", *TSBS_CPU_FIELDS]


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_equals_reference_and_generic(shape, cut_table, full_size_ceilings):
    rows, db = cut_table
    fast = LocalEngine(db.table_provider())
    generic = LocalEngine(db.table_provider(), ExecOptions(compiled_serving=False))
    for q in queries(shape):
        batches, got = run(fast, q)
        assert fast.last_serving_path == MIX["shapes"][shape]["tier"], q
        assert judge.mismatch(numpy_ref.answer(q, rows), client.normalize(q, batches, rows.dicts)) is None, q
        _b, want = run(generic, q)
        assert generic.last_serving_path == "generic"
        assert got == want, q
        assert got, q


@pytest.mark.parametrize("shape, passes", [
    ("single_groupby_1_1_1", 1), ("single_groupby_5_8_1", 5), ("cpu_max_all_8", 10),
    ("double_groupby_all", 0), ("high_cpu_1", 0),
])
def test_minmax_span_and_counter(shape, passes, cut_table, full_size_ceilings):
    """One ``compiled/minmax`` span a MAX query, naming its value columns
    and its code count, and one ``minmax_passes_total`` a K3 launch; none
    for the shapes without a min or max."""
    _rows, db = cut_table
    q = queries(shape)[0]
    tracer, registry = Tracer(), MetricsRegistry()
    engine = LocalEngine(db.table_provider(), ExecOptions(tracer=tracer, metrics=registry))
    run(engine, q)
    (root,) = tracer.roots

    def find(span, name):
        return ([span] if span.name == name else []) + [s for c in span.children for s in find(c, name)]

    spans = find(root, "compiled/minmax")
    assert registry.counter("minmax_passes_total").value() == passes
    if not passes:
        assert spans == []
        return
    (span,) = spans
    columns = [c for f, c in next(s for s in q if s[0] == "aggregate")[1] if f == "max"]
    (execute,) = find(root, "compiled/execute")
    (remap,) = find(execute, "groups/remap")
    assert span.attributes == {"columns": columns, "codes": remap.attributes["codes"]}
    # 1-minute buckets of a 1 h window: 60 codes, padded to 64; the hourly
    # buckets of an 8 h window over the 3 h held: 3, padded to 4.
    assert span.attributes["codes"] == (64 if shape.startswith("single") else 4)


def test_double_groupby_all_takes_the_sorted_route(cut_table, full_size_ceilings):
    """double_groupby_all (ten sums and a count by host and hour) past the
    segment route's threshold: every partial a sum, so the sorted route's
    place is taken by the table route."""
    _rows, db = cut_table
    tracer = Tracer()
    engine = LocalEngine(db.table_provider(), ExecOptions(tracer=tracer))
    run(engine, queries("double_groupby_all")[0])
    assert engine.last_serving_path == "dense"
    (root,) = tracer.roots
    (dense,) = [c for c in root.children if c.name == "dense/execute"]
    (parts,) = [c for c in dense.children if c.name == "dense/parts"]
    assert parts.attributes["route"] == "table"


def test_no_query_uploads_after_sync(monkeypatch, full_size_ceilings):
    """``Table.sync`` leaves every part's device mirror whole: the first
    query of each shape on a fresh table uploads no column."""
    from frostdb_tpu_torch.device import DeviceBatch

    rows = datagen.generate(CONFIG, SEED + 1)
    db = ColumnStore(device="cpu").db("fresh")
    client.fill_table(db, CONFIG, rows.batches(), rows.dicts).sync()
    uploads = []
    upload = DeviceBatch._upload
    monkeypatch.setattr(DeviceBatch, "_upload", lambda self, hc: uploads.append(hc.name) or upload(self, hc))
    engine = LocalEngine(db.table_provider())
    for shape in SHAPES:
        run(engine, queries(shape)[0])
        assert engine.last_serving_path == MIX["shapes"][shape]["tier"]
    assert uploads == []
