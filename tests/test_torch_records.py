"""The port's typed-records layer against the JAX package (the records cases
of tests/test_components.py): ``schema_for`` derives the same schema from a
dataclass, and ``build_batch`` / ``GenericTable`` write the same rows."""

from dataclasses import dataclass, field

import pytest

from test_torch_durability import JAX, PKGS, PORT, rows, run


@dataclass
class Sample:
    example_type: str = field(default="", metadata={"rle_dict": True, "asc": 0})
    labels: dict = field(
        default_factory=dict, metadata={"rle_dict": True, "asc": 1, "null_first": True}
    )
    timestamp: int = field(default=0, metadata={"asc": 2})
    value: int = 0


@dataclass
class Wide:
    name: str = field(default="", metadata={"asc": 0})
    ratio: float = 0.0
    ok: bool = False
    count: int = 0


SAMPLES = [
    Sample("cpu", {"node": "n1"}, 1, 10),
    Sample("cpu", {"node": "n2"}, 2, 20),
    Sample("mem", {"node": "n1", "pod": "p"}, 3, 30),
]


@pytest.mark.parametrize("cls", [Sample, Wide], ids=lambda c: c.__name__)
def test_schema_for_dataclass(cls):
    defs = [K.records.schema_for(cls).to_dict() for K in PKGS]
    assert defs[0] == defs[1]
    if cls is Sample:
        sd = PORT.records.schema_for(cls)
        assert [c.name for c in sd.columns] == ["example_type", "labels", "timestamp", "value"]
        assert sd.columns[1].dynamic
        assert [s.name for s in sd.sorting_columns] == ["example_type", "labels", "timestamp"]


def _generic_table(K, cls, objs):
    store = K.ColumnStore()
    db = store.db("t")
    table = db.table("samples", K.config(schema=K.records.schema_for(cls)))
    K.records.GenericTable(table, cls).write(*objs)
    return db


def test_generic_table_write_and_query():
    got = {}
    for K in PKGS:
        db = _generic_table(K, Sample, SAMPLES)
        got[K.name] = (
            run(K, db, lambda q, E: q.aggregate(
                [E.Sum(E.Col("value"))], [E.Col("example_type")]), table="samples"),
            run(K, db, lambda q, E: q.project(
                E.Col("example_type"), E.DynCol("labels"), E.Col("timestamp"),
                E.Col("value")), table="samples"),
        )
    assert got[JAX.name] == got[PORT.name]
    sums = {dict(r)["example_type"]: dict(r)["sum(value)"] for r in got[PORT.name][0]}
    assert sums == {"cpu": 30, "mem": 30}


def test_build_batch_scalar_types():
    """Floats, bools, ints and strings, with missing fields as nulls."""
    objs = [
        {"name": "a", "ratio": 0.5, "ok": True, "count": 3},
        {"name": "b", "ratio": None, "ok": None, "count": None},
        {"name": "c", "ratio": -2.25, "ok": False, "count": -7},
    ]
    got = []
    for K in PKGS:
        store = K.ColumnStore()
        table = store.db("t").table("w", K.config(schema=K.records.schema_for(Wide)))
        b = K.records.build_batch(table, objs)
        table.insert_record(b)
        got.append((rows([b]), run(K, store.db("t"), lambda q, E: q.project(
            E.Col("name"), E.Col("ratio"), E.Col("ok"), E.Col("count")), table="w")))
    assert got[0] == got[1]
    assert dict(got[1][0][1]) == {"name": "b", "ratio": None, "ok": None, "count": None}


def test_generic_table_dataclass_rows():
    """GenericTable takes dataclass instances of the schema's class and
    writes one row per instance, dynamic label columns included."""
    got = []
    for K in PKGS:
        db = _generic_table(K, Sample, SAMPLES + [Sample("io", {}, 4, 1)])
        got.append(run(K, db, lambda q, E: q.aggregate(
            [E.Sum(E.Col("value"))], [E.Col("labels.node")]), table="samples"))
    assert got[0] == got[1]
    assert {dict(r)["labels.node"]: dict(r)["sum(value)"] for r in got[1]} == {
        "n1": 40, "n2": 20, None: 1,
    }
