"""Nested (struct) schemas in the port against the JAX package:
tests/test_nested_schema.py's cases run through the port (``port_view``,
with the reference's own assertions), and the same scenario in each
package must give the same flattened leaf columns and definition dict, the
same query rows before and after block rotation and after WAL recovery,
the same Arrow record batch when leaves are re-nested into a struct, and
the same null propagation from a null struct row.
"""

import numpy as np
import pyarrow as pa

import test_differential_fuzz as FZ
import test_nested_schema as TNS
from test_torch_engine import port_view

PNS = port_view(TNS)
MODS = (TNS, PNS)


def column_store(M, **kw):
    """The module's package's store; the port's on the CPU."""
    return M.ColumnStore(**kw, **({"device": "cpu"} if M is PNS else {}))


def both(fn, *args):
    got = [fn(M, *args) for M in MODS]
    assert got[0] == got[1], got
    return got[1]


def schema_shape(M):
    s = M.Schema(M._nested_def())
    return (
        [(c.name, c.layout.dict_encoded, c.layout.nullable) for c in s.columns()],
        [g.name for g in s.groups()],
        M._nested_def().to_dict(),
        M.SchemaDef.from_dict(M._nested_def().to_dict()) == M._nested_def(),
    )


def test_schema_flattening_and_roundtrip():
    PNS.test_schema_flattening_and_roundtrip()
    both(schema_shape)


def queries(M, db):
    E = M.E
    eng = M.LocalEngine(db.table_provider())
    out = []
    for q in (
        eng.scan_table("t").aggregate([E.Sum(E.Col("value"))], [E.Col("attributes.region")]),
        eng.scan_table("t").filter(E.Col("attributes.owner.team").eq("red")).aggregate(
            [E.Sum(E.Col("value"))], []
        ),
        eng.scan_table("t").project(
            E.Col("attributes.zone"), E.Col("attributes.owner.team"), E.Col("value")
        ),
    ):
        res = []
        q.execute(res.append)
        out.append((FZ.rows(res), eng.last_serving_path))
    return out


def ingest_rotate_recover(M, root):
    store = column_store(M, storage_path=str(root / "db"), enable_wal=True)
    db = store.db("test")
    table = db.table("t", M.TableConfig(schema=M._nested_def()))
    table.insert_record(M._struct_batch())
    seen = [queries(M, db)]
    table.rotate_block()
    table.insert_record(M._struct_batch(4))
    seen.append(queries(M, db))
    store.close()
    store2 = column_store(M, storage_path=str(root / "db"), enable_wal=True)
    db2 = store2.db("test")
    seen.append([g.name for g in db2.get_table("t").schema().groups()])
    seen.append(queries(M, db2))
    store2.close()
    return seen


def test_struct_ingest_query_rotate_recover(tmp_path):
    PNS.test_struct_ingest_query_rotate_recover(tmp_path / "ref")
    seen = both(lambda M: ingest_rotate_recover(M, tmp_path / M.__name__))
    assert seen[2] == ["attributes"]
    assert seen[3] == seen[1]


def arrow_roundtrip(M):
    store = column_store(M)
    db = store.db("test")
    table = db.table("t", M.TableConfig(schema=M._nested_def()))
    table.insert_record(M._struct_batch())
    E = M.E
    out = []
    M.LocalEngine(db.table_provider()).scan_table("t").project(
        E.Col("attributes.region"),
        E.Col("attributes.zone"),
        E.Col("attributes.owner.team"),
        E.Col("value"),
    ).execute(out.append)
    rb = out[0].to_arrow(schema=table.schema())
    store.close()
    return rb


def test_struct_arrow_roundtrip():
    PNS.test_struct_arrow_roundtrip()
    ref, got = (arrow_roundtrip(M) for M in MODS)
    assert got.schema.equals(ref.schema)
    assert got.equals(ref)
    assert pa.types.is_struct(got.schema.field("attributes").type)


def null_struct(M):
    struct = pa.StructArray.from_arrays(
        [pa.array(["us", "eu"]), pa.array(["a", "b"])], names=["region", "zone"]
    )
    struct = pa.StructArray.from_buffers(
        struct.type, 2, [pa.array([True, False]).buffers()[1]],
        children=[struct.field(0), struct.field(1)],
    )
    rb = pa.RecordBatch.from_arrays(
        [struct, pa.array(np.array([1, 2], dtype=np.int64))], names=["attributes", "value"]
    )
    cb = M.ColumnBatch.from_arrow(rb)
    return [
        (c.name, c.kind, [c.py_value(i) for i in range(cb.num_rows)], c.validity.tolist())
        for c in cb.columns
    ]


def test_null_struct_row_nulls_children():
    PNS.test_null_struct_row_nulls_children()
    cols = both(null_struct)
    assert [c[3] for c in cols if c[0].startswith("attributes.")] == [[True, False]] * 2
