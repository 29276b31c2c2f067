"""The port's Avro codec and Iceberg catalog against the JAX package
(tests/test_iceberg.py): the same records and blocks through both, the same
rows back, and each package reading the other's containers and warehouses."""

import importlib
import json
import os
import shutil

import numpy as np
import pytest

from test_torch_durability import JAX, PKGS, PORT, both, open_store, rows, run

AVRO = {K.name: importlib.import_module(f"{K.name}.avro") for K in PKGS}
ICEBERG = {K.name: importlib.import_module(f"{K.name}.iceberg") for K in PKGS}


NESTED_SCHEMA = {
    "type": "record",
    "name": "outer",
    "fields": [
        {"name": "s", "type": "string"},
        {"name": "n", "type": ["null", "long"], "default": None},
        {"name": "f", "type": "double"},
        {"name": "flag", "type": "boolean"},
        {"name": "raw", "type": "bytes"},
        {
            "name": "inner",
            "type": {
                "type": "record",
                "name": "inner_rec",
                "fields": [{"name": "k", "type": "int"}, {"name": "v", "type": "bytes"}],
            },
        },
        {"name": "items", "type": {"type": "array", "items": "inner_rec"}},
        {"name": "tags", "type": {"type": "map", "values": "string"}},
        {
            "name": "color",
            "type": {"type": "enum", "name": "color_e", "symbols": ["RED", "GREEN"]},
        },
        {"name": "sync", "type": {"type": "fixed", "name": "sync_f", "size": 4}},
    ],
}


def avro_records():
    return [
        {
            "s": "héllo", "n": None, "f": 3.25, "flag": True, "raw": b"\x00\x01\xff",
            "inner": {"k": -1, "v": b"x"},
            "items": [{"k": 7, "v": b"a"}, {"k": -(2**40), "v": b""}],
            "tags": {"a": "1", "b": "2"}, "color": "GREEN", "sync": b"abcd",
        },
        {
            "s": "", "n": 2**62, "f": -0.5, "flag": False, "raw": b"",
            "inner": {"k": 0, "v": b""}, "items": [], "tags": {}, "color": "RED",
            "sync": b"\x00\x00\x00\x00",
        },
    ]


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", PKGS, ids=str)
def test_avro_container_roundtrip_across_packages(writer, codec):
    blob = AVRO[writer.name].write_container(NESTED_SCHEMA, avro_records(), codec=codec)
    for K in PKGS:
        meta, got = AVRO[K.name].read_container(blob)
        assert got == avro_records()
        assert json.loads(meta["avro.schema"].decode()) == NESTED_SCHEMA


def test_avro_zigzag_edge_values():
    schema = {"type": "record", "name": "r", "fields": [{"name": "x", "type": "long"}]}
    for v in (0, 1, -1, 63, -64, 2**31, -(2**31), 2**63 - 1, -(2**63)):
        blobs = [
            AVRO[K.name].write_container(schema, [{"x": v}], codec="null") for K in PKGS
        ]
        for K in PKGS:
            for blob in blobs:
                assert AVRO[K.name].read_container(blob)[1] == [{"x": v}], v


def test_avro_named_type_reference_and_union():
    schema = {
        "type": "record",
        "name": "top",
        "fields": [
            {
                "name": "a",
                "type": {"type": "record", "name": "kv", "fields": [{"name": "k", "type": "int"}]},
            },
            {"name": "b", "type": ["null", "kv"], "default": None},
        ],
    }
    recs = [{"a": {"k": 1}, "b": {"k": 2}}, {"a": {"k": 3}, "b": None}]
    for K in PKGS:
        avro = AVRO[K.name]
        assert avro.read_container(avro.write_container(schema, recs))[1] == recs


# ---------------------------------------------------------------------------
# Iceberg catalog


def ice_batch(K, table, ts_start=0, n=6, etype="a"):
    cb = K.columnbatch
    d = table.dictionary("example_type")
    ones = np.ones(n, dtype=bool)
    return cb.ColumnBatch(
        [
            cb.Column("example_type", cb.KIND_DICT, *d.encode([etype] * n), d),
            cb.Column(
                "timestamp", cb.KIND_INT64,
                np.arange(ts_start, ts_start + n, dtype=np.int64), ones,
            ),
            cb.Column("value", cb.KIND_INT64, np.arange(n, dtype=np.int64) + ts_start, ones),
        ],
        n,
    )


def ice_rows(K, db, filt=None):
    def build(q, E):
        if filt is not None:
            q = q.filter(filt(E))
        return q.project(E.Col("example_type"), E.Col("timestamp"), E.Col("value"))

    return sorted(run(K, db, build))


def test_iceberg_upload_scan_roundtrip(tmp_path):
    def scenario(K, d):
        cat = ICEBERG[K.name].IcebergCatalog(str(d / "warehouse"))
        kw = dict(enable_wal=True, sources=[cat], sinks=[cat])
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=1), **kw
        )
        table.insert_record(ice_batch(K, table))
        table.insert_record(ice_batch(K, table, ts_start=10))
        table.sync()
        assert cat.prefixes("test") == ["t"]
        before = ice_rows(K, db)
        store.close()
        tdir = d / "warehouse" / "test" / "t"
        v = int((tdir / "metadata" / "version-hint.text").read_text())
        meta = json.loads((tdir / f"v{v}.metadata.json").read_text())
        assert meta["format-version"] == 1
        snap = [
            s for s in meta["snapshots"] if s["snapshot-id"] == meta["current-snapshot-id"]
        ][0]
        _m, manifests = AVRO[K.name].read_container(open(snap["manifest-list"], "rb").read())
        assert manifests and all(os.path.exists(m["manifest_path"]) for m in manifests)
        store2 = K.ColumnStore(storage_path=str(d / "db"), **kw)
        after = ice_rows(K, store2.db("test"))
        store2.close()
        assert after == before
        return after, meta["schema"]

    got, _schema = both(tmp_path, scenario)
    assert len(got) == 12


def _catalog_with_blocks(K, d, n_blocks, start=0, step=10):
    cat = ICEBERG[K.name].IcebergCatalog(str(d / "w"))
    store = K.ColumnStore(storage_path=str(d / "db"))
    table = store.db("test").table("t", K.config())
    for i in range(n_blocks):
        cat.upload_block(
            "test", "t", f"b{i}", ice_batch(K, table, ts_start=start + i * step),
            table._schema,
        )
    return cat, store, table


def test_iceberg_bound_pruning(tmp_path):
    def scenario(K, d):
        cat, store, table = _catalog_with_blocks(K, d, 2, step=1000)
        scan = lambda filt=None, excl=(): rows(  # noqa: E731
            cat.scan("test", "t", table._schema, filt, table.dictionary, excl)
        )
        full = scan()
        pruned = scan(K.E.Col("timestamp").gt_eq(500))
        excluded = scan(None, {"b1"})
        store.close()
        assert len(full) == 12 and len(pruned) == 6 and len(excluded) == 6
        assert all(dict(r)["timestamp"] >= 1000 for r in pruned)
        return full, pruned, excluded

    both(tmp_path, scenario)


def test_iceberg_maintenance_expires_snapshots(tmp_path):
    def scenario(K, d):
        cat, store, table = _catalog_with_blocks(K, d, 6)
        removed = cat.maintenance("test", "t", keep_snapshots=2)
        got = rows(cat.scan("test", "t", table._schema, None, table.dictionary))
        store.close()
        assert removed > 0 and len(got) == 36
        return removed, sorted(got)

    both(tmp_path, scenario)


def test_iceberg_maintenance_removes_orphaned_data_files(tmp_path):
    def scenario(K, d):
        cat, store, table = _catalog_with_blocks(K, d, 6)
        ddir = d / "w" / "test" / "t" / "data"
        orphan = ddir / "crashed-upload.parquet"
        orphan.write_bytes(b"not a real parquet")
        fresh = ddir / "inflight-upload.parquet"
        fresh.write_bytes(b"also not parquet")
        os.utime(orphan, (0, 0))
        removed = cat.maintenance("test", "t", keep_snapshots=2)
        assert removed > 0 and not orphan.exists() and fresh.exists()
        got = rows(cat.scan("test", "t", table._schema, None, table.dictionary))
        store.close()
        return removed, sorted(got)

    assert len(both(tmp_path, scenario)[1]) == 36


def test_iceberg_commit_conflict_detected(tmp_path):
    def scenario(K, d):
        cat, store, table = _catalog_with_blocks(K, d, 1)
        tdir = d / "w" / "test" / "t"
        v = int((tdir / "metadata" / "version-hint.text").read_text())
        (tdir / f"v{v + 1}.metadata.json").write_text(
            (tdir / f"v{v}.metadata.json").read_text()
        )
        with pytest.raises(ICEBERG[K.name].CommitConflictError):
            cat.upload_block("test", "t", "b1", ice_batch(K, table), table._schema)
        store.close()
        return int((tdir / "metadata" / "version-hint.text").read_text()) - v

    assert both(tmp_path, scenario) == 0


def test_iceberg_list_blocks_and_parts(tmp_path):
    """The block-granular source API the tables cache parts from: the same
    block ids and row groups in both packages."""

    def scenario(K, d):
        cat, store, table = _catalog_with_blocks(K, d, 3)
        blocks = cat.list_blocks("test", "t")
        parts = [
            rows(cat.read_block_parts(ref, table._schema, table.dictionary))
            for _bid, ref in blocks
        ]
        store.close()
        return [b for b, _r in blocks], parts

    ids, _parts = both(tmp_path, scenario)
    assert ids == ["b0", "b1", "b2"]


@pytest.mark.parametrize("writer", PKGS, ids=str)
def test_iceberg_warehouse_across_packages(tmp_path, writer):
    """A warehouse one package's store persisted blocks into is served by
    both packages' stores (as source) with the same rows, order included;
    a filter prunes the same files."""
    src = tmp_path / "src"
    cat = ICEBERG[writer.name].IcebergCatalog(str(src / "w"))
    store, db, table = open_store(
        writer, src / "db", table_config=writer.config(active_memory_size=1),
        enable_wal=True, sources=[cat], sinks=[cat],
    )
    for i in range(3):
        table.insert_record(ice_batch(writer, table, ts_start=100 * i))
    table.sync()
    written = ice_rows(writer, db)
    store.close()
    got = {}
    for K in PKGS:
        dst = tmp_path / K.name
        shutil.copytree(src / "db", dst / "db")
        rcat = ICEBERG[K.name].IcebergCatalog(str(src / "w"))
        rstore = K.ColumnStore(
            storage_path=str(dst / "db"), enable_wal=True, sources=[rcat]
        )
        rdb = rstore.db("test")
        got[K.name] = (
            ice_rows(K, rdb),
            ice_rows(K, rdb, lambda E: E.Col("timestamp").gt_eq(150)),
        )
        rstore.close()
    assert got[JAX.name] == got[PORT.name]
    assert got[PORT.name][0] == written
    assert {dict(r)["timestamp"] // 100 for r in got[PORT.name][1]} == {2}
