"""The port's durability modules against the JAX package: the WAL, disk
index levels, snapshots, recovery, the bucket store and its cached source
parts, background rotation, list columns through all of them, and the three
deterministic simulation suites.

Each case runs the same seeded scenario through both packages, each in a
directory of its own, and compares what the reference test checks plus the
full ``(name, py_value)`` row tuples, order included. The cross-package
cases hold each package to the other's files: a store that one package
wrote recovers in the other with the rows the writer's own recovery gives.
"""

import collections
import importlib
import os
import shutil
import threading
import time

import numpy as np
import pytest


class Pkg:
    """One package's durability surface, with the port held to the CPU."""

    MODULES = (
        "columnbatch", "db", "disklevel", "faults", "lsm", "metrics",
        "records", "schema", "snapshot", "store", "table", "wal",
    )

    def __init__(self, root, **device):
        self.name = root
        for mod in self.MODULES:
            setattr(self, mod, importlib.import_module(f"{root}.{mod}"))
        self.E = importlib.import_module(f"{root}.query.expr")
        self.engine = importlib.import_module(f"{root}.query.engine")
        self.physical = importlib.import_module(f"{root}.query.physical")
        self.device = device

    def __repr__(self):
        return self.name

    def ColumnStore(self, **kw):
        return self.db.ColumnStore(**kw, **self.device)

    def Part(self, batch, tx, level):
        return self.lsm.Part(batch, tx, compaction_level=level, **self.device)

    def DiskLevel(self, path, level):
        return self.disklevel.DiskLevel(str(path), level, **self.device)

    def config(self, schema=None, **kw):
        schema = schema or self.schema.sample_definition()
        return self.table.TableConfig(schema=schema, **kw)


JAX = Pkg("frostdb_tpu")
PORT = Pkg("frostdb_tpu_torch", device="cpu")
PKGS = (JAX, PORT)


def both(tmp_path, fn, *args):
    """``fn(K, directory, *args)`` for each package in its own directory;
    the two results must be equal. Returns the result."""
    out = []
    for K in PKGS:
        d = tmp_path / K.name
        d.mkdir(exist_ok=True)
        out.append(fn(K, d, *args))
    assert out[0] == out[1], (out[0], out[1])
    return out[0]


def batch(K, table, labels, values=None, ts_start=1, etype="cpu", stack="stack"):
    """A sample_definition batch: one row per label."""
    cb = K.columnbatch
    n = len(labels)
    values = np.arange(1, n + 1) if values is None else values
    d_et = table.dictionary("example_type")
    d_l = table.dictionary("labels")
    d_st = table.dictionary("stacktrace")
    ones = np.ones(n, dtype=bool)
    return cb.ColumnBatch(
        [
            cb.Column("example_type", cb.KIND_DICT, *d_et.encode([etype] * n), d_et),
            cb.Column("labels.label1", cb.KIND_DICT, *d_l.encode(list(labels)), d_l),
            cb.Column("stacktrace", cb.KIND_DICT, *d_st.encode([stack] * n), d_st),
            cb.Column(
                "timestamp", cb.KIND_INT64,
                np.arange(ts_start, ts_start + n, dtype=np.int64), ones,
            ),
            cb.Column("value", cb.KIND_INT64, np.asarray(values, dtype=np.int64), ones),
        ],
        n,
    )


def make_batch(K, table, n=3, ts_start=1):
    """tests/test_db.py's _make_batch."""
    return batch(K, table, [f"v{i}" for i in range(n)], ts_start=ts_start)


def rows(batches):
    return [
        tuple((c.name, c.py_value(i)) for c in b.columns)
        for b in batches
        for i in range(b.num_rows)
    ]


def run(K, db, build, compiled=True, table="t"):
    eng = K.engine.LocalEngine(
        db.table_provider(), K.physical.ExecOptions(compiled_serving=compiled)
    )
    out = []
    build(eng.scan_table(table), K.E).execute(out.append)
    return rows(out)


def sum_by_type(K, db, table="t"):
    """tests/test_db.py's _query_sum query, as full rows."""
    return run(
        K, db,
        lambda q, E: q.aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")]),
        table=table,
    )


def all_rows(K, db, table="t"):
    return run(
        K, db,
        lambda q, E: q.project(
            E.Col("labels.label1"), E.Col("timestamp"), E.Col("value")
        ),
        table=table,
    )


def total(result):
    return sum(dict(r)["sum(value)"] for r in result)


def open_store(K, d, db_name="test", table_config=None, **kw):
    store = K.ColumnStore(storage_path=str(d), **kw)
    db = store.db(db_name)
    table = db.table("t", table_config or K.config())
    return store, db, table


def segments(d):
    return sorted(f for f in os.listdir(str(d)) if f.endswith(".wal"))


# ---------------------------------------------------------------------------
# WAL (tests/test_wal.py)


def _wal_table(K):
    return K.ColumnStore().db("w").table("t", K.config())


@pytest.mark.parametrize("close", [False, True])
def test_async_wal_batcher(tmp_path, close):
    """The async batcher drains in tx order, on flush or on close."""

    def scenario(K, d):
        table = _wal_table(K)
        w = K.wal.FileWAL(str(d), sync=False)
        for tx in range(1, 21):
            w.log_record(tx, "t", make_batch(K, table), block_id="b1")
        if close:
            w.close()
            w = K.wal.FileWAL(str(d))
        else:
            w.flush()
        seen = []
        w.replay(lambda h, b: seen.append((h["tx"], h["kind"], h["block_id"], b)))
        w.close()
        assert [s[0] for s in seen] == list(range(1, 21))
        return seen

    both(tmp_path, scenario)


def test_wal_truncate_drops_whole_segments(tmp_path):
    def scenario(K, d):
        table = _wal_table(K)
        for tx in (1, 2, 3):
            w = K.wal.FileWAL(str(d))
            w.log_record(tx, "t", make_batch(K, table))
            if tx < 3:
                w.close()
        assert len(segments(d)) == 3
        w.truncate(3)
        assert len(segments(d)) == 1
        seen = []
        w.replay(lambda h, b: seen.append(h["tx"]))
        w.close()
        assert seen == [3]
        return segments(d)

    both(tmp_path, scenario)


def test_wal_unknown_format_refuses_instead_of_truncating(tmp_path):
    def scenario(K, d):
        path = d / "00000000000000000001.wal"
        legacy = b'{"tx": 1, "kind": "write"}' + b"x" * 100
        path.write_bytes(legacy)
        w = K.wal.FileWAL(str(d))
        with pytest.raises(K.wal.WALUnknownFormatError):
            w.replay(lambda h, b: None)
        w.close()
        assert path.read_bytes() == legacy
        return True

    both(tmp_path, scenario)


def test_wal_mid_segment_corruption_truncates_and_counts(tmp_path):
    def scenario(K, d):
        table = _wal_table(K)
        w = K.wal.FileWAL(str(d))
        for tx in (1, 2, 3):
            w.log_record(tx, "t", make_batch(K, table))
        w.close()
        seg = str(d / segments(d)[0])
        data = open(seg, "rb").read()
        off, bounds = 0, []
        while off < len(data):
            _m, _k, tlen, blen, bl, _tx = K.wal._PREFIX.unpack_from(data, off)
            bounds.append(off)
            off += K.wal._PREFIX.size + K.wal._CRC.size + tlen + blen + bl
        assert len(bounds) == 3
        corrupted = bytearray(data)
        corrupted[bounds[2]] = 0x00
        open(seg, "wb").write(bytes(corrupted))
        w2 = K.wal.FileWAL(str(d))
        seen = []
        w2.replay(lambda h, b: seen.append(h["tx"]))
        w2.close()
        assert seen == [1, 2]
        assert w2.repairs == 1 and w2.repairs_lost_records == 1
        assert os.path.getsize(seg) == bounds[2]
        return bounds, seen

    both(tmp_path, scenario)


def _flip_last_byte(seg):
    with open(seg, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))


def test_wal_repairs_surface_in_metrics_registry(tmp_path):
    def scenario(K, d):
        table = _wal_table(K)
        w = K.wal.FileWAL(str(d))
        w.log_record(1, "t", make_batch(K, table))
        w.log_record(2, "t", make_batch(K, table))
        w.close()
        _flip_last_byte(str(d / segments(d)[0]))
        reg = K.metrics.MetricsRegistry()
        w2 = K.wal.FileWAL(str(d), repair_counter=reg.wal_repairs)
        seen = []
        w2.replay(lambda h, b: seen.append(h["tx"]))
        w2.close()
        assert w2.repairs == 1 and reg.wal_repairs.value() == 1
        assert "frostdb_tpu_wal_repairs_total 1" in reg.expose()
        return seen

    both(tmp_path, scenario)


def test_db_recovery_repair_visible_in_expose(tmp_path):
    def scenario(K, d):
        store, db, t = open_store(K, d, "m", enable_wal=True)
        t.insert_record(make_batch(K, t))
        t.insert_record(make_batch(K, t))
        store.close()
        wal_dir = d / "databases" / "m" / "wal"
        _flip_last_byte(str(wal_dir / segments(wal_dir)[0]))
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        db2 = store2.db("m")
        assert store2.metrics.wal_repairs.value() >= 1
        assert "frostdb_tpu_wal_repairs_total" in store2.metrics.expose()
        out = sum_by_type(K, db2)
        store2.close()
        return out

    assert total(both(tmp_path, scenario)) == 6


def test_wal_unknown_kind_crc_valid_is_skipped(tmp_path):
    import zlib

    def scenario(K, d):
        table = _wal_table(K)
        w = K.wal.FileWAL(str(d))
        w.log_record(1, "t", make_batch(K, table))
        w.close()
        seg = str(d / segments(d)[0])
        body = b"future-entry"
        prefix = K.wal._PREFIX.pack(K.wal._MAGIC, 99, 0, 0, len(body), 2)
        crc = zlib.crc32(prefix + body) & 0xFFFFFFFF
        with open(seg, "ab") as f:
            f.write(prefix + K.wal._CRC.pack(crc) + body)
        w2 = K.wal.FileWAL(str(d))
        w2.log_snapshot(3)
        size_before = os.path.getsize(seg)
        seen = []
        w2.replay(lambda h, b: seen.append((h["tx"], h["kind"])))
        assert [tx for tx, _ in seen] == [1, 3]
        assert w2.repairs == 0 and w2.repairs_lost_records == 0
        assert os.path.getsize(seg) == size_before
        w2.close()
        return seen

    both(tmp_path, scenario)


def test_wal_replay_no_repair_leaves_tail(tmp_path):
    def scenario(K, d):
        table = _wal_table(K)
        w = K.wal.FileWAL(str(d))
        w.log_record(1, "t", make_batch(K, table))
        w.close()
        seg = str(d / segments(d)[0])
        with open(seg, "ab") as f:
            f.write(b"\xf5torn-partial-frame")
        size = os.path.getsize(seg)
        w2 = K.wal.FileWAL(str(d))
        seen = []
        w2.replay(lambda h, b: seen.append(h["tx"]), repair=False)
        w2.close()
        assert seen == [1] and os.path.getsize(seg) == size
        return seen

    both(tmp_path, scenario)


def test_wal_reset(tmp_path):
    def scenario(K, d):
        w = K.wal.FileWAL(str(d))
        w.log_record(1, "t", make_batch(K, _wal_table(K)))
        w.reset()
        w.close()
        return os.listdir(str(d))

    assert both(tmp_path, scenario) == []


def test_nop_wal(tmp_path):
    for K in PKGS:
        w = K.wal.NopWAL()
        w.log_record(1, "t", None)
        w.log_new_table_block(1, "t", "b", None)
        w.log_table_block_persisted(1, "t", "b")
        w.log_snapshot(1)
        assert w.replay(lambda h, b: None) == 0
        w.truncate(1)
        w.reset()
        w.close()


@pytest.mark.parametrize("writer", PKGS, ids=str)
def test_wal_frames_cross_packages(tmp_path, writer):
    """A segment one package wrote replays in the other: the same headers
    and bodies, and the IPC bodies decode to the same rows."""
    table = _wal_table(writer)
    w = writer.wal.FileWAL(str(tmp_path))
    w.log_new_table_block(1, "t", "b1", writer.config())
    for tx in (2, 3):
        w.log_record(tx, "t", make_batch(writer, table, ts_start=tx), block_id="b1")
    w.log_table_block_persisted(4, "t", "b1")
    w.log_snapshot(5)
    w.close()
    seen = {}
    for K in PKGS:
        got = []
        r = K.wal.FileWAL(str(tmp_path))
        r.replay(lambda h, b: got.append((h, b)), repair=False)
        r.close()
        seen[K.name] = got
        for h, b in got:
            if h["kind"] == K.wal.KIND_WRITE:
                t = _wal_table(K)
                cb = K.columnbatch.ColumnBatch.from_arrow(
                    K.wal.ipc_to_arrow(b), get_dictionary=t.dictionary
                )
                assert rows([cb]) == rows([make_batch(K, t, ts_start=h["tx"])])
    assert seen[JAX.name] == seen[PORT.name]
    assert [h["kind"] for h, _b in seen[PORT.name]] == [
        "new_table_block", "write", "write", "table_block_persisted", "snapshot",
    ]


# ---------------------------------------------------------------------------
# DB lifecycle (the persistence cases of tests/test_db.py)


def test_wal_replay(tmp_path):
    def scenario(K, d):
        store, db, table = open_store(K, d, enable_wal=True)
        table.insert_record(make_batch(K, table))
        table.insert_record(make_batch(K, table, ts_start=10))
        wm = db.high_watermark()
        before = all_rows(K, db)
        store.close()
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        db2 = store2.db("test")
        assert "t" in db2.tables and db2.high_watermark() == wm
        out = (sum_by_type(K, db2), all_rows(K, db2))
        assert out[1] == before
        store2.close()
        return out

    assert total(both(tmp_path, scenario)[0]) == 12


def test_snapshot_and_recovery(tmp_path):
    def scenario(K, d):
        store, db, table = open_store(K, d, enable_wal=True)
        table.insert_record(make_batch(K, table))
        tx = K.snapshot.write_snapshot(db, db.snapshot_dir)
        assert tx == db.high_watermark()
        table.insert_record(make_batch(K, table, ts_start=10))
        store.close()
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        db2 = store2.db("test")
        out = (tx, sum_by_type(K, db2), all_rows(K, db2))
        store2.close()
        return out

    assert total(both(tmp_path, scenario)[1]) == 12


def test_corrupt_snapshot_falls_back(tmp_path):
    def scenario(K, d):
        store, db, table = open_store(K, d, enable_wal=True)
        table.insert_record(make_batch(K, table))
        K.snapshot.write_snapshot(db, db.snapshot_dir)
        table.insert_record(make_batch(K, table, ts_start=10))
        tx2 = K.snapshot.write_snapshot(db, db.snapshot_dir)
        with open(K.snapshot.snapshot_path(db.snapshot_dir, tx2), "r+b") as f:
            f.seek(-2, os.SEEK_END)
            f.write(b"xx")
        store.close()
        assert K.snapshot.get_latest_valid_snapshot_txn(db.snapshot_dir) is None
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        db2 = store2.db("test")
        out = (sum_by_type(K, db2), all_rows(K, db2))
        store2.close()
        return out

    assert total(both(tmp_path, scenario)[0]) == 12


def test_block_persistence_to_bucket(tmp_path):
    def scenario(K, d):
        bucket = K.store.FileSystemBucket(str(d / "bucket"))
        kw = dict(enable_wal=True, sources=[bucket], sinks=[bucket])
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=1), **kw
        )
        table.insert_record(make_batch(K, table))
        table.sync()
        assert bucket.blocks("test", "t"), "block not uploaded"
        table.insert_record(make_batch(K, table, ts_start=10))
        table.sync()
        before = sum_by_type(K, db)
        store.close()
        store2 = K.ColumnStore(storage_path=str(d / "db"), **kw)
        db2 = store2.db("test")
        out = sum_by_type(K, db2)
        assert out == before
        store2.close()
        return out, len(bucket.blocks("test", "t"))

    assert total(both(tmp_path, scenario)[0]) == 12


def test_wal_corrupt_tail(tmp_path):
    def scenario(K, d):
        store, db, table = open_store(K, d, enable_wal=True)
        table.insert_record(make_batch(K, table))
        store.close()
        wal_dir = d / "databases" / "test" / "wal"
        with open(str(wal_dir / segments(wal_dir)[0]), "ab") as f:
            f.write(b"\x13\x07garbage-torn-write")
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        out = sum_by_type(K, store2.db("test"))
        store2.close()
        return out

    assert total(both(tmp_path, scenario)) == 6


def test_snapshot_trigger_size_writes_snapshots(tmp_path):
    """``snapshot_trigger_size`` snapshots from the insert path and at
    rotation, and recovery reads them back."""

    def scenario(K, d):
        bucket = K.store.FileSystemBucket(str(d / "bucket"))
        kw = dict(
            enable_wal=True, sources=[bucket], sinks=[bucket],
            snapshot_trigger_size=100,
        )
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=400), **kw
        )
        for i in range(6):
            table.insert_record(make_batch(K, table, ts_start=10 * i))
        table.sync()
        snaps = store.metrics.snapshots_total.value()
        assert snaps > 0 and os.listdir(db.snapshot_dir)
        before = all_rows(K, db)
        store.close()
        store2 = K.ColumnStore(storage_path=str(d / "db"), **kw)
        db2 = store2.db("test")
        out = sorted(all_rows(K, db2))
        assert out == sorted(before)
        store2.close()
        return snaps, out

    assert len(both(tmp_path, scenario)[1]) == 18


def test_port_store_takes_device(tmp_path):
    """The store's device reaches every recovered part: snapshot, WAL
    replay, disk level and bucket reads."""
    bucket = PORT.store.FileSystemBucket(str(tmp_path / "bucket"))
    kw = dict(enable_wal=True, sources=[bucket], sinks=[bucket])
    store, db, table = open_store(
        PORT, tmp_path / "db", table_config=PORT.config(active_memory_size=200), **kw
    )
    for i in range(4):
        table.insert_record(make_batch(PORT, table, ts_start=10 * i))
    table.sync()
    table.active_block.index.compact_level(0)
    table.active_block.index.compact_level(1)
    PORT.snapshot.write_snapshot(db, db.snapshot_dir)
    store.close()
    store2 = PORT.ColumnStore(storage_path=str(tmp_path / "db"), **kw)
    t2 = store2.db("test").get_table("t")
    parts = t2.collect_parts(store2.dbs["test"].high_watermark(), include_sources=True)
    assert parts and {str(p.device_name) for p in parts} == {"cpu"}
    assert {str(p.device().device) for p in parts} == {"cpu"}
    store2.close()
    import torch

    if not torch.cuda.is_available():
        # The default device is the card: without one the store refuses
        # before it touches the directory.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.db.ColumnStore(storage_path=str(tmp_path / "other"), enable_wal=True)
        assert not (tmp_path / "other").exists()


# ---------------------------------------------------------------------------
# Disk index levels (tests/test_disklevel.py)


def _four_inserts_spilled(K, d):
    store, db, table = open_store(K, d, "d", enable_wal=True)
    for i in range(4):
        table.insert_record(make_batch(K, table, ts_start=i * 10))
    table.active_block.index.compact_level(0)
    table.active_block.index.compact_level(1)
    return store, db, table


def test_disk_level_roundtrip(tmp_path):
    def scenario(K, d):
        table = K.ColumnStore(storage_path=str(d)).db("x").table("t", K.config())
        lvl = K.DiskLevel(d / "lvl", 2)
        lvl.write_part(K.Part(make_batch(K, table), 3, 2))
        lvl.write_part(K.Part(make_batch(K, table, ts_start=10), 5, 2))
        lvl.rotate_file()
        lvl.write_part(K.Part(make_batch(K, table, ts_start=20), 7, 2))
        recovered = K.DiskLevel(d / "lvl", 2).recover(table.dictionary)
        assert [p.tx for p in recovered] == [3, 5, 7]
        assert all(p.compaction_level == 2 for p in recovered)
        return [(p.tx, rows([p.batch])) for p in recovered], sorted(os.listdir(d / "lvl"))

    both(tmp_path, scenario)


def test_disk_level_torn_tail(tmp_path):
    def scenario(K, d):
        table = K.ColumnStore(storage_path=str(d)).db("x").table("t", K.config())
        lvl = K.DiskLevel(d / "lvl", 2)
        lvl.write_part(K.Part(make_batch(K, table), 3, 2))
        lvl.close()
        files = sorted(os.listdir(d / "lvl"))
        with open(str(d / "lvl" / files[0]), "ab") as f:
            f.write(b"torn-parquet-payload-without-size-frame"[:20])
        recovered = K.DiskLevel(d / "lvl", 2).recover(table.dictionary)
        assert [p.tx for p in recovered] == [3]
        return rows([recovered[0].batch])

    both(tmp_path, scenario)


def test_compaction_spills_to_disk_and_snapshot_links(tmp_path):
    def scenario(K, d):
        store, db, table = _four_inserts_spilled(K, d)
        disk_dir = os.path.join(table.index_dir(), table.active_block.id, "2")
        assert os.path.isdir(disk_dir) and os.listdir(disk_dir), "no index files"
        tx = K.snapshot.write_snapshot(db, db.snapshot_dir)
        footer = K.snapshot.read_footer(K.snapshot.snapshot_path(db.snapshot_dir, tx))
        link_dir = os.path.join(db.snapshot_dir, footer["index_dirname"], "t", "2")
        assert os.path.isdir(link_dir) and os.listdir(link_dir)
        out = [sum_by_type(K, db)]
        store.close()
        for _restart in range(2):
            store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
            out.append(sum_by_type(K, store2.db("d")))
            out.append(all_rows(K, store2.dbs["d"]))
            store2.close()
        return out

    out = both(tmp_path, scenario)
    assert [total(out[i]) for i in (0, 1, 3)] == [24, 24, 24]


def test_same_tx_resnapshot_eio_preserves_published(tmp_path):
    def scenario(K, d):
        store, db, table = _four_inserts_spilled(K, d)
        tx = K.snapshot.write_snapshot(db, db.snapshot_dir)
        footer1 = K.snapshot.read_footer(K.snapshot.snapshot_path(db.snapshot_dir, tx))
        dir1 = footer1["index_dirname"]
        linked1 = footer1["tables"][0]["index_files"]
        assert linked1
        db.store.fault_injector = K.faults.FaultInjector(seed=1, p_snapshot=1.0)
        with pytest.raises(OSError):
            K.snapshot.write_snapshot(db, db.snapshot_dir)
        db.store.fault_injector = None
        assert K.snapshot.get_latest_valid_snapshot_txn(db.snapshot_dir) == tx
        footer2 = K.snapshot.read_footer(K.snapshot.snapshot_path(db.snapshot_dir, tx))
        assert footer2["index_dirname"] == dir1
        for f in linked1:
            assert os.path.exists(os.path.join(db.snapshot_dir, dir1, "t", "2", f))
        store.close()
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        out = sum_by_type(K, store2.db("d"))
        store2.close()
        return out, len(linked1)

    assert total(both(tmp_path, scenario)[0]) == 24


def test_same_tx_resnapshot_success_swaps_incarnation(tmp_path):
    def scenario(K, d):
        store, db, table = _four_inserts_spilled(K, d)
        S = K.snapshot
        tx1 = S.write_snapshot(db, db.snapshot_dir)
        dir1 = S.read_footer(S.snapshot_path(db.snapshot_dir, tx1))["index_dirname"]
        tx2 = S.write_snapshot(db, db.snapshot_dir)
        assert tx2 == tx1
        dir2 = S.read_footer(S.snapshot_path(db.snapshot_dir, tx2))["index_dirname"]
        assert dir2 != dir1
        assert not os.path.isdir(os.path.join(db.snapshot_dir, dir1))
        assert os.path.isdir(os.path.join(db.snapshot_dir, dir2))
        store.close()
        store2 = K.ColumnStore(storage_path=str(d), enable_wal=True)
        out = sum_by_type(K, store2.db("d"))
        store2.close()
        return out

    assert total(both(tmp_path, scenario)) == 24


# ---------------------------------------------------------------------------
# Persisted blocks as cached source parts (tests/test_source_cache.py)


def _source_setup(K, d):
    bucket = K.store.FileSystemBucket(str(d / "bucket"))
    store = K.ColumnStore(sources=[bucket], sinks=[bucket])
    db = store.db("test")
    table = db.table("t", K.config())
    table.insert_record(batch(K, table, ["a", "b", "a"], [1, 2, 3]))
    table.rotate_block()
    table.insert_record(batch(K, table, ["b", "c"], [10, 20], ts_start=10))
    return store, db, table


def _label_sums(K, db, compiled, ts=None):
    def build(q, E):
        if ts is not None:
            q = q.filter(E.Col("timestamp").gt_eq(ts))
        return q.aggregate([E.Sum(E.Col("value"))], [E.Col("labels.label1")])

    return run(K, db, build, compiled=compiled)


def _pairs(result):
    return sorted((dict(r)["labels.label1"], dict(r)["sum(value)"]) for r in result)


def test_query_spans_rotated_and_active(tmp_path):
    def scenario(K, d):
        _store, db, _t = _source_setup(K, d)
        generic = _label_sums(K, db, compiled=False)
        compiled = _label_sums(K, db, compiled=True)
        assert compiled == generic
        return generic

    assert _pairs(both(tmp_path, scenario)) == [("a", 4), ("b", 12), ("c", 20)]


def test_compiled_path_survives_rotation(tmp_path):
    def scenario(K, d):
        _store, db, _t = _source_setup(K, d)
        compiled = importlib.import_module(f"{K.name}.compiled")
        logical = importlib.import_module(f"{K.name}.query.logical")
        optimize = importlib.import_module(f"{K.name}.query.optimize")
        plan = (
            logical.Builder()
            .scan(db.table_provider(), "t")
            .aggregate([K.E.Sum(K.E.Col("value"))], [K.E.Col("labels.label1")])
            .build()
        )
        out = compiled.lower_plan(
            optimize.optimize(plan), K.physical.ExecOptions()
        ).execute()
        return rows([out])

    assert _pairs(both(tmp_path, scenario)) == [("a", 4), ("b", 12), ("c", 20)]


def test_bucket_read_once(tmp_path, monkeypatch):
    def scenario(K, d):
        _store, db, _t = _source_setup(K, d)
        reads = {"n": 0}
        orig = K.store.FileSystemBucket.read_block_parts

        def counting(self, ref, schema, get_dictionary):
            reads["n"] += 1
            return orig(self, ref, schema, get_dictionary)

        monkeypatch.setattr(K.store.FileSystemBucket, "read_block_parts", counting)
        first = _label_sums(K, db, compiled=False)
        after_first = reads["n"]
        second = _label_sums(K, db, compiled=False)
        third = _label_sums(K, db, compiled=True)
        assert reads["n"] == after_first, "repeat queries re-read the bucket"
        assert first == second == third
        return first, after_first

    both(tmp_path, scenario)


def test_filter_query_after_rotation(tmp_path):
    def scenario(K, d):
        _store, db, _t = _source_setup(K, d)
        got = _label_sums(K, db, compiled=True, ts=10)
        assert got == _label_sums(K, db, compiled=False, ts=10)
        return got

    assert _pairs(both(tmp_path, scenario)) == [("b", 10), ("c", 20)]


def test_source_parts_evict_deleted_blocks(tmp_path):
    def scenario(K, d):
        _store, db, table = _source_setup(K, d)
        _label_sums(K, db, compiled=False)
        assert table._source_parts
        shutil.rmtree(str(d / "bucket" / "test" / "t"))
        got = _label_sums(K, db, compiled=False)
        assert not table._source_parts
        return got

    assert _pairs(both(tmp_path, scenario)) == [("b", 10), ("c", 20)]


def test_read_only_bucket_table_discovery(tmp_path):
    def scenario(K, d):
        _store, db, table = _source_setup(K, d)
        table.rotate_block()
        expected = _label_sums(K, db, compiled=False)
        store2 = K.ColumnStore(sources=[K.store.FileSystemBucket(str(d / "bucket"))])
        db2 = store2.db("test")
        t2 = db2.get_table("t")
        assert t2 is not None and t2.read_only
        generic = _label_sums(K, db2, compiled=False)
        assert _pairs(generic) == _pairs(expected)
        assert _pairs(_label_sums(K, db2, compiled=True)) == _pairs(expected)
        with pytest.raises(K.table.ReadOnlyTableError):
            t2.insert_record(batch(K, t2, ["z"], [1]))
        assert db2.table("t", K.config()) is t2
        # Blocks list in block-id order, and block ids are random.
        return _pairs(generic)

    both(tmp_path, scenario)


# ---------------------------------------------------------------------------
# Background rotation and compaction (tests/test_background.py)


def gated_bucket(K, root):
    class GatedBucket(K.store.FileSystemBucket):
        def __init__(self, root):
            super().__init__(root)
            self.gate = threading.Event()
            self.upload_started = threading.Event()
            self.uploads = 0
            self.fail = False

        def upload_block(self, db, table, block_id, batch, schema):
            self.upload_started.set()
            assert self.gate.wait(10), "gate never released"
            if self.fail:
                raise OSError("injected sink failure")
            self.uploads += 1
            return super().upload_block(db, table, block_id, batch, schema)

    return GatedBucket(root)


def _bg_batch(K, table, ts_start=0, n=10):
    return batch(
        K, table, [f"g{i % 3}" for i in range(n)], np.ones(n, np.int64), ts_start
    )


def _sum_all(K, db):
    return run(K, db, lambda q, E: q.aggregate([E.Sum(E.Col("value"))], []))


def test_inserts_proceed_during_inflight_rotation(tmp_path):
    def scenario(K, d):
        bucket = gated_bucket(K, str(d / "bucket"))
        kw = dict(enable_wal=True, sources=[bucket], sinks=[bucket])
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=1), **kw
        )
        t0 = time.perf_counter()
        table.insert_record(_bg_batch(K, table))
        assert time.perf_counter() - t0 < 1.0
        assert bucket.upload_started.wait(5), "rotation persist never started"
        table.insert_record(_bg_batch(K, table, ts_start=10))
        during = _sum_all(K, db)
        assert bucket.uploads == 0
        bucket.gate.set()
        table.sync()
        assert bucket.uploads >= 1 and bucket.blocks("test", "t")
        assert _sum_all(K, db) == during
        store.close()
        store2 = K.ColumnStore(storage_path=str(d / "db"), **kw)
        after = _sum_all(K, store2.db("test"))
        store2.close()
        return during, after

    during, after = both(tmp_path, scenario)
    assert during == after == [(("sum(value)", 20),)]


def test_rotation_failure_surfaces_on_next_insert(tmp_path):
    def scenario(K, d):
        bucket = gated_bucket(K, str(d / "bucket"))
        bucket.fail = True
        bucket.gate.set()
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=1),
            enable_wal=True, sources=[bucket], sinks=[bucket],
        )
        table.insert_record(_bg_batch(K, table))
        with pytest.raises(OSError, match="injected sink failure"):
            table.wait_for_rotations()
        stranded = _sum_all(K, db)
        assert table.persisted_tx == 0
        bucket.fail = False
        table.sync()
        assert bucket.uploads >= 1
        healed = _sum_all(K, db)
        store.close()
        return stranded, healed

    assert both(tmp_path, scenario) == ([(("sum(value)", 10),)],) * 2


def test_background_compaction_keeps_results_identical(tmp_path, monkeypatch):
    def scenario(K, d):
        monkeypatch.setattr(K.table.DEFAULT_LEVELS[0], "max_size", 1)
        store, db, table = open_store(K, d, enable_wal=True)
        assert table.active_block.index.background
        for i in range(8):
            table.insert_record(_bg_batch(K, table, ts_start=i * 10))
        table.sync()
        levels = table.active_block.index.levels
        assert sum(len(l) for l in levels[1:]) > 0
        out = _sum_all(K, db), sorted(all_rows(K, db))
        store.close()
        return out

    assert both(tmp_path, scenario)[0] == [(("sum(value)", 80),)]


def test_sync_mode_still_available(tmp_path):
    def scenario(K, d):
        bucket = K.store.FileSystemBucket(str(d / "bucket"))
        store, db, table = open_store(
            K, d / "db", table_config=K.config(active_memory_size=1),
            enable_wal=True, sources=[bucket], sinks=[bucket],
            background_threads=False,
        )
        table.insert_record(_bg_batch(K, table))
        assert bucket.blocks("test", "t")
        out = _sum_all(K, db), all_rows(K, db)
        store.close()
        return out

    assert both(tmp_path, scenario)[0] == [(("sum(value)", 10),)]


# ---------------------------------------------------------------------------
# List columns through ingest, WAL, rotation and compaction
# (tests/test_list_columns.py)


LIST_ROWS = [
    ("a", ["main", "foo"], [1, 2, 3], 10),
    ("b", ["main", "bar", "baz"], [], 20),
    ("c", None, None, 30),
    ("d", [], [7], 40),
    ("e", ["main", "foo"], [1, 2, 3], 50),
]


def list_schema(K):
    S = K.schema
    return S.SchemaDef(
        name="lists",
        columns=[
            S.ColumnDef("name", S.StorageLayout(S.TYPE_STRING, nullable=True)),
            S.ColumnDef(
                "stacktrace",
                S.StorageLayout(S.TYPE_STRING, nullable=True, repeated=True),
            ),
            S.ColumnDef(
                "samples", S.StorageLayout(S.TYPE_INT64, nullable=True, repeated=True)
            ),
            S.ColumnDef("value", S.StorageLayout(S.TYPE_INT64, nullable=True)),
        ],
        sorting_columns=[S.SortingColumnDef("name", "asc")],
    )


def arrow_lists():
    import pyarrow as pa

    return pa.record_batch(
        {
            "name": pa.array([r[0] for r in LIST_ROWS]),
            "stacktrace": pa.array([r[1] for r in LIST_ROWS], type=pa.list_(pa.string())),
            "samples": pa.array([r[2] for r in LIST_ROWS], type=pa.list_(pa.int64())),
            "value": pa.array([r[3] for r in LIST_ROWS], type=pa.int64()),
        }
    )


def list_store(K, d=None):
    kw = {}
    if d is not None:
        bucket = K.store.FileSystemBucket(str(d / "bucket"))
        kw = dict(
            storage_path=str(d / "db"), enable_wal=True, sources=[bucket], sinks=[bucket]
        )
    store = K.ColumnStore(**kw)
    db = store.db("l")
    return store, db, db.table("t", K.config(schema=list_schema(K)))


def list_rows(K, db):
    out = run(
        K, db,
        lambda q, E: q.project(
            E.Col("name"), E.Col("stacktrace"), E.Col("samples"), E.Col("value")
        ),
    )
    return sorted((tuple(v for _n, v in r) for r in out), key=lambda r: r[0])


def test_list_arrow_round_trip(tmp_path):
    def scenario(K, d):
        cb = K.columnbatch
        b = cb.ColumnBatch.from_arrow(arrow_lists())
        st = b.column("stacktrace")
        assert st.kind == cb.KIND_LIST
        assert st.values[0] == st.values[4] and st.values[0] != st.values[1]
        b2 = cb.ColumnBatch.from_arrow(b.to_arrow())
        assert rows([b2]) == rows([b])
        return rows([b]), [int(v) for v in st.values]

    both(tmp_path, scenario)


def test_list_take_and_concat(tmp_path):
    def scenario(K, d):
        cb = K.columnbatch
        b = cb.ColumnBatch.from_arrow(arrow_lists())
        t = b.take(np.asarray([4, 2, 0]))
        dname = b.column("name").dictionary
        b2 = cb.ColumnBatch(
            [
                cb.Column("name", cb.KIND_DICT, *dname.encode(["z"]), dname),
                cb.Column(
                    "value", cb.KIND_INT64, np.asarray([99], dtype=np.int64),
                    np.ones(1, dtype=bool),
                ),
            ],
            1,
        )
        merged = K.physical.unify_concat([b, b2])
        assert merged.num_rows == 6
        assert merged.column("stacktrace").py_value(5) is None
        return rows([t]), rows([merged])

    both(tmp_path, scenario)


def test_list_ingest_query_and_group_by_list(tmp_path):
    def scenario(K, d):
        _store, db, table = list_store(K)
        table.insert_record(arrow_lists(), sort=True)
        out = [list_rows(K, db)]
        out.append(run(K, db, lambda q, E: q.aggregate(
            [E.Sum(E.Col("value"))], [E.Col("stacktrace")])))
        out.append(run(K, db, lambda q, E: q.distinct(E.Col("stacktrace"))))
        return out

    plain, grouped, distinct = both(tmp_path, scenario)
    assert plain == sorted(LIST_ROWS, key=lambda r: r[0])
    sums = {
        (tuple(r[0][1]) if r[0][1] is not None else None): r[1][1] for r in grouped
    }
    assert sums[("main", "foo")] == 60 and sums[()] == 40
    assert len(distinct) == 4


def test_lists_survive_wal_recovery_and_rotation(tmp_path):
    def scenario(K, d):
        store, db, table = list_store(K, d)
        table.insert_record(arrow_lists(), sort=True)
        expect = list_rows(K, db)
        store.close()
        store, db, table = list_store(K, d)
        assert list_rows(K, db) == expect
        table.rotate_block()
        assert list_rows(K, db) == expect
        store.close()
        store, db, table = list_store(K, d)
        got = list_rows(K, db)
        store.close()
        assert got == expect
        return got

    assert both(tmp_path, scenario) == sorted(LIST_ROWS, key=lambda r: r[0])


def test_list_compaction_merges_parts(tmp_path):
    def scenario(K, d):
        _store, db, table = list_store(K)
        table.insert_record(arrow_lists(), sort=True)
        table.insert_record(arrow_lists(), sort=True)
        table.active_block.index.compact_level(0)
        assert table.active_block.index.num_parts() == 1
        return list_rows(K, db)

    assert len(both(tmp_path, scenario)) == 2 * len(LIST_ROWS)


def test_list_records_builder_repeated_fields(tmp_path):
    def scenario(K, d):
        _store, db, table = list_store(K)
        b = K.records.build_batch(
            table,
            [
                {"name": "x", "stacktrace": ["a", "b"], "samples": [1], "value": 1},
                {"name": "y", "stacktrace": None, "samples": [2, 3], "value": 2},
            ],
        )
        assert b.column("stacktrace").kind == K.columnbatch.KIND_LIST
        table.insert_record(b, sort=True)
        return rows([b]), list_rows(K, db)

    assert both(tmp_path, scenario)[1][0] == ("x", ["a", "b"], [1], 1)


# ---------------------------------------------------------------------------
# Deterministic simulation suites (tests/test_dst.py, test_dst_crash.py,
# test_dst_eio.py), seeds kept


def dst_insert(K, table, rng, next_ts):
    n = int(rng.integers(1, 20))
    labels = [f"l{int(rng.integers(0, 5))}" for _ in range(n)]
    values = rng.integers(0, 100, n).astype(np.int64)
    b = batch(K, table, labels, values, ts_start=next_ts, stack="s")
    tx = table.insert_record(b, sort=True)
    return tx, list(range(next_ts, next_ts + n))


def read_timestamps(K, db):
    out = run(K, db, lambda q, E: q.project(E.Col("timestamp")))
    return sorted(v for r in out for _n, v in r if v is not None)


def wal_bytes(path, db_name):
    wal_dir = os.path.join(path, "databases", db_name, "wal")
    if not os.path.isdir(wal_dir):
        return 0
    return sum(os.path.getsize(os.path.join(wal_dir, f)) for f in os.listdir(wal_dir))


def dst_open(K, d, db_name, **kw):
    bucket = K.store.FileSystemBucket(str(d / "bucket"))
    store = K.ColumnStore(
        storage_path=str(d / "db"), enable_wal=True, sources=[bucket],
        sinks=[bucket], wal_segment_size=32 * 1024, **kw,
    )
    db = store.db(db_name)
    return store, db, db.table("t", K.config())


def command_stream(rng, weights):
    cmds = list(weights)
    probs = np.array([weights[c] for c in cmds])
    return cmds, probs / probs.sum()


DST_WEIGHTS = {
    "insert": 0.75, "compact": 0.25, "compact_l1": 0.10, "snapshot": 0.10,
    "rotate": 0.05, "restart": 0.01,
}


def maintenance_command(K, cmd, db, table):
    """The commands every suite shares; False for the others."""
    if cmd == "compact":
        table.active_block.index.compact_level(0)
    elif cmd == "compact_l1":
        table.active_block.index.compact_level(1)
    elif cmd == "snapshot":
        K.snapshot.write_snapshot(db, db.snapshot_dir)
    elif cmd == "rotate":
        table.rotate_block()
    else:
        return False
    return True


@pytest.mark.parametrize("seed", [0, 7, 21, 99])
def test_dst(tmp_path, seed):
    """400 random commands against a real store with a sync WAL, small
    segments and a bucket; every timestamp survives the final restart
    exactly once and the WAL stays bounded."""

    def scenario(K, d):
        rng = np.random.default_rng(seed)
        path = str(d / "db")
        store, db, table = dst_open(K, d, "dst")
        cmds, probs = command_stream(rng, DST_WEIGHTS)
        next_ts, max_wal, truncs = 0, 0, 0.0
        for _i in range(400):
            cmd = rng.choice(cmds, p=probs)
            max_wal = max(max_wal, wal_bytes(path, "dst"))
            if cmd == "insert":
                next_ts += len(dst_insert(K, table, rng, next_ts)[1])
            elif cmd == "restart":
                truncs += store.metrics.wal_truncations.value()
                store.close()
                store, db, table = dst_open(K, d, "dst")
            else:
                maintenance_command(K, cmd, db, table)
        truncs += db.store.metrics.wal_truncations.value()
        assert truncs > 0
        assert max_wal < 512 * 1024, f"WAL grew unbounded: peak {max_wal} bytes"
        K.snapshot.write_snapshot(db, db.snapshot_dir)
        assert wal_bytes(path, "dst") <= 3 * 32 * 1024
        store.close()
        store, db, _table = dst_open(K, d, "dst")
        got = read_timestamps(K, db)
        store.close()
        assert got == list(range(next_ts)), f"wrote {next_ts}, read {len(got)}"
        return got

    both(tmp_path, scenario)


CRASH_WEIGHTS = {
    "insert": 0.70, "compact": 0.20, "compact_l1": 0.08, "snapshot": 0.10,
    "rotate": 0.05, "kill": 0.08, "restart": 0.02,
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
def test_dst_crash(tmp_path, seed):
    """Hard kills of an async-WAL store with background threads: rows not
    in the lossable set survive exactly once, nothing is duplicated. Which
    queued entries a kill drops depends on thread timing, so each package
    is held to the invariant on its own; the command stream is the same."""

    def scenario(K, d):
        rng = np.random.default_rng(seed)
        store, db, table = dst_open(K, d, "dstc", wal_sync=False)
        cmds, probs = command_stream(rng, CRASH_WEIGHTS)
        next_ts, kills = 0, 0
        rows_by_tx: dict = {}
        may_be_lost: set = set()
        for _i in range(300):
            cmd = rng.choice(cmds, p=probs)
            if cmd == "insert":
                tx, r = dst_insert(K, table, rng, next_ts)
                rows_by_tx[tx] = r
                next_ts += len(r)
            elif cmd == "restart":
                store.close()
                store, db, table = dst_open(K, d, "dstc", wal_sync=False)
            elif cmd == "kill":
                kills += 1
                lost = db.wal.hard_kill(
                    partial_writes=int(rng.integers(0, 6)),
                    tear_bytes=int(rng.integers(0, 300)),
                )
                for tx in lost:
                    may_be_lost.update(rows_by_tx.get(tx, ()))
                if rng.random() < 0.3 and db.snapshot_dir is not None:
                    os.makedirs(db.snapshot_dir, exist_ok=True)
                    bogus = K.snapshot.snapshot_path(db.snapshot_dir, db.high_watermark() + 1)
                    with open(bogus, "wb") as f:
                        f.write(b"FDBT" + bytes(rng.integers(0, 256, 64).astype(np.uint8)))
                db.join_background()
                store, db, table = dst_open(K, d, "dstc", wal_sync=False)
            else:
                maintenance_command(K, cmd, db, table)
        assert kills > 0
        for tx in db.wal.hard_kill(partial_writes=int(rng.integers(0, 6))):
            may_be_lost.update(rows_by_tx.get(tx, ()))
        db.join_background()
        store, db, _table = dst_open(K, d, "dstc", wal_sync=False)
        got = read_timestamps(K, db)
        if db.wal.repairs:
            line = [
                l for l in store.metrics.expose().splitlines()
                if l.startswith("frostdb_tpu_wal_repairs_total")
            ][0]
            assert float(line.split()[-1]) >= db.wal.repairs
        store.close()
        written = set(range(next_ts))
        assert len(got) == len(set(got)), "duplicated rows after crash recovery"
        assert set(got) <= written, "phantom rows"
        missing = (written - may_be_lost) - set(got)
        assert not missing, f"lost {len(missing)} durable rows"
        return next_ts, kills

    both(tmp_path, scenario)


EIO_WEIGHTS = {
    "insert": 0.66, "compact": 0.18, "compact_l1": 0.06, "snapshot": 0.08,
    "rotate": 0.05, "restart": 0.06,
}


def eio_reopen(K, d, injector):
    attempts = 0
    while True:
        try:
            return dst_open(
                K, d, "dste", wal_sync=True, background_threads=False,
                fault_injector=injector,
            ), attempts
        except OSError as e:
            assert "injected I/O error" in str(e), e
            attempts += 1
            assert attempts < 200, "recovery never succeeded"


# seed 17: an EIO'd advisory new-block WAL entry must still queue the old
# block's persist, or a later rotation reclaims its only durable copy
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 17, 21])
def test_dst_eio(tmp_path, seed):
    """EIO injected on writes, fsyncs and snapshots while the store keeps
    running (sync WAL, no background threads): every acknowledged insert
    survives every restart exactly once. A rotation whose new-block entry
    took an EIO persists on its worker without the caller waiting, so which
    later writes take a fault varies from run to run: each package is held
    to the invariant on its own; the command stream is the same."""

    def scenario(K, d):
        rng = np.random.default_rng(seed)
        injector = K.faults.FaultInjector(
            seed=seed + 1, p_write=0.06, p_fsync=0.04, p_snapshot=0.25
        )
        (store, db, table), _r = eio_reopen(K, d, injector)
        cmds, probs = command_stream(rng, EIO_WEIGHTS)
        next_ts, eio_seen = 0, 0
        acked: set = set()
        for _i in range(200):
            cmd = rng.choice(cmds, p=probs)
            try:
                if cmd == "insert":
                    r = dst_insert(K, table, rng, next_ts)[1]
                    acked.update(r)
                    next_ts += len(r)
                elif cmd == "restart":
                    try:
                        store.close()
                    except OSError as e:
                        assert "injected I/O error" in str(e), e
                        eio_seen += 1
                    (store, db, table), retries = eio_reopen(K, d, injector)
                    eio_seen += retries
                    got = read_timestamps(K, db)
                    assert not [r for r, c in collections.Counter(got).items() if c > 1]
                    assert not acked - set(got), "lost acked rows"
                else:
                    maintenance_command(K, cmd, db, table)
            except OSError as e:
                assert "injected I/O error" in str(e), e
                eio_seen += 1
        assert injector.injected > 0 and eio_seen > 0
        assert acked <= set(read_timestamps(K, db))
        try:
            store.close()
        except OSError as e:
            assert "injected I/O error" in str(e), e
        store2, db2, _t2 = dst_open(
            K, d, "dste", wal_sync=True, background_threads=False,
            fault_injector=K.faults.FaultInjector(),
        )
        got2 = read_timestamps(K, db2)
        store2.close()
        assert acked <= set(got2)
        assert not [r for r, c in collections.Counter(got2).items() if c > 1]
        return len(cmds)

    both(tmp_path, scenario)


# ---------------------------------------------------------------------------
# Cross-package stores: one package writes, both recover


def write_store(K, d, kind):
    """A store of ``kind`` under ``d``, closed; returns the writer's rows."""
    bucket = K.store.FileSystemBucket(str(d / "bucket"))
    kw = dict(enable_wal=True)
    if kind == "bucket":
        kw.update(sources=[bucket], sinks=[bucket])
    cfg = K.config(active_memory_size=300 if kind == "bucket" else 512 << 20)
    store, db, table = open_store(K, d / "db", "x", table_config=cfg, **kw)
    labels = ["a", "b", "c", "a", "d"]
    for i in range(6):
        table.insert_record(
            batch(K, table, labels[i % 3: i % 3 + 3], [i, 2 * i, 3 * i], ts_start=10 * i),
            sort=True,
        )
        if kind == "snapshot" and i == 2:
            K.snapshot.write_snapshot(db, db.snapshot_dir)
        if kind == "disklevel" and i == 3:
            table.active_block.index.compact_level(0)
            table.active_block.index.compact_level(1)
            K.snapshot.write_snapshot(db, db.snapshot_dir)
    table.sync()
    out = sorted(all_rows(K, db))
    store.close()
    return out


def recover_store(K, d, kind):
    kw = dict(enable_wal=True)
    if kind == "bucket":
        bucket = K.store.FileSystemBucket(str(d / "bucket"))
        kw.update(sources=[bucket], sinks=[bucket])
    store = K.ColumnStore(storage_path=str(d / "db"), **kw)
    db = store.db("x")
    out = all_rows(K, db), sum_by_type(K, db), db.high_watermark()
    store.close()
    return out


@pytest.mark.parametrize("kind", ["wal", "snapshot", "disklevel", "bucket"])
@pytest.mark.parametrize("writer", PKGS, ids=str)
def test_store_recovers_across_packages(tmp_path, writer, kind):
    """A WAL, snapshot, disk-level or bucket store one package wrote
    recovers in both packages with the same rows, order included, equal to
    what the writer held."""
    src = tmp_path / "src"
    src.mkdir()
    written = write_store(writer, src, kind)
    if kind == "disklevel":
        assert any(
            f.endswith(".parquet")
            for _r, _d, files in os.walk(src / "db") for f in files
        )
    if kind == "bucket":
        assert writer.store.FileSystemBucket(str(src / "bucket")).blocks("x", "t")
    got = {}
    for K in PKGS:
        dst = tmp_path / K.name
        shutil.copytree(src, dst)
        got[K.name] = recover_store(K, dst, kind)
    assert got[PORT.name] == got[JAX.name]
    assert sorted(got[PORT.name][0]) == written


# ---------------------------------------------------------------------------
# Arrow string columns into table dictionaries


@pytest.mark.parametrize("seed", range(6))
def test_from_arrow_codes_match_jax(seed):
    """The port encodes only the distinct values an Arrow string column
    uses (recovery decodes every WAL entry, snapshot part and bucket row
    group this way); the codes, validity and dictionary growth must equal
    the JAX package's row-by-row encoding, for string, large string, binary
    and dictionary arrays, with nulls and a dictionary already holding some
    of the values."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    pool = np.array(["a", "b", "c", "dd", "é", "x" * 5, "zz"], dtype=object)
    for trial in range(40):
        n = int(rng.integers(0, 60))
        vals = [None if rng.random() < 0.15 else str(rng.choice(pool)) for _ in range(n)]
        kind = trial % 4
        if kind == 0:
            arr = pa.array(vals, type=pa.string())
        elif kind == 1:
            arr = pa.array(vals, type=pa.large_string())
        elif kind == 2:
            arr = pa.array([v.encode() if v is not None else None for v in vals])
        else:
            dvals = list(rng.permutation(pool)[:5]) + ([str(pool[0])] if trial % 3 else [])
            idx = [None if rng.random() < 0.15 else int(rng.integers(0, len(dvals)))
                   for _ in range(n)]
            arr = pa.DictionaryArray.from_arrays(pa.array(idx, type=pa.int32()), pa.array(dvals))
        pre = [str(v) for v in rng.permutation(["b", "zz", "é", "q"])[: int(rng.integers(0, 4))]]
        out = []
        for K in PKGS:
            d = K.columnbatch.Dictionary()
            d.encode(pre)
            cb = K.columnbatch.ColumnBatch.from_arrow(
                pa.record_batch({"labels.x": arr}), get_dictionary=lambda _f, d=d: d
            )
            c = cb.columns[0]
            out.append((c.values.tolist(), c.validity.tolist(), list(d.values)))
        assert out[0] == out[1], (seed, trial, vals)
