"""The port's dbtool against the JAX package's (the dbtool cases of
tests/test_components.py): on the same store files both tools print the
same report, and each inspects the other package's WAL, snapshots and
bucket blocks."""

import importlib
import json
import os

import numpy as np
import pytest

from test_torch_durability import JAX, PKGS, make_batch, open_store

DBTOOL = {K.name: importlib.import_module(f"{K.name}.tools.dbtool") for K in PKGS}


def report(K, argv, capsys):
    DBTOOL[K.name].main(argv)
    return capsys.readouterr().out


def same_report(argv, capsys):
    outs = [report(K, argv, capsys) for K in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


@pytest.fixture(params=PKGS, ids=str)
def written(request, tmp_path):
    """A store one package wrote: WAL, a snapshot and a bucket block."""
    K = request.param
    bucket = K.store.FileSystemBucket(str(tmp_path / "bucket"))
    store, db, table = open_store(
        K, tmp_path / "db", "x", enable_wal=True, sources=[bucket], sinks=[bucket]
    )
    table.insert_record(make_batch(K, table, n=5))
    tx = K.snapshot.write_snapshot(db, db.snapshot_dir)
    table.insert_record(make_batch(K, table, n=4, ts_start=10))
    table.rotate_block()
    table.insert_record(make_batch(K, table, n=2, ts_start=20))
    store.close()
    (block,) = bucket.blocks("x", "t")
    return {
        "tx": tx,
        "snapshot": os.path.join(db.snapshot_dir, f"{tx:020d}.fdbt"),
        "wal": str(tmp_path / "db" / "databases" / "x" / "wal"),
        "parquet": bucket.block_path("x", "t", block),
        "bucket": str(tmp_path / "bucket"),
    }


def test_dbtool_snapshot(written, capsys):
    out = same_report(["snapshot", written["snapshot"]], capsys)
    assert f"snapshot tx: {written['tx']}" in out and "table t:" in out


@pytest.mark.parametrize("verbose", [False, True])
def test_dbtool_wal(written, capsys, verbose):
    argv = ["wal", written["wal"]] + (["--verbose"] if verbose else [])
    out = same_report(argv, capsys)
    assert "entries:" in out and "write" in out and "table_block_persisted" in out


@pytest.mark.parametrize(
    "argv",
    [
        ["parquet-stats"],
        ["parquet-rowgroups"],
        ["parquet-row", "1", "3"],
        ["parquet-row", "99", "1"],
    ],
    ids=lambda a: "-".join(a),
)
def test_dbtool_parquet_reports(written, capsys, argv):
    out = same_report(argv + [written["parquet"]], capsys)
    assert out.strip()
    if argv[0] == "parquet-stats":
        assert "rows: 9" in out and "frostdb_tpu.schema" in out


@pytest.mark.parametrize("where", ["timestamp=11", "labels.label1=v2", "value=99"])
def test_dbtool_parquet_find(written, capsys, where):
    out = same_report(["parquet-find", where, written["bucket"]], capsys)
    expect = {"timestamp=11": 1, "labels.label1=v2": 2, "value=99": 0}[where]
    assert f"matched {expect} rows" in out


def test_dbtool_invalid_snapshot(tmp_path, capsys):
    bad = tmp_path / "00000000000000000001.fdbt"
    bad.write_bytes(b"FDBT-not-a-snapshot")
    for K in PKGS:
        with pytest.raises(SystemExit):
            DBTOOL[K.name].main(["snapshot", str(bad)])
        assert "INVALID snapshot" in capsys.readouterr().out


def test_dbtool_reencode(tmp_path, capsys):
    """Both tools re-sort an unsorted parquet file by a schema's sorting
    columns to the same rows, tagged with the schema."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    K = JAX
    table = K.ColumnStore().db("x").table("t", K.config())
    b = make_batch(K, table, n=6)
    rev = b.take(np.arange(b.num_rows)[::-1])
    src = str(tmp_path / "in.parquet")
    pq.write_table(pa.Table.from_batches([rev.to_arrow()]), src)
    sfile = str(tmp_path / "schema.json")
    with open(sfile, "w") as f:
        json.dump(K.schema.sample_definition().to_dict(), f)
    got = []
    for P in PKGS:
        out_path = str(tmp_path / f"{P.name}.parquet")
        assert "reencoded 6 rows" in report(P, ["reencode", src, sfile, out_path], capsys)
        t = pq.read_table(out_path)
        assert b"frostdb_tpu.schema" in t.schema.metadata
        got.append(t.to_pylist())
    assert got[0] == got[1]
    ts = [r["timestamp"] for r in got[1]]
    assert ts == sorted(ts)


def test_dbtool_runs_as_a_module(written):
    """``python -m frostdb_tpu_torch.tools.dbtool`` from the repository root."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "frostdb_tpu_torch.tools.dbtool", "wal", written["wal"]],
        cwd=repo, capture_output=True, text=True, check=True, timeout=120,
    ).stdout
    assert "entries:" in out
