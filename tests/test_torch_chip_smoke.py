"""chip_smoke.py's phases 9 ("the rest of the package on the card") and
10 (the reference's differential fuzz) rehearsed on the CPU at a cut
size: each part runs its checks on a ``device="cpu"`` store, so the
phases' own logic (tools/verify's cases, the fan-out against a serial
scan, concurrent writers under compiled readers, the traced queries, the
pruning counts from the table's part layout, struct rotation and recovery,
the read path's A/B, the fuzz at two rows scales) is exercised here. The
kernel-launch and tier-coverage checks apply to CUDA tables only; the card
run holds them.
"""

import pytest

import chip_smoke as CS

from frostdb_tpu_torch.db import ColumnStore
from frostdb_tpu_torch.ops import agg_kernels as AK


@pytest.fixture
def cut(monkeypatch):
    monkeypatch.setattr(CS, "ROWS_PER_PART", 1 << 12)
    monkeypatch.setattr(CS, "VERIFY_SCALES", (1, 3))
    monkeypatch.setattr(CS, "CC_INSERTS", 4)
    monkeypatch.setattr(CS, "CC_ROWS", 1 << 10)
    monkeypatch.setattr(CS, "CC_PAUSE_S", 0.01)
    monkeypatch.setattr(CS, "STRUCT_ROWS", 1 << 8)


def printed(capsys):
    return capsys.readouterr().out


def test_verify_part(cut, capsys):
    CS.verify_part("cpu")
    assert printed(capsys).count(": ok,") == 2 * 2 * 10


def test_fanout_part(cut, capsys):
    db = ColumnStore(device="cpu").db("smoke")
    CS.build_table(db, "t2", 2)
    CS.fanout_part(db)
    assert printed(capsys).count("byte-identical") == 5


def test_concurrency_part(cut, capsys):
    CS.concurrency_part(AK, "cpu")
    assert "each == numpy" in printed(capsys)


def test_tracing_part(cut, capsys):
    CS.tracing_part(AK, "cpu")
    assert '"generic": 1' in printed(capsys)


@pytest.mark.parametrize("rows", [1 << 10, 1 << 16])
def test_pruning_part(cut, capsys, rows):
    CS.pruning_part("cpu", rows)
    log = printed(capsys)
    if rows == 1 << 10:  # eight label-disjoint parts
        assert "in 8 parts" in log and "label_eq 7 pruned" in log and "max 7 pruned" in log


def test_struct_part(cut, capsys):
    CS.struct_part(AK, "cpu")
    assert "before and after recovery" in printed(capsys)


def test_read_path_cost(cut, capsys, monkeypatch):
    monkeypatch.setattr(CS, "READ_PATH_ROUNDS", 2)
    db = ColumnStore(device="cpu").db("smoke")
    CS.build_table(db, "t", 2)
    CS.read_path_cost(db)
    assert printed(capsys).count("rounds faster as is") == 5


def test_fuzz_phase(cut, capsys, monkeypatch):
    """Phase 10 at a cut size: the fuzz at rows scale 1 against a CPU copy
    (here the CPU against itself) and at a small scale; the NaN-sign check;
    on the CPU nothing counts as a launch."""
    monkeypatch.setattr(CS, "FUZZ_EXTRA_SEEDS", 2)
    monkeypatch.setattr(CS, "FUZZ_SCALE", 3)
    launches = CS.fuzz_phase(AK, "cpu")
    log = printed(capsys)
    assert "fuzz x1 aggregates: 66 queries" in log
    assert "fuzz x1 directed shapes: 11 queries" in log
    assert "fuzz x3 aggregates: 36 queries" in log and "fuzz x3 directed" not in log
    assert "0 out-of-gate float sums" in log
    assert not any(launches.values())


def test_scan_layout_and_host_breakdown(cut, capsys, monkeypatch):
    """Phase 2's scan lines, read from the scan spans (``scan/blocks``,
    ``result/copy``, ``result/epilogue``) of traced queries."""
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine

    monkeypatch.setattr(CS, "QUERY_REPS", 3)
    db = ColumnStore(device="cpu").db("smoke")
    CS.build_table(db, "t", 2)
    engine = LocalEngine(db.table_provider())
    overflow = CS.scan_layout(engine, E, 2 * CS.ROWS_PER_PART)
    scans = [name for name, *_r in CS.scan_shapes(E, 0) if name.startswith("scan")]
    assert sorted(overflow) == sorted(scans)
    CS.scan_host_breakdown(engine, E, set(scans))
    log = printed(capsys)
    assert log.count("1 dispatches") + log.count("2 dispatches") == len(scans)
    assert log.count("host breakdown (median ms)") == len(scans)
    assert engine.exec_options.tracer is None
