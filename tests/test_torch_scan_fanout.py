"""The threaded scan fan-out in the port (``Table.iterator``'s lanes,
``config.PARALLEL_SCAN_MIN_ROWS``) against the JAX package:
tests/test_scan_fanout.py's cases run through the port (``port_view``,
with the reference's own assertions: lanes byte-identical to a serial scan,
lane threads spawned, a lane's exception raised on the query thread), and
each shape's rows, serial and fanned out, must equal the JAX package's.

Each package's ``_run`` patches its own ``config.PARALLEL_SCAN_MIN_ROWS``
(0 forces the fan-out on, 2^60 off) and runs with ``concurrency=8``.
"""

import threading

import pytest

import test_scan_fanout as TSF
from test_torch_engine import port_view

import frostdb_tpu_torch.table as port_table

PSF = port_view(TSF)
SHAPES = {name: ordered for name, _build, ordered in TSF.SHAPES}


def builds(M):
    return {name: build for name, build, _ordered in M.SHAPES}


def lanes_spawned(monkeypatch, run):
    """The lane threads the port's table module starts while ``run()``."""
    spawned = []
    orig = threading.Thread

    class SpyThread(orig):
        def __init__(self, *a, **kw):
            spawned.append(kw.get("target"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(port_table.threading, "Thread", SpyThread)
    try:
        return run(), spawned
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("name", list(SHAPES))
def test_fanout_byte_identical(name, monkeypatch):
    PSF.test_fanout_byte_identical(name, builds(PSF)[name], SHAPES[name])
    _s, jdb = TSF._setup()
    _s, pdb = PSF._setup()
    ref = TSF._run(jdb, builds(TSF)[name], parallel=False, ordered=SHAPES[name])
    serial = PSF._run(pdb, builds(PSF)[name], parallel=False, ordered=SHAPES[name])
    fanned, spawned = lanes_spawned(
        monkeypatch,
        lambda: PSF._run(pdb, builds(PSF)[name], parallel=True, ordered=SHAPES[name]),
    )
    assert serial == ref
    assert fanned == ref
    assert spawned, name


def test_fanout_limit_total_rows():
    PSF.test_fanout_limit_total_rows()
    got = []
    for M in (TSF, PSF):
        _s, db = M._setup()
        got.append(M._run(db, lambda e: e.scan_table("t").limit(M.E.Literal(100)), parallel=True))
    assert got[1] == got[0] and len(got[1][1]) == 100


def test_fanout_memory_limit_propagates():
    PSF.test_fanout_memory_limit_propagates()


def test_fanout_threads_actually_spawn(monkeypatch):
    PSF.test_fanout_threads_actually_spawn(monkeypatch)


def test_streaming_source_fans_out_byte_identical(monkeypatch):
    PSF.test_streaming_source_fans_out_byte_identical(monkeypatch)
    monkeypatch.undo()
    got = []
    for M in (TSF, PSF):
        _s, db = M._setup()
        db.sources.append(M._FakeStreamingSource(M._src_batches(db)))
        E = M.E
        got.append(
            [
                M._run(db, build, parallel=parallel)
                for build in (
                    lambda e: e.scan_table("t").aggregate(
                        [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
                        [E.Col("example_type")],
                    ),
                    lambda e: e.scan_table("t").filter(E.Col("timestamp").gt_eq(0)).project(
                        E.Col("example_type"), E.Col("value")
                    ),
                )
                for parallel in (False, True)
            ]
        )
    assert got[1] == got[0]
    assert got[1][0] == got[1][1] and got[1][2] == got[1][3]
