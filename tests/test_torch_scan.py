"""The port's compiled_scan tier (filter -> project [-> limit] row
retrieval over the block-compaction kernel) against the JAX package.

Tables are built with the JAX package (the table functions of
tests/test_compiled_scan.py, tests/test_differential_fuzz.py and
tests/test_memlimit_fast_tiers.py) and carried across with
``frostdb_tpu_torch.interop.table_from_numpy``; the queries are the JAX
tests' own, built with the JAX expression classes and converted. Every
case requires the same rows, row order and batch boundaries as the JAX
package's compiled_scan tier and generic DAG, and the same serving path.
"""

import numpy as np
import pytest

import test_compiled_scan as CS
import test_differential_fuzz as FZ
import test_memlimit_fast_tiers as ML
from test_torch_engine import carry, to_port
from frostdb_tpu.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.schema import sample_definition
from frostdb_tpu.table import TableConfig as JTableConfig

import frostdb_tpu_torch.compiled_scan as PCS
from frostdb_tpu_torch.memorylimit import LimitAllocator, MemoryLimitExceeded
from frostdb_tpu_torch.ops import agg_kernels as AK
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions


class PortQuery:
    """A port query driven with JAX-package expressions: every
    method call converts its arguments with ``to_port``."""

    def __init__(self, q):
        self._q = q

    def __getattr__(self, name):
        fn = getattr(self._q, name)

        def call(*args, **kwargs):
            out = fn(
                *to_port(list(args)),
                **{k: to_port(v) for k, v in kwargs.items()},
            )
            return out if name == "execute" else PortQuery(out)

        return call


class PortEngine:
    def __init__(self, engine):
        self.engine = engine

    def scan_table(self, name):
        return PortQuery(self.engine.scan_table(name))

    def scan_schema(self, name):
        return PortQuery(self.engine.scan_schema(name))


def batches(bs):
    """Per batch, its rows as (name, kind, value) tuples: batch boundaries,
    row order, kinds and values (floats by repr and sign) all compare."""
    out = []
    for b in bs:
        rows = []
        for i in range(b.num_rows):
            row = []
            for c in b.columns:
                v = c.py_value(i)
                if isinstance(v, float):
                    v = repr(v) + ("/n" if np.signbit(v) else "")
                row.append((c.name, c.kind, v))
            rows.append(tuple(row))
        out.append(rows)
    return out


def run_jax(jdb, make_q, compiled, **kw):
    eng = JEngine(jdb.table_provider(), JOptions(compiled_serving=compiled), **kw)
    out = []
    make_q(eng).execute(out.append)
    return batches(out), eng.last_serving_path


def run_port(pdb, make_q, compiled=True, **kw):
    eng = PEngine(pdb.table_provider(), POptions(compiled_serving=compiled), **kw)
    out = []
    make_q(PortEngine(eng)).execute(out.append)
    return batches(out), eng.last_serving_path, eng.last_fallback_reasons


def check_parity(jdb, pdb, make_q, path):
    """The port's compiled tier == the JAX package's compiled tier == its
    generic DAG == the port's generic DAG, batch by batch; both fast
    tiers report ``path``."""
    ref, _ = run_jax(jdb, make_q, compiled=False)
    jfast, jpath = run_jax(jdb, make_q, compiled=True)
    fast, ppath, reasons = run_port(pdb, make_q)
    generic, gpath, _ = run_port(pdb, make_q, compiled=False)
    assert jpath == path
    assert ppath == path, reasons
    assert gpath == "generic"
    assert jfast == ref
    assert fast == ref
    assert generic == ref
    return fast


def scan_q(q_fn, table="t"):
    return lambda e: q_fn(e.scan_table(table))


@pytest.fixture(scope="module")
def scan_dbs():
    _s, jdb, _t = CS._mk()
    return jdb, carry(jdb)


# ---------------------------------------------------------------------------
# tests/test_compiled_scan.py through both packages


@pytest.mark.parametrize("qname", sorted(CS.QUERIES))
def test_scan_parity(scan_dbs, qname):
    jdb, pdb = scan_dbs
    check_parity(jdb, pdb, scan_q(CS.QUERIES[qname]), "compiled_scan")


def test_no_host_filter_evaluation(scan_dbs, monkeypatch):
    """The device path does not evaluate the filter on the host."""
    import frostdb_tpu_torch.query.physeval as pe

    _jdb, pdb = scan_dbs
    make_q = scan_q(CS.QUERIES["filter-project"])
    run_port(pdb, make_q)

    def boom(*a, **k):
        raise AssertionError("host filter_mask called on the device path")

    monkeypatch.setattr(pe, "filter_mask", boom)
    fast, path, _ = run_port(pdb, make_q)
    assert path == "compiled_scan"
    assert sum(len(b) for b in fast) > 0


def _record_capb(monkeypatch):
    capbs = []
    orig = AK.block_compact

    def rec(sel, capb):
        capbs.append(capb)
        return orig(sel, capb)

    monkeypatch.setattr(AK, "block_compact", rec)
    return capbs


def test_capacity_escalation(monkeypatch):
    """Oversized partial blocks escalate the per-block capacity with one
    more dispatch; the capacity is cached per table, so the next query of
    the structure takes one dispatch."""
    import frostdb_tpu.compiled_scan as JCS

    monkeypatch.setattr(JCS, "_CAPB0", 2)
    monkeypatch.setattr(PCS, "_CAPB0", 2)
    JCS._SCAN_CACHE.clear()
    _s, jdb, _t = CS._mk()
    pdb = carry(jdb)
    capbs = _record_capb(monkeypatch)
    make_q = scan_q(lambda q: q.filter(JE.Col("timestamp").gt_eq(500)))
    fast = check_parity(jdb, pdb, make_q, "compiled_scan")
    assert sum(len(b) for b in fast) > 500
    # one block holds all 3 parts (1024 padded rows each): ~780 selected
    assert capbs == [2, 1024]
    del capbs[:]
    run_port(pdb, make_q)
    assert capbs == [1024]
    JCS._SCAN_CACHE.clear()


def test_host_refilter_overflow_blocks(monkeypatch):
    """Blocks past _CAPB_MAX re-filter on the host with identical results;
    the one block here straddles all three parts."""
    import frostdb_tpu.compiled_scan as JCS

    for m in (JCS, PCS):
        monkeypatch.setattr(m, "_CAPB0", 2)
        monkeypatch.setattr(m, "_CAPB_MAX", 2)
    JCS._SCAN_CACHE.clear()
    _s, jdb, _t = CS._mk()
    pdb = carry(jdb)
    make_q = scan_q(
        lambda q: q.filter(JE.Col("timestamp").gt_eq(500)).project(
            JE.Col("value"), JE.Col("example_type")
        )
    )
    check_parity(jdb, pdb, make_q, "compiled_scan")
    JCS._SCAN_CACHE.clear()


def test_full_block_shortcut():
    """A filter selecting every row of whole blocks takes the arange path
    (bc == block size)."""
    _s, jdb, _t = CS._mk(rows=9000)
    pdb = carry(jdb)
    check_parity(
        jdb, pdb, scan_q(lambda q: q.filter(JE.Col("timestamp").gt_eq(-1))),
        "compiled_scan",
    )


def _exact_parts_db(sizes, seed=3):
    """A table whose parts hold exactly their padded sizes (powers of two
    >= 1024), so the port's 8192-row blocks start inside parts."""
    store = JColumnStore()
    jdb = store.db("x")
    table = jdb.table("t", JTableConfig(schema=sample_definition()))
    rng = np.random.default_rng(seed)
    d_et = table.dictionary("example_type")
    d_st = table.dictionary("stacktrace")
    for n in sizes:
        et, etv = d_et.encode(rng.choice(["cpu", "mem"], n).tolist())
        st, stv = d_st.encode(["s"] * n)
        table.insert_record(
            ColumnBatch(
                [
                    Column("example_type", KIND_DICT, et, etv, d_et),
                    Column("stacktrace", KIND_DICT, st, stv, d_st),
                    Column("timestamp", KIND_INT64,
                           rng.integers(0, 1000, n).astype(np.int64), np.ones(n, bool)),
                    Column("value", KIND_INT64,
                           rng.integers(-100, 100, n).astype(np.int64), np.ones(n, bool)),
                ],
                n,
            )
        )
    return store, jdb


@pytest.mark.parametrize(
    "lit,capb_max",
    [
        (-1, 1024),  # every row: full blocks straddling parts (arange path)
        (990, 1024),  # ~1%: compacted offsets across part boundaries
        (500, 4),  # ~50% past a tiny capacity: straddled host re-filter
    ],
)
def test_blocks_straddling_parts(monkeypatch, lit, capb_max):
    import frostdb_tpu.compiled_scan as JCS

    for m in (JCS, PCS):
        monkeypatch.setattr(m, "_CAPB_MAX", capb_max)
        monkeypatch.setattr(m, "_CAPB0", min(16, capb_max))
    JCS._SCAN_CACHE.clear()
    _s, jdb = _exact_parts_db([4096, 2048, 1024, 4096, 8192, 1024])
    pdb = carry(jdb)
    fast = check_parity(
        jdb, pdb,
        scan_q(lambda q: q.filter(JE.Col("timestamp").gt(lit)).project(
            JE.Col("timestamp"), JE.Col("value"))),
        "compiled_scan",
    )
    assert len(fast) == 6
    JCS._SCAN_CACHE.clear()


def test_unfiltered_scan_stays_generic(scan_dbs):
    _jdb, pdb = scan_dbs
    _out, path, reasons = run_port(pdb, scan_q(lambda q: q.project(JE.Col("value"))))
    assert path == "generic"
    assert reasons["compiled_scan"] == "unfiltered scan (generic path)"
    assert reasons["compiled_join"] == "root is not an aggregation"
    assert reasons["dense"] == "root is not an aggregation"


def test_empty_result(scan_dbs):
    _jdb, pdb = scan_dbs
    out, path, _ = run_port(
        pdb, scan_q(lambda q: q.filter(JE.Col("timestamp").gt_eq(10**9)))
    )
    assert path == "compiled_scan"
    assert out == []


@pytest.mark.parametrize("n", [0, 1, 7, 100, 10**6])
def test_limit_parity(scan_dbs, n):
    jdb, pdb = scan_dbs
    make_q = scan_q(
        lambda qb: qb.filter(JE.Col("timestamp").lt(500)).project(
            JE.Col("example_type"), JE.Col("value")
        ).limit(JE.Literal(n))
    )
    check_parity(jdb, pdb, make_q, "compiled_scan")


def test_limit_without_projection(scan_dbs):
    jdb, pdb = scan_dbs
    make_q = scan_q(
        lambda qb: qb.filter(JE.Col("timestamp").gt_eq(900)).limit(JE.Literal(13))
    )
    check_parity(jdb, pdb, make_q, "compiled_scan")


# ---------------------------------------------------------------------------
# The scan half of tests/test_differential_fuzz.py::test_scan_and_epilogue_differential


@pytest.mark.parametrize("seed", range(8))
def test_scan_differential(seed):
    rng = np.random.default_rng(5000 + seed)
    _store, jdb = FZ.build_db(rng)
    pdb = carry(jdb)
    filt = FZ.random_filter(rng, 10**5) or JE.Col("ts").gt_eq(0)
    lim = int(rng.integers(0, 50))

    def make_q(e):
        q = e.scan_table("t").filter(filt).project(
            JE.Col("g"), JE.Col("v"), JE.Col("f")
        )
        if lim:
            q = q.limit(JE.Literal(lim))
        return q

    ref, _ = run_jax(jdb, make_q, compiled=False)
    jfast, jpath = run_jax(jdb, make_q, compiled=True)
    fast, path, reasons = run_port(pdb, make_q)
    assert jfast == ref
    assert fast == ref, (seed, filt, lim)
    assert path == jpath, reasons


# ---------------------------------------------------------------------------
# The compiled_scan cases of tests/test_memlimit_fast_tiers.py


def test_limited_scan_serves_and_raises():
    _store, jdb = ML.build_db()
    pdb = carry(jdb)
    alloc = LimitAllocator(64 << 20)
    fast, path, reasons = run_port(pdb, ML.scan_q, allocator=alloc)
    assert path == "compiled_scan", reasons
    ref, _ = run_jax(jdb, ML.scan_q, compiled=True)
    assert fast == ref
    assert alloc.allocated() == 0
    with pytest.raises(MemoryLimitExceeded):
        run_port(pdb, ML.scan_q, allocator=LimitAllocator(64))


def test_limited_scan_with_limit_releases_everything():
    _store, jdb = ML.build_db()
    pdb = carry(jdb)
    alloc = LimitAllocator(64 << 20)
    eng = PEngine(pdb.table_provider(), allocator=alloc)
    for _ in range(3):
        out = []
        PortEngine(eng).scan_table("t").filter(JE.Col("timestamp").lt(500)).project(
            JE.Col("value")
        ).limit(JE.Literal(5)).execute(out.append)
        assert sum(b.num_rows for b in out) == 5
    assert eng.last_serving_path == "compiled_scan"
    assert alloc.allocated() == 0
