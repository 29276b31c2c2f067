"""The port's mesh tier (frostdb_tpu_torch/parallel/mesh_exec.py under
``ExecOptions(mesh=...)``) against the JAX package's: the mesh cases of the
reference's engine suites run through both packages at the reference's
shard counts — a JAX mesh of conftest's virtual CPU devices, a port mesh of
as many CPU shards — and must give the same rows in the same order (full
``(name, py_value)`` tuples, float signs and NaNs included), the same
serving tier and the same decline reasons.

Tables are built with the reference suites' own helpers and sizes and
carried across with ``frostdb_tpu_torch.interop.table_from_numpy``;
queries are the suites' own, written with the JAX package's expressions
and rebuilt from the port's classes by ``Port``. Also here: the
incremental sharded upload (``SHARDED_UPLOAD_STATS``) and the mesh tier
under a memory limit. The shuffle route's cases (past 2^20 codes) are in
tests/test_torch_mesh_shuffle.py. Tolerance: exact everywhere.
"""

import numpy as np
import pytest

import test_compiled_filters as TCF
import test_computed_group_key as TCG
import test_differential_fuzz as FZ
import test_float_minmax as TFM
import test_float_sums as TFS
import test_join_engine as TJ
import test_memlimit_fast_tiers as TML
import test_mesh_engine as TME
import test_multi_group as TMG
import test_unique_and_agg as TUA
import test_windowed_group as TWG
from frostdb_tpu.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu.db import ColumnStore
from frostdb_tpu.memorylimit import LimitAllocator as JLimitAllocator
from frostdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from frostdb_tpu.query import expr as E
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.schema import sample_definition
from frostdb_tpu.table import TableConfig
from test_torch_dense import split_groups_db
from test_torch_engine import carry, to_port

from frostdb_tpu_torch import columnbatch as PCB
from frostdb_tpu_torch.device import SHARDED_UPLOAD_STATS
from frostdb_tpu_torch.memorylimit import LimitAllocator
from frostdb_tpu_torch.parallel.mesh import make_mesh
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions

# One JAX mesh per shard count: the reference caches its shard programs by
# the mesh's id, so reusing the mesh reuses the compiled programs.
_JAX_MESHES: dict = {}


def jax_mesh(n):
    if n not in _JAX_MESHES:
        _JAX_MESHES[n] = jax_make_mesh(n)
    return _JAX_MESHES[n]


class Port:
    """A port engine or query builder that takes the JAX package's
    expressions: every argument is rebuilt from the port's classes, and
    builders come back wrapped."""

    def __init__(self, obj):
        self.obj = obj

    def __getattr__(self, name):
        attr = getattr(self.obj, name)

        def call(*args, **kw):
            out = attr(*map(_unwrap, args), **{k: _unwrap(v) for k, v in kw.items()})
            return Port(out) if hasattr(out, "execute") else out

        return call


def _unwrap(x):
    return x.obj if isinstance(x, Port) else to_port(x)


def run_jax(jdb, make_q, mesh=None, allocator=None, **opts):
    if mesh is not None:
        opts["mesh"] = jax_mesh(mesh)
    eng = JEngine(jdb.table_provider(), JOptions(**opts), allocator=allocator)
    out = []
    make_q(eng).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons


def run_port(pdb, make_q, mesh=None, allocator=None, **opts):
    if mesh is not None:
        opts["mesh"] = make_mesh(mesh, device="cpu")
    eng = PEngine(pdb.table_provider(), POptions(**opts), allocator=allocator)
    out = []
    make_q(Port(eng)).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons


def parity(jdb, make_q, n_devs, names=("t",), path="mesh", pdb=None, **opts):
    """``make_q`` through both packages on a mesh of each of ``n_devs``
    shards: same rows, order, serving tier (``path`` where given) and
    decline reasons. Returns the port's rows of the last mesh."""
    if pdb is None:
        pdb = carry(jdb, names)
    for n in n_devs:
        ref = run_jax(jdb, make_q, mesh=n, **opts)
        got = run_port(pdb, make_q, mesh=n, **opts)
        assert got[1] == ref[1], (n, got[1], got[2], ref[2])
        if path is not None:
            assert got[1] == path, (n, got[2])
        assert got[2] == ref[2], n
        assert got[0] == ref[0], n
    return got[0]


def on_table(q_fn, table="t"):
    """make_q of a suite query written against ``scan_table(table)``."""
    return lambda e: q_fn(e.scan_table(table))


# ---------------------------------------------------------------------------
# test_mesh_engine.py


@pytest.mark.parametrize("qname", sorted(TME.QUERIES))
def test_mesh_engine_bit_identical(qname):
    _s, jdb, _t = TME._setup()
    rows = parity(jdb, on_table(TME.QUERIES[qname]), (1, 8))
    assert rows, "query returned nothing"


def test_mesh_engine_wide_spans_distribute():
    _s, jdb, _t = TME._setup(ns_ts=True)
    q = lambda b: b.filter(E.Col("timestamp").gt(5 * 10**14)).aggregate(
        [E.Max(E.Col("timestamp")), E.Min(E.Col("timestamp")), E.Sum(E.Col("timestamp"))],
        [E.Col("labels.label1")],
    )
    assert parity(jdb, on_table(q), (8,))


def _ordered_db():
    """test_mesh_engine.py test_mesh_engine_ordered_aggregations' table."""
    store = ColumnStore()
    db = store.db("test")
    table = db.table("t", TableConfig(schema=sample_definition()))
    rng = np.random.default_rng(5)
    for _ in range(3):
        n = 200
        d_et = table.dictionary("example_type")
        d_l = table.dictionary("labels")
        d_st = table.dictionary("stacktrace")
        et, etv = d_et.encode(sorted(f"type{int(x)}" for x in rng.integers(0, 9, n)))
        lc, lv = d_l.encode(["x"] * n)
        st, stv = d_st.encode(["stack"] * n)
        table.insert_record(
            ColumnBatch(
                [
                    Column("example_type", KIND_DICT, et, etv, d_et),
                    Column("labels.label1", KIND_DICT, lc, lv, d_l),
                    Column("stacktrace", KIND_DICT, st, stv, d_st),
                    Column("timestamp", KIND_INT64, np.arange(n, dtype=np.int64), np.ones(n, bool)),
                    Column("value", KIND_INT64, rng.integers(0, 100, n).astype(np.int64), np.ones(n, bool)),
                ],
                n,
            )
        )
    return store, db


def test_mesh_engine_ordered_aggregations():
    _s, jdb = _ordered_db()
    q = lambda b: b.aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")])
    rows = parity(jdb, on_table(q), (8,), ordered_aggregations=True)
    keys = [r[0][1] for r in rows]
    assert keys == sorted(keys) and len(keys) == 9


def test_mesh_large_code_space_sorted_reduce():
    _s, jdb, _t = TME._setup(n_parts=2, rows=9000, n_groups=6000)
    q = lambda b: b.filter(E.Col("timestamp").gt(100)).aggregate(
        [E.Sum(E.Col("value")), E.Count(E.Col("value")), E.Min(E.Col("value")), E.Max(E.Col("value"))],
        [E.Col("labels.label1")],
    )
    assert len(parity(jdb, on_table(q), (8,))) > 4096


def test_mesh_table_route_equals_dense_tier():
    """Sums and counts over about 6,000 codes (past the segment route's
    4,096): the mesh tier at 1 and 4 shards takes the table route on every
    shard and gives the dense tier's rows in its order, and the JAX
    package's."""
    from frostdb_tpu_torch.tracing import Tracer

    _s, jdb, _t = TME._setup(n_parts=2, rows=9000, n_groups=6000)
    q = on_table(lambda b: b.filter(E.Col("timestamp").gt(100)).aggregate(
        [E.Sum(E.Col("value")), E.Count(E.Col("value"))], [E.Col("labels.label1")]))
    pdb = carry(jdb)
    dense = run_port(pdb, q)
    assert dense[1] == "dense"
    assert len(dense[0]) > 4096
    for n in (1, 4):
        tracer = Tracer()
        got = run_port(pdb, q, mesh=n, tracer=tracer)
        assert got[1] == "mesh" and got[0] == dense[0], n
        (root,) = tracer.roots
        (mesh,) = [c for c in root.children if c.name == "mesh/execute"]
        (parts,) = [c for c in mesh.children if c.name == "dense/parts"]
        assert parts.attributes["route"] == "table", n
    assert parity(jdb, q, (1, 4), pdb=pdb) == dense[0]


def test_mesh_engine_falls_back_on_unsupported():
    """A distinct declines on the mesh tier with the reference's reason;
    the same tier serves it on both packages."""
    _s, jdb, _t = TME._setup(n_parts=1, rows=100)
    q = lambda e: e.scan_table("t").distinct(E.Col("labels.label1"))
    rows = parity(jdb, q, (8,), path=None)
    assert rows


def _insert_gnew(table, cb):
    """test_mesh_engine.py test_mesh_scan_is_incremental's new part, in
    the package of ``cb`` (a columnbatch module)."""
    n = 50
    d_et = table.dictionary("example_type")
    d_l = table.dictionary("labels")
    d_st = table.dictionary("stacktrace")
    et, etv = d_et.encode(["cpu"] * n)
    lc, lv = d_l.encode(["gnew"] * n)
    st, stv = d_st.encode(["stack"] * n)
    table.insert_record(
        cb.ColumnBatch(
            [
                cb.Column("example_type", KIND_DICT, et, etv, d_et),
                cb.Column("labels.label1", KIND_DICT, lc, lv, d_l),
                cb.Column("stacktrace", KIND_DICT, st, stv, d_st),
                cb.Column("timestamp", KIND_INT64, np.arange(n, dtype=np.int64), np.ones(n, bool)),
                cb.Column("value", KIND_INT64, np.ones(n, dtype=np.int64), np.ones(n, bool)),
            ],
            n,
        )
    )


def test_mesh_scan_is_incremental():
    """A repeat query uploads nothing; an insert between two queries
    uploads only the new part's columns (2 columns x 8 shards x one
    ROW_TILE of data and validity); rows equal the JAX package's before
    and after the insert."""
    import frostdb_tpu.columnbatch as JCB

    _s, jdb, jt = TME._setup(n_parts=2, rows=200)
    pdb = carry(jdb)
    q = on_table(TME.QUERIES["multi-agg"])
    r1 = parity(jdb, q, (8,), pdb=pdb)
    first_cols = SHARDED_UPLOAD_STATS["columns"]
    assert first_cols > 0
    assert run_port(pdb, q, mesh=8)[0] == r1
    assert SHARDED_UPLOAD_STATS["columns"] == first_cols  # fully cached
    _insert_gnew(jt, JCB)
    _insert_gnew(pdb.get_table("t"), PCB)
    before = SHARDED_UPLOAD_STATS["bytes"]
    r3 = parity(jdb, q, (8,), pdb=pdb)
    uploaded = SHARDED_UPLOAD_STATS["bytes"] - before
    per_col = 8 * 1024 * (8 + 1)
    assert 0 < uploaded <= 2 * per_col + 64
    assert any(("labels.label1", "gnew") in r for r in r3)


# ---------------------------------------------------------------------------
# test_multi_group.py


@pytest.mark.parametrize("qname", sorted(TMG.QUERIES))
def test_two_column_group_by_distributes(qname):
    _s, jdb, _t = TMG._setup()
    assert parity(jdb, on_table(TMG.QUERIES[qname]), (8,))


def test_two_column_group_by_dense_tier_on_the_mesh():
    _s, jdb, _t = TMG._setup(n_parts=2, rows=4000, k_et=60, k_l=60)
    assert len(parity(jdb, on_table(TMG.QUERIES["pair-sum"]), (8,))) > 2000


def _four_group_db():
    """test_multi_group.py test_three_and_four_group_columns_fast_paths'
    table."""
    store = ColumnStore()
    db = store.db("mg4")
    table = db.table("t", TableConfig(schema=sample_definition()))
    rng = np.random.default_rng(5)
    for _p in range(2):
        n = 500
        d_et = table.dictionary("example_type")
        d_l = table.dictionary("labels")
        d_st = table.dictionary("stacktrace")
        et, etv = d_et.encode(rng.choice(["a", "b", "c"], n).tolist())
        l1, l1v = d_l.encode([f"x{int(i)}" for i in rng.integers(0, 4, n)])
        st, stv = d_st.encode([f"s{int(i)}" for i in rng.integers(0, 5, n)])
        table.insert_record(
            ColumnBatch(
                [
                    Column("example_type", KIND_DICT, et, etv, d_et),
                    Column("labels.l1", KIND_DICT, l1, l1v, d_l),
                    Column("stacktrace", KIND_DICT, st, stv, d_st),
                    Column("timestamp", KIND_INT64, rng.integers(0, 8, n).astype(np.int64), np.ones(n, bool)),
                    Column("value", KIND_INT64, rng.integers(-50, 50, n).astype(np.int64), np.ones(n, bool)),
                ],
                n,
            )
        )
    return store, db


@pytest.mark.parametrize(
    "groups",
    [
        [E.Col("example_type"), E.Col("labels.l1"), E.Col("stacktrace")],
        [E.Col("example_type"), E.Col("labels.l1"), E.Col("stacktrace"), E.Col("timestamp")],
        [E.Col("example_type"), E.Duration(4), E.Col("labels.l1")],
    ],
)
def test_three_and_four_group_columns_on_the_mesh(groups):
    _s, jdb = _four_group_db()
    q = lambda b: b.aggregate([E.Sum(E.Col("value")), E.Count(E.Col("value"))], groups)
    assert parity(jdb, on_table(q), (8,))


# ---------------------------------------------------------------------------
# test_unique_and_agg.py


@pytest.mark.parametrize("qi", range(len(TUA.QUERIES)))
def test_unique_and_mesh_parity(qi):
    _s, jdb = TUA.build_db(seed=3)
    assert parity(jdb, TUA.QUERIES[qi], (1, 8))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_unique_and_fuzz_on_the_mesh(seed):
    _s, jdb = TUA.build_db(
        seed=seed, n_parts=2 + seed % 2, n=1200, n_groups=6 + seed, value_span=seed % 3 + 1
    )
    pdb = carry(jdb)
    for q in TUA.QUERIES:
        parity(jdb, q, (8,), pdb=pdb)


# ---------------------------------------------------------------------------
# test_float_sums.py and test_float_minmax.py: exact float sums (digit
# planes) and float min/max (the two-pass (hi, lo) reduce, the sorted
# reduce's widened identities)


def _fv_aggs(*funcs):
    return on_table(
        lambda b: b.aggregate([getattr(E, f)(E.Col("fv")) for f in funcs], [E.Col("g")])
    )


@pytest.mark.parametrize("n_dev", [1, 8])
def test_fexact_mesh_parity(n_dev):
    vpp, gpp = TFS._mk_fuzz(7)
    _s, jdb, _t = TFS._mk(vpp, gpp)
    rows = parity(jdb, _fv_aggs("Sum", "Count"), (n_dev,))
    want = TFS._oracle(vpp, gpp)
    assert {r[0][1]: (r[1][1], r[2][1]) for r in rows} == {
        g: (repr(s) + ("/n" if np.signbit(s) else ""), c) for g, (s, c) in want.items()
    }


@pytest.mark.parametrize("seed", [0, 3])
def test_float_minmax_mesh_parity(seed):
    rng = np.random.default_rng(seed)
    vpp, gpp = [], []
    for _p in range(2):
        n = 400
        vpp.append((rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).tolist())
        gpp.append([f"g{int(x)}" for x in rng.integers(0, 6, n)])
    _s, jdb, _t = TFS._mk(vpp, gpp)
    parity(jdb, _fv_aggs("Min", "Max", "Sum"), (1, 8))


def test_float_minmax_sorted_path_large_k_on_the_mesh():
    rng = np.random.default_rng(7)
    n = 3000
    vals = (rng.normal(0, 5, n) * 10.0 ** rng.integers(-2, 3, n)).tolist()
    grps = [f"g{int(x)}" for x in rng.integers(0, 6000, n)]
    _s, jdb, _t = TFS._mk([vals], [grps])
    parity(jdb, _fv_aggs("Min", "Max", "Sum"), (8,))


def _f_minmax(group="g"):
    return on_table(
        lambda b: b.aggregate([E.Min(E.Col("f")), E.Max(E.Col("f"))], [E.Col(group)])
    )


def test_edge_values_mesh():
    """-0.0, +-inf, NaN, subnormals and 1e300 through float min/max."""
    _s, jdb = TFM._mk_dict_grouped(seed=1)
    parity(jdb, _f_minmax(), (1, 8))


@pytest.mark.parametrize("k", [3000, 12000])
def test_float_minmax_groups_missing_from_a_part_mesh(k):
    """Float min/max over two parts that each lack groups of the other
    (keys past 2^62), on the segment and the sorted route: a shard's empty
    group holds the int64 extreme before the shards combine."""
    jdb = split_groups_db(k)
    parity(jdb, on_table(lambda b: b.aggregate(
        [E.Min(E.Col("fv")), E.Max(E.Col("fv"))], [E.Col("g")])), (1, 8))


# ---------------------------------------------------------------------------
# test_windowed_group.py and test_computed_group_key.py


@pytest.mark.parametrize("qname", sorted(TWG.QUERIES))
def test_windowed_mesh_parity(qname):
    _s, jdb, _t = TWG._setup(seed=3)
    assert parity(jdb, on_table(TWG.QUERIES[qname]), (1, 8))


@pytest.mark.parametrize(
    "kw,groups",
    [
        (dict(rows=600, ts_lo=0, ts_hi=50), [E.Col("timestamp")]),
        (dict(rows=700, ts_lo=-50_000, ts_hi=50_000, seed=5), [E.Duration(7000)]),
    ],
    ids=["plain-int64", "negative-floor-division"],
)
def test_int_group_keys_on_the_mesh(kw, groups):
    _s, jdb, _t = TWG._setup(**kw)
    q = lambda b: b.aggregate([E.Sum(E.Col("value")), E.Count(E.Col("value"))], groups)
    rows = parity(jdb, on_table(q), (8,))
    if kw["ts_lo"] < 0:
        assert any(r[0][1] < 0 for r in rows)


def test_filter_clamp_keeps_key_space_small_on_the_mesh():
    _s, jdb, _t = TWG._setup(rows=2000, ts_lo=0, ts_hi=10**9, seed=4)
    q = lambda b: b.filter(
        E.And(E.Col("timestamp").gt_eq(500_000_000), E.Col("timestamp").lt(500_060_000))
    ).aggregate([E.Sum(E.Col("value"))], [E.Duration(1000)])
    parity(jdb, on_table(q), (8,))


@pytest.mark.parametrize("qi", range(len(TCG.QUERIES)))
def test_computed_group_key_mesh_parity(qi):
    _s, jdb = TCG.build_db(seed=2)
    assert parity(jdb, TCG.QUERIES[qi], (1, 8))


# ---------------------------------------------------------------------------
# test_compiled_filters.py: OR / IN clauses in the mesh's filter envelope


@pytest.mark.parametrize("i", range(len(TCF._OR_FILTERS)))
def test_or_filters_mesh_parity(i):
    _s, jdb, _t = TCF._mk([dict(p) for p in TCF._PARTS], db_name=f"orm{i}")
    q = lambda b: b.filter(TCF._OR_FILTERS[i]).aggregate(
        [E.Sum(E.Col("value")), E.Count(E.Col("value"))], [E.Col("example_type")]
    )
    parity(jdb, on_table(q), (1, 8))


# ---------------------------------------------------------------------------
# test_join_engine.py: the HashJoin's expansion across the mesh


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_join_mesh_parity(how):
    """join_rows: the generic HashJoin serves on both packages, its pairs
    expanded by the distributed CSR join at 8 shards."""
    _s, jdb = TJ._setup(seed=3)
    q = lambda e: e.scan_table("facts").join(e.scan_table("dims"), on=["job"], how=how)
    rows = parity(jdb, q, (1, 8), names=("facts", "dims"), path="generic")
    assert rows


def _dup_heavy_db(n_dev):
    """test_join_engine.py test_join_mesh_duplicate_heavy_capacity_escalation's
    tables: 80% of the facts hit one key that the dims hold 8 times."""
    store = ColumnStore()
    db = store.db(f"dup{n_dev}")
    facts = db.table("facts", TableConfig(schema=TJ._fact_schema()))
    dims = db.table("dims", TableConfig(schema=TJ._dim_schema()))
    rng = np.random.default_rng(9)
    n = 6000
    dj = facts.dictionary("job")
    ds = facts.dictionary("site")
    jobs = np.where(rng.random(n) < 0.8, "hot", rng.choice(["a", "b", "c"], n))
    jc, jv = dj.encode(jobs.tolist())
    sc, sv = ds.encode([f"s{int(x)}" for x in rng.integers(0, 7, n)])
    facts.insert_record(
        ColumnBatch(
            [
                Column("job", KIND_DICT, jc, jv, dj),
                Column("site", KIND_DICT, sc, sv, ds),
                Column("value", KIND_INT64, rng.integers(0, 100, n).astype(np.int64), np.ones(n, bool)),
            ],
            n,
        )
    )
    ddj = dims.dictionary("job")
    ddr = dims.dictionary("region")
    djobs = ["hot"] * 8 + ["a", "b", "d"]
    m = len(djobs)
    dc, dv = ddj.encode(djobs)
    rc, rv = ddr.encode([f"r{i}" for i in range(m)])
    dims.insert_record(
        ColumnBatch(
            [
                Column("job", KIND_DICT, dc, dv, ddj),
                Column("region", KIND_DICT, rc, rv, ddr),
                Column("weight", KIND_INT64, np.arange(m, dtype=np.int64), np.ones(m, bool)),
            ],
            m,
        )
    )
    return store, db


@pytest.mark.parametrize("n_dev", [1, 8])
def test_join_mesh_duplicate_heavy_capacity_escalation(n_dev):
    _s, jdb = _dup_heavy_db(n_dev)
    q = lambda e: e.scan_table("facts").join(
        e.scan_table("dims"), on=["job"], how="inner"
    ).aggregate(
        [E.Sum(E.Col("weight")), E.Count(E.Col("weight"))], [E.Col("job"), E.Col("site")]
    )
    rows = parity(jdb, q, (n_dev,), names=("facts", "dims"), path=None)
    assert sum(c for r in rows for name, c in r if name == "count(weight)") > 30000


# ---------------------------------------------------------------------------
# test_memlimit_fast_tiers.py


def test_limited_mesh_serves():
    """The mesh tier serves under a memory limit its result blob fits, and
    the port releases the blob's reservation after the query."""
    _s, jdb = TML.build_db()
    pdb = carry(jdb)
    ref = run_jax(jdb, TML.agg_q, mesh=8, allocator=JLimitAllocator(64 << 20))
    alloc = LimitAllocator(64 << 20)
    got = run_port(pdb, TML.agg_q, mesh=8, allocator=alloc)
    assert got == ref
    assert got[1] == "mesh"
    assert alloc.allocated() == 0


# ---------------------------------------------------------------------------
# test_differential_fuzz.py: the mesh sweep of test_aggregate_differential


@pytest.mark.parametrize("seed", range(20))
def test_aggregate_differential_mesh(seed):
    rng = np.random.default_rng(1000 + seed)
    _s, jdb = FZ.build_db(rng)
    pdb = carry(jdb)
    span = 10**5
    for _q in range(3):
        filt = FZ.random_filter(rng, span)
        aggs = FZ.random_aggs(rng)
        groups = FZ.random_groups(rng)

        def make_q(e):
            q = e.scan_table("t")
            if filt is not None:
                q = q.filter(filt)
            return q.aggregate(aggs, groups)

        parity(jdb, make_q, (4,), pdb=pdb, path=None)
