"""The port's dense tier (frostdb_tpu_torch/parallel/mesh_exec.py) against
the JAX package's: group-bys past the compiled tier's 2048 codes, on the
segment route (K <= 4096), the table route (K > 4096, sums and counts
only), the sorted route (K > 4096, any other aggregation) and the shuffle
route (K > 2^20), with the same rows in the same order, the same serving
tier and the same decline reasons.

Tables are made by the JAX package's own test helpers and carried
across with ``frostdb_tpu_torch.interop.table_from_numpy``; each query runs
through both engines with the compiled tiers on. Also here: the two dense
reductions of ``ops/kernels.py`` against the reference's functions, the
one-pass reductions' plain versions against the reductions they replace,
the route choice at its boundaries, the shuffle route under a memory
limit, the compiled tiers over a table with a data source (the
``collect_parts`` repair), and the port's fix of the reference's double
release of the shuffle route's memory reservation (marked
``divergence``).
"""

import functools

import numpy as np
import pytest
import torch

import test_compiled as TC
import test_differential_fuzz as FZ
import test_float_minmax as TFM
import test_float_sums as TFS
import test_multi_group as TMG
import test_shuffle_agg as TSA
import test_unique_and_agg as TUA
import test_windowed_group as TWG
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from test_torch_engine import carry

import frostdb_tpu_torch as P
from frostdb_tpu_torch.columnbatch import (
    Column, ColumnBatch, KIND_BOOL, KIND_DICT, KIND_FLOAT64, KIND_INT64,
)
from frostdb_tpu_torch.memorylimit import LimitAllocator, MemoryLimitExceeded
from frostdb_tpu_torch.ops import kernels as PK
from frostdb_tpu_torch.parallel import mesh_exec as ME
from frostdb_tpu_torch.parallel.mesh import make_mesh
from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.schema import (
    ColumnDef, ENCODING_RLE_DICTIONARY, SchemaDef, SortingColumnDef, StorageLayout,
    TYPE_BOOL, TYPE_DOUBLE, TYPE_INT64, TYPE_STRING, sample_definition,
)
from frostdb_tpu_torch.table import TableConfig
from frostdb_tpu_torch.tracing import Tracer


def run_both(jdb, make_q, names=("t",), pdb=None, **opts):
    """One query through both engines with the compiled tiers on:
    (JAX rows, path, reasons), (port rows, path, reasons). ``make_q(eng,
    E)`` builds the query from the engine and its expression module."""
    out = []
    jeng = JEngine(jdb.table_provider(), exec_options=JOptions(**opts))
    make_q(jeng, JE).execute(out.append)
    ref = (FZ.rows(out), jeng.last_serving_path, jeng.last_fallback_reasons)
    if pdb is None:
        pdb = carry(jdb, names)
    out = []
    peng = PEngine(pdb.table_provider(), exec_options=POptions(**opts))
    make_q(peng, PE).execute(out.append)
    return ref, (FZ.rows(out), peng.last_serving_path, peng.last_fallback_reasons)


def assert_same(ref, got, path):
    assert got[1] == ref[1] == path, (got[1], got[2], ref[2])
    assert got[2] == ref[2]
    assert got[0] == ref[0]


def agg(aggs, groups, filt=None, table="t"):
    """make_q for ``scan(table)[.filter(filt)].aggregate(aggs, groups)``,
    each argument a function of the expression module."""

    def make_q(eng, E):
        q = eng.scan_table(table)
        if filt is not None:
            q = q.filter(filt(E))
        return q.aggregate(aggs(E), groups(E))

    return make_q


# ---------------------------------------------------------------------------
# The reference's dense-tier cases, port against JAX


@pytest.mark.parametrize("k", [2600, 6000])
def test_large_code_space_dense_tier(k):
    """test_compiled.py test_large_code_space_dense_tier: a dict group
    column past 2048 codes; segment route below 4096 codes, sorted above."""
    from frostdb_tpu_torch.compiled import NotCompilable, compile_filter_aggregate
    from frostdb_tpu_torch.tracing import Tracer

    types = [f"u{i % k}" for i in range(2 * k)]
    jdb, _t = TC._setup_values(list(range(2 * k)), types=types, tss=list(range(2 * k)))
    pdb = carry(jdb)
    q = compile_filter_aggregate(pdb.get_table("t"), "example_type", [("sum", "value")])
    with pytest.raises(NotCompilable):
        q.execute()
    make_q = agg(
        lambda E: [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
        lambda E: [E.Col("example_type")],
        lambda E: E.Col("timestamp").gt_eq(100),
    )
    ref, got = run_both(jdb, make_q, pdb=pdb)
    assert_same(ref, got, "dense")
    assert len(got[0]) > 2048
    tracer = Tracer()
    peng = PEngine(pdb.table_provider(), exec_options=POptions(tracer=tracer))
    make_q(peng, PE).execute(lambda b: None)
    assert tracer.roots[0].attributes["path"] == "dense"


def test_shuffle_route_large_k():
    """test_shuffle_agg.py test_dense_tier_large_k_parity: an int64 key
    over ~3M values, past 2^20 codes."""
    _s, jdb, _t = TSA._mk()
    ref, got = run_both(
        jdb,
        agg(
            lambda E: [E.Sum(E.Col("v")), E.Count(E.Col("v")), E.Min(E.Col("v")), E.Max(E.Col("v"))],
            lambda E: [E.Col("k")],
        ),
    )
    assert_same(ref, got, "dense")
    assert len(got[0]) > 10000


def test_shuffle_route_filter_and_floats(monkeypatch):
    """test_shuffle_agg.py test_shuffle_tier_filter_and_floats: exact float
    sums on the shuffle route under a filter."""
    seen = []
    orig = ME.DenseLocalAggregate._execute_shuffle
    monkeypatch.setattr(
        ME.DenseLocalAggregate, "_execute_shuffle",
        lambda self, parts, k: seen.append(k) or orig(self, parts, k),
    )
    _s, jdb, _t = TSA._mk(seed=5, float_vals=True)
    ref, got = run_both(
        jdb,
        agg(
            lambda E: [E.Sum(E.Col("v")), E.Count(E.Col("v"))],
            lambda E: [E.Col("k")],
            lambda E: E.Col("k").gt_eq(1000),
        ),
    )
    assert_same(ref, got, "dense")
    assert seen and seen[0] > 1 << 20


def test_beyond_shuffle_ceiling_falls_generic():
    """test_shuffle_agg.py test_beyond_shuffle_ceiling_falls_generic: past
    2^27 codes the generic DAG serves, with the same decline reasons."""
    _s, jdb, _t = TSA._mk(rows=200, key_space=1 << 40)
    ref, got = run_both(
        jdb, agg(lambda E: [E.Sum(E.Col("v"))], lambda E: [E.Col("k")])
    )
    assert_same(ref, got, "generic")
    assert got[2]["dense"].startswith("group code space")


def test_two_column_group_by_dense_tier():
    """test_multi_group.py test_two_column_group_by_dense_tier: a 60 x 60
    pair space."""
    _s, jdb, _t = TMG._setup(n_parts=2, rows=4000, k_et=60, k_l=60)
    ref, got = run_both(
        jdb,
        agg(
            lambda E: [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
            lambda E: [E.Col("example_type"), E.Col("labels.label1")],
        ),
    )
    assert_same(ref, got, "dense")
    assert len(got[0]) > 2000


def test_unique_and_and_on_the_dense_tier():
    """test_unique_and_agg.py test_dense_tier_parity: unique(), and(),
    sum, min, max and count over 3000 groups."""
    _s, jdb = TUA.build_db(seed=5, n_groups=3000, n=4000)
    ref, got = run_both(
        jdb,
        agg(
            lambda E: [
                E.Unique(E.Col("v")), E.AndAgg(E.Col("b")), E.Sum(E.Col("v")),
                E.Min(E.Col("v")), E.Max(E.Col("v")), E.Count(E.Col("v")),
            ],
            lambda E: [E.Col("g")],
        ),
    )
    assert_same(ref, got, "dense")


def _fv_query(*funcs):
    return agg(
        lambda E: [getattr(E, f)(E.Col("fv")) for f in funcs],
        lambda E: [E.Col("g")],
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_fexact_compiled_parity(seed):
    """test_float_sums.py test_fexact_compiled_and_dense_parity: exact
    non-integral float sums (the compiled tier serves them)."""
    _s, jdb, _t = TFS._mk(*TFS._mk_fuzz(seed))
    ref, got = run_both(jdb, _fv_query("Sum", "Count"))
    assert_same(ref, got, "compiled")


@pytest.mark.parametrize("seed", [0, 3])
def test_float_minmax_dense_parity(seed):
    """test_float_sums.py test_float_minmax_dense_and_mesh_parity: float
    min/max through the monotone key plus the exact sum on one column."""
    rng = np.random.default_rng(seed)
    vpp, gpp = [], []
    for _p in range(2):
        n = 400
        vpp.append((rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).tolist())
        gpp.append([f"g{int(x)}" for x in rng.integers(0, 6, n)])
    _s, jdb, _t = TFS._mk(vpp, gpp)
    ref, got = run_both(jdb, _fv_query("Min", "Max", "Sum"))
    assert_same(ref, got, "dense")


@pytest.mark.parametrize(
    "vals",
    [
        [1e300, -1e300, 2.5, -2.5, 1e-300, 3.75],  # test_float_minmax_huge_magnitudes
        [-0.0, 1.5, 2.5],  # test_float_minmax_negzero_serves_dense
    ],
)
def test_float_minmax_edges_dense(vals):
    """test_float_sums.py test_float_minmax_huge_magnitudes and
    test_float_minmax_negzero_serves_dense: keys past 2^62 reduce exactly;
    -0.0 orders below +0.0."""
    _s, jdb, _t = TFS._mk([vals], [["a"] * len(vals)])
    ref, got = run_both(jdb, _fv_query("Min", "Max"))
    assert_same(ref, got, "dense")


def test_float_minmax_sorted_route_large_k():
    """test_float_sums.py test_float_minmax_sorted_path_large_k: float
    min/max through the sorted route (K > 4096), empty groups widened."""
    rng = np.random.default_rng(7)
    n = 3000
    vals = (rng.normal(0, 5, n) * 10.0 ** rng.integers(-2, 3, n)).tolist()
    grps = [f"g{int(x)}" for x in rng.integers(0, 6000, n)]
    _s, jdb, _t = TFS._mk([vals], [grps])
    ref, got = run_both(jdb, _fv_query("Min", "Max", "Sum"))
    assert_same(ref, got, "dense")


def split_groups_db(k: int, seed: int = 11):
    """Two parts of 4,000 rows over ``k`` groups, so each part lacks groups
    the other holds, with float values of both signs and |v| >= 2 (ordering
    keys past 2^62): a part's empty group must hold the int64 extreme
    before the parts fold."""
    rng = np.random.default_rng(seed)
    vpp, gpp = [], []
    for _p in range(2):
        n = 4000
        vpp.append((rng.choice([-1.0, 1.0], n) * rng.uniform(2.0, 1e6, n)).tolist())
        gpp.append([f"g{int(x)}" for x in rng.integers(0, k, n)])
    return TFS._mk(vpp, gpp)[1]


@pytest.mark.parametrize("route,k", [("segment", 3000), ("sorted", 12000)])
def test_float_minmax_groups_missing_from_a_part(route, k):
    """Float min/max over two parts that each lack groups of the other, on
    the segment route (about 3,000 codes) and the sorted route (about
    5,800)."""
    jdb = split_groups_db(k)
    ref, got = run_both(jdb, _fv_query("Min", "Max"))
    assert_same(ref, got, "dense")
    tracer = Tracer()
    peng = PEngine(carry(jdb).table_provider(), exec_options=POptions(tracer=tracer))
    _fv_query("Min", "Max")(peng, PE).execute(lambda b: None)
    (root,) = tracer.roots
    (dense,) = [c for c in root.children if c.name == "dense/execute"]
    assert next(c for c in dense.children if c.name == "dense/parts").attributes == {
        "parts": 2, "route": route}


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_values_dense_tier(seed):
    """test_float_minmax.py test_edge_values_dense_tier: -0.0, +-inf, NaN,
    subnormals and 1e300 through float min/max."""
    _s, jdb = TFM._mk_dict_grouped(seed=seed)
    ref, got = run_both(
        jdb,
        agg(lambda E: [E.Min(E.Col("f")), E.Max(E.Col("f"))], lambda E: [E.Col("g")]),
    )
    assert_same(ref, got, "dense")


def test_wide_range_falls_to_dense_then_generic():
    """test_windowed_group.py test_wide_range_falls_to_dense_then_generic:
    an int64 key over 10^6 values serves dense; over 2^40 the generic DAG
    serves, with the dense tier's reason recorded."""
    make_q = agg(lambda E: [E.Sum(E.Col("value"))], lambda E: [E.Col("timestamp")])
    _s, jdb, _t = TWG._setup(rows=400, ts_lo=0, ts_hi=10**6, seed=2)
    ref, got = run_both(jdb, make_q)
    assert_same(ref, got, "dense")
    _s2, jdb2, _t2 = TWG._setup(n_parts=1, rows=400, ts_lo=0, ts_hi=2**40, seed=2)
    ref, got = run_both(jdb2, make_q)
    assert_same(ref, got, "generic")
    assert "dense" in got[2]


def test_negative_window_codes_floor_divide():
    """Window codes of negative timestamps floor-divide (a window of 7000
    over [-50000, 50000), 2-column key past 2048 codes)."""
    _s, jdb, _t = TWG._setup(rows=700, ts_lo=-50_000, ts_hi=50_000, seed=5, n_groups=200)
    ref, got = run_both(
        jdb,
        agg(
            lambda E: [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
            lambda E: [E.Col("labels.node"), E.Duration(7000)],
        ),
    )
    assert_same(ref, got, "dense")
    assert any(v < 0 for r in got[0] for name, v in r if name == "timestamp")


@pytest.mark.parametrize("ordered", [False, True])
def test_filters_and_ordered_emission(ordered):
    """The full filter envelope on the dense tier (int range, dict regex,
    ==/!= null, an OR clause) with first-occurrence or key-order
    emission."""
    _s, jdb, _t = TMG._setup(n_parts=3, rows=3000, k_et=70, k_l=50, seed=4, with_nulls=False)
    make_q = agg(
        lambda E: [E.Sum(E.Col("value")), E.Min(E.Col("value")), E.Max(E.Col("timestamp"))],
        lambda E: [E.Col("example_type"), E.Col("labels.label1")],
        lambda E: E.And(
            E.And(E.Col("timestamp").gt(100), E.Col("labels.label1").regex_match("g[1-3]")),
            E.Or(E.Col("example_type").not_eq("type3"), E.Col("value").lt(0)),
        ),
    )
    ref, got = run_both(jdb, make_q, ordered_aggregations=ordered)
    assert_same(ref, got, "dense")
    assert len(got[0]) > 100


def test_mesh_option_records_not_ported_and_dense_serves():
    """With a one-shard mesh option the mesh tier serves, as the
    reference's does, with the same rows as the JAX package's mesh tier and
    its dense tier; no tier records "not ported"."""
    from frostdb_tpu.parallel.mesh import make_mesh as jmake_mesh

    _s, jdb, _t = TMG._setup(n_parts=2, rows=4000, k_et=60, k_l=60)
    make_q = agg(
        lambda E: [E.Sum(E.Col("value"))],
        lambda E: [E.Col("example_type"), E.Col("labels.label1")],
    )
    ref, _got = run_both(jdb, make_q)
    jeng = JEngine(jdb.table_provider(), exec_options=JOptions(mesh=jmake_mesh(1)))
    out = []
    make_q(jeng, JE).execute(out.append)
    assert jeng.last_serving_path == "mesh"
    pdb = carry(jdb)
    peng = PEngine(
        pdb.table_provider(), exec_options=POptions(mesh=make_mesh(1, device="cpu"))
    )
    got = []
    make_q(peng, PE).execute(got.append)
    assert peng.last_serving_path == "mesh"
    assert peng.last_fallback_reasons == jeng.last_fallback_reasons == {}
    assert FZ.rows(got) == FZ.rows(out) == ref[0]


def test_make_mesh_is_one_device_only():
    """A CPU mesh takes one shard by default and as many as asked for, all
    on the CPU (the reference's 8 virtual host devices)."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"shards": 1}
    assert mesh.devices == (torch.device("cpu"),)
    mesh8 = make_mesh(8, device="cpu")
    assert mesh8.shape == {"shards": 8}
    assert mesh8.devices == (torch.device("cpu"),) * 8
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


# ---------------------------------------------------------------------------
# The dense tier's rows and their order against the port's generic DAG.
# The emission order is sorted on the device and every partial arrives in
# it; these cases hold that order (first selected occurrence in the part
# stream, or key order under ordered_aggregations) to the generic DAG's.

# (band, group columns): the distinct values of each group column, so the
# code space lands in the segment route's band (2,049-4,096 codes) or past
# it ("sorted": 4,097-2^20), where the aggregations of _TABLE_AGGS take the
# table route and the others the sorted route.
_ORDER_SPACES = {
    ("segment", 1): (3000,),
    ("sorted", 1): (6000,),
    ("segment", 2): (60, 60),
    ("sorted", 2): (100, 70),
    ("sorted", 3): (17, 16, 16),
}

# One aggregation a query: under ordered_aggregations the planner picks
# OrderedAggregate (key order) only for a single aggregation.
_ORDER_AGGS = {
    "sum": lambda E: [E.Sum(E.Col("v"))],
    "count": lambda E: [E.Count(E.Col("v"))],
    "min": lambda E: [E.Min(E.Col("v"))],
    "max": lambda E: [E.Max(E.Col("v"))],
    "unique": lambda E: [E.Unique(E.Col("v"))],
    "and": lambda E: [E.AndAgg(E.Col("b"))],
    "float_sum": lambda E: [E.Sum(E.Col("f"))],
}
# Every partial of these is an int64 sum (a count has none; an exact float
# sum has four digit-plane sums).
_TABLE_AGGS = {"sum", "count", "float_sum"}


def _order_schema(n_groups):
    dict_layout = StorageLayout(TYPE_STRING, encoding=ENCODING_RLE_DICTIONARY)
    return SchemaDef(
        "t",
        tuple(ColumnDef(f"g{i}", dict_layout) for i in range(n_groups)) + (
            ColumnDef("ts", StorageLayout(TYPE_INT64)),
            ColumnDef("v", StorageLayout(TYPE_INT64, nullable=True)),
            ColumnDef("b", StorageLayout(TYPE_BOOL, nullable=True)),
            ColumnDef("f", StorageLayout(TYPE_DOUBLE, nullable=True)),
        ),
        tuple(SortingColumnDef(f"g{i}", "asc") for i in range(n_groups))
        + (SortingColumnDef("ts", "asc"),),
    )


@functools.cache
def _order_db(space):
    """Two parts, each sorted by its group values, in which every
    combination of the group values occurs (in a shuffled order, then again
    at random), so an unfiltered query leaves no code empty. The values'
    codes follow their first use, and part 2 brings keys below part 1's:
    neither code order nor first occurrence is key order."""
    sizes = _ORDER_SPACES[space]
    rng = np.random.default_rng(sum(sizes))
    k = int(np.prod(sizes))
    combos = np.concatenate([rng.permutation(k), rng.integers(0, k, k // 2)])
    db = P.ColumnStore(device="cpu").db("order")
    t = db.table("t", TableConfig(schema=_order_schema(len(sizes))))
    dicts = [t.dictionary(f"g{i}") for i in range(len(sizes))]
    n_all = len(combos)
    for lo, hi in ((0, n_all // 2), (n_all // 2, n_all)):
        c, n = combos[lo:hi], hi - lo
        cols, rest = [], c
        for i in reversed(range(len(sizes))):
            codes, valid = dicts[i].encode([f"v{x}" for x in rest % sizes[i]])
            cols.insert(0, Column(f"g{i}", KIND_DICT, codes, valid, dicts[i]))
            rest = rest // sizes[i]
        ones = np.ones(n, dtype=bool)
        vv, bv, fv = (rng.random(n) > 0.1 for _ in range(3))
        t.insert_record(ColumnBatch(cols + [
            Column("ts", KIND_INT64, np.arange(lo, hi, dtype=np.int64), ones),
            # values constant within even combinations: unique() hits there
            Column("v", KIND_INT64, np.where(vv, np.where(c % 2 == 0, c % 23, rng.integers(-50, 50, n)), 0), vv),
            Column("b", KIND_BOOL, np.where(bv, rng.random(n) > 0.2, False), bv),
            Column("f", KIND_FLOAT64, np.where(fv, rng.integers(-10**6, 10**6, n) / 1000.0, 0.0), fv),
        ], n), sort=True)
    return db


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("selection", ["sparse", "full"])
@pytest.mark.parametrize("aggs", sorted(_ORDER_AGGS))
@pytest.mark.parametrize("space", sorted(_ORDER_SPACES), ids=lambda s: f"{s[0]}-{s[1]}col")
def test_dense_emission_order_matches_generic(space, aggs, selection, ordered):
    """The dense tier's rows, in their order, equal the generic DAG's on
    the segment, table and sorted routes, one to three group columns,
    every aggregation the tier reduces, with a selection that leaves most
    codes empty (300 of 4,500 to 10,500 rows) or none, first-occurrence or
    key order."""
    db = _order_db(space)
    route = "table" if space[0] == "sorted" and aggs in _TABLE_AGGS else space[0]
    groups = lambda E: [E.Col(f"g{i}") for i in range(space[1])]
    filt = (lambda E: E.Col("ts").lt(300)) if selection == "sparse" else None
    make_q = agg(_ORDER_AGGS[aggs], groups, filt)
    got = {}
    for compiled in (True, False):
        tracer = Tracer()
        eng = PEngine(db.table_provider(), exec_options=POptions(
            compiled_serving=compiled, ordered_aggregations=ordered, tracer=tracer))
        out = []
        make_q(eng, PE).execute(out.append)
        got[compiled] = FZ.rows(out)
        if compiled:
            assert eng.last_serving_path == "dense", eng.last_fallback_reasons
            (dense,) = [c for c in tracer.roots[0].children if c.name == "dense/execute"]
            (parts,) = [c for c in dense.children if c.name == "dense/parts"]
            assert parts.attributes["route"] == route
    assert got[True] == got[False]
    n_codes = int(np.prod(_ORDER_SPACES[space]))
    if selection == "full":
        assert len(got[True]) == n_codes
        # key order exactly when ordered: the case tells the two apart
        keys = [tuple(v for _name, v in row[: space[1]]) for row in got[True]]
        assert (keys == sorted(keys)) == ordered
    else:
        assert 0 < len(got[True]) <= 300 < n_codes // 2


# ---------------------------------------------------------------------------
# The dense reductions of ops/kernels.py against the reference's


def _reduce_inputs(seed, n, k, wrap):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, n).astype(np.int32)
    sel = rng.random(n) > 0.3
    if wrap:
        # int64 sums that wrap: values near the int64 extremes
        vals = rng.integers(2**62, 2**63 - 1, n, dtype=np.int64)
        vals[rng.random(n) < 0.5] *= -1
    else:
        vals = rng.integers(-1000, 1000, n).astype(np.int64)
    vals2 = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    return codes, sel, vals, vals2


def _jnp():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from frostdb_tpu.ops import kernels as JK

    return jnp, JK


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("seed,n,k", [(0, 5000, 6000), (1, 3000, 50), (2, 1, 3), (3, 700, 9000)])
def test_sorted_group_reduce_matches_reference(seed, n, k, wrap):
    """Counts, first rows, wrapping int64 sums, min and max, with empty
    codes (k exceeds the selected rows on most cases)."""
    jnp, JK = _jnp()
    codes, sel, vals, vals2 = _reduce_inputs(seed, n, k, wrap)
    rows = np.arange(n, dtype=np.int64)
    ops = (PK.AGG_SUM, PK.AGG_MIN, PK.AGG_MAX, PK.AGG_SUM)
    ref = JK.sorted_group_reduce(
        jnp.asarray(codes), jnp.asarray(sel), jnp.asarray(rows),
        tuple(jnp.asarray(v) for v in (vals, vals2, vals2, vals2)), k, ops,
    )
    got = PK.sorted_group_reduce(
        torch.from_numpy(codes), torch.from_numpy(sel), torch.from_numpy(rows),
        tuple(torch.from_numpy(v) for v in (vals, vals2, vals2, vals2)), k, ops,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for g, r in zip(got[2], ref[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if k > n:
        assert (got[0].numpy() == 0).any()  # empty codes were checked


@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("wrap", [False, True])
def test_dense_group_reduce_matches_reference(op, wrap):
    jnp, JK = _jnp()
    codes, sel, vals, _v2 = _reduce_inputs(4, 4000, 3000, wrap)
    ref = JK.dense_group_reduce(jnp.asarray(codes), jnp.asarray(vals), jnp.asarray(sel), 3000, op)
    got = PK.dense_group_reduce(
        torch.from_numpy(codes), torch.from_numpy(vals), torch.from_numpy(sel), 3000, op
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dense_group_reduce_all_int64_min_group():
    """A group whose every value is INT64_MIN has max INT64_MIN on both
    packages: unselected rows reduce into a segment that is cut off, so the
    reference's negated min identity (-(2^63 - 1)) never meets a selected
    value, and empty codes hold INT64_MIN, the true identity of max."""
    jnp, JK = _jnp()
    lo = np.iinfo(np.int64).min
    codes = np.array([0, 0, 1, 2], np.int32)
    vals = np.array([lo, lo, 5, 7], np.int64)
    sel = np.array([True, True, False, True])
    ref = JK.dense_group_reduce(jnp.asarray(codes), jnp.asarray(vals), jnp.asarray(sel), 4, "max")
    got = PK.dense_group_reduce(
        torch.from_numpy(codes), torch.from_numpy(vals), torch.from_numpy(sel), 4, "max"
    )
    assert got.tolist() == np.asarray(ref).tolist() == [lo, lo, 7, lo]


# Padded rows of the segment-reduction cases: three runs of 16,380 rows and
# a ragged end; the live rows stop 1,001 short of it.
_SEG_PAD = 3 * 16380 + 13
_SEG_LIVE = _SEG_PAD - 1001


@pytest.mark.parametrize("selection", ["all", "sparse", "none"])
@pytest.mark.parametrize("run", [1, 7, 16380])
@pytest.mark.parametrize("k", [1, 2049, 4096])
def test_dense_segment_sum_count_plain_matches_dense_group_reduce(k, run, selection):
    """The segment route's one-pass reduction (plain version) against the
    three dense_group_reduce calls the route made before it, the port's and
    the JAX package's: codes in runs of ``run`` rows (the top code K - 1
    included), int64 values near +-2^63 whose sums wrap, the first row
    offset by ``row_base`` (0, and a shard's ``shard * m``), selected rows
    past the live count ``n`` ignored, and a count-only call."""
    from frostdb_tpu_torch.ops import agg_kernels as AK

    jnp, JK = _jnp()
    rng = np.random.default_rng([k, run, len(selection)])
    per_run = rng.integers(0, k, -(-_SEG_PAD // run)).astype(np.int32)
    per_run[-1] = k - 1
    codes = np.repeat(per_run, run)[:_SEG_PAD]
    sel = {"all": np.ones(_SEG_PAD, bool), "none": np.zeros(_SEG_PAD, bool),
           "sparse": rng.random(_SEG_PAD) < 0.02}[selection]
    vals = rng.integers(2**62, 2**63 - 1, _SEG_PAD, dtype=np.int64)
    vals[rng.random(_SEG_PAD) < 0.5] *= -1
    live = np.arange(_SEG_PAD) < _SEG_LIVE
    for row_base in (0, 3 * _SEG_PAD):
        rows = row_base + np.arange(_SEG_PAD, dtype=np.int64)
        c, s, v = (torch.from_numpy(x) for x in (codes, sel, vals))
        got = AK.dense_segment_sum_count_plain(c, s, v, _SEG_LIVE, row_base, k)
        # the route's calls before the one-pass reduction: the live rows
        # folded into the selection, first as the min of the rows
        s_live = torch.from_numpy(sel & live)
        want = (
            PK.dense_group_reduce(c, None, s_live, k, PK.AGG_COUNT),
            PK.dense_group_reduce(c, torch.from_numpy(rows), s_live, k, PK.AGG_MIN),
            PK.dense_group_reduce(c, v, s_live, k, PK.AGG_SUM),
        )
        jargs = (jnp.asarray(codes), jnp.asarray(sel & live))
        ref = (
            JK.dense_group_reduce(jargs[0], jnp.asarray(vals), jargs[1], k, "count"),
            JK.dense_group_reduce(jargs[0], jnp.asarray(rows), jargs[1], k, "min"),
            JK.dense_group_reduce(jargs[0], jnp.asarray(vals), jargs[1], k, "sum"),
        )
        for g, w, r in zip(got, want, ref):
            assert g.dtype == torch.int64 and g.shape == (k,)
            np.testing.assert_array_equal(g.numpy(), w.numpy())
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        counts, first, sums = (g.numpy() for g in got)
        assert counts.sum() == (sel & live).sum()
        assert (first[counts == 0] == np.iinfo(np.int64).max).all()
        assert (sums[counts == 0] == 0).all()
        only = AK.dense_segment_sum_count_plain(c, s, None, _SEG_LIVE, row_base, k)
        np.testing.assert_array_equal(only[0].numpy(), counts)
        np.testing.assert_array_equal(only[1].numpy(), first)
        assert not only[2].any()


@pytest.mark.parametrize("planes", [0, 1, 12])
@pytest.mark.parametrize("selection", ["none", "all", "hot"])
@pytest.mark.parametrize("k", [4097, 131072, 1 << 20])
def test_dense_table_sum_count_plain_matches_sorted_group_reduce(k, selection, planes):
    """The table route's one-pass reduction (plain version) against
    ``kernels.sorted_group_reduce``, the route's reduction before it, bit
    for bit: counts, first rows and every sum, over no selected row, every
    row, or every row with one hot code on half of them; int64 values near
    +-2^63 whose sums wrap; ``row_base`` 0 and past 2^31; codes outside [0,
    K) (selected, adding nothing); selected rows past the live count ``n``
    ignored; 0, 1 and 12 sum planes (one kernel pass)."""
    from frostdb_tpu_torch.ops import agg_kernels as AK

    rng = np.random.default_rng([k, len(selection), planes])
    codes = rng.integers(0, k, _SEG_PAD).astype(np.int32)
    if selection == "hot":
        codes[rng.random(_SEG_PAD) < 0.5] = k - 1
    codes[::97] = -1
    codes[::101] = k
    sel = np.full(_SEG_PAD, selection != "none")
    vals = []
    for _p in range(planes):
        v = rng.integers(2**62, 2**63 - 1, _SEG_PAD, dtype=np.int64)
        v[rng.random(_SEG_PAD) < 0.5] *= -1
        vals.append(v)
    live = np.arange(_SEG_PAD) < _SEG_LIVE
    c, s = torch.from_numpy(codes), torch.from_numpy(sel)
    tv = [torch.from_numpy(v) for v in vals]
    for row_base in (0, 3 * 2**31 + 7):
        counts, first, sums = AK.dense_table_sum_count_plain(c, s, tv, _SEG_LIVE, row_base, k)
        rows = torch.arange(_SEG_PAD, dtype=torch.int64) + row_base
        w_counts, w_first, w_sums = PK.sorted_group_reduce(
            c, torch.from_numpy(sel & live), rows, tuple(tv), k, (PK.AGG_SUM,) * planes)
        assert all(t.dtype == torch.int64 and t.shape == (k,) for t in (counts, first, *sums))
        assert len(sums) == planes
        np.testing.assert_array_equal(counts.numpy(), w_counts.numpy())
        has = counts.numpy() > 0
        np.testing.assert_array_equal(first.numpy()[has], w_first.numpy()[has])
        assert (first.numpy()[~has] == np.iinfo(np.int64).max).all()
        for g, w in zip(sums, w_sums):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        in_range = (codes >= 0) & (codes < k)
        assert counts.sum() == (sel & live & in_range).sum()
        if selection == "hot":
            assert counts[k - 1] > _SEG_LIVE // 3


_SUM, _MIN = ME.Slot(0, 2, 0, PK.AGG_SUM, 0), ME.Slot(1, 2, 0, PK.AGG_MIN, 2**62)


@pytest.mark.parametrize("k,slots,route", [
    (4096, (_SUM,), "segment"),
    (4097, (_SUM,), "table"),
    (4097, (), "table"),
    (1 << 20, (_SUM, _SUM), "table"),
    ((1 << 20) + 1, (_SUM,), "shuffle"),
    (4096, (_SUM, _MIN), "segment"),
    (4097, (_SUM, _MIN), "sorted"),
    (6000, (_MIN,), "sorted"),
    (1 << 20, (_MIN,), "sorted"),
    ((1 << 20) + 1, (_MIN,), "shuffle"),
], ids=lambda x: "-".join(s.op for s in x) or "count" if isinstance(x, tuple) else str(x))
def test_dense_route_boundaries(k, slots, route):
    """The route at the segment route's threshold (4,096 / 4,097 codes) and
    at the dense tier's ceiling (2^20 / 2^20 + 1): past 4,096 codes the
    table route where every partial slot is a sum (a count has none), the
    sorted route where one is a min or max."""
    assert ME.dense_route(k, slots, ME.DenseLocalAggregate.MAX_CODES) == route


@pytest.mark.parametrize("aggs,route", [
    ("sum_count", "table"), ("sum_min", "sorted"), ("min", "sorted")])
def test_routes_past_the_segment_threshold(aggs, route):
    """About 6,000 codes: sums and counts on the table route, and any query
    with a min slot on the sorted route, rows equal to the JAX package's."""
    types = [f"u{i % 6000}" for i in range(12000)]
    jdb, _t = TC._setup_values(list(range(12000)), types=types, tss=list(range(12000)))
    pdb = carry(jdb)
    fns = {
        "sum_count": lambda E: [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
        "sum_min": lambda E: [E.Sum(E.Col("value")), E.Min(E.Col("value"))],
        "min": lambda E: [E.Min(E.Col("value"))],
    }
    make_q = agg(fns[aggs], lambda E: [E.Col("example_type")],
                 lambda E: E.Col("timestamp").gt_eq(100))
    ref, got = run_both(jdb, make_q, pdb=pdb)
    assert_same(ref, got, "dense")
    assert len(got[0]) == 6000
    tracer = Tracer()
    peng = PEngine(pdb.table_provider(), exec_options=POptions(tracer=tracer))
    make_q(peng, PE).execute(lambda b: None)
    (dense,) = [c for c in tracer.roots[0].children if c.name == "dense/execute"]
    (parts,) = [c for c in dense.children if c.name == "dense/parts"]
    assert parts.attributes["route"] == route


# ---------------------------------------------------------------------------
# Memory limits on the shuffle route


def _shuffle_db():
    _s, jdb, _t = TSA._mk(rows=3000)
    return carry(jdb)


def _shuffle_query(pdb, alloc):
    eng = PEngine(pdb.table_provider(), allocator=alloc)
    out = []
    eng.scan_table("t").aggregate([PE.Sum(PE.Col("v"))], [PE.Col("k")]).execute(out.append)
    return eng, out


def test_shuffle_route_memory_limit():
    """The shuffle route accounts its result blob: a limit below it raises
    MemoryLimitExceeded as a query error (no fallback); a limit above it
    serves on the dense tier and leaves nothing reserved."""
    pdb = _shuffle_db()
    with pytest.raises(MemoryLimitExceeded):
        _shuffle_query(pdb, LimitAllocator(1 << 20))
    alloc = LimitAllocator(1 << 30)
    eng, out = _shuffle_query(pdb, alloc)
    assert eng.last_serving_path == "dense"
    assert sum(b.num_rows for b in out) > 1000
    assert alloc.allocated() == 0


@pytest.mark.divergence
def test_shuffle_route_releases_its_reservation_once():
    """Divergence: the reference's shuffle epilogue releases the result
    blob's reservation and its caller releases it again, so bytes another
    query holds on the same allocator are released too. The port releases
    it once: what was held before the query is held after it."""
    from frostdb_tpu.memorylimit import LimitAllocator as JLimitAllocator

    held = 300 << 20
    _s, jdb, _t = TSA._mk(rows=3000)
    jalloc = JLimitAllocator(1 << 31)
    jalloc.allocate(held)
    jeng = JEngine(jdb.table_provider(), allocator=jalloc)
    jeng.scan_table("t").aggregate([JE.Sum(JE.Col("v"))], [JE.Col("k")]).execute(lambda b: None)
    assert jeng.last_serving_path == "dense"
    assert jalloc.allocated() < held  # the reference released bytes it never took

    alloc = LimitAllocator(1 << 31)
    alloc.allocate(held)
    eng, _out = _shuffle_query(carry(jdb), alloc)
    assert eng.last_serving_path == "dense"
    assert alloc.allocated() == held


# ---------------------------------------------------------------------------
# The compiled tiers over a table with a data source


def _source_batch(table, rng, n):
    d_et = table.dictionary("example_type")
    d_l = table.dictionary("labels")
    et, etv = d_et.encode([f"type{int(x)}" for x in rng.integers(0, 3, n)])
    lc, lv = d_l.encode([f"g{int(x)}" for x in rng.integers(0, 5, n)])
    return ColumnBatch(
        [
            Column("example_type", KIND_DICT, et, etv, d_et),
            Column("labels.label1", KIND_DICT, lc, lv, d_l),
            Column("timestamp", KIND_INT64, rng.integers(0, 1000, n).astype(np.int64), np.ones(n, bool)),
            Column("value", KIND_INT64, rng.integers(-50, 50, n).astype(np.int64), np.ones(n, bool)),
        ],
        n,
    )


class _BlockSource:
    """A persisted-block source with the block-granular API: one block
    whose row groups are ``batches``."""

    def __init__(self, batches):
        self.batches = batches

    def list_blocks(self, db_name, table_name):
        return [("persisted-block", None)]

    def read_block_parts(self, ref, schema, dictionary):
        return self.batches


class _ScanSource:
    """A source that only streams its rows (no block API)."""

    def __init__(self, batches):
        self.batches = batches

    def scan(self, db_name, table_name, schema, filter, dictionary, exclude_block_ids=()):
        return list(self.batches)


def _sourced_db(source_cls):
    pdb = P.ColumnStore(device="cpu").db("src")
    table = pdb.table("t", TableConfig(schema=sample_definition()))
    rng = np.random.default_rng(9)
    table.insert_record(_source_batch(table, rng, 700))
    table.sync()
    pdb.sources.append(source_cls([_source_batch(table, rng, 500), _source_batch(table, rng, 300)]))
    return pdb


_SOURCE_QUERIES = {
    "compiled": agg(
        lambda E: [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
        lambda E: [E.Col("labels.label1")],
        lambda E: E.Col("timestamp").gt_eq(20),
    ),
    "dense": agg(
        lambda E: [E.Min(E.Col("value")), E.Count(E.Col("value"))],
        lambda E: [E.Col("labels.label1"), E.Col("timestamp")],
    ),
    "compiled_distinct": lambda eng, E: eng.scan_table("t").distinct(E.Col("labels.label1")),
}


@pytest.mark.parametrize("path", sorted(_SOURCE_QUERIES))
@pytest.mark.parametrize("source_cls", [_BlockSource, _ScanSource])
def test_tiers_read_data_sources(path, source_cls):
    """A block-API source's row groups join the compiled tiers' parts, so
    their rows equal the generic DAG's (which reads the source too); a
    source without the block API makes each tier decline with the
    reference's reason and the generic DAG serves."""
    pdb = _sourced_db(source_cls)
    make_q = _SOURCE_QUERIES[path]
    outs = {}
    for compiled in (False, True):
        eng = PEngine(pdb.table_provider(), exec_options=POptions(compiled_serving=compiled))
        out = []
        make_q(eng, PE).execute(out.append)
        outs[compiled] = (FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons)
    assert outs[True][0] == outs[False][0]
    if path == "dense":  # every row of the table and its source
        assert sum(v for r in outs[True][0] for name, v in r if name.startswith("count")) == 1500
    if source_cls is _BlockSource:
        assert outs[True][1] == path, outs[True][2]
    else:
        assert outs[True][1] == "generic"
        assert outs[True][2][path] == "a data source lacks the block API"
