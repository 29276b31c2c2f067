"""The port's ``compiled_join`` tier (the groupjoin decomposition on the
sum/count and min/max kernels) against the JAX package's, and against the
port's own generic HashJoin -> HashAggregate DAG.

Tables are built with the JAX package (tests/test_join_fused.py's and
tests/test_differential_fuzz.py's builders) and carried across with
``frostdb_tpu_torch.interop.table_from_numpy``. For every query the port's
fused rows, the JAX package's fused rows and the port's generic rows must be
identical, order included; the port must serve ``compiled_join`` wherever
the JAX package did, and decline with the same reason where it declined.
"""

import numpy as np
import pytest

import test_differential_fuzz as FZ
import test_join_fused as JF
from frostdb_tpu.columnbatch import Column as JColumn
from frostdb_tpu.columnbatch import ColumnBatch as JColumnBatch
from frostdb_tpu.columnbatch import KIND_DICT, KIND_INT64
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.schema import (
    ColumnDef,
    ENCODING_RLE_DICTIONARY,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    TYPE_INT64,
    TYPE_STRING,
    sample_definition,
)
from frostdb_tpu.table import TableConfig as JTableConfig
from test_torch_engine import carry

import frostdb_tpu_torch.compiled_join as PCJ
from frostdb_tpu_torch.columnbatch import Column as PColumn
from frostdb_tpu_torch.columnbatch import ColumnBatch as PColumnBatch
from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions


def run_jax(jdb, make_q):
    eng = JEngine(jdb.table_provider())
    out = []
    make_q(eng, JE).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons


def run_port(pdb, make_q, compiled=True):
    eng = PEngine(pdb.table_provider(), POptions(compiled_serving=compiled))
    out = []
    make_q(eng, PE).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons


def check(jdb, pdb, make_q, expect_path="compiled_join"):
    """Port fused == JAX fused == port generic, and the same serving
    decision as the JAX package. Returns the rows."""
    ref, jpath, jreasons = run_jax(jdb, make_q)
    out, path, reasons = run_port(pdb, make_q)
    generic, gpath, _ = run_port(pdb, make_q, compiled=False)
    assert gpath == "generic"
    assert out == ref, (path, reasons)
    assert generic == ref
    if expect_path is not None:
        assert jpath == expect_path, (jpath, jreasons)
    if jpath == "compiled_join":
        assert path == "compiled_join", reasons
    else:
        assert path == "generic"
        assert reasons["compiled_join"] == jreasons["compiled_join"]
    return out


def q_join(e, how="inner", right=None):
    return e.scan_table("stacktraces").join(
        right if right is not None else e.scan_table("dims"),
        on=["labels.node"],
        how=how,
    )


def fused_db(**kw):
    _store, jdb = JF.build_db(**kw)
    return jdb, carry(jdb, names=("stacktraces", "dims"))


@pytest.fixture(scope="module")
def dbs():
    return fused_db()


def test_sum_right_by_key(dbs):
    out = check(
        *dbs,
        lambda e, E: q_join(e)
        .filter(E.Col("timestamp").gt_eq(100))
        .aggregate([E.Sum(E.Col("weight"))], [E.Col("labels.node")]),
    )
    assert out


def test_all_agg_funcs_both_sides(dbs):
    check(
        *dbs,
        lambda e, E: q_join(e).aggregate(
            [
                E.Sum(E.Col("weight")),
                E.Count(E.Col("weight")),
                E.Min(E.Col("weight")),
                E.Max(E.Col("weight")),
                E.Sum(E.Col("value")),
                E.Min(E.Col("value")),
                E.Max(E.Col("value")),
                E.Count(E.Col("value")),
            ],
            [E.Col("labels.node")],
        ),
    )


def test_group_by_non_key_and_window(dbs):
    check(
        *dbs,
        lambda e, E: q_join(e)
        .filter(E.Col("timestamp").lt(700))
        .aggregate(
            [E.Sum(E.Col("weight")), E.Count(E.Col("value"))],
            [E.Duration(250)],
        ),
    )
    check(
        *dbs,
        lambda e, E: q_join(e).aggregate(
            [E.Sum(E.Col("weight"))],
            [E.Col("example_type"), E.Col("labels.node")],
        ),
        # example_type is absent from every part -> generic missing-column
        # semantics (part lacks example_type)
        expect_path="generic",
    )


def test_avg_rewrite(dbs):
    check(
        *dbs,
        lambda e, E: q_join(e).aggregate(
            [E.Avg(E.Col("weight"))], [E.Col("labels.node")]
        ),
    )


@pytest.mark.parametrize("how", ["semi", "anti"])
def test_semi_anti(dbs, how):
    check(
        *dbs,
        lambda e, E: q_join(e, how).aggregate(
            [E.Sum(E.Col("value")), E.Count(E.Col("value"))],
            [E.Col("labels.node")],
        ),
    )


def test_or_in_filters_combined(dbs):
    check(
        *dbs,
        lambda e, E: q_join(e)
        .filter(
            E.And(
                E.Or(
                    E.Col("timestamp").lt(300),
                    E.Col("timestamp").gt_eq(800),
                ),
                E.Col("labels.node").regex_match(r"^n[12]"),
            )
        )
        .aggregate([E.Sum(E.Col("weight"))], [E.Col("labels.node")]),
    )


@pytest.mark.parametrize("how", ["inner", "anti"])
def test_empty_right_and_no_matches(dbs, how):
    # dims filtered to nothing -> inner join empty, anti keeps all valid
    check(
        *dbs,
        lambda e, E: q_join(
            e, how, e.scan_table("dims").filter(E.Col("weight").gt(10**9))
        ).aggregate([E.Count(E.Col("value"))], [E.Col("labels.node")]),
    )


def test_right_subquery_filter(dbs):
    check(
        *dbs,
        lambda e, E: q_join(
            e, "inner", e.scan_table("dims").filter(E.Col("weight").gt(0))
        ).aggregate(
            [E.Sum(E.Col("weight")), E.Sum(E.Col("value"))],
            [E.Col("labels.node")],
        ),
    )


def test_wide_values():
    # Probe values needing the two-plane (wide) path; products bounded by
    # the candidate-corner range.
    check(
        *fused_db(value_scale=3_000_000_000),
        lambda e, E: q_join(e).aggregate(
            [
                E.Sum(E.Col("value")),
                E.Min(E.Col("value")),
                E.Max(E.Col("value")),
                E.Count(E.Col("value")),
            ],
            [E.Col("labels.node")],
        ),
    )


def test_missing_right_column_is_all_null(dbs):
    check(
        *dbs,
        lambda e, E: q_join(e).aggregate(
            [E.Sum(E.Col("nosuchcol"))], [E.Col("labels.node")]
        ),
    )


def _renamed_db():
    """test_join_fused.test_renamed_right_column's tables: the build side
    carries a ``value`` column that collides with the probe side's."""
    store = JColumnStore()
    db = store.db("t")
    table = db.table("stacktraces", JTableConfig(schema=sample_definition()))
    d_l = table.dictionary("labels")
    rng = np.random.default_rng(3)
    n = 2000
    node, nodev = d_l.encode([f"n{int(i)}" for i in rng.integers(0, 10, n)])
    ones = np.ones(n, bool)
    table.insert_record(
        JColumnBatch(
            [
                JColumn("labels.node", KIND_DICT, node, nodev, d_l),
                JColumn("timestamp", KIND_INT64, rng.integers(0, 100, n).astype(np.int64), ones),
                JColumn("value", KIND_INT64, rng.integers(0, 50, n).astype(np.int64), ones),
            ],
            n,
        ),
        sort=True,
    )
    table.sync()
    dims = db.table("dims", JTableConfig(schema=JF._dims_schema(("value",))))
    d_dim = dims.dictionary("labels")
    codes, _ = d_dim.encode([f"n{i}" for i in range(0, 10, 2)])
    m = len(codes)
    dims.insert_record(
        JColumnBatch(
            [
                JColumn("labels.node", KIND_DICT, codes, np.ones(m, bool), d_dim),
                JColumn("value", KIND_INT64, np.arange(m, dtype=np.int64) * 7, np.ones(m, bool)),
            ],
            m,
        )
    )
    return db, carry(db, names=("stacktraces", "dims"))


def test_renamed_right_column():
    # plain name = probe side, renamed (value_right) = build side
    check(
        *_renamed_db(),
        lambda e, E: q_join(e).aggregate(
            [E.Sum(E.Col("value")), E.Sum(E.Col("value_right"))],
            [E.Col("labels.node")],
        ),
    )


def test_left_outer_null_group_keys_fall_back(dbs):
    # left_outer keeps null-key rows, whose group key is null -> the
    # compiled tiers cannot emit the null-key group
    check(
        *dbs,
        lambda e, E: q_join(e, "left_outer").aggregate(
            [E.Sum(E.Col("weight"))], [E.Col("labels.node")]
        ),
        expect_path="generic",
    )


def test_left_outer_fused():
    # valid keys everywhere -> the left_outer decomposition serves:
    # unmatched rows emit one row with null build values (zero slots)
    jdb, pdb = fused_db(null_keys=False, weight_lo=0)
    check(
        jdb,
        pdb,
        lambda e, E: q_join(e, "left_outer").aggregate(
            [
                E.Sum(E.Col("weight")),
                E.Count(E.Col("weight")),
                E.Min(E.Col("weight")),
                E.Max(E.Col("weight")),
                E.Sum(E.Col("value")),
                E.Count(E.Col("value")),
            ],
            [E.Col("labels.node")],
        ),
    )
    check(
        jdb,
        pdb,
        lambda e, E: q_join(e, "left_outer")
        .filter(E.Col("timestamp").lt(600))
        .aggregate(
            [E.Sum(E.Col("weight")), E.Count(E.Col("value"))],
            [E.Duration(250)],
        ),
    )


def test_left_outer_null_keys_by_window():
    # null-key probe rows survive left_outer once each (count 1, null build
    # values): with a window group key they stay on the fused path and take
    # the gathered planes' else branch
    check(
        *fused_db(null_keys=True, weight_lo=0),
        lambda e, E: q_join(e, "left_outer").aggregate(
            [E.Sum(E.Col("weight")), E.Count(E.Col("value")), E.Sum(E.Col("value"))],
            [E.Duration(250)],
        ),
    )


def test_left_outer_negative_partials_fall_back():
    # negative build-side sums break the bias-0 requirement of the
    # left_outer gathered planes -> generic, with the reference's reason
    out = check(
        *fused_db(seed=9, null_keys=False),
        lambda e, E: q_join(e, "left_outer").aggregate(
            [E.Sum(E.Col("weight"))], [E.Col("labels.node")]
        ),
        expect_path="generic",
    )
    assert out


def test_dict_growth_between_queries():
    jdb, pdb = fused_db()

    def q(e, E):
        return q_join(e).aggregate(
            [E.Sum(E.Col("weight")), E.Count(E.Col("value"))],
            [E.Col("labels.node")],
        )

    check(jdb, pdb, q)
    # grow the probe dictionary and add a part, in both packages, and add
    # build rows matching the new values (the match set changes too)
    rng = np.random.default_rng(11)
    n = 1000
    names = [f"m{int(i)}" for i in rng.integers(0, 30, n)]
    ts = rng.integers(0, 1000, n).astype(np.int64)
    val = rng.integers(-10, 10, n).astype(np.int64)
    dnames = [f"m{i}" for i in range(0, 30, 3)]
    dw = np.arange(len(dnames), dtype=np.int64)
    for db, Col, Batch in ((jdb, JColumn, JColumnBatch), (pdb, PColumn, PColumnBatch)):
        table = db.get_table("stacktraces")
        d_l = table.dictionary("labels")
        node, nodev = d_l.encode(names)
        ones = np.ones(n, bool)
        table.insert_record(
            Batch(
                [
                    Col("labels.node", KIND_DICT, node, nodev, d_l),
                    Col("timestamp", KIND_INT64, ts, ones),
                    Col("value", KIND_INT64, val, ones),
                ],
                n,
            ),
            sort=True,
        )
        table.sync()
        dims = db.get_table("dims")
        d_dim = dims.dictionary("labels")
        codes, _ = d_dim.encode(dnames)
        m = len(dnames)
        dims.insert_record(
            Batch(
                [
                    Col("labels.node", KIND_DICT, codes, np.ones(m, bool), d_dim),
                    Col("weight", KIND_INT64, dw, np.ones(m, bool)),
                ],
                m,
            )
        )
    # the grown port tables against the port's generic DAG (their parts
    # were laid out by the port's own LSM) ...
    fused, path, reasons = run_port(pdb, q)
    generic, _gpath, _ = run_port(pdb, q, compiled=False)
    assert path == "compiled_join", reasons
    assert fused == generic
    assert any(r[0][1].startswith("m") for r in fused)
    # ... and the grown JAX tables carried across anew against the JAX
    # package
    check(jdb, carry(jdb, names=("stacktraces", "dims")), q)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_parity(seed):
    jdb, pdb = fused_db(
        seed=seed,
        n_parts=2 + seed % 3,
        n_per_part=1500,
        null_keys=bool(seed % 2),
        value_scale=10 ** (3 + seed),
    )
    rng = np.random.default_rng(seed * 101)
    for _q in range(4):
        lit = int(rng.integers(0, 1000))
        extra_mm = rng.random() < 0.5
        extra_sum = rng.random() < 0.5
        window = rng.random() < 0.4

        def make_q(e, E):
            aggs = [E.Sum(E.Col("weight")), E.Count(E.Col("value"))]
            if extra_mm:
                aggs += [E.Min(E.Col("weight")), E.Max(E.Col("value"))]
            if extra_sum:
                aggs.append(E.Sum(E.Col("value")))
            groups = [E.Col("labels.node")]
            if window:
                groups.append(E.Duration(200))
            return (
                q_join(e)
                .filter(E.Col("timestamp").gt_eq(lit))
                .aggregate(aggs, groups)
            )

        check(jdb, pdb, make_q)


# ---------------------------------------------------------------------------
# int64 join keys


def int_key_db(**kw):
    _store, jdb = JF._int_key_db(**kw)
    return jdb, carry(jdb, names=("t", "dims"))


def _int_join(e, how="inner"):
    return e.scan_table("t").join(e.scan_table("dims"), on=["id"], how=how)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int_key_join_fused(seed):
    # Range-dense int64 join keys (id joins): codes derive from the probe
    # parts' zone-map span; build rows outside the span match nothing.
    jdb, pdb = int_key_db(seed=seed)
    check(
        jdb,
        pdb,
        lambda e, E: _int_join(e).aggregate(
            [
                E.Sum(E.Col("w")),
                E.Count(E.Col("v")),
                E.Min(E.Col("w")),
                E.Max(E.Col("w")),
                E.Sum(E.Col("v")),
            ],
            [E.Col("g")],
        ),
    )
    check(
        jdb,
        pdb,
        lambda e, E: _int_join(e)
        .filter(E.Col("id").lt(5000))
        .aggregate([E.Sum(E.Col("w"))], [E.Col("g")]),
    )
    for how in ("semi", "anti"):
        check(
            jdb,
            pdb,
            lambda e, E: _int_join(e, how).aggregate(
                [E.Sum(E.Col("v")), E.Count(E.Col("v"))], [E.Col("g")]
            ),
        )


def test_int_key_span_ceiling_falls_back():
    # key span past the LUT ceiling (2^21) -> generic
    check(
        *int_key_db(id_lo=0, id_hi=1 << 24, dims_hi=1 << 24),
        lambda e, E: _int_join(e).aggregate([E.Sum(E.Col("w"))], [E.Col("g")]),
        expect_path="generic",
    )


def test_int_key_left_outer_falls_back():
    check(
        *int_key_db(),
        lambda e, E: _int_join(e, "left_outer").aggregate(
            [E.Sum(E.Col("w"))], [E.Col("g")]
        ),
        expect_path="generic",
    )


def test_right_to_left_codes_cache_pins_dictionaries(dbs):
    """The build->probe code map is cached per dictionary version and holds
    both dictionaries, so a recycled address never serves a stale map."""
    _jdb, pdb = dbs
    rd = pdb.get_table("dims").dictionary("labels")
    ld = pdb.get_table("stacktraces").dictionary("labels")
    PCJ._R2L_CACHE.clear()
    m = PCJ._right_to_left_codes(rd, ld)
    assert PCJ._right_to_left_codes(rd, ld) is m
    hit = next(iter(PCJ._R2L_CACHE.values()))
    assert hit[0] is rd and hit[1] is ld
    values = rd.value_array()
    for code, lc in enumerate(m):
        assert (ld.lookup(values[code]) if lc >= 0 else None) == (
            None if lc < 0 else int(lc)
        )


# ---------------------------------------------------------------------------
# The join sweeps of tests/test_differential_fuzz.py


def _fuzz_dims(jdb, rng):
    """test_join_differential's build side: a subset of g values, with
    duplicates and nulls."""
    dims = jdb.table(
        "dims",
        JTableConfig(
            schema=SchemaDef(
                "dims",
                (
                    ColumnDef(
                        "g",
                        StorageLayout(
                            TYPE_STRING,
                            nullable=True,
                            encoding=ENCODING_RLE_DICTIONARY,
                        ),
                    ),
                    ColumnDef("w", StorageLayout(TYPE_INT64, nullable=True)),
                ),
                (SortingColumnDef("g", "asc", True),),
            )
        ),
    )
    dd = dims.dictionary("g")
    vals = [f"g{int(i)}" for i in rng.integers(0, 10, int(rng.integers(2, 12)))]
    codes, valid = dd.encode(vals)
    m = len(codes)
    wv = rng.random(m) > 0.2
    lo = -50 if rng.random() < 0.5 else 0
    dims.insert_record(
        JColumnBatch(
            [
                JColumn("g", KIND_DICT, codes, valid, dd),
                JColumn(
                    "w",
                    KIND_INT64,
                    np.where(wv, rng.integers(lo, 100, m), 0).astype(np.int64),
                    wv,
                ),
            ],
            m,
        )
    )


@pytest.mark.parametrize("seed", range(6))
def test_join_differential(seed):
    rng = np.random.default_rng(9000 + seed)
    _store, jdb = FZ.build_db(rng)
    _fuzz_dims(jdb, rng)
    pdb = carry(jdb, names=("t", "dims"))
    for how in ("inner", "left_outer", "semi", "anti"):

        def make_q(e, E):
            aggs = (
                [E.Sum(E.Col("w")), E.Count(E.Col("v")), E.Min(E.Col("w"))]
                if how in ("inner", "left_outer")
                else [E.Sum(E.Col("v")), E.Count(E.Col("v"))]
            )
            return (
                e.scan_table("t")
                .join(e.scan_table("dims"), on=["g"], how=how)
                .aggregate(aggs, [E.Col("g")])
            )

        check(jdb, pdb, make_q, expect_path=None)


@pytest.mark.parametrize("seed", range(4))
def test_int_key_join_differential(seed):
    rng = np.random.default_rng(13000 + seed)
    _store, jdb = FZ.build_db(rng)
    dims = jdb.table(
        "idims",
        JTableConfig(
            schema=SchemaDef(
                "idims",
                (
                    ColumnDef("ts", StorageLayout(TYPE_INT64, nullable=True)),
                    ColumnDef("w", StorageLayout(TYPE_INT64, nullable=True)),
                ),
                (),
            )
        ),
    )
    m = int(rng.integers(5, 300))
    dv = rng.random(m) > 0.1
    dims.insert_record(
        JColumnBatch(
            [
                JColumn(
                    "ts",
                    KIND_INT64,
                    np.where(dv, rng.integers(0, 10**5, m), 0).astype(np.int64),
                    dv,
                ),
                JColumn(
                    "w",
                    KIND_INT64,
                    rng.integers(0, 50, m).astype(np.int64),
                    rng.random(m) > 0.2,
                ),
            ],
            m,
        )
    )
    pdb = carry(jdb, names=("t", "idims"))
    for how in ("inner", "semi", "anti"):

        def make_q(e, E):
            aggs = (
                [E.Sum(E.Col("w")), E.Count(E.Col("v"))]
                if how == "inner"
                else [E.Sum(E.Col("v"))]
            )
            return (
                e.scan_table("t")
                .join(e.scan_table("idims"), on=["ts"], how=how)
                .aggregate(aggs, [E.Col("g")])
            )

        check(jdb, pdb, make_q, expect_path=None)
