"""The port's generic join against the JAX package: ``query/join.py``, the
``HashJoin`` operator and ``ops/kernels.join_expand``.

Tables are built with the JAX package (tests/test_join_engine.py's builders)
and carried across with ``frostdb_tpu_torch.interop.table_from_numpy``; the
same queries run through both engines and the full ``(name, py_value)`` rows
must be identical, order included. ``join_expand`` is held against the
reference's ``K.join_expand`` on seeded random codes, slot for slot.
"""

import numpy as np
import pytest
import torch

import test_join_engine as JT
from frostdb_tpu.columnbatch import Column as JColumn
from frostdb_tpu.columnbatch import ColumnBatch as JColumnBatch
from frostdb_tpu.columnbatch import (
    KIND_DICT,
    KIND_FLOAT64,
    KIND_INT64,
    KIND_UINT64,
)
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.ops import kernels as JK
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query import join as JJ
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.schema import ColumnDef, SchemaDef, SortingColumnDef
from frostdb_tpu.schema import StorageLayout, TYPE_INT64
from frostdb_tpu.table import TableConfig as JTableConfig
from test_torch_engine import carry, to_port

import frostdb_tpu_torch.query.join as PJ
from frostdb_tpu_torch.columnbatch import Column as PColumn
from frostdb_tpu_torch.columnbatch import ColumnBatch as PColumnBatch
from frostdb_tpu_torch.ops import kernels as PK
from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.query.physeval import EvalError as PEvalError


def rows(batches):
    """Full (name, py_value) rows; floats by repr, so NaN keys compare."""
    return [
        tuple(
            (c.name, repr(v) if isinstance(v, float) else v)
            for c in b.columns
            for v in (c.py_value(i),)
        )
        for b in batches
        for i in range(b.num_rows)
    ]


def run_both(jdb, pdb, make_q, compiled=True):
    """(JAX rows, port rows, port serving path) of one query."""
    jeng = JEngine(jdb.table_provider())
    jeng.exec_options.compiled_serving = compiled
    peng = PEngine(pdb.table_provider(), POptions(compiled_serving=compiled))
    a, b = [], []
    make_q(jeng, JE).execute(a.append)
    make_q(peng, PE).execute(b.append)
    return rows(a), rows(b), peng.last_serving_path


@pytest.fixture(scope="module")
def dbs():
    _store, jdb = JT._setup()
    return jdb, carry(jdb, names=("facts", "dims"))


def _join_q(how, on=("job",), right_filter=None):
    def make_q(eng, E):
        right = eng.scan_table("dims")
        if right_filter is not None:
            right = right.filter(
                right_filter if E is JE else to_port(right_filter)
            )
        return eng.scan_table("facts").join(right, on=list(on), how=how)

    return make_q


@pytest.mark.parametrize("how", ["inner", "left_outer", "semi", "anti"])
def test_join_modes_match_jax(dbs, how):
    jdb, pdb = dbs
    ref, out, path = run_both(jdb, pdb, _join_q(how))
    assert out == ref
    assert path == "generic"
    # the oracle of the reference suite, on the port's own scans
    eng = PEngine(pdb.table_provider(), POptions())
    lrows = _scan_rows(eng, "facts", ["job", "site", "value"])
    rrows = _scan_rows(eng, "dims", ["job", "region", "weight"])
    expect = JT._oracle_join(lrows, rrows, ["job"], how, ["region", "weight"])
    assert [dict(r) for r in out] == expect


def _scan_rows(engine, table, cols):
    out = []
    engine.scan_table(table).project(*(PE.Col(c) for c in cols)).execute(
        out.append
    )
    return [
        {c.name: c.py_value(i) for c in b.columns}
        for b in out
        for i in range(b.num_rows)
    ]


def test_join_right_side_filter_keeps_payload_columns(dbs):
    jdb, pdb = dbs
    ref, out, _ = run_both(
        jdb, pdb, _join_q("inner", right_filter=JE.Col("region").eq("r1"))
    )
    assert out == ref and out
    assert {n for r in out for n, _v in r} >= {"region", "weight"}


@pytest.mark.parametrize("compiled", [True, False])
def test_join_then_aggregate(dbs, compiled):
    """sum(value) by the joined dim region: the build-side group key keeps
    the query on the generic HashJoin -> HashAggregate."""
    jdb, pdb = dbs

    def make_q(eng, E):
        return _join_q("inner")(eng, E).aggregate(
            [E.Sum(E.Col("value"))], [E.Col("region")]
        )

    ref, out, path = run_both(jdb, pdb, make_q, compiled)
    assert out == ref and out
    assert path == "generic"


def test_join_multi_key_and_collision_rename():
    """Two-column keys; a right column colliding with a left name gets the
    _right suffix."""
    jdb = JColumnStore().db("test")

    def schema(name):
        return SchemaDef(
            name=name,
            columns=(
                ColumnDef("k1", JT._DICT_STR),
                ColumnDef("k2", StorageLayout(TYPE_INT64)),
                ColumnDef("v", StorageLayout(TYPE_INT64)),
            ),
            sorting_columns=(SortingColumnDef("k1", "asc", True),),
        )

    for name, keys, k2, v in (
        ("a", ["x", "x", "y", "z"], [1, 2, 1, 1], [10, 20, 30, 40]),
        ("b", ["x", "y", "y"], [1, 1, 2], [100, 200, 300]),
    ):
        t = jdb.table(name, JTableConfig(schema=schema(name)))
        d = t.dictionary("k1")
        c, va = d.encode(keys)
        n = len(keys)
        t.insert_record(
            JColumnBatch(
                [
                    JColumn("k1", KIND_DICT, c, va, d),
                    JColumn("k2", KIND_INT64, np.array(k2), np.ones(n, bool)),
                    JColumn("v", KIND_INT64, np.array(v), np.ones(n, bool)),
                ],
                n,
            )
        )
    pdb = carry(jdb, names=("a", "b"))

    def make_q(eng, E):
        return eng.scan_table("a").join(
            eng.scan_table("b"), on=["k1", "k2"], how="inner"
        )

    ref, out, _ = run_both(jdb, pdb, make_q)
    assert out == ref
    assert [dict(r) for r in out] == [
        {"k1": "x", "k2": 1, "v": 10, "v_right": 100},
        {"k1": "y", "k2": 1, "v": 30, "v_right": 200},
    ]


def test_join_explain(dbs):
    _jdb, pdb = dbs
    eng = PEngine(pdb.table_provider(), POptions())
    s = eng.scan_table("facts").join(
        eng.scan_table("dims"), on=["job"], how="left_outer"
    ).explain()
    assert "HashJoin (left_outer on job)" in s
    assert "TableScan" in s


@pytest.mark.parametrize("agg", [False, True])
def test_join_memory_limit(dbs, agg):
    """The join's accumulated probe batches (and, under an aggregate, the
    compiled_join tier's result blob) are accounted: a tiny limit fails the
    query in both packages, an ample one gives the unlimited rows and frees
    every reservation."""
    from frostdb_tpu.memorylimit import LimitAllocator as JLimit
    from frostdb_tpu.memorylimit import MemoryLimitExceeded as JExceeded
    from frostdb_tpu_torch.memorylimit import LimitAllocator as PLimit
    from frostdb_tpu_torch.memorylimit import MemoryLimitExceeded as PExceeded

    jdb, pdb = dbs

    def make_q(eng, E):
        q = _join_q("inner")(eng, E)
        return q.aggregate([E.Sum(E.Col("weight"))], [E.Col("job")]) if agg else q

    ref, _out, _path = run_both(jdb, pdb, make_q)
    for limit in (64, 1 << 30):
        jalloc, palloc = JLimit(limit), PLimit(limit)
        jeng = JEngine(jdb.table_provider(), allocator=jalloc)
        peng = PEngine(pdb.table_provider(), allocator=palloc)
        if limit == 64:
            with pytest.raises(JExceeded):
                make_q(jeng, JE).execute(lambda b: None)
            with pytest.raises(PExceeded):
                make_q(peng, PE).execute(lambda b: None)
            continue
        out = []
        make_q(peng, PE).execute(out.append)
        assert rows(out) == ref
        assert peng.last_serving_path == ("compiled_join" if agg else "generic")
        assert palloc.allocated() == 0


@pytest.mark.parametrize("how", ["inner", "anti"])
def test_join_empty_right(dbs, how):
    jdb, pdb = dbs
    ref, out, _ = run_both(
        jdb, pdb, _join_q(how, right_filter=JE.Col("region").eq("nope"))
    )
    assert out == ref
    if how == "inner":
        assert out == []
    else:
        # anti against an empty right keeps every valid-key left row
        eng = PEngine(pdb.table_provider(), POptions())
        lrows = _scan_rows(eng, "facts", ["job"])
        assert len(out) == sum(1 for r in lrows if r["job"] is not None)


# ---------------------------------------------------------------------------
# join_batches on host batches of numeric keys


def _num_batches(name_vals):
    """The same {name: array} batch in both packages."""
    kinds = {
        np.dtype(np.int64): KIND_INT64,
        np.dtype(np.uint64): KIND_UINT64,
        np.dtype(np.float64): KIND_FLOAT64,
    }
    jcols, pcols = [], []
    n = None
    for name, vals in name_vals.items():
        vals = np.asarray(vals)
        n = len(vals)
        valid = np.ones(n, dtype=np.bool_)
        jcols.append(JColumn(name, kinds[vals.dtype], vals, valid))
        pcols.append(PColumn(name, kinds[vals.dtype], vals, valid))
    return JColumnBatch(jcols, n), PColumnBatch(pcols, n)


def _both_join(left, right, on, how):
    """join_batches in both packages; equal rows asserted, port batch
    returned."""
    jout = JJ.join_batches(left[0], right[0], on, how)
    pout = PJ.join_batches(left[1], right[1], on, how, device="cpu")
    assert (jout is None) == (pout is None)
    if pout is not None:
        assert rows([pout]) == rows([jout])
        assert [c.kind for c in pout.columns] == [c.kind for c in jout.columns]
    return pout


def test_join_uint64_int64_no_wrap():
    """u64 2^64-1 must NOT equal i64 -1 cross-kind."""
    left = _num_batches(
        {"k": np.array([-1, 5, 7], dtype=np.int64),
         "lv": np.array([10, 20, 30], dtype=np.int64)}
    )
    right = _num_batches(
        {"k": np.array([2**64 - 1, 5], dtype=np.uint64),
         "rv": np.array([1, 2], dtype=np.uint64)}
    )
    out = _both_join(left, right, ["k"], "inner")
    assert out.num_rows == 1
    assert int(out.column("lv").values[0]) == 20
    assert int(out.column("rv").values[0]) == 2


def test_join_uint64_within_int63_range():
    left = _num_batches({"k": np.array([3, 9], dtype=np.uint64)})
    right = _num_batches(
        {"k": np.array([9, 4], dtype=np.int64),
         "rv": np.array([7, 8], dtype=np.int64)}
    )
    out = _both_join(left, right, ["k"], "inner")
    assert out.num_rows == 1 and int(out.column("rv").values[0]) == 7


def test_join_uint64_exact_object_fallback():
    """u64 past 2^63 against negative i64 keys: neither int64 nor uint64
    holds both sides, so the keys compare as exact Python ints."""
    left = _num_batches({"k": np.array([-3, 7, 11], dtype=np.int64)})
    right = _num_batches(
        {"k": np.array([2**63 + 5, 7, 7], dtype=np.uint64),
         "rv": np.array([1, 2, 3], dtype=np.int64)}
    )
    out = _both_join(left, right, ["k"], "left_outer")
    assert out.num_rows == 4
    assert out.column("rv").validity.tolist() == [False, True, True, False]


def test_join_nan_keys_never_match():
    """SQL float equality: NaN != NaN; np.unique would collapse them."""
    nan = float("nan")
    left = _num_batches(
        {"k": np.array([nan, 1.5], dtype=np.float64),
         "lv": np.array([1, 2], dtype=np.int64)}
    )
    right = _num_batches(
        {"k": np.array([nan, 1.5], dtype=np.float64),
         "rv": np.array([10, 20], dtype=np.int64)}
    )
    out = _both_join(left, right, ["k"], "inner")
    assert out.num_rows == 1
    assert int(out.column("lv").values[0]) == 2
    # left_outer: the NaN row survives with a null right side
    out2 = _both_join(left, right, ["k"], "left_outer")
    assert out2.num_rows == 2
    assert list(out2.column("rv").validity) == [False, True]


def test_join_mixed_int_float_exactness_guard():
    big = 2**53 + 1
    left = _num_batches({"k": np.array([big, 3], dtype=np.int64)})
    right = _num_batches({"k": np.array([3.0], dtype=np.float64),
                          "rv": np.array([5], dtype=np.int64)})
    with pytest.raises(PEvalError):
        PJ.join_batches(left[1], right[1], ["k"], "inner", device="cpu")
    # representable ints compare exactly through float64
    left2 = _num_batches({"k": np.array([4, 3], dtype=np.int64)})
    out = _both_join(left2, right, ["k"], "inner")
    assert out.num_rows == 1 and int(out.column("rv").values[0]) == 5


def test_join_zero_row_right_left_outer():
    """A non-None 0-row right through the library entry point: right
    columns come back all-null."""
    left = _num_batches(
        {"k": np.array([1, 2], dtype=np.int64),
         "lv": np.array([10, 20], dtype=np.int64)}
    )
    right = _num_batches(
        {"k": np.array([], dtype=np.int64), "rv": np.array([], dtype=np.int64)}
    )
    out = _both_join(left, right, ["k"], "left_outer")
    assert out.num_rows == 2
    assert not out.column("rv").validity.any()
    assert _both_join(left, right, ["k"], "inner") is None


def test_join_batches_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left = _num_batches({"k": np.array([1], dtype=np.int64)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PJ.join_batches(left[1], left[1], ["k"], "inner")


# ---------------------------------------------------------------------------
# Dictionary keys: the LUT build


def test_dict_key_build_never_materializes_row_strings(dbs, monkeypatch):
    """dict⨝dict key building maps the dictionaries, never N rows of
    strings — _key_values must not run for dict keys."""
    _jdb, pdb = dbs

    def boom(col, n):
        raise AssertionError("per-row key materialization on dict path")

    monkeypatch.setattr(PJ, "_key_values", boom)
    eng = PEngine(pdb.table_provider(), POptions(compiled_serving=False))
    out = []
    eng.scan_table("facts").join(
        eng.scan_table("dims"), on=["job"], how="inner"
    ).aggregate([PE.Sum(PE.Col("value"))], [PE.Col("job")]).execute(out.append)
    assert out and out[0].num_rows > 0


def test_dict_key_lut_cache_reused(dbs):
    _jdb, pdb = dbs
    eng = PEngine(pdb.table_provider(), POptions(compiled_serving=False))
    PJ._DICT_JOIN_LUTS.clear()

    def run():
        out = []
        eng.scan_table("facts").join(
            eng.scan_table("dims"), on=["job"], how="inner"
        ).aggregate([PE.Sum(PE.Col("value"))], [PE.Col("job")]).execute(
            out.append
        )
        return rows(out)

    first = run()
    n_entries = len(PJ._DICT_JOIN_LUTS)
    assert n_entries >= 1
    assert run() == first
    # same dictionaries -> same version key, no new entries
    assert len(PJ._DICT_JOIN_LUTS) == n_entries


# ---------------------------------------------------------------------------
# join_expand against the reference's K.join_expand


def _expand_inputs(seed, n_l, n_r, num_codes, null_p, live_n):
    rng = np.random.default_rng(seed)
    lc = rng.integers(0, num_codes, n_l).astype(np.int64)
    lkv = rng.random(n_l) > null_p
    llive = np.arange(n_l) < live_n  # padding rows past live_n
    # few distinct build keys -> duplicate build rows per code
    rc = rng.integers(0, max(num_codes // 2, 1), n_r).astype(np.int64)
    rkv = rng.random(n_r) > null_p
    return lc, lkv, llive, rc, rkv


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize(
    "seed,n_l,n_r,num_codes,null_p,live_n",
    [
        (0, 64, 32, 16, 0.1, 60),
        (1, 200, 7, 8, 0.3, 200),
        (2, 1, 1, 1, 0.0, 1),
        (3, 128, 300, 64, 0.0, 100),
        (4, 50, 1, 4, 1.0, 50),  # every key null: an empty right side
    ],
)
def test_join_expand_matches_jax(seed, n_l, n_r, num_codes, null_p, live_n, left_outer):
    lc, lkv, llive, rc, rkv = _expand_inputs(seed, n_l, n_r, num_codes, null_p, live_n)
    counts = np.bincount(rc[rkv], minlength=num_codes)
    mc = np.where(lkv & llive, counts[lc], 0)
    total = int(np.where(llive, np.maximum(mc, 1), 0).sum()) if left_outer else int(mc.sum())
    cap = total + 5  # slots past total are checked too
    ref = JK.join_expand(lc, lkv, llive, rc, rkv, num_codes, cap, left_outer)
    out = PK.join_expand(
        *(torch.as_tensor(a) for a in (lc, lkv, llive, rc, rkv)),
        num_codes, cap, left_outer,
    )
    assert int(out[0]) == int(ref[0]) == total
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert out[1].dtype == out[2].dtype == torch.int32


@pytest.mark.parametrize(
    "how,n_r", [("inner", 9), ("left_outer", 9), ("left_outer", 0)]
)
def test_local_join_pairs_match_jax(how, n_r):
    """The one-copy pair fetch, an empty right side included (the port
    sizes the expansion to ``total``; the reference pads to powers of
    two)."""
    lc, lkv, _live, rc, rkv = _expand_inputs(7, 40, max(n_r, 1), 6, 0.2, 40)
    rc, rkv = rc[:n_r], rkv[:n_r]
    counts = np.bincount(rc[rkv], minlength=6)
    mc = np.where(lkv, counts[lc], 0)
    total = int(np.maximum(mc, 1).sum()) if how == "left_outer" else int(mc.sum())
    assert total > 0
    ref = JJ.local_join_pairs(lc, lkv, rc, rkv, 6, total, how)
    out = PJ.local_join_pairs(lc, lkv, rc, rkv, 6, total, how, "cpu")
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
