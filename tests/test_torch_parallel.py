"""The port's distributed modules (frostdb_tpu_torch/parallel/: mesh,
collectives, distributed, shuffle, join) against the JAX package's on
conftest's 8 virtual CPU devices: the same seeded numpy inputs go through
both packages, an 8-device JAX mesh and an 8-shard CPU mesh of the port,
and every output must be equal slot for slot — partition layouts, dense
partials, exchanged rows, join expansions — with the same dtypes. Every
case of tests/test_parallel.py and tests/test_shuffle.py is here, overflow,
salt escalation and the duplicate-key join modes included. Tolerance:
exact everywhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frostdb_tpu import columnbatch as JCB
from frostdb_tpu.ops import kernels as JK
from frostdb_tpu.parallel import distributed as JD
from frostdb_tpu.parallel import join as JJ
from frostdb_tpu.parallel import mesh as JM
from frostdb_tpu.parallel import shuffle as JS

from frostdb_tpu_torch import columnbatch as PCB
from frostdb_tpu_torch.ops import kernels as PK
from frostdb_tpu_torch.parallel import collectives as PC
from frostdb_tpu_torch.parallel import distributed as PD
from frostdb_tpu_torch.parallel import join as PJ
from frostdb_tpu_torch.parallel import mesh as PM
from frostdb_tpu_torch.parallel import shuffle as PS

N_DEV = 8


def _batches(cols, n):
    """(JAX batch, port batch) of the same columns: (name, kind, values,
    validity, dictionary strings or None)."""
    out = []
    for cb in (JCB, PCB):
        built = []
        for name, kind, vals, valid, dvals in cols:
            d = None
            if dvals is not None:
                d = cb.Dictionary()
                for s in dvals:
                    d.code(s)
            built.append(cb.Column(name, kind, vals.copy(), valid.copy(), d))
        out.append(cb.ColumnBatch(built, n))
    return out


def _tables(cols, n, hash_key=None):
    jb, pb = _batches(cols, n)
    return (
        JM.PartitionedTable.from_batch(jb, JM.make_mesh(), hash_key=hash_key),
        PM.PartitionedTable.from_batch(
            pb, PM.make_mesh(N_DEV, device="cpu"), hash_key=hash_key
        ),
    )


def same(ref, got):
    """Equal slot for slot, with the same dtype and shape."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


def same_tables(jt, pt):
    assert (pt.n_rows, pt.n_pad, pt.n_shards) == (jt.n_rows, jt.n_pad, jt.n_shards)
    assert list(pt.columns) == list(jt.columns)
    for name, jc in jt.columns.items():
        pc = pt.column(name)
        assert pc.kind == jc.kind
        same(jc.data, pc.data)
        same(jc.validity, pc.validity)


def _group_cols(n=5000, n_groups=17, seed=0):
    """test_parallel.py _batch: a dict group column, value and timestamp."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_groups, n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    ts = rng.integers(0, 100, n).astype(np.int64)
    ones = np.ones(n, dtype=bool)
    names = [f"group_{i}" for i in range(n_groups)]
    return [
        ("labels.g", JCB.KIND_DICT, codes, ones, names),
        ("value", JCB.KIND_INT64, vals, ones, None),
        ("timestamp", JCB.KIND_INT64, ts, ones, None),
    ]


def _key_cols(n=5000, n_keys=40, seed=5, skew_key=None):
    """test_shuffle.py _table: a dict key column and a value column."""
    rng = np.random.default_rng(seed)
    if skew_key is None:
        codes = rng.integers(0, n_keys, n).astype(np.int32)
    else:
        codes = np.full(n, skew_key, dtype=np.int32)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    ones = np.ones(n, dtype=bool)
    return [
        ("key", JCB.KIND_DICT, codes, ones, [f"k{i}" for i in range(n_keys)]),
        ("v", JCB.KIND_INT64, vals, ones, None),
    ]


# ---------------------------------------------------------------------------
# mesh.py: meshes, hash mixes, partitioned layouts


def test_devices_available():
    assert len(jax.devices()) == N_DEV
    mesh = PM.make_mesh(N_DEV, device="cpu")
    assert mesh.shape == JM.make_mesh().shape == {"shards": N_DEV}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    # a mesh is a value: equal meshes are one cache key
    assert PM.make_mesh(N_DEV, device="cpu") == mesh


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_mixes_bit_for_bit(seed):
    """The numpy mix, the JAX device mix and the port's int64-emulated
    device mix agree bit for bit, on int64 extremes and negatives too."""
    rng = np.random.default_rng(seed)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4000, dtype=np.int64)
    x = np.concatenate([x, np.array([0, 1, -1, 2**62, -(2**63), 2**63 - 1], np.int64)])
    ref = JM._hash_int64(x)
    same(ref, PM._hash_int64(x))
    same(np.asarray(JM.hash_int64_device(jnp.asarray(x))), ref)
    same(ref, PM.hash_int64_device(torch.from_numpy(x)).numpy())
    assert (ref >= 0).all()


@pytest.mark.parametrize("n", [1, 1234, 5000, 9000])
@pytest.mark.parametrize("hash_key", [None, "labels.g"])
def test_partitioned_table_layouts(n, hash_key):
    """Round-robin and hash-partitioned layouts, slot for slot: padding,
    per-shard tiles, the rows each shard holds and their order."""
    jt, pt = _tables(_group_cols(n=n, seed=n), n, hash_key=hash_key)
    same_tables(jt, pt)
    assert pt.n_pad % (N_DEV * 1024) == 0
    assert pt.column("value").data.shape == (pt.n_pad,)


def test_scaling_partition_shapes():
    jt, pt = _tables(_group_cols(n=1234), 1234)
    assert pt.n_pad % 8 == 0
    sc = pt.column("value")
    assert sc.data.shape[0] == pt.n_pad
    assert len(sc.data) == N_DEV
    assert all(t.shape[0] == pt.n_pad // N_DEV for t in sc.data)
    same_tables(jt, pt)


# ---------------------------------------------------------------------------
# collectives.py


def test_collectives_semantics():
    rng = np.random.default_rng(3)
    x = rng.integers(-(2**62), 2**62, (4, 6, 5), dtype=np.int64)
    xs = [torch.from_numpy(a) for a in x]
    for fn, ref in ((PC.psum, x.sum(0)), (PC.pmin, x.min(0)), (PC.pmax, x.max(0))):
        outs = fn(xs)
        assert len(outs) == 4
        for o in outs:
            same(ref, o.numpy())
    # non-tiled all_to_all: block s of output d is block d of input s
    blocks = rng.integers(0, 100, (4, 4, 3), dtype=np.int64)
    outs = PC.all_to_all([torch.from_numpy(b) for b in blocks])
    for d, o in enumerate(outs):
        same(blocks[:, d], o.numpy())
    outs = PC.all_gather([torch.from_numpy(b) for b in blocks])
    for o in outs:
        same(blocks.reshape(16, 3), o.numpy())
    assert list(PC.axis_index(4)) == [0, 1, 2, 3]


def test_psum_wraps_like_xla():
    big = np.array([2**63 - 1, -(2**63)], np.int64)
    outs = PC.psum([torch.from_numpy(big), torch.from_numpy(big)])
    same(big + big, outs[0].numpy())


# ---------------------------------------------------------------------------
# ops/kernels.compare_scalar_mask, distributed.py


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
def test_compare_scalar_mask_matches_reference(op):
    rng = np.random.default_rng(4)
    v = rng.integers(0, 10, 500).astype(np.int64)
    valid = rng.random(500) > 0.2
    ref = JK.compare_scalar_mask(jnp.asarray(v), jnp.asarray(valid), 5, op)
    got = PK.compare_scalar_mask(torch.from_numpy(v), torch.from_numpy(valid), 5, op)
    same(np.asarray(ref), got.numpy())
    with pytest.raises(ValueError):
        PK.compare_scalar_mask(torch.from_numpy(v), torch.from_numpy(valid), 5, "~")


def test_combine_codes_matches_reference():
    rng = np.random.default_rng(6)
    a, b, c = (rng.integers(0, k, 300).astype(np.int32) for k in (3, 7, 11))
    jcode, jk = JD.combine_codes([(jnp.asarray(a), 3), (jnp.asarray(b), 7), (jnp.asarray(c), 11)])
    pcode, pk = PD.combine_codes(
        [(torch.from_numpy(a), 3), (torch.from_numpy(b), 7), (torch.from_numpy(c), 11)]
    )
    assert pk == jk == 231
    same(np.asarray(jcode), pcode.numpy())


_AGG_SPECS = [("sum", "value"), ("count", "value"), ("min", "value"), ("max", "value")]


@pytest.mark.parametrize(
    "filter_op,literal", [(">=", 50), ("<", 30), ("==", 7), ("!=", 7)]
)
def test_distributed_filter_aggregate_matches_reference(filter_op, literal):
    """test_parallel.py test_distributed_filter_aggregate_matches_numpy:
    every partial and the group counts equal the JAX package's, and numpy."""
    cols = _group_cols()
    jt, pt = _tables(cols, 5000)
    kw = dict(filter_col="timestamp", filter_op=filter_op, filter_literal=literal)
    (jouts, jcounts) = JD.distributed_filter_aggregate(jt, "labels.g", 17, _AGG_SPECS, **kw)()
    (pouts, pcounts) = PD.distributed_filter_aggregate(pt, "labels.g", 17, _AGG_SPECS, **kw)()
    for j, p in zip(jouts, pouts):
        same(np.asarray(j), p.numpy())
    same(np.asarray(jcounts), pcounts.numpy())
    codes, vals, ts = cols[0][2], cols[1][2], cols[2][2]
    sel = {"<": ts < literal, ">=": ts >= literal, "==": ts == literal, "!=": ts != literal}[filter_op]
    for g in range(17):
        m = sel & (codes == g)
        assert int(pouts[0][g]) == int(vals[m].sum())
        assert int(pcounts[g]) == int(m.sum())


def test_distributed_agg_hash_partitioned():
    """Hash-partitioned load: same results, keys co-located."""
    cols = _group_cols(seed=3)
    jt, pt = _tables(cols, 5000, hash_key="labels.g")
    (jsums,), jcounts = JD.distributed_filter_aggregate(jt, "labels.g", 17, [("sum", "value")])()
    (psums,), pcounts = PD.distributed_filter_aggregate(pt, "labels.g", 17, [("sum", "value")])()
    same(np.asarray(jsums), psums.numpy())
    same(np.asarray(jcounts), pcounts.numpy())
    codes, vals = cols[0][2], cols[1][2]
    for g in range(17):
        assert int(psums[g]) == int(vals[codes == g].sum())


def test_distributed_distinct():
    cols = _group_cols(n=2000, n_groups=9, seed=1)
    jt, pt = _tables(cols, 2000)
    present = PD.distributed_distinct(pt, "labels.g", 12)
    same(np.asarray(JD.distributed_distinct(jt, "labels.g", 12)), present.numpy())
    expected = np.zeros(12, dtype=bool)
    expected[np.unique(cols[0][2])] = True
    same(expected, present.numpy())


# ---------------------------------------------------------------------------
# join.py


def _join_sides(n_keys=40, nl=3000, seed=7, present=30):
    rng = np.random.default_rng(seed)
    names = [f"k{i}" for i in range(n_keys)]
    l_codes = rng.integers(0, n_keys, nl).astype(np.int32)
    ones_l = np.ones(nl, dtype=bool)
    left = [
        ("key", JCB.KIND_DICT, l_codes, ones_l, names),
        ("lval", JCB.KIND_INT64, rng.integers(0, 100, nl).astype(np.int64), ones_l, None),
    ]
    keys = np.arange(0, present, dtype=np.int32)
    rv = keys.astype(np.int64) * 10 + 5
    rvalid = rng.random(present) > 0.1  # some null build values
    right = [
        ("key", JCB.KIND_DICT, keys, np.ones(present, bool), names),
        ("rval", JCB.KIND_INT64, np.where(rvalid, rv, 0), rvalid, None),
    ]
    return left, nl, right, present


@pytest.mark.parametrize("broadcast", [False, True])
def test_distributed_hash_join(broadcast):
    """test_parallel.py test_distributed_hash_join (co-partitioned sides)
    and its broadcast regime (round-robin sides, the build side
    all-gathered): mask and values equal the JAX package's slot for slot."""
    left, nl, right, nr = _join_sides()
    hk = None if broadcast else "key"
    jl, pl = _tables(left, nl, hash_key=hk)
    jr, pr = _tables(right, nr, hash_key=hk)
    jm, (jrv,) = JJ.distributed_hash_join(jl, jr, "key", 40, ["rval"], broadcast_right=broadcast)()
    pm, (prv,) = PJ.distributed_hash_join(pl, pr, "key", 40, ["rval"], broadcast_right=broadcast)()
    same(jm, pm)
    same(jrv, prv)
    lk = np.asarray(pl.column("key").data)
    lvalid = np.asarray(pl.column("key").validity)
    matched = np.asarray(pm)
    if not broadcast:  # co-located: every present key matches
        rvalid = right[1][3]
        want = lvalid & (lk < 30) & rvalid[np.clip(lk, 0, 29)]
        same(want, matched)


def _dup_sides():
    """test_parallel.py's duplicate-key build side: keys 0..11 with 1..4
    rows each; 12..15 absent."""
    rng = np.random.default_rng(11)
    names = [f"k{i}" for i in range(16)]
    nl = 600
    l_codes = rng.integers(0, 16, nl).astype(np.int32)
    ones_l = np.ones(nl, dtype=bool)
    left = [
        ("key", JCB.KIND_DICT, l_codes, ones_l, names),
        ("lval", JCB.KIND_INT64, np.arange(nl, dtype=np.int64), ones_l, None),
    ]
    r_codes, r_vals = [], []
    for k in range(12):
        for j in range(1 + k % 4):
            r_codes.append(k)
            r_vals.append(k * 100 + j)
    r_codes = np.asarray(r_codes, dtype=np.int32)
    nr = len(r_codes)
    ones_r = np.ones(nr, dtype=bool)
    right = [
        ("key", JCB.KIND_DICT, r_codes, ones_r, names),
        ("rval", JCB.KIND_INT64, np.asarray(r_vals, dtype=np.int64), ones_r, None),
    ]
    return left, nl, right, nr


@pytest.mark.parametrize("mode", ["inner", "left_outer"])
@pytest.mark.parametrize("initial_capacity", [64, None])
def test_distributed_join_duplicate_keys_expand(mode, initial_capacity):
    """test_parallel.py test_distributed_join_duplicate_keys_inner_outer_semi_anti
    (inner, left_outer): the capacity the escalation ends at, the totals and
    every output slot equal the JAX package's; the pair multiset equals a
    numpy join."""
    left, nl, right, nr = _dup_sides()
    jl, pl = _tables(left, nl, hash_key="key")
    jr, pr = _tables(right, nr, hash_key="key")
    kw = dict(mode=mode, initial_capacity=initial_capacity)
    jt, jli, jrv, jrvs, jcap = JJ.distributed_join_auto(jl, jr, "key", 16, ["rval"], **kw)
    pt, pli, prv, prvs, pcap = PJ.distributed_join_auto(pl, pr, "key", 16, ["rval"], **kw)
    assert pcap == jcap
    same(jt, pt)
    same(jli, pli)
    same(jrv, prv)
    for j, p in zip(jrvs, prvs):
        same(j, p)
    if initial_capacity == 64:
        assert pcap > 64  # the escalation ran

    l_codes, l_vals = left[0][2], left[1][2]
    r_codes, r_vals = right[0][2], right[1][2]
    expect = sorted(
        (int(l_codes[i]), int(l_vals[i]), int(r_vals[j]))
        for i in range(nl)
        for j in range(nr)
        if l_codes[i] == r_codes[j]
    )
    if mode == "left_outer":
        hit = {e[1] for e in expect}
        expect += [(int(l_codes[i]), int(l_vals[i]), None) for i in range(nl) if int(l_vals[i]) not in hit]
    lk = np.asarray(pl.column("key").data)
    lv = np.asarray(pl.column("lval").data)
    lvalid = np.asarray(pl.column("key").validity)
    li, rvalid, rv = np.asarray(pli), np.asarray(prv), np.asarray(prvs[0])
    per_shard = len(lk) // N_DEV
    got = []
    for s in range(N_DEV):
        for o in range(int(pt[s])):
            g = s * pcap + o
            row = s * per_shard + int(li[g])
            if not lvalid[row]:
                continue  # padding rows emit one left_outer slot each
            got.append((int(lk[row]), int(lv[row]), int(rv[g]) if rvalid[g] else None))
    assert sorted(got, key=str) == sorted(expect, key=str)


@pytest.mark.parametrize("mode", ["semi", "anti"])
def test_distributed_join_semi_anti(mode):
    left, nl, right, nr = _dup_sides()
    jl, pl = _tables(left, nl, hash_key="key")
    jr, pr = _tables(right, nr, hash_key="key")
    pmask = PJ.distributed_join_auto(pl, pr, "key", 16, [], mode=mode)
    same(JJ.distributed_join_auto(jl, jr, "key", 16, [], mode=mode), pmask)
    lk = np.asarray(pl.column("key").data)
    lvalid = np.asarray(pl.column("key").validity)
    has = lk < 12
    same(lvalid & (has if mode == "semi" else ~has), np.asarray(pmask))


def test_join_multi_rejects_unknown_mode():
    left, nl, right, nr = _dup_sides()
    _jl, pl = _tables(left, nl, hash_key="key")
    _jr, pr = _tables(right, nr, hash_key="key")
    with pytest.raises(ValueError):
        PJ.distributed_hash_join_multi(pl, pr, "key", 16, [], 8, mode="outer")


# ---------------------------------------------------------------------------
# shuffle.py


def _shuffled_same(jt2, pt2):
    same_tables(jt2, pt2)
    assert pt2.n_pad == N_DEV * (pt2.n_pad // N_DEV)


def test_shuffle_preserves_rows_and_colocates():
    cols = _key_cols()
    jt, pt = _tables(cols, 5000)
    jt2, pt2 = JS.shuffle_by_key(jt, "key"), PS.shuffle_by_key(pt, "key")
    _shuffled_same(jt2, pt2)
    k = np.asarray(pt2.column("key").data)
    kv = np.asarray(pt2.column("key").validity)
    v = np.asarray(pt2.column("v").data)
    got = sorted(zip(k[kv].tolist(), v[kv].tolist()))
    assert got == sorted(zip(cols[0][2].tolist(), cols[1][2].tolist()))
    per_shard = pt2.n_pad // N_DEV
    for s in range(N_DEV):
        sl = slice(s * per_shard, (s + 1) * per_shard)
        ks = k[sl][kv[sl]]
        if len(ks):
            assert (PM._hash_int64(ks.astype(np.int64)) % N_DEV == s).all()


def test_shuffle_overflow_detected_and_retry():
    # every row has the same key -> one destination receives everything
    jt, pt = _tables(_key_cols(n=4000, skew_key=3), 4000)
    with pytest.raises(JS.ShuffleOverflow):
        JS.shuffle_by_key(jt, "key", oversub=2.0)
    with pytest.raises(PS.ShuffleOverflow, match=r"cap=256"):
        PS.shuffle_by_key(pt, "key", oversub=2.0)
    # a capacity covering the full skew succeeds
    jt2, pt2 = JS.shuffle_by_key(jt, "key", oversub=64.0), PS.shuffle_by_key(pt, "key", oversub=64.0)
    _shuffled_same(jt2, pt2)
    assert int(np.asarray(pt2.column("key").validity).sum()) == 4000


def test_skewed_shuffle_auto_salts():
    """A single heavy key overflows the plain exchange; the skew-aware
    entry salts instead, with the same salt and the same exchanged slots as
    the JAX package, and per-key partials still combine exactly."""
    cols = _key_cols(n=4000, skew_key=3)
    jt, pt = _tables(cols, 4000)
    (jt2, jsalt), (pt2, psalt) = JS.shuffle_by_key_auto(jt, "key"), PS.shuffle_by_key_auto(pt, "key")
    assert psalt == jsalt > 1
    _shuffled_same(jt2, pt2)
    k = np.asarray(pt2.column("key").data)
    kv = np.asarray(pt2.column("key").validity)
    v = np.asarray(pt2.column("v").data)
    assert int(kv.sum()) == 4000
    per_shard = pt2.n_pad // N_DEV
    shards_with_rows = sum(
        1 for s in range(N_DEV) if kv[s * per_shard : (s + 1) * per_shard].any()
    )
    assert shards_with_rows >= min(psalt, N_DEV)
    assert int(v[kv].sum()) == int(cols[1][2].sum())


def test_shuffle_auto_grows_capacity_when_fully_salted():
    """max_salt reached and still overflowing: one capacity doubling, then
    the overflow surfaces. Shard 0 sends 1024 rows of the one key: cap 256
    doubled to 512 still overflows; 512 doubled to 1024 holds them."""
    jt, pt = _tables(_key_cols(n=4000, skew_key=3), 4000)
    with pytest.raises(JS.ShuffleOverflow):
        JS.shuffle_by_key_auto(jt, "key", oversub=2.0, max_salt=1)
    with pytest.raises(PS.ShuffleOverflow, match=r"cap=512"):
        PS.shuffle_by_key_auto(pt, "key", oversub=2.0, max_salt=1)
    jt2, jsalt = JS.shuffle_by_key_auto(jt, "key", oversub=4.0, max_salt=1)
    pt2, psalt = PS.shuffle_by_key_auto(pt, "key", oversub=4.0, max_salt=1)
    assert psalt == jsalt == 1
    _shuffled_same(jt2, pt2)
    assert pt2.n_pad == N_DEV * N_DEV * 1024


def test_salted_shuffle_uniform_keys_unaffected():
    """Salting a uniform table still preserves all rows exactly."""
    cols = _key_cols(seed=21)
    jt, pt = _tables(cols, 5000)
    jt2 = JS.shuffle_by_key(jt, "key", oversub=4.0, salt=4)
    pt2 = PS.shuffle_by_key(pt, "key", oversub=4.0, salt=4)
    _shuffled_same(jt2, pt2)
    k = np.asarray(pt2.column("key").data)
    kv = np.asarray(pt2.column("key").validity)
    v = np.asarray(pt2.column("v").data)
    assert sorted(zip(k[kv].tolist(), v[kv].tolist())) == sorted(
        zip(cols[0][2].tolist(), cols[1][2].tolist())
    )


def test_shuffled_local_aggregate_matches():
    """After the shuffle each shard owns disjoint keys: local exact grouping
    needs no cross-shard combine."""
    cols = _key_cols(seed=11)
    jt, pt = _tables(cols, 5000, hash_key=None)
    jt2, pt2 = JS.shuffle_by_key(jt, "key", oversub=6.0), PS.shuffle_by_key(pt, "key", oversub=6.0)
    _shuffled_same(jt2, pt2)
    k = np.asarray(pt2.column("key").data)
    kv = np.asarray(pt2.column("key").validity)
    v = np.asarray(pt2.column("v").data)
    sums: dict = {}
    per_shard = pt2.n_pad // N_DEV
    for s in range(N_DEV):
        sl = slice(s * per_shard, (s + 1) * per_shard)
        ks, vs = k[sl][kv[sl]], v[sl][kv[sl]]
        for code in np.unique(ks):
            assert int(code) not in sums, "key appeared on two shards"
            sums[int(code)] = int(vs[ks == code].sum())
    codes_np, vals_np = cols[0][2], cols[1][2]
    for code in np.unique(codes_np):
        assert sums[int(code)] == int(vals_np[codes_np == code].sum())
