"""The port's mesh tier on the shuffle route (group code spaces past 2^20,
frostdb_tpu_torch/parallel/mesh_exec.py) against the JAX package's: the
mesh cases of tests/test_shuffle_agg.py and tests/test_float_minmax.py run
through both packages at the reference's shard counts and must give the
same rows in the same order, the same serving tier and the same decline
reasons (helpers in tests/test_torch_mesh.py). Spies on both packages'
``_shuffle_program`` hold the per-shard owner-table size ``k_per`` and the
pair buckets' capacity ``cap`` to the reference's, part by part and
attempt by attempt. Tolerance: exact everywhere.
"""

import numpy as np
import pytest

import test_float_minmax as TFM
import test_shuffle_agg as TSA
from frostdb_tpu.columnbatch import Column, ColumnBatch, KIND_INT64
from frostdb_tpu.db import ColumnStore
from frostdb_tpu.parallel import mesh_exec as JME
from frostdb_tpu.query import expr as E
from frostdb_tpu.table import TableConfig
from test_torch_mesh import _f_minmax, parity

from frostdb_tpu_torch.parallel import mesh_exec as PME

_MINMAX4 = [E.Sum(E.Col("v")), E.Count(E.Col("v")), E.Min(E.Col("v")), E.Max(E.Col("v"))]


def _by_k(aggs=_MINMAX4, filt=None):
    def make_q(e):
        q = e.scan_table("t")
        if filt is not None:
            q = q.filter(filt)
        return q.aggregate(aggs, [E.Col("k")])

    return make_q


@pytest.mark.parametrize("n_dev", [1, 8])
def test_mesh_tier_large_k_parity(n_dev):
    _s, jdb, _t = TSA._mk(seed=3)
    assert len(parity(jdb, _by_k(), (n_dev,))) > 10000


def _spy(monkeypatch, module, calls):
    orig = module.MeshFilterAggregate._shuffle_program

    def spy(self, sig, num_codes, k_per, cap):
        calls.append((num_codes, k_per, cap))
        return orig(self, sig, num_codes, k_per, cap)

    monkeypatch.setattr(module.MeshFilterAggregate, "_shuffle_program", spy)


def test_per_shard_memory_is_k_over_shards(monkeypatch):
    """The owner tables are [K / shards] per shard (k_per rounded up to
    128), and the pair buckets' capacity is the reference's, part by
    part."""
    jcalls, pcalls = [], []
    _spy(monkeypatch, JME, jcalls)
    _spy(monkeypatch, PME, pcalls)
    _s, jdb, _t = TSA._mk(seed=4)
    parity(jdb, _by_k(), (8,))
    assert pcalls == jcalls and len(pcalls) == 2
    num_codes, k_per, cap = pcalls[0]
    assert num_codes > 1 << 20
    assert k_per <= -(-num_codes // 8) + 128 and k_per % 128 == 0
    # 8000 rows: 1000 per shard, / 8 destinations, x 2, up to 128s
    assert cap == 256


def test_shuffle_tier_filter_and_floats():
    _s, jdb, _t = TSA._mk(seed=5, float_vals=True)
    make_q = _by_k([E.Sum(E.Col("v")), E.Count(E.Col("v"))], E.Col("k").gt_eq(1000))
    parity(jdb, make_q, (8,))


def test_overflow_escalation(monkeypatch):
    """Every key congruent mod 8: the first bucket capacity overflows, and
    the escalation retries with the same capacities as the reference's
    and ends exact, with pairs crossing shards."""
    schema = TSA.SchemaDef(
        "t",
        (
            TSA.ColumnDef("k", TSA.StorageLayout(TSA.TYPE_INT64)),
            TSA.ColumnDef("v", TSA.StorageLayout(TSA.TYPE_INT64, nullable=True)),
        ),
        (TSA.SortingColumnDef("k", "asc", True),),
    )
    store = ColumnStore()
    jdb = store.db("ov")
    t = jdb.table("t", TableConfig(schema=schema))
    rng = np.random.default_rng(7)
    n = 9000
    keys = (rng.integers(0, 400_000, n).astype(np.int64) * 8) % 3_000_000
    t.insert_record(
        ColumnBatch(
            [
                Column("k", KIND_INT64, keys, np.ones(n, bool)),
                Column("v", KIND_INT64, rng.integers(0, 10, n).astype(np.int64), np.ones(n, bool)),
            ],
            n,
        )
    )
    jcalls, pcalls = [], []
    _spy(monkeypatch, JME, jcalls)
    _spy(monkeypatch, PME, pcalls)
    for key in PME.EXCHANGE_STATS:
        PME.EXCHANGE_STATS[key] = 0
    parity(jdb, _by_k(), (8,))
    assert pcalls == jcalls
    assert len({c[2] for c in pcalls}) > 1  # the capacity grew
    assert PME.EXCHANGE_STATS["oversub"] > 2.0
    assert PME.EXCHANGE_STATS["pairs"] > 0



@pytest.mark.parametrize("n_dev", [1, 8])
def test_shuffle_tier_float_minmax(n_dev):
    _s, jdb = TFM._mk_large_k(seed=n_dev)
    parity(jdb, _f_minmax("k"), (n_dev,))
