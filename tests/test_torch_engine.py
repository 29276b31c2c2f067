"""The port as a whole against the JAX package: the same tables and queries
go through both engines, and the full ``(name, py_value)`` row tuples must
be identical — same rows, group emission order, dtypes, nulls and exact
float sums.

Tables are built with the JAX package (the generators of
tests/test_differential_fuzz.py and directed builders below) and carried
across with ``frostdb_tpu_torch.interop.table_from_numpy``, so dictionary
codes, part boundaries and scan order are the same on both sides. Queries
are built once with the JAX expression classes and converted.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_differential_fuzz as FZ
from frostdb_tpu.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.table import TableConfig as JTableConfig

import frostdb_tpu_torch as P
from frostdb_tpu_torch.interop import table_from_numpy
from frostdb_tpu_torch.ops import agg_kernels as AK
from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.schema import SchemaDef as PSchemaDef


def to_port(e):
    """A JAX-package expression tree rebuilt from the port's classes."""
    if isinstance(e, (list, tuple)):
        return type(e)(to_port(x) for x in e)
    if not isinstance(e, JE.Expr):
        return e
    out = object.__new__(getattr(PE, type(e).__name__))
    out.__dict__.update({k: to_port(v) for k, v in e.__dict__.items()})
    return out


def carry(jdb, names=("t",)):
    """The JAX db's tables rebuilt in a port db on the CPU."""
    pdb = P.ColumnStore(device="cpu").db("port")
    tx = jdb.high_watermark()
    for name in names:
        jt = jdb.get_table(name)
        parts = [
            {c.name: (c.kind, c.values, c.validity) for c in p.batch.columns}
            for p in jt.collect_parts(tx)
        ]
        dicts = {fam: list(d.values) for fam, d in jt.dictionaries.items()}
        schema = PSchemaDef.from_dict(jt.config.schema.to_dict())
        table_from_numpy(pdb, name, schema, dicts, parts)
    return pdb


def run_jax(jdb, make_q, compiled=False):
    eng = JEngine(jdb.table_provider(), exec_options=JOptions(compiled_serving=compiled))
    out = []
    make_q(eng, JE).execute(out.append)
    return FZ.rows(out), eng.last_serving_path


def run_port(pdb, make_q, compiled=True):
    eng = PEngine(pdb.table_provider(), exec_options=POptions(compiled_serving=compiled))
    out = []
    make_q(eng, PE).execute(out.append)
    return FZ.rows(out), eng.last_serving_path, eng.last_fallback_reasons


def agg_query(table, filt, aggs, groups):
    def make_q(eng, E):
        cv = (lambda x: x) if E is JE else to_port
        q = eng.scan_table(table)
        if filt is not None:
            q = q.filter(cv(filt))
        return q.aggregate(cv(aggs), cv(groups))

    return make_q


# ---------------------------------------------------------------------------
# The aggregate sweep of tests/test_differential_fuzz.py


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_aggregates_match_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    _store, jdb = FZ.build_db(rng)
    pdb = carry(jdb)
    for _q in range(3):
        make_q = agg_query(
            "t",
            FZ.random_filter(rng, 10**5),
            FZ.random_aggs(rng),
            FZ.random_groups(rng),
        )
        ref, _ = run_jax(jdb, make_q)
        fast, path, reasons = run_port(pdb, make_q, compiled=True)
        assert fast == ref, (seed, path, reasons)
        generic, gpath, _ = run_port(pdb, make_q, compiled=False)
        assert gpath == "generic"
        assert generic == ref, seed


# ---------------------------------------------------------------------------
# Directed shapes: each forces one kernel path of the compiled tier


def _directed_db():
    """Two tables of the fuzz schema: ``t`` with small values and ``tn``
    with nanosecond-scale values (a wide, two-plane column)."""
    rng = np.random.default_rng(42)
    store = JColumnStore()
    jdb = store.db("directed")
    for name, vbase, vspan in (("t", 0, 10_000), ("tn", 1_700_000_000 * 10**9, 2**40)):
        t = jdb.table(name, JTableConfig(schema=FZ._schema()))
        dg, dh = t.dictionary("g"), t.dictionary("h")
        for _part in range(3):
            n = 3000
            gc, gv = dg.encode([f"g{int(i)}" for i in rng.integers(0, 40, n)])
            hc, hv = dh.encode([f"h{int(i)}" for i in rng.integers(0, 3, n)])
            v = vbase + rng.integers(0, vspan, n, dtype=np.int64)
            # null slots hold 0 and bound the value span, so the wide
            # table has none
            vv = rng.random(n) > (0.1 if vbase == 0 else 0.0)
            t.insert_record(
                ColumnBatch(
                    [
                        Column("g", KIND_DICT, gc, gv, dg),
                        Column("h", KIND_DICT, hc, hv, dh),
                        Column("ts", KIND_INT64, rng.integers(0, 1000, n).astype(np.int64), np.ones(n, bool)),
                        Column("v", KIND_INT64, np.where(vv, v, 0), vv),
                    ],
                    n,
                )
            )
        t.sync()
    return jdb


@pytest.fixture(scope="module")
def directed():
    jdb = _directed_db()
    return jdb, carry(jdb, names=("t", "tn"))


_DIRECTED = {
    "band_1": (
        "t", lambda E: E.Col("ts").gt_eq(500),
        lambda E: [E.Sum(E.Col("v")), E.Count(E.Col("v"))],
        {"fused_band_group_sum_count"},
    ),
    "band_3_dict_eq": (
        "t",
        lambda E: E.And(
            E.And(E.Col("ts").gt_eq(100), E.Col("ts").lt(800)),
            E.Col("h").eq("h1"),
        ),
        lambda E: [E.Sum(E.Col("v"))],
        {"fused_band_group_sum_count"},
    ),
    "int_eq": (
        "t", lambda E: E.Col("ts").eq(77),
        lambda E: [E.Sum(E.Col("v")), E.Count(E.Col("v"))],
        {"fused_cmp_group_sum_count"},
    ),
    "int_not_eq": (
        "t", lambda E: E.Col("ts").not_eq(77),
        lambda E: [E.Sum(E.Col("v"))],
        {"fused_cmp_group_sum_count"},
    ),
    "or": (
        "t", lambda E: E.Or(E.Col("ts").lt(100), E.Col("ts").gt(900)),
        lambda E: [E.Sum(E.Col("v")), E.Count(E.Col("v"))],
        {"group_sum_count"},
    ),
    "min_max": (
        "t", lambda E: E.Col("ts").gt_eq(300),
        lambda E: [E.Min(E.Col("v")), E.Max(E.Col("v"))],
        {"group_sum_count", "group_min_max"},
    ),
    "wide_max_ns": (
        "tn", None, lambda E: [E.Max(E.Col("v")), E.Sum(E.Col("v"))],
        {"group_sum_count", "group_min_max"},
    ),
}


@pytest.mark.parametrize("case", sorted(_DIRECTED))
def test_directed_kernel_paths(directed, monkeypatch, case):
    jdb, pdb = directed
    table, filt, aggs, kernels = _DIRECTED[case]
    called = []
    for name in AK.LAUNCHES:
        fn = getattr(AK, name)
        monkeypatch.setattr(
            AK, name,
            lambda *a, _fn=fn, _name=name, **k: called.append(_name) or _fn(*a, **k),
        )

    def make_q(eng, E):
        q = eng.scan_table(table)
        if filt is not None:
            q = q.filter(filt(E))
        return q.aggregate(aggs(E), [E.Col("g")])

    ref, jpath = run_jax(jdb, make_q, compiled=True)
    assert jpath == "compiled"
    fast, path, reasons = run_port(pdb, make_q, compiled=True)
    assert path == "compiled", reasons
    assert set(called) == kernels
    if case == "wide_max_ns":
        assert called.count("group_min_max") == 3  # hi plane + two lo passes
    assert fast == ref
    assert len(ref) > 0
    generic, _gpath, _ = run_port(pdb, make_q, compiled=False)
    assert generic == ref


def _pairwise(v):
    v = np.array(v, dtype=np.float64)
    s = 1
    with np.errstate(invalid="ignore"):  # inf + -inf is NaN on both sides
        while s < len(v):
            v[0 : len(v) - s : 2 * s] += v[s :: 2 * s]
            s *= 2
    return (v[0] if len(v) else 0.0) + 0.0


@pytest.mark.parametrize("seed", range(3))
def test_ordered_segment_sum_is_a_pairwise_sum_per_segment(seed):
    """The generic DAG's float sum on the GPU: each contiguous segment's
    values summed by a binary tree rooted at the segment's first row, so
    the result depends on the segment's values alone, not on where the
    segment lies or on any scheduling."""
    from frostdb_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    num_segments = 40
    lengths = rng.integers(0, 300, num_segments)
    lengths[rng.integers(0, num_segments, 5)] = 0  # empty segments
    seg = np.repeat(np.arange(num_segments), lengths)
    vals = FZ.FLOAT_EDGE[rng.integers(0, len(FZ.FLOAT_EDGE), len(seg))]
    vals = np.where(rng.random(len(seg)) < 0.5, vals, rng.normal(size=len(seg)) * 1e6)
    out = K.ordered_segment_sum(
        torch.from_numpy(vals), torch.from_numpy(seg), num_segments
    ).numpy()
    starts = np.concatenate([[0], np.cumsum(lengths)])
    ref = np.array(
        [_pairwise(vals[starts[i] : starts[i + 1]]) for i in range(num_segments)]
    )
    np.testing.assert_array_equal(out.view(np.int64)[~np.isnan(ref)], ref.view(np.int64)[~np.isnan(ref)])
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))


def test_ordered_segment_sum_signed_zeros_and_empty_segments():
    from frostdb_tpu_torch.ops import kernels as K

    vals = torch.tensor([-0.0, -0.0, 1.5, -1.5, 2.0])
    seg = torch.tensor([0, 0, 2, 2, 3])
    out = K.ordered_segment_sum(vals.double(), seg, 5)
    assert out.tolist() == [0.0, 0.0, 0.0, 2.0, 0.0]
    assert not torch.signbit(out).any()  # -0.0 + -0.0 from 0 is +0.0


def test_unported_tiers_fall_back_exactly(directed):
    """A shape the compiled tier declines (a null-key-free distinct) is
    served by the generic DAG with every unported tier recorded."""
    jdb, pdb = directed

    def make_q(eng, E):
        return eng.scan_table("t").distinct(E.Col("h"))

    ref, _ = run_jax(jdb, make_q)
    out, path, reasons = run_port(pdb, make_q)
    assert out == ref
    assert path == "generic"
    assert reasons["dense"] == "not ported"
    assert "compiled" in reasons


# ---------------------------------------------------------------------------
# The device rule and the parts not ported yet


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ColumnStore()
    store = P.ColumnStore(device="cpu")
    assert store.db("d").device == torch.device("cpu")


def test_port_imports_without_jax_pyarrow_or_triton():
    """Every module of the port imports in a process where jax, pyarrow,
    triton and the JAX package cannot be imported."""
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyarrow", "triton", "frostdb_tpu"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import frostdb_tpu_torch
for m in pkgutil.walk_packages(frostdb_tpu_torch.__path__, "frostdb_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
"""
    repo = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)


@pytest.mark.parametrize(
    "kwargs",
    [{"storage_path": "unused"}, {"enable_wal": True}, {"sinks": [object()]}],
)
def test_persistence_is_refused(kwargs):
    with pytest.raises(NotImplementedError, match="later slice"):
        P.ColumnStore(device="cpu", **kwargs)
