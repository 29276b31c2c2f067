"""The port's compiled_distinct and schema_meta tiers (the Parca
Types/Values/Labels shapes) against the JAX package.

Tables are made by the table functions of tests/test_compiled_distinct.py and
tests/test_schema_meta.py and carried across with
``frostdb_tpu_torch.interop.table_from_numpy``; the queries are those
tests' own. Every case requires the same rows, row order, kinds and batch
boundaries as the JAX package's fast tier and generic DAG, and the same
serving path. ``test_sql_distinct_through_engine`` needs SQL, which is not
ported yet.
"""

import pytest

import test_compiled_distinct as CD
import test_schema_meta as SM
from test_torch_engine import carry
from test_torch_scan import check_parity, run_jax, run_port
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.query import expr as JE
from frostdb_tpu.schema import sample_definition
from frostdb_tpu.table import TableConfig as JTableConfig

from frostdb_tpu_torch.ops import agg_kernels as AK


def scan_q(q_fn):
    return lambda e: q_fn(e.scan_table("t"))


@pytest.fixture(scope="module")
def distinct_dbs():
    _s, jdb, _t = CD._mk()
    return jdb, carry(jdb)


def _record_kernels(monkeypatch):
    called = []
    for name in AK.LAUNCHES:
        fn = getattr(AK, name)
        monkeypatch.setattr(
            AK, name,
            lambda *a, _fn=fn, _name=name, **k: called.append(_name) or _fn(*a, **k),
        )
    return called


# Which sum/count kernel each distinct shape runs: K2 over the selection
# plane, K1 where the filter is a band of range compares.
_KERNELS = {
    "values": {"group_sum_count"},
    "types": {"group_sum_count"},
    "pair": {"group_sum_count"},
    "int-key": {"group_sum_count"},
    "filtered": {"fused_band_group_sum_count"},
    "or-filtered": {"group_sum_count"},
    "three-keys": {"group_sum_count"},
    "dict-compare-key": {"group_sum_count"},
}


@pytest.mark.parametrize("qname", sorted(CD.QUERIES))
def test_distinct_compiled_parity(distinct_dbs, monkeypatch, qname):
    jdb, pdb = distinct_dbs
    called = _record_kernels(monkeypatch)
    out = check_parity(jdb, pdb, scan_q(CD.QUERIES[qname]), "compiled_distinct")
    assert out and out[0]
    assert set(called) == _KERNELS[qname]
    assert len(called) == 1


def test_null_keys_fall_generic():
    _s, jdb, _t = CD._mk(with_nulls=True)
    pdb = carry(jdb)
    make_q = scan_q(CD.QUERIES["values"])
    ref, jpath = run_jax(jdb, make_q, compiled=True)
    out, path, reasons = run_port(pdb, make_q)
    assert jpath == path == "generic"
    assert reasons["compiled_distinct"] == "null group keys (generic engine path)"
    assert out == ref


def test_missing_dynamic_key_part_falls_generic():
    """A part lacking the distinct key column: the generic engine emits a
    null-key group, so the compiled tier declines."""
    _s, jdb, _t = CD._mk(drop_node_part=True)
    pdb = carry(jdb)
    make_q = scan_q(CD.QUERIES["values"])
    ref, jpath = run_jax(jdb, make_q, compiled=True)
    out, path, reasons = run_port(pdb, make_q)
    assert jpath == path == "generic"
    assert "part lacks" in reasons["compiled_distinct"]
    assert out == ref


def test_distinct_past_the_code_space_is_not_served_here():
    """A distinct key past the kernels' 2048 codes declines with the code
    space as its reason and is served, exactly, by the generic DAG."""
    _s, jdb, _t = CD._mk()
    pdb = carry(jdb)
    make_q = scan_q(lambda q: q.distinct(JE.Col("value")))
    ref, _ = run_jax(jdb, make_q, compiled=False)
    out, path, reasons = run_port(pdb, make_q)
    assert path == "generic"
    assert reasons["compiled_distinct"].startswith("group code space")
    assert out == ref


# ---------------------------------------------------------------------------
# tests/test_schema_meta.py through both packages


@pytest.fixture(scope="module")
def schema_dbs():
    _s, jdb = SM.build_db()
    return jdb, carry(jdb, names=("stacktraces",))


def schema_q(*filters_after, before=None, col="name"):
    def make_q(e):
        q = e.scan_schema("stacktraces")
        if before is not None:
            q = q.filter(before)
        q = q.distinct(JE.Col(col))
        for f in filters_after:
            q = q.filter(f)
        return q

    return make_q


_SCHEMA = {
    "labels": schema_q(JE.Col("name").regex_match(r"^labels\..+$")),
    "no-filter": schema_q(),
    "filter-below": schema_q(before=JE.Col("name").regex_match("^l")),
    "eq-value": schema_q(JE.Col("name").eq("value")),
    "regex-not": schema_q(JE.Col("name").regex_not_match("^labels")),
    "no-match": schema_q(JE.Col("name").regex_match("nomatch-anywhere")),
    "two-filters": schema_q(
        JE.Col("name").regex_match("^labels"), JE.Col("name").not_eq("labels.pod")
    ),
}


@pytest.mark.parametrize("qname", sorted(_SCHEMA))
def test_schema_meta_parity(schema_dbs, monkeypatch, qname):
    jdb, pdb = schema_dbs
    called = _record_kernels(monkeypatch)
    out = check_parity(jdb, pdb, _SCHEMA[qname], "schema_meta")
    assert called == []  # host work only
    if qname == "labels":
        names = [dict((n, v) for n, _k, v in r)["name"] for r in out[0]]
        assert "labels.node" in names and "labels.extra2" in names
        assert all(n.startswith("labels.") for n in names)


def test_schema_meta_empty_table():
    store = JColumnStore()
    jdb = store.db("t")
    jdb.table("stacktraces", JTableConfig(schema=sample_definition()))
    pdb = carry(jdb, names=("stacktraces",))
    out = check_parity(jdb, pdb, schema_q(), "schema_meta")
    assert out == []


def test_schema_non_name_distinct_falls_back(schema_dbs):
    jdb, pdb = schema_dbs
    make_q = schema_q(col="other")
    ref, jpath = run_jax(jdb, make_q, compiled=True)
    out, path, reasons = run_port(pdb, make_q)
    assert jpath == path == "generic"
    assert reasons["schema_meta"] == "schema distinct is not on the name column"
    assert out == ref
