"""The port's SQL front end (frostdb_tpu_torch/sqlparse.py) and logic-test
runner (frostdb_tpu_torch/logictest.py) against the JAX package's: the
same SQL gives the same query-API calls, and through the engine the same
rows in the same order on the same serving tier; datadriven scripts give
the same output text through both packages' ``run_file``. The one
difference, marked ``divergence``: the port applies a HAVING clause that
has no GROUP BY, which the JAX package drops.
"""

import importlib.util
import io
import contextlib
import pathlib

import numpy as np
import pytest

import test_compiled_distinct as TCD
import test_differential_fuzz as FZ
import test_sql_extended as TSE
import test_windowed_group as TWG
from frostdb_tpu import logictest as JLT
from frostdb_tpu.db import ColumnStore as JColumnStore
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from frostdb_tpu.sqlparse import Parser as JParser, SQLParseError as JSQLParseError
from test_sqlparse import _FakeBuilder as _ReferenceFakeBuilder
from test_torch_engine import carry

import frostdb_tpu_torch as P
from frostdb_tpu_torch import logictest as PLT
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions
from frostdb_tpu_torch.sqlparse import Parser as PParser, SQLParseError as PSQLParseError

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Parser: the query-API calls of tests/test_sqlparse.py, port against JAX

class _FakeBuilder(_ReferenceFakeBuilder):
    """tests/test_sqlparse.py's call recorder, plus ORDER BY."""

    def _add(self, entry):
        return _FakeBuilder(self.log + [entry])

    def order_by(self, *keys):
        return self._add(("order_by", list(keys)))


PARSE_CASES = [
    "select labels.label1, timestamp",
    "select value where (labels.l1 = 'a' and timestamp > 2) or value != null",
    "select sum(value) as value_sum, labels.label2 group by labels.label2",
    "select sum(value), (timestamp/1000)*1000 as bucket group by bucket",
    "select distinct(labels.l1, value > 0)",
    "select value where labels.l1 not regexp 'v.*'",
    "select value where stacktrace like 'ack'",
    "select labels, labels.l1",
    "select labels.l1 limit 4 # trailing comment",
    "explain select labels.l1",
    "select convert(value, float) * floatvalue",
    "select second(2), sum(value) group by second(2)",
    "select count(value), labels.node where labels.node in ('a', 'b') group by labels.node",
    "select value where labels.node not in ('a', 'b') and value >= 3",
    "select min(value), max(value), avg(value) group by (labels.a, labels.b)",
    "select sum(value) as total, labels.node group by labels.node having total > 5"
    " order by total desc, labels.node limit 3",
    "select value, timestamp where timestamp < 200 order by value desc, timestamp asc",
    "select true, false, null, 1.5, 3",
    "select value where value <> 3 and value <= 4 and value >= 2 and value < 9",
]


@pytest.mark.parametrize("sql", PARSE_CASES)
def test_parse_query_calls_match(sql):
    j = JParser().parse(_FakeBuilder(), ["labels"], sql)
    p = PParser().parse(_FakeBuilder(), ["labels"], sql)
    assert p.explain == j.explain
    assert p.plan.log == j.plan.log


@pytest.mark.parametrize(
    "sql",
    ["select", "insert into t values (1)", "select a from", "select sum(value) group",
     "select a from t join u", "select convert(value, blob)", "select 'unterminated",
     "select value where value > -2"],
)
def test_parse_errors_match(sql):
    with pytest.raises(JSQLParseError) as je:
        JParser().parse(_FakeBuilder(), ["labels"], sql)
    with pytest.raises(PSQLParseError) as pe:
        PParser().parse(_FakeBuilder(), ["labels"], sql)
    assert str(pe.value) == str(je.value)


def test_tokenize_matches():
    from frostdb_tpu.sqlparse import tokenize as jtok
    from frostdb_tpu_torch.sqlparse import tokenize as ptok

    sql = "select a.b, 'x y', 3.25 # note\n where c >= 4 and d <> 'e'"
    assert ptok(sql) == jtok(sql)


# ---------------------------------------------------------------------------
# SQL through the engine: tests/test_sql_extended.py, port against JAX


@pytest.fixture(scope="module")
def ext_dbs():
    _store, jdb = TSE.build_db()
    return jdb, carry(jdb, names=("stacktraces", "dims"))


def _run_sql(eng, parser, sql, table="stacktraces"):
    res = parser.parse(eng.scan_table(table), ["labels"], sql)
    out = []
    res.plan.execute(out.append)
    return FZ.rows(out), eng.last_serving_path


def sql_both(jdb, pdb, sql, table="stacktraces", **opts):
    jeng = JEngine(jdb.table_provider(), exec_options=JOptions(**opts))
    peng = PEngine(pdb.table_provider(), exec_options=POptions(**opts))
    return _run_sql(jeng, JParser(), sql, table), _run_sql(peng, PParser(), sql, table)


EXT_CASES = {
    "order_by_limit": ("select value, timestamp where timestamp < 200"
                       " order by value desc, timestamp limit 7", "compiled_scan"),
    "in_list": ("select sum(value), labels.node where labels.node in"
                " ('n1', 'n3', 'n5') group by labels.node", "compiled"),
    "not_in": ("select count(value), labels.node where labels.node not in ('n1')"
               " group by labels.node", "compiled"),
    "join_group_by": ("select sum(weight), labels.node from stacktraces"
                      " inner join dims on labels.node group by labels.node", "compiled_join"),
    "semi_join": ("select count(value), labels.node from stacktraces semi join dims"
                  " using (labels.node) group by labels.node", "compiled_join"),
    "anti_join": ("select count(value), labels.node from stacktraces anti join dims"
                  " using (labels.node) group by labels.node", "compiled_join"),
    "left_join": ("select sum(weight), count(value), labels.node from stacktraces"
                  " left outer join dims on labels.node = labels.node group by labels.node",
                  "compiled_join"),
    "epilogue": ("select sum(value), labels.node where timestamp < 500"
                 " group by labels.node order by labels.node desc limit 4", "compiled"),
    "join_epilogue": ("select sum(weight), labels.node from stacktraces inner join dims"
                      " on labels.node where labels.node in ('n0','n2','n4')"
                      " group by labels.node order by labels.node desc limit 2", "compiled_join"),
    "having_alias": ("select sum(value) as total, labels.node group by labels.node"
                     " having total > 15000 order by total desc", "generic"),
    "having_agg": ("select count(value), labels.node group by labels.node"
                   " having count(value) > 380", "generic"),
    "window": ("select sum(value), second(1) where timestamp >= 100 group by second(1)",
               "compiled"),
    "avg_window": ("select avg(value), second(1) where timestamp >= 100 group by second(1)",
                   "generic"),
    "distinct_order": ("select distinct(labels.node) order by labels.node desc", "compiled_distinct"),
    "dense_pair": ("select sum(value), count(value), labels.node, timestamp"
                   " group by labels.node, timestamp", "dense"),
    "dense_filtered": ("select max(value), labels.node, timestamp where value > 20"
                       " and labels.node != 'n4' group by labels.node, timestamp", "dense"),
    "generic_scan": ("select value, labels.node", "generic"),
}


@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_sql_through_engine_matches(ext_dbs, case):
    jdb, pdb = ext_dbs
    sql, tier = EXT_CASES[case]
    ref, got = sql_both(jdb, pdb, sql)
    assert got == ref
    assert got[1] == tier
    assert got[0]


def test_order_by_query_matches(ext_dbs):
    """test_sql_extended.py test_order_by_builder through both engines."""
    jdb, pdb = ext_dbs

    def run(eng, E):
        out = []
        eng.scan_table("stacktraces").filter(E.Col("timestamp").lt(100)).project(
            E.Col("value"), E.Col("timestamp")
        ).order_by(("value", "desc"), "timestamp").execute(out.append)
        return FZ.rows(out)

    from frostdb_tpu.query import expr as JE
    from frostdb_tpu_torch.query import expr as PE

    ref = run(JEngine(jdb.table_provider()), JE)
    got = run(PEngine(pdb.table_provider()), PE)
    assert got == ref and len(got) > 10


@pytest.mark.parametrize(
    "sql",
    [
        "explain select value where timestamp < 10 order by value limit 3",
        "explain select sum(value), labels.node where timestamp > 3 group by labels.node",
        "explain select sum(weight), labels.node from stacktraces inner join dims"
        " on labels.node group by labels.node",
        "explain select distinct(labels.node)",
    ],
)
def test_explain_matches(ext_dbs, sql):
    jdb, pdb = ext_dbs
    j = JParser().parse(JEngine(jdb.table_provider()).scan_table("stacktraces"), ["labels"], sql)
    p = PParser().parse(PEngine(pdb.table_provider()).scan_table("stacktraces"), ["labels"], sql)
    assert j.explain and p.explain
    assert p.plan.explain() == j.plan.explain()


def test_sql_distinct_through_engine():
    """test_compiled_distinct.py test_sql_distinct_through_engine."""
    _s, jdb, _t = TCD._mk(seed=4)
    pdb = carry(jdb)
    sql = "select distinct(example_type, value > 500000)"
    ref, got = sql_both(jdb, pdb, sql, table="t")
    assert got == ref
    assert got[1] == "compiled_distinct"
    gen, gpath = _run_sql(
        PEngine(pdb.table_provider(), exec_options=POptions(compiled_serving=False)),
        PParser(), sql, "t",
    )
    assert gpath == "generic" and gen == got[0]


def test_sql_second_window_through_engine():
    """test_windowed_group.py test_sql_second_window_through_engine."""
    _s, jdb, _t = TWG._setup(seed=7)
    pdb = carry(jdb)
    ref, got = sql_both(jdb, pdb, "select second(2), sum(value) group by second(2)", table="t")
    assert got == ref
    assert got[1] in ("compiled", "dense")
    assert got[0]


# ---------------------------------------------------------------------------
# HAVING without GROUP BY


@pytest.mark.divergence
@pytest.mark.parametrize(
    "sql,keep",
    [
        ("select value, timestamp where timestamp < 3 having value > 50",
         lambda r: r["value"] > 50),
        ("select distinct(labels.node) having labels.node = 'n1'",
         lambda r: r["labels.node"] == "n1"),
    ],
)
def test_having_without_group_by(ext_dbs, sql, keep):
    """Divergence: the JAX package drops a HAVING that has no GROUP BY and
    returns every projected row; the port filters the output rows by it,
    as MySQL does, in the same order."""
    jdb, pdb = ext_dbs
    (jrows, _jp), (prows, _pp) = sql_both(jdb, pdb, sql)
    assert any(not keep(dict(r)) for r in jrows)  # the reference ignored it
    assert prows == [r for r in jrows if keep(dict(r))]
    assert prows


# ---------------------------------------------------------------------------
# Datadriven scripts through both packages' run_file


def _insert(cols, rows):
    return ("insert cols=(" + ", ".join(cols) + ")",
            "\n".join("\t".join(str(v) for v in row) for row in rows))


def _exec(sql, unordered=False):
    return ("exec unordered" if unordered else "exec", sql)


def render(directives, expected=None):
    """A datadriven file: each (command line, input) directive followed by
    ``----`` and its expected output (empty unless given)."""
    blocks = []
    for i, (cmd, body) in enumerate(directives):
        out = expected[i] if expected is not None else ""
        blocks.append(cmd + ("\n" + body if body else "") + "\n----\n" + (out + "\n" if out else ""))
    return "\n".join(blocks)


def _script_basic():
    rng = np.random.default_rng(3)
    cols = ["labels.label1", "labels.label2", "stacktrace", "timestamp", "value", "floatvalue"]
    rows = []
    for i in range(60):
        l2 = "null" if i % 7 == 0 else f"b{int(rng.integers(0, 3))}"
        rows.append((f"a{int(rng.integers(0, 4))}", l2, f"stack{int(rng.integers(0, 5))}",
                     int(rng.integers(0, 20_000)), int(rng.integers(-50, 50)),
                     f"{rng.normal() * 10:.3f}"))
    out = [("createtable schema=default", ""), _insert(cols, rows[:35]), _insert(cols, rows[35:])]
    for sql, unordered in [
        ("select labels.label1, sum(value) group by labels.label1", False),
        ("select labels.label2, count(value), min(value), max(value) group by labels.label2", True),
        ("select stacktrace, sum(floatvalue) where timestamp >= 5000 group by stacktrace", False),
        ("select distinct(labels.label1)", True),
        ("select labels.label1, timestamp, value where value > 40 order by timestamp", False),
        ("select second(5), sum(value) group by second(5)", False),
        ("select labels.label1, avg(value) where labels.label1 regexp 'a[12]'"
         " group by labels.label1", True),
        ("select labels.label1, labels.label2, sum(value) group by labels.label1, labels.label2"
         " order by labels.label1, labels.label2", False),
        ("select sum(value) as s, labels.label1 group by labels.label1 having s > 0", True),
        ("explain select labels.label1, sum(value) where value > 3 group by labels.label1", False),
        ("select labels, value where timestamp < 3000", False),
        ("select value where stacktrace like 'ck3'", False),
    ]:
        out.append(_exec(sql, unordered))
    return out


def _script_dense():
    """More than 2048 (label, timestamp) groups: the dense tier serves the
    group-by on both packages."""
    rng = np.random.default_rng(4)
    cols = ["labels.node", "stacktrace", "timestamp", "value"]
    rows = [(f"n{int(rng.integers(0, 3))}", "s", int(t), int(rng.integers(0, 100)))
            for t in rng.permutation(2600)]
    return [
        ("createtable schema=default", ""),
        _insert(cols, rows),
        _exec("select labels.node, timestamp, sum(value), count(value)"
              " where timestamp >= 10 group by labels.node, timestamp"),
        _exec("select labels.node, timestamp, min(value) group by labels.node, timestamp", True),
    ]


def _script_bool_and_bytes():
    return [
        ("createtable schema=simple_bool", ""),
        _insert(["name", "found"], [("a", "true"), ("b", "false"), ("c", "true"), ("d", "null")]),
        _exec("select name, found where found = true"),
        _exec("select distinct(found)", True),
        ("createtable schema=bytes", ""),
        _insert(["labels.x", "timestamp", "value"],
                [("p", 3, "aa"), ("q", 1, "bb"), ("null", 2, "cc"), ("p", 9, "dd")]),
        _exec("select labels.x, timestamp, value"),
        _exec("select value where labels.x = 'p'"),
    ]


SCRIPTS = {"basic": _script_basic, "dense": _script_dense, "bool_and_bytes": _script_bool_and_bytes}


def _run_jax(path):
    return JLT.run_file(str(path), lambda: JLT.LogicTestDB(JColumnStore().db("test")))


def _run_port(path):
    return PLT.run_file(str(path), lambda: PLT.LogicTestDB(P.ColumnStore(device="cpu").db("test")))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_datadriven_scripts_match(tmp_path, name):
    """Each script's output, directive by directive, is the JAX package's;
    written back as the script's expected blocks, it is met by both."""
    directives = SCRIPTS[name]()
    path = tmp_path / f"{name}.test"
    path.write_text(render(directives))
    ref = _run_jax(path)
    got = _run_port(path)
    assert len(got) == len(ref) == len(directives)
    for (d, _e, actual), (_d, _e2, want) in zip(got, ref):
        assert actual == want, f"{name}:{d.line}\n{d.input}"
    assert sum(1 for d, _e, a in got if d.cmd == "exec" and a) >= 2
    path.write_text(render(directives, [a for _d, _e, a in got]))
    for run in (_run_jax, _run_port):
        for d, expected, actual in run(path):
            assert actual == expected, f"{name}:{d.line}\n{d.input}"


def test_format_column_and_tabwriter_match():
    from frostdb_tpu.columnbatch import Column as JColumn
    from frostdb_tpu_torch.columnbatch import Column as PColumn

    vals = np.array([1.5, -0.0, 3.0]), np.array([True, False, True])
    assert PLT.format_column(PColumn("f", "float64", *vals)) == JLT.format_column(
        JColumn("f", "float64", *vals)
    )
    rows = ["a\tbb\tccc\n", "dddddddddd\te\tf\n"]
    assert PLT.tabwriter_format(rows) == JLT.tabwriter_format(rows)


# ---------------------------------------------------------------------------
# examples_torch/ against examples/


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem + "_" + path.parent.name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["simple", "aggregations", "sql_joins"])
def test_examples_print_the_same(name):
    outs = []
    for mod, kwargs in ((_load(REPO / "examples" / f"{name}.py"), {}),
                        (_load(REPO / "examples_torch" / f"{name}.py"), {"device": "cpu"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(**kwargs)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert outs[0].count("\n") >= 3
