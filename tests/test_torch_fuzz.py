"""``frostdb_tpu_torch/tools/fuzz.py`` against the JAX package's
differential fuzz (tests/test_differential_fuzz.py).

The reference's own scenario functions run with spies on their generators:
the port's generators must make the same draws (the same parts, columns,
validity and dictionaries of every table, the same filters, aggregates and
groups, the rng in the same state afterwards), and the tool on the CPU must
give, per query, the rows the JAX package gives on the reference's own db.
Then the tool's directed shapes against the JAX package's rows, its
out-of-gate float-sum rule, its CLI, and a planted fault it must report.
"""

import re

import numpy as np
import pytest

import test_differential_fuzz as FZ
import test_torch_engine as TE
from frostdb_tpu.query import expr as JE

from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.physical import ExecOptions
from frostdb_tpu_torch.tools import fuzz as PF

REFERENCE = {
    "aggregates": FZ.test_aggregate_differential,
    "scan and epilogue": FZ.test_scan_and_epilogue_differential,
    "joins": FZ.test_join_differential,
    "int-key joins": FZ.test_int_key_join_differential,
}
GENERATORS = ("random_filter", "random_aggs", "random_groups")
# The seeds each reference scenario is parametrised over.
FZ_SEEDS = {
    name: next(m.args[1] for m in fn.pytestmark if m.name == "parametrize")
    for name, fn in REFERENCE.items()
}


def structure(e):
    """An expression tree (either package's) as nested tuples of class
    names and attributes: equal for equal trees."""
    if isinstance(e, (list, tuple)):
        return tuple(structure(x) for x in e)
    if isinstance(e, (JE.Expr, PE.Expr)):
        return (type(e).__name__,) + tuple(
            (k, structure(v)) for k, v in sorted(vars(e).items()))
    return (type(e).__name__, e)


def spy(monkeypatch, module, drawn):
    """Record what ``module``'s generators return, in call order."""
    for name in GENERATORS:
        fn = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _fn=fn: drawn.append(_fn(*a)) or drawn[-1],
        )


def reference_run(monkeypatch, scenario, seed):
    """The reference's scenario at one seed: its db, the generators'
    draws, its rng's final state and the JAX generic DAG's rows per query
    (the reference's tier comparisons run in tests/test_differential_fuzz.py
    itself; here every run but the generic one returns its rows)."""
    rec = {"drawn": [], "rows": []}
    spy(monkeypatch, FZ, rec["drawn"])
    build, run = FZ.build_db, FZ._run

    def build_db(rng):
        rec["rng"] = rng
        store, rec["db"] = build(rng)
        return store, rec["db"]

    def generic_only(db, opts, make_q):
        if opts.mesh is None and not opts.compiled_serving:
            rec["rows"].append(run(db, opts, make_q)[0])
        return rec["rows"][-1], "generic"

    monkeypatch.setattr(FZ, "build_db", build_db)
    monkeypatch.setattr(FZ, "_run", generic_only)
    REFERENCE[scenario](seed)
    monkeypatch.undo()
    return rec


def table_parts(db, name):
    """Per part, per column: (name, kind, values' dtype and bytes,
    validity); and the table's dictionaries' values."""
    t = db.get_table(name)
    parts = [
        [(c.name, c.kind, c.values.dtype.str, c.values.tobytes(), c.validity.tobytes())
         for c in p.batch.columns]
        for p in t.collect_parts(db.high_watermark())
    ]
    dicts = {fam: list(d.values) for fam, d in t.dictionaries.items()}
    return parts, dicts


@pytest.mark.parametrize("scenario", list(REFERENCE))
def test_draws_and_rows_match_reference(monkeypatch, scenario):
    scn = next(s for s in PF.SCENARIOS if s.name == scenario)
    assert scn.seeds == len(FZ_SEEDS[scenario])
    for seed in range(scn.seeds):
        ref = reference_run(monkeypatch, scenario, seed)

        drawn = []
        spy(monkeypatch, PF, drawn)
        rng = np.random.default_rng(scn.base + seed)
        store, db = scn.setup(rng, "cpu", 1)
        queries = scn.queries(rng)
        monkeypatch.undo()

        assert rng.bit_generator.state == ref["rng"].bit_generator.state, seed
        assert structure(drawn) == structure(ref["drawn"]), seed
        jdb = ref["db"]
        names = sorted(jdb.tables)
        assert names == sorted(db.tables)
        for name in names:
            assert table_parts(db, name) == table_parts(jdb, name), (seed, name)

        stats = PF.Stats()
        opts = PF.tier_options("cpu")
        assert len(queries) == len(ref["rows"])
        for i, (q, want) in enumerate(zip(queries, ref["rows"])):
            runs = PF.check_query(f"seed {seed} query {i}", q, db, opts, None, None, stats)
            assert runs["generic"].rows == want, (seed, i, q.text)
        assert stats.queries == len(queries)
        store.close()


def test_directed_shapes_match_jax():
    """The tool's directed tables are the port engine test's, and each
    directed shape gives the JAX package's rows on the tier it names."""
    jdb = TE._directed_db()
    store, db = PF.directed_setup("cpu")
    for name in ("t", "tn"):
        assert table_parts(db, name) == table_parts(jdb, name)
    jax_shapes = {
        **{name: TE._DIRECTED[name] for name in PF.DIRECTED},
        **{f"count_only_{name}": TE._COUNT_ONLY[name] for name in TE._COUNT_ONLY},
    }
    assert set(jax_shapes) == {*PF.DIRECTED, *PF.COUNT_ONLY}
    opts = PF.tier_options("cpu")
    for name, (make, tier, _kernels) in {**PF.DIRECTED, **PF.COUNT_ONLY}.items():
        shape = jax_shapes[name]
        if name in TE._DIRECTED:
            table, filt, aggs, _k = shape

            def make_q(eng, E, table=table, filt=filt, aggs=aggs):
                q = eng.scan_table(table)
                if filt is not None:
                    q = q.filter(filt(E))
                return q.aggregate(aggs(E), [E.Col("g")])
        else:
            def make_q(eng, E, shape=shape):
                return shape(E)(eng)

        want, jpath = TE.run_jax(jdb, make_q, compiled=True)
        runs = PF.check_query(name, PF.Query(name, make), db, opts, None, None, PF.Stats())
        assert runs["compiled"].path == jpath == tier, name
        assert runs["compiled"].rows == want and want, name
    store.close()


def wide_floats_db(seed):
    """A fuzz-schema table of two parts whose float column holds wide
    finite values (signs and exponents from -30 to 30, outside the
    exact-sum gate): sums in row order and by a binary tree then differ in
    their last bits."""
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.table import TableConfig

    rng = np.random.default_rng(seed)
    store = ColumnStore(device="cpu")
    db = store.db("wide")
    t = db.table("t", TableConfig(schema=PF._schema()))
    dg, dh = t.dictionary("g"), t.dictionary("h")
    for n in (700, 500):
        ones = np.ones(n, bool)
        f = rng.choice([-1.0, 1.0], n) * rng.random(n) * 10.0 ** rng.integers(-30, 31, n)
        t.insert_record(ColumnBatch([
            Column("g", "dict", *dg.encode([f"g{i}" for i in rng.integers(0, 4, n)]), dg),
            Column("h", "dict", *dh.encode([f"h{i}" for i in rng.integers(0, 3, n)]), dh),
            Column("ts", "int64", rng.integers(0, 10**5, n), ones),
            Column("v", "int64", rng.integers(-100, 100, n), ones),
            Column("f", "float64", f, ones),
            Column("b", "bool", rng.random(n) > 0.5, ones),
        ], n))
    t.sync()
    return store, db


def host_groups(db, keys, lit):
    """{key tuple: the f values of rows with ts >= lit, in scan order}."""
    parts = db.get_table("t").collect_parts(db.high_watermark())
    cols = {name: [] for name in (*keys, "ts", "f")}
    for p in parts:
        for name in cols:
            c = p.batch.column(name)
            cols[name] += [c.py_value(i) for i in range(p.batch.num_rows)] if name in keys \
                else list(c.values)
    m = np.asarray(cols["ts"]) >= lit
    out: dict = {}
    for i in np.flatnonzero(m):
        out.setdefault(tuple(cols[k][i] for k in keys), []).append(cols["f"][i])
    return out


def test_float_sum_rule():
    """Where the device's rows differ from the CPU's only in an out-of-gate
    float sum equal to the pairwise tree over the group's selected values in
    stream order, the difference is counted; a sum off the tree, or any
    other difference, is a mismatch."""
    cases = 0
    for seed in range(3):
        store, db = wide_floats_db(seed)
        for keys in (("g",), ("g", "h")):
            lit = 20_000
            filt = PE.Col("ts").gt_eq(lit)
            q = PF.Query(
                "float sums", lambda e, filt=filt, keys=keys: e.scan_table("t").filter(filt)
                .aggregate([PE.Sum(PE.Col("f")), PE.Count(PE.Col("v"))],
                           [PE.Col(k) for k in keys]),
                float_sums={"sum(f)": "f"}, sum_filter=filt,
            )
            cpu = PF.run_tier(db, ExecOptions(compiled_serving=False), q.make).rows
            groups = host_groups(db, keys, lit)
            tree = []
            for row in cpu:
                vals = np.array(groups[tuple(v for n, v in row if n in keys)])
                assert row[len(keys)] == ("sum(f)", PF.encode_float(float(np.cumsum(vals)[-1])))
                tree.append(tuple((n, PF.encode_float(PF.tree_sum(vals)) if n == "sum(f)" else v)
                                  for n, v in row))
            differ = sum(a != b for a, b in zip(tree, cpu))
            assert PF.float_sum_cases("w", q, tree, cpu, db) == differ
            cases += differ
            if differ:
                i = next(i for i, (a, b) in enumerate(zip(tree, cpu)) if a != b)
                off = list(tree)
                off[i] = tuple((n, PF.encode_float(-1.0) if n == "sum(f)" else v)
                               for n, v in off[i])
                with pytest.raises(PF.Mismatch, match="pairwise tree"):
                    PF.float_sum_cases("w", q, off, cpu, db)
                wrong_count = list(tree)
                wrong_count[i] = tuple((n, v + 1 if n == "count(v)" else v) for n, v in tree[i])
                with pytest.raises(PF.Mismatch, match="differ from the CPU"):
                    PF.float_sum_cases("w", q, wrong_count, cpu, db)
        store.close()
    assert cases > 0


def test_tree_sum_signs_nan_as_the_port_does():
    nan = float("nan")
    assert PF.encode_float(PF.tree_sum(np.array([1.0, -nan, 2.0, nan, 3.0]))) == "nan"
    assert PF.encode_float(PF.tree_sum(np.array([1.0, nan, -nan]))) == "nan/n"
    assert PF.encode_float(PF.tree_sum(np.array([np.inf, -np.inf]))) == "nan/n"
    assert PF.encode_float(PF.tree_sum(np.array([-0.0, -0.0]))) == "0.0"
    assert PF.tree_sum(np.array([1e16, 1.0, -1e16, 1.0])) == 0.0  # (1e16+1)+(-1e16+1)


def test_cli_passes_on_the_cpu(capsys):
    assert PF.main(["--device", "cpu", "--against-cpu", "--extra-seeds", "2"]) == 0
    out = capsys.readouterr().out
    for name in (*REFERENCE, "directed shapes"):
        assert re.search(rf"^{name}: \d+ queries, served ", out, re.M), name
    assert "aggregates: 66 queries" in out
    assert out.splitlines()[-1].startswith("PASS")


def test_cli_reports_a_planted_fault(monkeypatch, capsys):
    """A compiled tier that drops one row of its result fails the run,
    which names the seed and the query."""
    from frostdb_tpu_torch import compiled

    lower = compiled.lower_plan

    def lower_dropping_a_row(plan, exec_options=None):
        prog = lower(plan, exec_options)
        execute = prog.execute

        def dropped():
            out = execute()
            return out.slice(0, out.num_rows - 1) if out.num_rows else out

        prog.execute = dropped
        return prog

    monkeypatch.setattr(compiled, "lower_plan", lower_dropping_a_row)
    assert PF.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert re.search(r"FAIL: aggregates seed 10\d\d query \d: compiled \(served by compiled\) "
                     r"differs from the generic DAG", out)
    assert "query: aggregate [" in out
