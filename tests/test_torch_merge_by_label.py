"""Parca's flame graph grouped by node (gpubench's ``merge_by_label`` mix
over the ``parca_by_node`` configuration, the ``parca_profiles`` table) on
the port, cut to 2 rows a profile: every query of both shapes goes through
LocalEngine on the CPU on the dense tier's shuffle route, equals the plain numpy reference
(``gpubench/reference/numpy_ref.py``) with exact int64 sums and the port's
generic DAG row for row, in its emission order. The route's spans carry
their counts (``dense/pairs``: selected rows and pairs of a part;
``shuffle/order``: the groups ordered on the host) and
``shuffle_pairs_total`` counts the pairs scattered, on one device and on
the mesh tier's 8 shards.

At full size the pair space (labels.node, stacktrace) holds 64 x 131,072 =
8,388,608 codes, past the dense tier's 2^20: the shuffle route. The cut
table holds 64 x a few thousand stacks; the tests cut the tier's ceiling
to 1,024 codes so that the same route serves it."""

import os
import sys

import pytest

GPUBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gpubench")
if GPUBENCH not in sys.path:
    sys.path.append(GPUBENCH)

from harness import client, datagen, judge, spec  # noqa: E402
from reference import numpy_ref  # noqa: E402

from frostdb_tpu_torch.db import ColumnStore  # noqa: E402
from frostdb_tpu_torch.metrics import MetricsRegistry  # noqa: E402
from frostdb_tpu_torch.parallel import mesh_exec as ME  # noqa: E402
from frostdb_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from frostdb_tpu_torch.query.engine import LocalEngine  # noqa: E402
from frostdb_tpu_torch.query.physical import ExecOptions  # noqa: E402
from frostdb_tpu_torch.tracing import Tracer  # noqa: E402

SEED = 2**33 + 22
ROWS_PER_PROFILE = 2
CONFIG = spec.load(os.path.join(GPUBENCH, "configs", "parca_by_node.json"))
MIX = spec.load(os.path.join(GPUBENCH, "traffic", "merge_by_label.json"))
SHAPES = list(MIX["cycle"])
QUERIES = [(name, params) for name in SHAPES for params in spec.combos(MIX["shapes"][name])]


@pytest.fixture(scope="module")
def cut_table():
    """(rows, db): the cut table, synced, on a CPU store."""
    rows = datagen.generate(CONFIG, SEED, ROWS_PER_PROFILE)
    db = ColumnStore(device="cpu").db("parca")
    client.fill_table(db, CONFIG, rows.batches(), rows.dicts).sync()
    return rows, db


@pytest.fixture
def shuffle_ceiling(monkeypatch):
    monkeypatch.setattr(ME.DenseLocalAggregate, "MAX_CODES", 1024)


def query(name: str, params: dict) -> list:
    return spec.bind(MIX["shapes"][name]["query"], params)


def run(engine, q) -> tuple:
    """(result batches, the rows as Python values in order)."""
    batches = []
    client.build(engine, CONFIG["table"], q).execute(batches.append)
    rows = []
    for b in batches:
        rows.extend(zip(*[client._decoded(c) for c in b.columns]))
    return batches, rows


def find(span, name) -> list:
    return ([span] if span.name == name else []) + [s for c in span.children for s in find(c, name)]


def traced(db, q, **opts) -> tuple:
    """(rows, serving path, the query's root span, the counter of pairs)."""
    tracer, registry = Tracer(), MetricsRegistry()
    engine = LocalEngine(db.table_provider(), ExecOptions(tracer=tracer, metrics=registry, **opts))
    _batches, rows = run(engine, q)
    (root,) = tracer.roots
    return rows, engine.last_serving_path, root, registry.counter("shuffle_pairs_total").value()


def selected(rows, q) -> int:
    frame = numpy_ref.table_frame(rows)
    return int(numpy_ref.mask(next(s for s in q if s[0] == "filter")[1], frame).sum())


@pytest.mark.parametrize("name, params", QUERIES, ids=lambda x: str(x))
def test_query_equals_reference_and_generic(name, params, cut_table, shuffle_ceiling):
    rows, db = cut_table
    q = query(name, params)
    fast = LocalEngine(db.table_provider())
    batches, got = run(fast, q)
    assert fast.last_serving_path == MIX["shapes"][name]["tier"] == "dense"
    assert judge.mismatch(numpy_ref.answer(q, rows), client.normalize(q, batches, rows.dicts)) is None
    generic = LocalEngine(db.table_provider(), ExecOptions(compiled_serving=False))
    _b, want = run(generic, q)
    assert generic.last_serving_path == "generic"
    assert got == want
    assert len(got) > 1024


@pytest.mark.parametrize("name", SHAPES)
def test_shuffle_spans_and_counter(name, cut_table, shuffle_ceiling):
    """One ``dense/pairs`` a part read, with the part's selected rows and
    pairs; one ``shuffle/order`` inside the epilogue with the groups it
    ordered; the counter equal to the pairs scattered."""
    rows, db = cut_table
    q = query(name, spec.combos(MIX["shapes"][name])[-1])
    got, path, root, counted = traced(db, q)
    assert path == "dense"
    (parts,) = find(root, "dense/parts")
    assert parts.attributes["route"] == "shuffle"
    (remap,) = [s for s in find(root, "groups/remap") if "declined" not in s.attributes]
    assert remap.attributes["codes"] > 1024
    pairs = find(parts, "dense/pairs")
    assert len(pairs) == parts.attributes["parts"] > 0
    assert all(set(s.attributes) == {"selected", "pairs"} for s in pairs)
    assert all(0 < s.attributes["pairs"] <= s.attributes["selected"] for s in pairs)
    assert sum(s.attributes["selected"] for s in pairs) == selected(rows, q)
    assert counted == sum(s.attributes["pairs"] for s in pairs) >= len(got)
    (epilogue,) = find(root, "result/epilogue")
    (order,) = find(epilogue, "shuffle/order")
    assert order.attributes == {"groups": len(got)}


@pytest.mark.parametrize("n_shards", [1, 8])
def test_mesh_shuffle_counts_the_pairs_it_scatters(n_shards, cut_table, shuffle_ceiling, monkeypatch):
    """The mesh tier: the same rows as one device; on one shard the dense
    tier's spans; on eight one ``dense/pairs`` a shard for each part's
    exchange, with the pairs that shard sends, and the counter the sum of
    those of the exchanges that scattered (an overflowed one restarts the
    query and scatters nothing)."""
    rows, db = cut_table
    name = SHAPES[0]
    q = query(name, spec.combos(MIX["shapes"][name])[0])
    want, _path, local_root, local = traced(db, q)
    overflowed = []
    program = ME.MeshFilterAggregate._shuffle_program

    def spy(self, *a):
        step = program(self, *a)

        def watched(*args, **kw):
            tabs, over = step(*args, **kw)
            overflowed.append(over)
            return tabs, over

        return watched

    monkeypatch.setattr(ME.MeshFilterAggregate, "_shuffle_program", spy)
    got, path, root, counted = traced(db, q, mesh=make_mesh(n_shards, device="cpu"))
    assert path == "mesh" and got == want
    (parts,) = find(root, "dense/parts")
    pairs = find(parts, "dense/pairs")
    if n_shards == 1:
        assert overflowed == []
        assert len(pairs) == len(find(local_root, "dense/pairs"))
        assert counted == local == sum(s.attributes["pairs"] for s in pairs)
    else:
        assert len(pairs) == n_shards * len(overflowed) and not overflowed[-1]
        steps = [pairs[i:i + n_shards] for i in range(0, len(pairs), n_shards)]
        assert counted == sum(s.attributes["pairs"] for step, over in zip(steps, overflowed)
                              if not over for s in step)
        # The last attempt reads every part: its shards select every row.
        last = steps[-parts.attributes["parts"]:]
        assert sum(s.attributes["selected"] for step in last for s in step) == selected(rows, q)
    (order,) = find(root, "shuffle/order")
    assert order.attributes == {"groups": len(got)}
