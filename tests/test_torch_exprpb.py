"""The port's plan protocol against the JAX package (tests/test_exprpb.py
and the proto round trip of tests/test_join_engine.py): expressions and
plans serialize to the same bytes in both packages and parse back in either,
the port's ProtoEngine serves a received plan through its engine's tiers,
and gRPC servers and clients of the two packages talk to each other."""

import importlib

import numpy as np
import pytest

import test_join_engine as JT
from frostdb_tpu.query import expr as JE
from test_torch_durability import JAX, PKGS, PORT, make_batch, rows
from test_torch_engine import carry, to_port

PB = {K.name: importlib.import_module(f"{K.name}.exprpb") for K in PKGS}
LOGICAL = {K.name: importlib.import_module(f"{K.name}.query.logical") for K in PKGS}


def exprs():
    return [
        JE.Col("timestamp").gt_eq(2),
        JE.And(JE.Col("a").eq("x"), JE.Col("b").regex_match("v.*")),
        JE.Sum(JE.BinaryExpr(JE.Col("value"), JE.OP_MUL, JE.Col("timestamp"))),
        JE.DynCol("labels"),
        JE.Literal(None),
        JE.Literal(True),
        JE.Literal(3.5),
        JE.Convert(JE.Count(JE.Col("v")), "float64"),
        JE.Col("x").alias("y"),
        JE.IsNullExpr(JE.Col("x")),
        JE.Duration(5000),
        JE.AllExpr(),
    ]


@pytest.mark.parametrize("i", range(12))
def test_expr_roundtrip_across_packages(i):
    """The same expression serializes to the same bytes in both packages,
    and each package parses the other's message back to the same name."""
    je = exprs()[i]
    pe = to_port(je)
    jmsg = PB[JAX.name].expr_to_proto(je).SerializeToString()
    pmsg = PB[PORT.name].expr_to_proto(pe).SerializeToString()
    assert jmsg == pmsg
    for K in PKGS:
        pb = PB[K.name]
        back = pb.expr_from_proto(pb.pb.Expr.FromString(jmsg))
        assert back.name() == je.name()


def _store(K, n=3, name="test"):
    store = K.ColumnStore()
    db = store.db(name)
    table = db.table("t", K.config())
    table.insert_record(make_batch(K, table, n=n))
    return store, db


def _agg_plan(K, db, filt=True):
    E = K.E
    b = LOGICAL[K.name].Builder().scan(db.table_provider(), "t")
    if filt:
        b = b.filter(E.Col("timestamp").gt_eq(2))
    return b.aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")]).build()


def test_plan_roundtrip_and_proto_engine():
    """A plan from either package runs through the port's ProtoEngine on
    the compiled tier with the rows the JAX package's ProtoEngine gives."""
    got = {}
    for K in PKGS:
        _s, db = _store(K)
        node = PB[K.name].plan_to_proto(_agg_plan(K, db))
        assert PB[K.name].plan_from_proto(node, db.table_provider()).aggregation
        got[K.name] = (db, node)
    jdb, jnode = got[JAX.name]
    pdb, pnode = got[PORT.name]
    assert jnode.SerializeToString() == pnode.SerializeToString()
    ref = []
    PB[JAX.name].ProtoEngine(jdb.table_provider()).execute(jnode, ref.append)
    assert rows(ref) == [(("example_type", "cpu"), ("sum(value)", 5))]
    for node in (jnode, pnode):
        pe = PB[PORT.name].ProtoEngine(pdb.table_provider())
        out = []
        pe.execute(PB[PORT.name].pb.PlanNode.FromString(node.SerializeToString()), out.append)
        assert rows(out) == rows(ref)
        assert pe.engine.last_serving_path == "compiled"


@pytest.mark.parametrize("client", PKGS, ids=str)
@pytest.mark.parametrize("server", PKGS, ids=str)
def test_grpc_query_stream_across_packages(server, client):
    """Either package's client queries either package's server over
    localhost; the Arrow IPC stream decodes to the same rows."""
    store, _db = _store(server, name="grpcdb")
    srv, port = PB[server.name].make_grpc_server(store)
    srv.start()
    try:
        _cs, cdb = _store(client, name="grpcdb")
        rc = PB[client.name].RemoteClient(f"127.0.0.1:{port}")
        got = rows(rc.query(_agg_plan(client, cdb, filt=False), database="grpcdb"))
        rc.channel.close()
    finally:
        srv.stop(0)
    assert got == [(("example_type", "cpu"), ("sum(value)", 6))]


def test_order_by_round_trip():
    for K in PKGS:
        pb = PB[K.name]
        plan = (
            LOGICAL[K.name].Builder()
            .scan(None, "t")
            .project(K.E.Col("value"), K.E.Col("timestamp"))
            .order_by(("value", "desc"), "timestamp")
            .limit(K.E.Literal(5))
            .build()
        )
        rebuilt = pb.plan_from_proto(pb.plan_to_proto(plan), None)
        assert rebuilt.limit is not None
        assert rebuilt.input.order_by.keys == [("value", "desc"), ("timestamp", "asc")]


def test_join_explain_and_proto_roundtrip():
    """tests/test_join_engine.py's proto round trip on the port: the join
    survives the protocol and runs to the rows of the query it came from
    and of the JAX package."""
    _store_j, jdb = JT._setup()
    pdb = carry(jdb, names=("facts", "dims"))
    out = {}
    for K, db in ((JAX, jdb), (PORT, pdb)):
        engine = K.engine.LocalEngine(db.table_provider())
        q = engine.scan_table("facts").join(
            engine.scan_table("dims"), on=["job"], how="left_outer"
        )
        s = q.explain()
        assert "HashJoin (left_outer on job)" in s and "TableScan" in s
        pb = PB[K.name]
        back = pb.plan_from_proto(pb.plan_to_proto(q.builder.build()), db.table_provider())
        assert back.join.on == ["job"] and back.join.how == "left_outer"
        assert back.join.right.table_scan.table_name == "dims"
        direct, received = [], []
        q.execute(direct.append)
        optimize = importlib.import_module(f"{K.name}.query.optimize")
        K.physical.build_physical(
            optimize.optimize(back), K.physical.ExecOptions()
        ).execute(received.append)
        assert rows(direct) == rows(received)
        out[K.name] = rows(direct)
    assert out[PORT.name] == out[JAX.name]


def test_grpc_serves_through_the_compiled_tier():
    """A remote aggregate takes the port's compiled tier: its sum/count
    kernel's plain version runs for it on the CPU."""
    from frostdb_tpu_torch.ops import agg_kernels as AK

    store = PORT.ColumnStore()
    db = store.db("g")
    table = db.table("t", PORT.config())
    for i in range(3):
        table.insert_record(make_batch(PORT, table, n=50, ts_start=100 * i))
    calls = []
    orig = AK.fused_band_group_sum_count

    def spy(*a, **k):
        calls.append(a[0].device)
        return orig(*a, **k)

    AK.fused_band_group_sum_count = spy
    srv, port = PB[PORT.name].make_grpc_server(store)
    srv.start()
    try:
        rc = PB[PORT.name].RemoteClient(f"127.0.0.1:{port}")
        plan = _agg_plan(PORT, db)
        remote = rows(rc.query(plan, database="g"))
        rc.channel.close()
    finally:
        srv.stop(0)
        AK.fused_band_group_sum_count = orig
    local = []
    PORT.engine.LocalEngine(db.table_provider()).scan_table("t").filter(
        PORT.E.Col("timestamp").gt_eq(2)
    ).aggregate([PORT.E.Sum(PORT.E.Col("value"))], [PORT.E.Col("example_type")]).execute(
        local.append
    )
    assert remote == rows(local)
    assert calls and {str(d) for d in calls} == {"cpu"}
    assert np.sum([dict(r)["sum(value)"] for r in remote]) == 3 * sum(range(1, 51)) - (1 + 2)
