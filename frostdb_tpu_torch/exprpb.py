"""Serialized logical-plan protocol: expr/plan <-> protobuf + gRPC service.

Reference: query/exprpb/proto.go (full Expr/plan round-trip) and
proto/frostdb/storage/v1alpha1/storage.proto (FrostDBService.Query streaming
Arrow IPC). This is the distribution hook: a remote engine executes a
serialized plan against its local tables and streams record batches back.
"""

from __future__ import annotations

from typing import Optional

from .gen import storage_pb2 as pb
from .query import expr as E
from .query.logical import Builder, LogicalPlan


class ProtoConversionError(Exception):
    pass


# ---------------------------------------------------------------------------
# Expr -> proto


def expr_to_proto(e: E.Expr) -> pb.Expr:
    if isinstance(e, E.AliasExpr):
        return pb.Expr(
            alias=pb.Alias(expr=expr_to_proto(e.expr), name=e.alias_name)
        )
    if isinstance(e, E.Column):
        return pb.Expr(column=pb.Column(name=e.column_name))
    if isinstance(e, E.DynamicColumn):
        return pb.Expr(dynamic_column=pb.DynamicColumn(name=e.column_name))
    if isinstance(e, E.Literal):
        v = e.value
        if v is None:
            return pb.Expr(literal=pb.Literal(null=True))
        if isinstance(v, bool):
            return pb.Expr(literal=pb.Literal(bool_value=v))
        if isinstance(v, float):
            return pb.Expr(literal=pb.Literal(double_value=v))
        if isinstance(v, str):
            return pb.Expr(literal=pb.Literal(string_value=v))
        return pb.Expr(literal=pb.Literal(int64_value=int(v)))
    if isinstance(e, E.BinaryExpr):
        return pb.Expr(
            binary=pb.BinaryExpr(
                left=expr_to_proto(e.left),
                op=e.op,
                right=expr_to_proto(e.right),
            )
        )
    if isinstance(e, E.AggregationFunction):
        return pb.Expr(
            aggregation=pb.AggregationFunction(
                func=e.func, expr=expr_to_proto(e.expr)
            )
        )
    if isinstance(e, E.ConvertExpr):
        return pb.Expr(
            convert=pb.Convert(expr=expr_to_proto(e.expr), to_type=e.to_type)
        )
    if isinstance(e, E.IsNullExpr):
        return pb.Expr(is_null=pb.IsNull(expr=expr_to_proto(e.expr)))
    if isinstance(e, E.DurationExpr):
        return pb.Expr(duration=pb.Duration(milliseconds=e.milliseconds))
    if isinstance(e, E.AllExpr):
        return pb.Expr(all=pb.All())
    raise ProtoConversionError(f"unsupported expr {e!r}")


def expr_from_proto(p: pb.Expr) -> E.Expr:
    kind = p.WhichOneof("kind")
    if kind == "column":
        return E.Col(p.column.name)
    if kind == "dynamic_column":
        return E.DynCol(p.dynamic_column.name)
    if kind == "literal":
        which = p.literal.WhichOneof("value")
        if which == "null" or which is None:
            return E.Literal(None)
        if which == "bool_value":
            return E.Literal(p.literal.bool_value)
        if which == "double_value":
            return E.Literal(p.literal.double_value)
        if which == "string_value":
            return E.Literal(p.literal.string_value)
        if which == "uint64_value":
            return E.Literal(p.literal.uint64_value)
        return E.Literal(p.literal.int64_value)
    if kind == "binary":
        return E.BinaryExpr(
            expr_from_proto(p.binary.left),
            p.binary.op,
            expr_from_proto(p.binary.right),
        )
    if kind == "aggregation":
        return E.AggregationFunction(
            p.aggregation.func, expr_from_proto(p.aggregation.expr)
        )
    if kind == "alias":
        return expr_from_proto(p.alias.expr).alias(p.alias.name)
    if kind == "convert":
        return E.Convert(expr_from_proto(p.convert.expr), p.convert.to_type)
    if kind == "is_null":
        return E.IsNullExpr(expr_from_proto(p.is_null.expr))
    if kind == "duration":
        return E.Duration(p.duration.milliseconds)
    if kind == "all":
        return E.AllExpr()
    raise ProtoConversionError(f"unsupported proto expr kind {kind}")


# ---------------------------------------------------------------------------
# Plan -> proto (linear chain, scan last — reference storage.proto PlanNode)


def plan_to_proto(plan: LogicalPlan) -> pb.PlanNode:
    node = pb.PlanNode()
    if plan.table_scan is not None:
        node.table_scan.table_name = plan.table_scan.table_name
    elif plan.schema_scan is not None:
        node.schema_scan.table_name = plan.schema_scan.table_name
    elif plan.filter is not None:
        node.filter.expr.CopyFrom(expr_to_proto(plan.filter.expr))
    elif plan.projection is not None:
        node.projection.exprs.extend(
            expr_to_proto(e) for e in plan.projection.exprs
        )
    elif plan.distinct is not None:
        node.distinct.exprs.extend(
            expr_to_proto(e) for e in plan.distinct.exprs
        )
    elif plan.aggregation is not None:
        node.aggregation.group_exprs.extend(
            expr_to_proto(e) for e in plan.aggregation.group_exprs
        )
        node.aggregation.agg_exprs.extend(
            expr_to_proto(e) for e in plan.aggregation.agg_exprs
        )
    elif plan.limit is not None:
        node.limit.expr.CopyFrom(expr_to_proto(plan.limit.expr))
    elif plan.join is not None:
        node.join.right.CopyFrom(plan_to_proto(plan.join.right))
        node.join.on.extend(plan.join.on)
        node.join.how = plan.join.how
    elif plan.order_by is not None:
        for name, direction in plan.order_by.keys:
            k = node.order_by.keys.add()
            k.column = name
            k.direction = direction
    else:
        raise ProtoConversionError("unsupported plan node")
    if plan.input is not None:
        node.next.CopyFrom(plan_to_proto(plan.input))
    return node


def plan_from_proto(node: pb.PlanNode, provider) -> LogicalPlan:
    """Rebuild a LogicalPlan chain; the scan binds to the local provider."""
    # Collect chain root->leaf then build leaf-first.
    chain: list[pb.PlanNode] = []
    cur: Optional[pb.PlanNode] = node
    while cur is not None:
        chain.append(cur)
        cur = cur.next if cur.HasField("next") else None

    builder = Builder()
    for n in reversed(chain):
        spec = n.WhichOneof("spec")
        if spec == "table_scan":
            builder = builder.scan(provider, n.table_scan.table_name)
        elif spec == "schema_scan":
            builder = builder.schema_scan(provider, n.schema_scan.table_name)
        elif spec == "filter":
            builder = builder.filter(expr_from_proto(n.filter.expr))
        elif spec == "projection":
            builder = builder.project(
                *(expr_from_proto(e) for e in n.projection.exprs)
            )
        elif spec == "distinct":
            builder = builder.distinct(
                *(expr_from_proto(e) for e in n.distinct.exprs)
            )
        elif spec == "aggregation":
            aggs = [expr_from_proto(e) for e in n.aggregation.agg_exprs]
            groups = [expr_from_proto(e) for e in n.aggregation.group_exprs]
            # Raw node chain: attach without the builder's avg rewrite (the
            # sender already resolved aggregations).
            plan = LogicalPlan(builder.plan)
            from .query.logical import Aggregation

            plan.aggregation = Aggregation(groups, aggs)
            builder = Builder(plan)
        elif spec == "limit":
            builder = builder.limit(expr_from_proto(n.limit.expr))
        elif spec == "join":
            right = plan_from_proto(n.join.right, provider)
            builder = builder.join(right, list(n.join.on), n.join.how)
        elif spec == "order_by":
            builder = builder.order_by(
                *((k.column, k.direction) for k in n.order_by.keys)
            )
        else:
            raise ProtoConversionError(f"unsupported plan spec {spec}")
    return builder.plan


# ---------------------------------------------------------------------------
# ProtoEngine: execute a serialized plan (reference: query/exprpb/engine.go)


class ProtoEngine:
    """Executes a received plan through the port's ``LocalEngine``, so a
    remote query takes the same serving tiers and kernels as a local one;
    ``engine.last_serving_path`` names the tier that served the last plan."""

    def __init__(self, provider, exec_options=None):
        from .query.engine import LocalEngine

        self.provider = provider
        self.exec_options = exec_options
        self.engine = LocalEngine(provider, exec_options)

    def execute(self, node: pb.PlanNode, callback) -> None:
        from .query.engine import LocalQueryBuilder

        plan = plan_from_proto(node, self.provider)
        LocalQueryBuilder(self.engine, Builder(plan)).execute(callback)


# ---------------------------------------------------------------------------
# gRPC service (hand-wired handlers; grpc_tools codegen is not available in
# this image, so serializers are bound explicitly).

SERVICE_NAME = "frostdb_tpu.v1.FrostDBTPUService"


def make_grpc_server(store, address: str = "127.0.0.1:0"):
    """Create (server, port). The service streams Arrow IPC batches for
    Query(QueryRequest) like the reference's FrostDBService
    (storage.proto:6-25)."""
    import grpc

    from .wal import batch_to_ipc

    def query(request: pb.QueryRequest, context):
        db = store.db(request.database or "default")
        engine_provider = db.table_provider()
        pe = ProtoEngine(engine_provider)
        batches = []
        pe.execute(request.plan, lambda b: batches.append(b))
        for b in batches:
            yield pb.QueryResponse(record=batch_to_ipc(b))

    handler = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Query": grpc.unary_stream_rpc_method_handler(
                query,
                request_deserializer=pb.QueryRequest.FromString,
                response_serializer=pb.QueryResponse.SerializeToString,
            )
        },
    )
    from concurrent import futures

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port(address)
    return server, port


class RemoteClient:
    """Client for FrostDBTPUService.Query — returns ColumnBatches decoded
    from the Arrow IPC stream."""

    def __init__(self, target: str):
        import grpc

        self.channel = grpc.insecure_channel(target)
        self._query = self.channel.unary_stream(
            f"/{SERVICE_NAME}/Query",
            request_serializer=pb.QueryRequest.SerializeToString,
            response_deserializer=pb.QueryResponse.FromString,
        )

    def query(self, plan: LogicalPlan, database: str = "default"):
        from .columnbatch import ColumnBatch
        from .wal import ipc_to_arrow

        req = pb.QueryRequest(plan=plan_to_proto(plan), database=database)
        for resp in self._query(req):
            yield ColumnBatch.from_arrow(ipc_to_arrow(resp.record))
