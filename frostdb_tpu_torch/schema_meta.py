"""Schema-scan serving from metadata (port of ``frostdb_tpu/schema_meta.py``):
the Parca Labels shape answered in pure host work, no device round-trip.

``scan_schema(t).distinct(Col("name")).filter(name =~ ...)`` (reference:
table.go:872 SchemaIterator; the Labels bench query bench_test.go:264-300)
asks for the distinct concrete column NAMES across the table's parts —
pure part metadata. The generic pipeline nevertheless routes the tiny name
batches through the device Distinction (an upload, a device distinct and a
copy back per query); this tier mirrors ``table.schema_iterator`` +
``Distinction`` + ``PredicateFilter`` exactly on the host:

- the same snapshot view (``table.view``) and part enumeration order
  (memory parts, then source parts) as SchemaScanExec,
- the same shared output dictionary (every part's names encoded in stream
  order, matching schema_iterator's per-part ``d.encode``),
- distinct = first occurrence over the concatenated name stream
  (kernels.distinct_rows semantics),
- filters evaluated with the generic engine's own ``filter_mask``.

Results are byte-identical to the operator DAG, including dictionary code
assignment and emission order.
"""

from __future__ import annotations

from .columnbatch import Column, ColumnBatch, Dictionary, KIND_DICT
from .compiled import NotCompilable
from .query import expr as E


class SchemaMetaDistinct:
    SPAN = "schema_meta/execute"

    def __init__(self, table, filters: list):
        self.table = table
        self.filters = filters  # bottom-up order (applied in chain order)

    def execute(self) -> ColumnBatch:
        from .query.physeval import filter_mask
        from .tracing import span as _span

        with _span(self.SPAN, table=self.table.name):
            holder: dict = {}

            def run(tx):
                parts = self.table.collect_parts(tx)
                sp = (
                    self.table.source_parts()
                    if self.table.db is not None
                    else []
                )
                if sp is not None:
                    parts = parts + sp
                holder["parts"] = parts

            self.table.view(run)
            d = Dictionary()
            order: list[str] = []
            seen: set[str] = set()
            for part in holder.get("parts", []):
                names = part.batch.column_names()
                # keep dictionary code assignment identical to
                # schema_iterator's per-part encode
                d.encode(names)
                for nm in names:
                    if nm not in seen:
                        seen.add(nm)
                        order.append(nm)
            codes, valid = d.encode(order)
            batch = ColumnBatch(
                [Column("name", KIND_DICT, codes, valid, d)], len(order)
            )
            for fe in self.filters:
                if batch.num_rows == 0:
                    break
                mask = filter_mask(batch, fe)
                batch = batch.select_mask(mask)
            return batch


def lower_plan_schema(plan, exec_options=None) -> SchemaMetaDistinct:
    """Match ``SchemaScan <- [Filter]* <- Distinct(Col name) <- [Filter]*``
    (the Labels shape and its filter-position variants)."""
    node = plan
    filters: list = []
    distinct = None
    while node is not None and node.schema_scan is None:
        if node.filter is not None:
            filters.append(node.filter.expr)
        elif node.distinct is not None:
            if distinct is not None:
                raise NotCompilable("multiple distinct nodes")
            distinct = node.distinct
        else:
            raise NotCompilable("schema tier serves distinct+filters only")
        node = node.input
    if node is None or node.schema_scan is None:
        raise NotCompilable("not a schema scan")
    if distinct is None:
        raise NotCompilable("schema tier needs a distinct node")
    exprs = distinct.exprs
    if len(exprs) != 1 or type(exprs[0]) is not E.Column or (
        exprs[0].column_name != "name"
    ):
        raise NotCompilable("schema distinct is not on the name column")
    scan = node.schema_scan
    table = scan.provider.get_table(scan.table_name)
    if table is None:
        raise NotCompilable(f"table not found: {scan.table_name}")
    filters.reverse()  # bottom-up, matching operator chain order
    return SchemaMetaDistinct(table, filters)
