"""Object-storage block persistence (reference: store.go).

Blocks are Parquet files at ``<db>/<table>/<block_id>/data.parquet``
(store.go:30-62 Persist). ``FileSystemBucket`` plays the role of the
thanos-objstore bucket (store.go:64 DefaultObjstoreBucket): it is a
DataSink (upload blocks on rotation) and a DataSource (scan persisted
blocks, pruning row groups whose statistics cannot match the filter — the
TrueNegativeFilter contract, store.go:243 filterRowGroups).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .columnbatch import ColumnBatch
from .query import expr as E
from .schema import Schema


class FileSystemBucket:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- DataSink (reference: db.go:381 DataSink) -------------------------

    def block_path(self, db: str, table: str, block_id: str) -> str:
        return os.path.join(self.root, db, table, block_id, "data.parquet")

    def upload_block(
        self, db: str, table: str, block_id: str, batch: ColumnBatch, schema: Schema
    ) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        path = self.block_path(db, table, block_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rb = batch.to_arrow()
        t = pa.Table.from_batches([rb])
        meta = {
            b"frostdb_tpu.schema": json.dumps(schema.def_.to_dict()).encode(),
        }
        t = t.replace_schema_metadata(meta)
        tmp = path + ".tmp"
        pq.write_table(t, tmp, compression="zstd")
        os.replace(tmp, path)

    # -- DataSource (reference: db.go:374 DataSource) ---------------------

    def prefixes(self, db: str) -> list[str]:
        """Table names present under the db prefix (db.go:494 read-only
        tables discovery)."""
        p = os.path.join(self.root, db)
        if not os.path.isdir(p):
            return []
        return sorted(os.listdir(p))

    def blocks(self, db: str, table: str) -> list[str]:
        p = os.path.join(self.root, db, table)
        if not os.path.isdir(p):
            return []
        return sorted(os.listdir(p))

    # -- block-granular source API (reference: store.go:123 the bucket block
    # cache/dedup — blocks are listed per query but each block's bytes are
    # read ONCE and cached as device-resident parts by the table layer) ----

    def list_blocks(self, db: str, table: str) -> list[tuple[str, str]]:
        """(block_id, opaque ref) pairs for every persisted block."""
        out = []
        for block_id in self.blocks(db, table):
            path = self.block_path(db, table, block_id)
            if os.path.exists(path):
                out.append((block_id, path))
        return out

    def read_block_parts(self, ref: str, schema: Schema, get_dictionary):
        """One ColumnBatch per row group (row-group granularity keeps the
        per-part zone-map pruning as fine as the reference's row-group
        statistics pruning, store.go:243)."""
        import pyarrow.parquet as pq

        f = pq.ParquetFile(ref)
        out = []
        for g in range(f.metadata.num_row_groups):
            t = f.read_row_group(g)
            out.append(ColumnBatch.from_arrow(t, get_dictionary=get_dictionary))
        return out

    def block_schema(self, ref: str) -> Optional[Schema]:
        """Schema persisted in the block's parquet metadata (the read-only
        table discovery hook, db.go:494-508)."""
        import pyarrow.parquet as pq

        from .schema import SchemaDef

        meta = pq.ParquetFile(ref).schema_arrow.metadata or {}
        raw = meta.get(b"frostdb_tpu.schema")
        if raw is None:
            return None
        return Schema(SchemaDef.from_dict(json.loads(raw.decode())))

    def scan(
        self,
        db: str,
        table: str,
        schema: Schema,
        filter: Optional[E.Expr],
        get_dictionary,
        exclude_block_ids: Iterable[str] = (),
    ) -> list[ColumnBatch]:
        """Read persisted blocks into column batches, skipping row groups
        whose parquet statistics cannot satisfy the filter."""
        import pyarrow.parquet as pq

        out: list[ColumnBatch] = []
        exclude = set(exclude_block_ids)
        for block_id in self.blocks(db, table):
            if block_id in exclude:
                continue
            path = self.block_path(db, table, block_id)
            if not os.path.exists(path):
                continue
            f = pq.ParquetFile(path)
            keep_groups = [
                g
                for g in range(f.metadata.num_row_groups)
                if not _prune_row_group(f.metadata, g, f.schema_arrow, filter)
            ]
            if not keep_groups:
                continue
            t = f.read_row_groups(keep_groups)
            out.append(ColumnBatch.from_arrow(t, get_dictionary=get_dictionary))
        return out


def _prune_row_group(meta, group: int, arrow_schema, filter: Optional[E.Expr]) -> bool:
    """True negative test on row-group statistics (reference:
    query/expr/filter.go BooleanExpr.Eval over Particulates)."""
    if filter is None:
        return False

    rg = meta.row_group(group)
    stats: dict[str, tuple] = {}
    for i in range(rg.num_columns):
        col = rg.column(i)
        s = col.statistics
        if s is None or not s.has_min_max:
            continue
        name = col.path_in_schema
        stats[name] = (s.min, s.max)

    def cannot_match(e: E.Expr) -> bool:
        if isinstance(e, E.BinaryExpr):
            if e.op == E.OP_AND:
                return cannot_match(e.left) or cannot_match(e.right)
            if e.op == E.OP_OR:
                return cannot_match(e.left) and cannot_match(e.right)
            if isinstance(e.left, E.Column) and isinstance(e.right, E.Literal):
                name = e.left.column_name
                lit = e.right.value
                if name not in stats or lit is None:
                    return False
                lo, hi = stats[name]
                if isinstance(lit, str):
                    if isinstance(lo, bytes):
                        lo = lo.decode("utf-8", "surrogateescape")
                    if isinstance(hi, bytes):
                        hi = hi.decode("utf-8", "surrogateescape")
                try:
                    if e.op == E.OP_EQ:
                        return lit < lo or lit > hi
                    if e.op == E.OP_GT:
                        return hi <= lit
                    if e.op == E.OP_GT_EQ:
                        return hi < lit
                    if e.op == E.OP_LT:
                        return lo >= lit
                    if e.op == E.OP_LT_EQ:
                        return lo > lit
                except TypeError:
                    return False
        return False

    return cannot_match(filter)
