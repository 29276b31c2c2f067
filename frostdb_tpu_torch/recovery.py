"""Crash recovery: snapshot load + two-pass WAL replay (reference:
db.go:670 recover; replay strategy documented in design/wal.md:33-41).

Pass 1 collects TableBlockPersisted entries so writes belonging to already-
persisted blocks are skipped; pass 2 recreates tables/blocks and re-inserts
surviving writes. The resulting watermark is max(snapshot tx, last WAL tx)
(db.go:902-912 resume invariant).
"""

from __future__ import annotations

import os

from .columnbatch import ColumnBatch
from .table import TableConfig
from .wal import (
    KIND_NEW_TABLE_BLOCK,
    KIND_SNAPSHOT,
    KIND_TABLE_BLOCK_PERSISTED,
    KIND_WRITE,
    ipc_to_arrow,
)


def recover_db(db, path: str) -> None:
    from .snapshot import load_snapshot

    snapshot_tx = 0
    if db.snapshot_dir is not None:
        snapshot_tx = load_snapshot(db, db.snapshot_dir)
        db.last_snapshot_tx = snapshot_tx

    if db.wal is None:
        if snapshot_tx:
            db.reset_to_txn(snapshot_tx)
        return

    # Truncate the WAL below the snapshot (db.go:701).
    if snapshot_tx:
        db.wal.truncate(snapshot_tx + 1)

    # Pass 1: find persisted blocks (design/wal.md:33). A block can also be
    # proven persisted by its presence in the object-storage bucket — the
    # WAL entry may live in a truncated segment (the reference dedups bucket
    # blocks against in-memory blocks by ULID timestamp, store.go:123).
    persisted: dict[str, set[str]] = {}
    # Block boundaries must come from the FULL wal: a write after the
    # snapshot can belong to a block whose NewTableBlock entry precedes it
    # (caught by the DST: snapshot -> write -> rotate+persist -> restart
    # double-counted the write).
    block_boundaries: dict[str, list[tuple[int, str]]] = {}

    def pass1(header: dict, body: bytes) -> None:
        if header["kind"] == KIND_TABLE_BLOCK_PERSISTED:
            persisted.setdefault(header["table"], set()).add(header["block_id"])
        elif header["kind"] == KIND_NEW_TABLE_BLOCK:
            block_boundaries.setdefault(header["table"], []).append(
                (header["tx"], header["block_id"])
            )

    db.wal.replay(pass1, from_tx=0)

    for bounds in block_boundaries.values():
        bounds.sort(key=lambda b: b[0])

    def block_for_write(table_name: str, tx: int) -> str | None:
        blk = None
        for btx, bid in block_boundaries.get(table_name, ()):
            if btx <= tx:
                blk = bid
            else:
                break
        return blk

    for source in db.sources:
        if not hasattr(source, "blocks"):
            continue
        for tname in list(db.tables) + source.prefixes(db.name):
            for block_id in source.blocks(db.name, tname):
                persisted.setdefault(tname, set()).add(block_id)

    # Snapshot-restored blocks that were later persisted would double-count
    # with the bucket scan: drop them and start a fresh active block.
    from .table import TableBlock

    for name, table in db.tables.items():
        if table.active_block.id in persisted.get(name, set()):
            table.active_block = TableBlock(
                table, _fresh_block_id(), min_tx=snapshot_tx
            )
        # Snapshot-restored PENDING blocks the bucket already owns would
        # double-count with the bucket scan the same way.
        with table._lock:
            table.pending_blocks = [
                b
                for b in table.pending_blocks
                if b.id not in persisted.get(name, set())
            ]

    # Pass 2: recreate tables and re-insert surviving writes.
    current_block: dict[str, str] = {}
    last_tx = snapshot_tx

    def pass2(header: dict, body: bytes) -> None:
        nonlocal last_tx
        tx = header["tx"]
        last_tx = max(last_tx, tx)
        kind = header["kind"]
        if kind == KIND_NEW_TABLE_BLOCK:
            config = TableConfig.from_dict(header["config"])
            name = header["table"]
            table = db.tables.get(name)
            if table is None:
                table = _create_table_no_wal(db, name, config)
            current_block[name] = header["block_id"]
            table.active_block.id = header["block_id"]
            # Replayed writes rebuild this block from scratch; stale on-disk
            # index frames from the previous run would double-count at the
            # next snapshot link.
            table.active_block.reattach_disk()
            if table.active_block.disk_level is not None:
                table.active_block.disk_level.delete_all()
        elif kind == KIND_WRITE:
            name = header["table"]
            table = db.tables.get(name)
            if table is None:
                return
            block = (
                header.get("block_id")
                or block_for_write(name, tx)
                or table.active_block.id
            )
            if block in persisted.get(name, set()):
                return  # write already persisted to object storage
            rb = ipc_to_arrow(body)
            batch = ColumnBatch.from_arrow(rb, get_dictionary=table.dictionary)
            table.active_block.index.add(tx, batch)
        elif kind == KIND_SNAPSHOT:
            pass

    db.wal.replay(pass2, from_tx=snapshot_tx + 1)

    # A kill can lose the rotation's queued NewTableBlock entry while the
    # block upload itself completed: replay then ends with an active block
    # whose id the bucket already owns. Re-identify it (keeping the replayed
    # parts) — otherwise new writes get stamped with a persisted block id
    # and the NEXT recovery silently skips them (caught by the crash DST,
    # seed 137: 95 durable rows lost).
    for name, table in db.tables.items():
        if table.active_block.id in persisted.get(name, set()):
            if table.active_block.disk_level is not None:
                # Stale spills under the persisted id would double-count
                # with the bucket copy on a future snapshot link.
                table.active_block.disk_level.delete_all()
            table.active_block.id = _fresh_block_id()
            table.active_block.reattach_disk()
        # Resume persists for snapshot-restored pending blocks (their
        # rotation's upload never completed): upto=0 keeps persisted_tx
        # conservative — the WAL holds their entries until a snapshot or
        # their own persist marker covers them.
        if db.sinks:
            with table._lock:
                pend = list(table.pending_blocks)
            for b in pend:
                table.enqueue_persist(b, 0)

    db.reset_to_txn(max(snapshot_tx, last_tx))


def _fresh_block_id() -> str:
    import uuid

    return str(uuid.uuid4())


def _create_table_no_wal(db, name: str, config: TableConfig):
    """Create a table during replay without logging a fresh WAL entry."""
    from .table import Table

    t = Table(db, name, config)
    if db.store is not None and db.store.metrics is not None:
        t.metrics = db.store.metrics.table_metrics(db.name, name)
    db.tables[name] = t
    return t
