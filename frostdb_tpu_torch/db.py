"""ColumnStore / DB / transaction watermark (reference: db.go, tx_list.go).

``ColumnStore`` is the process-wide store owning named DBs (db.go:86 New).
``DB`` owns tables, the transaction counter and high watermark (snapshot
isolation: readers see all txns <= watermark, db.go:1229-1273), the WAL and
snapshot machinery, and object-storage sources/sinks.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from .config import DEFAULT_DEVICE, resolve_device
from .table import PERSISTENCE_NOT_PORTED, Table, TableConfig


class TxPool:
    """Committed-txn watermark bubbling (reference: tx_list.go:55 TxPool).

    The reference keeps a lock-free list of committed txn ids and a cleaner
    goroutine advances the watermark over consecutive ids; here a mutex-held
    min-heap of out-of-order commits serves the same contract: the watermark
    only advances once every txn below it has committed.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._watermark = 0
        self._pending: set[int] = set()

    def insert(self, tx: int) -> None:
        with self._lock:
            self._pending.add(tx)
            while self._watermark + 1 in self._pending:
                self._pending.discard(self._watermark + 1)
                self._watermark += 1

    def watermark(self) -> int:
        with self._lock:
            return self._watermark

    def reset_to(self, tx: int) -> None:
        with self._lock:
            self._watermark = tx
            self._pending.clear()


class DB:
    def __init__(
        self,
        store: "ColumnStore",
        name: str,
        wal=None,
        sources=(),
        sinks=(),
        snapshot_trigger_size: int = 0,
        snapshot_dir: Optional[str] = None,
        device=None,
    ):
        self.store = store
        self.name = name
        # The torch device every table of this DB lives on (the store's
        # unless given).
        if device is None:
            device = store.device if store is not None else DEFAULT_DEVICE
        self.device = resolve_device(device)
        self.tables: dict[str, Table] = {}
        self._tx_counter = 0
        self._tx_lock = threading.Lock()
        self.tx_pool = TxPool()
        self.wal = wal
        self.sources = list(sources)
        self.sinks = list(sinks)
        self.snapshot_trigger_size = snapshot_trigger_size
        self.snapshot_dir = snapshot_dir
        self._snapshot_inserts = 0
        # Highest txn covered by a durable snapshot (written this process or
        # loaded at recovery). Feeds maintain_wal's truncation watermark.
        self.last_snapshot_tx = 0
        # Serializes write_snapshot: rotation workers and the insert thread
        # can both trigger snapshots concurrently; interleaved writes to the
        # same tmp/index paths could publish a valid-footer snapshot whose
        # linked index files another attempt deleted (silent loss).
        self._snapshot_lock = threading.Lock()

    # -- transactions (reference: db.go:1229 begin/beginRead) ------------

    def begin(self) -> int:
        with self._tx_lock:
            self._tx_counter += 1
            return self._tx_counter

    def commit(self, tx: int) -> None:
        self.tx_pool.insert(tx)

    def high_watermark(self) -> int:
        return self.tx_pool.watermark()

    def wait(self, tx: int) -> None:
        """Block until tx is visible (reference: db.go Wait)."""
        import time

        while self.high_watermark() < tx:
            time.sleep(0.0001)

    def reset_to_txn(self, tx: int) -> None:
        """reference: db.go:1276 resetToTxn (recovery)."""
        with self._tx_lock:
            self._tx_counter = max(self._tx_counter, tx)
        self.tx_pool.reset_to(tx)

    # -- tables ----------------------------------------------------------

    def table(self, name: str, config: TableConfig) -> Table:
        """Get or create (reference: db.go:1109 Table)."""
        t = self.tables.get(name)
        if t is not None:
            return t
        t = Table(self, name, config)
        if self.store is not None and self.store.metrics is not None:
            t.metrics = self.store.metrics.table_metrics(self.name, name)
        tx = self.begin()
        try:
            if self.wal is not None and not config.disable_wal:
                self.wal.log_new_table_block(
                    tx, name, t.active_block.id, config
                )
        finally:
            # Always commit (even on an EIO'd log): a holed txn would
            # freeze the watermark; writes are block-id-stamped so replay
            # does not depend on this advisory entry.
            self.commit(tx)
        self.tables[name] = t
        return t

    def get_table(self, name: str) -> Optional[Table]:
        return self.tables.get(name)

    def table_provider(self) -> "DBTableProvider":
        return DBTableProvider(self)

    # -- durability hooks -------------------------------------------------

    def maybe_snapshot(self, table: Table) -> None:
        if not self.snapshot_trigger_size or self.snapshot_dir is None:
            return
        size = sum(t.active_block.size() for t in self.tables.values())
        if size - self._snapshot_inserts >= self.snapshot_trigger_size:
            raise NotImplementedError(PERSISTENCE_NOT_PORTED)

    def maintain_wal(self) -> None:
        """Truncate the WAL live below the durable watermark (reference:
        db.go:1015-1051 maintainWAL).

        A WAL entry at tx T may be dropped once EVERY table's data at T is
        durable elsewhere: either the table's blocks containing T were
        persisted to a sink (tracked per table as ``persisted_tx``) or a
        snapshot at >= T covers the whole DB. The truncation point is
        therefore min over tables of max(table.persisted_tx,
        last_snapshot_tx); segment granularity means only whole segments
        strictly below it are removed."""
        if self.wal is None:
            return
        if self.tables:
            durable = min(
                max(t.persisted_tx, self.last_snapshot_tx)
                for t in self.tables.values()
            )
        else:
            durable = self.last_snapshot_tx
        if durable > 0:
            self.wal.truncate(durable + 1)
            if self.store is not None and self.store.metrics is not None:
                self.store.metrics.wal_truncations.inc()

    def join_background(self, timeout: float = 5.0) -> None:
        """Crash-simulation support: after ``wal.hard_kill``, wait for this
        (now dead) store's background threads to reach quiescence so a
        recovered store never races them on shared files."""
        for t in self.tables.values():
            t.join_background(timeout)

    def close(self) -> None:
        # Drain background block persists and compactions before the WAL
        # closes (the reference waits on writeBlock goroutines at Close,
        # db.go:617).
        err = None
        for t in self.tables.values():
            try:
                t.sync()
            except BaseException as e:
                err = err or e
        if self.wal is not None:
            self.wal.close()
        if err is not None:
            raise err


class DBTableProvider:
    """reference: db.go:1190 TableProvider."""

    def __init__(self, db: DB):
        self.db = db

    def get_table(self, name: str):
        return self.db.get_table(name)


class ColumnStore:
    """reference: db.go:86 New. In-memory only in this package: a storage
    path, a WAL, snapshots, sources or sinks raise NotImplementedError.

    ``device`` is the torch device every table's parts live on. The default
    is ``"cuda"``, which raises when no GPU is visible; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(
        self,
        storage_path: Optional[str] = None,
        enable_wal: bool = False,
        snapshot_trigger_size: int = 0,
        sources=(),
        sinks=(),
        metrics=None,
        background_threads: bool = True,
        device=DEFAULT_DEVICE,
    ):
        if storage_path is not None or enable_wal or snapshot_trigger_size:
            raise NotImplementedError(PERSISTENCE_NOT_PORTED)
        if sources or sinks:
            raise NotImplementedError(PERSISTENCE_NOT_PORTED)
        self.device = resolve_device(device)
        # Rotation persists and LSM compactions run on worker threads (the
        # reference's `go t.writeBlock` / `go l.compact`); False forces the
        # fully-synchronous single-threaded mode.
        self.background_threads = background_threads
        self.storage_path = None
        self.sources: list = []
        self.sinks: list = []
        self.fault_injector = None
        self.dbs: dict[str, DB] = {}
        if metrics is None:
            from .metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics

    def db_path(self, name: str) -> Optional[str]:
        return None

    def db(self, name: str) -> DB:
        """Open or create a database (reference: db.go:402 DB)."""
        d = self.dbs.get(name)
        if d is None:
            d = self.dbs[name] = DB(self, name, device=self.device)
        return d

    def close(self) -> None:
        for d in self.dbs.values():
            d.close()


def New(**kwargs) -> ColumnStore:
    return ColumnStore(**kwargs)
