"""Lightweight metrics registry (reference: metrics.go — prometheus counters,
gauges and histograms for ingest, WAL, snapshots, LSM levels).

Prometheus-compatible exposition via ``MetricsRegistry.expose()`` (text
format) without requiring the prometheus client library.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def value(self) -> float:
        return self._value


class Gauge(Counter):
    def set(self, v: float) -> None:
        with self._lock:
            self._value = v


@dataclass
class TableMetrics:
    """reference: metrics.go:238-263 per-table ingest metrics."""

    rows_inserted: Counter
    zero_rows_inserted: Counter
    rotations: Counter
    active_block_size: Gauge
    # Scan-pruning effectiveness (the reference counts row groups skipped by
    # TrueNegativeFilter via tracing; here explicit counters).
    parts_scanned: Counter
    parts_pruned: Counter


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, Counter] = {}
        self._lock = threading.Lock()
        # Store-wide durability metrics (reference: metrics.go:140-300 — WAL
        # record/truncation/repair counters, snapshot counters, LSM
        # compactions per level).
        self.wal_records_logged = self.counter(
            "frostdb_tpu_wal_records_logged_total"
        )
        self.wal_truncations = self.counter(
            "frostdb_tpu_wal_truncations_total"
        )
        self.wal_repairs = self.counter("frostdb_tpu_wal_repairs_total")
        self.snapshots_total = self.counter("frostdb_tpu_snapshots_total")
        self.snapshot_bytes = self.counter(
            "frostdb_tpu_snapshot_bytes_written_total"
        )

    def lsm_compactions(self, level: int) -> Counter:
        return self.counter(
            f'frostdb_tpu_lsm_compactions_total{{level="{level}"}}'
        )

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help_)
                self._metrics[name] = m
            return m

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name, help_)
                self._metrics[name] = m
            return m

    def table_metrics(self, db: str, table: str) -> TableMetrics:
        p = f'frostdb_tpu_table{{db="{db}",table="{table}"}}'
        return TableMetrics(
            rows_inserted=self.counter(f"rows_inserted_{p}"),
            zero_rows_inserted=self.counter(f"zero_rows_inserted_{p}"),
            rotations=self.counter(f"rotations_{p}"),
            active_block_size=self.gauge(f"active_block_size_{p}"),
            parts_scanned=self.counter(f"parts_scanned_{p}"),
            parts_pruned=self.counter(f"parts_pruned_{p}"),
        )

    def expose(self) -> str:
        lines = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                lines.append(f"{name} {m.value()}")
        return "\n".join(lines) + "\n"
