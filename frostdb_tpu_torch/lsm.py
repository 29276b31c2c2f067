"""LSM index of immutable parts (reference: index/lsm.go, parts/part.go).

Parts are immutable column batches tagged with the transaction that created
them. L0 holds raw inserted batches (the reference's Arrow-record parts,
parts/arrow.go); higher levels hold compacted, sorted batches (the
reference's Parquet parts, parts/parquet.go). The reference's lock-free
linked list with CAS splicing (index/lsm.go:37,628) maps to a mutex-guarded
Python list here — the insert hot path on this engine is the device upload,
not list manipulation.

Scan order is newest-first within L0 then deeper levels, matching the
reference's head-first list iteration (index/lsm.go:401 Scan).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .columnbatch import ColumnBatch, KIND_DICT
from .device import DeviceBatch


class Part:
    """Immutable part (reference: parts/part.go:12 Part interface)."""

    def __init__(
        self,
        batch: ColumnBatch,
        tx: int,
        compaction_level: int = 0,
        device="cuda",
    ):
        self.batch = batch
        self.tx = tx
        self.compaction_level = compaction_level
        # The table's torch device: where device() uploads the batch.
        self.device_name = device
        self._device: Optional[DeviceBatch] = None
        self._zone_map: Optional[dict] = None
        self._raw_ranges: dict = {}
        self._code_presence: dict = {}

    def num_rows(self) -> int:
        return self.batch.num_rows

    def size_bytes(self) -> int:
        total = 0
        for c in self.batch.columns:
            total += c.values.nbytes + c.validity.nbytes
        return total

    def device(self) -> DeviceBatch:
        """Cached device mirror on the table's device — parts are immutable
        so the upload happens once and stays device-resident across
        queries."""
        if self._device is None:
            self._device = DeviceBatch(self.batch, self.device_name)
        return self._device

    def raw_range(self, name: str):
        """(min, max) over a column's raw values buffer *including* null
        slots — null slots participate in sums like the reference's
        raw-buffer sum (aggregate.go:763), so value-range bounds for the
        compiled digit decomposition must cover them. Cached: parts are
        immutable. Returns None if the column is absent or empty."""
        if name in self._raw_ranges:
            return self._raw_ranges[name]
        c = self.batch.column(name)
        r = None
        if c is not None and len(c.values):
            r = (int(c.values.min()), int(c.values.max()))
        self._raw_ranges[name] = r
        return r

    def float_sum_meta(self, name: str):
        """floatsum.column_meta over the column's raw slots, cached (parts
        are immutable) — the compiled/mesh exact-float-sum gate."""
        key = ("float_sum_meta", name)
        if key in self._raw_ranges:
            return self._raw_ranges[key]
        from .floatsum import column_meta

        c = self.batch.column(name)
        meta = column_meta(c.values if c is not None else np.zeros(0))
        self._raw_ranges[key] = meta
        return meta

    def float_minmax_meta(self, name: str):
        """(all_finite, has_negative_zero) over raw slots, cached — the
        gate for monotone-int64 float min/max on the dense/mesh tiers
        (-0.0 would make the total order visibly stricter than the
        generic engine's IEEE min/max on the -0/+0 pair)."""
        key = ("float_minmax_meta", name)
        if key in self._raw_ranges:
            return self._raw_ranges[key]
        c = self.batch.column(name)
        if c is None or not np.issubdtype(c.values.dtype, np.floating):
            meta = (False, True)
        else:
            v = c.values
            meta = (
                bool(np.isfinite(v).all()),
                bool(((v == 0.0) & np.signbit(v)).any()),
            )
        self._raw_ranges[key] = meta
        return meta

    def all_valid(self, name: str) -> bool:
        """Whether every slot of the column is valid — cached (parts are
        immutable): per-query serving must not rescan a 2M-row validity
        buffer per column (the compiled path's null-group-key gate)."""
        key = ("all_valid", name)
        if key in self._raw_ranges:
            return self._raw_ranges[key]
        c = self.batch.column(name)
        ok = bool(c is not None and c.validity.all())
        self._raw_ranges[key] = ok
        return ok

    def float_integral(self, name: str) -> bool:
        """True when every raw slot of a float64 column holds an integral
        value with |v| <= 2^53 (null slots are zero-filled and integral) —
        the gate for the compiled path's exact integer-mantissa float sums.
        Cached: parts are immutable."""
        key = ("float_integral", name)
        if key in self._raw_ranges:
            return self._raw_ranges[key]
        c = self.batch.column(name)
        ok = False
        if c is not None and np.issubdtype(c.values.dtype, np.floating):
            v = c.values
            ok = bool(
                np.all(np.isfinite(v))
                and np.all(np.abs(v) <= 2.0**53)
                and np.all(v == np.floor(v))
            )
        self._raw_ranges[key] = ok
        return ok

    def code_presence(self, name: str):
        """Set of dictionary codes present among a dict column's valid slots
        — the in-memory analogue of the reference's parquet dictionary/bloom
        pruning (query/expr/binaryscalarexpr.go:104: bloom filter first,
        then min/max). Cached: parts are immutable. Returns None for
        non-dict/absent columns."""
        if name in self._code_presence:
            return self._code_presence[name]
        c = self.batch.column(name)
        pres = None
        if c is not None and c.kind == KIND_DICT:
            pres = np.unique(c.values[c.validity])
        self._code_presence[name] = pres
        return pres

    def zone_map(self) -> dict:
        """Per-column min/max for scan pruning (the reference prunes row
        groups with parquet column indexes via TrueNegativeFilter,
        query/expr/filter.go:38; here zone maps are computed once per part).
        """
        if self._zone_map is None:
            zm: dict[str, tuple] = {}
            for c in self.batch.columns:
                if (
                    c.kind == KIND_DICT
                    or c.kind == "list"
                    or not c.validity.any()
                ):
                    continue
                vals = c.values[c.validity]
                if len(vals) == 0:
                    continue
                zm[c.name] = (vals.min(), vals.max())
            self._zone_map = zm
        return self._zone_map


@dataclass
class LevelConfig:
    """reference: index/lsm.go:71 LevelConfig."""

    level: int
    max_size: int
    compact: Optional[Callable[[list[Part]], list[Part]]] = None


class LSM:
    """reference: index/lsm.go:122."""

    def __init__(
        self,
        levels: Sequence[LevelConfig],
        on_compact=None,
        background: bool = False,
        device="cuda",
    ):
        self.configs = list(levels)
        self.device = device
        # parts per level, newest first.
        self.levels: list[list[Part]] = [[] for _ in range(len(self.configs))]
        self._lock = threading.Lock()
        self.on_compact = on_compact
        self.watermark: Callable[[], int] = lambda: 2**63
        self.compacting = threading.Lock()
        # Background compaction (the reference compacts in a goroutine,
        # index/lsm.go:341-348 `go l.compact`): inserts kick a worker and
        # return; `drain_compactions` is the sync point.
        self.background = background
        self._bg_cv = threading.Condition(self._lock)
        self._bg_running = False
        self._bg_again = False
        self._bg_error: BaseException | None = None

    def add(self, tx: int, batch: ColumnBatch) -> Part:
        """Prepend an L0 part (reference: index/lsm.go:332 Add)."""
        part = Part(batch, tx, 0, device=self.device)
        with self._lock:
            self.levels[0].insert(0, part)
        if self.background:
            self._schedule_compact()
        else:
            self.maybe_compact()
        return part

    def _schedule_compact(self) -> None:
        with self._lock:
            if self._bg_running:
                self._bg_again = True
                return
            self._bg_running = True
        threading.Thread(target=self._bg_loop, daemon=True).start()

    def _bg_loop(self) -> None:
        while True:
            try:
                self.maybe_compact()
            except BaseException as e:  # surfaced on the next add/drain
                with self._lock:
                    self._bg_error = e
            with self._lock:
                if not self._bg_again:
                    self._bg_running = False
                    self._bg_cv.notify_all()
                    return
                self._bg_again = False

    def drain_compactions(self) -> None:
        """Wait for in-flight background compaction to finish (the
        reference's sync points wait on the compaction waitgroup)."""
        with self._lock:
            while self._bg_running:
                self._bg_cv.wait(0.005)
            if self._bg_error is not None:
                err, self._bg_error = self._bg_error, None
                raise err

    def join_background(self, timeout: float = 5.0) -> None:
        """Crash-simulation support: wait (bounded) for the worker to stop,
        swallowing errors — a killed store's thread must reach quiescence
        before a recovered store reopens the same files (a real crash stops
        it instantly; an in-process simulation can only wait it out)."""
        import time as _t

        deadline = _t.monotonic() + timeout
        with self._lock:
            while self._bg_running and _t.monotonic() < deadline:
                self._bg_cv.wait(0.005)
            self._bg_error = None

    def insert_part(self, part: Part) -> None:
        """Insert an already-built part at its compaction level (reference:
        index/lsm.go:357 InsertPart, used by snapshot recovery)."""
        lvl = min(part.compaction_level, len(self.levels) - 1)
        with self._lock:
            self.levels[lvl].insert(0, part)

    def scan(self, tx: int) -> list[Part]:
        """Parts visible at tx, newest-first (reference: index/lsm.go:401)."""
        with self._lock:
            out = []
            for level in self.levels:
                for p in level:
                    if p.tx <= tx:
                        out.append(p)
            return out

    def level_size(self, level: int) -> int:
        with self._lock:
            return sum(p.size_bytes() for p in self.levels[level])

    def maybe_compact(self) -> None:
        """Cascade compaction when a level exceeds its max size (reference:
        index/lsm.go:653 compact)."""
        for cfg in self.configs[:-1]:
            if self.level_size(cfg.level) < cfg.max_size:
                continue
            self.compact_level(cfg.level)

    def compact_level(self, level: int) -> None:
        cfg = self.configs[level]
        if cfg.compact is None:
            return
        if not self.compacting.acquire(blocking=False):
            return
        try:
            # Watermark-bounded cut: only compact parts whose tx is visible
            # (reference: index/lsm.go:532 merge bounds by watermark).
            wm = self.watermark()
            with self._lock:
                eligible = [p for p in self.levels[level] if p.tx <= wm]
                if not eligible:
                    return
            compacted = cfg.compact(eligible)
            with self._lock:
                # Splice out exactly the compacted parts; parts prepended by
                # concurrent inserts while the merge ran must survive (the
                # reference's CAS list splice, index/lsm.go:628-633 —
                # a wholesale overwrite here loses them, caught by
                # tests/test_concurrency.py).
                elig_ids = {id(p) for p in eligible}
                self.levels[level] = [
                    p for p in self.levels[level] if id(p) not in elig_ids
                ]
                for p in reversed(compacted):
                    p.compaction_level = level + 1
                    self.levels[level + 1].insert(0, p)
            if self.on_compact is not None:
                self.on_compact(level)
        finally:
            self.compacting.release()

    def rotate(self, compact_fn) -> list[Part]:
        """Drain every part into a final compacted set for block persistence
        (reference: index/lsm.go:507 Rotate). Excludes an in-flight
        background compaction first: its splice would otherwise resurrect
        already-drained rows into the emptied levels."""
        with self.compacting:
            with self._lock:
                all_parts = [p for level in self.levels for p in level]
                self.levels = [[] for _ in range(len(self.configs))]
        if not all_parts:
            return []
        return compact_fn(all_parts)

    def snapshot(self) -> list[Part]:
        """Stable view of all parts (reference: index/lsm.go:255)."""
        with self._lock:
            return [p for level in self.levels for p in level]

    def num_parts(self) -> int:
        with self._lock:
            return sum(len(l) for l in self.levels)


def _dict_match_lut(dictionary, op: str, lit, memo: Optional[dict]) -> Optional[np.ndarray]:
    """Boolean LUT over a table-global dictionary's values: which values can
    satisfy ``value <op> lit``. Memoized per query (the dictionary is shared
    across all of a table's parts, so one evaluation serves every part — the
    reference evaluates string predicates once per parquet dictionary page,
    binaryscalarexpr.go:104 dictionary path). Returns None when the op
    cannot be reduced to a per-value test."""
    import re as _re

    from .query import expr as E

    key = (id(dictionary), op, lit)
    if memo is not None and key in memo:
        lut = memo[key]
        if lut is None or len(lut) >= len(dictionary):
            return lut
    vals = dictionary.values
    if op == E.OP_EQ:
        lut = np.fromiter((v == lit for v in vals), dtype=np.bool_, count=len(vals))
    elif op == E.OP_NOT_EQ:
        lut = np.fromiter((v != lit for v in vals), dtype=np.bool_, count=len(vals))
    elif op == E.OP_REGEX_MATCH or op == E.OP_REGEX_NOT_MATCH:
        rx = _re.compile(str(lit))
        lut = np.fromiter(
            (rx.search(v) is not None for v in vals), dtype=np.bool_, count=len(vals)
        )
        if op == E.OP_REGEX_NOT_MATCH:
            lut = ~lut
    elif op == E.OP_CONTAINS or op == E.OP_NOT_CONTAINS:
        s = str(lit)
        lut = np.fromiter((s in v for v in vals), dtype=np.bool_, count=len(vals))
        if op == E.OP_NOT_CONTAINS:
            lut = ~lut
    elif op in (E.OP_LT, E.OP_LT_EQ, E.OP_GT, E.OP_GT_EQ):
        s = str(lit)
        cmp = {
            E.OP_LT: lambda v: v < s,
            E.OP_LT_EQ: lambda v: v <= s,
            E.OP_GT: lambda v: v > s,
            E.OP_GT_EQ: lambda v: v >= s,
        }[op]
        lut = np.fromiter((cmp(v) for v in vals), dtype=np.bool_, count=len(vals))
    else:
        lut = None
    if memo is not None:
        memo[key] = lut
    return lut


def prune_part(part: Part, filter_expr, memo: Optional[dict] = None) -> bool:
    """True if the part can definitely not contain matching rows — the
    TrueNegativeFilter contract (reference: query/expr/filter.go:38: false
    negatives are forbidden, false positives are fine). Numeric columns
    prune on zone maps; dict/string columns prune on per-part code-presence
    sets against a memoized dictionary-value LUT (the reference's parquet
    bloom-filter + dictionary pruning, binaryscalarexpr.go:104-110). Pass a
    per-query ``memo`` dict to share LUTs across parts."""
    import re as _re

    from .query import expr as E

    if filter_expr is None:
        return False

    zm = part.zone_map()

    def dict_cannot_match(e) -> bool:
        name = e.left.column_name
        lit = e.right.value
        col = part.batch.column(name)
        if col is None:
            # Missing dynamic column = all-null. Prune exactly where the
            # shared missing-column semantics yield an all-false mask
            # (physeval.missing_column_all_true — the single source of
            # truth for all engine paths); an invalid regex is never a
            # provable negative.
            from .query.physeval import missing_column_all_true

            try:
                return not missing_column_all_true(e.op, lit)
            except _re.error:
                return False
        if col.kind != KIND_DICT or lit is None or not isinstance(lit, str):
            return False
        presence = part.code_presence(name)
        if presence is None:
            return False
        if e.op == E.OP_EQ:
            code = col.dictionary.lookup(lit)
            if code is None:
                return True
            return not np.isin(code, presence).item()
        try:
            lut = _dict_match_lut(col.dictionary, e.op, lit, memo)
        except _re.error:
            return False
        if lut is None or len(lut) == 0:
            return False
        pres = presence[presence < len(lut)]
        if len(pres) < len(presence):
            return False  # codes beyond the cached LUT: can't prove negative
        return not lut[pres].any()

    def cannot_match(e) -> bool:
        if isinstance(e, E.BinaryExpr):
            if e.op == E.OP_AND:
                return cannot_match(e.left) or cannot_match(e.right)
            if e.op == E.OP_OR:
                return cannot_match(e.left) and cannot_match(e.right)
            if isinstance(e.left, (E.Column,)) and isinstance(e.right, E.Literal):
                name = e.left.column_name
                lit = e.right.value
                if isinstance(lit, str) or e.op in (
                    E.OP_REGEX_MATCH,
                    E.OP_REGEX_NOT_MATCH,
                    E.OP_CONTAINS,
                ):
                    return dict_cannot_match(e)
                if name not in zm or lit is None:
                    return False
                lo, hi = zm[name]
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

    return cannot_match(filter_expr)
