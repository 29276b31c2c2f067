"""Write-ahead log (reference: wal/wal.go FileWAL).

Append-only segment files of binary-framed entries (the reference frames
protobuf records in its segment store; JSON framing was the round-1
bootstrap). Each entry:

    [u8 magic=0xF5][u8 kind][u16 table_len][u16 block_id_len]
    [u32 body_len][u64 tx][u32 crc32(prefix+payload)]
    [table][block_id][body]

The body of a "write" entry is the record batch as Arrow IPC (the
reference serializes Arrow IPC inside its protobuf Entry_Write,
wal/wal.go:558 LogRecord); a "new_table_block" body is the JSON table
config (persisted in the WAL and restored on replay, db.go:747-760).

Entries are appended in transaction order; replay tolerates a corrupt tail
by truncating at the first bad frame (the reference's segment self-repair,
wal/wal.go:216 repairs_total). Batching/fsync policy: entries are buffered
and flushed per log call by default (``sync=True``); ``sync=False`` defers
to an explicit flush, mirroring the reference's async batcher
(wal/wal.go:360 process loop).
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import zlib
from typing import Callable, Optional

KIND_WRITE = "write"
KIND_NEW_TABLE_BLOCK = "new_table_block"
KIND_TABLE_BLOCK_PERSISTED = "table_block_persisted"
KIND_SNAPSHOT = "snapshot"

_KIND_CODES = {
    KIND_WRITE: 0,
    KIND_NEW_TABLE_BLOCK: 1,
    KIND_TABLE_BLOCK_PERSISTED: 2,
    KIND_SNAPSHOT: 3,
}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}

class WALUnknownFormatError(Exception):
    """A WAL segment does not start with a recognizable frame. Refusing to
    replay protects against silently truncating an entire segment written by
    a different (older/newer) framing version — truncation-based self-repair
    only applies to a torn *tail* behind at least one valid frame."""


_MAGIC = 0xF5
# magic u8 | kind u8 | table_len u16 | block_id_len u16 | body_len u32 | tx u64
_PREFIX = struct.Struct("<BBHHIQ")
_CRC = struct.Struct("<I")
SEGMENT_MAX_BYTES = 8 * 1024 * 1024


def batch_to_ipc(batch) -> bytes:
    import pyarrow as pa

    rb = batch.to_arrow()
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return sink.getvalue()


def ipc_to_arrow(data: bytes) -> "pa.RecordBatch":
    import pyarrow as pa

    with pa.ipc.open_stream(io.BytesIO(data)) as r:
        batches = [b for b in r]
    if len(batches) == 1:
        return batches[0]
    return pa.Table.from_batches(batches).combine_chunks().to_batches()[0]


class FileWAL:
    def __init__(
        self,
        directory: str,
        sync: bool = True,
        segment_size: int = SEGMENT_MAX_BYTES,
        repair_counter=None,
        injector=None,
    ):
        """sync=True: every entry is fsync'd before the call returns.
        sync=False: entries enqueue to a background batcher thread that
        drains them in tx order and fsyncs once per batch — the reference's
        async process loop (wal/wal.go:360 pops a tx-ordered heap and
        batches into the segment store). ``segment_size`` bounds a segment
        file; truncation is segment-granular, so smaller segments reclaim
        sooner (the reference's segment store works the same way)."""
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.sync = sync
        self.segment_size = segment_size
        self._lock = threading.Lock()
        self._file: Optional[io.BufferedWriter] = None
        self._segment_start_tx = 0
        self._segment_size = 0
        self.repairs = 0
        self.repairs_lost_records = 0
        # Registry counter mirroring ``repairs`` (reference: repairs_total,
        # wal/wal.go:216) so repairs surface in MetricsRegistry.expose().
        self._repair_counter = repair_counter
        # Write-fault injection (reference: dst/vfs/fs.go:24) — EIO raised
        # mid-append; the write sites truncate back to their pre-write size
        # so an injected fault can never leave a torn MIDDLE for replay.
        self._injector = injector
        self._queue: list[tuple[int, bytes]] = []
        self._cv = threading.Condition()
        self._closing = False
        self._killed = False
        self._thread: Optional[threading.Thread] = None
        if not sync:
            self._thread = threading.Thread(
                target=self._process_loop, name="frostdb-wal", daemon=True
            )
            self._thread.start()

    def _process_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait()
                if self._killed:
                    return
                batch = self._queue
                self._queue = []
                closing = self._closing
            if batch:
                batch.sort(key=lambda e: e[0])
                failed_at = None
                with self._lock:
                    for i, (tx, frame) in enumerate(batch):
                        try:
                            # _open_segment inside the try: an EIO from the
                            # previous segment's final fsync must re-queue
                            # this batch, not kill the worker thread (which
                            # would silently drop acked-but-unwritten
                            # entries with no crash having happened).
                            if (
                                self._file is None
                                or self._segment_size > self.segment_size
                            ):
                                self._open_segment(tx)
                            self._write_frame_rollback(frame)
                        except OSError:
                            failed_at = i
                            break
                    if self._file is not None:
                        self._file.flush()
                        try:
                            os.fsync(self._file.fileno())
                        except OSError:
                            pass  # retried by the next batch / close()
                with self._cv:
                    if failed_at is not None:
                        # Re-queue the failed frame and everything after it;
                        # the batcher retries on its next wakeup (acks in
                        # async mode precede durability anyway — entries are
                        # lossable only at a crash, never silently dropped).
                        self._queue = batch[failed_at:] + self._queue
                    self._cv.notify_all()
                if failed_at is not None:
                    import time as _t

                    _t.sleep(0.001)
            if closing and not batch:
                return

    # -- segment management ------------------------------------------------

    def _segments(self) -> list[str]:
        segs = [
            f
            for f in os.listdir(self.dir)
            if f.endswith(".wal") and f[:-4].isdigit()
        ]
        return sorted(segs)

    def _open_segment(self, first_tx: int) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        path = os.path.join(self.dir, f"{first_tx:020d}.wal")
        self._file = open(path, "ab")
        self._segment_start_tx = first_tx
        self._segment_size = 0

    # -- logging -----------------------------------------------------------

    def _append(
        self,
        tx: int,
        kind: str,
        body: bytes,
        table: str = "",
        block_id: str = "",
    ) -> None:
        if self._killed:
            # Simulated process death (hard_kill): a handle held by a
            # lingering background worker must be inert — a real crash
            # takes its threads with it.
            return
        tb = table.encode("utf-8")
        bb = block_id.encode("utf-8")
        prefix = _PREFIX.pack(
            _MAGIC, _KIND_CODES[kind], len(tb), len(bb), len(body), tx
        )
        payload = tb + bb + body
        crc = zlib.crc32(prefix + payload) & 0xFFFFFFFF
        frame = prefix + _CRC.pack(crc) + payload
        if not self.sync and self._thread is not None:
            with self._cv:
                self._queue.append((tx, frame))
                self._cv.notify_all()
            return
        with self._lock:
            if self._file is None or self._segment_size > self.segment_size:
                self._open_segment(tx)
            self._write_frame_rollback(frame)
            if self.sync:
                self._file.flush()
                pre = os.fstat(self._file.fileno()).st_size
                from .faults import faulty_fsync

                try:
                    faulty_fsync(
                        self._file.fileno(), self._injector, "wal fsync"
                    )
                except OSError:
                    # Not provably durable: roll the frame back so the ack
                    # contract (sync=True ⇒ durable) holds.
                    self._rollback_to(pre - len(frame))
                    self._segment_size -= len(frame)
                    raise

    def _write_frame_rollback(self, frame: bytes) -> None:
        """Append one frame; on (injected or real) EIO, truncate back to the
        pre-write size — replay's torn-tail repair only handles tears at the
        END, so a failed append must never be followed by more appends."""
        from .faults import faulty_append

        # fstat, not tell(): a prior rollback truncate leaves the buffered
        # position stale, and an overstated pre-size would strand a torn
        # frame in the MIDDLE of the segment (caught by the EIO DST).
        self._file.flush()
        pre = os.fstat(self._file.fileno()).st_size
        try:
            faulty_append(self._file, frame, self._injector, "wal append")
        except OSError:
            self._rollback_to(pre)
            raise
        self._segment_size += len(frame)

    def _rollback_to(self, size: int) -> None:
        try:
            self._file.flush()
        except OSError:
            pass
        try:
            self._file.truncate(max(size, 0))
        except OSError:
            pass

    def log_record(self, tx: int, table: str, batch, block_id: str = "") -> None:
        # The owning block id is stamped on every write so recovery can skip
        # persisted-block writes even when the block's NewTableBlock entry
        # lives in a truncated segment (caught by the DST).
        self._append(
            tx, KIND_WRITE, batch_to_ipc(batch), table=table, block_id=block_id
        )

    def log_new_table_block(self, tx: int, table: str, block_id: str, config) -> None:
        self._append(
            tx,
            KIND_NEW_TABLE_BLOCK,
            json.dumps(config.to_dict()).encode("utf-8"),
            table=table,
            block_id=block_id,
        )

    def log_table_block_persisted(self, tx: int, table: str, block_id: str) -> None:
        self._append(
            tx, KIND_TABLE_BLOCK_PERSISTED, b"", table=table, block_id=block_id
        )

    def log_snapshot(self, tx: int) -> None:
        self._append(tx, KIND_SNAPSHOT, b"")

    def flush(self) -> None:
        if self._killed:
            return  # dead handle (see _append)
        if not self.sync and self._thread is not None:
            with self._cv:
                self._cv.notify_all()
                while self._queue:
                    self._cv.wait(timeout=0.5)
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())

    def _repair(self) -> None:
        self.repairs += 1
        if self._repair_counter is not None:
            self._repair_counter.inc()

    # -- replay ------------------------------------------------------------

    def replay(
        self,
        handler: Callable[[dict, bytes], None],
        from_tx: int = 0,
        repair: bool = True,
    ) -> int:
        """Replay entries with tx >= from_tx in global transaction order;
        returns the max tx seen (reference: wal/wal.go:618 Replay; the
        reference's writer enforces tx order at log time via its heap,
        wal/wal.go:360 — here replay sorts, which also tolerates entries
        appended out of order across segment boundaries). Corrupt tails
        truncate (self-repair, wal/wal.go:216) when ``repair`` is set;
        read-only inspection (dbtool) passes repair=False to leave segment
        bytes untouched.

        Version safety: a segment whose FIRST frame is unreadable (bad magic)
        raises ``WALUnknownFormatError`` instead of truncating — a framing
        change must never masquerade as a torn tail and silently drop a
        whole segment. Frames with a valid CRC but an unknown kind code
        (written by a newer version) are skipped, not treated as corruption."""
        self.flush()
        max_tx = 0
        collected: list[tuple[int, dict, bytes]] = []
        for seg in self._segments():
            path = os.path.join(self.dir, seg)
            with open(path, "rb") as f:
                data = f.read()
            pos = 0
            good_end = 0
            hsize = _PREFIX.size + _CRC.size
            while pos + hsize <= len(data):
                prefix = data[pos : pos + _PREFIX.size]
                magic, kcode, tlen, blen, body_len, tx = _PREFIX.unpack(prefix)
                if magic != _MAGIC:
                    if good_end == 0:
                        raise WALUnknownFormatError(
                            f"{path}: segment does not start with a "
                            f"recognizable WAL frame (magic "
                            f"0x{magic:02X} != 0x{_MAGIC:02X}); refusing to "
                            f"replay/repair — written by another version?"
                        )
                    self._repair()
                    break
                (crc,) = _CRC.unpack_from(data, pos + _PREFIX.size)
                pstart = pos + hsize
                pend = pstart + tlen + blen + body_len
                if pend > len(data):
                    break
                payload = data[pstart:pend]
                if zlib.crc32(prefix + payload) & 0xFFFFFFFF != crc:
                    self._repair()
                    break
                pos = pend
                good_end = pos
                if kcode not in _KIND_NAMES:
                    # CRC-valid frame of an unknown kind: forward-compatible
                    # skip (a newer writer's entry), never a truncation point.
                    continue
                kind = _KIND_NAMES[kcode]
                header = {
                    "tx": tx,
                    "kind": kind,
                    "table": payload[:tlen].decode("utf-8"),
                    "block_id": payload[tlen : tlen + blen].decode("utf-8"),
                    "bl": body_len,
                }
                body = payload[tlen + blen :]
                if kind == KIND_NEW_TABLE_BLOCK:
                    header["config"] = json.loads(body)
                    body = b""
                max_tx = max(max_tx, tx)
                if tx >= from_tx:
                    collected.append((tx, header, body))
            if good_end < len(data) and repair:
                # truncate torn tail (self-repair)
                self.repairs_lost_records += 1
                with open(path, "r+b") as f:
                    f.truncate(good_end)
        collected.sort(key=lambda e: e[0])
        for _tx, header, body in collected:
            handler(header, body)
        return max_tx

    def first_index(self) -> int:
        segs = self._segments()
        if not segs:
            return 0
        return int(segs[0][:-4])

    def _segment_max_tx(self, path: str) -> Optional[int]:
        """Max tx among a segment's valid frames (None when it has none).
        Walks the same frame format replay does; stops at the first torn or
        corrupt frame, matching what replay would actually recover."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        pos = 0
        hsize = _PREFIX.size + _CRC.size
        mx: Optional[int] = None
        while pos + hsize <= len(data):
            prefix = data[pos : pos + _PREFIX.size]
            magic, _k, tlen, blen, body_len, tx = _PREFIX.unpack(prefix)
            if magic != _MAGIC:
                break
            pend = pos + hsize + tlen + blen + body_len
            if pend > len(data):
                break
            (crc,) = _CRC.unpack_from(data, pos + _PREFIX.size)
            if zlib.crc32(prefix + data[pos + hsize : pend]) & 0xFFFFFFFF != crc:
                break
            mx = tx if mx is None else max(mx, tx)
            pos = pend
        return mx

    def truncate(self, tx: int) -> None:
        """Drop whole segments whose entries are all strictly below tx
        (reference: wal/wal.go:484 Truncate; segment granularity like the
        underlying segment store).

        The bound comes from each segment's CONTENT, not its filename: a
        crash can leave a rolled-but-fully-torn (empty) segment whose name
        overstates the previous segment's upper bound — trusting names there
        deleted live entries (caught by the crash DST, seed 137: truncate(66)
        removed the segment holding txns 66-79 because an empty 00066.wal
        sat next to it)."""
        if self._killed:
            return  # dead handle (see _append)
        with self._lock:
            for seg in self._segments():
                cur = os.path.join(self.dir, seg)
                if self._file is not None and os.path.samefile(
                    cur, self._file.name
                ):
                    continue
                mx = self._segment_max_tx(cur)
                if mx is None or mx < tx:
                    os.remove(cur)

    def reset(self) -> None:
        """Drop everything (reference: wal/wal.go:493 Reset)."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            for seg in self._segments():
                os.remove(os.path.join(self.dir, seg))

    def hard_kill(self, partial_writes: int = 0, tear_bytes: int = 0) -> list[int]:
        """Simulate a process crash (testing support, the analogue of the
        reference DST's vfs hard-shutdown, dst/vfs/fs.go:24): the async
        batcher stops WITHOUT draining; ``partial_writes`` queued frames are
        written to the segment but never fsync'd, and the final
        ``tear_bytes`` bytes are chopped off (a torn in-flight write). No
        close-time flush happens. Returns the txns whose entries were queued
        but not durably flushed — the legitimately-lossable set the verifier
        accounts for (dst_test.go:217 testLogStore)."""
        with self._cv:
            self._killed = True
            self._closing = True
            dropped = list(self._queue)
            self._queue = []
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        lost = [tx for tx, _f in dropped]
        with self._lock:
            dropped.sort(key=lambda e: e[0])
            unsynced = 0
            for tx, frame in dropped[: max(partial_writes, 0)]:
                if self._file is None or self._segment_size > self.segment_size:
                    self._open_segment(tx)
                    unsynced = 0  # segment roll fsyncs the previous file
                self._file.write(frame)
                self._segment_size += len(frame)
                unsynced += len(frame)
            if self._file is not None:
                self._file.flush()  # OS buffer, NO fsync — like a real crash
                path = self._file.name
                self._file.close()
                self._file = None
                # A crash can only tear bytes that were never fsync'd.
                tear = min(max(tear_bytes, 0), unsynced)
                if tear > 0:
                    size = os.path.getsize(path)
                    with open(path, "r+b") as f:
                        f.truncate(max(size - tear, 0))
        return lost

    def close(self) -> None:
        if self._thread is not None:
            with self._cv:
                self._closing = True
                self._cv.notify_all()
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if self._file is not None:
                # A clean close must not report success unless the tail is
                # provably durable: the async loop swallows batch-fsync
                # EIOs (retried next batch), so retry here and surface a
                # persistent failure to the caller (ADVICE r3).
                err: Optional[OSError] = None
                try:
                    self._file.flush()
                except OSError as e:
                    err = e
                if err is None:
                    for _ in range(3):
                        try:
                            os.fsync(self._file.fileno())
                            err = None
                            break
                        except OSError as e:
                            err = e
                self._file.close()
                self._file = None
                if err is not None:
                    raise err


class NopWAL:
    """reference: wal/wal.go:27 NopWAL."""

    def log_record(self, *a, **k):
        pass

    def log_new_table_block(self, *a, **k):
        pass

    def log_table_block_persisted(self, *a, **k):
        pass

    def log_snapshot(self, *a, **k):
        pass

    def replay(self, handler, from_tx: int = 0, repair: bool = True) -> int:
        return 0

    def truncate(self, tx: int) -> None:
        pass

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass
