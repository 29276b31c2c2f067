"""On-disk persistent index files for compacted LSM levels.

Reference: index/levels.go FileCompaction (CompactionTypeParquetDisk) and
design/index_files.md. Compacted parts append into index files under

    databases/<db>/index/<table>/<block>/<level>/NNNNNNNNNNNNNNNNNNNN.parquet

as framed parquet payloads: ``<parquet bytes><uint64 size>`` repeated
(index_files.md:16-25); the part's transaction id travels in the parquet
key-value metadata under ``compaction_tx``. Files fsync after each write,
reopen on restart (``recover``), and snapshots hard-link them instead of
copying (snapshot.go:730 restoreIndexFilesFromSnapshot).
"""

from __future__ import annotations

import io
import os
import struct
from typing import Optional

from .columnbatch import ColumnBatch
from .config import DEFAULT_DEVICE
from .lsm import Part

_U64 = struct.Struct("<Q")
TX_META_KEY = b"compaction_tx"
LEVEL_META_KEY = b"compaction_level"


class DiskLevel:
    """A directory-backed level of the LSM (reference: index/levels.go:30
    FileCompaction). ``device`` is the owning table's torch device: every
    part ``recover`` rebuilds lives there."""

    def __init__(
        self,
        directory: str,
        level: int,
        is_dead=None,
        injector=None,
        device=DEFAULT_DEVICE,
    ):
        self.dir = directory
        self.level = level
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self._seq = self._max_seq() + 1
        self._active_path: Optional[str] = None
        # Crash-simulation guard (DST): a killed store's in-flight
        # compaction must not spill into files a recovered store (or its
        # snapshot hard-links) will read — a real crash takes the writer
        # with it. Checked at the write boundary; no handle is retained
        # across writes for the same reason.
        self.is_dead = is_dead
        # Write-fault injection (dst/vfs/fs.go:24 analogue).
        self.injector = injector

    def _files(self) -> list[str]:
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            # The block's index dir can be deleted by a completed persist
            # whose tail (WAL maintenance) failed and is being retried.
            return []
        return sorted(
            f for f in names if f.endswith(".parquet") and f[:-8].isdigit()
        )

    def _max_seq(self) -> int:
        files = self._files()
        return int(files[-1][:-8]) if files else 0

    def _ensure_active(self) -> None:
        if self._active_path is None:
            self._active_path = os.path.join(
                self.dir, f"{self._seq:020d}.parquet"
            )

    def write_part(self, part: Part) -> None:
        """Append one compacted part's parquet payload + size frame
        (index_files.md Writes; fsync'd). The file opens and closes per
        write — no handle survives the call, so a crashed (simulated-dead)
        store can never append to an inode a later life hard-linked."""
        if self.is_dead is not None and self.is_dead():
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        rb = part.batch.to_arrow()
        table = pa.Table.from_batches([rb])
        table = table.replace_schema_metadata(
            {
                TX_META_KEY: str(part.tx).encode(),
                LEVEL_META_KEY: str(part.compaction_level).encode(),
            }
        )
        buf = io.BytesIO()
        pq.write_table(table, buf, compression="zstd")
        payload = buf.getvalue()
        self._ensure_active()
        from .faults import faulty_append, faulty_fsync

        os.makedirs(self.dir, exist_ok=True)
        with open(self._active_path, "ab") as f:
            pre = f.tell()
            try:
                faulty_append(
                    f,
                    payload + _U64.pack(len(payload)),
                    self.injector,
                    "index append",
                )
                f.flush()
                faulty_fsync(f.fileno(), self.injector, "index fsync")
            except OSError:
                # Roll back to the pre-write size: replay repairs tears only
                # at the END of a file, so a failed append must never be
                # followed by further appends.
                try:
                    f.flush()
                except OSError:
                    pass
                try:
                    f.truncate(pre)
                except OSError:
                    pass
                raise

    def rotate_file(self) -> None:
        """Seal the active index file name (done at snapshot time so sealed
        files can be hard-linked; index_files.md Snapshots)."""
        if self._active_path is not None:
            self._active_path = None
            self._seq += 1

    def recover(self, get_dictionary, only=None) -> list[Part]:
        """Re-open all parts from the level's index files (index_files.md
        Replay). Torn tails (missing/short trailing frame) are dropped.
        ``only`` restricts recovery to the named files (snapshot footers
        record exactly which linked files belong to them)."""
        import pyarrow.parquet as pq

        parts: list[Part] = []
        for fname in self._files():
            if only is not None and fname not in only:
                continue
            path = os.path.join(self.dir, fname)
            with open(path, "rb") as f:
                data = f.read()
            # Walk frames from the end: [payload][u64 size] ... repeated.
            # A torn tail (append interrupted before the size frame) is
            # skipped by backing up to the last parquet magic: a valid frame
            # boundary has ...PAR1 immediately before its size suffix.
            frames: list[tuple[int, int]] = []
            end = len(data)
            magic = b"PAR1"
            while end >= _U64.size + 8:
                (size,) = _U64.unpack(data[end - _U64.size : end])
                start = end - _U64.size - size
                valid = (
                    0 <= start
                    and data[start : start + 4] == magic
                    and data[end - _U64.size - 4 : end - _U64.size] == magic
                )
                if valid:
                    frames.append((start, end - _U64.size))
                    end = start
                    continue
                if frames:
                    break
                # torn tail: resync on the previous payload-tail magic
                # (strictly before the current candidate, so this terminates)
                pos = data.rfind(magic, 0, max(end - _U64.size - 4, 0))
                if pos < 0:
                    break
                end = pos + 4 + _U64.size
            for start, stop in reversed(frames):
                try:
                    table = pq.read_table(io.BytesIO(data[start:stop]))
                except Exception:
                    continue
                meta = table.schema.metadata or {}
                tx = int(meta.get(TX_META_KEY, b"0"))
                level = int(meta.get(LEVEL_META_KEY, str(self.level).encode()))
                batch = ColumnBatch.from_arrow(table, get_dictionary=get_dictionary)
                parts.append(Part(batch, tx, level, device=self.device))
        return parts

    def snapshot_link(self, snapshot_dir: str) -> list[str]:
        """Hard-link sealed index files into the snapshot directory
        (snapshot.go:730). Returns linked relative names."""
        self.rotate_file()
        os.makedirs(snapshot_dir, exist_ok=True)
        linked = []
        for fname in self._files():
            src = os.path.join(self.dir, fname)
            dst = os.path.join(snapshot_dir, fname)
            if not os.path.exists(dst):
                try:
                    os.link(src, dst)
                except OSError:
                    import shutil

                    shutil.copy2(src, dst)
            linked.append(fname)
        return linked

    def delete_all(self) -> None:
        """Drop the level's files after compaction into the next level or
        block rotation (index_files.md Compaction/Rotation)."""
        self.rotate_file()
        for fname in self._files():
            try:
                os.remove(os.path.join(self.dir, fname))
            except OSError:
                pass

    def close(self) -> None:
        self.rotate_file()
