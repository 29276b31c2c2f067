"""Database snapshots (reference: snapshot.go; format comment at
snapshot.go:31-49).

A snapshot is a point-in-time image of all tables' parts, named by the txn
watermark it covers:

    <tx:020d>.fdbt  =  [magic "FDBT"][part payloads...]
                       [footer json][u32 footer_len][u32 crc32(footer)]
                       [magic "FDBT"]

Part payloads are Arrow IPC streams. Loading validates the trailing magic and
footer checksum and falls back to the newest *valid* snapshot
(snapshot.go:317 getLatestValidSnapshotTxn). Old snapshots are removed after
a successful write (snapshot.go:674).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

from .columnbatch import ColumnBatch
from .lsm import Part
from .table import TableConfig
from .wal import batch_to_ipc, ipc_to_arrow

MAGIC = b"FDBT"
_U32 = struct.Struct("<I")


def snapshot_path(directory: str, tx: int) -> str:
    return os.path.join(directory, f"{tx:020d}.fdbt")


def _snapshot_block(f, block, tx, index_root, name, pend_id, meta, offset):
    """Serialize one TableBlock into the open snapshot file: inline parts
    below the disk level, hard-link the disk level's files. One consistent
    cut per block: a background compaction splicing between the part
    enumeration and the index-file link would put the merged rows in the
    linked files while their sources are inlined (duplicates at recovery,
    caught by the crash DST seed 137) — ``compacting`` excludes the
    spill+splice window."""
    disk = block.disk_level
    with block.index.compacting:
        for part in block.index.snapshot():
            if part.tx > tx:
                continue
            if disk is not None and part.compaction_level >= disk.level:
                # Covered by hard-linked index files below — not copied
                # (design/index_files.md Snapshots; snapshot.go:730).
                continue
            payload = batch_to_ipc(part.batch)
            f.write(payload)
            meta["parts"].append(
                {
                    "tx": part.tx,
                    "level": part.compaction_level,
                    "offset": offset,
                    "length": len(payload),
                }
            )
            offset += len(payload)
        if disk is not None:
            parts_dir = [name] if pend_id is None else [name, pend_id]
            link_dir = os.path.join(index_root, *parts_dir, str(disk.level))
            meta["index_files"] = disk.snapshot_link(link_dir)
            meta["index_level"] = disk.level
    return offset


def write_snapshot(db, directory: str) -> int:
    """reference: snapshot.go:395 WriteSnapshot. Returns the snapshot tx.

    Concurrency/crash safety: attempts are serialized by ``db._snapshot_lock``
    (rotation workers and the insert thread can both trigger snapshots), the
    tmp file and the index-link staging dir are named uniquely per attempt,
    and a published snapshot's index dir is NEVER mutated in place. A
    snapshot at tx T stages its hard links under ``<tx>.index.<incarnation>``
    and records that dirname in the footer; only after the ``.fdbt`` publish
    is durable are other incarnations (and older snapshots) removed. A crash
    or injected EIO mid-write therefore leaves any previously published
    snapshot — including one at the SAME tx from a pre-recovery incarnation —
    fully intact with all its linked files.
    """
    with db._snapshot_lock:
        return _write_snapshot_locked(db, directory)


def _write_snapshot_locked(db, directory: str) -> int:
    import uuid

    os.makedirs(directory, exist_ok=True)
    tx = db.high_watermark()
    path = snapshot_path(directory, tx)
    incarnation = uuid.uuid4().hex[:12]
    tmp = f"{path}.tmp.{os.getpid()}.{incarnation}"
    index_dirname = f"{tx:020d}.index.{incarnation}"
    index_root = os.path.join(directory, index_dirname)
    footer: dict = {"tx": tx, "index_dirname": index_dirname, "tables": []}
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            offset = len(MAGIC)
            for name, table in db.tables.items():
                with table._lock:
                    active = table.active_block
                    pending = list(table.pending_blocks)
                tmeta = {
                    "name": name,
                    "config": table.config.to_dict(),
                    "active_block_id": active.id,
                    "parts": [],
                    "index_files": [],
                    # Rotated-but-unpersisted blocks: their rows live ONLY in
                    # memory (and the WAL), so the snapshot must carry them or
                    # its coverage claim — and the WAL truncation based on it —
                    # would silently drop them (caught by the EIO DST: a persist
                    # failing with EIO strands the block in pending).
                    "pending": [],
                }
                offset = _snapshot_block(
                    f, active, tx, index_root, name, None, tmeta, offset
                )
                for blk in pending:
                    bmeta = {"id": blk.id, "parts": [], "index_files": []}
                    offset = _snapshot_block(
                        f, blk, tx, index_root, name, blk.id, bmeta, offset
                    )
                    tmeta["pending"].append(bmeta)
                footer["tables"].append(tmeta)
            fb = json.dumps(footer).encode("utf-8")
            f.write(fb)
            f.write(_U32.pack(len(fb)))
            f.write(_U32.pack(zlib.crc32(fb) & 0xFFFFFFFF))
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        inj = getattr(getattr(db, "store", None), "fault_injector", None)
        if inj is not None and inj.snapshot_fails():
            # Injected EIO before the atomic publish (dst/vfs/fs.go:24
            # analogue): the torn tmp never becomes visible and no state
            # (last_snapshot_tx, WAL truncation) advances.
            from .faults import eio

            raise eio("snapshot write")
    except BaseException:
        # Failed attempt: remove only THIS attempt's staging artifacts; any
        # previously published snapshot (same tx included) is untouched.
        import shutil as _shutil

        try:
            os.remove(tmp)
        except OSError:
            pass
        _shutil.rmtree(index_root, ignore_errors=True)
        raise
    os.replace(tmp, path)
    if db.wal is not None:
        db.wal.log_snapshot(tx)
    cleanup_old_snapshots(directory, keep_tx=tx, keep_index_dirname=index_dirname)
    db.last_snapshot_tx = max(db.last_snapshot_tx, tx)
    if db.store is not None and db.store.metrics is not None:
        db.store.metrics.snapshots_total.inc()
        db.store.metrics.snapshot_bytes.inc(os.path.getsize(path))
    # Everything at or below tx is durable in the snapshot: reclaim WAL
    # segments live (the reference truncates after snapshot-on-rotation,
    # table.go:513 + db.go:1015).
    db.maintain_wal()
    return tx


def read_footer(path: str) -> Optional[dict]:
    """reference: snapshot.go:491 readFooter — validates magic + checksum."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < len(MAGIC) * 2 + 8 or data[: len(MAGIC)] != MAGIC:
            return None
        if data[-len(MAGIC) :] != MAGIC:
            return None
        crc = _U32.unpack(data[-len(MAGIC) - 4 : -len(MAGIC)])[0]
        flen = _U32.unpack(data[-len(MAGIC) - 8 : -len(MAGIC) - 4])[0]
        fstart = len(data) - len(MAGIC) - 8 - flen
        fb = data[fstart : fstart + flen]
        if zlib.crc32(fb) & 0xFFFFFFFF != crc:
            return None
        return json.loads(fb)
    except Exception:
        return None


def list_snapshot_txns(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        if f.endswith(".fdbt") and f[:-5].isdigit():
            out.append(int(f[:-5]))
    return sorted(out)


def get_latest_valid_snapshot_txn(directory: str) -> Optional[int]:
    """reference: snapshot.go:317 — newest snapshot whose footer validates."""
    for tx in reversed(list_snapshot_txns(directory)):
        if read_footer(snapshot_path(directory, tx)) is not None:
            return tx
    return None


def load_snapshot(db, directory: str) -> int:
    """Restore tables/parts from the newest valid snapshot; returns its tx
    (0 when none). reference: snapshot.go:277 LoadSnapshot."""
    tx = get_latest_valid_snapshot_txn(directory)
    if tx is None:
        return 0
    path = snapshot_path(directory, tx)
    footer = read_footer(path)
    if footer is None:
        return 0
    with open(path, "rb") as f:
        data = f.read()
    # Old-format snapshots (pre-incarnation) linked under "<tx>.index".
    index_root = os.path.join(
        directory, footer.get("index_dirname", f"{tx:020d}.index")
    )
    # Tables are restored without WAL logging: the transaction counter is
    # still at zero here, and logging a NewTableBlock with a pre-reset tx
    # would interleave stale txns into old segments (caught by the DST).
    from .recovery import _create_table_no_wal

    for tmeta in footer["tables"]:
        config = TableConfig.from_dict(tmeta["config"])
        table = db.tables.get(tmeta["name"])
        if table is None:
            table = _create_table_no_wal(db, tmeta["name"], config)
        table.active_block.id = tmeta.get("active_block_id", table.active_block.id)
        table.active_block.reattach_disk()
        if table.active_block.disk_level is not None:
            # Clear stale live index files: the snapshot's linked files are
            # authoritative; anything newer re-derives from the WAL tail
            # (keeping them would double-count on the next snapshot link).
            table.active_block.disk_level.delete_all()
        for pmeta in tmeta["parts"]:
            payload = data[pmeta["offset"] : pmeta["offset"] + pmeta["length"]]
            rb = ipc_to_arrow(payload)
            batch = ColumnBatch.from_arrow(rb, get_dictionary=table.dictionary)
            part = Part(
                batch, pmeta["tx"], pmeta["level"], device=table.device
            )
            table.active_block.index.insert_part(part)
        # Disk-level parts come from the hard-linked index files
        # (restoreIndexFilesFromSnapshot, snapshot.go:730); relink them into
        # the live index dir so future snapshots can link again.
        if tmeta.get("index_files"):
            from .disklevel import DiskLevel

            level = tmeta.get("index_level", 2)
            link_dir = os.path.join(index_root, tmeta["name"], str(level))
            if os.path.isdir(link_dir):
                snap_level = DiskLevel(link_dir, level, device=table.device)
                disk = table.active_block.disk_level
                # Only the files the footer recorded belong to THIS
                # snapshot; anything else in the dir is a stale leftover.
                for part in snap_level.recover(
                    table.dictionary, only=set(tmeta["index_files"])
                ):
                    table.active_block.index.insert_part(part)
                    if disk is not None:
                        disk.write_part(part)
        # Rotated-but-unpersisted blocks carried by the snapshot: restore
        # them WITH their identity so the bucket dedup (recovery) and the
        # source-part exclusion keep working; recovery re-enqueues their
        # persist.
        from .table import TableBlock
        from .disklevel import DiskLevel

        for bmeta in tmeta.get("pending", ()):
            blk = TableBlock(table, bmeta["id"], min_tx=0)
            if blk.disk_level is not None:
                blk.disk_level.delete_all()
            for pmeta in bmeta["parts"]:
                payload = data[pmeta["offset"] : pmeta["offset"] + pmeta["length"]]
                rb = ipc_to_arrow(payload)
                batch = ColumnBatch.from_arrow(
                    rb, get_dictionary=table.dictionary
                )
                blk.index.insert_part(
                    Part(
                        batch, pmeta["tx"], pmeta["level"], device=table.device
                    )
                )
            if bmeta.get("index_files"):
                level = bmeta.get("index_level", 2)
                link_dir = os.path.join(
                    index_root, tmeta["name"], bmeta["id"], str(level)
                )
                if os.path.isdir(link_dir):
                    snap_level = DiskLevel(
                        link_dir, level, device=table.device
                    )
                    for part in snap_level.recover(
                        table.dictionary, only=set(bmeta["index_files"])
                    ):
                        blk.index.insert_part(part)
                        if blk.disk_level is not None:
                            blk.disk_level.write_part(part)
            table.pending_blocks.append(blk)
    db.reset_to_txn(tx)
    return tx


def cleanup_old_snapshots(
    directory: str, keep_tx: int, keep_index_dirname: Optional[str] = None
) -> None:
    """Remove snapshots below keep_tx and any index dir not referenced by the
    surviving snapshot (stale incarnations at the same tx, older txns, and
    abandoned staging dirs from crashed attempts). reference: snapshot.go:674."""
    import shutil

    for tx in list_snapshot_txns(directory):
        if tx < keep_tx:
            try:
                os.remove(snapshot_path(directory, tx))
            except OSError:
                pass
    if keep_index_dirname is None:
        footer = read_footer(snapshot_path(directory, keep_tx))
        if footer is not None:
            keep_index_dirname = footer.get(
                "index_dirname", f"{keep_tx:020d}.index"
            )
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for name in entries:
        if ".fdbt.tmp." in name:
            # Abandoned tmp from a crashed attempt (the live attempt's tmp
            # was os.replace'd before cleanup runs, and attempts are
            # serialized by the db snapshot lock).
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
            continue
        if ".index" not in name or name == keep_index_dirname:
            continue
        stem = name.split(".index", 1)[0]
        if not stem.isdigit():
            continue
        if int(stem) < keep_tx or (
            int(stem) == keep_tx and name != keep_index_dirname
        ):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
