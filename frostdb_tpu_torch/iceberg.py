"""Apache Iceberg DataSource/DataSink over a filesystem warehouse
(reference: storage/iceberg.go — an Iceberg-backed DataSink/DataSource
using an HDFS-style catalog: version-hint.text + numbered metadata files,
iceberg.go:29-50 layout comment).

Layout (iceberg.go:31-37):

    <root>/<db>/<table>/v<N>.metadata.json          metadata file
    <root>/<db>/<table>/data/<block_id>.parquet     data files
    <root>/<db>/<table>/metadata/snap-<id>.avro     manifest list (snapshot)
    <root>/<db>/<table>/metadata/<uuid>-m0.avro     manifest file
    <root>/<db>/<table>/metadata/version-hint.text  latest version number

Upload (iceberg.go:329): write the data file, add it to a new manifest,
append the manifest to the manifest list, commit a new metadata version,
update the version hint. Scan (iceberg.go:230): load the current snapshot,
read the manifest list, prune manifest entries on their per-column
lower/upper bounds (manifestEntryMayContainUsefulData), then prune row
groups inside surviving files — the same TrueNegativeFilter contract as the
plain bucket source (store.py).

Manifests and manifest lists are real Avro object container files with
Iceberg-spec field names/ids (written and read by the self-contained codec
in avro.py); bounds use Iceberg single-value binary serialization
(little-endian longs/doubles, UTF-8 strings).
"""

from __future__ import annotations

import json
import os
import struct
import time
import uuid
from typing import Iterable, Optional

from . import avro
from .columnbatch import ColumnBatch
from .query import expr as E
from .schema import Schema
from .store import _prune_row_group

# ---------------------------------------------------------------------------
# Iceberg Avro schemas (spec field names + ids; v1 manifests)

_BOUND_KV = lambda name, kid, vid: {  # noqa: E731
    "type": "array",
    "items": {
        "type": "record",
        "name": name,
        "fields": [
            {"name": "key", "type": "int", "field-id": kid},
            {"name": "value", "type": "bytes", "field-id": vid},
        ],
    },
}

MANIFEST_ENTRY_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {
            "name": "snapshot_id",
            "type": ["null", "long"],
            "default": None,
            "field-id": 1,
        },
        {
            "name": "data_file",
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "file_path", "type": "string", "field-id": 100},
                    {"name": "file_format", "type": "string", "field-id": 101},
                    {"name": "record_count", "type": "long", "field-id": 103},
                    {
                        "name": "file_size_in_bytes",
                        "type": "long",
                        "field-id": 104,
                    },
                    {
                        "name": "lower_bounds",
                        "type": ["null", _BOUND_KV("k126_v127", 126, 127)],
                        "default": None,
                        "field-id": 125,
                    },
                    {
                        "name": "upper_bounds",
                        "type": ["null", _BOUND_KV("k129_v130", 129, 130)],
                        "default": None,
                        "field-id": 128,
                    },
                ],
            },
            "field-id": 2,
        },
    ],
}

MANIFEST_FILE_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {
            "name": "added_snapshot_id",
            "type": ["null", "long"],
            "default": None,
            "field-id": 503,
        },
        {
            "name": "added_data_files_count",
            "type": ["null", "int"],
            "default": None,
            "field-id": 504,
        },
        {
            "name": "existing_data_files_count",
            "type": ["null", "int"],
            "default": None,
            "field-id": 505,
        },
        {
            "name": "deleted_data_files_count",
            "type": ["null", "int"],
            "default": None,
            "field-id": 506,
        },
    ],
}


# ---------------------------------------------------------------------------
# Single-value serialization (Iceberg spec appendix D)


def _bound_bytes(value, iceberg_type: str) -> Optional[bytes]:
    if value is None:
        return None
    if iceberg_type == "long":
        return struct.pack("<q", int(value))
    if iceberg_type == "double":
        return struct.pack("<d", float(value))
    if iceberg_type == "boolean":
        return b"\x01" if value else b"\x00"
    if iceberg_type == "string":
        return str(value).encode("utf-8")
    return None


def _bound_value(raw: bytes, iceberg_type: str):
    if iceberg_type == "long":
        return struct.unpack("<q", raw)[0]
    if iceberg_type == "double":
        return struct.unpack("<d", raw)[0]
    if iceberg_type == "boolean":
        return raw != b"\x00"
    if iceberg_type == "string":
        return raw.decode("utf-8")
    return None


def _iceberg_type(arrow_type: "pa.DataType") -> str:
    import pyarrow as pa

    if pa.types.is_integer(arrow_type):
        return "long"
    if pa.types.is_floating(arrow_type):
        return "double"
    if pa.types.is_boolean(arrow_type):
        return "boolean"
    return "string"


# ---------------------------------------------------------------------------


class IcebergCatalog:
    """Iceberg warehouse over a local/posix directory — the DataSource and
    DataSink contract of store.FileSystemBucket, persisted as real Iceberg
    tables (reference: storage/iceberg.go:65 Iceberg struct; HDFS-catalog
    flavor with version-hint.text, iceberg.go:41-43)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _table_dir(self, db: str, table: str) -> str:
        return os.path.join(self.root, db, table)

    def _version(self, tdir: str) -> int:
        hint = os.path.join(tdir, "metadata", "version-hint.text")
        try:
            with open(hint) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return 0

    def _metadata(self, tdir: str) -> Optional[dict]:
        v = self._version(tdir)
        if v == 0:
            return None
        path = os.path.join(tdir, f"v{v}.metadata.json")
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # -- DataSink ----------------------------------------------------------

    def upload_block(
        self,
        db: str,
        table: str,
        block_id: str,
        batch: ColumnBatch,
        schema: Schema,
    ) -> None:
        """Commit one data file as a new snapshot (iceberg.go:329 Upload:
        data file -> manifest -> manifest list -> metadata -> hint)."""
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq

        tdir = self._table_dir(db, table)
        os.makedirs(os.path.join(tdir, "data"), exist_ok=True)
        os.makedirs(os.path.join(tdir, "metadata"), exist_ok=True)

        rb = batch.to_arrow()
        t = pa.Table.from_batches([rb])
        t = t.replace_schema_metadata(
            {b"frostdb_tpu.schema": json.dumps(schema.def_.to_dict()).encode()}
        )
        data_path = os.path.join(tdir, "data", f"{block_id}.parquet")
        tmp = data_path + ".tmp"
        pq.write_table(t, tmp, compression="zstd")
        os.replace(tmp, data_path)
        file_size = os.path.getsize(data_path)

        meta = self._metadata(tdir)
        field_ids: dict[str, int] = (
            {f["name"]: f["id"] for f in meta["schema"]["fields"]}
            if meta
            else {}
        )
        types: dict[str, str] = (
            {f["name"]: f["type"] for f in meta["schema"]["fields"]}
            if meta
            else {}
        )
        last_id = max(field_ids.values(), default=0)
        for name, typ in zip(rb.schema.names, rb.schema.types):
            if name not in field_ids:
                last_id += 1
                field_ids[name] = last_id
                types[name] = _iceberg_type(typ)

        # per-column bounds over valid values (parquet-stats semantics)
        lower, upper = [], []
        for i, name in enumerate(rb.schema.names):
            col = rb.column(i)
            if col.null_count == len(col):
                continue
            if pa.types.is_dictionary(col.type):
                col = col.cast(col.type.value_type)
            mm = pc.min_max(col)
            lo = _bound_bytes(mm["min"].as_py(), types[name])
            hi = _bound_bytes(mm["max"].as_py(), types[name])
            if lo is not None and hi is not None:
                lower.append({"key": field_ids[name], "value": lo})
                upper.append({"key": field_ids[name], "value": hi})

        snapshot_id = int.from_bytes(os.urandom(7), "big")
        entry = {
            "status": 1,  # ADDED
            "snapshot_id": snapshot_id,
            "data_file": {
                "file_path": data_path,
                "file_format": "PARQUET",
                "record_count": batch.num_rows,
                "file_size_in_bytes": file_size,
                "lower_bounds": lower,
                "upper_bounds": upper,
            },
        }
        manifest_path = os.path.join(
            tdir, "metadata", f"{uuid.uuid4()}-m0.avro"
        )
        with open(manifest_path, "wb") as f:
            f.write(
                avro.write_container(
                    MANIFEST_ENTRY_SCHEMA,
                    [entry],
                    metadata={
                        "schema": json.dumps(
                            self._iceberg_schema(field_ids, types)
                        ),
                        "content": "data",
                    },
                )
            )

        # Carry previous manifests forward (append semantics).
        manifests = []
        if meta is not None:
            cur = self._current_snapshot(meta)
            if cur is not None:
                _m, manifests_prev = avro.read_container(
                    open(cur["manifest-list"], "rb").read()
                )
                manifests = list(manifests_prev)
        manifests.append(
            {
                "manifest_path": manifest_path,
                "manifest_length": os.path.getsize(manifest_path),
                "partition_spec_id": 0,
                "added_snapshot_id": snapshot_id,
                "added_data_files_count": 1,
                "existing_data_files_count": 0,
                "deleted_data_files_count": 0,
            }
        )
        list_path = os.path.join(
            tdir, "metadata", f"snap-{snapshot_id}.avro"
        )
        with open(list_path, "wb") as f:
            f.write(avro.write_container(MANIFEST_FILE_SCHEMA, manifests))

        now_ms = int(time.time() * 1000)
        snapshots = list(meta["snapshots"]) if meta else []
        snapshots.append(
            {
                "snapshot-id": snapshot_id,
                "timestamp-ms": now_ms,
                "manifest-list": list_path,
                "summary": {"operation": "append"},
            }
        )
        new_meta = {
            "format-version": 1,
            "table-uuid": (meta or {}).get("table-uuid", str(uuid.uuid4())),
            "location": tdir,
            "last-updated-ms": now_ms,
            "last-column-id": last_id,
            "schema": self._iceberg_schema(field_ids, types),
            "partition-spec": [],
            "partition-specs": [{"spec-id": 0, "fields": []}],
            "default-spec-id": 0,
            "properties": {},
            "current-snapshot-id": snapshot_id,
            "snapshots": snapshots,
        }
        self._commit_metadata(tdir, new_meta)

    def _commit_metadata(self, tdir: str, meta: dict) -> int:
        """Atomically commit the next metadata version. The metadata file is
        linked into place with O_EXCL semantics (``os.link`` fails if the
        version already exists), so two concurrent committers race on the
        version number and the loser gets ``CommitConflictError`` instead of
        silently dropping the winner's snapshot (optimistic concurrency, the
        Iceberg spec's commit rule; the reference delegates this to the
        catalog implementation, storage/iceberg.go:329)."""
        v = self._version(tdir) + 1
        mpath = os.path.join(tdir, f"v{v}.metadata.json")
        tmp = mpath + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        try:
            os.link(tmp, mpath)
        except FileExistsError:
            raise CommitConflictError(
                f"{mpath}: version {v} was committed concurrently; "
                f"re-read the table metadata and retry"
            )
        finally:
            os.unlink(tmp)
        hint = os.path.join(tdir, "metadata", "version-hint.text")
        tmp = hint + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(v))
        os.replace(tmp, hint)
        return v

    @staticmethod
    def _iceberg_schema(field_ids: dict, types: dict) -> dict:
        return {
            "type": "struct",
            "schema-id": 0,
            "fields": [
                {
                    "id": fid,
                    "name": name,
                    "required": False,
                    "type": types[name],
                }
                for name, fid in sorted(
                    field_ids.items(), key=lambda kv: kv[1]
                )
            ],
        }

    @staticmethod
    def _current_snapshot(meta: dict) -> Optional[dict]:
        sid = meta.get("current-snapshot-id")
        for s in meta.get("snapshots", []):
            if s["snapshot-id"] == sid:
                return s
        return None

    # -- DataSource ----------------------------------------------------------

    def prefixes(self, db: str) -> list[str]:
        """Tables in the warehouse for the db (iceberg.go:315 Prefixes)."""
        p = os.path.join(self.root, db)
        if not os.path.isdir(p):
            return []
        return sorted(
            t
            for t in os.listdir(p)
            if os.path.exists(
                os.path.join(p, t, "metadata", "version-hint.text")
            )
        )

    def scan(
        self,
        db: str,
        table: str,
        schema: Schema,
        filter: Optional[E.Expr],
        get_dictionary,
        exclude_block_ids: Iterable[str] = (),
    ) -> list[ColumnBatch]:
        """Current snapshot -> manifest list -> manifests -> bound-pruned
        data files -> row-group-pruned reads (iceberg.go:230 Scan)."""
        import pyarrow.parquet as pq

        tdir = self._table_dir(db, table)
        meta = self._metadata(tdir)
        if meta is None:
            return []
        snap = self._current_snapshot(meta)
        if snap is None:
            return []
        field_types = {
            f["id"]: f["type"] for f in meta["schema"]["fields"]
        }
        field_names = {
            f["id"]: f["name"] for f in meta["schema"]["fields"]
        }
        exclude = set(exclude_block_ids)

        out: list[ColumnBatch] = []
        _m, manifests = avro.read_container(
            open(snap["manifest-list"], "rb").read()
        )
        for mf in manifests:
            _me, entries = avro.read_container(
                open(mf["manifest_path"], "rb").read()
            )
            for e in entries:
                if e["status"] == 2:  # DELETED
                    continue
                df = e["data_file"]
                block_id = os.path.splitext(
                    os.path.basename(df["file_path"])
                )[0]
                if block_id in exclude:
                    continue
                if self._entry_cannot_match(
                    df, filter, field_types, field_names
                ):
                    continue
                if not os.path.exists(df["file_path"]):
                    continue
                f = pq.ParquetFile(df["file_path"])
                keep = [
                    g
                    for g in range(f.metadata.num_row_groups)
                    if not _prune_row_group(
                        f.metadata, g, f.schema_arrow, filter
                    )
                ]
                if not keep:
                    continue
                t = f.read_row_groups(keep)
                out.append(
                    ColumnBatch.from_arrow(t, get_dictionary=get_dictionary)
                )
        return out

    def list_blocks(self, db: str, table: str) -> list[tuple[str, str]]:
        """(block_id, data-file path) pairs for the current snapshot — the
        block-granular source API the table layer caches device-resident
        parts against (see store.py list_blocks)."""
        tdir = self._table_dir(db, table)
        meta = self._metadata(tdir)
        if meta is None:
            return []
        snap = self._current_snapshot(meta)
        if snap is None:
            return []
        out: list[tuple[str, str]] = []
        _m, manifests = avro.read_container(
            open(snap["manifest-list"], "rb").read()
        )
        for mf in manifests:
            _me, entries = avro.read_container(
                open(mf["manifest_path"], "rb").read()
            )
            for e in entries:
                if e["status"] == 2:  # DELETED
                    continue
                path = e["data_file"]["file_path"]
                if not os.path.exists(path):
                    continue
                block_id = os.path.splitext(os.path.basename(path))[0]
                out.append((block_id, path))
        return sorted(out)

    def read_block_parts(self, ref: str, schema: Schema, get_dictionary):
        """One ColumnBatch per row group of one data file."""
        import pyarrow.parquet as pq

        f = pq.ParquetFile(ref)
        out = []
        for g in range(f.metadata.num_row_groups):
            t = f.read_row_group(g)
            out.append(ColumnBatch.from_arrow(t, get_dictionary=get_dictionary))
        return out

    @staticmethod
    def _entry_cannot_match(
        data_file: dict, filter: Optional[E.Expr], field_types, field_names
    ) -> bool:
        """True-negative test on a manifest entry's column bounds
        (iceberg.go manifestEntryMayContainUsefulData / the
        dataFileParticulate virtual column chunks, iceberg.go:440-528)."""
        if filter is None:
            return False
        stats: dict[str, tuple] = {}
        lowers = data_file.get("lower_bounds") or []
        uppers = {
            kv["key"]: kv["value"]
            for kv in (data_file.get("upper_bounds") or [])
        }
        for kv in lowers:
            fid = kv["key"]
            if fid not in field_names or fid not in uppers:
                continue
            typ = field_types[fid]
            stats[field_names[fid]] = (
                _bound_value(kv["value"], typ),
                _bound_value(uppers[fid], typ),
            )

        def cannot_match(e: E.Expr) -> bool:
            if isinstance(e, E.BinaryExpr):
                if e.op == E.OP_AND:
                    return cannot_match(e.left) or cannot_match(e.right)
                if e.op == E.OP_OR:
                    return cannot_match(e.left) and cannot_match(e.right)
                if isinstance(e.left, E.Column) and isinstance(
                    e.right, E.Literal
                ):
                    name = e.left.column_name
                    lit = e.right.value
                    if name not in stats or lit is None:
                        return False
                    lo, hi = stats[name]
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

    # -- maintenance ---------------------------------------------------------

    def maintenance(
        self,
        db: str,
        table: str,
        keep_snapshots: int = 3,
        orphan_age_s: float = 24 * 3600.0,
    ) -> int:
        """Expire old snapshots, delete orphaned metadata files, and remove
        data files no surviving manifest references (iceberg.go:133
        Maintenance; WithExpireSnapshotsOlderThan /
        WithMetadataPreviousVersionsMax defaults iceberg.go:58-63;
        DefaultOrphanedFileAge guards in-flight uploads — a data file is
        only orphan-deleted once older than ``orphan_age_s``). Returns the
        number of files removed."""
        tdir = self._table_dir(db, table)
        meta = self._metadata(tdir)
        if meta is None:
            return 0
        snaps = meta.get("snapshots", [])
        if len(snaps) <= keep_snapshots:
            return 0
        keep = snaps[-keep_snapshots:]
        keep_ids = {s["snapshot-id"] for s in keep}

        # Manifests (and the data files they point to) referenced by
        # surviving snapshots stay.
        referenced: set[str] = set()
        live_data: set[str] = set()
        for s in keep:
            referenced.add(s["manifest-list"])
            _m, manifests = avro.read_container(
                open(s["manifest-list"], "rb").read()
            )
            referenced.update(m["manifest_path"] for m in manifests)
            for m in manifests:
                _m2, entries = avro.read_container(
                    open(m["manifest_path"], "rb").read()
                )
                live_data.update(
                    e["data_file"]["file_path"] for e in entries
                )

        removed = 0
        mdir = os.path.join(tdir, "metadata")
        for fn in os.listdir(mdir):
            path = os.path.join(mdir, fn)
            if fn.endswith(".avro") and path not in referenced:
                os.remove(path)
                removed += 1

        # Orphaned data files: referenced only by expired snapshots (or by
        # nothing at all, e.g. a crashed upload). The age guard keeps an
        # in-flight upload's freshly-written file safe until its snapshot
        # commit lands (iceberg.go:133 removes orphans older than
        # DefaultOrphanedFileAge).
        ddir = os.path.join(tdir, "data")
        now = time.time()
        if os.path.isdir(ddir):
            for fn in os.listdir(ddir):
                path = os.path.join(ddir, fn)
                if path in live_data or not fn.endswith(".parquet"):
                    continue
                if now - os.path.getmtime(path) >= orphan_age_s:
                    os.remove(path)
                    removed += 1

        meta["snapshots"] = keep
        if meta["current-snapshot-id"] not in keep_ids:
            meta["current-snapshot-id"] = keep[-1]["snapshot-id"]
        self._commit_metadata(tdir, meta)
        v = self._version(tdir)
        # Drop superseded metadata versions beyond the previous 3
        # (WithMetadataPreviousVersionsMax(3), iceberg.go:62).
        for fn in os.listdir(tdir):
            if fn.endswith(".metadata.json"):
                try:
                    ver = int(fn[1 : -len(".metadata.json")])
                except ValueError:
                    continue
                if ver < v - 3:
                    os.remove(os.path.join(tdir, fn))
                    removed += 1
        return removed


class CommitConflictError(Exception):
    """Another writer committed the same metadata version concurrently;
    the caller must re-read table metadata and retry its commit."""


class IcebergUnavailable(ImportError):
    """Kept for API compatibility: the native implementation above no
    longer needs pyiceberg, so this is never raised by IcebergCatalog."""
