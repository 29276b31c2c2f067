"""dbtool — inspect parquet blocks, WAL segments and snapshots.

Reference: cmd/parquet-tool (dump/stats/rowgroup/row/find on parquet files,
WAL inspect, snapshot inspect; cmd/parquet-tool/cmd/*.go).

Usage:
    python -m frostdb_tpu_torch.tools.dbtool parquet-stats  <file.parquet>
    python -m frostdb_tpu_torch.tools.dbtool parquet-dump   <file.parquet> [--rows N]
    python -m frostdb_tpu_torch.tools.dbtool parquet-rowgroups <file.parquet>
    python -m frostdb_tpu_torch.tools.dbtool parquet-row  <start> <n> <file.parquet>
    python -m frostdb_tpu_torch.tools.dbtool parquet-find <col>=<val>[,<col2>=<val2>] <file-or-dir>
    python -m frostdb_tpu_torch.tools.dbtool wal <wal-dir> [--verbose]
    python -m frostdb_tpu_torch.tools.dbtool snapshot <file.fdbt>
"""

from __future__ import annotations

import argparse
import json
import sys


def parquet_stats(path: str) -> None:
    import pyarrow.parquet as pq

    f = pq.ParquetFile(path)
    md = f.metadata
    print(f"file: {path}")
    print(f"rows: {md.num_rows}  row_groups: {md.num_row_groups}  columns: {md.num_columns}")
    print(f"created_by: {md.created_by}")
    kv = md.metadata or {}
    for k, v in kv.items():
        if k != b"ARROW:schema":
            print(f"meta {k.decode()}: {v[:200].decode(errors='replace')}")
    print("schema:")
    print(f.schema_arrow)


def parquet_rowgroups(path: str) -> None:
    import pyarrow.parquet as pq

    f = pq.ParquetFile(path)
    md = f.metadata
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        print(f"row group {g}: rows={rg.num_rows} bytes={rg.total_byte_size}")
        for c in range(rg.num_columns):
            col = rg.column(c)
            s = col.statistics
            mm = (
                f" min={s.min!r} max={s.max!r} nulls={s.null_count}"
                if s is not None and s.has_min_max
                else ""
            )
            print(
                f"  {col.path_in_schema}: {col.physical_type}"
                f" {col.compression} bytes={col.total_compressed_size}{mm}"
            )


def parquet_dump(path: str, rows: int) -> None:
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    print(t.slice(0, rows).to_pandas().to_string())


def _print_rows(table, start: int, indices) -> None:
    cols = table.column_names
    for i in indices:
        vals = {c: table.column(c)[i].as_py() for c in cols}
        body = "  ".join(f"{c}={vals[c]!r}" for c in cols)
        print(f"row {start + i}: {body}")


def parquet_row(path: str, row_start: int, num_rows: int) -> None:
    """Print rows [row_start, row_start+num_rows) — the reference's
    row-group-resolving row dump (cmd/parquet-tool/cmd/row.go)."""
    import pyarrow.parquet as pq

    f = pq.ParquetFile(path)
    md = f.metadata
    seen = 0
    for g in range(md.num_row_groups):
        rg_rows = md.row_group(g).num_rows
        if seen + rg_rows > row_start:
            # rows may span row groups; read from here onward
            remaining = num_rows
            offset = row_start - seen
            for g2 in range(g, md.num_row_groups):
                t = f.read_row_group(g2)
                take = min(remaining, t.num_rows - offset)
                if take <= 0:
                    break
                sl = t.slice(offset, take)
                base = seen + offset
                _print_rows(sl, base, range(sl.num_rows))
                remaining -= take
                seen += t.num_rows
                offset = 0
                if remaining <= 0:
                    break
            return
        seen += rg_rows
    print(f"row {row_start} out of range ({md.num_rows} rows)")


def _parse_matchers(arg: str) -> dict:
    out = {}
    for m in arg.split(","):
        if "=" not in m:
            raise SystemExit(
                f"invalid column argument: {m}; expected <column>=<value>"
            )
        k, v = m.split("=", 1)
        out[k] = v
    return out


def _typed(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parquet_find(column_arg: str, file_or_dir: str) -> None:
    """Find rows matching <col>=<value> conjunctions, pruning row groups by
    their min/max statistics first (cmd/parquet-tool/cmd/find.go)."""
    import os

    import pyarrow.parquet as pq

    matchers = {k: _typed(v) for k, v in _parse_matchers(column_arg).items()}
    files = []
    if os.path.isdir(file_or_dir):
        for root, _dirs, names in os.walk(file_or_dir):
            files += [
                os.path.join(root, n)
                for n in names
                if n.endswith(".parquet")
            ]
        files.sort()
    else:
        files = [file_or_dir]

    total = 0
    for path in files:
        f = pq.ParquetFile(path)
        md = f.metadata
        name_to_idx = {
            md.row_group(0).column(c).path_in_schema: c
            for c in range(md.num_columns)
        } if md.num_row_groups else {}
        base = 0
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            prune = False
            for col, want in matchers.items():
                ci = name_to_idx.get(col)
                if ci is None:
                    continue
                s = rg.column(ci).statistics
                if (
                    s is not None
                    and s.has_min_max
                    and isinstance(want, (int, float))
                    and isinstance(s.min, (int, float))
                ):
                    if want < s.min or want > s.max:
                        prune = True
                        break
            if prune:
                base += rg.num_rows
                continue
            t = f.read_row_group(g)
            mask = None
            for col, want in matchers.items():
                if col not in t.column_names:
                    mask = None
                    break
                vals = [x.as_py() for x in t.column(col)]
                m = [
                    v == want or str(v) == str(want) for v in vals
                ]
                mask = m if mask is None else [a and b for a, b in zip(mask, m)]
            if mask:
                idxs = [i for i, hit in enumerate(mask) if hit]
                if idxs:
                    print(f"{path} row group {g}:")
                    _print_rows(t, base, idxs)
                    total += len(idxs)
            base += rg.num_rows
    print(f"matched {total} rows")


def wal_inspect(path: str, verbose: bool) -> None:
    from ..wal import FileWAL

    w = FileWAL(path)
    counts: dict[str, int] = {}
    txs: list[int] = []

    def h(header, body):
        counts[header["kind"]] = counts.get(header["kind"], 0) + 1
        txs.append(header["tx"])
        if verbose:
            print(json.dumps({k: v for k, v in header.items() if k != "bl"}))

    w.replay(h, from_tx=0, repair=False)
    print(f"entries: {sum(counts.values())}  kinds: {counts}")
    if txs:
        print(f"tx range: {min(txs)}..{max(txs)}")
    if w.repairs:
        print(f"repairs: {w.repairs} lost_records: {w.repairs_lost_records}")


def snapshot_inspect(path: str) -> None:
    from ..snapshot import read_footer

    footer = read_footer(path)
    if footer is None:
        print("INVALID snapshot (bad magic or checksum)")
        sys.exit(1)
    print(f"snapshot tx: {footer['tx']}")
    for t in footer["tables"]:
        nrows = "?"
        print(
            f"table {t['name']}: block={t.get('active_block_id', '?')[:8]}"
            f" parts={len(t['parts'])}"
        )
        for p in t["parts"]:
            print(
                f"  part tx={p['tx']} level={p['level']}"
                f" offset={p['offset']} length={p['length']}"
            )


def parquet_reencode(path: str, schema_file: str, out_path: str) -> None:
    """Re-encode a parquet file through a frostdb schema definition
    (reference: cmd/parquet-reencode/main.go — open the file, re-sort rows
    by the new schema's sorting columns, rewrite through its writer)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..columnbatch import ColumnBatch, Dictionary
    from ..schema import Schema, SchemaDef

    with open(schema_file) as f:
        sdef = SchemaDef.from_dict(json.load(f))
    schema = Schema(sdef)

    dicts: dict[str, Dictionary] = {}

    def get_dictionary(fam: str) -> Dictionary:
        return dicts.setdefault(fam.split(".", 1)[0], Dictionary())

    t = pq.read_table(path)
    batch = ColumnBatch.from_arrow(t, get_dictionary=get_dictionary)
    sorting = schema.sorting_key_columns(batch.dynamic_columns())
    batch = batch.sort_by(sorting)
    out = pa.Table.from_batches([batch.to_arrow()])
    out = out.replace_schema_metadata(
        {b"frostdb_tpu.schema": json.dumps(sdef.to_dict()).encode()}
    )
    pq.write_table(out, out_path, compression="zstd")
    print(
        f"reencoded {batch.num_rows} rows -> {out_path} "
        f"(sorted by {[n for n, _s in sorting]})"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="dbtool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parquet-stats")
    p.add_argument("file")
    p = sub.add_parser("parquet-rowgroups")
    p.add_argument("file")
    p = sub.add_parser("parquet-dump")
    p.add_argument("file")
    p.add_argument("--rows", type=int, default=20)
    p = sub.add_parser("parquet-row")
    p.add_argument("start", type=int)
    p.add_argument("n", type=int)
    p.add_argument("file")
    p = sub.add_parser("parquet-find")
    p.add_argument("matchers")
    p.add_argument("path")
    p = sub.add_parser("wal")
    p.add_argument("dir")
    p.add_argument("--verbose", action="store_true")
    p = sub.add_parser("snapshot")
    p.add_argument("file")
    p = sub.add_parser("reencode")
    p.add_argument("file")
    p.add_argument("schema")
    p.add_argument("out")
    args = ap.parse_args(argv)

    if args.cmd == "parquet-stats":
        parquet_stats(args.file)
    elif args.cmd == "parquet-rowgroups":
        parquet_rowgroups(args.file)
    elif args.cmd == "parquet-dump":
        parquet_dump(args.file, args.rows)
    elif args.cmd == "parquet-row":
        parquet_row(args.file, args.start, args.n)
    elif args.cmd == "parquet-find":
        parquet_find(args.matchers, args.path)
    elif args.cmd == "wal":
        wal_inspect(args.dir, args.verbose)
    elif args.cmd == "snapshot":
        snapshot_inspect(args.file)
    elif args.cmd == "reencode":
        parquet_reencode(args.file, args.schema, args.out)


if __name__ == "__main__":
    main()
