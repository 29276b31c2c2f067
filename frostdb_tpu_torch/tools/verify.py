"""Compiled-vs-generic parity check of the port on a device.

The port of the JAX package's ``tools/verify_tpu.py``: the same cases,
drawn from the same ``default_rng(1000 + seed)``, through the port's
engine. Each case builds a randomized multi-part table and asserts the
compiled serving tier emits byte-identical results to the generic operator
DAG, covering:

- sum/count/min/max, bias-shifted negative and nanosecond-magnitude values
- wide (two-plane) value spans past 32 bits
- multiple value columns per query
- integral float64 columns on the integer kernel path
- first-occurrence emission order with many codes first selected in one
  block
- ordered (key-order) emission
- filtered and unfiltered scans, multi-part streams

The fast run must be served by the ``compiled`` tier; on a CUDA device it
must also launch at least one of the sum/count and min/max kernels (K1-K4,
and K3 wherever the case takes min or max), so a decline to the generic
DAG cannot pass as parity. Runs every case and exits nonzero if any
mismatched. Usage:

    python -m frostdb_tpu_torch.tools.verify [--seeds N] [--device cuda|cpu]
                                             [--rows-scale N]

``--rows-scale`` multiplies the reference's 1500-3000 rows per part.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

# The sum/count and min/max kernels of the compiled tier (K1-K4).
AGG_KERNELS = (
    "fused_band_group_sum_count",
    "group_sum_count",
    "group_min_max",
    "fused_cmp_group_sum_count",
)


def _batch_tuples(batches):
    rows = []
    for b in batches:
        for i in range(b.num_rows):
            rows.append(tuple((c.name, c.py_value(i)) for c in b.columns))
    return rows


def _encode_draws(dictionary, draws, fmt):
    """Codes of the strings ``fmt.format(d)`` for each draw, as encoding
    them row by row gives: the distinct values are encoded once, in order
    of first occurrence."""
    uniq, first = np.unique(draws, return_index=True)
    order = uniq[np.argsort(first, kind="stable")]
    codes, _valid = dictionary.encode([fmt.format(int(v)) for v in order])
    lut = np.zeros(int(uniq.max()) + 1, dtype=np.int32)
    lut[order] = codes
    return lut[draws], np.ones(len(draws), dtype=bool)


def _mk_table(rng, n_parts, rows, value_maker, k_types=7, *, device, rows_scale=1):
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.schema import sample_definition_with_float
    from frostdb_tpu_torch.table import TableConfig

    rows *= rows_scale
    store = ColumnStore(device=device)
    db = store.db("vtpu")
    table = db.table("t", TableConfig(schema=sample_definition_with_float()))
    d_et = table.dictionary("example_type")
    for _ in range(n_parts):
        n = int(rng.integers(max(1, rows // 2), rows + 1))
        et, etv = _encode_draws(d_et, rng.integers(0, k_types, n), "type{}")
        vals = value_maker(rng, n)
        cols = [
            Column("example_type", KIND_DICT, et, etv, d_et),
            Column(
                "timestamp",
                KIND_INT64,
                rng.integers(0, 100, n).astype(np.int64),
                np.ones(n, dtype=bool),
            ),
        ]
        for name, kind, v in vals:
            cols.append(Column(name, kind, v, np.ones(n, dtype=bool)))
        table.insert_record(ColumnBatch(cols, n))
    return db, table


def _run(db, compiled, aggs, filt, ordered):
    """The query's batches and the tier that served it."""
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions

    engine = LocalEngine(
        db.table_provider(),
        ExecOptions(compiled_serving=compiled, ordered_aggregations=ordered),
    )
    q = engine.scan_table("t")
    if filt is not None:
        q = q.filter(filt)
    out = []
    q.aggregate(aggs, [E.Col("example_type")]).execute(out.append)
    return out, engine.last_serving_path


CASES = []


def case(name):
    def deco(fn):
        CASES.append((name, fn))
        return fn

    return deco


def _int_col(lo, hi):
    def maker(rng, n):
        return [("value", "int64", rng.integers(lo, hi, n).astype(np.int64))]

    return maker


@case("small-ints sum/count/min/max, filtered")
def _c1(rng, mk):
    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 3, 3000, _int_col(0, 100000))
    aggs = [
        E.Sum(E.Col("value")),
        E.Count(E.Col("value")),
        E.Min(E.Col("value")),
        E.Max(E.Col("value")),
    ]
    return db, aggs, E.Col("timestamp").gt_eq(50), False


@case("bias-shifted negatives")
def _c2(rng, mk):
    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 2, 2000, _int_col(-50_000, 50_000))
    aggs = [E.Sum(E.Col("value")), E.Min(E.Col("value")), E.Max(E.Col("value"))]
    return db, aggs, None, False


@case("nanosecond-timestamp magnitude (31-bit span, huge bias)")
def _c3(rng, mk):
    base = 1_755_000_000_000_000_000

    def maker(rng, n):
        return [
            (
                "value",
                "int64",
                base + rng.integers(0, 2**31 - 1, n).astype(np.int64),
            )
        ]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 2, 2000, maker)
    return db, [E.Sum(E.Col("value")), E.Count(E.Col("value"))], None, False


@case("wide 53-bit span (two-plane sums)")
def _c4(rng, mk):
    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 2, 2000, _int_col(-(2**52), 2**52))
    return db, [E.Sum(E.Col("value")), E.Count(E.Col("value"))], None, False


@case("wide-span min/max (two-plane lexicographic, ns timestamps)")
def _c4b(rng, mk):
    base = 1_755_000_000_000_000_000

    def maker(rng, n):
        return [
            (
                "value",
                "int64",
                base + rng.integers(0, 2**40, n).astype(np.int64),
            )
        ]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 3, 2000, maker)
    aggs = [
        E.Min(E.Col("value")),
        E.Max(E.Col("value")),
        E.Sum(E.Col("value")),
    ]
    return db, aggs, E.Col("timestamp").gt_eq(20), False


@case("wide-span min/max hi-plane ties across parts")
def _c4c(rng, mk):
    def maker(rng, n):
        hi = rng.integers(0, 4, n).astype(np.int64)
        lo = rng.integers(0, 2**28, n).astype(np.int64)
        return [("value", "int64", (hi << 33) + lo)]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 4, 1500, maker)
    aggs = [E.Min(E.Col("value")), E.Max(E.Col("value"))]
    return db, aggs, None, False


@case("multiple value columns")
def _c5(rng, mk):
    def maker(rng, n):
        return [
            ("value", "int64", rng.integers(0, 1000, n).astype(np.int64)),
            ("value2", "int64", rng.integers(-900, 900, n).astype(np.int64)),
        ]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 3, 1500, maker)
    aggs = [
        E.Sum(E.Col("value")),
        E.Sum(E.Col("value2")),
        E.Min(E.Col("value2")),
        E.Count(E.Col("value")),
    ]
    return db, aggs, E.Col("timestamp").lt(80), False


@case("integral float64 on the integer path")
def _c6(rng, mk):
    def maker(rng, n):
        return [
            (
                "floatvalue",
                "float64",
                rng.integers(-1000, 1000, n).astype(np.float64),
            )
        ]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 2, 2000, maker)
    aggs = [
        E.Sum(E.Col("floatvalue")),
        E.Min(E.Col("floatvalue")),
        E.Max(E.Col("floatvalue")),
    ]
    return db, aggs, None, False


@case("emission-order ties inside one superblock")
def _c7(rng, mk):
    # Many codes first selected inside one 8192-row block: the emission
    # order must still be each code's exact first selected row.
    def maker(rng, n):
        return [("value", "int64", np.arange(n, dtype=np.int64))]

    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 1, 2000, maker, k_types=64)
    return db, [E.Sum(E.Col("value"))], E.Col("timestamp").gt_eq(30), False


@case("ordered (key-order) emission")
def _c8(rng, mk):
    from frostdb_tpu_torch.query import expr as E

    db, _ = mk(rng, 2, 1500, _int_col(0, 1000), k_types=20)
    return db, [E.Sum(E.Col("value")), E.Count(E.Col("value"))], None, True


def launch_problems(aggs, launches):
    """Why a fast run on a CUDA table with these K1-K4 ``launches`` did not
    go through the kernels: none launched, or no K3 for a min or max."""
    from frostdb_tpu_torch.query.expr import AGG_MAX, AGG_MIN

    problems = []
    if not any(launches.values()):
        problems.append("fast run launched none of K1-K4")
    if any(a.func in (AGG_MIN, AGG_MAX) for a in aggs) and not launches["group_min_max"]:
        problems.append("min/max case did not launch K3 (group_min_max)")
    return problems


def run_case(fn, seed, device="cuda", rows_scale=1):
    """One case at one seed: builds its table on ``device``, runs the query
    on the compiled tier and on the generic DAG, and returns a dict with
    both results' rows (``compiled``, ``generic``), the fast run's tier
    (``path``), the K1-K4 launches of the fast run (``launches``), the
    table's rows and ``problems``: why the case fails, empty when it
    passes."""
    from frostdb_tpu_torch.ops import agg_kernels as AK

    rng = np.random.default_rng(1000 + seed)
    mk = functools.partial(_mk_table, device=device, rows_scale=rows_scale)
    db, aggs, filt, ordered = fn(rng, mk)
    rows = sum(p.num_rows() for p in db.get_table("t").collect_parts(db.high_watermark()))
    before = {k: AK.LAUNCHES[k] for k in AGG_KERNELS}
    fast, path = _run(db, True, aggs, filt, ordered)
    launches = {k: AK.LAUNCHES[k] - before[k] for k in AGG_KERNELS}
    slow, _slow_path = _run(db, False, aggs, filt, ordered)
    ft, st = _batch_tuples(fast), _batch_tuples(slow)
    problems = []
    if path != "compiled":
        problems.append(f"fast run served by {path!r}, not 'compiled'")
    if db.get_table("t").device.type == "cuda":
        problems += launch_problems(aggs, launches)
    if ft != st:
        problems.append("MISMATCH")
        for i, (a, b) in enumerate(zip(ft, st)):
            if a != b:
                problems.append(f"  row {i}: compiled={a}")
                problems.append(f"  row {i}:  generic={b}")
                break
        if len(ft) != len(st):
            problems.append(f"  rows: compiled={len(ft)} generic={len(st)}")
    return {
        "compiled": ft,
        "generic": st,
        "path": path,
        "launches": launches,
        "rows": rows,
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument(
        "--rows-scale", type=int, default=1,
        help="multiplies the rows per part (1500-3000 at 1)",
    )
    args = ap.parse_args(argv)

    from frostdb_tpu_torch.config import resolve_device

    dev = resolve_device(args.device)
    name = ""
    if dev.type == "cuda":
        import torch

        from frostdb_tpu_torch.ops import agg_kernels as AK

        AK.build()
        name = f" ({torch.cuda.get_device_name(dev)})"
    print(f"device: {dev}{name}, rows scale {args.rows_scale}", flush=True)

    failures = 0
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        for case_name, fn in CASES:
            r = run_case(fn, seed, args.device, args.rows_scale)
            counts = ", ".join(f"{k} {n}" for k, n in r["launches"].items() if n)
            if r["problems"]:
                failures += 1
                print(f"[seed {seed}] {case_name}: FAIL ({r['rows']} rows)")
                for line in r["problems"]:
                    print(f"  {line}")
            else:
                print(
                    f"[seed {seed}] {case_name}: ok ({len(r['compiled'])} groups, "
                    f"{r['rows']} rows; launches: {counts or 'none'})",
                    flush=True,
                )
    print(f"{args.seeds * len(CASES)} cases in {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"FAIL: {failures} case(s) failed")
        return 1
    print("PASS: compiled tier byte-identical to the generic DAG")
    return 0


if __name__ == "__main__":
    sys.exit(main())
