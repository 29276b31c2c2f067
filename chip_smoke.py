#!/usr/bin/env python3
"""Smoke run of frostdb_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--parts N]

Builds the CUDA kernels from frostdb_tpu_torch/csrc/ (one nvcc per source,
all started together) and holds each kernel against its plain PyTorch
version on the card (edge cases, exactly; for the sum/count and min/max
kernels also the code layouts they are designed for: sorted runs across
the vector, warp, block and grid-stride boundaries, one code, two random
codes, out-of-range codes, ragged lengths, 2048 codes, unaligned planes,
the count-only pass, int32-extreme values, negative selection entries and
min/max's second pass over a wide column; for the dense segment reduction
K up to 4,096, runs of 1-16,380 rows, int64 sums that wrap, live counts
below the padded length and the 6- and 7-part layouts of a 67M-row
table; for the dense table reduction K 4,097 to 2^20, uniform, Zipf 1.1,
hot and run-length codes, codes out of range, 0-13 sum planes, row bases
past 2^31, a Merge part's Zipf stream and TSBS's ten-plane shape). Then
drives six paths, each with the launch counts set to 0 just before it and
read just after:

1. the aggregate shapes (slice 1): the engine's hot filter + group-by
   query shapes through LocalEngine on a 32 x 2^21-row table (the shape of
   bench.py's engine_bench; --parts cuts the 32), every result checked
   against a numpy reference and against the port's generic operator DAG,
   float sums checked on both paths, the queries timed and profiled;
2. the scan and distinct shapes (slice 2) on the same table: filter ->
   project [-> limit] on the compiled_scan tier, the Parca Values/Types
   distincts on compiled_distinct and Labels on schema_meta, each checked
   against the generic DAG (rows and batch boundaries) and numpy, timed and
   profiled;
3. the join shapes (slice 3) on the same table as the probe side, against
   three small build tables: six aggregates over inner, semi, anti and
   left_outer joins on a dictionary key and an int64 key, served by the
   compiled_join tier on the sum/count and min/max kernels, each checked
   against numpy at full width and against the generic DAG on a 2-part
   table; and a join that returns rows, on the generic HashJoin, checked
   row for row against a numpy join; timed and profiled;
4. the dense shapes (slice 4) on a second 32 x 2^21-row table whose
   stacktraces take 131,072 values at Zipf-like frequencies: Parca's merge
   (sum and count by stacktrace over a time range) on the dense tier's
   table route, its min/max and a sum with a min on its sorted route, a
   (label, window) group-by of 4096 codes on its segment route and a
   (label, stacktrace) group-by of 8,388,608 codes on its shuffle route,
   each checked against numpy at full width and against the generic DAG
   on a 2-part table, timed and profiled; no K1-K6 kernel may run here
   (the dense tier is torch ops, dense_segment_sum_count on the segment
   route and dense_table_sum_count on the table route, both of which must
   run);
5. the mesh shapes (slice 7): the five aggregate shapes, dense_stack,
   dense_shuffle, an exact float sum, a float min/max and join_rows under
   ExecOptions(mesh=...) at 1 and at 4 shards (the 4 shards all on the one
   card), each served by the mesh tier (join_rows by the generic HashJoin,
   its pairs expanded by the distributed join) and equal, in order, to the
   same shape on its local tier; no K1-K6 kernel may run here (the mesh
   tier is torch ops, dense_segment_sum_count and dense_table_sum_count);
   dense_shuffle at 4 shards must move pairs across shards; then the
   distributed modules (filter-aggregate, distinct, shuffle, join) against
   numpy, timings and a profile at each shard count, the sharded upload's
   bytes and seconds;
6. the kernel bench (bench.py's data): 8 datasets of 2^25 rows through the
   fused `ts >= literal` sum/count kernel, checked exactly against numpy.

Then every engine shape of paths 1-4 runs once more as SQL text through the
port's SQL front end and must take the same tier and give the same rows.

7. the durability path (slice 5): the engine table's data written again,
   insert by insert, into a store as Parca runs one with persistence (WAL
   fsynced per insert, a parquet bucket as sink and source, snapshots every
   256 MiB, rotation at 512 MiB), a hard kill after the last acknowledged
   insert, recovery on the card timed by part (snapshot load, WAL replay,
   the first query's bucket reads), then five aggregate shapes, a scan and
   a distinct on the recovered table, each on its tier, equal to numpy over
   every acknowledged row and to the same shape on the in-memory table,
   each kernel call equal to its plain version, timed and profiled; one
   shape over gRPC on localhost, and dbtool on the store's WAL and snapshot.
8. the rest of the package (phase 9, after the kernel checks and paths
   1-7): tools/verify's cases at two seeds, at the reference's 750-3000
   rows a part and at 1024 times that, each on the compiled tier (K1-K3)
   equal byte for byte to the generic DAG; tests/test_scan_fanout.py's
   five shapes on the 2-part table with the scan fan-out forced on and
   off, equal byte for byte, lane threads counted; 4 writers and a
   compactor under two readers running a compiled aggregate (K1), every
   result equal to numpy over the inserts at a watermark the reader saw;
   a traced compiled and a traced generic query (span trees, counters);
   the pruning shapes (parts pruned as the layout says, results equal to
   numpy and to an unpruned scan); a struct table through a query,
   rotation and recovery; the aggregate shapes' latency on the engine
   table with the compiled read path's view and dictionary lock and
   without them, in alternating rounds.
9. the reference's differential fuzz (phase 10, after phase 9):
   frostdb_tpu_torch/tools/fuzz.py's scenarios (random schemas, data with
   null keys and float edge values, CNF filters, every aggregation,
   windowed keys, scans, ORDER BY + LIMIT, four kinds of join) at the
   reference's 38 seeds, 60 more aggregate seeds and the directed kernel
   shapes, each query's generic, compiled and mesh runs equal on the card
   and equal to the same query on a CPU copy of its tables; then at 1024
   times the rows, generic == compiled (== mesh) on the card; K1-K4 and K6
   must launch and compiled, compiled_scan, compiled_join and mesh serve.

Last, each kernel is checked and timed on the inputs its path gave it
(K1, K2 and K3 on every shape that launches them), beside its plain
version, a one-call PyTorch yardstick and three bounds (padded rows, live
rows, 32-byte sectors with a selected row). Prints a
``kernels`` JSON line and, last, an ``ok`` JSON line. Exits non-zero,
printing no result, without a CUDA device or without the package beside
it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT32_OPS_PER_S = 33.5e12  # H100 SXM non-tensor int32 (half its fp32 rate)
NUM_CODES = 64
ROWS_PER_PART = 1 << 21  # bench.py engine_bench
SEED = 0  # bench.py engine_bench's rng(0)
QUERY_REPS = 10

# The dense phase's stacks table: stacktrace codes from NUM_STACKS distinct
# stacks at Zipf-like frequencies; DENSE_WINDOW is the segment shape's
# timestamp window (64 labels x 64 padded windows = 4096 codes).
NUM_STACKS = 1 << 17
STACK_ZIPF = 1.1
DENSE_WINDOW = 20

BENCH_ROWS = 1 << 25  # bench.py's kernel bench on the TPU: 2^25 rows
BENCH_DATASETS = 8
BENCH_LITERAL = 50

# name -> (Pallas entry it replaces, int ops per row, CUDA source)
KERNELS = {
    "fused_band_group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:264", 6, "agg.cu"),
    "group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:156", 5, "agg.cu"),
    "group_min_max": ("frostdb_tpu/ops/pallas_agg.py:435", 5, "agg.cu"),
    "fused_cmp_group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:319", 6, "agg.cu"),
    "filter_group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:216", 5, "agg.cu"),
    "block_compact": ("frostdb_tpu/ops/pallas_agg.py:570", 3, "compact.cu"),
}
SLICE1_KERNELS = (
    "fused_band_group_sum_count", "group_sum_count", "group_min_max",
    "fused_cmp_group_sum_count",
)
# Kernels captured and timed on every shape that launches them (the rest on
# the first shape only).
PER_SHAPE_KERNELS = ("fused_band_group_sum_count", "group_sum_count", "group_min_max")

# Position of num_codes among each wrapper's arguments.
NUM_CODES_ARG = {
    "fused_band_group_sum_count": 4,
    "group_sum_count": 3,
    "group_min_max": 3,
    "fused_cmp_group_sum_count": 5,
    "filter_group_sum_count": 4,
}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median time of one call alone, from CUDA events around each call:
    where the device waits on the host's launch work, that wait counts."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def chained_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Time per call over ``reps`` calls issued back to back between two
    CUDA events: the device's time per call once the host's launch work
    overlaps the calls before it."""
    import torch

    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(out, ref) -> int:
    import torch

    err = 0
    for o, r in zip(out, ref):
        torch.cuda.synchronize()
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        if o.numel():
            d = (o.to(torch.int64) - r.to(torch.int64)).abs().max()
            err = max(err, int(d.item()))
    return err


# ---------------------------------------------------------------------------
# Kernel phase


def kernel_inputs(n, num_codes, vmax, sel_p, seed, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, num_codes, (n,), generator=g, device=dev, dtype=torch.int32)
    values = torch.randint(0, vmax, (n,), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    ts = torch.randint(0, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
    u = torch.rand(n, generator=g, device=dev)
    sel = (u < sel_p).to(torch.int32)
    base8 = (torch.rand(n, generator=g, device=dev) < 0.9).to(torch.int8)
    return codes, values, ts, sel, base8


def kernel_calls(x, num_codes, num_digits, lit):
    """(name, wrapper args) per kernel for one input set."""
    codes, values, ts, sel, base8 = x
    return {
        "fused_band_group_sum_count": (
            codes, values, (ts,), (lit,), num_codes, num_digits, (">=",)
        ),
        "group_sum_count": (codes, values, sel, num_codes, num_digits),
        "group_min_max": (codes, values, sel, num_codes),
        "fused_cmp_group_sum_count": (
            codes, values, ts, base8, lit, num_codes, num_digits, "!="
        ),
    }


def new_kernel_edge_cases(AK, dev, errs) -> None:
    """The fused ``ts >= literal`` sum/count (K5) and block compaction (K6)
    against their plain versions, exactly: empty input, no row and every
    row selected, one code and 2048 codes, values that exercise the digit
    mask; for K6 capacities 16, 128 and 1024, blocks with exactly capb
    (and capb +- 1) selected rows, and a partial last block."""
    import torch

    k5 = [  # (n, K, vmax, literal, num_digits)
        (0, 64, 1 << 14, 50, 2),  # empty
        (100_003, 64, 1 << 14, 1000, 2),  # no row selected
        (100_003, 64, 1 << 14, -5, 2),  # every row selected
        ((1 << 20) + 12_345, 2048, 1 << 14, 500, 2),
        (1 << 18, 1, 1 << 14, 500, 3),
        (1 << 18, 64, 2**31 - 1, 500, 2),  # digit mask: 14 of 31 bits kept
        (1 << 18, 64, 2**31 - 1, 100, 5),
    ]
    for i, (n, k, vmax, lit, nd) in enumerate(k5):
        codes, values, ts, _sel, _b = kernel_inputs(n, k, vmax, 0.5, 300 + i, dev)
        args = (codes, values, ts, lit, k, nd)
        out = AK.filter_group_sum_count(*args)
        torch.cuda.synchronize()
        e = max_abs_err(out, AK.filter_group_sum_count_plain(*args))
        errs["filter_group_sum_count"] = max(errs["filter_group_sum_count"], e)
        if e:
            raise AssertionError(f"filter_group_sum_count n={n} K={k}: max abs err {e}")

    rb = AK.BLOCK_ROWS
    g = torch.Generator(device=dev).manual_seed(400)
    n = 37 * rb + 4321  # partial last block
    k6 = [(torch.zeros(0, dtype=torch.int32, device=dev), 16)]  # empty
    for p in (0.0, 1.0, 0.003, 0.05, 0.5):
        sel = (torch.rand(n, generator=g, device=dev) < p).to(torch.int32)
        k6 += [(sel, capb) for capb in (16, 128, 1024)]
    for capb in (16, 128, 1024):
        sel = torch.zeros(4 * rb, dtype=torch.int32, device=dev)
        for b, k in enumerate((capb, capb + 1, capb - 1, rb)):
            pos = torch.randperm(rb, generator=g, device=dev)[:k]
            sel[b * rb + pos] = 1
        k6.append((sel, capb))
    for sel, capb in k6:
        out = AK.block_compact(sel, capb)
        torch.cuda.synchronize()
        ref = AK.block_compact_plain(sel, capb)
        e = max_abs_err(out, ref)
        errs["block_compact"] = max(errs["block_compact"], e)
        if e:
            raise AssertionError(f"block_compact n={sel.numel()} capb={capb}: max abs err {e}")
    log(
        f"kernel edge cases: {len(k5)} input sets of filter_group_sum_count and "
        f"{len(k6)} of block_compact exact"
    )


def layout_codes(layout, n, k, g, dev):
    """Codes of n rows in one of the layouts the sum/count kernels are
    designed for: "uniform", "one code", "2 random codes", "runs:L" (runs
    of L rows, each of one random code) or "oor runs:L" (the same with 5%
    of the rows holding codes outside [0, k))."""
    import torch

    if layout == "uniform":
        return torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    if layout == "one code":
        return torch.full((n,), k - 1, dtype=torch.int32, device=dev)
    if layout == "2 random codes":
        return torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
    kind, length = layout.split(":")
    run = int(length)
    per_run = torch.randint(0, k, (-(-n // run),), generator=g, device=dev, dtype=torch.int32)
    codes = per_run.repeat_interleave(run)[:n].contiguous()
    if kind == "oor runs":
        junk = torch.tensor([-1, k, k + 1000, -(2**31)], dtype=torch.int32, device=dev)
        pick = junk[torch.randint(0, 4, (n,), generator=g, device=dev)]
        codes = torch.where(torch.rand(n, generator=g, device=dev) < 0.05, pick, codes)
    return codes


def sum_count_calls(codes, values, ts, sel, base8, k, nd, lit):
    """(name, wrapper args) of K1 (one and three clauses), K2, K4 and K5 on
    one input set, and of K1, K2 and K4 counting only (no value plane)."""
    calls = []
    for vals in (values, None):
        calls += [
            ("fused_band_group_sum_count", (codes, vals, (ts,), (lit,), k, nd, (">=",))),
            ("fused_band_group_sum_count",
             (codes, vals, (ts, ts, sel), (lit, lit + 500, 1), k, nd, (">=", "<", "=="))),
            ("group_sum_count", (codes, vals, sel, k, nd)),
            ("fused_cmp_group_sum_count", (codes, vals, ts, base8, lit, k, nd, "!=")),
        ]
    calls.append(("filter_group_sum_count", (codes, values, ts, lit, k, nd)))
    return calls


def min_max_calls(AK, codes, values, ts, sel, k):
    """(name, wrapper args) of K3 on one input set: an int32 column, and the
    second pass of a wide (two-plane) column, whose selection keeps the rows
    whose high plane (``values``) equals their code's minimum, as the
    compiled tier builds it (``sel * (hi == mn_hi[code])``)."""
    import torch

    mn_hi, _mx = AK.group_min_max_plain(codes, values, sel, k)
    sel2 = sel * (values == mn_hi[codes.clamp(0, k - 1).long()]).to(torch.int32)
    return [
        ("group_min_max", (codes, values, sel, k)),
        ("group_min_max", (codes, ts, sel2, k)),
    ]


def layout_edge_cases(AK, dev, errs) -> None:
    """The sum/count kernels (K1, K2, K4, K5, and the count-only pass) and
    the min/max kernel (K3, also on a wide column's second pass) against
    their plain versions, exactly, on the code layouts they are designed
    for: sorted runs of 1-513 rows and longer (crossing the 4-row vector,
    the 32-lane warp, the block and the grid stride), one code over all
    rows, 2 random codes, out-of-range codes inside runs, 2048 and 300
    codes (the shared block table), n not a multiple of 4, values whose
    masked sums pass 2^32 in one run (the shared sums' carry), values at
    INT32_MIN and INT32_MAX, a selection plane holding negative values
    (K3 selects only sel > 0), and planes at a 4-byte offset (scalar loads)
    and a 16-byte one (vector loads)."""
    import torch

    n = (1 << 20) + 3
    cases = [(n, 64, f"runs:{r}", 1 << 14, 2) for r in (1, 3, 4, 31, 32, 33, 511, 513)]
    # 4 x 2^20 rows: more than one grid stride of the 132-SM card (4 blocks
    # an SM, 2048 rows a block a step), so runs also cross the stride.
    cases += [((1 << 22) + 3, 64, f"runs:{r}", 1 << 14, 2) for r in (4099, 1 << 17)]
    cases += [
        (n, 64, "one code", 1 << 14, 2),
        ((1 << 20) + 1, 1, "one code", -1, 5),  # every value 2^32 - 1
        ((1 << 20) + 2, 2, "2 random codes", 1 << 14, 2),
        (n, 64, "oor runs:100", 2**31 - 1, 5),
        (n, 2048, "uniform", 1 << 14, 2),
        (n, 2048, "runs:7", 1 << 14, 3),
        (n, 300, "runs:513", 1 << 14, 2),
        (n, 256, "runs:33", 1 << 14, 2),
        (n, 64, "runs:33", "int32 ends", 5),
        (n, 64, "uniform", "negative sel", 2),
    ]
    ends = torch.tensor([-(2**31), 2**31 - 1, -5, 0, 7], dtype=torch.int32, device=dev)
    checked = 0
    for i, (rows, k, layout, vmax, nd) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(500 + i)
        codes = layout_codes(layout, rows, k, g, dev)
        if vmax == -1:
            values = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        elif vmax == "int32 ends":
            values = ends[torch.randint(0, len(ends), (rows,), generator=g, device=dev)]
        else:
            hi = vmax if isinstance(vmax, int) else 1 << 14
            values = torch.randint(0, hi, (rows,), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
        ts = torch.randint(0, 1000, (rows,), generator=g, device=dev, dtype=torch.int32)
        if vmax == "negative sel":
            sel = torch.randint(-3, 3, (rows,), generator=g, device=dev, dtype=torch.int32)
        else:
            sel = (torch.rand(rows, generator=g, device=dev) < 0.7).to(torch.int32)
        base8 = (torch.rand(rows, generator=g, device=dev) < 0.9).to(torch.int8)
        planes = [codes, values, ts, sel, base8]
        offsets = (0, 1, 4) if layout == "runs:33" and k == 64 and vmax == 1 << 14 else (0,)
        for off in offsets:
            x = [t[off:] for t in planes]
            calls = sum_count_calls(*x, k, nd, 300) + min_max_calls(AK, *x[:4], k)
            for name, args in calls:
                out = getattr(AK, name)(*args)
                torch.cuda.synchronize()
                e = max_abs_err(out, getattr(AK, name + "_plain")(*args))
                errs[name] = max(errs[name], e)
                checked += 1
                if e:
                    raise AssertionError(
                        f"{name} on {layout} ({vmax}), n={rows - off}, K={k}, offset {off} rows, "
                        f"count only {args[1] is None}: max abs err {e}"
                    )
    log(f"kernel layout cases: {checked} sum/count and min/max calls over {len(cases)} input sets exact")


def dense_segment_check(AK, what, codes, sel, values, n, row_base, k) -> None:
    """One dense_segment_sum_count call, and its count-only call, against
    the plain version, exactly."""
    import torch

    for vals in (values, None):
        got = AK.dense_segment_sum_count(codes, sel, vals, n, row_base, k)
        torch.cuda.synchronize()
        want = AK.dense_segment_sum_count_plain(codes, sel, vals, n, row_base, k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
            raise AssertionError(
                f"dense_segment_sum_count on {what}, n={n}, row_base={row_base}, K={k}, "
                f"count only {vals is None}: outputs {bad} (counts, first, sums) differ"
            )


def dense_segment_edge_cases(AK, dev) -> None:
    """The dense segment reduction against its plain version, exactly: K
    1, 2,049 and 4,096 (codes up to K - 1) over runs of 1, 7 and 16,380
    rows, every row, 2% of the rows and no row selected, int64 values near
    +-2^63 whose sums wrap, row_base 0 and a shard's ``shard * m``, a live
    count 1,001 rows short of the padded length (the padding selected), n
    not a multiple of the 4-row vector and below one vector, planes at a
    one-row offset (scalar loads); then the (node, minute) codes of a
    67,092,480-row table split into 6 and into 7 parts, as ``sync`` leaves
    range_wide's table, each part a call with a 45-minute selection."""
    import torch

    g = torch.Generator(device=dev).manual_seed(700)
    pad = 3 * 16380 + 13
    checked = 0
    for k in (1, 2049, 4096):
        for run in (1, 7, 16380):
            per_run = torch.randint(0, k, (-(-pad // run),), generator=g, device=dev, dtype=torch.int32)
            per_run[-1] = k - 1
            codes = per_run.repeat_interleave(run)[:pad].contiguous()
            vals = torch.randint(2**62, 2**63 - 1, (pad,), generator=g, device=dev, dtype=torch.int64)
            vals = torch.where(torch.rand(pad, generator=g, device=dev) < 0.5, -vals, vals)
            for selection in ("all", "sparse", "none"):
                sel = {
                    "all": torch.ones(pad, dtype=torch.bool, device=dev),
                    "none": torch.zeros(pad, dtype=torch.bool, device=dev),
                    "sparse": torch.rand(pad, generator=g, device=dev) < 0.02,
                }[selection]
                what = f"runs:{run}, {selection} selected"
                for n, row_base in ((pad, 0), (pad - 1001, 3 * pad), (pad - 2, 0), (3, 5), (1, 0)):
                    dense_segment_check(AK, what, codes, sel, vals, n, row_base, k)
                    checked += 2
                if selection == "sparse":
                    x = [t[1:] for t in (codes, sel, vals)]
                    dense_segment_check(AK, what + ", one-row offset", *x, pad - 1001, pad, k)
                    checked += 2
    rows, runs = 67_092_480, 16_380
    node_minute = torch.arange(rows // runs, dtype=torch.int32, device=dev).repeat_interleave(runs)
    minute = node_minute % 64
    vals = torch.randint(1, 3, (rows,), generator=g, device=dev, dtype=torch.int64)
    for n_parts in (6, 7):
        bounds = [rows * i // n_parts for i in range(n_parts + 1)]
        for lo, hi in zip(bounds, bounds[1:]):
            n = hi - lo
            m = -(-n // 8192) * 8192  # padded as a part's planes are
            codes = torch.zeros(m, dtype=torch.int32, device=dev)
            codes[:n] = node_minute[lo:hi]
            sel = torch.ones(m, dtype=torch.bool, device=dev)
            sel[:n] = minute[lo:hi] >= 19
            v = torch.zeros(m, dtype=torch.int64, device=dev)
            v[:n] = vals[lo:hi]
            dense_segment_check(AK, f"{n_parts}-part layout, rows {lo}-{hi}", codes, sel, v, n, 0, 4096)
            checked += 2
    log(f"dense segment cases: {checked} dense_segment_sum_count calls exact")


def dense_table_check(AK, what, codes, sel, values, n, row_base, k) -> int:
    """One dense_table_sum_count call against the plain version, exactly;
    returns 1."""
    import torch

    got = AK.dense_table_sum_count(codes, sel, values, n, row_base, k)
    torch.cuda.synchronize()
    want = AK.dense_table_sum_count_plain(codes, sel, values, n, row_base, k)
    got, want = [got[0], got[1], *got[2]], [want[0], want[1], *want[2]]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
    if bad or len(got) != len(want):
        raise AssertionError(
            f"dense_table_sum_count on {what}, n={n}, row_base={row_base}, K={k}, "
            f"{len(values)} planes: outputs {bad} (counts, first, sums...) differ"
        )
    return 1


def zipf_codes(k: int, rows: int, g, dev):
    """``rows`` codes of [0, k) with p proportional to 1 / (code + 1)^STACK_ZIPF."""
    import torch

    p = 1.0 / torch.arange(1, k + 1, dtype=torch.float64, device=dev) ** STACK_ZIPF
    return torch.multinomial(p / p.sum(), rows, replacement=True, generator=g).to(torch.int32)


def dense_table_edge_cases(AK, dev) -> None:
    """The dense table reduction against its plain version, exactly: K
    4,097, 131,072 and 2^20 (codes up to K - 1) drawn uniformly, at Zipf
    1.1, with one hot code on half the rows and in runs of 360 rows, a
    selected code outside [0, K) every 97th and 101st row; every row, 2% of
    the rows and no row selected; 0, 1, 12 and 13 int64 planes near +-2^63
    whose sums wrap (13: a second pass over the codes); row_base 0 and past
    2^31; a live count 1,001 rows short of the padding, n not a multiple
    of the 4-row vector and below one vector; planes at a one-row offset
    (scalar loads). Then two shapes at full size: a Merge part (16,777,216
    padded rows, 15,728,640 live, K 131,072 at Zipf 1.1, one sum plane, a
    time range selecting a third of them) and a TSBS part (3,600,000 rows
    of 10,000 (host, hour) runs of 360 rows over K 64,000, ten planes,
    every row selected)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(800)
    pad = 3 * 16380 + 13
    checked = 0
    for k in (4097, 131072, 1 << 20):
        layouts = {
            "uniform": torch.randint(0, k, (pad,), generator=g, device=dev, dtype=torch.int32),
            "zipf": zipf_codes(k, pad, g, dev),
            "hot": torch.where(torch.rand(pad, generator=g, device=dev) < 0.5, k - 1,
                               torch.randint(0, k, (pad,), generator=g, device=dev)).to(torch.int32),
            "runs:360": torch.randint(0, k, (-(-pad // 360),), generator=g, device=dev,
                                      dtype=torch.int32).repeat_interleave(360)[:pad],
        }
        for layout, codes in layouts.items():
            codes = codes.contiguous()
            codes[::97] = -1
            codes[::101] = k
            for planes in (0, 1, 12, 13):
                vals = []
                for _p in range(planes):
                    v = torch.randint(2**62, 2**63 - 1, (pad,), generator=g, device=dev, dtype=torch.int64)
                    vals.append(torch.where(torch.rand(pad, generator=g, device=dev) < 0.5, -v, v))
                for selection in ("all", "sparse", "none"):
                    sel = {
                        "all": torch.ones(pad, dtype=torch.bool, device=dev),
                        "none": torch.zeros(pad, dtype=torch.bool, device=dev),
                        "sparse": torch.rand(pad, generator=g, device=dev) < 0.02,
                    }[selection]
                    what = f"{layout}, {selection} selected"
                    for n, row_base in ((pad, 0), (pad - 1001, 3 * 2**31 + 7), (pad - 2, 0), (3, 5)):
                        checked += dense_table_check(AK, what, codes, sel, vals, n, row_base, k)
                    if selection == "all" and planes == 1:
                        x = [t[1:] for t in (codes, sel)]
                        checked += dense_table_check(
                            AK, what + ", one-row offset", *x, [v[1:] for v in vals], pad - 1001, pad, k)
    m, live = 1 << 24, 15 * (1 << 20)
    codes = zipf_codes(NUM_STACKS, m, g, dev)
    sel = torch.zeros(m, dtype=torch.bool, device=dev)
    sel[live // 3: 2 * live // 3] = True
    v = torch.randint(1, 3, (m,), generator=g, device=dev, dtype=torch.int64)
    checked += dense_table_check(AK, "a Merge part", codes, sel, [v], live, 0, NUM_STACKS)
    rows = 3_600_000
    codes = torch.randperm(64_000, generator=g, device=dev)[:rows // 360].to(torch.int32).repeat_interleave(360)
    vals = [torch.randint(0, 101, (rows,), generator=g, device=dev, dtype=torch.int64) for _ in range(10)]
    checked += dense_table_check(AK, "a TSBS part", codes, torch.ones(rows, dtype=torch.bool, device=dev),
                                 vals, rows, 2**31, 64_000)
    log(f"dense table cases: {checked} dense_table_sum_count calls exact")


def kernel_phase(AK, dev, main_rows):
    import torch

    errs = {k: 0 for k in KERNELS}
    new_kernel_edge_cases(AK, dev, errs)
    layout_edge_cases(AK, dev, errs)
    dense_segment_edge_cases(AK, dev)
    dense_table_edge_cases(AK, dev)
    # Edge cases: code spaces, every row filtered out, a ragged length,
    # values near 2^31, 3-clause bands with a dict-style equality.
    cases = [
        (100_003, 1, 1 << 14, 0.5, 2, 500),
        (100_003, 127, 1 << 14, 0.5, 2, 500),
        (65_536, 128, 1 << 21, 0.5, 3, 0),
        ((1 << 20) + 12_345, 129, 1 << 14, 0.3, 2, 999),
        (1 << 20, 2048, 1 << 14, 0.5, 2, 500),
        (1 << 18, 64, 1 << 14, 0.0, 2, 500),  # all filtered (sel/min-max)
        (1 << 18, 64, 1 << 14, 0.5, 2, 1000),  # all filtered (band)
        (1 << 18, 64, 2**31 - 1, 0.9, 5, 100),  # values near 2^31
    ]
    for i, (n, k, vmax, sel_p, nd, lit) in enumerate(cases):
        x = kernel_inputs(n, k, vmax, sel_p, 100 + i, dev)
        for name, args in kernel_calls(x, k, nd, lit).items():
            out = getattr(AK, name)(*args)
            torch.cuda.synchronize()
            ref = getattr(AK, name + "_plain")(*args)
            e = max_abs_err(out, ref)
            errs[name] = max(errs[name], e)
            if e:
                raise AssertionError(f"{name} n={n} K={k}: max abs err {e}")
    codes, values, ts, sel, _b = x = kernel_inputs(main_rows, 64, 1 << 14, 0.5, 7, dev)
    c3 = (codes % 5).contiguous()
    band3 = (codes, values, (ts, ts, c3), (100, 900, 3), 64, 2, (">=", "<", "=="))
    out = AK.fused_band_group_sum_count(*band3)
    errs["fused_band_group_sum_count"] = max(
        errs["fused_band_group_sum_count"],
        max_abs_err(out, AK.fused_band_group_sum_count_plain(*band3)),
    )
    log(f"kernel edge cases: {len(cases)} input sets x {len(SLICE1_KERNELS)} kernels exact")

    # Uniform random codes at the main path's row count, the regime of hashed
    # keys (the main path's own inputs are timed by main_path_kernels).
    for name, args in kernel_calls(x, NUM_CODES, 2, 500).items():
        wrapper = getattr(AK, name)
        log(
            f"kernel {name}: {chained_ms(lambda: wrapper(*args)):.4f} ms a call in "
            f"a chain, {cuda_ms(lambda: wrapper(*args)):.4f} ms alone on "
            f"uniform random codes, {main_rows} rows, K={NUM_CODES}, "
            f"{int(_selection(name, args).sum())} rows selected"
        )
    return errs


def _selection(name, args):
    """The rows a kernel's predicate selects (bool), computed with torch."""
    import torch

    cmp = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
           "==": torch.eq, "!=": torch.ne}
    if name == "block_compact":
        return args[0] != 0
    if name == "filter_group_sum_count":
        return args[2] >= int(args[3])
    if name == "group_sum_count":
        return args[2] != 0
    if name == "group_min_max":
        return args[2] > 0
    if name == "fused_band_group_sum_count":
        _c, _v, planes, lits, _k, _nd, ops = args
        m = None
        for plane, lit, op in zip(planes, lits, ops):
            x = cmp[op](plane, int(lit))
            m = x if m is None else m & x
        return m
    _c, _v, ts, base8, lit, _k, _nd, op = args
    return (base8 != 0) & cmp[op](ts, int(lit))


@contextlib.contextmanager
def capture_kernel_args(AK):
    """Record (name, arguments) of every kernel wrapper call made while the
    block runs, in order; the wrappers are restored after it."""
    seen: list = []
    saved = {name: getattr(AK, name) for name in KERNELS}

    def recorder(name, fn):
        def call(*args):
            seen.append((name, args))
            return fn(*args)

        return call

    for name, fn in saved.items():
        setattr(AK, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(AK, name, fn)


def keep_captures(captured, shape, calls) -> None:
    """Add one shape's kernel calls ``calls`` [(name, args)] to
    ``captured`` {(name, shape): args}: each kernel's first call of the
    shape for PER_SHAPE_KERNELS, a kernel's first call of any shape for the
    rest."""
    for name, args in calls:
        if name in PER_SHAPE_KERNELS:
            captured.setdefault((name, shape), args)
        elif all(n != name for n, _shape in captured):
            captured[(name, shape)] = args


def main_path_kernels(AK, captured, errs, launches, live_rows):
    """Each kernel against its plain version on the inputs its path gave
    it, timed beside the plain version and a one-call yardstick. The bound
    (``bound_ms``) counts what the kernel must read and write: for the
    sum/count and min/max kernels the predicate planes in full, padding
    included, and the code and value of each selected row (the kernel
    reads no other), plus the outputs; for block compaction the selection
    plane and the ``n_blocks x (1 + capb)`` output. ``bound_live_ms``
    counts the planes over ``live_rows[name]`` rows only, the bound once
    parts are not padded. ``bound_sector_ms`` counts the code and value
    planes by the 32-byte sectors (8 rows) that hold a selected row, the
    least the card can move for them: where selected rows come in runs (the
    main path's sorted parts) it is ``bound_ms``, but where they are
    scattered (K5's bench data selects half its rows at random, so nearly
    every sector holds one) the card moves every sector of both planes and
    ``bound_ms`` cannot be reached. A count-only call (``values`` None)
    reads the code of each selected row and no value. Every plane must be
    16-byte aligned, so the sum/count kernels take their vector loads."""
    import torch

    rows = []
    for (name, shape), args in captured.items():
        if any(t.data_ptr() % 16 for t in _tensors(args)):
            raise AssertionError(f"{name} on {shape}'s inputs: a plane is not 16-byte aligned")
        wrapper = getattr(AK, name)
        plain = getattr(AK, name + "_plain")
        out = wrapper(*args)
        torch.cuda.synchronize()
        e = max_abs_err(out, plain(*args))
        if e:
            raise AssertionError(f"{name} on the main path's inputs: max abs err {e}")
        live = _selection(name, args)
        n_sel = int(live.sum())
        out_bytes = sum(o.numel() * o.element_size() for o in out)
        if name == "block_compact":
            sel, capb = args
            n = sel.numel()
            view = sel.reshape(-1, AK.BLOCK_ROWS)

            def library():
                torch.nonzero(view)
                view.sum(dim=1)

            plane_bytes, row_bytes, sector_bytes = n * sel.element_size(), 0, 0
            what = f"capb={capb}"
        else:
            codes, values = args[0], args[1]
            n = codes.numel()
            k = args[NUM_CODES_ARG[name]]
            # Unselected rows may hold any code; the yardstick sends them to 0.
            codes64 = torch.where(live, codes, 0).long()
            if name == "group_min_max":
                vmin = torch.where(live, values, 2**31 - 1)
                vmax = torch.where(live, values, -(2**31))

                def library():
                    # No single PyTorch call gives both: one scatter_reduce_ each.
                    torch.full((k,), 2**31 - 1, dtype=torch.int32, device=codes.device).scatter_reduce_(0, codes64, vmin, "amin")
                    torch.full((k,), -(2**31), dtype=torch.int32, device=codes.device).scatter_reduce_(0, codes64, vmax, "amax")
            else:
                masked = live.long() if values is None else torch.where(live, values.long(), 0)

                def library():
                    torch.zeros(k, dtype=torch.int64, device=codes.device).index_add_(0, codes64, masked)

            plane_bytes = sum(t.numel() * t.element_size() for t in _tensors(args[2:]))
            row_bytes = n_sel * (4 if values is None else 8)
            sector_bytes = sum(32 * _sectors(live, t) for t in (codes, values) if t is not None)
            what = f"K={k}" + (", count only" if values is None else "")
        live_n = live_rows[name]
        ops_per_row = KERNELS[name][1]
        bytes_ms = (plane_bytes + row_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = n * ops_per_row / INT32_OPS_PER_S * 1e3
        live_bytes = plane_bytes * live_n / n + row_bytes + out_bytes
        live_ms = max(
            live_bytes / HBM_BYTES_PER_S * 1e3,
            live_n * ops_per_row / INT32_OPS_PER_S * 1e3,
        )
        sector_ms = max(
            (plane_bytes + sector_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, ops_ms
        )
        ms = chained_ms(lambda: wrapper(*args))
        call_ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = chained_ms(lambda: plain(*args), reps=5, warm=1)
        lib_ms = chained_ms(library, reps=5, warm=1)
        rows.append({
            "name": name,
            "shape": shape,
            "route": "cuda",
            "source": "frostdb_tpu_torch/csrc/" + KERNELS[name][2],
            "replaces": KERNELS[name][0],
            "launches": launches[name],
            "max_abs_err": max(errs[name], e),
            "ms": ms,
            "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_live_ms": live_ms,
            "bound_sector_ms": sector_ms,
            "library_ms": lib_ms,
        })
        log(
            f"kernel {name} on {shape}'s inputs: {ms:.4f} ms a call in a chain, "
            f"{call_ms:.4f} ms alone (plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms on "
            f"{n} padded rows, {live_ms:.4f} ms on {live_n} live rows, "
            f"{rows[-1]['bound_sector_ms']:.4f} ms by sectors) "
            f"with {n_sel} selected, {what}"
        )
    return rows


def _sectors(live, plane) -> int:
    """32-byte sectors of the int32 ``plane`` that hold a row where the
    bool ``live`` is true (sectors counted from the plane's address)."""
    import torch

    lead = (plane.data_ptr() % 32) // plane.element_size()
    m = torch.cat([live.new_zeros(lead), live.reshape(-1)])
    m = torch.cat([m, m.new_zeros(-m.numel() % 8)])
    return int(m.view(-1, 8).any(dim=1).sum())


def _tensors(args):
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, tuple):
            yield from (t for t in a if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Engine phase


def build_table(db, name, n_parts, floats=None, seed=SEED, stack_p=None,
                sync=True, insert_s=None):
    """bench.py engine_bench's table: n_parts records of ROWS_PER_PART rows,
    64 label codes, int64 timestamp and value in [0, 1000). With
    ``floats(rng, n)`` the table also holds the float64 ``floatvalue``
    column of ``sample_definition_with_float``, filled from it. With
    ``stack_p`` (a probability per stack), ``stacktrace`` codes are drawn
    from ``len(stack_p)`` distinct stacks ``s0, s1, ...`` at those
    probabilities, else every row holds the one stack ``stack``. The table
    is synced at the end unless ``sync`` is false; ``insert_s``, a list,
    gets each insert's seconds."""
    from frostdb_tpu_torch.columnbatch import (
        Column, ColumnBatch, KIND_DICT, KIND_FLOAT64, KIND_INT64,
    )
    from frostdb_tpu_torch.schema import sample_definition, sample_definition_with_float
    from frostdb_tpu_torch.table import TableConfig

    rng = np.random.default_rng(seed)
    schema = sample_definition() if floats is None else sample_definition_with_float()
    table = db.table(name, TableConfig(schema=schema))
    data = []
    for _p in range(n_parts):
        n = ROWS_PER_PART
        d_et = table.dictionary("example_type")
        d_l = table.dictionary("labels")
        d_st = table.dictionary("stacktrace")
        d_et.encode(["cpu"])
        codes = rng.integers(0, NUM_CODES, n).astype(np.int32)
        d_l.encode([f"g{i}" for i in range(NUM_CODES)])
        if stack_p is None:
            d_st.encode(["stack"])
            stacks = np.zeros(n, np.int32)
        else:
            if not len(d_st):
                d_st.encode([f"s{i}" for i in range(len(stack_p))])
            stacks = rng.choice(len(stack_p), n, p=stack_p).astype(np.int32)
        ts = rng.integers(0, 1000, n).astype(np.int64)
        val = rng.integers(0, 1000, n).astype(np.int64)
        ones = np.ones(n, bool)
        cols = [
            Column("example_type", KIND_DICT, np.zeros(n, np.int32), ones, d_et),
            Column("labels.label1", KIND_DICT, codes, ones, d_l),
            Column("stacktrace", KIND_DICT, stacks, ones, d_st),
            Column("timestamp", KIND_INT64, ts, ones),
            Column("value", KIND_INT64, val, ones),
        ]
        if floats is not None:
            fv = floats(rng, n)
            cols.append(Column("floatvalue", KIND_FLOAT64, fv, ones))
            val = fv
        t0 = time.perf_counter()
        table.insert_record(ColumnBatch(cols, n))
        if insert_s is not None:
            insert_s.append(time.perf_counter() - t0)
        data.append((codes, ts, val))
    if sync:
        table.sync()
    return table, data


def shapes(E, lit):
    """The five hot query shapes: (name, filter, aggregations, kernels)."""
    ts, v = E.Col("timestamp"), E.Col("value")
    return [
        ("band_ts_ge", ts.gt_eq(lit), [E.Sum(v), E.Count(v)],
         {"fused_band_group_sum_count"}),
        ("band3_dict_eq",
         E.And(E.And(ts.gt_eq(lit), ts.lt(lit + 600)), E.Col("example_type").eq("cpu")),
         [E.Sum(v)], {"fused_band_group_sum_count"}),
        ("int_eq", v.eq(lit), [E.Sum(v), E.Count(v)],
         {"fused_cmp_group_sum_count"}),
        ("or", E.Or(ts.lt(lit), ts.gt_eq(lit + 800)), [E.Sum(v), E.Count(v)],
         {"group_sum_count"}),
        ("min_max", ts.gt_eq(lit), [E.Min(v), E.Max(v)],
         {"group_sum_count", "group_min_max"}),
    ]


def host_reference(name, data, lit):
    """{label: (agg values...)} from the generated arrays with numpy."""
    codes = np.concatenate([d[0] for d in data])
    ts = np.concatenate([d[1] for d in data])
    val = np.concatenate([d[2] for d in data])
    if name == "band_ts_ge":
        m = ts >= lit
    elif name == "band3_dict_eq":
        m = (ts >= lit) & (ts < lit + 600)
    elif name == "int_eq":
        m = val == lit
    elif name == "or":
        m = (ts < lit) | (ts >= lit + 800)
    else:
        m = ts >= lit
    c, x = codes[m], val[m]
    cnt = np.bincount(c, minlength=NUM_CODES)
    if name == "min_max":
        mn = np.full(NUM_CODES, np.iinfo(np.int64).max)
        mx = np.full(NUM_CODES, np.iinfo(np.int64).min)
        np.minimum.at(mn, c, x)
        np.maximum.at(mx, c, x)
        cols = (mn, mx)
    else:
        s = np.bincount(c, weights=x, minlength=NUM_CODES).astype(np.int64)
        cols = (s, cnt) if name != "band3_dict_eq" else (s,)
    return {
        f"g{k}": tuple(int(col[k]) for col in cols)
        for k in range(NUM_CODES)
        if cnt[k] > 0
    }


def run_query(engine, table, filt, aggs, E):
    out = []
    engine.scan_table(table).filter(filt).aggregate(
        aggs, [E.Col("labels.label1")]
    ).execute(out.append)
    return out


def as_rows(batches):
    return [
        tuple((c.name, c.py_value(i)) for c in b.columns)
        for b in batches
        for i in range(b.num_rows)
    ]


def engine_phase(AK, args, device="cuda"):
    import torch

    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions

    store = ColumnStore(device=device)
    db = store.db("smoke")
    t0 = time.perf_counter()
    table, data = build_table(db, "t", args.parts)
    build_s = time.perf_counter() - t0
    total = args.parts * ROWS_PER_PART
    log(f"engine table: {args.parts} inserts x {ROWS_PER_PART} rows = {total} rows, built in {build_s:.1f} s")
    parts = table.collect_parts(db.high_watermark())
    label_changes = sum(
        int(np.count_nonzero(np.diff(p.batch.column("labels.label1").values)))
        for p in parts
    )
    log(
        f"engine table layout: {len(parts)} visible parts, "
        f"{sum(p.batch.num_rows for p in parts)} rows, "
        f"{sum(p.device().n_pad for p in parts)} rows padded on the device, "
        f"{label_changes} label changes between neighbouring rows"
    )
    if args.parts < 32:
        log(f"engine table cut from 32 x {ROWS_PER_PART} rows to {args.parts} x {ROWS_PER_PART}")
    small, small_data = build_table(db, "t2", 2)
    del small
    engine = LocalEngine(db.table_provider())
    generic = LocalEngine(db.table_provider(), ExecOptions(compiled_serving=False))

    # Warm: the first query of each shape uploads parts and builds planes.
    for name, filt, aggs, _k in shapes(E, 50):
        run_query(engine, "t", filt, aggs, E)
    torch.cuda.synchronize()

    # The main path: every count to 0, the five shapes once, counts read.
    # The kernels' inputs are kept for main_path_kernels.
    AK.reset_launches()
    results = []
    captured: dict = {}
    with capture_kernel_args(AK) as seen:
        for name, filt, aggs, kernels in shapes(E, 40):
            before = dict(AK.LAUNCHES)
            n_seen = len(seen)
            out = run_query(engine, "t", filt, aggs, E)
            moved = {k for k in AK.LAUNCHES if AK.LAUNCHES[k] > before[k]}
            if engine.last_serving_path != "compiled":
                raise AssertionError(f"{name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
            if moved != kernels:
                raise AssertionError(f"{name}: launched {moved}, expected {kernels}")
            keep_captures(captured, name, seen[n_seen:])
            results.append((name, out))
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (aggregate shapes): {json.dumps(launches)}")
    for k in SLICE1_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    for name, out in results:
        got = {
            row[0][1]: tuple(v for _n, v in row[1:]) for row in as_rows(out)
        }
        ref = host_reference(name, data, 40)
        if got != ref:
            raise AssertionError(f"{name}: result differs from the host reference")
        if len(got) != NUM_CODES and name != "int_eq":
            raise AssertionError(f"{name}: {len(got)} groups")
    log("engine results equal the numpy reference on all 5 shapes")

    for name, filt, aggs, _k in shapes(E, 40):
        fast = as_rows(run_query(engine, "t2", filt, aggs, E))
        path = engine.last_serving_path
        slow = as_rows(run_query(generic, "t2", filt, aggs, E))
        if path != "compiled" or generic.last_serving_path != "generic":
            raise AssertionError(f"{name}: paths {path}/{generic.last_serving_path}")
        if fast != slow or host_reference(name, small_data, 40) != {
            r[0][1]: tuple(v for _n, v in r[1:]) for r in fast
        }:
            raise AssertionError(f"{name}: compiled and generic DAG differ on t2")
    log("2-part table: compiled tier == generic DAG, rows and order, on all 5 shapes")
    float_sums(db, engine, generic, E)

    walls: dict = {}
    for i in range(QUERY_REPS):
        for name, filt, aggs, _k in shapes(E, 100 + 37 * i):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_query(engine, "t", filt, aggs, E)
            walls.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
    for name, w in walls.items():
        log(
            f"engine {name}: median {statistics.median(w):.3f} ms, "
            f"min {min(w):.3f} ms over {len(w)} queries of {total} rows"
        )
    device_breakdown(
        [(name, lambda f=filt, a=aggs: run_query(engine, "t", f, a, E))
         for name, filt, aggs, _k in shapes(E, 90)],
        walls,
    )
    return launches, captured, (db, engine, generic, data)


def _groups(labels, x):
    """{label: its values in stream order}."""
    keys, inv = np.unique(labels, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(keys) + 1))
    return {
        str(k): x[order[bounds[i]:bounds[i + 1]]] for i, k in enumerate(keys)
    }


def float_sums(db, engine, generic, E, lit: int = 40) -> None:
    """sum(floatvalue) where timestamp >= lit, by label, on two 2-part
    tables. Within the exact-sum gate (floatsum.py) the compiled tier and
    the generic DAG must each give every group's correctly rounded sum
    (math.fsum). Outside it the compiled tier declines, and the generic DAG
    must give the sum in its fixed order, computed on the host from the
    parts in scan order, bit for bit, on two runs."""
    from frostdb_tpu_torch.tools.fuzz import pairwise_sum

    filt, aggs = E.Col("timestamp").gt_eq(lit), [E.Sum(E.Col("floatvalue"))]

    def exact(rng, n):
        return rng.random(n) * 1000.0 + 1.0

    def wide(rng, n):
        sign = rng.choice(np.array([-1.0, 1.0]), n)
        return sign * rng.random(n) * 10.0 ** rng.integers(-30, 31, n)

    _t, data = build_table(db, "fx", 2, exact, seed=SEED + 1)
    codes = np.concatenate([d[0] for d in data])
    m = np.concatenate([d[1] for d in data]) >= lit
    x = np.concatenate([d[2] for d in data])
    ref = {
        k: (math.fsum(v.tolist()),)
        for k, v in _groups(np.char.add("g", codes[m].astype(str)), x[m]).items()
    }
    for eng, path in ((engine, "compiled"), (generic, "generic")):
        rows = as_rows(run_query(eng, "fx", filt, aggs, E))
        if eng.last_serving_path != path:
            raise AssertionError(f"exact float sum: served by {eng.last_serving_path}")
        if {r[0][1]: tuple(v for _n, v in r[1:]) for r in rows} != ref:
            raise AssertionError(f"exact float sum on the {path} path differs from math.fsum")

    table, _data = build_table(db, "fw", 2, wide, seed=SEED + 2)
    parts = table.collect_parts(db.high_watermark())

    def stream(name):
        return np.concatenate([p.batch.column(name).values for p in parts])

    labels = np.concatenate([
        np.asarray(p.batch.column("labels.label1").dictionary.values, dtype=object)[
            p.batch.column("labels.label1").values
        ]
        for p in parts
    ]).astype(str)
    m = stream("timestamp") >= lit
    ref = {k: (pairwise_sum(v),) for k, v in _groups(labels[m], stream("floatvalue")[m]).items()}
    runs = []
    for _ in range(2):
        rows = as_rows(run_query(engine, "fw", filt, aggs, E))
        if engine.last_serving_path != "generic":
            raise AssertionError(f"wide float sum: served by {engine.last_serving_path}")
        runs.append({r[0][1]: tuple(v for _n, v in r[1:]) for r in rows})
    if runs[0] != ref or runs[1] != ref:
        raise AssertionError("wide float sum on the generic DAG differs from its fixed-order host sum")
    log(
        f"float sums on 2 x {ROWS_PER_PART} rows: exact (compiled, generic) == math.fsum; "
        f"outside the exact gate, the generic DAG's fixed-order sum, two runs == host"
    )


def device_breakdown(runs, walls, top: int = 4) -> None:
    """Per query shape, one query under torch.profiler: the device's busy
    time (kernels and copies), its share of the median wall time, the
    device-to-host copies and the ``top`` largest device operations.
    ``runs`` is a list of (name, fn running one query)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, fn in runs:
        # A trace now and then holds no device events: one more try.
        for _attempt in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ops = [
                e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ]
            if ops:
                break
        if not ops:
            log(f"engine {name}: device time not measured (the profiler saw no device events)")
            continue
        busy = sum(e.self_device_time_total for e in ops) / 1e3
        d2h = sum(e.self_device_time_total for e in ops if "DtoH" in e.key) / 1e3
        wall = statistics.median(walls[name])
        largest = sorted(ops, key=lambda e: -e.self_device_time_total)[:top]
        log(
            f"engine {name}: device busy {busy:.3f} ms of a {wall:.3f} ms median "
            f"query (idle share {1 - busy / wall:.3f}); device-to-host copies "
            f"{d2h:.3f} ms; largest: "
            + "; ".join(
                f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                for e in largest
            )
        )


# ---------------------------------------------------------------------------
# Scan and distinct phase (slice 2)


def scan_shapes(E, i):
    """The slice's query shapes for query number ``i`` (literals vary with
    it): (name, fn(engine) -> query, serving tier, kernels)."""
    ts, v = E.Col("timestamp"), E.Col("value")
    label = f"g{(7 + i) % NUM_CODES}"
    low = 5 + i % 3
    return [
        # bench_macro.py's filter_project (~0.5% selected there, 0.4% here)
        ("scan_value_gt",
         lambda e: e.scan_table("t").filter(v.gt(995 - i % 3)).project(
             E.Col("example_type"), v),
         "compiled_scan", {"block_compact"}),
        ("scan_label_band_limit",
         lambda e: e.scan_table("t").filter(
             E.And(E.Col("labels.label1").eq(label), ts.gt_eq(500))).project(
             E.Col("labels.label1"), ts, v).limit(E.Literal(1000)),
         "compiled_scan", {"block_compact"}),
        ("scan_or",
         lambda e: e.scan_table("t").filter(
             E.Or(ts.lt(low), ts.gt_eq(990 + low))).project(v),
         "compiled_scan", {"block_compact"}),
        # The same OR on a column the parts are not sorted by, so no block
        # holds a long run of selected rows.
        ("scan_or_value",
         lambda e: e.scan_table("t").filter(
             E.Or(v.lt(low), v.gt_eq(990 + low))).project(ts),
         "compiled_scan", {"block_compact"}),
        # bench_macro.py's Values, Types and Labels
        ("distinct_values",
         lambda e: e.scan_table("t").distinct(E.Col("labels.label1")),
         "compiled_distinct", {"group_sum_count"}),
        ("distinct_types",
         lambda e: e.scan_table("t").distinct(
             E.Col("example_type"), v.gt(500 + i)),
         "compiled_distinct", {"group_sum_count"}),
        ("schema_labels",
         lambda e: e.scan_schema("t").distinct(E.Col("name")).filter(
             E.Col("name").regex_match(r"^labels\..+$")),
         "schema_meta", set()),
    ]


def run_shape(engine, make_q):
    out = []
    make_q(engine).execute(out.append)
    return out


def batch_columns(batches):
    """Per batch, per column: (name, kind, values, validity), dictionary
    codes decoded to their strings."""
    out = []
    for b in batches:
        cols = []
        for c in b.columns:
            vals = np.asarray(c.values)
            if c.dictionary is not None:
                vals = np.asarray(c.dictionary.values, dtype=object)[vals]
            cols.append((c.name, c.kind, vals, np.asarray(c.validity)))
        out.append(cols)
    return out


def same_batches(a, b) -> bool:
    """The same batches (boundaries), columns, kinds, validity and valid
    values."""
    a, b = batch_columns(a), batch_columns(b)
    if len(a) != len(b):
        return False
    for ca, cb in zip(a, b):
        if [x[:2] for x in ca] != [x[:2] for x in cb]:
            return False
        for (_n, _k, va, ma), (_n2, _k2, vb, mb) in zip(ca, cb):
            if len(va) != len(vb) or not np.array_equal(ma, mb):
                return False
            if not np.array_equal(va[ma], vb[mb]):
                return False
    return True


def column_of(batches, name):
    cols = [c for b in batches for c in batch_columns([b])[0] if c[0] == name]
    return np.concatenate([c[2] for c in cols]) if cols else np.zeros(0)


def scan_reference_ok(name, i, out, flat) -> bool:
    """The shape's rows against numpy over the generated arrays ``flat`` =
    (codes, timestamps, values): as a multiset for the scans (the limited
    scan's rows a sub-multiset of the matching rows, as many as the limit
    allows), exactly for the distincts."""
    codes, ts, val = flat
    if name == "scan_value_gt":
        ref = np.sort(val[val > 995 - i % 3])
        return (np.array_equal(np.sort(column_of(out, "value").astype(np.int64)), ref)
                and set(column_of(out, "example_type")) <= {"cpu"})
    if name == "scan_or":
        low = 5 + i % 3
        ref = np.sort(val[(ts < low) | (ts >= 990 + low)])
        return np.array_equal(np.sort(column_of(out, "value").astype(np.int64)), ref)
    if name == "scan_or_value":
        low = 5 + i % 3
        ref = np.sort(ts[(val < low) | (val >= 990 + low)])
        return np.array_equal(np.sort(column_of(out, "timestamp").astype(np.int64)), ref)
    if name == "scan_label_band_limit":
        k = (7 + i) % NUM_CODES
        m = (codes == k) & (ts >= 500)
        ref_keys, ref_n = np.unique(ts[m] * 1000 + val[m], return_counts=True)
        got = column_of(out, "timestamp").astype(np.int64) * 1000 + column_of(out, "value").astype(np.int64)
        keys, n = np.unique(got, return_counts=True)
        pos = np.searchsorted(ref_keys, keys)
        pos = np.minimum(pos, len(ref_keys) - 1)
        return (len(got) == min(1000, int(m.sum()))
                and np.array_equal(ref_keys[pos], keys)
                and bool((n <= ref_n[pos]).all())
                and set(column_of(out, "labels.label1")) == {f"g{k}"})
    if name == "distinct_values":
        got = list(column_of(out, "labels.label1"))
        present = np.flatnonzero(np.bincount(codes, minlength=NUM_CODES))
        return len(got) == len(set(got)) and sorted(got) == sorted(f"g{k}" for k in present)
    if name == "distinct_types":
        rows = list(zip(column_of(out, "example_type"), column_of(out, out[0].columns[1].name)))
        above = int((val > 500 + i).sum())
        ref = {("cpu", x) for x, n in ((True, above), (False, len(val) - above)) if n}
        return len(rows) == len(ref) and {(a, bool(b)) for a, b in rows} == ref
    return list(column_of(out, "name")) == ["labels.label1"]


def scan_distinct_phase(AK, db, engine, generic, data, total):
    """Slice 2's path on the engine table: each shape once with the launch
    counts set to 0 before and read after (the inputs of each kernel's
    first launch are kept), served by its tier, equal to the generic DAG
    batch for batch and to numpy; then timed over QUERY_REPS queries with
    varying literals and profiled once each."""
    import torch

    from frostdb_tpu_torch.query import expr as E

    flat = tuple(np.concatenate([d[j] for d in data]) for j in range(3))
    # Warm: uploads and planes, and every literal of the timed loop once,
    # so each structure's cached compaction capacity has settled and the
    # timed queries take one dispatch each.
    for i in range(QUERY_REPS):
        for _name, make_q, _tier, _k in scan_shapes(E, i):
            run_shape(engine, make_q)
    torch.cuda.synchronize()

    AK.reset_launches()
    results = []
    captured: dict = {}
    with capture_kernel_args(AK) as seen:
        for name, make_q, tier, kernels in scan_shapes(E, 0):
            before = dict(AK.LAUNCHES)
            n_seen = len(seen)
            out = run_shape(engine, make_q)
            moved = {k for k in AK.LAUNCHES if AK.LAUNCHES[k] > before[k]}
            if engine.last_serving_path != tier:
                raise AssertionError(f"{name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
            if moved != kernels:
                raise AssertionError(f"{name}: launched {moved}, expected {kernels}")
            keep_captures(captured, name, seen[n_seen:])
            results.append((name, make_q, out))
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (scan and distinct shapes): {json.dumps(launches)}")
    if launches["block_compact"] == 0:
        raise AssertionError("block_compact was not launched on the scan path")

    for name, make_q, out in results:
        t0 = time.perf_counter()
        slow = run_shape(generic, make_q)
        slow_s = time.perf_counter() - t0
        if generic.last_serving_path != "generic":
            raise AssertionError(f"{name}: generic engine served by {generic.last_serving_path}")
        if not same_batches(out, slow):
            raise AssertionError(f"{name}: fast tier and generic DAG differ")
        if not scan_reference_ok(name, 0, out, flat):
            raise AssertionError(f"{name}: result differs from the numpy reference")
        log(
            f"{name}: {sum(b.num_rows for b in out)} rows in {len(out)} batches, "
            f"== generic DAG (batches, rows, order; generic took {slow_s:.2f} s) and numpy"
        )
    # A scan whose partial blocks overflow the largest capacity takes the
    # host re-filter for them by design: it is checked above and not timed
    # (tests/test_torch_scan.py covers that path).
    overflow = scan_layout(engine, E, total)
    timed = {name for name, *_r in scan_shapes(E, 0) if not overflow.get(name)}
    for name in sorted(set(overflow) - timed):
        log(f"engine {name}: not timed, {overflow[name]} blocks fall to the host re-filter")

    walls: dict = {}
    dispatches: dict = {}
    for i in range(QUERY_REPS):
        for name, make_q, tier, _k in scan_shapes(E, i):
            if name not in timed:
                continue
            before = AK.LAUNCHES["block_compact"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = run_shape(engine, make_q)
            walls.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
            dispatches.setdefault(name, []).append(AK.LAUNCHES["block_compact"] - before)
            if engine.last_serving_path != tier:
                raise AssertionError(f"{name} #{i}: served by {engine.last_serving_path}")
            if name.startswith("scan") and not scan_reference_ok(name, i, out, flat):
                raise AssertionError(f"{name} #{i}: result differs from the numpy reference")
    for name, w in walls.items():
        log(
            f"engine {name}: median {statistics.median(w):.3f} ms, min {min(w):.3f} ms "
            f"over {len(w)} queries of {total} rows; block_compact dispatches per "
            f"query {dispatches[name]}"
        )
        if name.startswith("scan") and set(dispatches[name]) != {1}:
            raise AssertionError(f"{name}: a timed query took {dispatches[name]} dispatches")
    device_breakdown(
        [(name, lambda m=make_q: run_shape(engine, m))
         for name, make_q, _t, _k in scan_shapes(E, 0) if name in timed],
        walls,
    )
    scan_host_breakdown(engine, E, timed)
    return launches, captured


def traced_scans(engine, make_q, n: int) -> list:
    """``n`` runs of a query under a tracer: per run, its spans by name
    (the root under ``query``)."""
    from frostdb_tpu_torch.tracing import Tracer

    saved, engine.exec_options.tracer = engine.exec_options.tracer, Tracer()
    try:
        for _ in range(n):
            run_shape(engine, make_q)
        roots = engine.exec_options.tracer.roots
    finally:
        engine.exec_options.tracer = saved
    runs = []
    for root in roots:
        by_name, todo = {"query": [root]}, list(root.children)
        while todo:
            span = todo.pop()
            by_name.setdefault(span.name, []).append(span)
            todo.extend(span.children)
        runs.append(by_name)
    return runs


def scan_host_breakdown(engine, E, timed) -> None:
    """Per timed scan shape, where a query's wall time goes (its spans,
    median of QUERY_REPS queries): the result's copy (which waits for the
    device program), the rest of ``scan/blocks`` (the program's launches
    and the host's per-block loop that turns the blob into row positions),
    ``result/epilogue`` (the per-part ``take`` and projection), and the
    rest (planning, part collection, tier dispatch)."""
    for shape, make_q, _tier, _k in scan_shapes(E, 0):
        if not shape.startswith("scan") or shape not in timed:
            continue
        runs = traced_scans(engine, make_q, QUERY_REPS)
        med = {k: statistics.median(sum(s.duration for s in r.get(k, ())) * 1e3 for r in runs)
               for k in ("query", "result/copy", "scan/blocks", "result/epilogue")}
        log(
            f"engine {shape} host breakdown (median ms): query {med['query']:.3f} = "
            f"device program and copy {med['result/copy']:.3f} + launches and per-block "
            f"loop {med['scan/blocks'] - med['result/copy']:.3f} + take and "
            f"project {med['result/epilogue']:.3f} + rest "
            f"{med['query'] - med['scan/blocks'] - med['result/epilogue']:.3f}"
        )


def scan_layout(engine, E, total) -> dict:
    """Per scan shape, what its compaction saw (``scan/blocks``' attributes
    and the rows ``result/epilogue`` emitted): blocks with a selected row,
    blocks past the capacity, the capacity it settled on and the dispatches
    it took. Returns {shape: blocks re-filtered on the host}."""
    import frostdb_tpu_torch.compiled_scan as CS
    from frostdb_tpu_torch.ops import agg_kernels as AK

    overflow = {}
    for name, make_q, _tier, _k in scan_shapes(E, 0):
        if not name.startswith("scan"):
            continue
        (spans,) = traced_scans(engine, make_q, 1)
        a = spans["scan/blocks"][0].attributes
        rows = spans["result/epilogue"][0].attributes["rows"]
        log(
            f"{name}: blocks of {AK.BLOCK_ROWS} rows over {total} live rows, "
            f"{a['blocks']} with a selected row, {a['refiltered']} past "
            f"the capacity and re-filtered on the host (capb {a['capb']}; a block past "
            f"{CS._CAPB_MAX} stops the escalation); {a['dispatches']} dispatches; "
            f"{rows} rows emitted"
        )
        overflow[name] = a["refiltered"]
    return overflow


# ---------------------------------------------------------------------------
# Join phase (slice 3)


def join_tables(db):
    """The join phase's build sides in ``db``, each with its own dictionary:

    - ``dims``: bench_macro.py's join_agg dims (bench_macro.py:216-253) on
      the engine table: every second of the 64 labels, ``weight = arange``;
    - ``dims_dup``: tests/test_join_fused.py build_db's shape: every third
      label and one the probe lacks, 1-3 rows each, three null keys,
      nullable ``weight`` in [-100, 100);
    - ``idims``: an int64 ``timestamp`` key over every third value of
      [0, 1000), 1-2 rows each, plus two keys outside the probe's span and
      a null key, int64 ``w``.

    Returns {name: (keys, values, values' validity)} in scan order, keys as
    probe label codes (-1: null or absent from the probe) or int64 (None:
    null)."""
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
    from frostdb_tpu_torch.schema import (
        ColumnDef, ENCODING_RLE_DICTIONARY, SchemaDef, StorageLayout, TYPE_INT64, TYPE_STRING,
    )
    from frostdb_tpu_torch.table import TableConfig

    rng = np.random.default_rng(SEED + 3)
    dict_str = StorageLayout(TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY)
    i64 = StorageLayout(TYPE_INT64, nullable=True)
    out = {}
    for name, key, vcol in (("dims", "labels.label1", "weight"),
                            ("dims_dup", "labels.label1", "weight"),
                            ("idims", "timestamp", "w")):
        kdef = ColumnDef(key, dict_str if key.startswith("labels") else i64)
        t = db.table(name, TableConfig(schema=SchemaDef(name, (kdef, ColumnDef(vcol, i64)), ())))
        if name == "dims":
            keys = list(range(0, NUM_CODES, 2))
            w = np.arange(len(keys), dtype=np.int64)
            wv = np.ones(len(keys), bool)
        elif name == "dims_dup":
            keys = [k for k in range(0, NUM_CODES, 3) for _ in range(rng.integers(1, 4))]
            keys += [NUM_CODES, None, None, None]  # "gx" is not in the probe
            keys = [keys[j] for j in rng.permutation(len(keys))]
            wv = rng.random(len(keys)) > 0.15
            w = np.where(wv, rng.integers(-100, 100, len(keys)), 0).astype(np.int64)
        else:
            keys = [k for k in range(0, 1000, 3) for _ in range(rng.integers(1, 3))]
            keys += [-7, 5000, None]  # outside the probe's [0, 1000) span
            w = rng.integers(-50, 1000, len(keys)).astype(np.int64)
            wv = np.ones(len(keys), bool)
        n = len(keys)
        kvalid = np.array([k is not None for k in keys])
        if key.startswith("labels"):
            d = t.dictionary("labels")
            kc, _v = d.encode([f"g{k}" if k != NUM_CODES else "gx" for k in keys if k is not None])
            codes = np.zeros(n, np.int32)
            codes[kvalid] = kc
            kcol = Column(key, KIND_DICT, codes, kvalid, d)
            probe_keys = np.array([-1 if k is None or k >= NUM_CODES else k for k in keys])
        else:
            kv = np.array([0 if k is None else k for k in keys], dtype=np.int64)
            kcol = Column(key, KIND_INT64, kv, kvalid)
            probe_keys = keys
        t.insert_record(ColumnBatch([kcol, Column(vcol, KIND_INT64, w, wv)], n))
        t.sync()
        out[name] = (probe_keys, w, wv)
    return out


def join_literals(i):
    """The join shapes' literals for query number ``i``: timestamp >= ts,
    value < value_lt, value > value_gt, and the build-side weight >= weight
    of the semi/anti shapes."""
    return {"ts": 100 + 37 * i, "value_lt": 300 + 41 * i,
            "value_gt": 995 - i % 3, "weight": i % 5}


def join_shapes(E, i, table="t"):
    """The join phase's query shapes for query number ``i`` (literals vary
    with it): (name, fn(engine) -> query, serving tier, kernels)."""
    ts, v, label = E.Col("timestamp"), E.Col("value"), E.Col("labels.label1")
    lits = join_literals(i)
    lit = lits["ts"]

    def join(e, right, how, filt=None, on="labels.label1"):
        q = e.scan_table(table)
        if filt is not None:
            q = q.filter(filt)
        return q.join(right, on=[on], how=how)

    def dims_upto(e):
        # build-side literal: the match set changes from query to query
        return e.scan_table("dims").filter(E.Col("weight").gt_eq(lits["weight"]))

    k2, k2k3 = {"group_sum_count"}, {"group_sum_count", "group_min_max"}
    return [
        ("join_agg",
         lambda e: join(e, e.scan_table("dims"), "inner", ts.gt_eq(lit)).aggregate(
             [E.Sum(E.Col("weight"))], [label]),
         "compiled_join", k2),
        ("join_all_aggs",
         lambda e: join(e, e.scan_table("dims_dup"), "inner", ts.gt_eq(lit)).aggregate(
             [E.Count(v), E.Sum(v), E.Sum(E.Col("weight")), E.Min(E.Col("weight")),
              E.Max(E.Col("weight"))], [label]),
         "compiled_join", k2k3),
        ("join_semi",
         lambda e: join(e, dims_upto(e), "semi").aggregate([E.Count(v)], [label]),
         "compiled_join", k2),
        ("join_anti",
         lambda e: join(e, dims_upto(e), "anti").aggregate([E.Count(v)], [label]),
         "compiled_join", k2),
        ("join_left_outer",
         lambda e: join(e, e.scan_table("dims"), "left_outer", ts.gt_eq(lit)).aggregate(
             [E.Count(v), E.Sum(E.Col("weight")), E.Sum(v)], [label]),
         "compiled_join", k2),
        ("join_int_key",
         lambda e: join(e, e.scan_table("idims"), "inner", v.lt(lits["value_lt"]),
                        on="timestamp").aggregate(
             [E.Count(v), E.Sum(E.Col("w")), E.Sum(v)], [label]),
         "compiled_join", k2),
        ("join_rows",
         lambda e: join(e, e.scan_table("dims_dup"), "inner", v.gt(lits["value_gt"])).project(
             label, v, E.Col("weight")),
         "generic", set()),
    ]


def _side_luts(side, size, lit=None):
    """(count, sum, min, max) per key over a build side's rows with a valid
    key in [0, size) (and, with ``lit``, value >= lit); null values count
    as 0, as the joined batch's zeroed null slots do."""
    keys, w, wv = side
    k = np.array([-1 if x is None else x for x in keys], dtype=np.int64)
    w0 = np.where(wv, w, 0)
    ok = (k >= 0) & (k < size)
    if lit is not None:
        ok &= w0 >= lit
    cnt = np.bincount(k[ok], minlength=size)
    s = np.bincount(k[ok], weights=w0[ok], minlength=size).astype(np.int64)
    mn = np.full(size, np.iinfo(np.int64).max)
    mx = np.full(size, np.iinfo(np.int64).min)
    np.minimum.at(mn, k[ok], w0[ok])
    np.maximum.at(mx, k[ok], w0[ok])
    return cnt, s, mn, mx


def join_reference(name, i, flat, sides):
    """{label: (agg values...)} of a fused join shape from the generated
    arrays with numpy: the per-label partials of the probe selection
    combined with the build side's multiplicities and partials."""
    codes, ts, val = flat
    k_all = np.arange(NUM_CODES)
    lits = join_literals(i)

    def bc(m, weights=None):
        return np.bincount(codes[m], weights=weights, minlength=NUM_CODES).astype(np.int64)

    out = {}
    if name == "join_int_key":
        cnt, s, _mn, _mx = _side_luts(sides["idims"], 1000)
        m = val < lits["value_lt"]
        c_r = cnt[ts[m]]
        n = bc(m, c_r)
        cols = (n, bc(m, s[ts[m]]), bc(m, val[m] * c_r))
        keep = n > 0
    elif name in ("join_semi", "join_anti"):
        cnt, *_r = _side_luts(sides["dims"], NUM_CODES, lit=lits["weight"])
        n = bc(np.ones(len(codes), bool))
        cols = (n,)
        keep = (n > 0) & ((cnt > 0) if name == "join_semi" else (cnt == 0))
    else:
        side = sides["dims_dup" if name == "join_all_aggs" else "dims"]
        cnt, s, mn, mx = _side_luts(side, NUM_CODES)
        m = ts >= lits["ts"]
        n, sv = bc(m), bc(m, val[m])
        if name == "join_agg":
            cols, keep = (n * s,), (n > 0) & (cnt > 0)
        elif name == "join_all_aggs":
            cols, keep = (n * cnt, sv * cnt, n * s, mn, mx), (n > 0) & (cnt > 0)
        else:  # left_outer: unmatched rows emit once, with null weights
            mult = np.maximum(cnt, 1)
            cols, keep = (n * mult, n * s, sv * mult), n > 0
    for k in k_all[keep]:
        out[f"g{k}"] = tuple(int(col[k]) for col in cols)
    return out


def join_rows_check(out, i, table, side):
    """join_rows' batches against a numpy join, row for row and in order:
    probe rows in scan order with ``value > value_gt``, each followed by its
    build rows in build order."""
    parts = table.collect_parts(table.db.high_watermark())
    lab = parts[0].batch.column("labels.label1").dictionary
    if list(lab.values[:NUM_CODES]) != [f"g{k}" for k in range(NUM_CODES)]:
        raise AssertionError("join_rows: probe label codes are not g0..g63")
    pc = np.concatenate([p.batch.column("labels.label1").values for p in parts]).astype(np.int64)
    pv = np.concatenate([p.batch.column("value").values for p in parts])
    sel = np.flatnonzero(pv > join_literals(i)["value_gt"])
    keys, w, wv = side
    bk = np.array([-1 if k is None else k for k in keys], dtype=np.int64)
    order = np.argsort(np.where(bk >= 0, bk, NUM_CODES), kind="stable")
    cnt = np.bincount(bk[bk >= 0], minlength=NUM_CODES)
    starts = np.cumsum(cnt) - cnt
    n_out = cnt[pc[sel]]
    li = np.repeat(sel, n_out)
    rank = np.arange(len(li)) - np.repeat(np.cumsum(n_out) - n_out, n_out)
    brow = order[starts[pc[li]] + rank]
    ref = {
        "labels.label1": (np.char.add("g", pc[li].astype(str)).astype(object), np.ones(len(li), bool)),
        "value": (pv[li], np.ones(len(li), bool)),
        "weight": (w[brow], wv[brow]),
    }
    got = {}
    for b in batch_columns(out):
        for name, _kind, vals, valid in b:
            got.setdefault(name, []).append((vals, valid))
    if list(got) != list(ref):
        raise AssertionError(f"join_rows: columns {list(got)}")
    for name, (rv, rm) in ref.items():
        gv = np.concatenate([x[0] for x in got[name]])
        gm = np.concatenate([x[1] for x in got[name]])
        if not (np.array_equal(gm, rm) and np.array_equal(gv[gm], rv[rm])):
            raise AssertionError(f"join_rows: column {name} differs from the numpy join")
    return len(li)


def join_phase(AK, db, engine, generic, data, total):
    """Slice 3's path on the engine table: the six fused join shapes on the
    compiled_join tier and join_rows on the generic HashJoin, each once with
    the launch counts set to 0 before and read after (the inputs of each
    kernel's first launch per shape are kept); every result against numpy
    at full width, the fused shapes also against the generic DAG on the
    2-part table; then timed over QUERY_REPS queries with varying literals
    and profiled once each."""
    import torch

    from frostdb_tpu_torch.query import expr as E

    t0 = time.perf_counter()
    sides = join_tables(db)
    flat = tuple(np.concatenate([d[j] for d in data]) for j in range(3))
    table = db.get_table("t")
    log(
        "join build sides: " + ", ".join(f"{n} {len(s[0])} rows" for n, s in sides.items())
        + f", made in {time.perf_counter() - t0:.1f} s"
    )
    for _name, make_q, _tier, _k in join_shapes(E, 0):
        run_shape(engine, make_q)
    torch.cuda.synchronize()

    AK.reset_launches()
    results = []
    captured: dict = {}
    with capture_kernel_args(AK) as seen:
        for name, make_q, tier, kernels in join_shapes(E, 0):
            before = dict(AK.LAUNCHES)
            n_seen = len(seen)
            out = run_shape(engine, make_q)
            moved = {k for k in AK.LAUNCHES if AK.LAUNCHES[k] > before[k]}
            if engine.last_serving_path != tier:
                raise AssertionError(f"{name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
            if moved != kernels:
                raise AssertionError(f"{name}: launched {moved}, expected {kernels}")
            keep_captures(captured, name, seen[n_seen:])
            results.append((name, make_q, out))
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (join shapes): {json.dumps(launches)}")

    on_t2 = {name: make_q for name, make_q, _t, _k in join_shapes(E, 0, "t2")}
    for name, make_q, out in results:
        if name == "join_rows":
            n = join_rows_check(out, 0, table, sides["dims_dup"])
            log(f"join_rows: {n} rows in {len(out)} batches == the numpy join, row for row")
            continue
        got = {row[0][1]: tuple(v for _n, v in row[1:]) for row in as_rows(out)}
        if got != join_reference(name, 0, flat, sides):
            raise AssertionError(f"{name}: result differs from the numpy reference")
        t1 = time.perf_counter()
        fast = as_rows(run_shape(engine, on_t2[name]))
        path = engine.last_serving_path
        slow = as_rows(run_shape(generic, on_t2[name]))
        if path != "compiled_join" or generic.last_serving_path != "generic":
            raise AssertionError(f"{name} on t2: paths {path}/{generic.last_serving_path}")
        if fast != slow:
            raise AssertionError(f"{name}: compiled_join and the generic DAG differ on t2")
        log(
            f"{name}: {len(got)} groups == numpy at full width; on t2 compiled_join "
            f"== generic DAG, rows and order ({len(fast)} groups, "
            f"{time.perf_counter() - t1:.2f} s for both)"
        )

    walls: dict = {}
    for i in range(QUERY_REPS):
        for name, make_q, tier, _k in join_shapes(E, i):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = run_shape(engine, make_q)
            walls.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
            if engine.last_serving_path != tier:
                raise AssertionError(f"{name} #{i}: served by {engine.last_serving_path}")
            if name in ("join_semi", "join_anti"):
                # cheap to recheck: the build-side literal moves the match set
                got = {r[0][1]: tuple(x for _n, x in r[1:]) for r in as_rows(out)}
                if got != join_reference(name, i, flat, sides):
                    raise AssertionError(f"{name} #{i}: result differs from the numpy reference")
    for name, w in walls.items():
        log(
            f"engine {name}: median {statistics.median(w):.3f} ms, "
            f"min {min(w):.3f} ms over {len(w)} queries of {total} rows"
        )
    device_breakdown(
        [(name, lambda m=make_q: run_shape(engine, m))
         for name, make_q, _t, _k in join_shapes(E, 0)],
        walls,
    )
    log(f"join phase: {time.perf_counter() - t0:.1f} s")
    return launches, captured


# ---------------------------------------------------------------------------
# Dense phase (slice 4): group-bys past the kernels' 2048 codes


def stack_probabilities():
    """Parca's stack frequencies, modelled as Zipf-like: the stack of rank r
    is drawn with p proportional to 1 / r^STACK_ZIPF."""
    p = 1.0 / np.arange(1, NUM_STACKS + 1, dtype=np.float64) ** STACK_ZIPF
    return p / p.sum()


def dense_literals(i):
    """The dense shapes' literals for query number ``i``: timestamp >= ts,
    and value >= value on the segment shape."""
    return {"ts": 100 + 37 * i, "value": 300 + 41 * i}


def dense_shapes(E, i, stacks="stacks", t="t"):
    """The dense phase's query shapes for query number ``i``: (name, table,
    fn(engine) -> query, route). Parca's merge (sum and count over a time
    range by stacktrace, K = 131,072), its min/max and a sum with a min, a
    (label, 20-unit window of timestamp) group-by on the engine table (K =
    64 x 64) and a (label, stacktrace) group-by (K = 64 x 131,072)."""
    ts, v = E.Col("timestamp"), E.Col("value")
    lits = dense_literals(i)
    stack, label = E.Col("stacktrace"), E.Col("labels.label1")
    return [
        ("dense_stack", stacks,
         lambda e: e.scan_table(stacks).filter(ts.gt_eq(lits["ts"])).aggregate(
             [E.Sum(v), E.Count(v)], [stack]),
         "table"),
        ("dense_stack_minmax", stacks,
         lambda e: e.scan_table(stacks).filter(ts.gt_eq(lits["ts"])).aggregate(
             [E.Min(v), E.Max(v)], [stack]),
         "sorted"),
        ("dense_stack_summin", stacks,
         lambda e: e.scan_table(stacks).filter(ts.gt_eq(lits["ts"])).aggregate(
             [E.Sum(v), E.Min(v)], [stack]),
         "sorted"),
        ("dense_segment", t,
         lambda e: e.scan_table(t).filter(v.gt_eq(lits["value"])).aggregate(
             [E.Sum(v), E.Count(v)], [label, E.Duration(DENSE_WINDOW)]),
         "segment"),
        ("dense_shuffle", stacks,
         lambda e: e.scan_table(stacks).filter(ts.gt_eq(lits["ts"])).aggregate(
             [E.Sum(v)], [label, stack]),
         "shuffle"),
    ]


def dense_route_probe(engine, make_q):
    """One run of a query under a tracer: (its output, and the route, K and
    parts read that its ``dense/parts`` and ``groups/remap`` spans under
    ``dense/execute`` record, or (None, None, None) where the dense tier
    did not serve)."""
    from frostdb_tpu_torch.tracing import Tracer

    saved, engine.exec_options.tracer = engine.exec_options.tracer, Tracer()
    try:
        out = run_shape(engine, make_q)
        (root,) = engine.exec_options.tracer.roots
    finally:
        engine.exec_options.tracer = saved
    for span in root.children:
        if span.name == "dense/execute":
            by_name = {c.name: c.attributes for c in span.children}
            if "dense/parts" in by_name:
                parts = by_name["dense/parts"]
                return out, parts["route"], by_name["groups/remap"]["codes"], parts["parts"]
    return out, None, None, None


def _reduction_module(name):
    """The module of a dense-tier reduction: the segment or table route's
    kernel (ops/agg_kernels.py) or one of ops/kernels.py's two."""
    from frostdb_tpu_torch.ops import agg_kernels as AK
    from frostdb_tpu_torch.ops import kernels as K

    return AK if name in ("dense_segment_sum_count", "dense_table_sum_count") else K


@contextlib.contextmanager
def capture_reductions():
    """Record the arguments of every call of the dense tier's reductions
    (ops/kernels.py's two, the segment and table routes' kernels) while
    the block runs: {function name: [args]}."""
    seen: dict = {"sorted_group_reduce": [], "dense_group_reduce": [],
                  "dense_segment_sum_count": [], "dense_table_sum_count": []}
    saved = {name: getattr(_reduction_module(name), name) for name in seen}

    def recorder(name, fn):
        def call(*args):
            seen[name].append(args)
            return fn(*args)

        return call

    for name, fn in saved.items():
        setattr(_reduction_module(name), name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(_reduction_module(name), name, fn)


def reduction_times(shape, captured) -> None:
    """Device time of the dense tier's reductions on one query's inputs:
    per function, all of the query's calls in a chain and alone, beside the
    least time the card needs to read their inputs and write their outputs
    once."""
    for fname, calls in captured.items():
        if not calls:
            continue
        fn = getattr(_reduction_module(fname), fname)

        def run_all(fn=fn, calls=calls):
            for a in calls:
                fn(*a)

        moved = 0
        for a in calls:
            out = fn(*a)
            for t in [*_tensors(a), *_tensors(out if isinstance(out, tuple) else (out,))]:
                moved += t.numel() * t.element_size()
        log(
            f"dense {shape}: {fname} x{len(calls)} (the query's calls over its parts), "
            f"{chained_ms(run_all, reps=5, warm=1):.3f} ms in a chain, "
            f"{cuda_ms(run_all, reps=5, warm=1):.3f} ms alone; bound "
            f"{moved / HBM_BYTES_PER_S * 1e3:.3f} ms ({moved} bytes read and written once)"
        )


def scan_stream(table):
    """(label codes, stack codes, timestamps, values) over the table's
    visible parts in scan order, the stream whose first selected rows order
    the groups."""
    parts = table.collect_parts(table.db.high_watermark())
    return tuple(
        np.concatenate([p.batch.column(c).values for p in parts])
        for c in ("labels.label1", "stacktrace", "timestamp", "value")
    )


def dense_reference(name, i, stream):
    """A dense shape's output columns with numpy: group key codes (window
    keys as values) and aggregates, groups in the order of their first
    selected row in the scan stream."""
    lab, stk, ts, val = stream
    lits = dense_literals(i)
    if name == "dense_segment":
        m = val >= lits["value"]
        key = lab[m].astype(np.int64) * 64 + ts[m] // DENSE_WINDOW
        space = NUM_CODES * 64
    elif name == "dense_shuffle":
        m = ts >= lits["ts"]
        key = lab[m].astype(np.int64) * NUM_STACKS + stk[m]
        space = NUM_CODES * NUM_STACKS
    else:
        m = ts >= lits["ts"]
        key = stk[m].astype(np.int64)
        space = NUM_STACKS
    x = val[m]
    cnt = np.bincount(key, minlength=space)
    first = np.full(space, len(key), np.int64)
    np.minimum.at(first, key, np.arange(len(key), dtype=np.int64))
    present = np.flatnonzero(cnt)
    g = present[np.argsort(first[present], kind="stable")]
    if name in ("dense_stack_minmax", "dense_stack_summin"):
        mn = np.full(space, np.iinfo(np.int64).max)
        mx = np.full(space, np.iinfo(np.int64).min)
        np.minimum.at(mn, key, x)
        np.maximum.at(mx, key, x)
        if name == "dense_stack_minmax":
            aggs = [mn[g], mx[g]]
        else:
            aggs = [np.bincount(key, weights=x, minlength=space).astype(np.int64)[g], mn[g]]
    else:
        s = np.bincount(key, weights=x, minlength=space).astype(np.int64)
        aggs = [s[g]] if name == "dense_shuffle" else [s[g], cnt[g]]
    if name == "dense_segment":
        keys = [g // 64, (g % 64) * DENSE_WINDOW]
    elif name == "dense_shuffle":
        keys = [g // NUM_STACKS, g % NUM_STACKS]
    else:
        keys = [g]
    return keys + aggs


def raw_columns(batches):
    """Per output column: its values over all batches (dictionary codes as
    codes) and whether every slot is valid."""
    if not batches:
        return []
    return [
        (np.concatenate([np.asarray(b.columns[j].values) for b in batches]),
         all(bool(np.asarray(b.columns[j].validity).all()) for b in batches))
        for j in range(len(batches[0].columns))
    ]


def flat_columns(batches):
    """Per output column over all batches: (name, kind, values, validity),
    dictionary codes decoded to their strings."""
    per_batch = batch_columns(batches)
    if not per_batch:
        return []
    return [
        (name, kind,
         np.concatenate([b[j][2] for b in per_batch]),
         np.concatenate([b[j][3] for b in per_batch]))
        for j, (name, kind, _v, _m) in enumerate(per_batch[0])
    ]


def same_columns(a, b, renames=None) -> bool:
    """The same columns (names, ``a``'s renamed by ``renames``), kinds,
    validity and valid values, batch boundaries aside."""
    fa, fb = flat_columns(a), flat_columns(b)
    renames = renames or {}
    if [(renames.get(n, n), k) for n, k, _v, _m in fa] != [(n, k) for n, k, _v, _m in fb]:
        return False
    return all(
        np.array_equal(ma, mb) and np.array_equal(va[ma], vb[mb])
        for (_n, _k, va, ma), (_n2, _k2, vb, mb) in zip(fa, fb)
    )


def dense_phase(AK, db, engine, generic, n_parts):
    """Slice 4's path: Parca's by-stacktrace merge and four more group-bys
    past the kernels' 2048 codes, on a table ``stacks`` built like the
    engine table but with Zipf-distributed stacktraces. Each shape once with
    the launch counts set to 0 before and read after (no K1-K6 may run),
    served by the dense tier on its route, equal to numpy at full width and
    to the generic DAG on a 2-part table; then timed over QUERY_REPS
    queries with varying literals, profiled, and the segment, table and
    sorted reductions timed on one query's inputs."""
    import torch

    from frostdb_tpu_torch.query import expr as E

    t0 = time.perf_counter()
    p = stack_probabilities()
    stacks, _data = build_table(db, "stacks", n_parts, seed=SEED + 4, stack_p=p)
    build_table(db, "stacks2", 2, seed=SEED + 5, stack_p=p)
    streams = {"stacks": scan_stream(stacks), "t": scan_stream(db.get_table("t"))}
    parts = stacks.collect_parts(db.high_watermark())
    stk = streams["stacks"][1]
    log(
        f"dense tables: stacks {n_parts} x {ROWS_PER_PART} rows in {len(parts)} visible "
        f"parts ({sum(q.device().n_pad for q in parts)} rows padded), "
        f"{len(np.unique(stk))} of {NUM_STACKS} stacks present, the most frequent in "
        f"{np.bincount(stk).max() / len(stk):.4f} of rows; stacks2 2 x {ROWS_PER_PART} rows; "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    for _name, _table, make_q, _r in dense_shapes(E, 0):
        run_shape(engine, make_q)
    torch.cuda.synchronize()

    AK.reset_launches()
    results = []
    table_parts = 0
    for name, table, make_q, route in dense_shapes(E, 0):
        out, taken, k, n_read = dense_route_probe(engine, make_q)
        table_parts += n_read if taken == "table" else 0
        if engine.last_serving_path != "dense":
            raise AssertionError(f"{name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
        if taken != route:
            raise AssertionError(f"{name}: route {taken} at K={k}, expected {route}")
        results.append((name, table, route, out, k))
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (dense shapes): {json.dumps(launches)}")
    if any(n for k, n in launches.items() if k in KERNELS):
        raise AssertionError("a K1-K6 kernel was launched on the dense shapes")
    if not launches["dense_segment_sum_count"]:
        raise AssertionError("the segment route launched no dense_segment_sum_count")
    if not table_parts or launches["dense_table_sum_count"] != table_parts:
        raise AssertionError(
            f"the table route launched dense_table_sum_count {launches['dense_table_sum_count']} "
            f"times, not once a part ({table_parts})")

    on_small = {name: make_q for name, _t, make_q, _r in dense_shapes(E, 0, "stacks2", "t2")}
    for name, table, route, out, k in results:
        got = raw_columns(out)
        want = dense_reference(name, 0, streams[table])
        if len(got) != len(want) or not all(
            valid and np.array_equal(v.astype(np.int64), w) for (v, valid), w in zip(got, want)
        ):
            raise AssertionError(f"{name}: result differs from the numpy reference")
        run_shape(engine, on_small[name])  # the first query uploads the table
        t1 = time.perf_counter()
        fast = run_shape(engine, on_small[name])
        t2 = time.perf_counter()
        path = engine.last_serving_path
        slow = run_shape(generic, on_small[name])
        t3 = time.perf_counter()
        if path != "dense" or generic.last_serving_path != "generic":
            raise AssertionError(f"{name} on the 2-part table: paths {path}/{generic.last_serving_path}")
        if not same_columns(fast, slow):
            raise AssertionError(f"{name}: the dense tier and the generic DAG differ on the 2-part table")
        log(
            f"{name}: K={k} ({route} route), "
            f"{len(want[0])} groups == numpy at full width; on the 2-part table the dense "
            f"tier == the generic DAG, rows and order ({sum(b.num_rows for b in fast)} groups; "
            f"dense {(t2 - t1) * 1e3:.1f} ms, generic DAG {t3 - t2:.2f} s)"
        )

    walls: dict = {}
    for i in range(QUERY_REPS):
        for name, _table, make_q, _route in dense_shapes(E, i):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_shape(engine, make_q)
            walls.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
            if engine.last_serving_path != "dense":
                raise AssertionError(f"{name} #{i}: served by {engine.last_serving_path}")
    for name, w in walls.items():
        log(
            f"engine {name}: median {statistics.median(w):.3f} ms, "
            f"min {min(w):.3f} ms over {len(w)} queries of {n_parts * ROWS_PER_PART} rows"
        )
    device_breakdown(
        [(name, lambda m=make_q: run_shape(engine, m)) for name, _t, make_q, _r in dense_shapes(E, 0)],
        walls, top=8,
    )
    for name, _table, make_q, _route in dense_shapes(E, 0):
        if name != "dense_shuffle":
            with capture_reductions() as captured:
                run_shape(engine, make_q)
            reduction_times(name, captured)
    log(f"dense phase: {time.perf_counter() - t0:.1f} s")
    return launches, {}


# ---------------------------------------------------------------------------
# Mesh phase (slice 7): the mesh tier over 1 and 4 shards of the one card

MESH_SHARDS = (1, 4)


def mesh_shapes(E, i):
    """The mesh phase's query shapes for query number ``i``: (name,
    fn(engine) -> query, tier under ExecOptions(mesh=...)). The five
    aggregate shapes on ``t``, dense_stack (the table route) and
    dense_shuffle (the pair exchange) on ``stacks``, an exact float sum
    (digit planes) and a float min/max (the two-pass (hi, lo) reduce) on
    ``fx``, and join_rows (the generic HashJoin, its pairs expanded by the
    distributed CSR join)."""
    ts, label, fv = E.Col("timestamp"), E.Col("labels.label1"), E.Col("floatvalue")
    lit = 40 + 37 * i
    out = [
        (name, lambda e, f=filt, a=aggs: e.scan_table("t").filter(f).aggregate(a, [label]), "mesh")
        for name, filt, aggs, _k in shapes(E, lit)
    ]
    out += [
        (name, make_q, "mesh")
        for name, _t, make_q, _r in dense_shapes(E, i)
        if name in ("dense_stack", "dense_shuffle")
    ]
    out += [
        ("fx_sum", lambda e: e.scan_table("fx").filter(ts.gt_eq(lit)).aggregate(
            [E.Sum(fv)], [label]), "mesh"),
        ("fx_minmax", lambda e: e.scan_table("fx").filter(ts.gt_eq(lit)).aggregate(
            [E.Min(fv), E.Max(fv)], [label]), "mesh"),
    ]
    out += [(name, make_q, "generic") for name, make_q, _t, _k in join_shapes(E, i) if name == "join_rows"]
    return out


def fx_minmax_reference(db, lit: int = 40):
    """fx_minmax's rows {label: (min, max)} with numpy over fx's parts."""
    parts = db.get_table("fx").collect_parts(db.high_watermark())
    codes, ts, fv = (
        np.concatenate([p.batch.column(c).values for p in parts])
        for c in ("labels.label1", "timestamp", "floatvalue")
    )
    m = ts >= lit
    mn = np.full(NUM_CODES, np.inf)
    mx = np.full(NUM_CODES, -np.inf)
    np.minimum.at(mn, codes[m], fv[m])
    np.maximum.at(mx, codes[m], fv[m])
    present = np.bincount(codes[m], minlength=NUM_CODES) > 0
    return {f"g{k}": (float(mn[k]), float(mx[k])) for k in np.flatnonzero(present)}


def mesh_modules(db, mesh) -> None:
    """The distributed modules once each on PartitionedTables of the first
    part of ``t`` over ``mesh``, each against numpy: a filtered sum, min,
    max and count (distributed_filter_aggregate), the labels present
    (distributed_distinct), the skew-aware exchange (shuffle_by_key_auto:
    every row kept, each label on its hash's shard) and an inner join with
    a duplicate-key build side (distributed_join_auto: every pair's keys
    equal, the pair count and the build values' sum as numpy's)."""
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
    from frostdb_tpu_torch.parallel import (
        PartitionedTable, distributed_distinct, distributed_filter_aggregate, shuffle_by_key_auto,
    )
    from frostdb_tpu_torch.parallel.join import distributed_join_auto
    from frostdb_tpu_torch.parallel.mesh import _hash_int64

    t0 = time.perf_counter()
    n_shards = len(mesh.devices)
    batch = db.get_table("t").collect_parts(db.high_watermark())[0].batch
    key = "labels.label1"
    codes = batch.column(key).values.astype(np.int64)
    ts, val = batch.column("timestamp").values, batch.column("value").values
    pt = PartitionedTable.from_batch(batch, mesh)

    (s, mn, mx), cnt = distributed_filter_aggregate(
        pt, key, NUM_CODES, [("sum", "value"), ("min", "value"), ("max", "value")],
        filter_col="timestamp", filter_op=">=", filter_literal=40,
    )()
    m = ts >= 40
    want_mn = np.full(NUM_CODES, np.iinfo(np.int64).max)
    want_mx = np.full(NUM_CODES, np.iinfo(np.int64).min)
    np.minimum.at(want_mn, codes[m], val[m])
    np.maximum.at(want_mx, codes[m], val[m])
    want = (
        np.bincount(codes[m], weights=val[m], minlength=NUM_CODES).astype(np.int64),
        want_mn, want_mx, np.bincount(codes[m], minlength=NUM_CODES),
    )
    for got, ref in zip((s, mn, mx, cnt), want):
        if not np.array_equal(got.cpu().numpy(), ref):
            raise AssertionError("distributed_filter_aggregate differs from numpy")
    present = distributed_distinct(pt, key, NUM_CODES + 8).cpu().numpy()
    if not np.array_equal(present, np.bincount(codes, minlength=NUM_CODES + 8) > 0):
        raise AssertionError("distributed_distinct differs from numpy")

    sh, salt = shuffle_by_key_auto(pt, key)
    k = np.asarray(sh.column(key).data).astype(np.int64)
    kv = np.asarray(sh.column(key).validity)
    v = np.asarray(sh.column("value").data)
    per = sh.n_pad // n_shards
    shard_of = np.repeat(np.arange(n_shards), per)
    if (
        kv.sum() != len(codes)
        or (salt == 1 and not np.array_equal(_hash_int64(k[kv]) % n_shards, shard_of[kv]))
        or not np.array_equal(
            np.bincount(k[kv], weights=v[kv], minlength=NUM_CODES),
            np.bincount(codes, weights=val, minlength=NUM_CODES),
        )
    ):
        raise AssertionError("shuffle_by_key_auto lost rows or misplaced a key")

    rk = np.array([c for c in range(0, NUM_CODES, 3) for _ in range(1 + c % 3)], np.int32)
    rw = np.arange(len(rk), dtype=np.int64) * 10 - 50
    ones = np.ones(len(rk), bool)
    right = ColumnBatch(
        [Column(key, KIND_DICT, rk, ones, batch.column(key).dictionary),
         Column("w", KIND_INT64, rw, ones)],
        len(rk),
    )
    left = PartitionedTable.from_batch(batch, mesh, hash_key=key)
    rpt = PartitionedTable.from_batch(right, mesh, hash_key=key)
    totals, li, rvalid, rvs, cap = distributed_join_auto(left, rpt, key, NUM_CODES, [key, "w"], "inner")
    lcodes = np.asarray(left.column(key).data)
    lvalid = np.asarray(left.column(key).validity)
    li, rvalid = np.asarray(li), np.asarray(rvalid)
    rcode, rwout = np.asarray(rvs[0]), np.asarray(rvs[2])
    per = left.n_pad // n_shards
    pairs, wsum = 0, 0
    for sh_i in range(n_shards):
        sl = slice(sh_i * cap, sh_i * cap + int(totals[sh_i]))
        lrow = sh_i * per + li[sl]
        if not (lvalid[lrow].all() and rvalid[sl].all() and np.array_equal(lcodes[lrow], rcode[sl])):
            raise AssertionError("distributed_join_auto paired rows of different keys")
        pairs += len(lrow)
        wsum += int(rwout[sl].sum())
    cnt_r = np.bincount(rk, minlength=NUM_CODES)
    sum_r = np.bincount(rk, weights=rw, minlength=NUM_CODES).astype(np.int64)
    if pairs != int(cnt_r[codes].sum()) or wsum != int(sum_r[codes].sum()):
        raise AssertionError("distributed_join_auto differs from numpy")
    log(
        f"mesh modules on {n_shards} shards over one part of t ({len(codes)} rows): "
        f"distributed_filter_aggregate, distributed_distinct, shuffle_by_key_auto (salt {salt}) "
        f"and distributed_join_auto (inner, {pairs} pairs, cap {cap}) == numpy, "
        f"{time.perf_counter() - t0:.1f} s"
    )


def mesh_phase(AK, db, engine, smi, device="cuda"):
    """Slice 7's path: every mesh shape on the mesh tier at 1 and at 4
    shards (all on the one card), once with the launch counts set to 0
    before and read after (no K1-K6 may run): each served by ``mesh``
    (join_rows by the generic HashJoin), its rows equal, in order, to the
    same shape's rows from its local tier, which the earlier phases held to
    numpy (fx_minmax, new here, against numpy too); at 4 shards
    dense_shuffle must move pairs across shards. Then the distributed
    modules against numpy, the shapes timed over QUERY_REPS queries at each
    shard count and profiled, and the parts' sharded mirrors dropped."""
    import torch

    from frostdb_tpu_torch.device import SHARDED_UPLOAD_STATS, ShardedDeviceBatch
    from frostdb_tpu_torch.parallel import mesh_exec as ME
    from frostdb_tpu_torch.parallel.mesh import make_mesh
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions

    t0 = time.perf_counter()
    meshes = {n: make_mesh(n, device=device) for n in MESH_SHARDS}
    for n, mesh in meshes.items():
        log(f"mesh of {n} shard(s): " + ", ".join(f"shard {s} on {d}" for s, d in enumerate(mesh.devices)))
    engines = {n: LocalEngine(db.table_provider(), ExecOptions(mesh=mesh)) for n, mesh in meshes.items()}

    steps: dict = {}
    t_step = time.perf_counter()
    local = {}
    for name, make_q, _tier in mesh_shapes(E, 0):
        local[name] = (run_shape(engine, make_q), engine.last_serving_path)
    got = {r[0][1]: tuple(v for _n, v in r[1:]) for r in as_rows(local["fx_minmax"][0])}
    if got != fx_minmax_reference(db):
        raise AssertionError(f"fx_minmax on the {local['fx_minmax'][1]} tier differs from numpy")
    steps["local tiers"] = time.perf_counter() - t_step

    # The main path, also the first query of each shape at each shard
    # count: it uploads the parts' sharded mirrors.
    t_step = time.perf_counter()
    AK.reset_launches()
    exchange = {}
    for n, eng in engines.items():
        before = dict(SHARDED_UPLOAD_STATS)
        took: dict = {}
        t2 = time.perf_counter()
        ME.EXCHANGE_STATS.update(exchanges=0, pairs=0, bytes=0, oversub=0.0)
        with timed_calls(ShardedDeviceBatch, "_upload", took):
            for name, make_q, tier in mesh_shapes(E, 0):
                out = run_shape(eng, make_q)
                if eng.last_serving_path != tier:
                    raise AssertionError(f"{name} at {n} shard(s): served by {eng.last_serving_path}: {eng.last_fallback_reasons}")
                if not same_columns(out, local[name][0]):
                    raise AssertionError(f"{name} at {n} shard(s) differs from the {local[name][1]} tier's rows")
            torch.cuda.synchronize()
        exchange[n] = dict(ME.EXCHANGE_STATS)  # dense_shuffle's: no other shape exchanges
        log(
            f"mesh {n} shard(s): sharded upload of "
            f"{SHARDED_UPLOAD_STATS['columns'] - before['columns']} columns, "
            f"{SHARDED_UPLOAD_STATS['bytes'] - before['bytes']} bytes in {took['_upload']:.3f} s, "
            f"within the first pass over the shapes of {time.perf_counter() - t2:.1f} s"
        )
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (mesh shapes): {json.dumps(launches)}")
    if any(n for k, n in launches.items() if k in KERNELS):
        raise AssertionError("a K1-K6 kernel was launched on the mesh shapes")
    for name, _make_q, tier in mesh_shapes(E, 0):
        want, local_tier = local[name]
        log(
            f"{name}: {sum(b.num_rows for b in want)} rows on the {tier} tier at "
            f"{' and '.join(map(str, MESH_SHARDS))} shards == the {local_tier} tier's rows, in order"
        )
    ex = exchange[MESH_SHARDS[-1]]
    log(
        f"dense_shuffle at {MESH_SHARDS[-1]} shards: {ex['exchanges']} pair exchanges (one per part), "
        f"{ex['pairs']} pairs and {ex['bytes']} bucket bytes crossed shards, oversub ended at {ex['oversub']}"
    )
    if ex["pairs"] == 0:
        raise AssertionError("dense_shuffle moved no pair across shards")
    steps["main path"] = time.perf_counter() - t_step

    t_step = time.perf_counter()
    mesh_modules(db, meshes[MESH_SHARDS[-1]])
    steps["modules"] = time.perf_counter() - t_step

    t_step = time.perf_counter()
    log(
        f"mesh timings on {smi}: the {MESH_SHARDS[-1]} shards share the one card's SMs and "
        f"memory bandwidth, so their times are not a scaling number"
    )
    walls: dict = {}
    for i in range(QUERY_REPS):
        for n, eng in engines.items():
            for name, make_q, tier in mesh_shapes(E, i):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run_shape(eng, make_q)
                walls.setdefault(f"{name}@{n}", []).append((time.perf_counter() - t1) * 1e3)
                if eng.last_serving_path != tier:
                    raise AssertionError(f"{name} #{i} at {n} shard(s): served by {eng.last_serving_path}")
    for key, w in walls.items():
        log(f"mesh {key}: median {statistics.median(w):.3f} ms, min {min(w):.3f} ms over {len(w)} queries")
    steps["timing"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    device_breakdown(
        [(f"{name}@{n}", lambda e=eng, m=make_q: run_shape(e, m))
         for n, eng in engines.items() for name, make_q, _t in mesh_shapes(E, 0)],
        walls, top=6,
    )
    steps["profile"] = time.perf_counter() - t_step
    for name in ("t", "t2", "stacks", "fx"):
        for p in db.get_table(name).collect_parts(db.high_watermark()):
            p._device_sharded.clear()
    torch.cuda.empty_cache()
    log(
        f"mesh phase: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items()) + ")"
    )
    return launches, {}


# ---------------------------------------------------------------------------
# SQL part: every phase's shapes once more as SQL text


def sql_texts(lit, i):
    """Each engine shape as SQL text (aggregate shapes at ``lit``, the rest
    at query number ``i``), or None where SQL has no form for it."""
    j, d = join_literals(i), dense_literals(i)
    low = 5 + i % 3
    by_label = "group by labels.label1"
    return {
        "band_ts_ge": f"select labels.label1, sum(value), count(value) where timestamp >= {lit} {by_label}",
        "band3_dict_eq": (f"select labels.label1, sum(value) where timestamp >= {lit} and "
                          f"timestamp < {lit + 600} and example_type = 'cpu' {by_label}"),
        "int_eq": f"select labels.label1, sum(value), count(value) where value = {lit} {by_label}",
        "or": (f"select labels.label1, sum(value), count(value) where timestamp < {lit} or "
               f"timestamp >= {lit + 800} {by_label}"),
        "min_max": f"select labels.label1, min(value), max(value) where timestamp >= {lit} {by_label}",
        "scan_value_gt": f"select example_type, value where value > {995 - i % 3}",
        "scan_label_band_limit": (f"select labels.label1, timestamp, value where labels.label1 = "
                                  f"'g{(7 + i) % NUM_CODES}' and timestamp >= 500 limit 1000"),
        "scan_or": f"select value where timestamp < {low} or timestamp >= {990 + low}",
        "scan_or_value": f"select timestamp where value < {low} or value >= {990 + low}",
        "distinct_values": "select distinct(labels.label1)",
        "distinct_types": f"select distinct(example_type, value > {500 + i})",
        "schema_labels": None,
        "join_agg": (f"select labels.label1, sum(weight) from t inner join dims on labels.label1 "
                     f"where timestamp >= {j['ts']} {by_label}"),
        "join_all_aggs": (f"select labels.label1, count(value), sum(value), sum(weight), min(weight), "
                          f"max(weight) from t inner join dims_dup on labels.label1 where "
                          f"timestamp >= {j['ts']} {by_label}"),
        # SQL cannot filter a join's build side: the forms join dims whole,
        # the same build side as the API form's weight >= W where W is 0
        "join_semi": (f"select labels.label1, count(value) from t semi join dims using (labels.label1) {by_label}"
                      if j["weight"] == 0 else None),
        "join_anti": (f"select labels.label1, count(value) from t anti join dims using (labels.label1) {by_label}"
                      if j["weight"] == 0 else None),
        "join_left_outer": (f"select labels.label1, count(value), sum(weight), sum(value) from t left "
                            f"outer join dims on labels.label1 where timestamp >= {j['ts']} {by_label}"),
        "join_int_key": (f"select labels.label1, count(value), sum(w), sum(value) from t inner join "
                         f"idims on timestamp where value < {j['value_lt']} {by_label}"),
        "join_rows": (f"select labels.label1, value, weight from t inner join dims_dup on labels.label1 "
                      f"where value > {j['value_gt']}"),
        "dense_stack": f"select stacktrace, sum(value), count(value) where timestamp >= {d['ts']} group by stacktrace",
        "dense_stack_minmax": (f"select stacktrace, min(value), max(value) where timestamp >= {d['ts']} "
                               f"group by stacktrace"),
        "dense_stack_summin": (f"select stacktrace, sum(value), min(value) where timestamp >= {d['ts']} "
                               f"group by stacktrace"),
        # SQL's windows are whole seconds (second(n)); a 20-unit window is
        # the projected key (timestamp / 20) * 20, emitted as "bucket"
        "dense_segment": (f"select labels.label1, (timestamp / {DENSE_WINDOW}) * {DENSE_WINDOW} as bucket, "
                          f"sum(value), count(value) where value >= {d['value']} group by labels.label1, bucket"),
        "dense_shuffle": (f"select labels.label1, stacktrace, sum(value) where timestamp >= {d['ts']} "
                          f"group by labels.label1, stacktrace"),
    }


SQL_RENAMES = {"dense_segment": {"timestamp": "bucket"}}
SQL_NOTES = {
    "join_semi": "SQL joins dims whole; the API form's build-side weight >= 0 keeps every row",
    "join_anti": "SQL joins dims whole; the API form's build-side weight >= 0 keeps every row",
    "dense_segment": "SQL names the 20-unit window key bucket",
}
SQL_NOT_EXPRESSIBLE = {
    "schema_labels": "a schema scan (scan_schema): the SQL front end scans tables only",
    "join_semi": "a filtered build side: SQL joins a table by name",
    "join_anti": "a filtered build side: SQL joins a table by name",
}


def sql_part(engine, lit: int = 40):
    """Every phase's engine shapes once more as SQL text through the port's
    sqlparse, untimed: the same serving tier and the same rows (columns,
    order, kinds, nulls) as the same shape through the query API."""
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.sqlparse import Parser

    t0 = time.perf_counter()
    texts = sql_texts(lit, 0)
    forms = [
        (name, "t", lambda e, f=filt, a=aggs: e.scan_table("t").filter(f).aggregate(
            a, [E.Col("labels.label1")]))
        for name, filt, aggs, _k in shapes(E, lit)
    ]
    forms += [(name, "t", make_q) for name, make_q, _t, _k in scan_shapes(E, 0)]
    forms += [(name, "t", make_q) for name, make_q, _t, _k in join_shapes(E, 0)]
    forms += [(name, table, make_q) for name, table, make_q, _r in dense_shapes(E, 0)]
    n_checked = 0
    for name, table, make_q in forms:
        sql = texts[name]
        if sql is None:
            log(f"sql {name}: not expressible in SQL ({SQL_NOT_EXPRESSIBLE[name]})")
            continue
        want = run_shape(engine, make_q)
        path = engine.last_serving_path
        res = Parser().parse(engine.scan_table(table), ["labels"], sql)
        got = []
        res.plan.execute(got.append)
        if engine.last_serving_path != path:
            raise AssertionError(f"sql {name}: served by {engine.last_serving_path}, the API form by {path}")
        if not same_columns(want, got, SQL_RENAMES.get(name)):
            raise AssertionError(f"sql {name}: rows differ from the API form")
        n_checked += 1
        note = f" ({SQL_NOTES[name]})" if name in SQL_NOTES else ""
        log(f"sql {name}: {path}, {sum(b.num_rows for b in got)} rows == the API form{note}: {sql}")
    log(f"sql part: {n_checked} shapes as SQL text, same tier and rows, {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Durability phase (slice 5)

# FrostDB as Parca runs it with persistence: every acknowledged insert is
# fsynced to the WAL, rotated blocks go to a bucket that is also a source,
# the active block rotates at TableConfig's default 512 MiB and a snapshot
# is due every 256 MiB of inserts (half the active memory). Both sizes scale
# with ROWS_PER_PART, so a cut rehearsal still rotates after inserts 10, 20
# and 30.
def durable_sizes() -> tuple:
    """(active block bytes, snapshot trigger bytes) at this ROWS_PER_PART."""
    active = (512 << 20) * ROWS_PER_PART // (1 << 21)
    return active, active // 2


DURABLE_SHAPES = ("band_ts_ge", "band3_dict_eq", "int_eq", "or", "min_max",
                  "scan_value_gt", "distinct_values")
DURABLE_KERNELS = ("fused_band_group_sum_count", "group_sum_count", "group_min_max",
                   "fused_cmp_group_sum_count", "block_compact")


def durable_shapes(E, i, lit):
    """The phase's seven shapes for query number ``i``: (name, fn(engine)
    -> query, serving tier, kernels), the aggregates at literal ``lit``."""
    out = [
        (name, lambda e, f=filt, a=aggs: e.scan_table("t").filter(f).aggregate(
            a, [E.Col("labels.label1")]), "compiled", kernels)
        for name, filt, aggs, kernels in shapes(E, lit)
    ]
    return out + [s for s in scan_shapes(E, i) if s[0] in DURABLE_SHAPES]


def tree_bytes(path) -> tuple:
    """(files, bytes) under ``path``."""
    import os

    n = size = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            n += 1
            size += os.path.getsize(os.path.join(root, f))
    return n, size


@contextlib.contextmanager
def timed_calls(owner, attr, took):
    """Add the seconds of every call of ``owner.attr`` to ``took[attr]``
    while the block runs."""
    fn = getattr(owner, attr)
    took.setdefault(attr, 0.0)

    def call(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            took[attr] += time.perf_counter() - t

    setattr(owner, attr, call)
    try:
        yield took
    finally:
        setattr(owner, attr, fn)


def durable_store(root, device):
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.store import FileSystemBucket

    bucket = FileSystemBucket(f"{root}/bucket")
    return ColumnStore(
        storage_path=f"{root}/db", enable_wal=True, wal_sync=True,
        snapshot_trigger_size=durable_sizes()[1], sources=[bucket],
        sinks=[bucket], device=device,
    ), bucket


def durability_phase(AK, t_engine, n_parts, device="cuda"):
    """Slice 5's path: build_table's data into a durable store (WAL with
    fsync, bucket sink and source, snapshots), a hard kill after the last
    acknowledged insert, recovery on the card timed by part, then the seven
    shapes on the recovered table with the launch counts set to 0 before
    and read after: each on its tier, equal to numpy over every acknowledged
    row and to the same shape on ``t``, timed and profiled; one shape over
    gRPC; dbtool on the store's files. The store lives in a temporary
    directory, removed at the end."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="frostdb-durable-")
    try:
        return _durability(AK, t_engine, n_parts, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _durability(AK, t_engine, n_parts, device, root):
    import io
    import os
    import shutil

    import torch

    import frostdb_tpu_torch.snapshot as S
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.schema import sample_definition
    from frostdb_tpu_torch.store import FileSystemBucket
    from frostdb_tpu_torch.table import TableConfig
    from frostdb_tpu_torch.wal import FileWAL

    t_phase = time.perf_counter()
    total = n_parts * ROWS_PER_PART
    log(f"durable store in {root}: {shutil.disk_usage(root).free / 2**30:.1f} GiB free there")

    # Ingest with durability on, then a hard kill after the last ack.
    store, bucket = durable_store(root, device)
    db = store.db("durable")
    db.table("t", TableConfig(schema=sample_definition(), active_memory_size=durable_sizes()[0]))
    insert_s: list = []
    t0 = time.perf_counter()
    table, data = build_table(db, "t", n_parts, sync=False, insert_s=insert_s)
    wall = time.perf_counter() - t0
    snaps_bytes = store.metrics.snapshot_bytes.value()
    log(
        f"durable ingest: {n_parts} inserts x {ROWS_PER_PART} rows, "
        f"{total / sum(insert_s):.4g} rows/s acknowledged (insert calls {sum(insert_s):.2f} s, "
        f"median {statistics.median(insert_s) * 1e3:.1f} ms, max {max(insert_s) * 1e3:.1f} ms; "
        f"{wall:.2f} s with data generation); {table.metrics.rotations.value():.0f} rotations, "
        f"{store.metrics.snapshots_total.value():.0f} snapshots ({snaps_bytes / 2**20:.1f} MiB), "
        f"{store.metrics.wal_truncations.value():.0f} WAL truncations"
    )
    pending = len(table.pending_blocks)
    db.wal.hard_kill()
    t0 = time.perf_counter()
    db.join_background(timeout=600.0)
    quiet_s = time.perf_counter() - t0
    busy = table._rot_running or any(
        b.index._bg_running for b in [table.active_block] + list(table.pending_blocks)
    )
    if busy:
        raise AssertionError("the killed store's background threads are still running")
    wal_files, wal_b = tree_bytes(os.path.join(root, "db", "databases", "durable", "wal"))
    snap_files, snap_b = tree_bytes(os.path.join(root, "db", "databases", "durable", "snapshots"))
    idx_files, idx_b = tree_bytes(os.path.join(root, "db", "databases", "durable", "index"))
    pq_files, pq_b = tree_bytes(os.path.join(root, "bucket"))
    blocks = bucket.blocks("durable", "t")
    log(
        f"hard kill after insert {n_parts}: {pending} rotated blocks still pending, "
        f"background quiet after {quiet_s:.2f} s; on disk: WAL {wal_files} segments "
        f"{wal_b / 2**20:.1f} MiB, snapshots {snap_files} files {snap_b / 2**20:.1f} MiB, "
        f"disk-level index {idx_files} files {idx_b / 2**20:.1f} MiB, bucket {len(blocks)} "
        f"blocks in {pq_files} files {pq_b / 2**20:.1f} MiB"
    )
    del table

    # Recovery on the card, timed by part.
    took: dict = {}
    with timed_calls(S, "load_snapshot", took), timed_calls(FileWAL, "replay", took):
        t0 = time.perf_counter()
        store2, _bucket2 = durable_store(root, device)
        db2 = store2.db("durable")
        open_s = time.perf_counter() - t0
    engine = LocalEngine(db2.table_provider())
    band = durable_shapes(E, 0, 40)[0][1]
    with timed_calls(FileSystemBucket, "read_block_parts", took):
        t0 = time.perf_counter()
        run_shape(engine, band)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    if engine.last_serving_path != "compiled":
        raise AssertionError(f"first query served by {engine.last_serving_path}")
    t2 = db2.get_table("t")

    def layout():
        sizes = [p.batch.num_rows for p in t2.collect_parts(db2.high_watermark(), include_sources=True)]
        return (f"{len(sizes)} parts ({sum(sizes)} rows; {len(t2.source_parts() or ())} "
                f"from the bucket, largest {max(sizes)}, smallest {min(sizes)} rows)")

    first_layout = layout()
    # Replayed writes compact, and snapshot-restored pending blocks persist,
    # on worker threads: the steady path runs on the settled layout.
    t0 = time.perf_counter()
    t2.sync()
    settle_s = time.perf_counter() - t0
    log(
        f"durable recovery: open {open_s:.3f} s = snapshot load {took['load_snapshot']:.3f} s + "
        f"WAL replay (two passes) {took['replay']:.3f} s + rest "
        f"{open_s - took['load_snapshot'] - took['replay']:.3f} s; first query {first_s:.3f} s "
        f"= bucket row groups read {took['read_block_parts']:.3f} s + upload, planes and "
        f"kernels {first_s - took['read_block_parts']:.3f} s on {first_layout}; resumed "
        f"persists and compactions settled {settle_s:.3f} s later: {layout()}, "
        f"{len(t2.pending_blocks)} blocks pending"
    )

    # The main path: the seven shapes once, checked.
    flat = tuple(np.concatenate([d[j] for d in data]) for j in range(3))
    AK.reset_launches()
    results = []
    with capture_kernel_args(AK) as seen:
        for name, make_q, tier, kernels in durable_shapes(E, 0, 40):
            before = dict(AK.LAUNCHES)
            n_seen = len(seen)
            out = run_shape(engine, make_q)
            moved = {k for k in AK.LAUNCHES if AK.LAUNCHES[k] > before[k]}
            if engine.last_serving_path != tier:
                raise AssertionError(f"durable {name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
            if moved != kernels:
                raise AssertionError(f"durable {name}: launched {moved}, expected {kernels}")
            results.append((name, make_q, out, seen[n_seen:]))
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (durable shapes on the recovered table): {json.dumps(launches)}")
    for k in DURABLE_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the recovered table")
    checked = 0
    for name, make_q, out, calls in results:
        ref_t = run_shape(t_engine, make_q)
        if name in ("scan_value_gt", "distinct_values"):
            ok = scan_reference_ok(name, 0, out, flat) and sorted(as_rows(out)) == sorted(as_rows(ref_t))
        else:
            got = {r[0][1]: tuple(v for _n, v in r[1:]) for r in as_rows(out)}
            on_t = {r[0][1]: tuple(v for _n, v in r[1:]) for r in as_rows(ref_t)}
            ok = got == host_reference(name, data, 40) == on_t
        if not ok:
            raise AssertionError(f"durable {name}: differs from numpy or from t")
        # Each kernel's first call of the shape against its plain version.
        done: set = set()
        for kname, args in calls:
            if kname in done:
                continue
            done.add(kname)
            e = max_abs_err(getattr(AK, kname)(*args), getattr(AK, kname + "_plain")(*args))
            if e:
                raise AssertionError(f"durable {name}: {kname} differs from its plain version by {e}")
            checked += 1
    counts = run_shape(engine, durable_shapes(E, 0, 0)[0][1])
    n_rows = sum(r[2][1] for r in as_rows(counts))
    if n_rows != total:
        raise AssertionError(f"recovered table holds {n_rows} rows, {total} were acknowledged")
    log(
        f"durable shapes: all 7 on their tiers, equal to numpy over all {total} acknowledged "
        f"rows and to the same shape on t; {n_rows} rows counted, none lost or doubled; "
        f"{checked} kernel calls equal to their plain versions"
    )

    # Latency on the recovered table against t, interleaved.
    walls: dict = {}
    for i in range(QUERY_REPS):
        for name, make_q, _tier, _k in durable_shapes(E, i, 100 + 37 * i):
            for label, eng in (("durable", engine), ("t", t_engine)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run_shape(eng, make_q)
                torch.cuda.synchronize()
                walls.setdefault(f"{label} {name}", []).append((time.perf_counter() - t1) * 1e3)
    for name in DURABLE_SHAPES:
        w, wt = walls[f"durable {name}"], walls[f"t {name}"]
        log(
            f"durable {name}: median {statistics.median(w):.3f} ms (t: {statistics.median(wt):.3f} ms), "
            f"min {min(w):.3f} ms over {len(w)} queries of {total} rows"
        )
    device_breakdown(
        [(f"durable {name}", lambda m=make_q: run_shape(engine, m))
         for name, make_q, _t, _k in durable_shapes(E, 0, 90)],
        walls,
    )

    # One shape over gRPC on localhost: the same rows as LocalEngine.
    from frostdb_tpu_torch.exprpb import RemoteClient, make_grpc_server
    from frostdb_tpu_torch.query.logical import Builder

    plan = (
        Builder().scan(db2.table_provider(), "t").filter(E.Col("timestamp").gt_eq(40))
        .aggregate([E.Sum(E.Col("value")), E.Count(E.Col("value"))], [E.Col("labels.label1")])
        .build()
    )
    server, port = make_grpc_server(store2)
    server.start()
    try:
        client = RemoteClient(f"127.0.0.1:{port}")
        before = AK.LAUNCHES["fused_band_group_sum_count"]
        t0 = time.perf_counter()
        remote = as_rows(list(client.query(plan, database="durable")))
        grpc_ms = (time.perf_counter() - t0) * 1e3
        grpc_k1 = AK.LAUNCHES["fused_band_group_sum_count"] - before
        client.channel.close()
    finally:
        server.stop(0).wait()
    local = as_rows(run_shape(engine, band))
    if remote != local:
        raise AssertionError("gRPC rows differ from LocalEngine's")
    log(
        f"gRPC band_ts_ge on 127.0.0.1: {len(remote)} rows == LocalEngine (order included), "
        f"{grpc_ms:.3f} ms, fused_band_group_sum_count launched {grpc_k1} times for it"
    )

    # dbtool on the recovered store's files.
    from frostdb_tpu_torch.tools import dbtool

    base = os.path.join(root, "db", "databases", "durable")
    snap_txs = S.list_snapshot_txns(os.path.join(base, "snapshots"))
    reports = []
    for argv in (["wal", os.path.join(base, "wal")],
                 ["snapshot", S.snapshot_path(os.path.join(base, "snapshots"), snap_txs[-1])]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dbtool.main(argv)
        text = buf.getvalue().strip().splitlines()
        if not text:
            raise AssertionError(f"dbtool {argv[0]} printed nothing")
        reports.append(f"{argv[0]}: {text[0]}" + (f" / {text[1]}" if len(text) > 1 else ""))
    log("dbtool on the store: " + "; ".join(reports))
    store2.close()
    log(f"durability phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The rest of the package on the card (phase 9): tools/verify's cases, the
# scan fan-out's lanes, concurrent writers with compiled readers, tracing,
# pruning and struct schemas

VERIFY_SCALES = (1, 1024)  # 1024: 0.77M-3.1M rows per part
VERIFY_SEEDS = (0, 1)
FANOUT_LANES = 8
# Parca's ingest width (sample_definition) from 4 writers at once.
CC_WRITERS = 4
CC_INSERTS = 16
CC_ROWS = 1 << 16
CC_LIT = 40
# Each writer's pause between inserts: the four together then ingest a
# steady ~2.6M rows/s instead of one burst, so the readers see the table
# change between their queries.
CC_PAUSE_S = 0.1
PRUNE_PARTS = 8
# Rows per insert: at 2^15 the eight inserts stay eight label-disjoint parts
# (below L0's 15 MiB); at 2^20 the LSM merges them.
PRUNE_ROWS = (1 << 15, 1 << 20)
STRUCT_ROWS = 1 << 16
# Rounds of the read path's A/B: its two sides differ by microseconds, and
# ten rounds of 1-2 ms queries read the host clock's spread.
READ_PATH_ROUNDS = 30


def fanout_shapes(E):
    """tests/test_scan_fanout.py's five shapes: (name, fn(engine) ->
    query, ordered)."""
    return [
        ("group_sum_first_occurrence_order",
         lambda e: e.scan_table("t2").aggregate(
             [E.Sum(E.Col("value")), E.Count(E.Col("value"))], [E.Col("example_type")]),
         False),
        ("filtered_group_minmax",
         lambda e: e.scan_table("t2").filter(E.Col("timestamp").gt(300)).aggregate(
             [E.Min(E.Col("value")), E.Max(E.Col("value"))], [E.Col("stacktrace")]),
         False),
        ("distinct",
         lambda e: e.scan_table("t2").distinct(E.Col("example_type"), E.Col("stacktrace")),
         False),
        ("limit_of_limits",
         lambda e: e.scan_table("t2").project(E.Col("timestamp"), E.Col("value")).limit(
             E.Literal(37)),
         False),
        ("ordered_aggregation",
         lambda e: e.scan_table("t2").aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")]),
         True),
    ]


# The span trees (names and nesting) of tests/test_tracing_integration.py's
# two traced queries, as both packages give them on the CPU
# (tests/test_torch_tracing.py holds this constant to the JAX package's).
TRACE_TREES = {
    "compiled": ("query/execute", [("plan/optimize", []), ("compiled/execute", [])]),
    "generic": ("query/execute", [
        ("plan/optimize", []), ("physical/build", []),
        ("physical/execute", [("table/iterator", [])]),
    ]),
}


def trace_queries(E):
    """(name, fn(engine) -> query, compiled) of the two traced queries."""
    return [
        ("compiled",
         lambda e: e.scan_table("t").aggregate([E.Sum(E.Col("value"))], [E.Col("example_type")]),
         True),
        ("generic",
         lambda e: e.scan_table("t").filter(E.Col("timestamp").gt_eq(10)).aggregate(
             [E.Sum(E.Col("value"))], [E.Col("labels.label1")]),
         False),
    ]


def span_names(span):
    """(name, children) as the JAX package emits them: the spans only the
    port emits dropped with their children lifted, tier spans renamed."""
    from frostdb_tpu_torch.tracing import PORT_ONLY_SPANS, REFERENCE_TIER_SPAN

    def kept(s):
        children = [t for c in s.children for t in kept(c)]
        if s.name in PORT_ONLY_SPANS:
            return children
        return [(REFERENCE_TIER_SPAN.get(s.name, s.name), children)]

    (tree,) = kept(span)
    return tree


def trace_table(db):
    """tests/test_tracing_integration.py's table: 50 rows in one sorted
    insert."""
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
    from frostdb_tpu_torch.schema import sample_definition
    from frostdb_tpu_torch.table import TableConfig

    table = db.table("t", TableConfig(schema=sample_definition()))
    n = 50
    d_et, d_l, d_st = (table.dictionary(f) for f in ("example_type", "labels", "stacktrace"))
    ones = np.ones(n, dtype=bool)
    table.insert_record(ColumnBatch([
        Column("example_type", KIND_DICT, *d_et.encode(["cpu"] * n), d_et),
        Column("labels.label1", KIND_DICT, *d_l.encode([f"l{i % 3}" for i in range(n)]), d_l),
        Column("stacktrace", KIND_DICT, *d_st.encode(["s"] * n), d_st),
        Column("timestamp", KIND_INT64, np.arange(n, dtype=np.int64), ones),
        Column("value", KIND_INT64, np.ones(n, dtype=np.int64), ones),
    ], n), sort=True)
    return table


def traced_run(db):
    """The two traced queries on ``db``'s table ``t``: per query (name,
    rows, serving tier, span names, root attributes), then the
    ``queries_served_*`` counters."""
    from frostdb_tpu_torch.metrics import MetricsRegistry
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions
    from frostdb_tpu_torch.tracing import Tracer

    out = []
    registry = MetricsRegistry()
    for name, make_q, compiled in trace_queries(E):
        tracer = Tracer()
        engine = LocalEngine(db.table_provider(), ExecOptions(
            compiled_serving=compiled, tracer=tracer, metrics=registry))
        batches = run_shape(engine, make_q)
        (root,) = tracer.roots
        out.append((name, as_rows(batches), engine.last_serving_path, span_names(root),
                    dict(root.attributes)))
    served = {p: registry.counter(f"queries_served_{p}").value() for p in ("compiled", "generic")}
    return out, served


def verify_part(device) -> None:
    """tools/verify's cases at each VERIFY_SCALES and seed: compiled ==
    generic byte for byte, served by compiled, K1-K4 launched (K3 for
    min/max); launch counts printed per case."""
    from frostdb_tpu_torch.tools import verify as V

    for scale in VERIFY_SCALES:
        t0 = time.perf_counter()
        for seed in VERIFY_SEEDS:
            for name, fn in V.CASES:
                r = V.run_case(fn, seed, device, scale)
                if r["problems"]:
                    raise AssertionError(
                        f"verify x{scale} seed {seed} {name}: " + "; ".join(r["problems"]))
                counts = {k: n for k, n in r["launches"].items() if n}
                log(f"verify x{scale} seed {seed} {name}: ok, {len(r['compiled'])} groups, "
                    f"{r['rows']} rows, launches {json.dumps(counts)}")
        log(f"verify: {len(VERIFY_SEEDS) * len(V.CASES)} cases at rows scale {scale} "
            f"in {time.perf_counter() - t0:.1f} s")


def fanout_part(db) -> None:
    """test_scan_fanout's shapes on t2 through the generic DAG with
    concurrency=8: the fan-out forced on (threshold 0) must equal it forced
    off, byte for byte, and lane threads must have run."""
    import threading

    import frostdb_tpu_torch.config as C
    import frostdb_tpu_torch.table as T
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions

    lanes = []
    thread_cls = T.threading.Thread

    class LaneThread(thread_cls):
        def __init__(self, *a, **kw):
            lanes.append(threading.current_thread().name)
            super().__init__(*a, **kw)

    def run(make_q, ordered, threshold):
        engine = LocalEngine(db.table_provider(), ExecOptions(
            concurrency=FANOUT_LANES, compiled_serving=False, ordered_aggregations=ordered))
        old = C.PARALLEL_SCAN_MIN_ROWS
        C.PARALLEL_SCAN_MIN_ROWS = threshold
        T.threading.Thread = LaneThread
        try:
            t = time.perf_counter()
            out = as_rows(run_shape(engine, make_q))
            return out, (time.perf_counter() - t) * 1e3, engine.last_serving_path
        finally:
            T.threading.Thread = thread_cls
            C.PARALLEL_SCAN_MIN_ROWS = old

    for name, make_q, ordered in fanout_shapes(E):
        serial, serial_ms, path = run(make_q, ordered, 1 << 60)
        n_serial = len(lanes)
        if path != "generic" or n_serial:
            raise AssertionError(f"fanout {name}: serial run on {path}, {n_serial} lane threads")
        times = []
        for _ in range(2):
            fanned, ms, _p = run(make_q, ordered, 0)
            if fanned != serial:
                raise AssertionError(f"fanout {name}: lanes differ from the serial scan")
            times.append(ms)
        if not lanes:
            raise AssertionError(f"fanout {name}: no lane thread ran")
        log(f"fanout {name}: {len(serial)} rows byte-identical with {len(lanes)} lane "
            f"threads over 2 runs; serial {serial_ms:.1f} ms, fanned out "
            f"{', '.join(f'{t:.1f}' for t in times)} ms")
        lanes.clear()


def cc_batch(table, rng):
    """One writer's insert: CC_ROWS rows of 64 labels, and its per-label
    (sum, count) of value over rows with timestamp >= CC_LIT."""
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64

    n = CC_ROWS
    d_et, d_l, d_st = (table.dictionary(f) for f in ("example_type", "labels", "stacktrace"))
    labels = rng.integers(0, NUM_CODES, n)
    ts = rng.integers(0, 1000, n).astype(np.int64)
    val = rng.integers(0, 1000, n).astype(np.int64)
    ones = np.ones(n, dtype=bool)
    # Each insert encodes its label values (the writers' first encodes
    # race) and maps its rows through their codes.
    label_codes = d_l.encode([f"g{k}" for k in range(NUM_CODES)])[0]
    batch = ColumnBatch([
        Column("example_type", KIND_DICT, np.full(n, d_et.code("cpu"), np.int32), ones, d_et),
        Column("labels.label1", KIND_DICT, label_codes[labels], ones, d_l),
        Column("stacktrace", KIND_DICT, np.full(n, d_st.code("stack"), np.int32), ones, d_st),
        Column("timestamp", KIND_INT64, ts, ones),
        Column("value", KIND_INT64, val, ones),
    ], n)
    m = ts >= CC_LIT
    agg = np.stack([
        np.bincount(labels[m], weights=val[m], minlength=NUM_CODES),
        np.bincount(labels[m], minlength=NUM_CODES),
    ]).astype(np.int64)
    return batch, agg


def concurrency_part(AK, device) -> None:
    """CC_WRITERS writers of CC_INSERTS inserts each, a compactor and two
    readers on one table: every reader query is band_ts_ge on the compiled
    tier (K1), and each result must equal the numpy sum over the inserts at
    or below a watermark between the ones read before and after it."""
    import threading

    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.schema import sample_definition
    from frostdb_tpu_torch.table import TableConfig

    t0 = time.perf_counter()
    store = ColumnStore(device=device)
    db = store.db("cc")
    table = db.table("t", TableConfig(schema=sample_definition()))
    create_tx = db.high_watermark()
    by_tx: dict = {}
    seen: list = []
    errors: list = []
    compactions = [0]
    stop = threading.Event()
    filt, aggs = E.Col("timestamp").gt_eq(CC_LIT), [E.Sum(E.Col("value")), E.Count(E.Col("value"))]

    def writer(wid):
        try:
            rng = np.random.default_rng(SEED + 100 + wid)
            for _ in range(CC_INSERTS):
                batch, agg = cc_batch(table, rng)
                by_tx[table.insert_record(batch)] = agg
                time.sleep(CC_PAUSE_S)
        except Exception as e:  # raised below on the main thread
            errors.append(f"writer {wid}: {e!r}")

    def compactor():
        # A pass a millisecond: a loop that never waits holds the GIL from
        # the writers and readers.
        try:
            while not stop.wait(0.001):
                table.active_block.index.compact_level(0)
                compactions[0] += 1
        except Exception as e:
            errors.append(f"compactor: {e!r}")

    def reader():
        try:
            engine = LocalEngine(db.table_provider())
            while db.high_watermark() == create_tx and not stop.wait(0.001):
                pass  # the empty table's answer is no test
            while not stop.is_set():
                lo = db.high_watermark()
                out = run_query(engine, "t", filt, aggs, E)
                seen.append((lo, db.high_watermark(), as_rows(out), engine.last_serving_path))
        except Exception as e:
            errors.append(f"reader: {e!r}")

    k1 = AK.LAUNCHES["fused_band_group_sum_count"]
    writers = [threading.Thread(target=writer, args=(w,)) for w in range(CC_WRITERS)]
    aux = [threading.Thread(target=f) for f in (compactor, reader, reader)]
    for t in aux + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in aux:
        t.join()
    torch_sync()
    ingest_s = time.perf_counter() - t0
    k1 = AK.LAUNCHES["fused_band_group_sum_count"] - k1
    if errors:
        raise AssertionError(f"concurrency: {errors[:3]}")
    final = db.high_watermark()
    if final != create_tx + CC_WRITERS * CC_INSERTS:
        raise AssertionError(f"concurrency: watermark {final} after {CC_WRITERS * CC_INSERTS} inserts")
    prefix = np.zeros((2, NUM_CODES), np.int64)
    at = {create_tx: {}}
    for tx in range(create_tx + 1, final + 1):
        prefix = prefix + by_tx[tx]
        at[tx] = {f"g{k}": (int(prefix[0, k]), int(prefix[1, k]))
                  for k in range(NUM_CODES) if prefix[1, k]}
    engine = LocalEngine(db.table_provider())
    seen.append((final, final, as_rows(run_query(engine, "t", filt, aggs, E)),
                 engine.last_serving_path))
    paths = {p for *_x, p in seen}
    if paths != {"compiled"}:
        raise AssertionError(f"concurrency: readers served by {paths}")
    bad = []
    for lo, hi, rows, _p in seen:
        got = {r[0][1]: tuple(v for _n, v in r[1:]) for r in rows}
        if not any(got == at[w] for w in range(lo, hi + 1)):
            bad.append((lo, hi))
    if bad:
        raise AssertionError(f"concurrency: {len(bad)} of {len(seen)} results are no prefix of "
                             f"the inserts (watermarks {bad[:3]})")
    if db.device.type == "cuda" and not k1:
        raise AssertionError("concurrency: the readers launched no K1")
    watermarks = {w for lo, hi, *_x in seen for w in (lo, hi)}
    nonempty = sum(1 for _lo, _hi, rows, _p in seen if rows)
    log(f"concurrency: {CC_WRITERS} writers x {CC_INSERTS} inserts x {CC_ROWS} rows with "
        f"{compactions[0]} L0 compactions and 2 readers in {ingest_s:.2f} s; "
        f"{len(seen)} compiled results ({nonempty} non-empty) at {len(watermarks)} "
        f"watermarks, each == numpy over "
        f"the inserts at a watermark it saw; K1 launches {k1} for the "
        f"{len(seen) - 1} reader results (the last result is the check after the writers)")


def torch_sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def tracing_part(AK, device) -> None:
    """The two traced queries on test_tracing_integration's table on the
    device: TRACE_TREES' span trees, the paths, the counters; the compiled
    query launches K1-K4."""
    from frostdb_tpu_torch.db import ColumnStore

    db = ColumnStore(device=device).db("tr")
    trace_table(db)
    before = sum(AK.LAUNCHES[k] for k in SLICE1_KERNELS)
    got, served = traced_run(db)
    launched = sum(AK.LAUNCHES[k] for k in SLICE1_KERNELS) - before
    for name, rows, path, tree, attrs in got:
        if path != name or attrs.get("path") != name or tree != TRACE_TREES[name]:
            raise AssertionError(f"tracing {name}: path {path}, tree {tree}")
        if not rows:
            raise AssertionError(f"tracing {name}: no rows")
    if got[0][1] != [(("example_type", "cpu"), ("sum(value)", 50))]:
        raise AssertionError(f"tracing: compiled rows {got[0][1]}")
    if sorted(got[1][1]) != [(("labels.label1", f"l{k}"), ("sum(value)", s))
                             for k, s in ((0, 13), (1, 14), (2, 13))]:
        raise AssertionError(f"tracing: generic rows {got[1][1]}")
    if served != {"compiled": 1, "generic": 1}:
        raise AssertionError(f"tracing: counters {served}")
    if db.device.type == "cuda" and not launched:
        raise AssertionError("tracing: the compiled query launched no kernel")
    log(f"tracing: span trees {json.dumps({n: t for n, _r, _p, t, _a in got})}, "
        f"queries_served {json.dumps(served)}, {launched} kernel launches")


def prune_shapes(E):
    """tests/test_pruning.py's shapes as global aggregates: (name, filter or
    None, aggregation, the labels l{i} the filter matches or None)."""
    label, v = E.Col("labels.label1"), E.Col("value")
    return [
        ("label_eq", label.eq("l3"), E.Sum(v), {3}),
        ("label_absent", label.eq("nope"), E.Sum(v), set()),
        ("regex", label.regex_match("l[05]$"), E.Sum(v), {0, 5}),
        ("max", None, E.Max(v), None),
        ("min", None, E.Min(v), None),
        ("sum", None, E.Sum(v), None),
    ]


def part_labels(part) -> set:
    """The label numbers i of the labels l{i} a part holds."""
    col = part.batch.column("labels.label1")
    values = np.asarray(col.dictionary.values)[np.unique(col.values)]
    return {int(s[1:]) for s in values}


def expected_pruning(parts, func, wanted):
    """(parts pruned, parts scanned) of a global aggregate over ``parts``
    in scan order (newest first), from each part's labels and values: a
    filter prunes the parts holding no label it matches; max and min skip
    a part whose range cannot beat the best so far (the push-down); sum
    skips nothing."""
    pruned = 0
    best = None
    for p in parts:
        if wanted is not None:
            pruned += not part_labels(p) & wanted
        elif func in ("max", "min"):
            v = p.batch.column("value").values
            cand = int(v.max()) if func == "max" else int(v.min())
            if best is not None and (cand <= best if func == "max" else cand >= best):
                pruned += 1
                continue
            best = cand
    return pruned, len(parts) - pruned


def pruning_part(device, rows) -> None:
    """tests/test_pruning.py's shapes on PRUNE_PARTS sorted inserts of
    ``rows`` rows, insert i holding only label l{i} and values in
    [i * 10^7, i * 10^7 + 10^6). The LSM merges inserts past its level
    sizes, so the expected counts come from the parts the table holds once
    synced (expected_pruning). Each shape's global aggregate (the generic
    DAG's pruning and push-down) prunes and scans as expected and equals
    numpy; a filtered shape also equals its run with prune_part turned off
    (an unpruned scan) and, grouped by example_type, prunes as many parts
    on the compiled tier with the same value."""
    import frostdb_tpu_torch.lsm as L
    import frostdb_tpu_torch.table as T
    from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine
    from frostdb_tpu_torch.query.physical import ExecOptions
    from frostdb_tpu_torch.schema import sample_definition
    from frostdb_tpu_torch.table import TableConfig

    t0 = time.perf_counter()
    db = ColumnStore(device=device).db("p")
    table = db.table("t", TableConfig(schema=sample_definition()))
    rng = np.random.default_rng(SEED + 5)
    d_et, d_l, d_st = (table.dictionary(f) for f in ("example_type", "labels", "stacktrace"))
    labs, vals = [], []
    ones = np.ones(rows, dtype=bool)
    for i in range(PRUNE_PARTS):
        x = i * 10**7 + rng.integers(0, 10**6, rows).astype(np.int64)
        table.insert_record(ColumnBatch([
            Column("example_type", KIND_DICT, np.full(rows, d_et.code("cpu"), np.int32), ones, d_et),
            Column("labels.label1", KIND_DICT, np.full(rows, d_l.code(f"l{i}"), np.int32), ones, d_l),
            Column("stacktrace", KIND_DICT, np.full(rows, d_st.code("s"), np.int32), ones, d_st),
            Column("timestamp", KIND_INT64, np.arange(i * rows, (i + 1) * rows, dtype=np.int64), ones),
            Column("value", KIND_INT64, x, ones),
        ], rows), sort=True)
        labs.append(np.full(rows, i))
        vals.append(x)
    table.sync()
    labs, vals = np.concatenate(labs), np.concatenate(vals)
    parts = table.collect_parts(db.high_watermark())
    m = table.metrics

    def run(filt, agg, grouped):
        """(value or None, serving tier, parts pruned, parts scanned)."""
        engine = LocalEngine(db.table_provider(), ExecOptions(compiled_serving=grouped))
        q = engine.scan_table("t")
        if filt is not None:
            q = q.filter(filt)
        p0, s0 = m.parts_pruned.value(), m.parts_scanned.value()
        groups = [E.Col("example_type")] if grouped else []
        rows_out = as_rows(run_shape(engine, lambda e: q.aggregate([agg], groups)))
        if grouped and rows_out and rows_out[0][0] != ("example_type", "cpu"):
            raise AssertionError(f"pruning: grouped rows {rows_out}")
        value = rows_out[0][-1][1] if rows_out else None
        return (value, engine.last_serving_path, m.parts_pruned.value() - p0,
                m.parts_scanned.value() - s0)

    keep = L.prune_part, T.prune_part
    report = []
    for name, filt, agg, wanted in prune_shapes(E):
        pruned, scanned = expected_pruning(parts, agg.func, wanted)
        x = vals if wanted is None else vals[np.isin(labs, list(wanted))]
        want = getattr(x, agg.func)().item() if len(x) else None
        got = run(filt, agg, False)
        if got != (want, "generic", pruned, scanned):
            raise AssertionError(f"pruning {name}: (value, tier, pruned, scanned) {got}, "
                                 f"expected {(want, 'generic', pruned, scanned)}")
        if filt is not None:
            L.prune_part = T.prune_part = lambda *a, **k: False
            try:
                unpruned = run(filt, agg, False)
            finally:
                L.prune_part, T.prune_part = keep
            if unpruned[0] != want or unpruned[2] != 0:
                raise AssertionError(f"pruning {name}: unpruned scan {unpruned}, want {want}")
            fast = run(filt, agg, True)
            if fast[:3] != (want, "compiled", pruned):
                raise AssertionError(f"pruning {name}: grouped on {fast[1]}: {fast}")
        report.append(f"{name} {pruned} pruned")
    layout = [sorted(part_labels(p)) for p in parts]
    log(f"pruning: {PRUNE_PARTS} inserts x {rows} rows in {len(parts)} parts (labels "
        f"{json.dumps(layout)}); " + ", ".join(report)
        + "; every value == numpy, filtered shapes == the unpruned scan and == the "
        f"compiled tier grouped; {time.perf_counter() - t0:.1f} s")


def nested_def():
    """tests/test_nested_schema.py's definition: a struct group of three
    dictionary leaves (one nested a level deeper) beside name, timestamp
    and value."""
    from frostdb_tpu_torch.schema import (
        ColumnDef, ENCODING_RLE_DICTIONARY, GroupDef, SchemaDef, SortingColumnDef,
        StorageLayout, TYPE_INT64, TYPE_STRING,
    )

    s = StorageLayout(TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY)
    return SchemaDef(
        name="nested",
        columns=(
            GroupDef("attributes", nodes=(
                ColumnDef("region", s), ColumnDef("zone", s),
                GroupDef("owner", nodes=(ColumnDef("team", s),)),
            ), nullable=True),
            ColumnDef("name", s),
            ColumnDef("timestamp", StorageLayout(TYPE_INT64)),
            ColumnDef("value", StorageLayout(TYPE_INT64)),
        ),
        sorting_columns=(SortingColumnDef("name", "asc"), SortingColumnDef("timestamp", "asc")),
    )


def struct_batch(rng, n, ts0):
    """An Arrow record batch with a struct column ``attributes``, and the
    region, zone and team of each row (None for null)."""
    import pyarrow as pa

    regions = np.array(["us", "eu", "ap", None], dtype=object)[rng.integers(0, 4, n)]
    zones = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
    teams = np.array(["red", "blue", None], dtype=object)[rng.integers(0, 3, n)]
    values = rng.integers(0, 1000, n).astype(np.int64)
    struct = pa.StructArray.from_arrays([
        pa.array(list(regions), type=pa.string()),
        pa.array(list(zones), type=pa.string()),
        pa.StructArray.from_arrays([pa.array(list(teams), type=pa.string())], names=["team"]),
    ], names=["region", "zone", "owner"])
    rb = pa.RecordBatch.from_arrays([
        struct, pa.array(["x"] * n, type=pa.string()),
        pa.array(np.arange(ts0, ts0 + n, dtype=np.int64)), pa.array(values),
    ], names=["attributes", "name", "timestamp", "value"])
    return rb, regions, zones, teams, values


def struct_queries(db):
    """Sum of value by attributes.region, where attributes.owner.team is
    "red", and by attributes.zone where it is: ({region: sum}, red sum,
    {zone: red sum}, the three serving tiers)."""
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine

    engine = LocalEngine(db.table_provider())
    by_region = {r[0][1]: r[1][1] for r in as_rows(run_shape(engine, lambda e: e.scan_table(
        "t").aggregate([E.Sum(E.Col("value"))], [E.Col("attributes.region")])))}
    p1 = engine.last_serving_path
    red_team = E.Col("attributes.owner.team").eq("red")
    red = as_rows(run_shape(engine, lambda e: e.scan_table("t").filter(red_team).aggregate(
        [E.Sum(E.Col("value"))], [])))
    p2 = engine.last_serving_path
    by_zone = {r[0][1]: r[1][1] for r in as_rows(run_shape(engine, lambda e: e.scan_table(
        "t").filter(red_team).aggregate([E.Sum(E.Col("value"))], [E.Col("attributes.zone")])))}
    return by_region, red[0][0][1], by_zone, (p1, p2, engine.last_serving_path)


def struct_part(AK, device) -> None:
    """Struct ingest, the two queries, block rotation, a second insert,
    close and recovery from the WAL on the device: each answer equal to
    numpy, the recovered table's equal to the closed one's."""
    import shutil
    import tempfile

    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.table import TableConfig

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="frostdb-struct-")
    try:
        rng = np.random.default_rng(SEED + 6)
        store = ColumnStore(storage_path=f"{root}/db", enable_wal=True, device=device)
        db = store.db("test")
        table = db.table("t", TableConfig(schema=nested_def()))
        cols = [], [], [], []

        def insert(ts0):
            rb, *arrays = struct_batch(rng, STRUCT_ROWS, ts0)
            table.insert_record(rb)
            for col, a in zip(cols, arrays):
                col.append(a)

        def expected():
            r, z, tm, v = (np.concatenate(x) for x in cols)
            by = {key: int(v[r == key].sum()) for key in ("us", "eu", "ap")}
            by[None] = int(v[np.equal(r, None)].sum())
            red = tm == "red"
            return by, int(v[red].sum()), {k: int(v[red & (z == k)].sum()) for k in ("a", "b", "c")}

        insert(0)
        before = sum(AK.LAUNCHES[k] for k in SLICE1_KERNELS)
        first = struct_queries(db)
        if first[:3] != expected() or first[3][2] != "compiled":
            raise AssertionError(f"struct: {first} != numpy {expected()}")
        table.rotate_block()
        insert(STRUCT_ROWS)
        second = struct_queries(db)
        if second[:3] != expected():
            raise AssertionError(f"struct after rotation: {second[:3]} != numpy {expected()}")
        launched = sum(AK.LAUNCHES[k] for k in SLICE1_KERNELS) - before
        store.close()
        store2 = ColumnStore(storage_path=f"{root}/db", enable_wal=True, device=device)
        db2 = store2.db("test")
        groups = [g.name for g in db2.get_table("t").schema().groups()]
        recovered = struct_queries(db2)
        store2.close()
        if groups != ["attributes"] or recovered != second:
            raise AssertionError(f"struct recovery: groups {groups}, {recovered} != {second}")
        if db2.device.type == "cuda" and not launched:
            raise AssertionError("struct: no kernel launched")
        log(f"struct: 2 inserts x {STRUCT_ROWS} rows, rotation and recovery; tiers "
            f"{first[3]} / {recovered[3]}; results == numpy before and after recovery; "
            f"{launched} kernel launches; {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def read_path_cost(db) -> None:
    """The five aggregate shapes' latency on ``t`` with the compiled tier's
    read path as it is (parts collected inside ``Table.view``; dictionary
    reads and writes under the dictionary's lock) and with both undone (the
    watermark read unregistered, no lock), READ_PATH_ROUNDS rounds in
    alternating order; the rows must be the same either way."""
    import contextlib

    from frostdb_tpu_torch.compiled import CompiledFilterAggregate
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine

    table = db.get_table("t")
    engine = LocalEngine(db.table_provider())
    visible_parts = CompiledFilterAggregate._visible_parts
    locks = {name: d._lock for name, d in table.dictionaries.items()}

    def unregistered(self):
        tx = self.table.db.high_watermark()
        return self.table.collect_parts(tx, include_sources=True)

    @contextlib.contextmanager
    def undone():
        CompiledFilterAggregate._visible_parts = unregistered
        for d in table.dictionaries.values():
            d._lock = contextlib.nullcontext()
        try:
            yield
        finally:
            CompiledFilterAggregate._visible_parts = visible_parts
            for name, d in table.dictionaries.items():
                d._lock = locks[name]

    walls: dict = {}
    for i in range(READ_PATH_ROUNDS):
        order = ("as is", "undone") if i % 2 == 0 else ("undone", "as is")
        for name, filt, aggs, _k in shapes(E, 100 + 37 * i):
            rows = {}
            for mode in order:
                with undone() if mode == "undone" else contextlib.nullcontext():
                    torch_sync()
                    t1 = time.perf_counter()
                    rows[mode] = as_rows(run_query(engine, "t", filt, aggs, E))
                    walls.setdefault((name, mode), []).append((time.perf_counter() - t1) * 1e3)
            if rows["as is"] != rows["undone"] or engine.last_serving_path != "compiled":
                raise AssertionError(f"read path cost {name}: rows differ or not compiled")
    report = []
    for name, *_x in shapes(E, 0):
        a, u = walls[(name, "as is")], walls[(name, "undone")]
        faster = sum(x < y for x, y in zip(a, u))
        report.append(f"{name} {statistics.median(a):.3f} / {statistics.median(u):.3f} "
                      f"({faster} of {len(a)} rounds faster as is)")
    log("read path as is / undone, median ms over alternating rounds on t: "
        + "; ".join(report))


def rest_phase(AK, db, device="cuda"):
    """Phase 9, with the launch counts set to 0 before and read after:
    tools/verify's cases at rows scales 1 and 1024, test_scan_fanout's
    shapes on t2 with the fan-out forced on and off, concurrent writers and
    a compactor under compiled readers, two traced queries, the pruning
    shapes, a struct table through rotation and recovery, and the compiled
    read path's cost on t. Returns the launch counts."""
    t0 = time.perf_counter()
    AK.reset_launches()
    verify_part(device)
    fanout_part(db)
    concurrency_part(AK, device)
    tracing_part(AK, device)
    for rows in PRUNE_ROWS:
        pruning_part(device, rows)
    struct_part(AK, device)
    read_path_cost(db)
    launches = dict(AK.LAUNCHES)
    log(f"rest phase launches: {json.dumps(launches)}")
    if device == "cuda":
        missing = [k for k in SLICE1_KERNELS[:3] if not launches[k]]
        if missing:
            raise AssertionError(f"rest phase launched no {missing}")
    log(f"rest phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The reference's differential fuzz on the card (phase 10)

# (a): the reference's 38 seeds, the directed shapes and 60 more aggregate
# seeds at its 200-1500 rows a part, each query repeated on a CPU copy.
FUZZ_EXTRA_SEEDS = 60
# (b): at 1024 x the rows (205k-1.5M a part), these seeds of each scenario,
# generic == compiled (== mesh) on the card.
FUZZ_SCALE = 1024
# At that scale aggregate seeds 1000-1003 select nothing on the compiled
# tier; 1007, 1009 and 1011 launch K2 and K3.
FUZZ_SCALED_SEEDS = {"aggregates": 12, "scan and epilogue": 2, "joins": 2, "int-key joins": 2}
FUZZ_KERNELS = ("fused_band_group_sum_count", "group_sum_count", "group_min_max",
                "fused_cmp_group_sum_count", "block_compact", "dense_segment_sum_count")
FUZZ_TIERS = ("compiled", "compiled_scan", "compiled_join", "mesh")


def nan_sign_check(device) -> None:
    """The generic DAG's float sums on ``device`` give a NaN the sign the
    reference's row-order sum gives it: [inf, -inf] -> -NaN (no NaN
    input), else the last NaN input's sign. Phase 10's first run found the
    GPU's sums all +NaN (at aggregate seed 1000, query 2)."""
    import torch

    from frostdb_tpu_torch.ops import kernels as K

    vals = np.array([np.inf, -np.inf, 1.0, np.nan, 2.0, -np.nan, np.nan, 3.0])
    keys = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], device=device)
    ones = torch.ones(8, dtype=torch.bool, device=device)
    _ng, _first, _k, _kv, (sums,), _v = K.group_aggregate(
        (keys,), (ones,), (torch.from_numpy(vals).to(device),), (ones,), ones, (K.AGG_SUM,))
    signs = np.signbit(sums[:4].cpu().numpy()).tolist()
    if signs != [True, False, True, False] or not np.isnan(sums[:4].cpu().numpy()).all():
        raise AssertionError(f"NaN float sums on {device}: {sums[:4].tolist()}, sign bits {signs}")


def fuzz_phase(AK, device="cuda"):
    """Phase 10, with the launch counts set to 0 before and read after:
    the NaN float-sum signs (nan_sign_check), then
    frostdb_tpu_torch/tools/fuzz.py, the port of the reference's
    differential fuzz, (a) at rows scale 1 against a CPU copy of every
    table and (b) at FUZZ_SCALE. Every tier of every query must give the
    generic DAG's rows (the CPU's, but for out-of-gate float sums equal to
    the GPU's pairwise tree, counted); on a GPU, K1-K4 and K6 must launch
    and compiled, compiled_scan, compiled_join and mesh each serve. Prints
    the serve counts, the launches per kernel and per template variant, and
    the card's allocated bytes at the start, after (a) and at the end.
    Returns the launch counts."""
    import torch

    from frostdb_tpu_torch.tools import fuzz as F

    on_gpu = torch.device(device).type == "cuda"

    def allocated():
        return torch.cuda.memory_allocated() if on_gpu else 0

    t0 = time.perf_counter()
    mem = [allocated()]
    nan_sign_check(device)
    AK.reset_launches()
    # The fuzz runs the cycle collector after each seed (tools/fuzz.collect):
    # the earlier phases' live objects are frozen out of its walks.
    gc.freeze()
    try:
        a = F.run(device, 1, FUZZ_EXTRA_SEEDS, against_cpu=True,
                  log=lambda s: log(f"fuzz x1 {s}"))
        mem.append(allocated())
        b = F.run(device, FUZZ_SCALE, seeds=FUZZ_SCALED_SEEDS, directed=False,
                  log=lambda s: log(f"fuzz x{FUZZ_SCALE} {s}"))
        mem.append(allocated())
    finally:
        gc.unfreeze()
    launches = dict(AK.LAUNCHES)
    served = a.served + b.served
    log(f"fuzz phase: {a.queries} queries at rows scale 1 ({a.float_sum_cases} out-of-gate "
        f"float sums differ from the CPU's, each == the pairwise tree), {b.queries} at "
        f"{FUZZ_SCALE} (largest table {b.max_rows} rows); served {json.dumps(dict(served))}")
    log(f"fuzz phase launches: {json.dumps(launches)}; by template: "
        f"{json.dumps(dict(sorted(AK.TEMPLATE_LAUNCHES.items())))}")
    if on_gpu:
        missing = [k for k in FUZZ_KERNELS if not launches[k]]
        unserved = [t for t in FUZZ_TIERS if not served[t]]
        if missing or unserved:
            raise AssertionError(f"fuzz phase launched no {missing}, no query served by {unserved}")
    log(f"fuzz phase: allocated bytes {mem[0]} at the start, {mem[1]} after rows scale 1, "
        f"{mem[2]} at the end; {time.perf_counter() - t0:.1f} s, of which "
        f"{a.collect_s + b.collect_s:.1f} s in the cycle collector between seeds")
    return launches


# ---------------------------------------------------------------------------
# Kernel bench phase (K5)


def bench_data(seed: int, n: int, dev):
    """bench.py's kernel-bench columns for one dataset, made on the device:
    a multiplicative hash of the row index gives 64 codes, values in
    [0, 1000) and timestamps in [0, 100) (bench.py ``gen``, in uint32
    arithmetic, here in int64 masked to 32 bits)."""
    import torch

    m32 = 0xFFFFFFFF
    i = (torch.arange(n, dtype=torch.int64, device=dev) + seed * 0x9E3779B9) & m32
    h = ((i * 2654435761) & m32) ^ (i >> 16)
    return (
        (h % NUM_CODES).to(torch.int32),
        ((h >> 8) % 1000).to(torch.int32),
        ((h >> 4) % 100).to(torch.int32),
    )


def bench_reference(seed: int, n: int):
    """bench.py's exact numpy check of one dataset: (sums, counts)."""
    i = np.arange(n, dtype=np.uint64).astype(np.uint32) + np.uint32(
        (seed * 0x9E3779B9) & 0xFFFFFFFF
    )
    h = (i * np.uint32(2654435761)) ^ (i >> 16)
    cc = (h % np.uint32(NUM_CODES)).astype(np.int64)
    vv = ((h >> 8) % np.uint32(1000)).astype(np.int64)
    m = (h >> 4) % np.uint32(100) >= BENCH_LITERAL
    sums = np.bincount(cc[m], weights=vv[m], minlength=NUM_CODES).astype(np.int64)
    counts = np.bincount(cc[m], minlength=NUM_CODES).astype(np.int64)
    return sums, counts


def k5_bench_phase(AK, dev):
    """bench.py's kernel bench through the port: BENCH_DATASETS datasets of
    BENCH_ROWS rows resident on the device, ``where ts >= 50 group by
    codes`` sums and counts over each through filter_group_sum_count, the
    launch counts set to 0 before and read after; dataset 7's result is
    checked exactly against numpy, as bench.py checks it. Then the sweep
    over all datasets is timed with CUDA events."""
    import torch

    datasets = [bench_data(s, BENCH_ROWS, dev) for s in range(BENCH_DATASETS)]
    torch.cuda.synchronize()
    AK.reset_launches()
    with capture_kernel_args(AK) as seen:
        outs = [
            AK.filter_group_sum_count(c, v, t, BENCH_LITERAL, NUM_CODES)
            for c, v, t in datasets
        ]
    launches = dict(AK.LAUNCHES)
    log(f"main path launches (kernel bench): {json.dumps(launches)}")
    if launches["filter_group_sum_count"] != BENCH_DATASETS:
        raise AssertionError("filter_group_sum_count was not launched once per dataset")
    ref = bench_reference(7, BENCH_ROWS)
    got = [o.cpu().numpy() for o in outs[7]]
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError("kernel bench: dataset 7 differs from numpy")

    def sweep():
        for c, v, t in datasets:
            AK.filter_group_sum_count(c, v, t, BENCH_LITERAL, NUM_CODES)

    ms = cuda_ms(sweep, reps=5, warm=1) / BENCH_DATASETS
    chained = chained_ms(sweep, reps=5, warm=1) / BENCH_DATASETS
    log(
        f"kernel bench: {BENCH_DATASETS} datasets x {BENCH_ROWS} rows, dataset 7 "
        f"== numpy exactly; {ms:.4f} ms per dataset in a sweep alone, "
        f"{chained:.4f} ms per dataset in a chain of sweeps "
        f"({BENCH_ROWS / chained * 1e3:.4g} rows/s)"
    )
    captured: dict = {}
    keep_captures(captured, "kernel bench", seen)
    return launches, captured


def package_line() -> str:
    """Whether the modules the durability (pyarrow) and plan-protocol (grpc)
    slices need import here, with their versions."""
    import importlib

    found = []
    for name in ("pyarrow", "grpc"):
        try:
            mod = importlib.import_module(name)
            found.append(f"{name} {getattr(mod, '__version__', '(no version)')} imports")
        except Exception as e:  # any failure means the slice cannot run here
            found.append(f"{name} does not import ({type(e).__name__}: {e})")
    return "packages: " + "; ".join(found)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--parts", type=int, default=32,
        help="inserts of 2^21 rows in the engine table (bench.py: 32)",
    )
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        from frostdb_tpu_torch.ops import agg_kernels as AK
    except ImportError as e:
        print(f"chip_smoke: frostdb_tpu_torch not importable: {e}", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [AK._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"{smi}; python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, nvcc: {nvcc}")
    log(package_line())
    t0 = time.perf_counter()
    libs = AK.build()
    log(f"built {', '.join(libs.values())} in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    dev = torch.device("cuda", 0)

    total = args.parts * ROWS_PER_PART
    errs = kernel_phase(AK, dev, total)
    torch.cuda.empty_cache()
    launches, captured, (db, engine, generic, data) = engine_phase(AK, args)
    for phase in (
        lambda: scan_distinct_phase(AK, db, engine, generic, data, total),
        lambda: join_phase(AK, db, engine, generic, data, total),
        lambda: dense_phase(AK, db, engine, generic, args.parts),
        lambda: mesh_phase(AK, db, engine, smi),
        lambda: k5_bench_phase(AK, dev),
    ):
        more_launches, more_captured = phase()
        for k, n in more_launches.items():
            launches[k] += n
        for (name, shape), kargs in more_captured.items():
            keep_captures(captured, shape, [(name, kargs)])
    sql_part(engine)
    for k, n in durability_phase(AK, engine, args.parts).items():
        launches[k] += n
    for k, n in rest_phase(AK, db).items():
        launches[k] += n
    for k, n in fuzz_phase(AK).items():
        launches[k] += n
    live_rows = {k: total for k in KERNELS}
    live_rows["filter_group_sum_count"] = BENCH_ROWS
    rows = main_path_kernels(AK, captured, errs, launches, live_rows)
    if {r["name"] for r in rows} != set(KERNELS):
        raise AssertionError(f"kernels line lacks {set(KERNELS) - {r['name'] for r in rows}}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
