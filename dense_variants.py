#!/usr/bin/env python3
"""Time variants of the dense segment reduction on one NVIDIA GPU, on the
inputs of gpubench's ``parca_profiles.range_wide`` queries, or the dense
table reduction on the inputs of Merge's and TSBS's.

    python3 dense_variants.py [--seed N] [--rounds N]
    python3 dense_variants.py --table [--seed N] [--rounds N]

Builds ``frostdb_tpu_torch/csrc/dense.cu`` as it is ("final") and as a few
variants made by small edits of its text (a grid stride in place of a
contiguous chunk a block, 512 threads a block, four vectors a lane a step,
and the first and the last together), each with its own nvcc (all started
together, under the ignored build/variants/), and prints each one's
registers and spills. Then builds
the cell's table as gpubench's set-up does (the seed's rows, the inserts,
``sync``), runs each of the cell's query shapes once through LocalEngine and
keeps the arguments of every ``dense_segment_sum_count`` call (one a part).
On each shape's calls, every variant's library takes the place of the
port's in turn and is checked exactly against the plain version, then
timed per query (all of the query's calls, in a chain of 20 queries
between CUDA events, ``--rounds`` rounds in alternating order, min, median
and max printed); beside them the plain version (the three ``kernels.dense_group_reduce``
calls, i.e. three ``scatter_reduce_`` calls a part, with their
temporaries) and the bound: 13 B a live row (int32 code, selection byte,
int64 value) and the three [K] int64 outputs at 3.35 TB/s. Prints the
card's name and power limit and a JSON line last.

With ``--table``: the tables of ``parca_profiles.merge`` and
``tsbs_devops.queries`` built from the seed, and the arguments of every
``dense_table_sum_count`` call (one a part) of Merge's fleet-wide shape
over the last 5, 15 and 60 minutes and of two of TSBS's
double_groupby_all windows. On each query's calls: the kernel, checked
exactly against its plain version (one ``scatter_reduce_`` for the counts,
one for the first rows and one a sum plane: the library yardstick too) and
timed with it and with ``kernels.sorted_group_reduce`` (the sorted route's
reduction, which the table route replaces) on the same rows, in a chain
of 20 queries between CUDA events, ``--rounds`` rounds in alternating
order; beside them the bound: 5 B a live row (code, selection byte), 8 B a
sum plane of each selected row and the [K] int64 outputs at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "frostdb_tpu_torch", "csrc", "dense.cu")
CELL = "parca_profiles.range_wide"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM

CHUNK = """  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < nvec ? begin + chunk : nvec;
  for (long long q0 = begin; q0 < end; q0 += kSpan) {"""
STRIDE = """  const long long end = nvec;
  for (long long q0 = (long long)blockIdx.x * kSpan; q0 < end;
       q0 += (long long)gridDim.x * kSpan) {"""

# name -> edits (old text, new text) of dense.cu
VARIANTS = {
    "final": [],
    "grid stride": [(CHUNK, STRIDE)],
    "512 threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "grid stride, unroll4": [
        (CHUNK, STRIDE), ("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
}


def log(*a) -> None:
    print(*a, flush=True)


def sources():
    with open(SOURCE) as f:
        final = f.read()
    out = {}
    for name, edits in VARIANTS.items():
        text = final
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name}: {old[:40]!r} not in dense.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(AK, srcs, tmp):
    """{variant: library path}; logs each variant's ptxas registers and
    spills."""
    nvcc = AK._nvcc()
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = os.path.join(tmp, f"dense{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"libdense{i}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *AK.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        report = [l.split("ptxas info    : ")[-1] for l in (out + err).splitlines()
                  if "registers" in l or "spill" in l]
        log(f"variant {name}: built; ptxas: " + " | ".join(report))
        libs[name] = so
    return libs


def bind(AK, so):
    """The port's library namespace with this variant's dense entry."""
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.fdb_dense_segment_sum_count
    fn.argtypes = [p] * 3 + [ll, ll, i] + [p] * 3 + [i, p]
    fn.restype = i
    return types.SimpleNamespace(**{**vars(AK._load()), "fdb_dense_segment_sum_count": fn})


def captured_calls(AK, seed, cell=CELL, kernel="dense_segment_sum_count", pick=None):
    """{shape label: [``kernel`` args, one a part]} over the cell's query
    shapes (those whose (name, params) ``pick`` takes: all by default), on
    its table built from ``seed``."""
    sys.path.insert(0, os.path.join(ROOT, "gpubench"))
    from harness import client, datagen, spec

    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query.engine import LocalEngine

    _bench, _cell, config, mix = spec.load_cell(os.path.join(ROOT, "gpubench"), cell)
    rows = datagen.generate(config, seed)
    db = ColumnStore(device="cuda").db("variants")
    table = client.fill_table(db, config, rows.batches(), rows.dicts)
    table.sync()
    parts = table.collect_parts(db.high_watermark())
    log(f"{cell} seed {seed}: {rows.n} rows, {len(parts)} parts after sync, "
        f"{[p.batch.num_rows for p in parts]} rows in them")
    engine = LocalEngine(db.table_provider())
    fn = getattr(AK, kernel)
    seen: list = []
    setattr(AK, kernel, lambda *a: seen.append(a) or fn(*a))
    found = {}
    try:
        for name in mix["cycle"]:
            shape = mix["shapes"][name]
            for params in spec.combos(shape):
                if pick is not None and not pick(name, params):
                    continue
                q = spec.bind(shape["query"], params)
                del seen[:]
                client.build(engine, config["table"], q).execute(lambda b: None)
                if engine.last_serving_path != "dense":
                    raise AssertionError(f"{name} {params}: served by {engine.last_serving_path}")
                found[f"{name} " + " ".join(f"{k}={v}" for k, v in sorted(params.items()))] = list(seen)
    finally:
        setattr(AK, kernel, fn)
    return found


# (cell, the shapes timed): Merge's fleet-wide ranges ending now; two of
# TSBS's 12-hour double_groupby_all windows.
TABLE_CELLS = (
    ("parca_profiles.merge", lambda name, params: name == "merge"),
    ("tsbs_devops.queries", lambda name, params: name == "double_groupby_all" and params["S"] in (0, 36)),
)


def table_times(AK, S, seed: int, rounds: int) -> dict:
    """The dense table reduction on each picked query's calls: exact
    against its plain version, then timed beside it and beside the sorted
    route's reduction; logs a line a query and returns the figures."""
    import torch

    from frostdb_tpu_torch.ops import kernels as K

    results = {}
    for cell, pick in TABLE_CELLS:
        for label, calls in captured_calls(AK, seed, cell, "dense_table_sum_count", pick).items():
            live = sum(int(a[3]) for a in calls)
            selected = sum(int(a[1][: int(a[3])].sum()) for a in calls)
            k, planes = calls[0][5], len(calls[0][2])
            bound_ms = ((5 * live + 8 * planes * selected) + (2 + planes) * 8 * k * len(calls)) / HBM_BYTES_PER_S * 1e3
            # the sorted route's inputs: the live rows folded into the
            # selection, the rows as stream positions
            sorted_args = []
            for codes, sel, values, n, row_base, _k in calls:
                local = torch.arange(codes.shape[0], device=codes.device)
                sorted_args.append((codes, sel & (local < n), local + row_base, values))

            def kernel(calls=calls):
                return [AK.dense_table_sum_count(*a) for a in calls]

            def plain(calls=calls):
                return [AK.dense_table_sum_count_plain(*a) for a in calls]

            def sorted_route(sorted_args=sorted_args, k=k, planes=planes):
                return [K.sorted_group_reduce(c, s, r, v, k, (K.AGG_SUM,) * planes)
                        for c, s, r, v in sorted_args]

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                        and all(torch.equal(x, y) for x, y in zip(g[2], w[2]))):
                    raise AssertionError(f"dense_table_sum_count differs from the plain version on {cell} {label}")
            times = {"kernel": [], "plain": [], "sorted route": []}
            fns = {"kernel": kernel, "plain": plain, "sorted route": sorted_route}
            for rnd in range(rounds):
                for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                    times[name].append(S.chained_ms(fns[name]))
            results[f"{cell} {label}"] = {
                "parts": len(calls), "live_rows": live, "selected_rows": selected, "K": k,
                "planes": planes, "bound_ms": bound_ms,
                "ms": {n: [min(t), statistics.median(t), max(t)] for n, t in times.items()},
            }
            log(f"{cell} {label}: {len(calls)} parts, {live} live rows, {selected} selected, K={k}, "
                f"{planes} planes; " + ", ".join(
                    f"{n} {min(t):.4f}/{statistics.median(t):.4f}/{max(t):.4f}" for n, t in times.items())
                + f" ms a query; bound {bound_ms:.4f} ms")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3000001701)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--table", action="store_true",
                    help="time the dense table reduction on Merge's and TSBS's inputs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from frostdb_tpu_torch.ops import agg_kernels as AK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    if args.table:
        AK.build()
        results = table_times(AK, S, args.seed, args.rounds)
        log(smi)
        log(json.dumps({"device": smi, "seed": args.seed, "dense_table_sum_count": results}))
        return 0
    tmp = os.path.join(ROOT, "build", "variants")
    os.makedirs(tmp, exist_ok=True)
    libs = {name: bind(AK, so) for name, so in build(AK, sources(), tmp).items()}
    found = captured_calls(AK, args.seed)
    final_lib = AK._load()
    results = {}
    for label, calls in found.items():
        live = sum(int(a[3]) for a in calls)
        selected = sum(int(a[1][: int(a[3])].sum()) for a in calls)
        k = calls[0][5]
        bound_ms = (13 * live + 3 * 8 * k * len(calls)) / HBM_BYTES_PER_S * 1e3

        def plain(calls=calls):
            return [AK.dense_segment_sum_count_plain(*a) for a in calls]

        def kernel(calls=calls):
            return [AK.dense_segment_sum_count(*a) for a in calls]

        want = plain()
        times = {name: [] for name in libs}
        for name, lib in libs.items():
            AK._lib = lib
            got = kernel()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not all(torch.equal(x, y) for x, y in zip(g, w)):
                    raise AssertionError(f"variant {name} differs from the plain version on {label}")
        for rnd in range(args.rounds):
            for name in (list(libs) if rnd == 0 else list(libs)[::-1]):
                AK._lib = libs[name]
                times[name].append(S.chained_ms(kernel))
        AK._lib = final_lib
        plain_ms = S.chained_ms(plain, reps=5, warm=1)
        results[label] = {
            "parts": len(calls), "live_rows": live, "selected_rows": selected, "K": k,
            "bound_ms": bound_ms, "plain_ms": plain_ms,
            "variants_ms": {n: [min(t), statistics.median(t), max(t)] for n, t in times.items()},
        }
        log(f"{label}: {len(calls)} parts, {live} live rows, {selected} selected, K={k}; "
            + ", ".join(f"{n} {min(t):.4f}/{statistics.median(t):.4f}/{max(t):.4f}"
                        for n, t in times.items())
            + f" ms a query; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms")
    log(smi)
    log(json.dumps({"device": smi, "seed": args.seed, "dense_segment_sum_count": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
