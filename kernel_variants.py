#!/usr/bin/env python3
"""Time variants of the aggregation kernels' source on one NVIDIA GPU.

    python3 kernel_variants.py [--parent DIR]

Builds ``frostdb_tpu_torch/csrc/agg.cu`` as it is ("final") and as a few
variants made by small edits of its text, each with its own nvcc (all
started together, under the ignored build/variants/), plus, with ``--parent``, the ``agg.cu`` of another
checkout (for example an earlier commit unpacked with ``git archive``).
Each variant's library takes the place of the port's in turn, so the same
wrappers launch it, on:

- the main path's own inputs: the five aggregate shapes and the two
  distinct shapes on chip_smoke.py's 32 x 2^21-row engine table, each
  kernel's arguments captured from its first launch;
- bench.py's kernel-bench data (K5), one dataset and the sweep over 8;
- uniform random codes (hashed keys) at the main path's row count.

With ``--parent``, the five aggregate shapes' query latency is also timed
with the final and the parent library, 10 rounds in alternating order.

Every variant but the load floor is checked exactly against the plain
version on every input. Times are per call in a chain of 20 calls (CUDA
events), two rounds in alternating order, min and max printed. Each
variant's shared-memory atomics are counted from its SASS (``cuobjdump``).
Prints the card's name and power limit, a line per input and a JSON line.
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
LATENCY_ROUNDS = 10
SOURCE = os.path.join(ROOT, "frostdb_tpu_torch", "csrc", "agg.cu")

LOOP = """  const long long stride = (long long)gridDim.x * kWarps * kSpan;
  for (long long q0 = ((long long)blockIdx.x * kWarps + warp) * kSpan;
       q0 < nvec; q0 += stride) {"""
CHUNK = """  const long long warps = (long long)gridDim.x * kWarps;
  const long long chunk = ((nvec + warps - 1) / warps + kSpan - 1) / kSpan * kSpan;
  const long long begin = ((long long)blockIdx.x * kWarps + warp) * chunk;
  const long long end = min(begin + chunk, nvec);
  for (long long q0 = begin; q0 < end; q0 += kSpan) {"""

# name -> edits (old text, new text) of agg.cu
VARIANTS = {
    "final": [],
    # Loads and predicate with no write-out but each lane's last: the load
    # floor (results are not checked).
    "floor": [("  if (a.live() && c != a.code) a.write();\n", "")],
    # Read-only cached loads in place of streaming ones.
    "ldg": [("__ldcs(", "__ldg(")],
    # A contiguous chunk of vectors a warp in place of the grid stride.
    "chunk": [(LOOP, CHUNK), ("m[u] = q < nvec ?", "m[u] = q < end ?")],
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "3 blocks an SM": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
}


def log(*a) -> None:
    print(*a, flush=True)


def sources(parent):
    with open(SOURCE) as f:
        final = f.read()
    out = {}
    for name, edits in VARIANTS.items():
        text = final
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name}: {old[:40]!r} not in agg.cu")
            text = text.replace(old, new)
        out[name] = text
    if parent:
        with open(os.path.join(parent, "frostdb_tpu_torch", "csrc", "agg.cu")) as f:
            out["parent"] = f.read()
    return out


def build(AK, srcs, tmp):
    nvcc = AK._nvcc()
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = os.path.join(tmp, f"agg{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"libagg{i}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *AK.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        spills = [l for l in err.splitlines() if "spill" in l and " 0 bytes spill stores" not in l]
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
            capture_output=True, text=True).stdout
        atoms = {}
        for word in sass.split():
            if word.startswith("ATOMS."):
                atoms[word] = atoms.get(word, 0) + 1
        log(f"variant {name}: built; {len(spills)} kernels spill; shared atomics in SASS {atoms}")
        libs[name] = so
    return libs


def bind(AK, so):
    """The port's library namespace with this variant's aggregation entries."""
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    ll, u = ctypes.c_longlong, ctypes.c_uint
    lib.fdb_group_sum_count.argtypes = [i, i] + [p] * 6 + [i] * 6 + [ll, i, u] + [p] * 3 + [i, p]
    lib.fdb_group_sum_count.restype = i
    lib.fdb_group_min_max.argtypes = [p] * 3 + [ll, i] + [p] * 2 + [i, p]
    lib.fdb_group_min_max.restype = i
    lib.fdb_filter_group_sum_count.argtypes = [p] * 3 + [i, ll, i, u] + [p] * 2 + [i, p]
    lib.fdb_filter_group_sum_count.restype = i
    return types.SimpleNamespace(
        fdb_group_sum_count=lib.fdb_group_sum_count,
        fdb_group_min_max=lib.fdb_group_min_max,
        fdb_filter_group_sum_count=lib.fdb_filter_group_sum_count,
        fdb_block_compact=AK._load().fdb_block_compact,
    )


def inputs(S, AK, dev):
    """{(kernel, input name): wrapper args}, and the K5 bench datasets."""
    import torch

    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query import expr as E
    from frostdb_tpu_torch.query.engine import LocalEngine

    db = ColumnStore(device="cuda").db("variants")
    S.build_table(db, "t", 32)
    engine = LocalEngine(db.table_provider())
    for _name, filt, aggs, _k in S.shapes(E, 50):
        S.run_query(engine, "t", filt, aggs, E)
    found: dict = {}
    with S.capture_kernel_args(AK) as seen:
        for name, filt, aggs, _k in S.shapes(E, 40):
            n0 = len(seen)
            S.run_query(engine, "t", filt, aggs, E)
            for kernel, args in seen[n0:]:
                found.setdefault((kernel, name), args)
        for name, make_q, _tier, _k in S.scan_shapes(E, 0):
            if name.startswith("distinct"):
                n0 = len(seen)
                S.run_shape(engine, make_q)
                for kernel, args in seen[n0:]:
                    found.setdefault((kernel, name), args)
    datasets = [S.bench_data(s, S.BENCH_ROWS, dev) for s in range(S.BENCH_DATASETS)]
    c, v, t = datasets[0]
    found[("filter_group_sum_count", "kernel bench")] = (c, v, t, S.BENCH_LITERAL, S.NUM_CODES)
    x = S.kernel_inputs(32 * S.ROWS_PER_PART, S.NUM_CODES, 1 << 14, 0.5, 7, dev)
    for kernel, args in S.kernel_calls(x, S.NUM_CODES, 2, 500).items():
        found[(kernel, "uniform")] = args
    torch.cuda.synchronize()
    return found, datasets, engine


def latency(S, AK, engine, libs):
    """{shape: {variant: [median ms]}}: the five aggregate shapes' latency
    with the "final" and "parent" libraries, the median of QUERY_REPS
    queries per round as chip_smoke.py times them (host clock, literals
    varying), over LATENCY_ROUNDS rounds alternating which runs first. Only
    the kernel library differs between the two: the engine is this
    checkout's."""
    import time

    import torch

    from frostdb_tpu_torch.query import expr as E

    names = [n for n in ("final", "parent") if n in libs]
    out: dict = {}
    for rnd in range(-1, LATENCY_ROUNDS):  # round -1 warms and is dropped
        for name in names if rnd % 2 == 0 else names[::-1]:
            AK._lib = libs[name]
            walls: dict = {}
            for i in range(S.QUERY_REPS):
                for shape, filt, aggs, _k in S.shapes(E, 100 + 37 * i):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    S.run_query(engine, "t", filt, aggs, E)
                    walls.setdefault(shape, []).append((time.perf_counter() - t) * 1e3)
            for shape, w in walls.items():
                if rnd >= 0:
                    out.setdefault(shape, {}).setdefault(name, []).append(statistics.median(w))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose agg.cu runs as the variant 'parent'")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from frostdb_tpu_torch.ops import agg_kernels as AK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)
    tmp = os.path.join(ROOT, "build", "variants")
    os.makedirs(tmp, exist_ok=True)
    libs = {name: bind(AK, so) for name, so in build(AK, sources(args.parent), tmp).items()}
    found, datasets, engine = inputs(S, AK, dev)
    order = list(libs)
    results = {}

    def run(label, fn_for, check=None):
        times = {name: [] for name in order}
        if check is not None:
            ref = check[0]()
            for name in order:
                AK._lib = libs[name]
                out = check[1]()
                torch.cuda.synchronize()
                if name != "floor" and not all(torch.equal(o, r) for o, r in zip(out, ref)):
                    raise AssertionError(f"variant {name} differs from the plain version on {label}")
        for rnd in range(2):
            for name in order if rnd == 0 else order[::-1]:
                AK._lib = libs[name]
                times[name].append(fn_for())
        results[label] = times
        log(f"{label}: " + ", ".join(f"{n} {min(t):.4f}/{max(t):.4f}" for n, t in times.items()))

    for (kernel, shape), kargs in found.items():
        wrapper = getattr(AK, kernel)
        plain = getattr(AK, kernel + "_plain")
        run(f"{kernel} @ {shape}",
            lambda: S.chained_ms(lambda: wrapper(*kargs)),
            (lambda: plain(*kargs), lambda: wrapper(*kargs)))

    def sweep():
        for c, v, t in datasets:
            AK.filter_group_sum_count(c, v, t, S.BENCH_LITERAL, S.NUM_CODES)

    run("K5 sweep per dataset",
        lambda: S.chained_ms(sweep, reps=10, warm=1) / S.BENCH_DATASETS)
    walls = latency(S, AK, engine, libs)
    for shape, by in walls.items():
        line = ", ".join(
            f"{n} median {statistics.median(w):.3f} (quartiles "
            f"{' '.join(f'{q:.3f}' for q in statistics.quantiles(w, n=4))})"
            for n, w in by.items())
        if len(by) == 2:
            wins = sum(f < p for f, p in zip(by["final"], by["parent"]))
            line += f"; final faster in {wins} of {len(by['final'])} rounds"
        log(f"latency {shape} (ms, median of {S.QUERY_REPS} queries a round): {line}")
    log(json.dumps({"device": smi, "ms": results, "latency_ms": walls}))
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
