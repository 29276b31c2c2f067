#!/usr/bin/env python3
"""Smoke run of frostdb_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--parts N]

Builds the CUDA kernels from frostdb_tpu_torch/csrc/ and holds each kernel
against its plain PyTorch version on the card (edge cases, exactly). Then
serves the engine's hot query shapes through LocalEngine on a 32 x 2^21-row
table (the shape of bench.py's engine_bench; --parts cuts the 32), checks
every result against a numpy reference and against the port's generic
operator DAG, checks float sums on both paths, times the queries and
profiles one of each. Last, each kernel is checked and timed on the inputs
the main path gave it, beside its plain version and a one-call PyTorch
yardstick. Prints a ``kernels`` JSON line and, last, an ``ok`` JSON line.
Exits non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
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

# name -> (Pallas entry it replaces, int ops per row)
KERNELS = {
    "fused_band_group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:264", 6),
    "group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:156", 5),
    "group_min_max": ("frostdb_tpu/ops/pallas_agg.py:435", 5),
    "fused_cmp_group_sum_count": ("frostdb_tpu/ops/pallas_agg.py:319", 6),
}

# Position of num_codes among each wrapper's arguments.
NUM_CODES_ARG = {
    "fused_band_group_sum_count": 4,
    "group_sum_count": 3,
    "group_min_max": 3,
    "fused_cmp_group_sum_count": 5,
}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
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


def max_abs_err(out, ref) -> int:
    import torch

    err = 0
    for o, r in zip(out, ref):
        torch.cuda.synchronize()
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        d = (o.to(torch.int64) - r.to(torch.int64)).abs().max()
        err = max(err, int(d.item()) if o.numel() else 0)
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


def kernel_phase(AK, dev, main_rows):
    import torch

    errs = {k: 0 for k in KERNELS}
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
    log(f"kernel edge cases: {len(cases)} input sets x {len(KERNELS)} kernels exact")

    # Uniform random codes at the main path's row count (the main path's
    # own inputs are timed by main_path_kernels).
    for name, args in kernel_calls(x, NUM_CODES, 2, 500).items():
        wrapper = getattr(AK, name)
        log(
            f"kernel {name}: {cuda_ms(lambda: wrapper(*args)):.4f} ms on "
            f"uniform random codes, {main_rows} rows, K={NUM_CODES}, "
            f"{int(_selection(name, args).sum())} rows selected"
        )
    return errs


def _selection(name, args):
    """The rows a kernel's predicate selects (bool), computed with torch."""
    import torch

    cmp = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
           "==": torch.eq, "!=": torch.ne}
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
    """Record the first arguments each kernel wrapper gets while the block
    runs; the wrappers are restored after it."""
    seen: dict = {}
    saved = {name: getattr(AK, name) for name in KERNELS}

    def recorder(name, fn):
        def call(*args):
            seen.setdefault(name, args)
            return fn(*args)

        return call

    for name, fn in saved.items():
        setattr(AK, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(AK, name, fn)


def main_path_kernels(AK, captured, errs, launches, live_rows):
    """Each kernel against its plain version on the inputs the main path
    gave it, timed beside the plain version and a one-call yardstick. The
    bound (``bound_ms``) counts the predicate planes in full, padding
    included, and the code and value of each selected row (the kernel reads
    no other), plus the outputs; ``bound_live_ms`` counts the planes over
    the table's ``live_rows`` only, the bound once parts are not padded."""
    import torch

    rows = []
    for name, (shape, args) in captured.items():
        wrapper = getattr(AK, name)
        plain = getattr(AK, name + "_plain")
        out = wrapper(*args)
        torch.cuda.synchronize()
        e = max_abs_err(out, plain(*args))
        if e:
            raise AssertionError(f"{name} on the main path's inputs: max abs err {e}")
        codes, values = args[0], args[1]
        live = _selection(name, args)
        n, n_sel = codes.numel(), int(live.sum())
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
            masked = torch.where(live, values.long(), 0)

            def library():
                torch.zeros(k, dtype=torch.int64, device=codes.device).index_add_(0, codes64, masked)

        pred_bytes = sum(t.numel() * t.element_size() for t in _tensors(args[2:]))
        sel_bytes = n_sel * (codes.element_size() + values.element_size())
        out_bytes = sum(o.numel() * o.element_size() for o in out)
        bytes_ms = (pred_bytes + sel_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = n * KERNELS[name][1] / INT32_OPS_PER_S * 1e3
        live_bytes = pred_bytes * live_rows / n + sel_bytes + out_bytes
        live_ms = max(
            live_bytes / HBM_BYTES_PER_S * 1e3,
            live_rows * KERNELS[name][1] / INT32_OPS_PER_S * 1e3,
        )
        ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        lib_ms = cuda_ms(library)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "frostdb_tpu_torch/csrc/agg.cu",
            "replaces": KERNELS[name][0],
            "launches": launches[name],
            "max_abs_err": max(errs[name], e),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_live_ms": live_ms,
            "library_ms": lib_ms,
        })
        log(
            f"kernel {name} on {shape}'s inputs: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms on "
            f"{n} padded rows, {live_ms:.4f} ms on {live_rows} live rows) "
            f"with {n_sel} selected, K={k}"
        )
    return rows


def _tensors(args):
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, tuple):
            yield from (t for t in a if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Engine phase


def build_table(db, name, n_parts, floats=None, seed=SEED):
    """bench.py engine_bench's table: n_parts records of ROWS_PER_PART rows,
    64 label codes, int64 timestamp and value in [0, 1000). With
    ``floats(rng, n)`` the table also holds the float64 ``floatvalue``
    column of ``sample_definition_with_float``, filled from it."""
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
        d_st.encode(["stack"])
        ts = rng.integers(0, 1000, n).astype(np.int64)
        val = rng.integers(0, 1000, n).astype(np.int64)
        ones = np.ones(n, bool)
        cols = [
            Column("example_type", KIND_DICT, np.zeros(n, np.int32), ones, d_et),
            Column("labels.label1", KIND_DICT, codes, ones, d_l),
            Column("stacktrace", KIND_DICT, np.zeros(n, np.int32), ones, d_st),
            Column("timestamp", KIND_INT64, ts, ones),
            Column("value", KIND_INT64, val, ones),
        ]
        if floats is not None:
            fv = floats(rng, n)
            cols.append(Column("floatvalue", KIND_FLOAT64, fv, ones))
            val = fv
        table.insert_record(ColumnBatch(cols, n))
        data.append((codes, ts, val))
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
    # Each kernel's first inputs are kept for main_path_kernels.
    AK.reset_launches()
    results = []
    first_shape: dict = {}
    with capture_kernel_args(AK) as seen:
        for name, filt, aggs, kernels in shapes(E, 40):
            before = dict(AK.LAUNCHES)
            out = run_query(engine, "t", filt, aggs, E)
            moved = {k for k in AK.LAUNCHES if AK.LAUNCHES[k] > before[k]}
            if engine.last_serving_path != "compiled":
                raise AssertionError(f"{name}: served by {engine.last_serving_path}: {engine.last_fallback_reasons}")
            if moved != kernels:
                raise AssertionError(f"{name}: launched {moved}, expected {kernels}")
            for k in moved:
                first_shape.setdefault(k, name)
            results.append((name, out))
    launches = dict(AK.LAUNCHES)
    captured = {k: (first_shape[k], seen[k]) for k in KERNELS if k in seen}
    log(f"main path launches: {json.dumps(launches)}")
    for k, n in launches.items():
        if n == 0:
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
    device_breakdown(engine, E, walls)
    return launches, captured


def pairwise_sum(v) -> float:
    """The generic DAG's float sum on the GPU for one group
    (kernels.ordered_segment_sum): a binary tree over the group's values in
    stream order, rooted at the first, then + 0.0."""
    v = np.array(v, dtype=np.float64)
    s = 1
    while s < len(v):
        v[0:len(v) - s:2 * s] += v[s::2 * s]
        s *= 2
    return float((v[0] if len(v) else 0.0) + 0.0)


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


def device_breakdown(engine, E, walls) -> None:
    """Per shape, one query under torch.profiler: the device's busy time
    (kernels and copies), its share of the median wall time, and the
    largest device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, filt, aggs, _k in shapes(E, 90):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_query(engine, "t", filt, aggs, E)
            torch.cuda.synchronize()
        ops = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        if not ops:
            log(f"engine {name}: device time not measured (the profiler saw no device events)")
            continue
        busy = sum(e.self_device_time_total for e in ops) / 1e3
        wall = statistics.median(walls[name])
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:4]
        log(
            f"engine {name}: device busy {busy:.3f} ms of a {wall:.3f} ms median "
            f"query (idle share {1 - busy / wall:.3f}); largest: "
            + "; ".join(
                f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                for e in top
            )
        )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--parts", type=int, default=32,
        help="inserts of 2^21 rows in the engine table (bench.py: 32)",
    )
    args = ap.parse_args()
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
    t0 = time.perf_counter()
    so = AK.build()
    log(f"built {so} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)

    errs = kernel_phase(AK, dev, args.parts * ROWS_PER_PART)
    torch.cuda.empty_cache()
    launches, captured = engine_phase(AK, args)
    rows = main_path_kernels(AK, captured, errs, launches, args.parts * ROWS_PER_PART)
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
