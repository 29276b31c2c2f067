"""One run of one cell: set-up, the measured window, the comparison with the
reference, the result line. ``run.py`` is the command; tests call ``main``
with ``device="cpu"`` and a cut size."""

from __future__ import annotations

import argparse
import ctypes
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from harness import datagen, judge, spec
from harness import trace as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "frostdb_tpu")
REFERENCE_THREADS = min(8, os.cpu_count() or 1)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def out(*a) -> None:
    print(*a, flush=True)


@dataclass
class Context:
    """What a per-layer reader reads (metrics/<name>.py ``read(ctx)``)."""

    mix: dict
    rows: datagen.Rows
    window_queries: list  # (shape, bound query), in order
    spans: list  # the program's root spans (tracing.Span)
    trace: T.Trace
    window_s: float
    busy_s: float
    peaks: dict | None  # harness/peaks.json's entry for this card
    selected: object  # callable(query) -> rows the filter selects


class Reservoir:
    """Per shape, a sample of the window's answers drawn from the seed (a
    reservoir of ``k``), and the shape's slowest answer."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 2])
        self.seen: dict = {}
        self.kept: dict = {}
        self.slowest: dict = {}

    def offer(self, shape, item, took) -> None:
        n = self.seen.get(shape, 0)
        self.seen[shape] = n + 1
        kept = self.kept.setdefault(shape, [])
        if len(kept) < self.k:
            kept.append(item)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.k:
                kept[j] = item
        if took > self.slowest.get(shape, (-1.0, None))[0]:
            self.slowest[shape] = (took, item)

    def items(self):
        for shape, kept in self.kept.items():
            slow = self.slowest[shape][1]
            yield from ((shape, it) for it in kept)
            if all(slow is not it for it in kept):
                yield shape, slow


def load_reader(name: str):
    path = os.path.join(ROOT, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("gpubench_metric_" + name.replace(".", "_"), path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m.read


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def card_line(torch) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi not read: {e}"
    return f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}"


def host_line() -> str:
    """The CPUs the calling thread may use, the one it runs on, each CPU's
    clock and the load: where a run's host time went."""
    def read(path):
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return ""

    try:
        cpu = ctypes.CDLL(None).sched_getcpu()
    except (OSError, AttributeError):
        cpu = "?"
    mhz = [round(float(l.split(":")[1])) for l in read("/proc/cpuinfo").splitlines()
           if l.startswith("cpu MHz")]
    load = read("/proc/loadavg").split()[:3]
    return (f"cpus {sorted(os.sched_getaffinity(0))}, on cpu {cpu}, MHz {mhz}, load {load}, "
            f"PYTHONHASHSEED {os.environ.get('PYTHONHASHSEED')}")


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclass
class Window:
    """What the measured window left: every query in order, its latency,
    the sample to check and, in a traced run, the spans and the trace."""

    queries: list  # (shape, bound query)
    latencies: list
    errors: list
    reservoir: Reservoir
    seconds: float
    spans: list
    trace: T.Trace


def set_up(args, config, mix, device, rows_per_profile, t_start, torch, AK):
    """Kernels, rows, table, warm-up: (rows, store, engine, setup_s)."""
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query.engine import LocalEngine

    from harness import client

    on_card = device == "cuda"
    setup = {"start_to_setup_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    log("host at set-up: " + host_line())
    if on_card:
        log(card_line(torch))
        AK.build()
    setup["kernel_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    rows = datagen.generate(config, args.seed, rows_per_profile)
    setup["generate_s"] = time.perf_counter() - t

    t = time.perf_counter()
    store = ColumnStore(device=device)
    db = store.db("gpubench")
    table = client.fill_table(db, config, rows.batches(), rows.dicts)
    setup["insert_s"] = time.perf_counter() - t
    t = time.perf_counter()
    table.sync()
    setup["sync_s"] = time.perf_counter() - t
    parts = table.collect_parts(db.high_watermark())
    log(f"table {config['table']}: {rows.n} rows in {rows.inserts} inserts, "
        f"{len(parts)} parts after sync, {sum(p.batch.num_rows for p in parts)} rows in them")

    t = time.perf_counter()
    engine = LocalEngine(db.table_provider())
    tier_of: dict = {}
    launches_of: dict = {}
    for shape, _params, q in spec.warmup_queries(mix, args.seed):
        AK.reset_launches()
        client.build(engine, config["table"], q).execute(lambda b: None)
        tier_of.setdefault(shape, set()).add(engine.last_serving_path)
        launches_of.setdefault(shape, []).append({k: v for k, v in AK.LAUNCHES.items() if v})
    if on_card:
        torch.cuda.synchronize()
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("set-up: " + json.dumps({k: round(v, 3) for k, v in setup.items()}) + f"; setup_s {setup_s:.3f}")
    if on_card:
        log(f"device bytes allocated after warm-up (the table's parts and planes): "
            f"{torch.cuda.memory_allocated()}")
    for shape in mix["cycle"]:
        want = mix["shapes"][shape]
        log(f"warm-up {shape}: served by {sorted(tier_of[shape])} (expected {want['tier']}); "
            f"launches per query {launches_of[shape]} (expected kernels {want['kernels']})")
    return rows, store, engine, setup_s


def run_window(args, config, mix, engine, on_card, torch, AK) -> Window:
    """One client, closed loop, for ``args.seconds``; under the profiler
    and the program's tracer with ``--trace 1``."""
    from frostdb_tpu_torch.tracing import Tracer

    from harness import client

    stream = spec.Stream(mix, args.seed)
    w = Window([], [], [], Reservoir(mix["checked_per_shape"], args.seed), 0.0, [], T.Trace())
    served: dict = {}
    tracer = prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        tracer = Tracer()
        engine.exec_options.tracer = tracer
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        prof.__enter__()
    # The client's thread stays on one CPU of the GPU's node for the window.
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(allowed)})
    log("host at the window's start: " + host_line())
    AK.reset_launches()
    t_begin = time.perf_counter()
    deadline = t_begin + args.seconds
    t1 = t_begin
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        shape, params, q = stream.next()
        sink = []
        with torch.profiler.record_function(T.QUERY_PREFIX + shape):
            try:
                client.build(engine, config["table"], q).execute(sink.append)
            except Exception as e:  # a failed query is counted, and the run goes on
                w.errors.append(f"{shape} {params}: {type(e).__name__}: {e}")
                sink = None
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        w.queries.append((shape, q))
        key = (shape, engine.last_serving_path)
        served[key] = served.get(key, 0) + 1
        w.reservoir.offer(shape, (params, q, sink), t1 - t0)
    w.seconds = t1 - t_begin
    log("host at the window's end: " + host_line())
    os.sched_setaffinity(0, allowed)
    launches = {k: v for k, v in AK.LAUNCHES.items() if v}
    if prof is not None:
        prof.__exit__(None, None, None)
        if on_card:
            w.trace = T.from_profile(prof)
        w.spans = list(tracer.roots)
    if on_card:
        log("at the window's end: " + card_line(torch))
    log(f"window: {len(w.latencies)} queries in {w.seconds:.3f} s, {len(w.errors)} failed")
    for shape in mix["cycle"]:
        tiers = {p: n for (s, p), n in served.items() if s == shape}
        log(f"served {shape}: {tiers} (expected {mix['shapes'][shape]['tier']})")
    log(f"kernel launches in the window: {json.dumps(launches)} over {len(w.latencies)} queries")
    for e in w.errors[:5]:
        log("failed: " + e)
    return w


def compare(w: Window, mix, rows) -> dict:
    """The window's sample against the reference: the numbers compared,
    each with its limit. Numpy releases the interpreter lock, so the
    reference answers on a few threads."""
    from harness import client
    from reference import numpy_ref

    t = time.perf_counter()
    sample = [(shape, item) for shape, item in w.reservoir.items() if item[2] is not None]
    with ThreadPoolExecutor(REFERENCE_THREADS) as ex:
        refs = list(ex.map(lambda s: numpy_ref.answer(s[1][1], rows), sample))
    wrong, checked, shown = 0, {}, 0
    for (shape, (params, q, sink)), ref in zip(sample, refs):
        why = judge.mismatch(ref, client.normalize(q, sink, rows.dicts))
        checked[shape] = checked.get(shape, 0) + 1
        if why is not None:
            wrong += 1
            if shown < 5:
                log(f"wrong answer: {shape} {params}: {why}")
                shown += 1
    log(f"checked {sum(checked.values())} answers against the reference in "
        f"{time.perf_counter() - t:.3f} s: {checked}")
    return {
        "wrong_answers": {"value": wrong, "limit": 0},
        "failed_queries": {"value": len(w.errors), "limit": 0},
        "shapes_unchecked": {"value": sum(1 for s in mix["cycle"] if not checked.get(s)), "limit": 0},
    }


def end_to_end(w: Window, setup_s: float) -> dict:
    lat = np.asarray(w.latencies)
    p95 = float(np.percentile(lat, 95))
    log(f"latency ms: median {1e3 * float(np.median(lat)):.4f}, p95 {1e3 * p95:.4f}, "
        f"max {1e3 * float(lat.max()):.4f}; {int((lat > p95).sum())} beyond p95")
    shapes = np.array([s for s, _q in w.queries])
    for s in dict.fromkeys(shapes.tolist()):
        x = lat[shapes == s]
        log(f"latency ms of {s}: median {1e3 * float(np.median(x)):.4f}, "
            f"p95 {1e3 * float(np.percentile(x, 95)):.4f}, {int((x > p95).sum())} beyond the run's p95")
    return {
        "queries_per_s": (len(w.latencies) - len(w.errors)) / w.seconds,
        "query_p95_ms": 1e3 * p95,
        "setup_s": setup_s,
    }


def per_layer(bench, cell, w: Window, mix, rows, device_info) -> tuple:
    """({metric: value} of every reader that found something, breakdown),
    and the traced window's busy and wall seconds into ``device_info``."""
    from harness.selected import SelectedRows

    t = time.perf_counter()
    lo, hi = w.trace.window()
    busy_s = T.busy_ns(w.trace.device_ops, lo, hi) / 1e9
    traced_s = (hi - lo) / 1e9
    with open(os.path.join(ROOT, "harness", "peaks.json")) as f:
        peaks = json.load(f)
    ctx = Context(mix, rows, w.queries, w.spans, w.trace, traced_s, busy_s,
                  peaks.get(device_info["kind"]), SelectedRows(rows))
    values = {}
    for m in bench["per_layer"]:
        if applies(m, cell["name"]):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
    device_info["busy_s"] = busy_s
    device_info["window_s"] = traced_s
    breakdown = None
    if w.trace.device_ops:
        breakdown = {"device_ops": T.device_ops_top(w.trace), "idle_gaps": T.idle_gaps_top(w.trace)}
        log(f"trace: {len(w.trace.device_ops)} device ops, {len(w.trace.annotations)} host ranges, "
            f"read in {time.perf_counter() - t:.3f} s")
    return values, breakdown


def main(argv, t_start: float, device: str = "cuda", rows_per_profile: int | None = None) -> int:
    args = parse(argv)
    found = spec.load_cell(ROOT, args.workload)
    if found is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    bench, cell, config, mix = found
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        log(f"{cell['traffic']}: this harness runs one client in a closed loop")
        return 2

    import torch

    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell['name']} needs {cell['chips']} CUDA device(s); {n} visible. No result.")
        return 3

    from frostdb_tpu_torch.ops import agg_kernels as AK

    rows, store, engine, setup_s = set_up(args, config, mix, device, rows_per_profile, t_start, torch, AK)
    w = run_window(args, config, mix, engine, on_card, torch, AK)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(f"device memory peak {memory_peak} bytes of {torch.cuda.get_device_properties(0).total_memory}")
    del engine, store
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks = compare(w, mix, rows)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": memory_peak}
    breakdown = None
    if args.trace:
        values, breakdown = per_layer(bench, cell, w, mix, rows, device_info)
        listed = bench["per_layer"]
    else:
        values = end_to_end(w, setup_s)
        listed = [m for m in bench["end_to_end"] if applies(m, cell["name"])]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in listed if m["name"] in values}

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"modules that must not load in this process: {found}. No result.")
        return 4
    log(f"run: {time.perf_counter() - t_start:.3f} s from process start")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(w.latencies), "failed": len(w.errors),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    out(json.dumps(result))
    return 0
