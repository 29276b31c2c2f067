"""The cells ``tsbs_devops.queries`` and ``parca_profiles.range_wide`` on the
CPU at a cut size: correct, failed by the stale-read control, traced with
every span their readers read; the two min/max readers on a made-up trace;
and the min/max bytes frozen in the mix against the planes the passes
read. The TSBS cell is cut to 16 hosts and 13 hours (``tsbs_cut.py``), so
that every window of the mix, 12 hours the longest, fits in the table."""

import json

import numpy as np
import pytest

import control
import tsbs_cut
from cells import run_cell
from harness import client, datagen, runner, spec, trace as T
from harness.runner import Context, load_reader
from harness.selected import SelectedRows

from frostdb_tpu_torch.tracing import Span

HOSTS, HOURS = 16, 13
TSBS = "tsbs_devops.queries"
RANGE_WIDE = "parca_profiles.range_wide"
MINMAX_SHAPES = ("single_groupby_1_1_1", "single_groupby_5_8_1", "cpu_max_all_8")


@pytest.fixture
def tsbs_cut_cell(monkeypatch):
    found = tsbs_cut.cut(HOSTS, HOURS)
    load = spec.load_cell
    monkeypatch.setattr(spec, "load_cell", lambda root, w: found if w == TSBS else load(root, w))
    return found


def keep_spans(monkeypatch) -> dict:
    got = {}
    per_layer = runner.per_layer

    def keep(bench, cell, w, *a):
        got["spans"] = w.spans
        return per_layer(bench, cell, w, *a)

    monkeypatch.setattr(runner, "per_layer", keep)
    return got


def walk(span):
    yield span
    for c in span.children:
        yield from walk(c)


@pytest.mark.parametrize("workload", [TSBS, RANGE_WIDE])
def test_cell_is_correct_on_the_cpu(capsys, tsbs_cut_cell, workload):
    # A window long enough for every shape on a loaded CPU: the windows'
    # part sets build their planes as they come.
    rc, res, err = run_cell(capsys, workload, seconds=5.0)
    assert rc == 0, err
    assert res["correct"], err
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    mix = tsbs_cut_cell[3] if workload == TSBS else spec.load_cell(control.HERE, workload)[3]
    for shape in mix["cycle"]:
        tier = mix["shapes"][shape]["tier"]
        if shape == "double_groupby_all":
            # 16 hosts x 16 hours: the compiled tier's 2,048 codes hold it
            # here; 4,000 hosts take the dense tier.
            tier = "compiled"
        assert f"served {shape}: {{'{tier}':" in err, err


@pytest.mark.parametrize("workload", [TSBS, RANGE_WIDE])
def test_stale_read_control_fails(tsbs_cut_cell, workload):
    counts = control.control_counts(workload, 2**31 + 5, rows_per_profile=None if workload == TSBS else 2,
                                    threads=2)
    assert counts["stale_read"] > 0, counts


def test_traced_tsbs_run_has_every_span_the_readers_read(capsys, monkeypatch, tsbs_cut_cell):
    got = keep_spans(monkeypatch)
    rc, res, err = run_cell(capsys, TSBS, seconds=5.0, trace=1)
    assert rc == 0 and res["correct"], err
    # No device on the CPU: minmax_roofline and minmax.idle_ms read nothing.
    assert set(res["metrics"]) == {"engine.plan_ms", "tier.serve_ms"}
    minmax = [s for r in got["spans"] for s in walk(r) if s.name == "compiled/minmax"]
    assert minmax
    mix = tsbs_cut_cell[3]
    columns = {tuple(c for _f, c in s[1]) for sh in MINMAX_SHAPES
               for s in mix["shapes"][sh]["query"] if s[0] == "aggregate"}
    assert {tuple(s.attributes["columns"]) for s in minmax} == columns
    assert {s.attributes["codes"] for s in minmax} == {64, 8}
    assert all(not s.children for s in minmax)


def test_range_wide_takes_the_dense_segment_route(capsys, monkeypatch):
    got = keep_spans(monkeypatch)
    rc, res, err = run_cell(capsys, RANGE_WIDE, trace=1)
    assert rc == 0 and res["correct"], err
    routes, codes = set(), set()
    for root in got["spans"]:
        assert root.attributes["path"] == "dense"
        for s in walk(root):
            if s.name == "dense/parts":
                routes.add(s.attributes["route"])
            if s.name == "groups/remap" and "declined" not in s.attributes:
                codes.add(s.attributes["codes"])
    # 64 nodes x 45-64 minutes, padded to 64: past the compiled tier's
    # 2,048 codes, within the segment route's 4,096.
    assert routes == {"segment"} and codes == {4096}


def test_frozen_minmax_bytes_match_the_planes_the_passes_read(monkeypatch, tsbs_cut_cell):
    """Per min/max shape, each plane its K3 passes read counted once: the
    selection, read whole (plane bytes per row); the codes and each pass's
    value plane, read where a row is selected (selected bytes per row);
    and the [K] mins and maxs each pass writes (out bytes)."""
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.ops import agg_kernels as AK
    from frostdb_tpu_torch.query.engine import LocalEngine

    _b, _c, config, mix = tsbs_cut_cell
    rows = datagen.generate(config, 5)
    db = ColumnStore(device="cpu").db("t")
    client.fill_table(db, config, rows.batches(), rows.dicts).sync()
    engine = LocalEngine(db.table_provider())
    calls = []
    fn = AK.group_min_max
    monkeypatch.setattr(AK, "group_min_max", lambda *a: calls.append(a) or fn(*a))
    for name, shape in mix["shapes"].items():
        entry = shape.get("roofline", {}).get("minmax_roofline")
        assert (entry is not None) == (name in MINMAX_SHAPES), name
        if entry is None:
            continue
        params = {**spec.combos(shape)[0], "K": 0}
        calls.clear()
        client.build(engine, config["table"], spec.bind(shape["query"], params)).execute(lambda b: None)
        assert calls, name
        codes, values, sel = ({t.data_ptr(): t.element_size() for t in ts} for ts in zip(*(a[:3] for a in calls)))
        assert len(values) == len(calls)
        assert entry["plane_bytes_per_row"] == sum(sel.values())
        assert entry["selected_bytes_per_row"] == sum(codes.values()) + sum(values.values())
        # mins and maxs, int32 [K] each, per pass
        assert entry["out_bytes"] == sum(8 * a[3] for a in calls)


def made_up_ctx(tsbs_cut_cell, kernel_ns: int, minmax_span: bool = True):
    """Two queries of the cut mix: single_groupby_1_1_1 (its K3 kernel
    busy ``kernel_ns``, inside a 1 ms ``compiled/minmax`` span, the card
    idle in 0.4 ms of it) and high_cpu_1 (no min/max)."""
    _b, _c, config, mix = tsbs_cut_cell
    rows = datagen.generate(config, 5)
    ms = 1_000_000
    q1 = spec.bind(mix["shapes"]["single_groupby_1_1_1"]["query"], {"S": 0, "K": 0})
    q2 = spec.bind(mix["shapes"]["high_cpu_1"]["query"], {"S": 0, "K": 0})
    inner = [Span("compiled/minmax", 2 * ms, 3 * ms, {"columns": ["usage_user"], "codes": 64})]
    roots = [
        Span("query/execute", 0, 10 * ms, {}, [Span("compiled/execute", 1 * ms, 9 * ms, {},
                                                    inner if minmax_span else [])]),
        Span("query/execute", 11 * ms, 20 * ms, {}, []),
    ]
    tr = T.Trace(
        device_ops=[("void group_kernel<(anonymous namespace)::MinMax, 1, 1, 4>(...)", 2 * ms + 400_000,
                     2 * ms + 400_000 + kernel_ns),
                    ("void group_kernel<SumCount<true, false>, 1, 1, 4>(...)", 1 * ms, 2 * ms),
                    ("elementwise", 3 * ms, 9 * ms), ("elementwise", 11 * ms, 20 * ms)],
        annotations=[(T.QUERY_PREFIX + "single_groupby_1_1_1", 0, 10 * ms),
                     (T.QUERY_PREFIX + "high_cpu_1", 11 * ms, 20 * ms)],
    )
    return Context(mix, rows, [("single_groupby_1_1_1", q1), ("high_cpu_1", q2)], roots, tr,
                   20e-3, 0.0, json.load(open(f"{control.HERE}/harness/peaks.json"))["NVIDIA H100 80GB HBM3"],
                   SelectedRows(rows))


def test_minmax_readers_on_a_made_up_trace(tsbs_cut_cell):
    ctx = made_up_ctx(tsbs_cut_cell, 600_000)
    # The 1 h window holds 360 rounds of 16 hosts: 5,760 rows of 4 bytes
    # of selection; one host's 360 rows selected, a code and a value each;
    # 512 out bytes; over the K3 kernel's 0.6 ms at 3.35 TB/s.
    want = 100.0 * (4 * 5760 + 8 * 360 + 512) / 3.35e12 / 600e-6
    assert load_reader("minmax_roofline")(ctx) == pytest.approx(want)
    # 0.4 ms idle inside the span, over two queries.
    assert load_reader("minmax.idle_ms")(ctx) == pytest.approx(0.4 / 2)


def test_minmax_readers_without_the_span_read_nothing(tsbs_cut_cell):
    ctx = made_up_ctx(tsbs_cut_cell, 600_000, minmax_span=False)
    assert load_reader("minmax_roofline")(ctx) is None
    assert load_reader("minmax.idle_ms")(ctx) == 0.0
    ctx.trace.device_ops = []
    assert load_reader("minmax.idle_ms")(ctx) is None


def test_minmax_roofline_counts_the_window_and_the_selected_rows(tsbs_cut_cell):
    """The reader's row counts against the rows themselves, for queries
    of every min/max shape."""
    import importlib.util

    _b, _c, config, mix = tsbs_cut_cell
    rows = datagen.generate(config, 5)
    s = importlib.util.spec_from_file_location("minmax_roofline", f"{control.HERE}/metrics/minmax_roofline.py")
    reader = importlib.util.module_from_spec(s)
    s.loader.exec_module(reader)
    counts = reader._Counts(rows)
    stream = spec.Stream(mix, 9)
    ts, host = rows.columns["timestamp"], rows.columns["labels.hostname"]
    for _ in range(3 * len(mix["cycle"])):
        name, p, q = stream.next()
        if name not in MINMAX_SHAPES:
            continue
        step = 900_000 if name.startswith("single") else 3_600_000
        hours = 1 if name.startswith("single") else 8
        lo = config["layout"]["start_ms"] + p["S"] * step
        window = (ts >= lo) & (ts < lo + hours * 3_600_000)
        hosts = [(p["K"] + i * HOSTS // 8) % HOSTS for i in range(1 if name.endswith("1_1_1") else 8)]
        selected = window & np.isin(host, hosts)
        assert counts(q) == (int(window.sum()), int(selected.sum())), (name, p)
