"""The cell ``parca_profiles.merge_by_label`` on the CPU at a cut size, with
the dense tier's code ceiling cut so that its shuffle route serves both
shapes as it does at 8,388,608 codes: correct, failed by the stale-read
control, and traced with the route's spans; its three readers on that
run's spans over a made-up device trace, and on a program without the
spans; and the bytes ``dense_shuffle_roofline`` counts, frozen in the mix,
against the columns the route reads."""

import pytest

import control
from cells import ROWS_PER_PROFILE, run_cell
from harness import client, datagen, runner, spec, trace as T

from frostdb_tpu_torch.parallel import mesh_exec as ME

CELL = "parca_profiles.merge_by_label"
H100 = "NVIDIA H100 80GB HBM3"
CEILING = 1024
READERS = ("dense_shuffle_roofline", "shuffle.pairs_idle_ms", "shuffle.order_idle_ms")


@pytest.fixture
def shuffle_ceiling(monkeypatch):
    monkeypatch.setattr(ME.DenseLocalAggregate, "MAX_CODES", CEILING)


def walk(span):
    yield span
    for c in span.children:
        yield from walk(c)


def made_up_device(monkeypatch, drop=()) -> dict:
    """Run ``per_layer`` on the window's real spans over a made-up trace of
    an H100 that is busy for the first microsecond of each query and idle
    after it, without the spans named in ``drop``; keeps the window."""
    got = {}
    per_layer = runner.per_layer

    def keep(bench, cell, w, mix, rows, device_info):
        def strip(span):
            span.children = [strip(c) for c in span.children if c.name not in drop]
            return span

        w.spans = [strip(r) for r in w.spans]
        assert len(w.spans) == len(w.queries)
        w.trace = T.Trace(
            device_ops=[("k", r.start_ns, r.start_ns + 1000) for r in w.spans],
            annotations=[(T.QUERY_PREFIX + shape, r.start_ns, r.end_ns)
                         for (shape, _q), r in zip(w.queries, w.spans)])
        got["w"], got["rows"] = w, rows
        return per_layer(bench, cell, w, mix, rows, {**device_info, "kind": H100})

    monkeypatch.setattr(runner, "per_layer", keep)
    return got


def test_cell_is_correct_on_the_cpu(capsys, shuffle_ceiling):
    rc, res, err = run_cell(capsys, CELL, seconds=3.0)
    assert rc == 0, err
    assert res["correct"], err
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "wrong_answers": 0, "failed_queries": 0, "shapes_unchecked": 0}
    for shape in ("merge_by_label", "merge_by_label_past"):
        assert f"served {shape}: {{'dense':" in err, err


def test_stale_read_control_fails():
    counts = control.control_counts(CELL, 2**31 + 5, rows_per_profile=ROWS_PER_PROFILE, threads=2)
    assert counts["stale_read"] > 0, counts


def test_traced_run_reads_the_shuffle_route(capsys, monkeypatch, shuffle_ceiling):
    """Every query on the shuffle route, its spans read by the cell's
    readers: the idle of each span over the made-up trace, and the frozen
    bytes over its busy microseconds."""
    got = made_up_device(monkeypatch)
    rc, res, err = run_cell(capsys, CELL, seconds=3.0, trace=1)
    assert rc == 0 and res["correct"], err
    w, rows = got["w"], got["rows"]
    idle = {"dense/pairs": 0, "shuffle/order": 0}
    for root in w.spans:
        assert root.attributes["path"] == "dense"
        spans = list(walk(root))
        assert {s.attributes["route"] for s in spans if s.name == "dense/parts"} == {"shuffle"}
        assert [s.name for s in spans].count("shuffle/order") == 1
        for s in spans:
            if s.name in idle:
                assert not s.children
                idle[s.name] += s.end_ns - s.start_ns
    n = len(w.spans)
    values = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(values)
    assert values["shuffle.pairs_idle_ms"] == pytest.approx(idle["dense/pairs"] / 1e6 / n)
    assert values["shuffle.order_idle_ms"] == pytest.approx(idle["shuffle/order"] / 1e6 / n)
    from harness.selected import SelectedRows

    count = SelectedRows(rows)
    moved = sum(16 * count(q) + 100_663_296 for _s, q in w.queries)
    assert values["dense_shuffle_roofline"] == pytest.approx(100 * moved / 3.35e12 / (n * 1e-6))


def test_readers_without_the_spans_read_nothing(capsys, monkeypatch, shuffle_ceiling):
    """A program that opens neither span (the route before them) leaves the
    two span readers out of the line; the roofline share, which reads
    device time alone, stays."""
    made_up_device(monkeypatch, drop=("dense/pairs", "shuffle/order"))
    rc, res, err = run_cell(capsys, CELL, seconds=1.0, trace=1)
    assert rc == 0 and res["correct"], err
    assert "dense_shuffle_roofline" in res["metrics"]
    assert not {"shuffle.pairs_idle_ms", "shuffle.order_idle_ms"} & set(res["metrics"])


def test_frozen_shuffle_bytes_match_the_route():
    """Per selected row the two group codes and the value at the widths the
    parts hold on the device; per query 12 B a code of the pair space (the
    Merge mix's convention at 131,072 codes) over the configuration's 64 x
    131,072 codes; no plane, over a time band."""
    from frostdb_tpu_torch.db import ColumnStore

    _b, _c, config, mix = spec.load_cell(control.HERE, CELL)
    merge = spec.load_cell(control.HERE, "parca_profiles.merge")[3]
    db = ColumnStore(device="cpu").db("t")
    rows = datagen.generate(config, 5, ROWS_PER_PROFILE)
    table = client.fill_table(db, config, rows.batches(), rows.dicts)
    table.sync()
    dev = table.collect_parts(db.high_watermark())[0].device()
    width = {c: dev.column(c).data.element_size() for c in ("labels.node", "stacktrace", "value")}
    codes = config["columns"]["labels.node"]["strings"]["count"] * config["columns"]["stacktrace"]["strings"]["count"]
    assert ME.DenseLocalAggregate.MAX_CODES < codes == 8_388_608 <= ME.SHUFFLE_MAX_CODES
    merge_out = merge["shapes"]["merge"]["roofline"]["dense_sorted_roofline"]["out_bytes"]
    for shape in mix["shapes"].values():
        e = shape["roofline"]["dense_shuffle_roofline"]
        assert e["plane_bytes_per_row"] == 0
        assert e["selected_bytes_per_row"] == sum(width.values()) == 16
        assert e["out_bytes"] == 12 * codes == merge_out * 64
