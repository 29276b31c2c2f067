"""The span readers (harness/spans.py, metrics/*_idle_*.py) on a made-up
trace and span tree, and a traced CPU run of Merge and single in which
every span the cells' readers read occurs."""

import pytest

from cells import run_cell
from harness import runner, spans, trace as T
from harness.runner import Context, load_reader

from frostdb_tpu_torch.tracing import Span

MS = 1_000_000
READERS = ("tier.declined_idle_ms", "planes.build_idle_ms", "result.epilogue_idle_ms",
           "dense.parts_idle_ms", "device.idle_explained_share")


def s(name, a, b, *children, **attributes):
    return Span(name, int(a * MS), int(b * MS), attributes, list(children))


def made_up(device=True):
    """Two queries. The first: compiled declines in lowering and in its
    group remap, dense serves (a plane built in its part loop, the copy,
    the epilogue); the card busy 2-2.5 and 7.5-8.5 ms. The second: one
    compiled execute, busy 12-18 ms, an epilogue 18-20 ms."""
    roots = [
        s("query/execute", 0, 10,
          s("compiled/lower", 0.5, 1, declined="root is not ..."),
          s("compiled/execute", 1, 4,
            s("groups/remap", 1, 3, codes=3000, declined="group code space"),
            declined="group code space"),
          s("dense/lower", 4, 5),
          s("dense/execute", 5, 10,
            s("dense/parts", 5, 8, s("planes/build", 6, 7, kind="lut", bytes=4)),
            s("result/copy", 8, 9), s("result/epilogue", 9, 10))),
        s("query/execute", 12, 20, s("compiled/execute", 12, 20, s("result/epilogue", 18, 20))),
    ]
    t = T.Trace()
    t.annotations = [("gpubench/query/a", 0, 10 * MS), ("gpubench/query/b", 12 * MS, 20 * MS)]
    if device:
        t.device_ops = [("k", 2 * MS, int(2.5 * MS)), ("k", int(7.5 * MS), int(8.5 * MS)),
                        ("k", 12 * MS, 18 * MS)]
    return Context({}, None, [("a", None), ("b", None)], roots, t, 0.02, 0.0075, None, None)


def read(name, ctx):
    return load_reader(name)(ctx)


def test_idle_goes_to_the_innermost_span():
    sp = spans.split(made_up())
    assert (sp.queries, sp.idle_ns) == (2, int(10.5 * MS))
    own = {}
    for span, _up, ns in sp.owned:
        own[span.name] = own.get(span.name, 0) + ns
    assert own == {"query/execute": 0.5 * MS, "compiled/lower": 0.5 * MS,
                   "compiled/execute": 1.0 * MS, "groups/remap": 1.5 * MS,
                   "dense/lower": 1.0 * MS, "dense/execute": 0, "dense/parts": 1.5 * MS,
                   "planes/build": 1.0 * MS, "result/copy": 0.5 * MS,
                   "result/epilogue": 3.0 * MS}


def test_readers_on_the_made_up_trace():
    ctx = made_up()
    # Declined: compiled/lower 0.5, compiled/execute's own 1.0 and its
    # groups/remap 1.5 ms; dense/lower did not decline.
    assert read("tier.declined_idle_ms", ctx) == pytest.approx(3.0 / 2)
    assert read("planes.build_idle_ms", ctx) == pytest.approx(1.0 / 2)
    assert read("result.epilogue_idle_ms", ctx) == pytest.approx(3.0 / 2)
    assert read("dense.parts_idle_ms", ctx) == pytest.approx(1.5 / 2)
    # All but the roots' 0.5 and compiled/execute's own 1.0 of 10.5 ms.
    assert read("device.idle_explained_share", ctx) == pytest.approx(100 * 9.0 / 10.5)


def test_no_device_ops_no_values():
    ctx = made_up(device=False)
    assert [read(n, ctx) for n in READERS] == [None] * len(READERS)


def test_spans_without_the_profilers_clock_give_no_values():
    """A program whose spans carry perf_counter ``start``/``end`` (no
    ``start_ns``) reads as nothing, without raising."""

    class Old:
        name, start, end, attributes, children = "query/execute", 1.0, 2.0, {}, []

    ctx = made_up()
    ctx.spans = [Old()]
    assert [read(n, ctx) for n in READERS] == [None] * len(READERS)


NEEDED = {
    "parca_profiles.merge": ("dense/parts", "result/epilogue", "groups/remap", "result/copy"),
    "parca_profiles.single": ("planes/build", "result/epilogue", "scan/blocks", "result/copy"),
}


@pytest.mark.parametrize("workload", sorted(NEEDED))
def test_traced_cpu_run_has_every_span_the_readers_read(capsys, monkeypatch, workload):
    got = {}
    per_layer = runner.per_layer

    def keep(bench, cell, w, *a):
        got["spans"] = w.spans
        return per_layer(bench, cell, w, *a)

    monkeypatch.setattr(runner, "per_layer", keep)
    rc, res, err = run_cell(capsys, workload, trace=1)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"engine.plan_ms", "tier.serve_ms"}
    names, declined = set(), 0

    def walk(span, parent):
        nonlocal declined
        assert parent.start_ns <= span.start_ns <= span.end_ns <= parent.end_ns
        names.add(span.name)
        declined += span.name.endswith(("/lower", "/execute")) and "declined" in span.attributes
        for c in span.children:
            walk(c, span)

    for root in got["spans"]:
        for c in root.children:
            walk(c, root)
    assert set(NEEDED[workload]) <= names
    assert declined >= len(got["spans"])
