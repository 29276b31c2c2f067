"""The reference against the program's answers on the CPU at a cut size,
through a whole run of each cell; and the roofline bytes frozen in the
mixes against the planes the program reads at this size."""

import os

import numpy as np
import pytest
import torch

from cells import CELLS, ROWS_PER_PROFILE, run_cell
from harness import client, datagen, spec

GPUBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_cpu(capsys, workload):
    rc, res, err = run_cell(capsys, workload)
    assert rc == 0, err
    assert res["correct"], err
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}
    assert "served" in err and "(limit 0)" in err.strip().splitlines()[-1]


def test_traced_run_reads_the_program_spans(capsys):
    rc, res, err = run_cell(capsys, "parca_profiles.dashboard", trace=1)
    assert rc == 0 and res["correct"], err
    # No device on the CPU: the device readers find nothing and stay out.
    assert set(res["metrics"]) == {"engine.plan_ms", "tier.serve_ms"}
    assert res["metrics"]["engine.plan_ms"]["value"] > 0


def fill(workload):
    from frostdb_tpu_torch.db import ColumnStore
    from frostdb_tpu_torch.query.engine import LocalEngine

    config, mix = cell(workload)
    db = ColumnStore(device="cpu").db("t")
    rows = datagen.generate(config, 5, ROWS_PER_PROFILE)
    table = client.fill_table(db, config, rows.batches(), rows.dicts)
    table.sync()
    return config, mix, db, table, LocalEngine(db.table_provider())


def cell(workload):
    return spec.load_cell(GPUBENCH, workload)[2:]


KERNELS = ("fused_band_group_sum_count", "fused_cmp_group_sum_count", "group_sum_count",
           "group_min_max", "block_compact")


@pytest.mark.parametrize("workload", ["parca_profiles.dashboard", "parca_profiles.single"])
def test_frozen_kernel_bytes_match_the_planes_read(monkeypatch, workload):
    """Per shape: plane bytes per row = the distinct predicate or selection
    planes its kernels read in full; selected bytes per row = a code, and a
    value where a kernel reads values (a position, for block_compact)."""
    from frostdb_tpu_torch.ops import agg_kernels as AK

    config, mix, _db, _table, engine = fill(workload)
    calls = []
    for name in KERNELS:
        fn = getattr(AK, name)
        monkeypatch.setattr(AK, name, lambda *a, _n=name, _f=fn: calls.append((_n, a)) or _f(*a))
    for shape_name, shape in mix["shapes"].items():
        entry = next(iter(shape.get("roofline", {}).values()), None)
        if entry is None:
            continue
        params = spec.combos(shape)[0]
        params.update({p: spec.param_values(v)[0] for p, v in shape.get("free", {}).items()})
        calls.clear()
        client.build(engine, config["table"], spec.bind(shape["query"], params)).execute(lambda b: None)
        planes, reads_values = {}, False
        for name, a in calls:
            if name == "block_compact":
                # A retry at a larger capacity reads the selection again:
                # counted once.
                planes.setdefault("selection", a[0].element_size())
                continue
            reads_values |= a[1] is not None
            rest = [x for x in a[2:] if isinstance(x, torch.Tensor)]
            rest += [x for t in a[2:] if isinstance(t, tuple) for x in t if isinstance(x, torch.Tensor)]
            for t in rest:
                planes[t.data_ptr()] = t.element_size()
        assert calls, shape_name
        # A shape over a time band counts no plane: a part inside the band
        # needs none, and a store in time order finds the band's rows
        # without one. Every other shape counts the planes read in full.
        banded = any(k in shape.get("params", {}) for k in ("E", "N"))
        read = 0 if banded else sum(planes.values())
        assert entry["plane_bytes_per_row"] == pytest.approx(read, abs=1e-3), shape_name
        want = 4 if calls[0][0] == "block_compact" else 4 + 4 * reads_values
        assert entry["selected_bytes_per_row"] == want, shape_name


def test_frozen_dense_bytes_match_the_part_columns():
    """The Merge shapes read stacktrace and value of each selected row, at
    the widths the parts hold on the device."""
    _config, mix, db, table, _engine = fill("parca_profiles.merge")
    part = table.collect_parts(db.high_watermark())[0]
    dev = part.device()
    width = {c: dev.column(c).data.element_size() for c in
             ("timestamp", "example_type", "labels.node", "stacktrace", "value")}
    e = {n: s["roofline"]["dense_sorted_roofline"] for n, s in mix["shapes"].items()}
    for v in e.values():
        # Over a time band: no plane is counted (see above).
        assert v["plane_bytes_per_row"] == 0
        assert v["selected_bytes_per_row"] == width["stacktrace"] + width["value"]


def test_selected_rows_count_the_filter():
    from harness.selected import SelectedRows

    config, mix = cell("parca_profiles.merge")
    rows = datagen.generate(config, 11, 3)
    count = SelectedRows(rows)
    s = spec.Stream(mix, 11)
    start = config["layout"]["start_ms"]
    for _ in range(12):
        _n, p, q = s.next()
        ts, node = rows.columns["timestamp"], rows.columns["labels.node"]
        m = (ts >= max(p["E"] - p["R"], start)) & (ts < p["E"])
        if "K" in p:
            m &= node == p["K"]
        assert 0 < count(q) == int(np.count_nonzero(m))
