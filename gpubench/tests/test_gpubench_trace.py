"""The trace readers on a made-up trace: busy time as a union, idle gaps
labelled by the innermost host range, and a roofline share."""

import pytest

from harness import roofline, trace as T
from harness.runner import Context

MS = 1_000_000


def made_up():
    t = T.Trace()
    # Two queries, 10 ms each, 5 ms apart.
    t.annotations = [
        ("gpubench/query/a", 0, 10 * MS), ("query/execute", 1 * MS, 9 * MS),
        ("plan/optimize", 1 * MS, 2 * MS),
        ("gpubench/query/b", 15 * MS, 25 * MS), ("query/execute", 15 * MS, 24 * MS),
    ]
    t.device_ops = [
        ("void group_kernel<x>", 3 * MS, 5 * MS), ("copy", 4 * MS, 6 * MS),
        ("void group_kernel<y>", 16 * MS, 17 * MS),
    ]
    return t


def test_busy_is_the_union_of_device_operations():
    t = made_up()
    assert t.window() == (0, 25 * MS)
    assert T.busy_ns(t.device_ops, *t.window()) == 4 * MS


def test_idle_gaps_take_the_innermost_open_range():
    gaps = dict(T.idle_gaps_top(made_up()))
    # 0-3: mid 1.5 in plan/optimize; 6-16: mid 11, between queries;
    # 17-25: mid 21 in query/execute.
    assert gaps == pytest.approx({"plan/optimize": 0.003, "between queries": 0.010,
                                  "query/execute": 0.008})


def test_device_ops_top_sums_by_name():
    top = T.device_ops_top(made_up())
    assert top[0] == ["void group_kernel<x>", 0.002]


def test_roofline_share_counts_frozen_bytes_over_kernel_time():
    class Rows:
        n = 1000

    mix = {"shapes": {"a": {"roofline": {"m": {"plane_bytes_per_row": 4,
                                               "selected_bytes_per_row": 8, "out_bytes": 100}}},
                      "b": {}}}
    ctx = Context(mix, Rows(), [("a", ["q"]), ("b", ["q"])], [], made_up(), 0.025, 0.004,
                  {"hbm_bytes_per_s": 1e9}, lambda q: 500)
    # (4 * 1000 + 8 * 500 + 100) bytes at 1e9 B/s over query a's 2 ms of group_kernel.
    assert roofline.share(ctx, "m", kernel="group_kernel") == pytest.approx(100 * 8100e-9 / 0.002)
    # Without a kernel name: all device time inside query a (3-6 ms).
    assert roofline.share(ctx, "m") == pytest.approx(100 * 8100e-9 / 0.003)
    assert roofline.share(ctx, "absent") is None
