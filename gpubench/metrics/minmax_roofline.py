"""minmax_roofline: the compiled tier's min/max passes, K3
(``csrc/agg.cu``'s ``group_kernel<MinMax, kPos>``, launched inside the
program's ``compiled/minmax`` span), percent of the HBM bound of the
passes' bytes over the profiled time of those launches.

A pass reads the selection plane whole and the code and value of each
selected row; each byte counts once a query, however many passes read it
(the selection and the codes: one pass a value column). Bytes are frozen
per shape in the mix file under this metric's name, in
``harness/roofline.py``'s form, with one difference:
``plane_bytes_per_row`` counts over the rows of the query's time window
(its ``timestamp`` leaves), the fewest a pass can read, since time pruning
leaves it whole parts. Both row counts come from the benchmark's own rows:
their counts over (the one column the query's other leaves read, time),
each over every value it can take (``harness/selected.py``'s joint grid
of all the filter's columns is past its cap at this size).

A launch is asynchronous, so its kernel may run after the span has closed
on the host: the time is that of the K3 kernels inside the shapes'
queries, which only that span launches. A window without a
``compiled/minmax`` span (a program without it) or without such a kernel,
or a query whose other leaves read more than one column, gives nothing."""

import numpy as np

from harness import trace as T
from harness.spec import COMPARISONS
from reference import numpy_ref as R


def _any_minmax(spans) -> bool:
    return any(s.name == "compiled/minmax" or _any_minmax(s.children) for s in spans)


def _leaves(query: list) -> tuple:
    """(timestamp leaves, the other leaves) of the query's filters, each a
    conjunction of leaves."""
    time, rest = [], []
    for step in query:
        if step[0] == "filter":
            p = step[1]
            for leaf in (p[1:] if p[0] == "and" else [p]):
                (time if leaf[0] in COMPARISONS and leaf[1] == "timestamp" else rest).append(leaf)
    return time, rest


def _levels_selected(rows, column: str, leaves: list) -> np.ndarray:
    """Which values of ``column`` the conjunction of ``leaves`` selects."""
    lv = rows.levels[column]
    if not leaves:
        return np.ones(len(lv), bool)
    dicts = {column: rows.dicts[column]} if column in rows.dicts else {}
    return R.mask(["and", *leaves], R.Frame({column: lv}, dicts))


class _Counts:
    """Rows in a query's time window, and rows it selects."""

    def __init__(self, rows):
        self.rows = rows
        self.time = rows.codes("timestamp")
        self.per_time = np.bincount(self.time, minlength=len(rows.levels["timestamp"]))
        self.joint: dict = {}

    def _joint(self, column: str) -> np.ndarray:
        if column not in self.joint:
            nt = len(self.per_time)
            key = self.rows.codes(column).astype(np.int64) * nt + self.time
            self.joint[column] = np.bincount(key, minlength=len(self.rows.levels[column]) * nt).reshape(-1, nt)
        return self.joint[column]

    def __call__(self, query: list):
        time, rest = _leaves(query)
        t = _levels_selected(self.rows, "timestamp", time)
        window = int(self.per_time[t].sum())
        if not rest:
            return window, window
        (column, *more) = sorted(set().union(*(R.columns_used(p) for p in rest)))
        if more or column == "timestamp":
            return None
        c = _levels_selected(self.rows, column, rest)
        return window, int(self._joint(column)[c][:, t].sum())


def read(ctx):
    if ctx.peaks is None or not _any_minmax(ctx.spans):
        return None
    counts = _Counts(ctx.rows)
    total = 0.0
    ranges = []
    for (shape, query), q in zip(ctx.window_queries, ctx.trace.queries()):
        entry = ctx.mix["shapes"][shape].get("roofline", {}).get("minmax_roofline")
        if entry is None:
            continue
        rows = counts(query)
        if rows is None:
            return None
        window, selected = rows
        total += (entry["plane_bytes_per_row"] * window + entry["selected_bytes_per_row"] * selected
                  + entry["out_bytes"])
        ranges.append((q[1], q[2]))
    if not total or not ranges:
        return None
    ns = sum(e - s for n, s, e in T.ops_in(ctx.trace.device_ops, ranges)
             if "group_kernel" in n and "MinMax" in n)
    if ns <= 0:
        return None
    return 100.0 * total / ctx.peaks["hbm_bytes_per_s"] / (ns / 1e9)
