"""A roofline share over a traced window: the least time the card needs
for the bytes the window's queries must move, at the card's peak bandwidth,
over the device time they took.

Bytes are frozen per shape in the mix file, under the metric's name:
``plane_bytes_per_row`` for each live row (planes read in full: filter
planes, a selection plane), ``selected_bytes_per_row`` for each row the
filter selects (codes and values of those rows) and ``out_bytes`` per
query. Padding is not counted; each plane counts once per query. The
selected rows are counted from the benchmark's own rows.
"""

from __future__ import annotations

from harness import trace as T


def share(ctx, metric: str, kernel: str | None = None):
    """Percent of the roofline, or None where nothing was read. With
    ``kernel`` the time is that of the device operations whose name holds
    it; without, all device time inside the metric's queries."""
    total = 0.0
    ranges = []
    for (shape, query), q in zip(ctx.window_queries, ctx.trace.queries()):
        entry = ctx.mix["shapes"][shape].get("roofline", {}).get(metric)
        if entry is None:
            continue
        total += (entry["plane_bytes_per_row"] * ctx.rows.n
                  + entry["selected_bytes_per_row"] * ctx.selected(query)
                  + entry["out_bytes"])
        ranges.append((q[1], q[2]))
    if not total or not ranges or ctx.peaks is None:
        return None
    ops = T.ops_in(ctx.trace.device_ops, ranges)
    if kernel is not None:
        ns = sum(e - s for n, s, e in ops if kernel in n)
    else:
        ns = sum(e - s for s, e in T.busy_intervals(ops, ranges[0][0], ranges[-1][1]))
    if ns <= 0:
        return None
    return 100.0 * total / ctx.peaks["hbm_bytes_per_s"] / (ns / 1e9)
