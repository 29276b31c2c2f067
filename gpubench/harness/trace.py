"""The device trace of a traced run: what ran on the device and when, what
the host had open meanwhile, and the numbers the per-layer readers and the
``breakdown`` take from them.

Events come from ``torch.profiler`` (CUPTI) as (name, start ns, end ns), in
the profiler's one clock for host and device. Device operations are the
kernels, copies and sets it saw on the card; host annotations are the
``record_function`` ranges open on the host: the program's spans
(``tracing.py``) and the benchmark's own ``gpubench/query/<shape>`` around
each query.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)  # (name, start_ns, end_ns)
    annotations: list = field(default_factory=list)  # (name, start_ns, end_ns)

    def queries(self) -> list:
        """The benchmark's per-query ranges, in order: (shape, start, end)."""
        out = [(n[len(QUERY_PREFIX):], s, e) for n, s, e in self.annotations
               if n.startswith(QUERY_PREFIX)]
        return sorted(out, key=lambda q: q[1])

    def window(self) -> tuple:
        """(start, end) ns: from the first query's start to the last one's end."""
        q = self.queries()
        return (q[0][1], q[-1][2]) if q else (0, 0)


QUERY_PREFIX = "gpubench/query/"


def from_profile(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    t = Trace()
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                t.device_ops.append((e.name(), start, end))
        elif e.is_user_annotation():
            t.annotations.append((e.name(), start, end))
    return t


def busy_intervals(ops, lo: int, hi: int) -> list:
    """The union of the ops' intervals clipped to [lo, hi], sorted."""
    out = []
    for _n, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(ops, lo: int, hi: int) -> int:
    return sum(e - s for s, e in busy_intervals(ops, lo, hi))


def ops_in(ops, ranges) -> list:
    """The ops that start inside one of the sorted, disjoint ``ranges``."""
    starts = [r[0] for r in ranges]
    out = []
    for op in ops:
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[1] < ranges[i][1]:
            out.append(op)
    return out


def device_ops_top(trace: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    lo, hi = trace.window()
    total: dict = {}
    for n, s, e in trace.device_ops:
        if s >= lo and e <= hi:
            total[n[:120]] = total.get(n[:120], 0) + (e - s)
    return [[n, ns / 1e9] for n, ns in sorted(total.items(), key=lambda x: -x[1])[:top]]


def idle_gaps_top(trace: Trace, top: int = 10) -> list:
    """[label, seconds] of the device's idle time inside the window, each
    gap labelled by the innermost host annotation open at its middle
    (``between queries`` where none is)."""
    lo, hi = trace.window()
    busy = busy_intervals(trace.device_ops, lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    anns = sorted(trace.annotations, key=lambda a: a[1])
    starts = [a[1] for a in anns]
    longest = max((a[2] - a[1] for a in anns), default=0)
    total: dict = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label, width = "between queries", None
        i = bisect.bisect_right(starts, mid)
        j = i - 1
        while j >= 0 and anns[j][1] >= mid - longest:
            n, a, b = anns[j]
            if a <= mid < b and (width is None or b - a < width):
                label, width = n, b - a
            j -= 1
        if label.startswith(QUERY_PREFIX):
            label = "benchmark client"
        total[label] = total.get(label, 0) + (e - s)
    return [[n, ns / 1e9] for n, ns in sorted(total.items(), key=lambda x: -x[1])[:top]]
