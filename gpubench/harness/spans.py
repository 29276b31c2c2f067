"""The program's spans against the device trace, on the clock they share:
``frostdb_tpu_torch/tracing.py`` stamps each span's ``start_ns`` and
``end_ns`` with ``time.time_ns``, the clock of torch.profiler's events.
Each nanosecond in which the device is idle inside a query's
``query/execute`` is put down to the innermost program span open at that
moment. The per-layer readers ``tier.declined_idle_ms``,
``planes.build_idle_ms``, ``result.epilogue_idle_ms``,
``dense.parts_idle_ms`` and ``device.idle_explained_share`` read it.

A program whose spans carry no ``start_ns`` (one before the spans shared
the profiler's clock), a trace without device operations (a run on the
CPU) or a window without a query span gives no split, and the readers
report nothing.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from harness import trace as T

ROOT = "query/execute"
# The work inside the tiers. With the tiers' ``*/lower`` spans these are
# what "explains" an idle nanosecond; the root and the ``*/execute`` spans
# do not.
INSIDE = ("planes/build", "program/build", "groups/remap", "dense/parts",
          "result/copy", "result/epilogue", "scan/blocks")


@dataclass
class Split:
    queries: int  # query/execute spans in the window
    idle_ns: int  # device idle inside them
    owned: list  # (span, its ancestors from the root, idle ns it owns)

    def ns(self, pred) -> int:
        """Idle ns owned by the spans for which ``pred(span, ancestors)``
        holds."""
        return sum(n for s, up, n in self.owned if pred(s, up))


class _Idle:
    """Idle ns of any interval, from the window's sorted idle gaps."""

    def __init__(self, gaps):
        self.starts = [s for s, _e in gaps]
        self.ends = [e for _s, e in gaps]
        self.prefix = [0]
        for s, e in gaps:
            self.prefix.append(self.prefix[-1] + e - s)

    def __call__(self, a: int, b: int) -> int:
        if b <= a:
            return 0
        i = bisect.bisect_right(self.ends, a)  # first gap ending after a
        j = bisect.bisect_left(self.starts, b)  # first gap starting at or after b
        if j <= i:
            return 0
        ns = self.prefix[j] - self.prefix[i]
        ns -= max(0, a - self.starts[i])
        ns -= max(0, self.ends[j - 1] - b)
        return ns


def idle_gaps(ops, lo: int, hi: int) -> list:
    """The sorted intervals of [lo, hi] in which no device op runs."""
    gaps, prev = [], lo
    for s, e in T.busy_intervals(ops, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def split(ctx) -> Split | None:
    roots = [s for s in ctx.spans if s.name == ROOT]
    if not ctx.trace.device_ops or not roots or getattr(roots[0], "start_ns", None) is None:
        return None
    lo, hi = ctx.trace.window()
    idle = _Idle(idle_gaps(ctx.trace.device_ops, lo, hi))
    owned = []

    def walk(span, up) -> int:
        a, b = max(span.start_ns, lo), min(span.end_ns, hi)
        mine = idle(a, b)
        below = sum(walk(c, up + (span,)) for c in span.children)
        owned.append((span, up, max(mine - below, 0)))
        return mine

    total = sum(walk(r, ()) for r in roots)
    return Split(len(roots), total, owned)


def declined(span, up) -> bool:
    """Inside a tier's lowering or execution that declined the query."""
    return any(s.name.endswith(("/lower", "/execute")) and "declined" in s.attributes
               for s in up + (span,))


def explained(span, _up) -> bool:
    return span.name in INSIDE or span.name.endswith("/lower")


def named(name: str):
    return lambda span, _up: span.name == name


def ms_per_query(ctx, pred) -> float | None:
    sp = split(ctx)
    return None if sp is None else sp.ns(pred) / 1e6 / sp.queries
