"""Tracing / profiling (reference: §5.1 — OpenTelemetry spans threaded
through scan/plan/execute, db.go:137, physicalplan.go:296).

Equivalents here:
- host spans: contextvar-scoped ``span(name)`` records wall-clock durations
  into a per-tracer tree (inspectable, exportable as JSON);
- device spans: the same ``span`` opens ``torch.profiler.record_function``
  so operator names show up in torch profiler timelines;
- plan introspection: the physical plan diagram is attached to the query
  span like the reference attaches the drawn plan as a span attribute
  (physicalplan.go:505).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_s": self.duration,
            "attributes": self.attributes,
            "children": [c.to_dict() for c in self.children],
        }


_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "frostdb_tpu_torch_span", default=None
)
_current_tracer: contextvars.ContextVar[Optional["Tracer"]] = (
    contextvars.ContextVar("frostdb_tpu_torch_tracer", default=None)
)


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.roots: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        if not self.enabled:
            yield None
            return
        parent = _current_span.get()
        s = Span(name=name, start=time.perf_counter(), attributes=dict(attributes))
        if parent is None:
            self.roots.append(s)
        else:
            parent.children.append(s)
        token = _current_span.set(s)
        ttoken = _current_tracer.set(self)
        try:
            with torch.profiler.record_function(name):
                yield s
        finally:
            s.end = time.perf_counter()
            _current_span.reset(token)
            _current_tracer.reset(ttoken)

    def reset(self) -> None:
        self.roots = []


NOOP_TRACER = Tracer(enabled=False)
DEFAULT_TRACER = Tracer()


def get_tracer() -> Tracer:
    return DEFAULT_TRACER


@contextlib.contextmanager
def span(name: str, **attributes):
    """Span on the *ambient* tracer: inner layers (table scan, compiled
    executor, WAL) call this without threading a tracer handle — it nests
    under whatever Tracer.span is active (the engine's per-query root) and
    no-ops otherwise. The analogue of the reference passing trace.Tracer
    through every layer via options (db.go:137, query/engine.go:36)."""
    t = _current_tracer.get()
    if t is None:
        yield None
        return
    with t.span(name, **attributes) as s:
        yield s
