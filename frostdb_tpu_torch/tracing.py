"""Tracing / profiling (reference: §5.1 — OpenTelemetry spans threaded
through scan/plan/execute, db.go:137, physicalplan.go:296).

Equivalents here:
- host spans: contextvar-scoped ``span(name)`` records its start and end
  into a per-tracer tree (inspectable, exportable as JSON), on the clock
  ``torch.profiler`` stamps its host and device events with
  (``time.time_ns``, CLOCK_REALTIME), so a span lines up with the device
  trace of the same run;
- device spans: the same ``span`` opens ``torch.profiler.record_function``
  so operator names show up in torch profiler timelines;
- plan introspection: the physical plan diagram is attached to the query
  span like the reference attaches the drawn plan as a span attribute
  (physicalplan.go:505);
- counters: ``count(name)`` bumps a counter of the query's metrics
  registry (``ExecOptions.metrics``), for work deep inside a tier.

The port emits more than the JAX package: the spans and attribute keys
below exist only here, and the tier spans carry the serving tier's name
where the reference's tiers all open ``compiled/execute``.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

# The clock of torch.profiler's event timestamps.
clock_ns = time.time_ns

# Spans only the port emits: each tier's lowering, and the work inside the
# tiers (cache misses, the group remap, the dense tier's part loop and its
# shuffle route's pairs, a fused program's min/max passes, the result's
# copy and host epilogue with the shuffle route's host order,
# compiled_scan's block loop).
PORT_ONLY_SPANS = (
    "compiled/lower", "compiled_join/lower", "dense/lower",
    "compiled_distinct/lower", "schema_meta/lower", "compiled_scan/lower",
    "mesh/lower", "planes/build", "program/build", "groups/remap",
    "dense/parts", "dense/pairs", "compiled/minmax", "result/copy",
    "result/epilogue", "shuffle/order", "scan/blocks",
)
# The port's tier spans, each under the name the reference's tier opens.
REFERENCE_TIER_SPAN = {
    "compiled_distinct/execute": "compiled/execute",
    "compiled_join/execute": "compiled/execute",
    "dense/execute": "compiled/execute",
    "mesh/execute": "compiled/execute",
}
# Attribute keys only the port sets, by the span (port name) both emit.
PORT_ONLY_KEYS = {
    "query/execute": ("query",),
    **{
        name: ("parts", "parts_pruned", "declined")
        for name in (
            "compiled/execute", "compiled_scan/execute", "schema_meta/execute",
            *REFERENCE_TIER_SPAN,
        )
    },
}


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        """Seconds, to the end or (while open) to now."""
        return ((self.end_ns or clock_ns()) - self.start_ns) / 1e9

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
_current_registry: contextvars.ContextVar = contextvars.ContextVar(
    "frostdb_tpu_torch_registry", default=None
)


class Tracer:
    def __init__(self):
        self.roots: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        parent = _current_span.get()
        s = Span(name=name, start_ns=clock_ns(), attributes=attributes)
        if parent is None:
            self.roots.append(s)
        else:
            parent.children.append(s)
        token = _current_span.set(s)
        ttoken = _current_tracer.set(self)
        try:
            with torch.profiler.record_function(name):
                yield s
        except Exception as e:
            from .compiled import NotCompilable

            if isinstance(e, NotCompilable):
                # A tier declined: every span the refusal leaves says why.
                s.attributes["declined"] = str(e) or type(e).__name__
            raise
        finally:
            s.end_ns = clock_ns()
            _current_span.reset(token)
            _current_tracer.reset(ttoken)

    def reset(self) -> None:
        self.roots = []


_OFF = contextlib.nullcontext()


def span(name: str, **attributes):
    """Span on the *ambient* tracer: inner layers (table scan, compiled
    executor, WAL) call this without threading a tracer handle — it nests
    under whatever Tracer.span is active (the engine's per-query root) and
    is a shared no-op context (entered as None) otherwise. The analogue of
    the reference passing trace.Tracer through every layer via options
    (db.go:137, query/engine.go:36)."""
    t = _current_tracer.get()
    if t is None:
        return _OFF
    return t.span(name, **attributes)


def annotate(**attributes) -> None:
    """Set attributes on the innermost open span, if any."""
    s = _current_span.get()
    if s is not None:
        s.attributes.update(attributes)


@contextlib.contextmanager
def metrics_scope(registry):
    """Make ``registry`` the one ``count`` bumps, for the block."""
    token = _current_registry.set(registry)
    try:
        yield
    finally:
        _current_registry.reset(token)


def count(name: str, help_: str, v: float = 1.0) -> None:
    """Bump counter ``name`` of the ambient registry, if any."""
    r = _current_registry.get()
    if r is not None:
        r.counter(name, help_).inc(v)
