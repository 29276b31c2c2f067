"""planes.build_idle_ms: ms per query in which the card is idle while the
innermost program span is ``planes/build``: a superpart, plane or device
LUT built on a cache miss (compiled.py; harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.ms_per_query(ctx, spans.named("planes/build"))
