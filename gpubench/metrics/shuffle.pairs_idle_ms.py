"""shuffle.pairs_idle_ms: ms per query in which the card is idle while the
innermost program span is ``dense/pairs``: a part's sparse sort-reduce
into (code, count, first, partials) pairs and their scatter into the [K]
tables on the dense tier's shuffle route (parallel/mesh_exec.py;
harness/spans.py)."""

from harness import spans


def _opened(roots) -> bool:
    return any(s.name == "dense/pairs" or _opened(s.children) for s in roots)


def read(ctx):
    # A program without the span (one before it) reads nothing, not 0.
    if not _opened(ctx.spans):
        return None
    return spans.ms_per_query(ctx, spans.named("dense/pairs"))
