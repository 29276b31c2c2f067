"""shuffle.order_idle_ms: ms per query in which the card is idle while the
innermost program span is ``shuffle/order``: the shuffle route's host
emission order (the present codes, their stable sort by first row, the
key order where asked) inside its epilogue (parallel/mesh_exec.py;
harness/spans.py)."""

from harness import spans


def _opened(roots) -> bool:
    return any(s.name == "shuffle/order" or _opened(s.children) for s in roots)


def read(ctx):
    # A program without the span (one before it) reads nothing, not 0.
    if not _opened(ctx.spans):
        return None
    return spans.ms_per_query(ctx, spans.named("shuffle/order"))
