"""dense.parts_idle_ms: ms per query in which the card is idle while the
innermost program span is ``dense/parts``: the dense tier's per-part loop
(parallel/mesh_exec.py; harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.ms_per_query(ctx, spans.named("dense/parts"))
