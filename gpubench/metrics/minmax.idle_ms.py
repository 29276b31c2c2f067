"""minmax.idle_ms: ms per query in which the card is idle while the
innermost program span is ``compiled/minmax``: the compiled tier's min/max
passes (K3) of a fused program (compiled.py; harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.ms_per_query(ctx, spans.named("compiled/minmax"))
