"""result.epilogue_idle_ms: ms per query in which the card is idle while
the innermost program span is ``result/epilogue``: the host's turn of the
result blob into batches (``_epilogue``, ``_dense_epilogue``,
``compiled_scan._materialize``; harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.ms_per_query(ctx, spans.named("result/epilogue"))
