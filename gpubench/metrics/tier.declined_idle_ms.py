"""tier.declined_idle_ms: ms per query in which the card is idle inside a
serving tier's ``*/lower`` or ``*/execute`` span that declined the query
(``declined`` attribute; innermost span at each idle ns, harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.ms_per_query(ctx, spans.declined)
