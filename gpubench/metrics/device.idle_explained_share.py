"""device.idle_explained_share: percent of the card's idle time inside the
queries' ``query/execute`` spans whose innermost program span is a tier's
``*/lower`` or one of the spans of the work inside the tiers
(harness/spans.py INSIDE), not the root or a ``*/execute``."""

from harness import spans


def read(ctx):
    sp = spans.split(ctx)
    if sp is None or sp.idle_ns <= 0:
        return None
    return 100.0 * sp.ns(spans.explained) / sp.idle_ns
