"""engine.plan_ms: the query engine's planning (query/engine.py), mean ms per
query of the program's ``plan/optimize`` span under its ``query/execute``."""


def read(ctx):
    roots = [s for s in ctx.spans if s.name == "query/execute"]
    if not roots:
        return None
    plan = sum(c.duration for s in roots for c in s.children if c.name == "plan/optimize")
    return 1e3 * plan / len(roots)
