"""tier.serve_ms: the serving tier that served each query (compiled,
compiled_distinct, schema_meta, dense, compiled_scan), mean ms per query of
the program's ``query/execute`` span less its ``plan/optimize``."""


def read(ctx):
    roots = [s for s in ctx.spans if s.name == "query/execute"]
    if not roots:
        return None
    serve = sum(s.duration - sum(c.duration for c in s.children if c.name == "plan/optimize")
                for s in roots)
    return 1e3 * serve / len(roots)
