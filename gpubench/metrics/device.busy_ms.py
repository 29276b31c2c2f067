"""device.busy_ms: ms per query in which a kernel, copy or set ran on the
card, over the traced window."""


def read(ctx):
    if not ctx.trace.device_ops or not ctx.window_queries:
        return None
    return 1e3 * ctx.busy_s / len(ctx.window_queries)
