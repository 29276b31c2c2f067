"""device.idle_share: percent of the traced window in which nothing ran on
the card."""


def read(ctx):
    if not ctx.trace.device_ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
