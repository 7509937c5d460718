"""Share of the traced window in which no kernel, memset or copy ran on
the device, %."""


def read(ctx):
    if not ctx.events:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in ctx.busy()) / 1e9 / ctx.window_s)
