"""The device's idle share over the traced stretch of updates: one
minus the union of kernel, copy and set intervals over the stretch."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
