"""The device's idle share of the traced window: 1 - busy/wall, busy the
union of the device's kernel, copy and memset intervals."""


def read(ctx):
    return 1.0 - ctx.busy_s / ctx.window_s
