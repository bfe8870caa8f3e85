"""Scan pairs registered per second: the calls of the window over the
whole window, from the first call's start to the last pose on the host."""


def read(ctx):
    return ctx.calls / ctx.window_s
