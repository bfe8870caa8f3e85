"""Set-up: from the start of the process to the start of the window
(imports, the kernels' build and load, the scan pairs made on the card,
the entry built and every shape warmed up)."""


def read(ctx):
    return ctx.setup_s
