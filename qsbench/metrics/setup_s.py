"""setup_s: from the harness's first line to the first measured request:
the port's import, the kernel library's load (its nvcc build in a
checkout's first run) and one warm request of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
