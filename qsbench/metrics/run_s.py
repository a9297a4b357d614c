"""run_s: the measured window over the requests completed in it, each a
``Simulator.run`` from the circuit dict to the counts on the host."""


def read(ctx):
    return ctx.window_s / len(ctx.requests)
