"""edit_ms: the measured window over the requests completed in it, in
ms: the mean wait of an edit's rerun, from its circuit dict to its counts
on the host."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.requests)
