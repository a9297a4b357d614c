"""trajectories_per_s: every trajectory completed in the window over the
window's length."""


def read(ctx):
    return sum(r.trajectories for r in ctx.requests) / ctx.window_s
