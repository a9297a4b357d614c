"""windows_per_traj.thermal: window boundaries of the monomial splice per
trajectory: the calls of its basis sample (``ops.monomial_traj.
_sample_axes``, one a window) over the trajectories completed in the
window. A change that merges windows lowers it."""

from qsbench.windows import MONO, trajectories

SPANS = {f"{MONO}:_sample_axes": "host"}


def read(ctx):
    samples = len(ctx.spans_named("_sample_axes"))
    if not samples or not trajectories(ctx):
        return None
    return samples / trajectories(ctx)
