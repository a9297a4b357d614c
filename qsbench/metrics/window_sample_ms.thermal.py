"""window_sample_ms.thermal: ms per trajectory in the window samples of the
monomial splice (``ops.monomial_traj._sample_axes``: one basis sample of
the state a window), spans that start and end in a synchronize."""

from qsbench.windows import MONO, per_trajectory_ms

SPANS = {f"{MONO}:_sample_axes": "device"}


def read(ctx):
    return per_trajectory_ms(ctx, SPANS)
