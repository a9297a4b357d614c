"""window_prep_ms.thermal: ms per trajectory in the preparation of the
monomial splice's windows: the site draws at each window's sample
(``ops.monomial_traj._window_draws``) and the batched operand build of
each segment (``ops.plan.build_group_operands_batched``), spans that start
and end in a synchronize."""

from qsbench.reduce import PLAN
from qsbench.windows import MONO, per_trajectory_ms

SPANS = {f"{MONO}:_window_draws": "device",
         f"{PLAN}:build_group_operands_batched": "device"}


def read(ctx):
    return per_trajectory_ms(ctx, SPANS)
