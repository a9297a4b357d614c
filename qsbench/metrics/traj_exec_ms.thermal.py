"""traj_exec_ms.thermal: ms per trajectory in the group-plan executor
(``ops.plan.execute_group_plan``) over the monomial splice's window
segments, spans that start and end in a synchronize."""

from qsbench.reduce import PLAN
from qsbench.windows import per_trajectory_ms

SPANS = {f"{PLAN}:execute_group_plan": "device"}


def read(ctx):
    return per_trajectory_ms(ctx, SPANS)
