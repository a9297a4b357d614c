"""traj_exec_ms.noisy: ms per trajectory batch in the batched group-plan
executor (``ops.plan.execute_group_plan``), spans that start and end in a
synchronize."""

from qsbench.reduce import PLAN, spans_ms

EXEC = f"{PLAN}:execute_group_plan"
SPANS = {EXEC: "device"}


def read(ctx):
    return spans_ms(ctx, SPANS, per=EXEC)
