"""executor_ms.sweep: ms per request in the group-plan executor
(``ops.plan.execute_group_plan``), a span that starts and ends in a
synchronize."""

from qsbench.reduce import PLAN, spans_ms

SPANS = {f"{PLAN}:execute_group_plan": "device"}


def read(ctx):
    return spans_ms(ctx, SPANS)
