"""traj_prep_ms.noisy: ms per trajectory batch in the trajectory engine's
preparation: the branch draws (``ops.unitary_traj.draw_branches``), their
operators (``branch_overrides``) and the batched operand build on the card
(``ops.plan.build_group_operands_batched``), each span ending in a
synchronize."""

from qsbench.reduce import PLAN, UNITARY_TRAJ, spans_ms

BATCH = f"{PLAN}:build_group_operands_batched"
SPANS = {f"{UNITARY_TRAJ}:draw_branches": "device",
         f"{UNITARY_TRAJ}:branch_overrides": "device",
         BATCH: "device"}


def read(ctx):
    return spans_ms(ctx, SPANS, per=BATCH)
