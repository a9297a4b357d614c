"""host_prep_ms.edit: ms per request in the host's preparation of a run:
lowering the circuit (``ops.program.compile_circuit``), the plan lookup
(``ops.plan.get_group_plan``), the NumPy operand build
(``build_group_operands``) and its copy to the card (``operands_to``)."""

from qsbench.reduce import PLAN, PROGRAM, spans_ms

SPANS = {f"{PROGRAM}:compile_circuit": "host",
         f"{PLAN}:get_group_plan": "host",
         f"{PLAN}:build_group_operands": "host",
         f"{PLAN}:operands_to": "host"}


def read(ctx):
    return spans_ms(ctx, SPANS)
