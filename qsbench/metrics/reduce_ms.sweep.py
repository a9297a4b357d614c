"""reduce_ms.sweep: ms per request in the large-state reductions
(``ops.bigstate.sample_state_indices``, ``state_axis_marginals``), spans
that start and end in a synchronize."""

from qsbench.reduce import BIGSTATE, spans_ms

SPANS = {f"{BIGSTATE}:sample_state_indices": "device",
         f"{BIGSTATE}:state_axis_marginals": "device"}


def read(ctx):
    return spans_ms(ctx, SPANS)
