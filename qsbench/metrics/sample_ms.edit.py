"""sample_ms.edit: ms per request in ``MeasurementEngine.sample_with_basis``,
from the final state to the counts dict, the device's earlier work
finished first."""

from qsbench.reduce import MEASUREMENT, spans_ms

SPANS = {f"{MEASUREMENT}:MeasurementEngine.sample_with_basis": "device"}


def read(ctx):
    return spans_ms(ctx, SPANS)
