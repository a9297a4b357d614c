"""Shared arithmetic of the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

PLAN = "quantum_simulator_tpu_torch.ops.plan"
PROGRAM = "quantum_simulator_tpu_torch.ops.program"
BIGSTATE = "quantum_simulator_tpu_torch.ops.bigstate"
UNITARY_TRAJ = "quantum_simulator_tpu_torch.ops.unitary_traj"
MEASUREMENT = "quantum_simulator_tpu_torch.measurement"


def span_name(target: str) -> str:
    return target.rpartition(":")[2].rpartition(".")[2]


def _union_s(spans) -> float:
    total, end = 0.0, None
    for s in sorted(spans, key=lambda s: s.start):
        if end is None or s.start > end:
            total += s.end - s.start
            end = s.end
        elif s.end > end:
            total += s.end - end
            end = s.end
    return total


def spans_ms(ctx, targets, per: str | None = None) -> float | None:
    """Milliseconds in the union of the spans of ``targets``, per request
    or, with ``per``, per span of that target. None when any of them
    never ran."""
    names = [span_name(t) for t in targets]
    found = [ctx.spans_named(n) for n in names]
    if any(not f for f in found):
        return None
    count = (len(ctx.requests) if per is None
             else len(ctx.spans_named(span_name(per))))
    return 1e3 * _union_s([s for f in found for s in f]) / count


def idle_percent(ctx) -> float | None:
    """The share of the traced window in which no operation ran on the
    device; None where the trace holds no device operation."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)


def roofline_percent(ctx, kernel: str) -> float | None:
    from .devtrace import roofline_share

    if ctx.trace is None:
        return None
    return roofline_share(ctx.kernel_times(), kernel)
