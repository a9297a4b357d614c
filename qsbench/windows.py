"""Shared arithmetic of the readers of the monomial-splice cells: times per
trajectory, and the least time of a window's basis sample.

A window's basis sample (``ops.monomial_traj._sample_axes``) draws one
index per trajectory from the state's law, axis by axis. Its first
marginal reads every element of the state once; each later one reads a
slice of the one before, and its writes are marginals, a few kilobytes.
So its least time is the state's bytes read once at the HBM bandwidth
(``roofline.HBM_BYTES_PER_S``), half of an executor pass's
(``passes.least_pass_s``, which reads and writes the state).
"""

from __future__ import annotations

from .passes import state_bytes
from .reduce import spans_ms
from .roofline import HBM_BYTES_PER_S

MONO = "quantum_simulator_tpu_torch.ops.monomial_traj"


def trajectories(ctx) -> int:
    return sum(r.trajectories for r in ctx.requests)


def per_trajectory_ms(ctx, targets) -> float | None:
    """Milliseconds per trajectory in the union of the spans of
    ``targets``; None when any of them never ran."""
    per_request = spans_ms(ctx, targets)
    if per_request is None or not trajectories(ctx):
        return None
    return per_request * len(ctx.requests) / trajectories(ctx)


def least_sample_s(config: dict) -> float:
    """The state of ``config`` read once at the HBM bandwidth."""
    return state_bytes(config) / HBM_BYTES_PER_S
