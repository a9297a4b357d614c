"""The least time of one kernel launch on one NVIDIA H100, from its shape.

The yardstick of the ``<kernel>_roofline`` metrics. A launch of the port's
fiber kernels (``dense_axis``, ``cross_bit_axis`` and their float64 forms)
applies a K-deep operator along one axis of a state, in place. Its least
time is the larger of

* bytes: every state element read once and written once, plus the
  operator's distinct elements read once, at the HBM bandwidth;
* operations: the product's algorithmic FLOPs, 2 K per real output
  element, twice that for a complex operator on a planar state, at the
  dense tensor-core peak of the state's precision.

It depends on the shape alone: not on how many passes or which
instructions an implementation uses, so it reads the same work whatever
implements the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet: dense peaks without sparsity, at its 700 W
# limit. float32 products run at the TF32 tensor-core peak, float64 ones
# at the FP64 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "float64": 67e12}


class Launch(NamedTuple):
    """What one launch was given: ``state_elems`` real elements of the
    state (planes and batch included), ``op_elems`` distinct real elements
    of the operator (one block when it is shared with stride 0), the
    depth ``K``, whether the operator is complex, and the precision."""

    kernel: str
    state_elems: int
    op_elems: int
    K: int
    complex_op: bool
    precision: str


def launch_bytes(launch: Launch) -> int:
    item = 8 if launch.precision == "float64" else 4
    return (2 * launch.state_elems + launch.op_elems) * item


def launch_flops(launch: Launch) -> int:
    return launch.state_elems * 2 * launch.K * (2 if launch.complex_op
                                                else 1)


def least_time(launch: Launch) -> tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: the bound and what sets it."""
    t_bytes = launch_bytes(launch) / HBM_BYTES_PER_S
    t_ops = launch_flops(launch) / PEAK_FLOPS[launch.precision]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
