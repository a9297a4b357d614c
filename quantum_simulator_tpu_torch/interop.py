"""Carry data built by the JAX package, as NumPy, into the port's layout.

``quantum_simulator_tpu.ops.plan.build_group_operands(..., xp=np)``
returns its complex operators in the blocked ``[[re, -im], [im, re]]``
form that feeds the TPU's matrix unit. The port keeps the two planes
``(re, im)`` instead (``ops/plan.build_group_operands``). With these
converters a test feeds identical operators to both executors. This
module imports neither JAX nor the JAX package: it takes plain arrays.
"""

from __future__ import annotations

import numpy as np


def _planes(blocked, axis: int = 0) -> np.ndarray:
    """Blocked (..., 2[c], 2[d], ...) at ``axis`` -> (re, im) planes: the
    d = 0 column holds (re, im)."""
    return np.ascontiguousarray(
        np.take(np.asarray(blocked, dtype=np.float32), 0, axis=axis + 1))


def operands_from_numpy(jax_operands):
    """The JAX package's operand 5-tuple (NumPy mode) -> the port's."""
    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = jax_operands
    return ([_planes(a, axis=1) for a in axis_stacks],
            [_planes(c) for c in cross_ops],
            [_planes(d) for d in diag_ops],
            [(tuple(np.asarray(m, dtype=np.float32) for m in facs),
              float(cre), float(cim)) for facs, cre, cim in prod_ops],
            [None if b is None else _planes(b) for b in bitpair_ops])


def params_from_numpy(initial_params) -> np.ndarray:
    """A parameter vector (any array-like) -> the port's float64 vector."""
    return np.asarray(initial_params, dtype=np.float64).reshape(-1)
