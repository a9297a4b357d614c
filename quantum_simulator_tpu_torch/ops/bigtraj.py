"""Realness analysis of noisy trajectories.

The part of ``quantum_simulator_tpu/ops/bigtraj.py`` (``:73-108``) that
the splice executors (``ops/unitary_traj.py``, ``ops/monomial_traj.py``)
import: ``phase_real_stack`` and ``trajectory_is_real``. Kraus stacks
that are real up to a global phase per operator (all four reference
channels: Y realifies to ``-iY``) keep an all-real circuit's trajectory
real, so its state is one float32 plane instead of two. A per-branch
global phase is unobservable: branch probabilities, later draws,
marginals, samples and reduced density matrices do not change.

The rest of that module, the per-gate fold executor for n >= 30, belongs
to the large-state slice (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import numpy as np

from .plan import _op_is_real


def phase_real_stack(stack: np.ndarray) -> np.ndarray | None:
    """``(m, 2, 2)`` complex Kraus stack -> float32 real stack when every
    operator is real up to a global phase, else None
    (``Y -> -iY = [[0, -1], [1, 0]]``)."""
    out = []
    for K in np.asarray(stack):
        flat = K.reshape(-1)
        j = int(np.argmax(np.abs(flat)))
        a = flat[j]
        if abs(a) < 1e-30:
            out.append(np.zeros((2, 2)))
            continue
        R = K * (np.conj(a) / abs(a))
        if not np.allclose(R.imag, 0.0, atol=1e-10):
            return None
        out.append(R.real)
    return np.stack(out).astype(np.float32)


def trajectory_is_real(program, noise_model) -> bool:
    """True when the whole stochastic trajectory stays real: every circuit
    operator real and every Kraus stack phase-real."""
    if not all(_op_is_real(op) for op in program.ops):
        return False
    seen: set[str] = set()
    for op in program.ops:
        if op.gate_name in seen:
            continue
        seen.add(op.gate_name)
        for st in noise_model.kraus_stacks_for_gate(op.gate_name):
            if phase_real_stack(st) is None:
                return False
    return True
