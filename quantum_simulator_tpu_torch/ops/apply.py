"""Gate application primitives on flat amplitude vectors.

Counterpart of ``quantum_simulator_tpu/ops/apply.py``: the segmented
einsum of ``apply_gate`` (``apply.py:47-112``), ``apply_cphase``,
``apply_gate_all_qubits`` and ``probabilities``. The group executor uses
``apply_gate`` only for a ``GenericStep`` (a non-diagonal gate on three or
more axes); basis rotations use ``apply_gate_all_qubits``.

Qubit 0 is the most significant bit of the basis index, so qubit ``q``
has stride ``2**(n-1-q)`` in the flat vector.
"""

from __future__ import annotations

import string

import numpy as np
import torch


def basis_state_index(initial_states: list[int]) -> int:
    """Index of the computational basis product state (qubit 0 = MSB)."""
    idx = 0
    n = len(initial_states)
    for i, bit in enumerate(initial_states):
        if bit:
            idx |= 1 << (n - 1 - i)
    return idx


def _segmented_view(targets: tuple[int, ...], n: int):
    """(state_shape, einsum spec) viewing the state as the sorted target
    bits plus the contiguous segments between them; the gate tensor axes
    are ordered (outputs..., inputs...)."""
    letters = iter(string.ascii_lowercase + string.ascii_uppercase)
    shape: list[int] = []
    state_sub: list[str] = []
    out_sub: list[str] = []
    gate_in: list[str] = []
    gate_out: list[str] = []
    prev = -1
    for t in targets:
        shape.append(1 << (t - prev - 1))
        seg_l = next(letters)
        state_sub.append(seg_l)
        out_sub.append(seg_l)
        shape.append(2)
        l_in, l_out = next(letters), next(letters)
        state_sub.append(l_in)
        gate_in.append(l_in)
        gate_out.append(l_out)
        out_sub.append(l_out)
        prev = t
    shape.append(1 << (n - targets[-1] - 1))
    tail_l = next(letters)
    state_sub.append(tail_l)
    out_sub.append(tail_l)
    spec = ("".join(gate_out) + "".join(gate_in) + ","
            + "".join(state_sub) + "->" + "".join(out_sub))
    return tuple(shape), spec


def apply_gate(state: torch.Tensor, matrix, targets: tuple[int, ...],
               num_qubits: int) -> torch.Tensor:
    """Apply a ``2^k x 2^k`` unitary to ``targets`` of a flat ``2^n``
    complex state. The first target is the most significant bit of the
    gate-matrix index."""
    n = num_qubits
    k = len(targets)
    if any(t < 0 or t >= n for t in targets):
        raise ValueError(f"target qubits {targets} out of range for n={n}")
    g = torch.as_tensor(np.asarray(matrix), dtype=state.dtype,
                        device=state.device).reshape((2,) * (2 * k))
    order = sorted(range(k), key=lambda i: targets[i])
    if order != list(range(k)):
        g = g.permute(tuple(order) + tuple(k + i for i in order))
    shape, spec = _segmented_view(tuple(sorted(targets)), n)
    out = torch.einsum(spec, g, state.reshape(shape))
    return out.reshape(state.shape)


def apply_cphase(state: torch.Tensor, targets: tuple[int, ...],
                 value: complex, num_qubits: int) -> torch.Tensor:
    """Controlled-phase-form diagonal of any width on a flat state:
    multiply the amplitudes whose targets are all |1> by ``value``."""
    mask = 0
    for q in targets:
        mask |= 1 << (num_qubits - 1 - q)
    idx = torch.arange(state.shape[0], device=state.device)
    hit = (idx & mask) == mask
    return torch.where(hit, state * value, state)


def apply_gate_all_qubits(state: torch.Tensor, matrix,
                          num_qubits: int) -> torch.Tensor:
    """Apply the same single-qubit gate to every qubit (basis rotations)."""
    for q in range(num_qubits):
        state = apply_gate(state, matrix, (q,), num_qubits)
    return state


def probabilities(state: torch.Tensor) -> torch.Tensor:
    """|amplitude|^2 in the state's real dtype."""
    return state.real.square() + state.imag.square()
