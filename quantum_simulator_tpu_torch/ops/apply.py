"""Gate application primitives on flat amplitude vectors.

Counterpart of ``quantum_simulator_tpu/ops/apply.py``: the segmented
einsum of ``apply_gate`` (``apply.py:47-112``), ``apply_cphase``,
``apply_gate_all_qubits``, ``probabilities``, and the mid-circuit
measurement primitives ``prob_qubit_zero``, ``collapse_qubit`` and
``normalize`` (``apply.py:152-197``), which take a leading batch of
trajectories, and the host-facing ``make_basis_state``,
``apply_gate_host`` and ``reduced_density_matrix_1q`` of ``StateVector``.
Every function indexes the state's last dimension and takes leading
batch dimensions. The group executor uses
``apply_gate`` only for a ``GenericStep`` (a non-diagonal gate on three or
more axes); basis rotations use ``apply_gate_all_qubits``; the per-gate
body (``program.forward_body``), the cost functions and ``StateAnalysis``
use ``apply_gate`` and ``apply_cphase`` on states with a leading batch.

Qubit 0 is the most significant bit of the basis index, so qubit ``q``
has stride ``2**(n-1-q)`` in the flat vector.
"""

from __future__ import annotations

import string

import torch

from ..config import CONFIG


def basis_state_index(initial_states: list[int]) -> int:
    """Index of the computational basis product state (qubit 0 = MSB)."""
    idx = 0
    n = len(initial_states)
    for i, bit in enumerate(initial_states):
        if bit:
            idx |= 1 << (n - 1 - i)
    return idx


def make_basis_state(num_qubits: int, index, dtype=None,
                     device="cpu") -> torch.Tensor:
    """|index> as a ``(2^n,)`` state in ``dtype`` (default
    ``CONFIG.dtype``); a sequence (or tensor) of indices gives one basis
    state per row, ``(..., 2^n)``."""
    dtype = dtype or CONFIG.dtype
    idx = torch.as_tensor(index, dtype=torch.int64, device=device)
    state = torch.zeros(tuple(idx.shape) + (1 << num_qubits,), dtype=dtype,
                        device=device)
    return state.scatter_(-1, idx[..., None], 1.0)


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
    """Apply a ``2^k x 2^k`` unitary (NumPy or torch) to ``targets`` of a
    ``(..., 2^n)`` complex state; leading dims are a batch. A torch
    ``(..., 2^k, 2^k)`` matrix with leading dims applies one matrix per
    batch row (they broadcast against the state's). The first target is
    the most significant bit of the gate-matrix index. Differentiable."""
    n = num_qubits
    k = len(targets)
    if any(t < 0 or t >= n for t in targets):
        raise ValueError(f"target qubits {targets} out of range for n={n}")
    g = torch.as_tensor(matrix, dtype=state.dtype, device=state.device)
    lead = tuple(g.shape[:-2])
    g = g.reshape(lead + (2,) * (2 * k))
    order = sorted(range(k), key=lambda i: targets[i])
    if order != list(range(k)):
        b = len(lead)
        g = g.permute(tuple(range(b)) + tuple(b + i for i in order)
                      + tuple(b + k + i for i in order))
    shape, spec = _segmented_view(tuple(sorted(targets)), n)
    gate_sub, rest = spec.split(",")
    state_sub, out_sub = rest.split("->")
    out = torch.einsum(f"...{gate_sub},...{state_sub}->...{out_sub}", g,
                       state.reshape(tuple(state.shape[:-1]) + shape))
    return out.reshape(tuple(out.shape[:-len(shape)]) + (1 << n,))


def apply_gate_host(state: torch.Tensor, matrix, targets,
                    num_qubits: int) -> torch.Tensor:
    """``apply_gate`` for host callers: a NumPy (or nested-list) matrix
    of any complex width and targets of any integer type."""
    return apply_gate(state, matrix, tuple(int(t) for t in targets),
                      int(num_qubits))


def apply_cphase(state: torch.Tensor, targets: tuple[int, ...],
                 value: complex, num_qubits: int) -> torch.Tensor:
    """Controlled-phase-form diagonal of any width on a ``(..., 2^n)``
    state (leading dims are a batch): multiply the amplitudes whose
    targets are all |1> by ``value``."""
    mask = 0
    for q in targets:
        mask |= 1 << (num_qubits - 1 - q)
    idx = torch.arange(state.shape[-1], device=state.device)
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


def _qubit_bits(state: torch.Tensor, qubit: int,
                num_qubits: int) -> torch.Tensor:
    """(2^n,) value of ``qubit``'s bit at every basis index."""
    idx = torch.arange(state.shape[-1], device=state.device)
    return (idx >> (num_qubits - 1 - qubit)) & 1


def prob_qubit_zero(state: torch.Tensor, qubit: int,
                    num_qubits: int) -> torch.Tensor:
    """P(qubit = 0), unnormalized, of a ``(..., 2^n)`` state by a masked
    reduction (qubit 0 = MSB); leading dims are a batch."""
    keep = _qubit_bits(state, qubit, num_qubits) == 0
    return (probabilities(state) * keep).sum(-1)


def collapse_qubit(state: torch.Tensor, qubit: int, outcome,
                   num_qubits: int) -> torch.Tensor:
    """Project a ``(..., 2^n)`` state onto ``qubit == outcome`` and
    renormalize; ``outcome`` is an int or one bit per batch row."""
    bits = _qubit_bits(state, qubit, num_qubits)
    outcome = torch.as_tensor(outcome, device=state.device)
    kept = torch.where(bits == outcome[..., None], state,
                       torch.zeros_like(state))
    return normalize(kept)


def reduced_density_matrix_1q(state: torch.Tensor, qubit: int,
                              num_qubits: int) -> torch.Tensor:
    """``(..., 2, 2)`` reduced density matrix of one qubit of a
    ``(..., 2^n)`` state (a view is fine), the full rho never built:
    rho_ij = sum psi[.., i, ..] conj(psi[.., j, ..]) as elementwise
    products and sums over the two halves, each a pass over the state.
    (An einsum here becomes a batched matmul with a 2 x 2 output, which
    runs far below the card's memory rate.)"""
    psi = state.reshape(tuple(state.shape[:-1])
                        + (1 << qubit, 2, 1 << (num_qubits - qubit - 1)))
    a, b = psi[..., 0, :], psi[..., 1, :]
    p0 = (a.real.square() + a.imag.square()).sum((-2, -1))
    p1 = (b.real.square() + b.imag.square()).sum((-2, -1))
    off = (a * b.conj()).sum((-2, -1))
    return torch.stack([torch.stack([p0.to(off.dtype), off], -1),
                        torch.stack([off.conj(), p1.to(off.dtype)], -1)],
                       -2)


def normalize(state: torch.Tensor) -> torch.Tensor:
    """Each ``(..., 2^n)`` row scaled to norm 1; a zero row stays zero."""
    norm = probabilities(state).sum(-1, keepdim=True).sqrt()
    return torch.where(norm > 1e-15, state / norm.clamp(min=1e-30), state)
