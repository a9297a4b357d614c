"""Hamiltonian term builders for VQE cost functions.

Counterpart of ``quantum_simulator_tpu/models/hamiltonians.py``. Terms
are ``(coefficient, pauli_string, qubits)`` triples consumed by
``CostFunction.vqe_hamiltonian``.
"""

from __future__ import annotations

Term = tuple[float, str, list[int]]


def zz_chain(num_qubits: int, coeff: float = -1.0) -> list[Term]:
    """sum_i coeff * Z_i Z_{i+1}."""
    return [(coeff, "ZZ", [i, i + 1]) for i in range(num_qubits - 1)]


def heisenberg_chain(num_qubits: int, jx: float = -1.0, jy: float = -1.0,
                     jz: float = -1.0) -> list[Term]:
    """Nearest-neighbour XX + YY + ZZ chain."""
    terms: list[Term] = []
    for i in range(num_qubits - 1):
        terms.append((jx, "XX", [i, i + 1]))
        terms.append((jy, "YY", [i, i + 1]))
        terms.append((jz, "ZZ", [i, i + 1]))
    return terms


def tfim_chain(num_qubits: int, j: float = -1.0,
               h: float = -1.0) -> list[Term]:
    """Transverse-field Ising: sum J Z_i Z_{i+1} + sum h X_i."""
    terms: list[Term] = zz_chain(num_qubits, j)
    terms.extend((h, "X", [i]) for i in range(num_qubits))
    return terms


def maxcut_edges_ring(num_qubits: int) -> list[tuple[int, int]]:
    """Ring-graph edge list for QAOA MaxCut."""
    return [(i, (i + 1) % num_qubits) for i in range(num_qubits)]
