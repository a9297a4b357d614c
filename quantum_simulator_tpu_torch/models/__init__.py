"""Model zoo: variational ansätze and Hamiltonian builders.

Counterpart of ``quantum_simulator_tpu/models``.
"""

from .ansatz import (
    brickwork_circuit,
    hardware_efficient_ansatz,
    qaoa_maxcut_ansatz,
)
from .hamiltonians import (
    heisenberg_chain,
    maxcut_edges_ring,
    tfim_chain,
    zz_chain,
)
from .trotter import exp_pauli_gate, trotter_circuit

__all__ = [
    "brickwork_circuit",
    "exp_pauli_gate",
    "hardware_efficient_ansatz",
    "heisenberg_chain",
    "maxcut_edges_ring",
    "qaoa_maxcut_ansatz",
    "tfim_chain",
    "trotter_circuit",
    "zz_chain",
]
