"""Model zoo: variational ansätze and Hamiltonian builders.

Counterpart of ``quantum_simulator_tpu/models``. The Trotter circuits
(``models/trotter.py``) wait for the MPS engine they import (ROADMAP
Queue 1 item 10).
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

__all__ = [
    "brickwork_circuit",
    "hardware_efficient_ansatz",
    "heisenberg_chain",
    "maxcut_edges_ring",
    "qaoa_maxcut_ansatz",
    "tfim_chain",
    "zz_chain",
]
