"""Quantum gate definitions: canonical NumPy matrices and builders.

Counterpart of ``quantum_simulator_tpu/gates.py:23-202`` without the
``jnp_*`` builders: the port builds every operator on the host in NumPy,
as the JAX package's ``xp=np`` operand build does
(``quantum_simulator_tpu/ops/plan.py:818-831``). A built-in parameterized
gate carries its matrix function as ``param_builder``; that marks its
parameters as a runtime vector, like ``jnp_matrix_func`` does in the JAX
package (``ops/program.py:110``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable

import numpy as np


class GateType(Enum):
    SINGLE = "single"
    CONTROLLED = "controlled"
    MULTI = "multi"
    MEASUREMENT = "measurement"
    BARRIER = "barrier"


@dataclass(frozen=True)
class GateDefinition:
    """Immutable definition of a quantum gate (``matrix_func`` returns a
    NumPy complex128 matrix)."""

    name: str
    display_name: str
    gate_type: GateType
    num_qubits: int
    num_params: int
    param_names: tuple[str, ...]
    matrix_func: Callable[..., np.ndarray]
    symbol: str
    color: str
    num_controls: int = 0
    num_targets: int = 1
    # Built-in parameterized gates: parameters stay a runtime vector.
    param_builder: Callable[..., np.ndarray] | None = None
    # Wide controlled-phase diagonals (MCZ_k, k > 10) carry only the phase
    # of the all-targets-set amplitude; matrix_func raises.
    cphase_value: complex | None = None


# --- Fixed single-qubit matrices --------------------------------------------

I_MATRIX = np.eye(2, dtype=np.complex128)
X_MATRIX = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y_MATRIX = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z_MATRIX = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H_MATRIX = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
S_MATRIX = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
S_DAG_MATRIX = np.array([[1, 0], [0, -1j]], dtype=np.complex128)
T_MATRIX = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128)
T_DAG_MATRIX = np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]],
                        dtype=np.complex128)

# --- Fixed multi-qubit matrices ---------------------------------------------

CNOT_MATRIX = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
)
CZ_MATRIX = np.diag([1.0, 1.0, 1.0, -1.0]).astype(np.complex128)
SWAP_MATRIX = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)

TOFFOLI_MATRIX = np.eye(8, dtype=np.complex128)
TOFFOLI_MATRIX[[6, 7], [6, 7]] = 0.0
TOFFOLI_MATRIX[6, 7] = TOFFOLI_MATRIX[7, 6] = 1.0

FREDKIN_MATRIX = np.eye(8, dtype=np.complex128)
FREDKIN_MATRIX[[5, 6], [5, 6]] = 0.0
FREDKIN_MATRIX[5, 6] = FREDKIN_MATRIX[6, 5] = 1.0


# --- Parameterized builders --------------------------------------------------

def rx_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz_matrix(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-1j * theta / 2), 0], [0, np.exp(1j * theta / 2)]],
        dtype=np.complex128,
    )


def phase_matrix(phi: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * phi)]], dtype=np.complex128)


def u3_matrix(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


def cphase_matrix(phi: float) -> np.ndarray:
    """Controlled-phase: diag(1, 1, 1, e^{i phi})."""
    return np.diag([1.0, 1.0, 1.0, np.exp(1j * phi)]).astype(np.complex128)


def mcz_matrix(num_qubits: int) -> np.ndarray:
    """Multi-controlled-Z on ``num_qubits`` qubits: diag(1,...,1,-1)."""
    d = np.ones(2**num_qubits, dtype=np.complex128)
    d[-1] = -1.0
    return np.diag(d)


def _const(matrix: np.ndarray) -> Callable[[], np.ndarray]:
    """No-arg callable returning a fixed matrix."""

    def _fn() -> np.ndarray:
        return matrix

    return _fn


PARAM_BUILDERS: dict[str, Callable] = {
    "Rx": rx_matrix,
    "Ry": ry_matrix,
    "Rz": rz_matrix,
    "Phase": phase_matrix,
    "U3": u3_matrix,
    "CPhase": cphase_matrix,
}
