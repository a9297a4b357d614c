"""Quantum gate definitions: canonical NumPy matrices and builders.

Counterpart of ``quantum_simulator_tpu/gates.py:23-212``. A built-in
parameterized gate carries two builders. ``param_builder`` (NumPy) builds
the host operands of an ideal run, as the JAX package's ``xp=np`` operand
build does (``quantum_simulator_tpu/ops/plan.py:818-831``), and marks the
gate's parameters as a runtime vector, like ``jnp_matrix_func`` does in
the JAX package (``ops/program.py:110``). ``torch_matrix_func`` (the
``TORCH_BUILDERS``, counterparts of ``JNP_BUILDERS``) builds the matrices
of a parameter batch on the device and is differentiable: angles of any
leading shape give ``(..., d, d)`` complex matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable

import numpy as np
import torch


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
    # Differentiable torch builder of a built-in parameterized gate.
    torch_matrix_func: Callable[..., torch.Tensor] | None = None


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


# --- Parameterized builders: torch (batched, differentiable) ---------------

def _angles(*thetas) -> list[torch.Tensor]:
    """Angles as broadcast float tensors (a Python or NumPy number becomes
    a ``CONFIG.real_dtype`` tensor)."""
    from .config import CONFIG

    ts = [t if isinstance(t, torch.Tensor)
          else torch.as_tensor(t, dtype=CONFIG.real_dtype) for t in thetas]
    return list(torch.broadcast_tensors(*ts))


def _cmat(re_rows, im_rows) -> torch.Tensor:
    """(..., d, d) complex matrix from nested rows of real and imaginary
    parts, each entry a tensor of the angles' shape."""
    re = torch.stack([torch.stack(r, -1) for r in re_rows], -2)
    im = torch.stack([torch.stack(r, -1) for r in im_rows], -2)
    return torch.complex(re, im)


def torch_rx_matrix(theta) -> torch.Tensor:
    (theta,) = _angles(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _cmat([[c, z], [z, c]], [[z, -s], [-s, z]])


def torch_ry_matrix(theta) -> torch.Tensor:
    (theta,) = _angles(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _cmat([[c, -s], [s, c]], [[z, z], [z, z]])


def torch_rz_matrix(theta) -> torch.Tensor:
    (theta,) = _angles(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _cmat([[c, z], [z, c]], [[-s, z], [z, s]])


def torch_phase_matrix(phi) -> torch.Tensor:
    (phi,) = _angles(phi)
    z = torch.zeros_like(phi)
    one = torch.ones_like(phi)
    return _cmat([[one, z], [z, torch.cos(phi)]],
                 [[z, z], [z, torch.sin(phi)]])


def torch_u3_matrix(theta, phi, lam) -> torch.Tensor:
    theta, phi, lam = _angles(theta, phi, lam)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _cmat(
        [[c, -torch.cos(lam) * s],
         [torch.cos(phi) * s, torch.cos(phi + lam) * c]],
        [[z, -torch.sin(lam) * s],
         [torch.sin(phi) * s, torch.sin(phi + lam) * c]])


def torch_cphase_matrix(phi) -> torch.Tensor:
    (phi,) = _angles(phi)
    z = torch.zeros_like(phi)
    one = torch.ones_like(phi)
    re = [[one, z, z, z], [z, one, z, z], [z, z, one, z],
          [z, z, z, torch.cos(phi)]]
    im = [[z, z, z, z], [z, z, z, z], [z, z, z, z],
          [z, z, z, torch.sin(phi)]]
    return _cmat(re, im)


TORCH_BUILDERS: dict[str, Callable] = {
    "Rx": torch_rx_matrix,
    "Ry": torch_ry_matrix,
    "Rz": torch_rz_matrix,
    "Phase": torch_phase_matrix,
    "U3": torch_u3_matrix,
    "CPhase": torch_cphase_matrix,
}
