"""Host-facing StateVector over a device-resident torch tensor.

Counterpart of ``quantum_simulator_tpu/state.py:34-153``: amplitudes live
on the device as ``CONFIG.dtype`` (complex64, or complex128 under
``config.enable_complex128``, where the executors already return
complex128 and ``from_tensor`` casts nothing); ``.data`` is a NumPy
complex128 copy and ``.probabilities`` a float64 one. The JAX package's
complex-transfer helpers (``utils/xfer.py``) exist for its TPU runtime and
are not needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CONFIG
from .ops.apply import (apply_gate_host, basis_state_index, collapse_qubit,
                        make_basis_state, prob_qubit_zero,
                        reduced_density_matrix_1q)
from .ops.apply import probabilities as _probabilities


class StateVector:
    """An n-qubit pure state as a device-resident complex tensor."""

    def __init__(self, num_qubits: int, device=None):
        if num_qubits < 1 or num_qubits > CONFIG.max_qubits:
            raise ValueError(
                f"num_qubits must be 1-{CONFIG.max_qubits}, got {num_qubits}")
        self._num_qubits = num_qubits
        self._data = make_basis_state(num_qubits, 0, CONFIG.dtype,
                                      device or CONFIG.device)

    @classmethod
    def from_initial_states(cls, initial_states: list[int],
                            device=None) -> "StateVector":
        """The computational basis product state (qubit 0 = MSB)."""
        sv = cls(len(initial_states), device=device)
        sv.reset(initial_states)
        return sv

    @classmethod
    def from_tensor(cls, tensor: torch.Tensor, num_qubits: int
                    ) -> "StateVector":
        """Wrap a flat ``(2^n,)`` device tensor without a copy."""
        if tuple(tensor.shape) != (1 << num_qubits,):
            raise ValueError(f"expected shape ({1 << num_qubits},), "
                             f"got {tuple(tensor.shape)}")
        sv = cls.__new__(cls)
        sv._num_qubits = num_qubits
        sv._data = tensor if tensor.dtype == CONFIG.dtype \
            else tensor.to(CONFIG.dtype)
        return sv

    @classmethod
    def from_numpy(cls, array, device=None) -> "StateVector":
        """Copy a NumPy amplitude vector of length 2^n onto ``device``."""
        array = np.asarray(array)
        n = array.shape[0].bit_length() - 1 if array.ndim == 1 else -1
        if n < 1 or array.shape[0] != 1 << n:
            raise ValueError(f"expected a (2^n,) vector, got {array.shape}")
        return cls.from_tensor(
            torch.from_numpy(array.astype(np.complex128)).to(
                device=device or CONFIG.device, dtype=CONFIG.dtype), n)

    def reset(self, initial_states: list[int] | None = None) -> None:
        """Back to a basis product state (|0...0> by default), on the
        state's device."""
        idx = basis_state_index(initial_states) if initial_states else 0
        self._data = make_basis_state(self._num_qubits, idx, CONFIG.dtype,
                                      self._data.device)

    def copy(self) -> "StateVector":
        """An independent copy on the same device."""
        return StateVector.from_tensor(self._data.clone(), self._num_qubits)

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def device_data(self) -> torch.Tensor:
        """The raw device tensor (no copy, no dtype change)."""
        return self._data

    @device_data.setter
    def device_data(self, tensor: torch.Tensor) -> None:
        self._data = tensor

    @property
    def data(self) -> np.ndarray:
        """Host copy as complex128."""
        return self._data.cpu().numpy().astype(np.complex128)

    @data.setter
    def data(self, value) -> None:
        value = np.asarray(value)
        if value.shape != (2**self._num_qubits,):
            raise ValueError(
                f"Expected shape ({2**self._num_qubits},), got {value.shape}")
        self._data = torch.from_numpy(value.astype(np.complex128)).to(
            device=self._data.device, dtype=CONFIG.dtype)

    @property
    def probabilities(self) -> np.ndarray:
        """Host |amplitude|^2 as float64."""
        return _probabilities(self._data).cpu().numpy().astype(np.float64)

    def apply_gate(self, gate_matrix, target_qubits: list[int]) -> None:
        n = self._num_qubits
        for q in target_qubits:
            if q < 0 or q >= n:
                raise ValueError(f"Qubit index {q} out of range [0, {n-1}]")
        self._data = apply_gate_host(self._data, gate_matrix,
                                     target_qubits, n)

    def measure_qubit(self, qubit: int,
                      rng: np.random.Generator | None = None) -> int:
        """Projective single-qubit measurement with collapse and
        renormalization; the outcome is one NumPy draw against P(0)."""
        if qubit < 0 or qubit >= self._num_qubits:
            raise ValueError(f"Qubit {qubit} out of range")
        rng = rng or np.random.default_rng()
        p0 = float(prob_qubit_zero(self._data, qubit, self._num_qubits))
        outcome = 0 if rng.random() < p0 else 1
        self._data = collapse_qubit(self._data, qubit, outcome,
                                    self._num_qubits)
        return outcome

    def measure_all(self, rng: np.random.Generator | None = None) -> str:
        """Measure every qubit; collapse to the drawn basis state."""
        rng = rng or np.random.default_rng()
        probs = self.probabilities
        probs = probs / probs.sum()
        idx = int(rng.choice(len(probs), p=probs))
        self._data = make_basis_state(self._num_qubits, idx, CONFIG.dtype,
                                      self._data.device)
        return format(idx, f"0{self._num_qubits}b")

    def get_reduced_density_matrix(self, qubit: int) -> np.ndarray:
        if qubit < 0 or qubit >= self._num_qubits:
            raise ValueError(f"Qubit {qubit} out of range")
        rho = reduced_density_matrix_1q(self._data, qubit, self._num_qubits)
        return rho.cpu().numpy().astype(np.complex128)

    def get_bloch_coordinates(self, qubit: int) -> tuple[float, float, float]:
        rho = self.get_reduced_density_matrix(qubit)
        x = 2.0 * np.real(rho[0, 1])
        y = 2.0 * np.imag(rho[1, 0])
        z = np.real(rho[0, 0] - rho[1, 1])
        return (float(x), float(y), float(z))

    def get_density_matrix(self) -> np.ndarray:
        psi = self.data
        return np.outer(psi, np.conj(psi))

    def __repr__(self) -> str:
        return (f"StateVector(num_qubits={self._num_qubits}, "
                f"device={self._data.device})")
