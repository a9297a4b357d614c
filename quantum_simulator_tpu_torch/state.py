"""Host-facing StateVector over a device-resident torch tensor.

Counterpart of ``quantum_simulator_tpu/state.py:34-153``: amplitudes live
on the device as ``CONFIG.dtype`` (complex64); ``.data`` is a NumPy
complex128 copy and ``.probabilities`` a float64 one. The JAX package's
complex-transfer helpers (``utils/xfer.py``) exist for its TPU runtime and
are not needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CONFIG
from .ops.apply import probabilities as _probabilities


class StateVector:
    """An n-qubit pure state as a device-resident complex tensor."""

    def __init__(self, num_qubits: int, device=None):
        if num_qubits < 1 or num_qubits > CONFIG.max_qubits:
            raise ValueError(
                f"num_qubits must be 1-{CONFIG.max_qubits}, got {num_qubits}")
        self._num_qubits = num_qubits
        self._data = torch.zeros(1 << num_qubits, dtype=CONFIG.dtype,
                                 device=device or CONFIG.device)
        self._data[0] = 1.0

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

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def device_data(self) -> torch.Tensor:
        """The raw device tensor (no copy, no dtype change)."""
        return self._data

    @property
    def data(self) -> np.ndarray:
        """Host copy as complex128."""
        return self._data.cpu().numpy().astype(np.complex128)

    @property
    def probabilities(self) -> np.ndarray:
        """Host |amplitude|^2 as float64."""
        return _probabilities(self._data).cpu().numpy().astype(np.float64)

    def __repr__(self) -> str:
        return (f"StateVector(num_qubits={self._num_qubits}, "
                f"device={self._data.device})")
