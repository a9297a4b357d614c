"""Noise channels, readout error and the NoiseModel.

Counterpart of ``quantum_simulator_tpu/noise.py``: the six single- and
two-qubit Kraus channels (``noise.py:61-209``), the per-bit readout
confusion model with its shot and distribution modes (``:211-311``) and
``NoiseModel`` with its global and per-gate channel lists, ``spec_key``,
``kraus_stacks_for_gate`` and the dict serde of the same type names
(``:333-457``). A JAX noise model carries over as its dict:
``NoiseModel.from_dict(jax_model.to_dict())``.

Every channel exposes ``kraus_stack()``, the stacked ``(m, D, D)`` complex
array the trajectory executors consume (``ops/unitary_traj.py``,
``ops/monomial_traj.py``, ``ops/plan.group_trajectory_body``). The
distribution-mode readout transform takes a float64 NumPy vector (exact,
host) or a torch tensor (on its device); both contract the 2x2 confusion
matrix along each qubit axis, never the 2^n x 2^n Kronecker product.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from .gates import I_MATRIX, X_MATRIX, Y_MATRIX, Z_MATRIX
from .ops.apply import apply_gate, probabilities
from .state import StateVector


def _check_prob(p: float, name: str = "Probability") -> float:
    if not 0 <= p <= 1:
        raise ValueError(f"{name} must be in [0, 1], got {p}")
    return float(p)


class NoiseChannel(ABC):
    """A CPTP channel given by its Kraus operators."""

    @abstractmethod
    def get_kraus_operators(self) -> list[np.ndarray]:
        ...

    @property
    @abstractmethod
    def probability(self) -> float:
        ...

    def kraus_stack(self) -> np.ndarray:
        """Stacked ``(m, D, D)`` complex128 Kraus operators."""
        return np.stack(self.get_kraus_operators()).astype(np.complex128)

    def spec_key(self) -> tuple:
        return (type(self).__name__, self.probability)


class BitFlipNoise(NoiseChannel):
    """X with probability p, identity otherwise."""

    def __init__(self, p: float):
        self._p = _check_prob(p)

    @property
    def probability(self) -> float:
        return self._p

    def get_kraus_operators(self) -> list[np.ndarray]:
        return [np.sqrt(1 - self._p) * I_MATRIX, np.sqrt(self._p) * X_MATRIX]


class PhaseFlipNoise(NoiseChannel):
    """Z with probability p, identity otherwise."""

    def __init__(self, p: float):
        self._p = _check_prob(p)

    @property
    def probability(self) -> float:
        return self._p

    def get_kraus_operators(self) -> list[np.ndarray]:
        return [np.sqrt(1 - self._p) * I_MATRIX, np.sqrt(self._p) * Z_MATRIX]


class DepolarizingNoise(NoiseChannel):
    """Each Pauli with probability p/3."""

    def __init__(self, p: float):
        self._p = _check_prob(p)

    @property
    def probability(self) -> float:
        return self._p

    def get_kraus_operators(self) -> list[np.ndarray]:
        return [
            np.sqrt(1 - self._p) * I_MATRIX,
            np.sqrt(self._p / 3) * X_MATRIX,
            np.sqrt(self._p / 3) * Y_MATRIX,
            np.sqrt(self._p / 3) * Z_MATRIX,
        ]


class TwoQubitDepolarizingNoise(NoiseChannel):
    """Each of the 15 non-identity two-qubit Paulis with probability p/15;
    ``kraus_stack`` is ``(16, 4, 4)``. Register it per two-qubit gate name
    (``add_gate_noise("CNOT", ...)``)."""

    def __init__(self, p: float):
        self._p = _check_prob(p)

    @property
    def probability(self) -> float:
        return self._p

    def get_kraus_operators(self) -> list[np.ndarray]:
        paulis = [I_MATRIX, X_MATRIX, Y_MATRIX, Z_MATRIX]
        ops = [np.sqrt(1 - self._p) * np.kron(I_MATRIX, I_MATRIX)]
        for m in range(1, 16):
            ops.append(np.sqrt(self._p / 15)
                       * np.kron(paulis[m >> 2], paulis[m & 3]))
        return ops


class AmplitudeDampingNoise(NoiseChannel):
    """Energy relaxation |1> -> |0> with rate gamma."""

    def __init__(self, gamma: float):
        self._gamma = _check_prob(gamma, "Gamma")

    @property
    def probability(self) -> float:
        return self._gamma

    def get_kraus_operators(self) -> list[np.ndarray]:
        k0 = np.array([[1, 0], [0, np.sqrt(1 - self._gamma)]],
                      dtype=np.complex128)
        k1 = np.array([[0, np.sqrt(self._gamma)], [0, 0]],
                      dtype=np.complex128)
        return [k0, k1]


class ThermalRelaxationNoise(NoiseChannel):
    """T1/T2 relaxation over one gate duration: amplitude damping with
    ``gamma = 1 - exp(-time/t1)`` composed with the pure dephasing that
    makes the off-diagonal element decay by ``exp(-time/t2)``
    (``lam = 1 - exp(-time * (2/t2 - 1/t1))``, so ``t2 <= 2 t1``).

        K0 = diag(1, sqrt((1-gamma)(1-lam)))
        K1 = [[0, sqrt(gamma)], [0, 0]]
        K2 = diag(0, sqrt((1-gamma) lam))
    """

    def __init__(self, t1: float, t2: float, time: float):
        if t1 <= 0 or t2 <= 0:
            raise ValueError(f"T1 and T2 must be positive, got {t1}, {t2}")
        if t2 > 2 * t1 + 1e-12:
            raise ValueError(
                f"T2 must satisfy T2 <= 2*T1 (got T2={t2}, T1={t1})")
        if time < 0:
            raise ValueError(f"Gate time must be >= 0, got {time}")
        self.t1 = float(t1)
        self.t2 = float(t2)
        self.time = float(time)

    @property
    def probability(self) -> float:
        """Dominant error probability (the relaxation branch weight)."""
        return 1.0 - float(np.exp(-self.time / self.t1))

    def get_kraus_operators(self) -> list[np.ndarray]:
        gamma = 1.0 - np.exp(-self.time / self.t1)
        lam = 1.0 - np.exp(-self.time * max(2.0 / self.t2 - 1.0 / self.t1,
                                            0.0))
        k0 = np.array([[1, 0], [0, np.sqrt((1 - gamma) * (1 - lam))]],
                      dtype=np.complex128)
        k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
        k2 = np.array([[0, 0], [0, np.sqrt((1 - gamma) * lam)]],
                      dtype=np.complex128)
        return [k0, k1, k2]

    def spec_key(self) -> tuple:
        return ("ThermalRelaxationNoise", self.t1, self.t2, self.time)


class ReadoutError:
    """Classical per-bit readout confusion model.

    ``p01``: P(read 1 | true 0); ``p10``: P(read 0 | true 1).
    """

    def __init__(self, p01: float = 0.0, p10: float = 0.0):
        self.p01 = _check_prob(p01, "p01")
        self.p10 = _check_prob(p10, "p10")

    @property
    def confusion_matrix(self) -> np.ndarray:
        """2x2 matrix C[measured][true]; columns sum to 1."""
        return np.array([
            [1 - self.p01, self.p10],
            [self.p01, 1 - self.p10],
        ])

    # --- shot mode -------------------------------------------------------

    def apply_to_bitstring(self, bitstring: str,
                           rng: np.random.Generator) -> str:
        bits = np.frombuffer(bitstring.encode(), dtype=np.uint8) - ord("0")
        flip_p = np.where(bits == 0, self.p01, self.p10)
        flips = rng.random(bits.shape) < flip_p
        noisy = bits ^ flips
        return "".join("1" if b else "0" for b in noisy)

    def corrupt_counts(self, counts: dict[str, int],
                       rng: np.random.Generator) -> dict[str, int]:
        """Shot-mode corruption of a whole counts dict: one draw of shape
        (total_shots, n), the same NumPy stream as the JAX package."""
        if not counts:
            return {}
        bitstrings = list(counts.keys())
        reps = np.array([counts[b] for b in bitstrings])
        bits = np.array([[int(ch) for ch in b] for b in bitstrings],
                        dtype=np.uint8)
        expanded = np.repeat(bits, reps, axis=0)  # (total_shots, n)
        flip_p = np.where(expanded == 0, self.p01, self.p10)
        flips = rng.random(expanded.shape) < flip_p
        noisy = expanded ^ flips
        uniq, cnt = np.unique(noisy.astype(np.uint8), axis=0,
                              return_counts=True)
        return {"".join("1" if b else "0" for b in row): int(c)
                for row, c in zip(uniq, cnt)}

    # --- distribution mode -------------------------------------------------

    def apply_to_distribution(self, probs, num_qubits: int):
        """Confusion-matrix transform of a length-2^n distribution, one
        qubit axis at a time. NumPy input -> float64 host result; a torch
        tensor -> a tensor on its device and of its dtype."""
        if isinstance(probs, torch.Tensor):
            return self._apply_to_distribution_torch(probs, num_qubits)
        c1 = self.confusion_matrix
        p = np.asarray(probs, dtype=np.float64).reshape([2] * num_qubits)
        for axis in range(num_qubits):
            p = np.tensordot(c1, p, axes=([1], [axis]))
            p = np.moveaxis(p, 0, axis)
        flat = p.reshape(-1)
        total = flat.sum()
        return flat / total if total > 1e-15 else flat

    def _apply_to_distribution_torch(self, probs: torch.Tensor,
                                     num_qubits: int) -> torch.Tensor:
        c1 = torch.as_tensor(self.confusion_matrix, dtype=probs.dtype,
                             device=probs.device)
        dim = probs.shape[-1]
        for axis in range(num_qubits):
            a = 1 << axis
            p3 = probs.reshape(a, 2, dim // (2 * a))
            probs = torch.einsum("mt,atb->amb", c1, p3).reshape(dim)
        total = probs.sum()
        return torch.where(total > 1e-15, probs / total, probs)

    def to_dict(self) -> dict:
        return {"p01": self.p01, "p10": self.p10}

    @classmethod
    def from_dict(cls, data: dict) -> "ReadoutError":
        return cls(p01=data.get("p01", 0.0), p10=data.get("p10", 0.0))

    def spec_key(self) -> tuple:
        return ("ReadoutError", self.p01, self.p10)


_CHANNEL_TYPES = {
    "BitFlipNoise": BitFlipNoise,
    "PhaseFlipNoise": PhaseFlipNoise,
    "DepolarizingNoise": DepolarizingNoise,
    "AmplitudeDampingNoise": AmplitudeDampingNoise,
    "TwoQubitDepolarizingNoise": TwoQubitDepolarizingNoise,
}


def _channel_to_dict(ch: NoiseChannel) -> dict:
    if isinstance(ch, ThermalRelaxationNoise):
        return {"type": "ThermalRelaxationNoise", "t1": ch.t1,
                "t2": ch.t2, "time": ch.time}
    return {"type": type(ch).__name__, "probability": ch.probability}


def _channel_from_dict(data: dict) -> NoiseChannel:
    kind = data["type"]
    if kind == "ThermalRelaxationNoise":
        return ThermalRelaxationNoise(data["t1"], data["t2"], data["time"])
    return _CHANNEL_TYPES[kind](data["probability"])


class NoiseModel:
    """Which channels fire after which gates, plus optional readout error."""

    def __init__(self):
        self._global_noise: list[NoiseChannel] = []
        self._gate_noise: dict[str, list[NoiseChannel]] = {}
        self._readout_error: ReadoutError | None = None
        self._rng = np.random.default_rng()
        self._seed: int | None = None

    # --- configuration ------------------------------------------------

    @property
    def readout_error(self) -> ReadoutError | None:
        return self._readout_error

    @property
    def global_channels(self) -> list[NoiseChannel]:
        """Channels applied after every gate (read-only view)."""
        return list(self._global_noise)

    def has_noise(self) -> bool:
        return bool(self._global_noise or self._gate_noise
                    or self._readout_error is not None)

    def set_readout_error(self, error: ReadoutError) -> None:
        self._readout_error = error

    def add_global_noise(self, channel: NoiseChannel):
        self._global_noise.append(channel)

    def add_gate_noise(self, gate_name: str, channel: NoiseChannel):
        self._gate_noise.setdefault(gate_name, []).append(channel)

    def set_seed(self, seed: int):
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    @property
    def seed(self) -> int | None:
        return self._seed

    @property
    def rng(self) -> np.random.Generator:
        return self._rng

    def has_channels(self) -> bool:
        return bool(self._global_noise or self._gate_noise)

    # --- trajectory-executor interface -------------------------------------

    def channels_for_gate(self, gate_name: str) -> list[NoiseChannel]:
        channels = list(self._global_noise)
        channels.extend(self._gate_noise.get(gate_name, []))
        return channels

    def kraus_stacks_for_gate(self, gate_name: str) -> list[np.ndarray]:
        return [ch.kraus_stack() for ch in self.channels_for_gate(gate_name)]

    def spec_key(self) -> tuple:
        """Static identity of the channel configuration (keys the splice
        spec caches)."""
        return (
            tuple(ch.spec_key() for ch in self._global_noise),
            tuple(sorted(
                (name, tuple(ch.spec_key() for ch in chans))
                for name, chans in self._gate_noise.items()
            )),
        )

    # --- interactive single-state path -----------------------------------

    def apply(self, state: StateVector, gate) -> None:
        """Stochastically apply every channel configured for this gate to
        each of its target qubits, drawing with the model's NumPy rng
        (mutates ``state``)."""
        for channel in self.channels_for_gate(gate.gate_name):
            self._apply_channel(state, channel, gate.target_qubits)

    def _apply_channel(self, state: StateVector, channel: NoiseChannel,
                       target_qubits: list[int]):
        for qubit in target_qubits:
            if qubit >= state.num_qubits:
                continue
            branches = [apply_gate(state.device_data, k, (qubit,),
                                   state.num_qubits)
                        for k in channel.get_kraus_operators()]
            norms = np.array([float(probabilities(b).sum())
                              for b in branches])
            total = norms.sum()
            probs = norms / total if total > 1e-15 else norms
            idx = int(self._rng.choice(len(branches), p=probs))
            norm = np.sqrt(norms[idx])
            chosen = branches[idx]
            state.device_data = chosen / norm if norm > 1e-15 else chosen

    # --- serde ------------------------------------------------------------

    def to_dict(self) -> dict:
        result: dict = {"global": [], "gate_specific": {}}
        for ch in self._global_noise:
            result["global"].append(_channel_to_dict(ch))
        for gate_name, channels in self._gate_noise.items():
            result["gate_specific"][gate_name] = [
                _channel_to_dict(ch) for ch in channels
            ]
        if self._readout_error is not None:
            result["readout_error"] = self._readout_error.to_dict()
        return result

    @classmethod
    def from_dict(cls, data: dict) -> "NoiseModel":
        model = cls()
        for ch_data in data.get("global", []):
            model.add_global_noise(_channel_from_dict(ch_data))
        for gate_name, channels in data.get("gate_specific", {}).items():
            for ch_data in channels:
                model.add_gate_noise(gate_name, _channel_from_dict(ch_data))
        if "readout_error" in data:
            model.set_readout_error(
                ReadoutError.from_dict(data["readout_error"]))
        return model
