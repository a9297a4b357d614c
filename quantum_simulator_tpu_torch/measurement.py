"""Measurement bases and sampling.

Counterpart of ``quantum_simulator_tpu/measurement.py:29-165``: Z/X/Y
bases (X rotates by H, Y by S-dagger then H), ``counts_from_array`` and
``MeasurementEngine.measure_qubit`` / ``measure_all`` / ``sample`` /
``sample_with_basis``.

Below ``DEVICE_SAMPLING_MIN_DIM`` the probabilities go to the host and
``rng.multinomial`` draws the counts, the same NumPy seed stream as the
JAX package. At or above it the distribution stays on the device: a
``torch.Generator`` seeded from one ``rng.integers(0, 2**63)`` draw (as
``measurement.py:118`` forks its JAX key), then an inverse CDF (float64
cumsum, ``searchsorted`` on uniforms, ``bincount``). ``torch.multinomial``
takes at most 2^24 categories and so cannot serve n >= 25.
``sample_with_basis`` applies readout error (``noise.ReadoutError``) in
shot or distribution mode.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from .gates import H_MATRIX, S_DAG_MATRIX
from .ops.apply import apply_gate_all_qubits, probabilities
from .state import StateVector
from .utils.seeding import generator_from_rng


class MeasurementBasis(Enum):
    Z = "Z"  # computational basis
    X = "X"  # apply H to every qubit first
    Y = "Y"  # apply S-dagger then H to every qubit first


def rotate_to_basis(state: StateVector,
                    basis: MeasurementBasis) -> StateVector:
    """Basis-rotated copy of ``state`` (on its device)."""
    if basis == MeasurementBasis.Z:
        return state
    data = state.device_data
    if basis == MeasurementBasis.Y:
        data = apply_gate_all_qubits(data, S_DAG_MATRIX, state.num_qubits)
    data = apply_gate_all_qubits(data, H_MATRIX, state.num_qubits)
    return StateVector.from_tensor(data, state.num_qubits)


def counts_from_array(counts_array: np.ndarray, num_qubits: int
                      ) -> dict[str, int]:
    """Dense histogram -> {bitstring: count}."""
    (nonzero,) = np.nonzero(counts_array)
    return {format(int(i), f"0{num_qubits}b"): int(counts_array[i])
            for i in nonzero}


def sample_counts_device(probs: torch.Tensor, shots: int,
                         generator: torch.Generator) -> dict[int, int]:
    """``shots`` draws from ``probs`` by inverse CDF on its device;
    returns {basis index: count} for the indices drawn. Beside ``probs``
    it holds one float64 array (the copy, summed in place) and arrays of
    ``shots`` entries: no 2^n histogram."""
    cdf = probs.to(torch.float64, copy=True).cumsum_(0)
    u = torch.rand(shots, dtype=torch.float64, device=probs.device,
                   generator=generator) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp_(max=probs.numel() - 1)
    vals, counts = torch.unique(idx, return_counts=True)
    return dict(zip(vals.cpu().tolist(), counts.cpu().tolist()))


# torch.multinomial takes at most 2^24 categories.
MULTINOMIAL_MAX_DIM = 1 << 24


def sample_rows(probs: torch.Tensor, k: int,
                generator: torch.Generator) -> torch.Tensor:
    """``k`` draws with replacement from each row of ``(T, D)``
    probabilities on their device: ``torch.multinomial`` up to its 2^24
    categories, else an inverse CDF per row (float64 cumsum,
    ``searchsorted`` on uniforms). Returns ``(T, k)`` basis indices."""
    D = probs.shape[-1]
    if D <= MULTINOMIAL_MAX_DIM:
        return torch.multinomial(probs, k, replacement=True,
                                 generator=generator)
    cdf = torch.cumsum(probs.to(torch.float64), dim=-1)
    u = torch.rand((probs.shape[0], k), dtype=torch.float64,
                   device=probs.device, generator=generator) * cdf[:, -1:]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=D - 1)


class MeasurementEngine:
    """Static measurement helpers over StateVector."""

    DEVICE_SAMPLING_MIN_DIM = 1 << 20

    @staticmethod
    def measure_qubit(state: StateVector, qubit: int,
                      rng: np.random.Generator | None = None
                      ) -> tuple[int, StateVector]:
        """Outcome and collapsed copy; ``state`` is left as it was."""
        collapsed = state.copy()
        outcome = collapsed.measure_qubit(qubit, rng)
        return outcome, collapsed

    @staticmethod
    def measure_all(state: StateVector,
                    rng: np.random.Generator | None = None
                    ) -> tuple[str, StateVector]:
        collapsed = state.copy()
        bitstring = collapsed.measure_all(rng)
        return bitstring, collapsed

    @staticmethod
    def sample(state: StateVector, shots: int,
               rng: np.random.Generator | None = None) -> dict[str, int]:
        """Sampling without collapse: host multinomial below
        ``DEVICE_SAMPLING_MIN_DIM``, the device sampler at or above it."""
        rng = rng or np.random.default_rng()
        n = state.num_qubits
        if (1 << n) >= MeasurementEngine.DEVICE_SAMPLING_MIN_DIM:
            data = state.device_data
            gen = generator_from_rng(rng, data.device)
            drawn = sample_counts_device(probabilities(data), shots, gen)
            return {format(i, f"0{n}b"): c for i, c in drawn.items()}
        probs = state.probabilities
        total = probs.sum()
        if total > 1e-15:
            probs = probs / total
        else:
            probs = np.full_like(probs, 1.0 / len(probs))
        return counts_from_array(rng.multinomial(shots, probs), n)

    @staticmethod
    def sample_with_basis(state: StateVector, shots: int,
                          basis: MeasurementBasis = MeasurementBasis.Z,
                          readout_error=None,
                          readout_mode: str = "shot",
                          rng: np.random.Generator | None = None
                          ) -> dict[str, int]:
        """Basis rotation, sampling and optional readout error
        (``measurement.py:133-165``): ``readout_mode="distribution"``
        transforms the probabilities with the per-qubit confusion matrix
        before a host multinomial; ``"shot"`` corrupts the sampled
        bitstrings afterwards (``ReadoutError.corrupt_counts``)."""
        rng = rng or np.random.default_rng()
        rotated = rotate_to_basis(state, basis)
        n = rotated.num_qubits
        if readout_error is not None and readout_mode == "distribution":
            probs = rotated.probabilities
            total = probs.sum()
            if total > 1e-15:
                probs = probs / total
            noisy = readout_error.apply_to_distribution(probs, n)
            return counts_from_array(rng.multinomial(shots, noisy), n)
        counts = MeasurementEngine.sample(rotated, shots, rng=rng)
        if readout_error is not None and readout_mode == "shot":
            counts = readout_error.corrupt_counts(counts, rng)
        return counts
