"""Acceptance benchmark suite: six named circuits with expected outcomes.

Counterpart of ``quantum_simulator_tpu/benchmarks.py``: Bell, GHZ-3,
Hadamard-1, QFT-3, Identity and X-Gate with their expected nonzero
bitstrings and fidelity floors, as a declarative spec table; each runs
ideal and timed (1024 shots), optionally noisy for a fidelity, with its
TVD and a pass/fail verdict.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .circuit import GateInstance, QuantumCircuit


@dataclass
class BenchmarkResult:
    """Outcome of one benchmark circuit."""

    name: str
    passed: bool
    fidelity: float
    tvd: float
    runtime_ms: float
    details: str = ""


@dataclass(frozen=True)
class BenchmarkSpec:
    """One acceptance benchmark: circuit factory + pass criteria."""

    name: str
    build: Callable[[], QuantumCircuit]
    expected_nonzero: frozenset[str] | None  # None = all states expected
    fidelity_min: float


def _gates(n: int, *specs) -> QuantumCircuit:
    c = QuantumCircuit(num_qubits=n)
    for name, targets, col in specs:
        c.add_gate(GateInstance(name, list(targets), [], col))
    return c


def _qft3() -> QuantumCircuit:
    from .algorithms import AlgorithmTemplate

    return AlgorithmTemplate.quantum_fourier_transform(3)


SPECS: tuple[BenchmarkSpec, ...] = (
    BenchmarkSpec(
        "Bell State",
        lambda: _gates(2, ("H", [0], 0), ("CNOT", [0, 1], 1)),
        frozenset({"00", "11"}), 0.99),
    BenchmarkSpec(
        "GHZ-3",
        lambda: _gates(3, ("H", [0], 0), ("CNOT", [0, 1], 1),
                       ("CNOT", [0, 2], 2)),
        frozenset({"000", "111"}), 0.99),
    BenchmarkSpec(
        "Hadamard-1",
        lambda: _gates(1, ("H", [0], 0)),
        frozenset({"0", "1"}), 0.99),
    BenchmarkSpec("QFT-3", _qft3, None, 0.99),
    BenchmarkSpec("Identity", lambda: QuantumCircuit(num_qubits=2),
                  frozenset({"00"}), 0.9999),
    BenchmarkSpec(
        "X-Gate",
        lambda: _gates(2, ("X", [0], 0)),
        frozenset({"10"}), 0.99),
)


class BenchmarkSuite:
    """Predefined validation benchmarks."""

    @classmethod
    def get_all_benchmarks(cls) -> list[dict]:
        """Reference-shaped benchmark dicts (name/circuit/expected_nonzero/
        expected_fidelity_min)."""
        return [
            {
                "name": spec.name,
                "circuit": spec.build(),
                "expected_nonzero": (set(spec.expected_nonzero)
                                     if spec.expected_nonzero is not None
                                     else None),
                "expected_fidelity_min": spec.fidelity_min,
            }
            for spec in SPECS
        ]

    @classmethod
    def run_all(cls, noise_model: object | None = None,
                seed: int | None = None, device=None
                ) -> list[BenchmarkResult]:
        """Run every benchmark on ``device`` (default ``CONFIG.device``):
        timed ideal run (1024 shots, ending in the probabilities on the
        host), optional noisy-vs-ideal fidelity, TVD, expected-outcome
        check."""
        from .analysis import ConvergenceAnalysis, StateAnalysis
        from .simulator import Simulator

        rng = np.random.default_rng(seed)
        results: list[BenchmarkResult] = []

        for spec in SPECS:
            circuit = spec.build()

            child_rng = np.random.default_rng(rng.integers(0, 2**63))
            t0 = time.perf_counter()
            ideal = Simulator(device=device).run(circuit, shots=1024,
                                                 rng=child_rng)
            probs = ideal.final_state.probabilities
            runtime_ms = (time.perf_counter() - t0) * 1000

            if noise_model is not None:
                child_rng2 = np.random.default_rng(rng.integers(0, 2**63))
                noisy_state = Simulator(
                    noise_model=noise_model, device=device).run(
                        circuit, shots=0, rng=child_rng2).final_state
                fidelity = StateAnalysis.process_fidelity(
                    ideal.final_state, noisy_state)
            else:
                fidelity = 1.0

            tvd = ConvergenceAnalysis.tvd(probs, ideal.measurement_counts,
                                          ideal.num_shots)

            passed = fidelity >= spec.fidelity_min
            if spec.expected_nonzero is not None and not \
                    spec.expected_nonzero.issubset(ideal.measurement_counts):
                passed = False

            results.append(BenchmarkResult(
                name=spec.name,
                passed=passed,
                fidelity=fidelity,
                tvd=tvd,
                runtime_ms=runtime_ms,
                details=(f"Fidelity={fidelity:.6f}, TVD={tvd:.4f}, "
                         f"Time={runtime_ms:.1f}ms"),
            ))

        return results
