"""Side-by-side circuit comparison: resources, fidelity, distributions.

Counterpart of ``quantum_simulator_tpu/comparison.py``: ``CircuitMetrics``
fields, the noisy path through ``run_with_noise`` with separate ideal
states, NaN output fidelity on a qubit-count mismatch, TVD and both KL
directions with epsilon smoothing, and a JSON report with a NumPy-safe
encoder. Runs on the port's ``Simulator`` on ``device``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np

from .analysis import StateAnalysis
from .circuit import QuantumCircuit
from .gates import GateType
from .registry import GateRegistry
from .simulator import SimulationResult, Simulator


@dataclass
class CircuitMetrics:
    """Resource metrics for a single circuit."""

    gate_count: int = 0
    depth: int = 0
    single_qubit_gates: int = 0
    multi_qubit_gates: int = 0
    num_qubits: int = 0
    parameterized_gates: int = 0
    measurement_gates: int = 0


@dataclass
class ComparisonResult:
    """Complete comparison between two circuits."""

    metrics_a: CircuitMetrics
    metrics_b: CircuitMetrics
    result_a: SimulationResult
    result_b: SimulationResult
    output_fidelity: float
    distribution_tvd: float
    distribution_kl_ab: float
    distribution_kl_ba: float
    entropy_a: float
    entropy_b: float
    purity_a: float
    purity_b: float


def _counts_to_probs(counts: dict[str, int], dim: int,
                     shots: int) -> np.ndarray:
    from .analysis import counts_to_array

    num_qubits = max(1, dim.bit_length() - 1)
    return counts_to_array(counts, num_qubits) / shots


class CircuitComparator:
    """Compare two circuits on resources, output fidelity, distributions;
    the runs go to ``device`` (default ``CONFIG.device``)."""

    def __init__(self, device=None):
        self._device = device

    def compute_metrics(self, circuit: QuantumCircuit) -> CircuitMetrics:
        registry = GateRegistry.instance()  # live lookup: reset()-safe
        m = CircuitMetrics(num_qubits=circuit.num_qubits)
        for gate in circuit.gates:
            # unknown gates raise: silently skipping them used to report
            # resource metrics missing every unregistered gate while the
            # simulator crashed on the same circuit
            gate_def = registry.get(gate.gate_name)
            if gate_def.gate_type == GateType.MEASUREMENT:
                m.measurement_gates += 1
                continue
            if gate_def.gate_type == GateType.BARRIER:
                continue
            m.gate_count += 1
            if gate_def.num_qubits <= 1:
                m.single_qubit_gates += 1
            else:
                m.multi_qubit_gates += 1
            if gate_def.num_params > 0:
                m.parameterized_gates += 1
        m.depth = circuit.get_column_count()
        return m

    def compare(self, circuit_a: QuantumCircuit, circuit_b: QuantumCircuit,
                shots: int = 1024, noise_model=None,
                seed: int | None = None) -> ComparisonResult:
        """Run both circuits (noisy path samples per-shot trajectories and
        keeps separate noiseless states for fidelity/entropy/purity)."""
        rng = np.random.default_rng(seed)
        metrics_a = self.compute_metrics(circuit_a)
        metrics_b = self.compute_metrics(circuit_b)

        sim = Simulator(noise_model=noise_model, device=self._device)
        seed_a = int(rng.integers(0, 2**63))
        seed_b = int(rng.integers(0, 2**63))

        if noise_model is not None:
            result_a = sim.run_with_noise(circuit_a, shots=shots, seed=seed_a)
            result_b = sim.run_with_noise(circuit_b, shots=shots, seed=seed_b)
            ideal_sim = Simulator(device=self._device)
            state_a = ideal_sim.run(circuit_a, shots=0,
                                    seed=seed_a).final_state
            state_b = ideal_sim.run(circuit_b, shots=0,
                                    seed=seed_b).final_state
        else:
            result_a = sim.run(circuit_a, shots=shots, seed=seed_a)
            result_b = sim.run(circuit_b, shots=shots, seed=seed_b)
            state_a = result_a.final_state
            state_b = result_b.final_state

        if circuit_a.num_qubits == circuit_b.num_qubits:
            output_fidelity = StateAnalysis.process_fidelity(state_a, state_b)
        else:
            output_fidelity = float("nan")

        dim = 2 ** max(circuit_a.num_qubits, circuit_b.num_qubits)
        prob_a = _counts_to_probs(result_a.measurement_counts, dim, shots)
        prob_b = _counts_to_probs(result_b.measurement_counts, dim, shots)

        tvd = 0.5 * float(np.abs(prob_a - prob_b).sum())
        eps = 1e-10

        def _kl(p, q):
            mask = p > eps
            return float(np.sum(p[mask] * np.log2(p[mask] / (q[mask] + eps))))

        kl_ab = _kl(prob_a, prob_b)
        kl_ba = _kl(prob_b, prob_a)

        return ComparisonResult(
            metrics_a=metrics_a,
            metrics_b=metrics_b,
            result_a=result_a,
            result_b=result_b,
            output_fidelity=output_fidelity,
            distribution_tvd=tvd,
            distribution_kl_ab=max(0.0, kl_ab),
            distribution_kl_ba=max(0.0, kl_ba),
            entropy_a=StateAnalysis.von_neumann_entropy(state_a),
            entropy_b=StateAnalysis.von_neumann_entropy(state_b),
            purity_a=StateAnalysis.purity(state_a),
            purity_b=StateAnalysis.purity(state_b),
        )

    @staticmethod
    def export_report(result: ComparisonResult, filepath: str) -> None:
        """JSON report with a NumPy-safe encoder."""
        data = {
            "metrics_a": asdict(result.metrics_a),
            "metrics_b": asdict(result.metrics_b),
            "output_fidelity": result.output_fidelity,
            "distribution_tvd": result.distribution_tvd,
            "distribution_kl_ab": result.distribution_kl_ab,
            "distribution_kl_ba": result.distribution_kl_ba,
            "entropy_a": result.entropy_a,
            "entropy_b": result.entropy_b,
            "purity_a": result.purity_a,
            "purity_b": result.purity_b,
            "counts_a": result.result_a.measurement_counts,
            "counts_b": result.result_b.measurement_counts,
            "shots_a": result.result_a.num_shots,
            "shots_b": result.result_b.num_shots,
        }

        def _default(obj):
            if isinstance(obj, np.integer):
                return int(obj)
            if isinstance(obj, np.floating):
                return float(obj)
            if isinstance(obj, np.ndarray):
                return obj.tolist()
            raise TypeError(f"Not serializable: {type(obj)}")

        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, default=_default)
