"""Circuit execution: ``Simulator.run`` for ideal circuits.

Counterpart of ``quantum_simulator_tpu/simulator.py:41-207``: compile the
circuit (``ops/program.compile_circuit``), run the group-plan executor on
the device (``ops/plan.py``, with the ``dense_axis`` and ``cross_bit_axis``
kernels), then sample Z/X/Y-basis counts (``measurement.py``). Noise,
step recording and the n >= 30 chunked path come with later modules of
the port (ROADMAP Queue 1, items 5 and 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .circuit import QuantumCircuit
from .config import CONFIG
from .measurement import MeasurementBasis, MeasurementEngine
from .ops import program as prog
from .state import StateVector

_NOT_YET = ("is not ported yet: noise and trajectories are ROADMAP "
            "Queue 1 item 5")


@dataclass
class SimulationResult:
    """Result of a full simulation run."""

    final_state: StateVector
    measurement_counts: dict[str, int]
    step_states: list[StateVector] | None = None
    num_shots: int = 1024
    seed: int | None = None
    reference_state: StateVector | None = None


class Simulator:
    """Runs a QuantumCircuit on ``device`` (default ``CONFIG.device``)."""

    def __init__(self, noise_model: object | None = None, device=None):
        if noise_model is not None and (
                noise_model.has_channels()
                or getattr(noise_model, "readout_error", None) is not None):
            raise NotImplementedError(f"a noise model {_NOT_YET}")
        self._device = device or CONFIG.device

    @property
    def device(self):
        return self._device

    def run(self, circuit: QuantumCircuit, shots: int = 1024,
            record_steps: bool = False,
            seed: int | None = None,
            rng: np.random.Generator | None = None,
            measurement_basis: MeasurementBasis = MeasurementBasis.Z
            ) -> SimulationResult:
        """Apply all gates through the group executor, then sample."""
        if record_steps:
            raise NotImplementedError(f"record_steps {_NOT_YET}")
        if circuit.num_qubits > CONFIG.max_qubits:
            raise ValueError(
                f"num_qubits must be 1-{CONFIG.max_qubits} for amplitude "
                f"simulation, got {circuit.num_qubits}")
        if rng is None:
            rng = np.random.default_rng(seed)

        program = prog.compile_circuit(circuit)
        final_arr = prog.forward_fn(program, self._device)(
            program.initial_params)
        final = StateVector.from_tensor(final_arr, circuit.num_qubits)

        has_measurement = any(g.gate_name == "Measure" for g in circuit.gates)
        if has_measurement or shots > 0:
            counts = MeasurementEngine.sample_with_basis(
                final, shots, basis=measurement_basis, rng=rng)
        else:
            counts = {}
        return SimulationResult(final_state=final, measurement_counts=counts,
                                num_shots=shots, seed=seed)
