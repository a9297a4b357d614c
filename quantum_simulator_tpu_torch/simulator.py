"""Circuit execution: ``Simulator`` runs, ideal and noisy.

Counterpart of ``quantum_simulator_tpu/simulator.py``: compile the circuit
(``ops/program.compile_circuit``), run the group-plan executor on the
device (``ops/plan.py``, with the ``dense_axis`` and ``cross_bit_axis``
kernels), then sample Z/X/Y-basis counts (``measurement.py``), with
readout error wherever the JAX package applies it.

With a noise model, ``run`` follows one stochastic trajectory, and the
Monte-Carlo entry points (``trajectory_states``, ``run_with_noise``, the
ensemble density matrices) run T trajectories as batches: each batch is
one trajectory body whose every dense and cross step is one batched
kernel launch (``ops/program.batched_trajectories``). Batches are cut to
``TRAJECTORY_MEMORY_BYTES``, a budget on the card covering the batch's
states, results and batched operands (``_chunk_size``).

Not ported yet: ``monitored_trajectories`` (ROADMAP Queue 1, item 5b) and
noisy runs at the sizes where the JAX package takes its chunked huge-state
path, n >= 30 (item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generator, Iterator

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG
from .measurement import (MeasurementBasis, MeasurementEngine,
                          counts_from_array, sample_rows)
from .ops import program as prog
from .state import StateVector
from .utils.seeding import generator_from_rng

# Noisy runs stop below the JAX package's huge-state regime: its
# ``bigstate.auto_chunks`` chunks a planar state from n = 30 on.
NOISY_MAX_QUBITS = 29

# Device bytes a batch of trajectories or of parameter rows may take at
# its peak (states, results and batched operands): a fifth of an 80 GB
# card.
TRAJECTORY_MEMORY_BYTES = 16 * 2**30


@dataclass
class SimulationResult:
    """Result of a full simulation run."""

    final_state: StateVector
    measurement_counts: dict[str, int]
    step_states: list[StateVector] | None = None
    num_shots: int = 1024
    seed: int | None = None
    reference_state: StateVector | None = None


def _check_amplitude_cap(circuit: QuantumCircuit) -> None:
    if circuit.num_qubits > CONFIG.max_qubits:
        raise ValueError(
            f"num_qubits must be 1-{CONFIG.max_qubits} for amplitude "
            f"simulation, got {circuit.num_qubits}")


def _plan_operand_bytes(plan) -> int:
    """Bytes of one trajectory's operands if every one were its own:
    (re, im) float32 planes of each dense, cross and pair-diagonal step."""
    from .ops import plan as gplan

    sizes = plan.layout.axis_sizes
    total = 0
    for s in plan.steps:
        if isinstance(s, gplan.AxisMatmulStep):
            total += 8 * sizes[s.axis] ** 2
        elif isinstance(s, gplan.CrossStep):
            total += 32 * sizes[s.op_axis] ** 2
        elif isinstance(s, gplan.DiagPairStep):
            total += 8 * sizes[s.axis_a] * sizes[s.axis_b]
    return total


def _chunk_size(program, noise_model, n_traj: int) -> int:
    """Trajectories per batch: ``TRAJECTORY_MEMORY_BYTES`` over
    one trajectory's peak, which is its planar state and one state-sized
    temporary (basis sampling, reductions), its complex64 result, and
    four times its operands: the batched build holds the kron chains and
    compositions beside the finished operands (3.2x measured at n=16
    depth-40 on an H100, ``chip_smoke.py`` phase 4b)."""
    from .ops import plan as gplan

    route = prog.trajectory_route(program, noise_model)
    if route == "unitary":
        from .ops.unitary_traj import unitary_insert_spec

        ops = _plan_operand_bytes(gplan.get_group_plan(
            unitary_insert_spec(program, noise_model).aug))
    elif route == "monomial":
        from .ops.monomial_traj import monomial_spec

        ops = max(_plan_operand_bytes(gplan.get_group_plan(s))
                  for s in monomial_spec(program, noise_model).segments)
    else:
        ops = 32 * 128 ** 2   # one embedded cross operator per gate or draw
    per = 3 * (8 << program.num_qubits) + 4 * ops
    return max(1, min(n_traj, TRAJECTORY_MEMORY_BYTES // per))


def param_rows_per_batch(program, n_rows: int) -> int:
    """Parameter rows per batch of the variational path
    (``optimizer._device_costs``): ``TRAJECTORY_MEMORY_BYTES`` over one
    row's peak, which is five state-sized complex64 buffers (the grouped
    state, the complex result and the cost's temporaries, such as a
    flipped copy of the result and its product with the result) and four
    times its operands,
    every one of which may be its own (the kron chains and compositions
    of the batched build, as in ``_chunk_size``)."""
    from .ops import plan as gplan

    ops = _plan_operand_bytes(gplan.get_group_plan(program))
    per = 5 * (8 << program.num_qubits) + 4 * ops
    return max(1, min(n_rows, TRAJECTORY_MEMORY_BYTES // per))


class Simulator:
    """Runs a QuantumCircuit on ``device`` (default ``CONFIG.device``)."""

    def __init__(self, noise_model: object | None = None, device=None):
        self._noise_model = noise_model
        self._device = device or CONFIG.device

    @property
    def device(self):
        return self._device

    def _noisy(self) -> bool:
        return (self._noise_model is not None
                and self._noise_model.has_channels())

    def _readout_error(self):
        return getattr(self._noise_model, "readout_error", None)

    def _check_noisy_size(self, circuit: QuantumCircuit, what: str) -> None:
        if circuit.num_qubits > NOISY_MAX_QUBITS:
            raise NotImplementedError(
                f"{what} at n = {circuit.num_qubits} is not ported yet: the "
                f"chunked huge-state trajectory paths (n > "
                f"{NOISY_MAX_QUBITS}) are ROADMAP Queue 1 item 6")

    # ------------------------------------------------------------------
    # Core runs
    # ------------------------------------------------------------------

    def run(self, circuit: QuantumCircuit, shots: int = 1024,
            record_steps: bool = False,
            seed: int | None = None,
            rng: np.random.Generator | None = None,
            measurement_basis: MeasurementBasis = MeasurementBasis.Z
            ) -> SimulationResult:
        """Apply all gates, then sample. With noise channels this follows
        ONE stochastic trajectory (use ``run_with_noise`` for a trajectory
        per shot); ``record_steps`` keeps the state after each column."""
        _check_amplitude_cap(circuit)
        noisy = self._noisy()
        if noisy:
            self._check_noisy_size(circuit, "a noisy run")
        if record_steps:
            self._check_noisy_size(circuit, "record_steps")
        if rng is None:
            rng = np.random.default_rng(seed)
        n = circuit.num_qubits
        program = prog.compile_circuit(circuit)
        params = program.initial_params
        step_states = None
        if record_steps:
            if noisy:
                stacked = prog.trajectory_fn(
                    program, self._noise_model, self._device,
                    record_columns=True)(
                        params, generator_from_rng(rng, self._device))
            else:
                stacked = prog.steps_fn(program, self._device)(params)
            step_states = [StateVector.from_tensor(stacked[i], n)
                           for i in range(1, stacked.shape[0])]
            final_arr = stacked[-1]
        elif noisy:
            final_arr = prog.trajectory_fn(
                program, self._noise_model, self._device)(
                    params, generator_from_rng(rng, self._device))
        else:
            final_arr = prog.forward_fn(program, self._device)(params)
        final = StateVector.from_tensor(final_arr, n)

        has_measurement = any(g.gate_name == "Measure" for g in circuit.gates)
        if has_measurement or shots > 0:
            counts = MeasurementEngine.sample_with_basis(
                final, shots, basis=measurement_basis,
                readout_error=self._readout_error(), rng=rng)
        else:
            counts = {}
        return SimulationResult(final_state=final, measurement_counts=counts,
                                step_states=step_states, num_shots=shots,
                                seed=seed)

    def run_step_by_step(self, circuit: QuantumCircuit,
                         rng: np.random.Generator | None = None
                         ) -> Generator[tuple[StateVector, int], None, None]:
        """Yields (state, column_index), the initial state at -1; with
        noise, the columns of one stochastic trajectory."""
        _check_amplitude_cap(circuit)
        self._check_noisy_size(circuit, "run_step_by_step")
        program = prog.compile_circuit(circuit)
        params = program.initial_params
        if self._noisy():
            rng = rng or np.random.default_rng()
            stacked = prog.trajectory_fn(
                program, self._noise_model, self._device,
                record_columns=True)(
                    params, generator_from_rng(rng, self._device))
        else:
            stacked = prog.steps_fn(program, self._device)(params)
        for i in range(stacked.shape[0]):
            yield StateVector.from_tensor(stacked[i], circuit.num_qubits), \
                i - 1

    # ------------------------------------------------------------------
    # Monte-Carlo paths (batched on the device)
    # ------------------------------------------------------------------

    def _trajectory_batches(self, circuit: QuantumCircuit, n_traj: int,
                            rng: np.random.Generator
                            ) -> Iterator[torch.Tensor]:
        """(take, 2^n) complex64 states of consecutive batches of the
        ``n_traj`` trajectories; without channels, the ideal state
        repeated (``simulator.py:475-477``)."""
        _check_amplitude_cap(circuit)
        self._check_noisy_size(circuit, "noisy trajectories")
        program = prog.compile_circuit(circuit)
        params = program.initial_params
        if not self._noisy():
            state = prog.forward_fn(program, self._device)(params)
            chunk = max(1, min(n_traj, TRAJECTORY_MEMORY_BYTES
                               // (16 << circuit.num_qubits)))
            for start in range(0, n_traj, chunk):
                yield state.expand(min(chunk, n_traj - start), -1)
            return
        gen = generator_from_rng(rng, self._device)
        fn = prog.batched_trajectories_fn(program, self._noise_model,
                                          self._device)
        chunk = _chunk_size(program, self._noise_model, n_traj)
        for start in range(0, n_traj, chunk):
            yield fn(params, min(chunk, n_traj - start), gen)

    def trajectory_states(self, circuit: QuantumCircuit, n_trajectories: int,
                          seed: int | None = None,
                          rng: np.random.Generator | None = None
                          ) -> torch.Tensor:
        """(T, 2^n) complex64 final states of T stochastic trajectories on
        the device."""
        if rng is None:
            rng = np.random.default_rng(seed)
        out = None
        start = 0
        for states in self._trajectory_batches(circuit, n_trajectories, rng):
            if states.shape[0] == n_trajectories:
                return states
            if out is None:
                out = torch.empty((n_trajectories, states.shape[1]),
                                  dtype=states.dtype, device=states.device)
            out[start:start + states.shape[0]] = states
            start += states.shape[0]
        return out

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               final_shots: int | None = None):
        raise NotImplementedError(
            "monitored_trajectories is not ported yet: mid-circuit "
            "collapse (the monomial events path, program._monitored_body, "
            "apply.collapse_qubit) is ROADMAP Queue 1 item 5b")

    def run_with_noise(self, circuit: QuantumCircuit, shots: int = 1024,
                       seed: int | None = None,
                       rng: np.random.Generator | None = None,
                       trajectories: int | None = None
                       ) -> SimulationResult:
        """One stochastic trajectory per shot, each measured once, in
        batches on the device (``simulator.py:576-642``); with
        ``trajectories < shots``, T trajectories each sampled about
        shots / T times. Counts are readout-corrupted; ``final_state`` is
        the initial basis state, as in the reference."""
        _check_amplitude_cap(circuit)
        if self._noise_model is None:
            return self.run(circuit, shots, seed=seed, rng=rng)
        self._check_noisy_size(circuit, "run_with_noise")
        if rng is None:
            rng = np.random.default_rng(seed)
        T = shots if trajectories is None \
            else max(1, min(shots, trajectories))
        n = circuit.num_qubits
        dim = 1 << n
        counts = torch.zeros(dim, dtype=torch.long, device=self._device)
        gen = None
        base, extra = divmod(shots, T) if T else (0, 0)
        start = 0
        for states in self._trajectory_batches(circuit, T, rng):
            if gen is None:
                gen = generator_from_rng(rng, self._device)
            probs = states.real.square() + states.imag.square()
            probs = probs / probs.sum(-1, keepdim=True)
            take = base + (1 if extra else 0)
            if take:
                idx = sample_rows(probs, take, gen)
                rows = torch.arange(start, start + states.shape[0],
                                    device=idx.device)
                keep = (torch.arange(take, device=idx.device)[None, :]
                        < (base + (rows < extra).long())[:, None])
                counts += torch.bincount(idx[keep], minlength=dim)
            start += states.shape[0]
            del states, probs
        all_counts = counts_from_array(counts.cpu().numpy(), n)
        readout = self._readout_error()
        if all_counts and readout is not None:
            all_counts = readout.corrupt_counts(all_counts, rng)
        return SimulationResult(
            final_state=StateVector.from_initial_states(
                circuit.initial_states, device=self._device),
            measurement_counts=all_counts, num_shots=shots, seed=seed)

    def ensemble_density_matrix(self, circuit: QuantumCircuit,
                                n_trials: int = 50,
                                seed: int | None = None) -> np.ndarray:
        """rho = (1/N) sum_i |psi_i><psi_i| over N stochastic trajectories,
        accumulated batch by batch on the device; complex128 on the host."""
        rng = np.random.default_rng(seed)
        rho = None
        for states in self._trajectory_batches(circuit, n_trials, rng):
            part = torch.einsum("ti,tj->ij", states, states.conj())
            rho = part if rho is None else rho + part
        return (rho / n_trials).cpu().numpy().astype(np.complex128)

    def ensemble_qubit_density_matrices(self, circuit: QuantumCircuit,
                                        n_trials: int = 50,
                                        seed: int | None = None
                                        ) -> np.ndarray:
        """(n, 2, 2) ensemble-averaged single-qubit reduced density
        matrices over N stochastic trajectories, complex128 on the host."""
        rng = np.random.default_rng(seed)
        n = circuit.num_qubits
        acc = torch.zeros((n, 2, 2), dtype=torch.complex64,
                          device=self._device)
        for states in self._trajectory_batches(circuit, n_trials, rng):
            t = states.shape[0]
            for q in range(n):
                s4 = states.reshape(t, 1 << q, 2, -1)
                acc[q] += torch.einsum("tapb,taqb->pq", s4, s4.conj())
        return (acc / n_trials).cpu().numpy().astype(np.complex128)
