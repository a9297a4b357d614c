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

``monitored_trajectories`` collapses mid-circuit ``Measure`` gates, in
batches through the monomial splice wherever the noise allows it.

From n = 30 on (``ops/bigstate.HUGE_MIN_QUBITS``) a state is never copied
into complex form: ``run`` returns a ``PlanarStateVector`` over the
executor's grouped tensor (float32 planes, float64 under
``enable_complex128``) and samples it with the two-level
sampler, ``run_step_by_step`` yields ``MarginalStateSummary`` snapshots,
``run_with_noise`` returns counts with ``final_state=None``, and
``monitored_trajectories`` returns count dicts in place of states. What
would keep a state per column or per trajectory there is refused with a
``ValueError`` before anything is allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generator, Iterator

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG, require_width
from .gates import GateType
from .measurement import (MeasurementBasis, MeasurementEngine,
                          counts_from_array, sample_rows)
from .ops import bigstate
from .ops import program as prog
from .ops.bigstate import (MarginalStateSummary, PlanarStateVector,
                           indices_to_counts)
from .registry import GateRegistry
from .state import StateVector
from .utils.profiling import gauge, span
from .utils.seeding import generator_from_rng

# Device bytes a batch of trajectories or of parameter rows may take at
# its peak (states, results and batched operands): a fifth of an 80 GB
# card.
TRAJECTORY_MEMORY_BYTES = 16 * 2**30


@dataclass
class SimulationResult:
    """Result of a full simulation run."""

    final_state: StateVector | PlanarStateVector | None
    measurement_counts: dict[str, int]
    step_states: list[StateVector] | None = None
    num_shots: int = 1024
    seed: int | None = None
    reference_state: StateVector | None = None


def _is_huge(circuit: QuantumCircuit) -> bool:
    """The one routing predicate of the n >= 30 regime, shared by ``run``
    and by the guards of what keeps whole states."""
    return bigstate.is_huge(circuit.num_qubits)


def _check_amplitude_cap(circuit: QuantumCircuit) -> None:
    if circuit.num_qubits > CONFIG.max_qubits:
        raise ValueError(
            f"num_qubits must be 1-{CONFIG.max_qubits} for amplitude "
            f"simulation, got {circuit.num_qubits}")
    require_width(circuit.num_qubits, "Simulator")


def _plan_operand_bytes(plan) -> int:
    """Bytes of one trajectory's operands if every one were its own:
    (re, im) planes of each dense, cross and pair-diagonal step."""
    from .ops import plan as gplan

    sizes = plan.layout.axis_sizes
    total = 0
    for s in plan.steps:
        if isinstance(s, gplan.AxisMatmulStep):
            total += sizes[s.axis] ** 2
        elif isinstance(s, gplan.CrossStep):
            total += 4 * sizes[s.op_axis] ** 2
        elif isinstance(s, gplan.DiagPairStep):
            total += sizes[s.axis_a] * sizes[s.axis_b]
    return total * CONFIG.dtype.itemsize


def _chunk_size(program, noise_model, n_traj: int) -> int:
    """Trajectories per batch: ``TRAJECTORY_MEMORY_BYTES`` over
    one trajectory's peak, which is its planar state and one state-sized
    temporary (basis sampling, reductions), its complex result (8 bytes
    an amplitude, 16 under ``enable_complex128``), and
    four times its operands: the batched build holds the kron chains and
    compositions beside the finished operands (3.2x, measured at n=16
    depth-40 on an H100). Its regime ends at n = 29, where it has long
    returned 1 (a planar n = 28 trajectory already reckons 6 GiB): the
    n >= 30 paths run one trajectory at a time on one grouped state and do
    not come here."""
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
        # one embedded cross operator per gate or draw
        ops = 4 * 128 ** 2 * CONFIG.dtype.itemsize
    per = 3 * (CONFIG.dtype.itemsize << program.num_qubits) + 4 * ops
    chunk = max(1, min(n_traj, TRAJECTORY_MEMORY_BYTES // per))
    gauge("traj.batch_bytes_reckoned", chunk * per)
    return chunk


def param_rows_per_batch(program, n_rows: int) -> int:
    """Parameter rows per batch of the variational path
    (``optimizer._device_costs``): ``TRAJECTORY_MEMORY_BYTES`` over one
    row's peak, which is five state-sized complex buffers (the grouped
    state, the complex result and the cost's temporaries, such as a
    flipped copy of the result and its product with the result) and four
    times its operands,
    every one of which may be its own (the kron chains and compositions
    of the batched build, as in ``_chunk_size``)."""
    from .ops import plan as gplan

    ops = _plan_operand_bytes(gplan.get_group_plan(program))
    per = 5 * (CONFIG.dtype.itemsize << program.num_qubits) + 4 * ops
    return max(1, min(n_rows, TRAJECTORY_MEMORY_BYTES // per))


def record_rows_per_batch(program, n_traj: int) -> int:
    """Trajectories per batch of a column-recording run (the debugger's
    trials): ``TRAJECTORY_MEMORY_BYTES`` over one trajectory's peak, which
    is its ``columns + 1`` complex snapshots and four state-sized
    buffers: the planar state, and the permuted and conjugated copies that
    the reduced density matrices take (of the state in the body, of one
    column in the reductions)."""
    per = (program.num_columns + 5) * (CONFIG.dtype.itemsize
                                       << program.num_qubits)
    return max(1, min(n_traj, TRAJECTORY_MEMORY_BYTES // per))


def run_batched_trajectories(traj_fn, params, uniforms: torch.Tensor,
                             row_shape: tuple, chunk: int) -> torch.Tensor:
    """``(T, *row_shape)`` ``CONFIG.dtype`` results of a batched trajectory
    function ``traj_fn(params, uniforms, out=...)`` (``program.
    batched_trajectories_fn(..., record_columns=True)``) over the ``T``
    rows of ``uniforms`` (``simulator.py:77-104``), in batches of
    ``chunk`` rows, each written into its rows of one result allocated up
    front: the peak is the result plus one batch's temporaries. The rows
    carry the draws, so the result does not depend on ``chunk``."""
    T = uniforms.shape[0]
    out = torch.empty((T,) + tuple(row_shape), dtype=CONFIG.dtype,
                      device=uniforms.device)
    for start in range(0, T, chunk):
        stop = min(T, start + chunk)
        traj_fn(params, uniforms[start:stop], out=out[start:stop])
    return out


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

    @staticmethod
    def _reject_huge(circuit: QuantumCircuit, what: str) -> None:
        """A state per column or per trajectory is a whole complex buffer
        each: refused at n >= 30, before anything is allocated."""
        if _is_huge(circuit):
            raise ValueError(
                f"{what} retains whole-state complex buffers and cannot "
                f"fit a {circuit.num_qubits}-qubit state on one chip; "
                "use Simulator.run (chunked huge-state path) or the "
                "sharded engine (quantum_simulator_tpu_torch.parallel."
                "DistributedSimulator)")

    def _generator(self, rng: np.random.Generator) -> torch.Generator:
        return generator_from_rng(rng, self._device)

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
        per shot); ``record_steps`` keeps the state after each column.
        At n >= 30 ``final_state`` is a ``PlanarStateVector``."""
        with span("simulator.run"):
            _check_amplitude_cap(circuit)
            if rng is None:
                rng = np.random.default_rng(seed)
            if _is_huge(circuit):
                return self._run_huge(circuit, shots, record_steps, seed, rng,
                                      measurement_basis)
            noisy = self._noisy()
            n = circuit.num_qubits
            program = prog.compile_circuit(circuit)
            params = program.initial_params
            step_states = None
            if record_steps:
                if noisy:
                    stacked = prog.trajectory_fn(
                        program, self._noise_model, self._device,
                        record_columns=True)(params, self._generator(rng))
                else:
                    stacked = prog.steps_fn(program, self._device)(params)
                step_states = [StateVector.from_tensor(stacked[i], n)
                               for i in range(1, stacked.shape[0])]
                final_arr = stacked[-1]
            elif noisy:
                final_arr = prog.trajectory_fn(
                    program, self._noise_model, self._device)(
                        params, self._generator(rng))
            else:
                final_arr = prog.forward_fn(program, self._device)(params)
            final = StateVector.from_tensor(final_arr, n)

            has_measurement = any(g.gate_name == "Measure"
                                  for g in circuit.gates)
            if has_measurement or shots > 0:
                counts = MeasurementEngine.sample_with_basis(
                    final, shots, basis=measurement_basis,
                    readout_error=self._readout_error(), rng=rng)
            else:
                counts = {}
            return SimulationResult(final_state=final,
                                    measurement_counts=counts,
                                    step_states=step_states, num_shots=shots,
                                    seed=seed)

    def _run_huge(self, circuit: QuantumCircuit, shots: int,
                  record_steps: bool, seed: int | None,
                  rng: np.random.Generator,
                  measurement_basis: MeasurementBasis) -> SimulationResult:
        """The n >= 30 path (``simulator.py:209-299``): the executor's
        grouped state as it is, the two-level sampler, a
        ``PlanarStateVector`` result. An X or Y basis is sampled first, on
        a run of the circuit with the rotation gates appended, and that
        state freed before the final state is made."""
        from .ops.plan import group_forward_state_body

        if record_steps:
            raise ValueError(
                f"record_steps would retain one {circuit.num_qubits}-qubit "
                "state per column; not supported on the single-chip "
                "huge-state path (run_step_by_step yields marginal "
                "snapshots instead).")
        program = prog.compile_circuit(circuit)
        if self._noisy():
            return self._run_huge_noisy(circuit, program, shots, seed, rng,
                                        measurement_basis)
        n = circuit.num_qubits

        def forward(p):
            return group_forward_state_body(p, p.initial_params,
                                            self._device)

        counts: dict[str, int] = {}
        if shots > 0 and measurement_basis != MeasurementBasis.Z:
            rotated = circuit.copy()
            col = rotated.get_column_count()
            for q in range(n):
                if measurement_basis == MeasurementBasis.Y:
                    rotated.add("S_DAG", [q], [], col)
                    rotated.add("H", [q], [], col + 1)
                else:
                    rotated.add("H", [q], [], col)
            xs, rplanar = forward(prog.compile_circuit(rotated))
            counts = indices_to_counts(bigstate.sample_state_indices(
                xs, shots, rplanar, self._generator(rng)), n)
            del xs
        x, planar = forward(program)
        if shots > 0 and measurement_basis == MeasurementBasis.Z:
            counts = indices_to_counts(bigstate.sample_state_indices(
                x, shots, planar, self._generator(rng)), n)
        final = PlanarStateVector(
            x, n, planar=planar,
            axis_marginals=bigstate.state_axis_marginals(x, planar))
        readout = self._readout_error()
        if counts and readout is not None:
            # shot mode works on the sparse counts; the distribution
            # transform would need the dense 2^n vector
            counts = readout.corrupt_counts(counts, rng)
        return SimulationResult(final_state=final, measurement_counts=counts,
                                step_states=None, num_shots=shots, seed=seed)

    def _run_huge_noisy(self, circuit: QuantumCircuit, program, shots: int,
                        seed: int | None, rng: np.random.Generator,
                        measurement_basis: MeasurementBasis
                        ) -> SimulationResult:
        """One stochastic trajectory at n >= 30 (``simulator.py:301-354``)
        through the splice or fold evolution of ``ops/bigtraj.py``. An X
        or Y basis is sampled on the rotated state first; the same draws
        then give the unrotated state."""
        from .ops.bigtraj import huge_trajectory_sample_fn

        params = program.initial_params
        traj_gen = self._generator(rng)
        sample_gen = self._generator(rng)
        basis = measurement_basis.name
        n = circuit.num_qubits
        nm = self._noise_model
        counts: dict[str, int] = {}
        draws = None
        if shots > 0 and basis != "Z":
            fn, _ = huge_trajectory_sample_fn(program, nm, shots,
                                              self._device, basis=basis)
            out = fn(params, traj_gen, sample_gen)
            counts = indices_to_counts(out.indices, n)
            draws = out.draws
            del out
            shots_z = 0
        else:
            shots_z = shots
        fn, planar = huge_trajectory_sample_fn(program, nm, shots_z,
                                               self._device, keep_state=True)
        out = fn(params, traj_gen, sample_gen, draws)
        if out.indices is not None:
            counts = indices_to_counts(out.indices, n)
        readout = self._readout_error()
        if counts and readout is not None:
            counts = readout.corrupt_counts(counts, rng)
        final = PlanarStateVector(out.state, n, planar=planar,
                                  axis_marginals=out.marginals)
        return SimulationResult(final_state=final, measurement_counts=counts,
                                step_states=None, num_shots=shots, seed=seed)

    def run_step_by_step(self, circuit: QuantumCircuit,
                         rng: np.random.Generator | None = None
                         ) -> Generator[tuple[StateVector, int], None, None]:
        """Yields (state, column_index), the initial state at -1; with
        noise, the columns of one stochastic trajectory. At n >= 30 the
        snapshots are ``MarginalStateSummary`` objects (per-axis
        probability marginals, hence per-qubit P(1)): the state evolves in
        place and only the marginals leave the device."""
        _check_amplitude_cap(circuit)
        if _is_huge(circuit):
            if self._noisy():
                raise ValueError(
                    "step-by-step with noise retains per-column "
                    "trajectory state; at n >= 30 use Simulator.run "
                    "(single noisy trajectory) or run_with_noise")
            program = prog.compile_circuit(circuit)
            fn, _ = bigstate.huge_step_marginals_fn(program, self._device)
            for i, marg in enumerate(fn(program.initial_params)):
                yield MarginalStateSummary(marg, circuit.num_qubits), i - 1
            return
        program = prog.compile_circuit(circuit)
        params = program.initial_params
        if self._noisy():
            rng = rng or np.random.default_rng()
            stacked = prog.trajectory_fn(
                program, self._noise_model, self._device,
                record_columns=True)(params, self._generator(rng))
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
        """(take, 2^n) ``CONFIG.dtype`` states of consecutive batches of the
        ``n_traj`` trajectories; without channels, the ideal state
        repeated (``simulator.py:475-477``)."""
        _check_amplitude_cap(circuit)
        self._reject_huge(circuit, "trajectory_states")
        program = prog.compile_circuit(circuit)
        params = program.initial_params
        if not self._noisy():
            state = prog.forward_fn(program, self._device)(params)
            chunk = max(1, min(n_traj, TRAJECTORY_MEMORY_BYTES
                               // (2 * CONFIG.dtype.itemsize
                                   << circuit.num_qubits)))
            for start in range(0, n_traj, chunk):
                yield state.expand(min(chunk, n_traj - start), -1)
            return
        gen = self._generator(rng)
        fn = prog.batched_trajectories_fn(program, self._noise_model,
                                          self._device)
        chunk = _chunk_size(program, self._noise_model, n_traj)
        for start in range(0, n_traj, chunk):
            yield fn(params, min(chunk, n_traj - start), gen)

    def trajectory_states(self, circuit: QuantumCircuit, n_trajectories: int,
                          seed: int | None = None,
                          rng: np.random.Generator | None = None
                          ) -> torch.Tensor:
        """(T, 2^n) ``CONFIG.dtype`` final states of T stochastic
        trajectories on the device."""
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
        """T independent monitored trajectories: ``Measure`` gates
        collapse mid-circuit (projective draw and renormalization) instead
        of being skipped, with this simulator's noise channels between
        them (``simulator.py:484-574``). Returns ``(outcomes (T, M) int
        array in Measure column order, sites [(column, qubit)] * M, a list
        of T final StateVectors)``.

        The collapses run as spliced projectors through the group plan, in
        batches with one kernel launch per dense and cross step, whenever
        the noise channels are monomial; other channels take the per-gate
        body below n = 19. At n >= 30 the third element is a list of T
        Z-basis count dicts of ``final_shots`` shots each (``[]`` without
        ``final_shots``), and noise must be monomial; ``final_shots`` is
        rejected below n = 30, where the returned states carry the
        amplitudes."""
        _check_amplitude_cap(circuit)
        if final_shots is not None and not _is_huge(circuit):
            raise ValueError(
                "final_shots is the n >= 30 replacement for returned "
                "states; below the huge threshold sample the returned "
                "StateVectors instead")
        program = prog.compile_circuit(circuit)
        registry = GateRegistry.instance()
        events: list[tuple[int, int]] = []
        sites: list[tuple[int, int]] = []
        pos = 0
        for column in circuit.get_ordered_gates():
            for gate in column:
                gtype = registry.get(gate.gate_name).gate_type
                if gtype == GateType.MEASUREMENT:
                    events.append((pos, gate.target_qubits[0]))
                    sites.append((gate.column, gate.target_qubits[0]))
                elif gtype != GateType.BARRIER:
                    pos += 1
        noise = self._noise_model if self._noisy() else None
        if _is_huge(circuit):
            return self._monitored_huge(circuit, program, noise,
                                        tuple(events), sites,
                                        n_trajectories, seed,
                                        final_shots or 0)
        rng = np.random.default_rng(seed)
        gen = self._generator(rng)
        params = program.initial_params
        chunk = _chunk_size(program, noise or prog._NoNoise, n_trajectories)
        n = circuit.num_qubits
        states_out: list[StateVector] = []
        outs_parts: list[np.ndarray] = []
        for start in range(0, n_trajectories, chunk):
            take = min(chunk, n_trajectories - start)
            states, outs = prog.monitored_trajectories(
                program, noise, events, params, take, self._device, gen)
            outs_parts.append(outs.cpu().numpy())
            states_out.extend(StateVector.from_tensor(states[i], n)
                              for i in range(take))
        outcomes = (np.concatenate(outs_parts, axis=0) if outs_parts
                    else np.zeros((0, len(events)), np.int64))
        return outcomes, sites, states_out

    def _monitored_huge(self, circuit: QuantumCircuit, program, noise,
                        events: tuple, sites, n_trajectories: int,
                        seed: int | None, final_shots: int):
        """n >= 30 monitored trajectories, one at a time
        (``simulator.py:356-391``): collapse through the monomial splice,
        then Z-basis sampling; only the outcomes and the shot indices
        leave the device. Third element: one counts dict per
        trajectory."""
        from .ops.bigtraj import huge_monitored_sample_fn
        from .ops.monomial_traj import monomial_monitored_evolve_ok

        nm = noise if noise is not None else prog._NoNoise
        if not monomial_monitored_evolve_ok(program, nm, events):
            raise ValueError(
                "huge (n >= 30) monitored trajectories need monomial "
                "noise channels (the reference family) or no noise; "
                "use MPSSimulator / CliffordSimulator monitored engines "
                "for other channels")
        fn, _ = huge_monitored_sample_fn(program, nm, events, final_shots,
                                         self._device)
        rng = np.random.default_rng(seed)
        params = program.initial_params
        outs_rows: list[np.ndarray] = []
        counts_list: list[dict[str, int]] = []
        for _ in range(n_trajectories):
            outs, idx = fn(params, self._generator(rng),
                           self._generator(rng))
            if idx is not None:
                counts_list.append(indices_to_counts(idx,
                                                     circuit.num_qubits))
            outs_rows.append(outs.cpu().numpy())
        return np.stack(outs_rows), sites, counts_list

    def run_with_noise(self, circuit: QuantumCircuit, shots: int = 1024,
                       seed: int | None = None,
                       rng: np.random.Generator | None = None,
                       trajectories: int | None = None
                       ) -> SimulationResult:
        """One stochastic trajectory per shot, each measured once, in
        batches on the device (``simulator.py:576-642``); with
        ``trajectories < shots``, T trajectories each sampled about
        shots / T times. Counts are readout-corrupted; ``final_state`` is
        the initial basis state, as in the reference. At n >= 30 one
        trajectory is a run of whole-state passes, so ``trajectories``
        defaults to ``min(shots, 16)`` there, and ``final_state`` is None
        (even the placeholder would be a state)."""
        with span("simulator.run_with_noise"):
            _check_amplitude_cap(circuit)
            if self._noise_model is None:
                return self.run(circuit, shots, seed=seed, rng=rng)
            if rng is None:
                rng = np.random.default_rng(seed)
            if _is_huge(circuit) and self._noisy():
                return self._run_with_noise_huge(circuit, shots, seed, rng,
                                                 trajectories)
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
                    gen = self._generator(rng)
                with span("traj.sample"):
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

    def _run_with_noise_huge(self, circuit: QuantumCircuit, shots: int,
                             seed: int | None, rng: np.random.Generator,
                             trajectories: int | None) -> SimulationResult:
        """n >= 30 (``simulator.py:644-687``): T trajectories one after
        the other, the shots spread over all of them (the first
        ``shots % T`` take one more); only shot indices leave the
        device. Each trajectory is one ``traj.huge`` span."""
        from .ops.bigtraj import huge_trajectory_sample_fn

        program = prog.compile_circuit(circuit)
        params = program.initial_params
        T = max(1, min(shots, trajectories or min(shots, 16)))
        base, extra = divmod(shots, T)
        all_idx: list[np.ndarray] = []
        for i in range(T if shots > 0 else 0):
            take = base + (1 if i < extra else 0)
            if take == 0:
                break
            fn, _ = huge_trajectory_sample_fn(program, self._noise_model,
                                              take, self._device)
            with span("traj.huge"):
                out = fn(params, self._generator(rng), self._generator(rng))
            all_idx.append(out.indices.cpu().numpy())
        counts: dict[str, int] = {}
        if all_idx:
            counts = indices_to_counts(torch.from_numpy(
                np.concatenate(all_idx)), circuit.num_qubits)
        readout = self._readout_error()
        if counts and readout is not None:
            counts = readout.corrupt_counts(counts, rng)
        return SimulationResult(final_state=None, measurement_counts=counts,
                                num_shots=shots, seed=seed)

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
        matrices over N stochastic trajectories, complex128 on the host;
        at n >= 30 from per-axis Gram reductions of one trajectory at a
        time (``simulator.py:723-742``)."""
        _check_amplitude_cap(circuit)
        rng = np.random.default_rng(seed)
        n = circuit.num_qubits
        if _is_huge(circuit):
            from .ops.bigtraj import (huge_trajectory_gram_fn,
                                      qubit_rhos_from_grams)

            nm = self._noise_model
            if not self._noisy():
                nm = prog._NoNoise   # a channel-free trajectory: the ideal run
                n_trials = 1
            program = prog.compile_circuit(circuit)
            fn, _ = huge_trajectory_gram_fn(program, nm, self._device)
            acc = np.zeros((n, 2, 2), np.complex128)
            for _ in range(n_trials):
                acc += qubit_rhos_from_grams(
                    fn(program.initial_params, self._generator(rng)), n)
            return acc / n_trials
        acc = torch.zeros((n, 2, 2), dtype=CONFIG.dtype,
                          device=self._device)
        for states in self._trajectory_batches(circuit, n_trials, rng):
            t = states.shape[0]
            for q in range(n):
                s4 = states.reshape(t, 1 << q, 2, -1)
                acc[q] += torch.einsum("tapb,taqb->pq", s4, s4.conj())
        return (acc / n_trials).cpu().numpy().astype(np.complex128)
