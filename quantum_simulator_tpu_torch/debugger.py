"""Circuit debugger: stepping, breakpoints, noise impact and attribution.

Counterpart of ``quantum_simulator_tpu/debugger.py``: a ``DebugSnapshot``
per column (the initial state at -1), forward / backward / goto stepping,
breakpoints, N-trial noise impact with per-qubit Uhlmann fidelities of
the reduced density matrices, noise attribution by fidelity-gap deltas
with recovery clamping and ``no_measurable_loss``, and the top-10 state
diff.

``run_full_debug`` takes the ideal column stack from ``program.steps_fn``
and a noisy one from ``program.trajectory_fn(..., record_columns=True)``:
both run the per-gate body ``plan.group_trajectory_body``, every gate and
every drawn Kraus operator one ``dense_axis`` or ``cross_bit_axis``
launch. The trial analyses run the same body on batches of trials, one
launch per gate and draw for the whole batch. The JAX package holds the
whole ``(T, C+1, 2^n)`` stack and reduces it; its only outputs are the
per-trial fidelities ``(T, C+1)`` and the mean single-qubit fidelities
``(C, n)``, so the port reduces batch by batch
(``simulator.record_rows_per_batch``) and its peak is one batch. Each
trial draws from its own row of uniforms (``plan.draw_uniforms``), so the
numbers do not depend on how the trials are cut into batches. The
per-qubit Uhlmann fidelity uses the exact 2x2 closed form in host
float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .analysis import StateAnalysis
from .circuit import QuantumCircuit
from .config import CONFIG
from .gates import GateType
from .ops import plan as gplan
from .ops import program as prog
from .ops.apply import reduced_density_matrix_1q
from .registry import GateRegistry
from .simulator import (Simulator, record_rows_per_batch,
                        run_batched_trajectories)
from .state import StateVector
from .utils.seeding import generator_from_rng


@dataclass
class DebugSnapshot:
    """State captured at a single execution point."""

    column_index: int  # -1 for initial state
    state: StateVector
    ideal_state: StateVector | None
    gate_labels: list[str]
    fidelity: float
    cumulative_fidelity: float
    entropy: float


@dataclass
class NoiseImpactResult:
    """Noise impact for a single gate column."""

    column_index: int
    gate_labels: list[str]
    fidelity_before: float
    fidelity_after: float
    fidelity_drop: float
    entropy_before: float
    entropy_after: float
    entropy_change: float
    per_qubit_fidelity: list[float]
    mean_delta_fidelity: float = 0.0
    std_delta_fidelity: float = 0.0


@dataclass
class NoiseAttribution:
    """Per-column noise attribution: contribution_i = gap_i - gap_{i-1}
    with gap = 1 - F(ideal, noisy). Negative deltas (recovery) keep their
    raw values but are clamped to zero for percentage normalization."""

    delta_fidelity: list[float]
    delta_fidelity_std: list[float]
    total_fidelity_loss: float
    column_attribution_pct: list[float]
    per_qubit_attribution: list[list[float]]
    gate_labels: list[list[str]]
    is_recovery: list[bool] = field(default_factory=list)
    no_measurable_loss: bool = False


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _pairwise_fidelity(ideal_steps: torch.Tensor,
                       noisy_steps: torch.Tensor) -> torch.Tensor:
    """|<ideal_c|noisy_{t,c}>|^2 -> (T, C+1): per column, an elementwise
    product with the conjugated ideal state and a sum, over a view of the
    stack (no permuted copy of it; a matrix-vector product over the
    strided view runs far below the card's memory rate)."""
    cols = [(noisy_steps[:, c] * ideal_steps[c].conj()).sum(-1)
            for c in range(ideal_steps.shape[0])]
    return torch.stack(cols, dim=1).abs().square()


def _all_1q_rdms_batch(states: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2^n) states (a view is fine) -> (B, n, 2, 2) single-qubit
    reduced density matrices, ``ops/apply.reduced_density_matrix_1q`` per
    qubit on a ``(B, 2^q, 2, 2^(n-q-1))`` view."""
    return torch.stack([reduced_density_matrix_1q(states, q, n)
                        for q in range(n)], dim=1)


def _uhlmann_2x2_batch(rho: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    """Exact Uhlmann fidelity for batches of 2x2 density matrices:
    F = tr(rho sigma) + 2 sqrt(det rho det sigma), after Hermitian/trace
    sanitization (float64 host math)."""

    def sanitize(m):
        m = (m + np.conj(np.swapaxes(m, -1, -2))) / 2
        tr = np.real(m[..., 0, 0] + m[..., 1, 1])
        tr = np.where(np.abs(tr) > 1e-15, tr, 1.0)
        return m / tr[..., None, None]

    rho = sanitize(np.asarray(rho, dtype=np.complex128))
    sigma = sanitize(np.asarray(sigma, dtype=np.complex128))
    tr_rs = np.real(np.einsum("...ij,...ji->...", rho, sigma))
    det_r = np.real(np.linalg.det(rho))
    det_s = np.real(np.linalg.det(sigma))
    f = tr_rs + 2 * np.sqrt(np.clip(det_r, 0, None)
                            * np.clip(det_s, 0, None))
    return np.clip(f, 0.0, 1.0)


def _host(x: torch.Tensor, dtype) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtype)


def _per_qubit_fidelity_sums(ideal_rdms: np.ndarray,
                             noisy_steps: torch.Tensor, n: int) -> np.ndarray:
    """(C, n) sums over the trials of a ``(t, C+1, 2^n)`` stack of the
    Uhlmann fidelity between each snapshot's single-qubit reduced density
    matrices and the ideal ones (``ideal_rdms``: (C, n, 2, 2)), column by
    column."""
    out = np.zeros(ideal_rdms.shape[:2])
    for c in range(1, noisy_steps.shape[1]):
        rdms = _host(_all_1q_rdms_batch(noisy_steps[:, c], n), np.complex128)
        out[c - 1] = _uhlmann_2x2_batch(
            np.broadcast_to(ideal_rdms[c - 1], rdms.shape), rdms).sum(axis=0)
    return out


# ---------------------------------------------------------------------------
# Debugger
# ---------------------------------------------------------------------------

class CircuitDebugger:
    """Caches per-column snapshots for stepping; batches trial analyses
    on ``device`` (default ``CONFIG.device``)."""

    def __init__(self, device=None):
        self._snapshots: list[DebugSnapshot] = []
        self._position: int = 0
        self._breakpoints: set[int] = set()
        self._registry = GateRegistry.instance()
        self._device = device or CONFIG.device

    # ---- label helper -----------------------------------------------------

    def _column_labels(self, circuit: QuantumCircuit) -> list[list[str]]:
        labels = []
        for column_gates in circuit.get_ordered_gates():
            col = []
            for g in column_gates:
                gd = self._registry.get(g.gate_name)
                if gd.gate_type not in (GateType.MEASUREMENT,
                                        GateType.BARRIER):
                    qstr = ",".join(str(q) for q in g.target_qubits)
                    col.append(f"{g.gate_name}({qstr})")
            labels.append(col)
        return labels

    # ---- full debug run ---------------------------------------------------

    def run_full_debug(self, circuit: QuantumCircuit, noise_model=None,
                       seed: int | None = None) -> list[DebugSnapshot]:
        """Execute once, caching state after every column (row 0 = initial):
        the ideal column stack and, with channels, one stochastic
        trajectory's, both through the per-gate body."""
        Simulator._reject_huge(circuit, "the debugger")
        rng = np.random.default_rng(seed)
        self._snapshots.clear()
        self._position = 0

        program = prog.compile_circuit(circuit)
        params = program.initial_params
        ideal_steps = prog.steps_fn(program, self._device)(params)

        noisy = noise_model is not None and noise_model.has_channels()
        if noisy:
            noisy_steps = prog.trajectory_fn(
                program, noise_model, self._device, record_columns=True)(
                    params, generator_from_rng(rng, self._device))
            fids = _host(_pairwise_fidelity(ideal_steps, noisy_steps[None])[0],
                         np.float64)
            cum = _host(_pairwise_fidelity(
                ideal_steps[0].expand_as(ideal_steps), noisy_steps[None])[0],
                np.float64)
        else:
            noisy_steps = ideal_steps

        labels = self._column_labels(circuit)
        n = circuit.num_qubits
        for i in range(ideal_steps.shape[0]):
            state = StateVector.from_tensor(noisy_steps[i], n)
            self._snapshots.append(DebugSnapshot(
                column_index=i - 1,
                state=state,
                ideal_state=StateVector.from_tensor(ideal_steps[i], n)
                if noisy else None,
                gate_labels=labels[i - 1] if i > 0 else [],
                fidelity=float(fids[i]) if noisy else 1.0,
                cumulative_fidelity=float(cum[i]) if noisy else 1.0,
                entropy=StateAnalysis.von_neumann_entropy(state),
            ))
        return self._snapshots

    # ---- stepping ----------------------------------------------------------

    @property
    def snapshots(self) -> list[DebugSnapshot]:
        return self._snapshots

    @property
    def position(self) -> int:
        return self._position

    @position.setter
    def position(self, value: int) -> None:
        if self._snapshots:
            self._position = max(0, min(value, len(self._snapshots) - 1))

    @property
    def current_snapshot(self) -> DebugSnapshot | None:
        return self._snapshots[self._position] if self._snapshots else None

    @property
    def num_steps(self) -> int:
        return len(self._snapshots)

    def step_forward(self) -> DebugSnapshot | None:
        if not self._snapshots or self._position >= len(self._snapshots) - 1:
            return None
        self._position += 1
        return self._snapshots[self._position]

    def step_backward(self) -> DebugSnapshot | None:
        if not self._snapshots or self._position <= 0:
            return None
        self._position -= 1
        return self._snapshots[self._position]

    def goto_step(self, step: int) -> DebugSnapshot | None:
        if not self._snapshots:
            return None
        self._position = max(0, min(step, len(self._snapshots) - 1))
        return self._snapshots[self._position]

    # ---- breakpoints --------------------------------------------------------

    def add_breakpoint(self, column: int) -> None:
        self._breakpoints.add(column)

    def remove_breakpoint(self, column: int) -> None:
        self._breakpoints.discard(column)

    def toggle_breakpoint(self, column: int) -> bool:
        if column in self._breakpoints:
            self._breakpoints.discard(column)
            return False
        self._breakpoints.add(column)
        return True

    @property
    def breakpoints(self) -> set[int]:
        return self._breakpoints

    def clear_breakpoints(self) -> None:
        self._breakpoints.clear()

    def run_to_breakpoint(self) -> DebugSnapshot | None:
        if not self._snapshots:
            return None
        for i in range(self._position + 1, len(self._snapshots)):
            if self._snapshots[i].column_index in self._breakpoints:
                self._position = i
                return self._snapshots[i]
        self._position = len(self._snapshots) - 1
        return self._snapshots[self._position]

    # ---- batched trial data -------------------------------------------------

    def _trials(self, circuit: QuantumCircuit, noise_model, n_trials: int,
                seed: int | None):
        """(program, ideal column stack (C+1, 2^n), the trials' uniforms
        (T, draws), the batched recording function)."""
        Simulator._reject_huge(circuit, "the debugger's trials")
        rng = np.random.default_rng(seed)
        program = prog.compile_circuit(circuit)
        ideal_steps = prog.steps_fn(program, self._device)(
            program.initial_params)
        uniforms = gplan.draw_uniforms(
            program, noise_model, n_trials, self._device,
            generator_from_rng(rng, self._device))
        fn = prog.batched_trajectories_fn(program, noise_model,
                                          self._device, record_columns=True)
        return program, ideal_steps, uniforms, fn

    def _trial_stacks(self, circuit: QuantumCircuit, noise_model,
                      n_trials: int, seed: int | None):
        """(ideal_steps (C+1, 2^n), noisy_steps (T, C+1, 2^n)) on the
        device: every trial's column stack, written batch by batch into
        one result (``simulator.run_batched_trajectories``)."""
        program, ideal_steps, uniforms, fn = self._trials(
            circuit, noise_model, n_trials, seed)
        noisy_steps = run_batched_trajectories(
            fn, program.initial_params, uniforms, tuple(ideal_steps.shape),
            record_rows_per_batch(program, n_trials))
        return ideal_steps, noisy_steps

    def _trial_reductions(self, circuit: QuantumCircuit, noise_model,
                          n_trials: int, seed: int | None):
        """``(fids (T, C+1), per_qubit (C, n))`` in float64: each trial's
        fidelity to the ideal state before the first and after every
        column, and the trial mean of the per-qubit Uhlmann fidelities
        after every column. Reduced batch by batch
        (``record_rows_per_batch`` trials each), so no more than one
        batch's stack exists at a time."""
        program, ideal_steps, uniforms, fn = self._trials(
            circuit, noise_model, n_trials, seed)
        n = circuit.num_qubits
        chunk = record_rows_per_batch(program, n_trials)
        ideal_rdms = _host(_all_1q_rdms_batch(ideal_steps[1:], n),
                           np.complex128)
        fids = np.empty((n_trials, ideal_steps.shape[0]))
        pq_sum = np.zeros((ideal_steps.shape[0] - 1, n))
        for start in range(0, n_trials, chunk):
            stop = min(n_trials, start + chunk)
            stack = fn(program.initial_params, uniforms[start:stop])
            fids[start:stop] = _host(_pairwise_fidelity(ideal_steps, stack),
                                     np.float64)
            pq_sum += _per_qubit_fidelity_sums(ideal_rdms, stack, n)
            del stack
        return fids, pq_sum / n_trials

    # ---- noise impact ---------------------------------------------------------

    def compute_noise_impact(self, circuit: QuantumCircuit, noise_model,
                             n_trials: int = 50,
                             seed: int | None = None
                             ) -> list[NoiseImpactResult]:
        """Per-column fidelity drop, averaged over n_trials batched runs."""
        if noise_model is None:
            return []
        fids, pq_fid = self._trial_reductions(circuit, noise_model,
                                              n_trials, seed)
        fb = fids[:, :-1]   # before each column
        fa = fids[:, 1:]    # after each column
        drops = fb - fa
        labels = self._column_labels(circuit)

        # Pure-state trajectories have zero von Neumann entropy; the
        # reference reports the same (its states are pure per trial).
        results = []
        for c in range(fa.shape[1]):
            results.append(NoiseImpactResult(
                column_index=c,
                gate_labels=labels[c],
                fidelity_before=float(fb[:, c].mean()),
                fidelity_after=float(fa[:, c].mean()),
                fidelity_drop=float(drops[:, c].mean()),
                entropy_before=0.0,
                entropy_after=0.0,
                entropy_change=0.0,
                per_qubit_fidelity=pq_fid[c].tolist(),
                mean_delta_fidelity=float(drops[:, c].mean()),
                std_delta_fidelity=float(drops[:, c].std()),
            ))
        return results

    # ---- noise attribution -----------------------------------------------------

    def compute_noise_attribution(self, circuit: QuantumCircuit, noise_model,
                                  reference_state: StateVector | None = None,
                                  n_trials: int = 50,
                                  seed: int | None = None
                                  ) -> NoiseAttribution:
        """contribution_i = gap_i - gap_{i-1}, gap = 1 - F(ideal, noisy)."""
        fids, pq_fid = self._trial_reductions(circuit, noise_model,
                                              n_trials, seed)
        gaps = 1.0 - fids
        contribs = gaps[:, 1:] - gaps[:, :-1]  # (T, C)
        pq_attr = (1.0 - pq_fid).tolist()

        mean_contrib = contribs.mean(axis=0).tolist()
        std_contrib = contribs.std(axis=0).tolist()
        total_loss = float(np.sum(mean_contrib))
        # The reference uses 1e-12 epsilons (complex128 compute,
        # ``debugger.py:455-460``); complex64 device states carry ~1e-7
        # fidelity noise, so the measurable-loss floor sits at 1e-6 here.
        is_recovery = [d < -1e-6 for d in mean_contrib]
        positive_sum = sum(max(0.0, d) for d in mean_contrib)
        no_loss = positive_sum <= 1e-6
        attr_pct = ([max(0.0, d) / positive_sum * 100.0
                     for d in mean_contrib]
                    if not no_loss else [0.0] * len(mean_contrib))

        return NoiseAttribution(
            delta_fidelity=mean_contrib,
            delta_fidelity_std=std_contrib,
            total_fidelity_loss=total_loss,
            column_attribution_pct=attr_pct,
            per_qubit_attribution=pq_attr,
            gate_labels=self._column_labels(circuit),
            is_recovery=is_recovery,
            no_measurable_loss=no_loss,
        )

    # ---- state diff ---------------------------------------------------------------

    @staticmethod
    def compute_state_diff(snap_a: DebugSnapshot,
                           snap_b: DebugSnapshot) -> dict:
        """Fidelity, TVD, entropy delta, and top-10 amplitude differences."""
        data_a = snap_a.state.data
        data_b = snap_b.state.data
        n = snap_a.state.num_qubits

        fid = StateAnalysis.state_fidelity(data_a, data_b)
        prob_a = np.abs(data_a) ** 2
        prob_b = np.abs(data_b) ** 2
        tvd = 0.5 * np.sum(np.abs(prob_a - prob_b))

        amp_diffs = np.abs(data_a - data_b)
        top = np.argsort(amp_diffs)[::-1][: min(10, len(amp_diffs))]
        amplitude_diffs = []
        for idx in top:
            if amp_diffs[idx] < 1e-10:
                break
            amplitude_diffs.append((
                int(idx), format(idx, f"0{n}b"),
                complex(data_a[idx]), complex(data_b[idx]),
                float(amp_diffs[idx]),
            ))

        return {
            "fidelity": float(fid),
            "tvd": float(tvd),
            "amplitude_diffs": amplitude_diffs,
            "entropy_diff": snap_b.entropy - snap_a.entropy,
            "prob_diffs": np.abs(prob_a - prob_b),
        }
