"""Quantitative state analysis: fidelities, entropies, partial traces,
entanglement measures and expectation values.

Counterpart of ``StateAnalysis`` in ``quantum_simulator_tpu/analysis.py:
40-362``. The 2^n-sized contractions run in torch where the state lives: a
``StateVector`` or a tensor on its device, a NumPy array on ``device``
(default ``CONFIG.device``, the card, as JAX's ``jnp.asarray`` puts it on
the default accelerator):
``partial_trace`` contracts |psi> directly with one segmented einsum
(``_ptrace_body``), all one- and two-qubit reduced density matrices come
from one pass over the qubit pairs (``_all_rdms``), and expectation values
apply the observable as a gate (``ops/apply.apply_gate``). The small
eigenproblems (2x2, 4x4, 2^k reduced matrices) finish in NumPy float64.

A ``PlanarStateVector`` (n >= 30) answers ``pauli_string_expectation`` and
``hamiltonian_expectation`` by its own read-only pass over the grouped
state.

The rest of the module (``analysis.py:369-786``): the entanglement-event
detector (a host state machine over ``pairwise_mutual_information``),
shot-convergence metrics (NumPy), and ``BenchmarkAnalysis``: gate timing,
the reference's quantum-volume protocol, and quantum volume at scale,
whose trials at one width are parameter rows of one batch through the
group executor (``plan.group_batched_forward``) and, with noise, through
the batched trajectory bodies with each row's own parameters and draws
(``heavy_output_chunk``): every dense and cross step one kernel launch for
the whole chunk.
"""

from __future__ import annotations

import string
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable

import numpy as np
import torch

from .config import CONFIG
from .gates import X_MATRIX, Y_MATRIX, Z_MATRIX
from .ops.apply import apply_gate
from .ops.bigstate import PlanarStateVector
from .state import StateVector

_PAULI = {"X": X_MATRIX, "Y": Y_MATRIX, "Z": Z_MATRIX}


def _as_np_state(x) -> np.ndarray:
    if isinstance(x, StateVector):
        return x.data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.complex128)
    return np.asarray(x)


def _as_tensor(x, device=None) -> torch.Tensor:
    """A state as a complex torch tensor: a ``StateVector``'s device data
    or a tensor as they are; NumPy as ``CONFIG.dtype`` on ``device``
    (default ``CONFIG.device``)."""
    if isinstance(x, StateVector):
        return x.device_data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x, dtype=CONFIG.np_complex)).to(
        device or CONFIG.device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.complex128)


def _ptrace_body(state: torch.Tensor, keep: tuple[int, ...],
                 n: int) -> torch.Tensor:
    """rho_keep[i, j] = sum_env psi[env; i] conj(psi[env; j]) without the
    full density matrix (``analysis.py:57-99``). ``keep`` must be sorted."""
    if not keep:
        raise ValueError("partial trace needs at least one kept qubit")
    if len(keep) > 8:
        raise ValueError(
            f"partial trace keeps {len(keep)} qubits: the reduced density"
            f" matrix would be 4^{len(keep)} entries; keep <= 8")
    letters = iter(string.ascii_lowercase)
    shape: list[int] = []
    sub: list[str] = []
    sub2: list[str] = []
    keep_bra: list[str] = []
    keep_ket: list[str] = []
    prev = -1
    for q in keep:
        shape.append(1 << (q - prev - 1))
        seg_l = next(letters)
        sub.append(seg_l)
        sub2.append(seg_l)
        shape.append(2)
        bra_l, ket_l = next(letters), next(letters)
        sub.append(bra_l)
        sub2.append(ket_l)
        keep_bra.append(bra_l)
        keep_ket.append(ket_l)
        prev = q
    shape.append(1 << (n - keep[-1] - 1))
    tail_l = next(letters)
    sub.append(tail_l)
    sub2.append(tail_l)
    spec = ("".join(sub) + "," + "".join(sub2) + "->"
            + "".join(keep_bra) + "".join(keep_ket))
    psi = state.reshape(shape)
    dim = 1 << len(keep)
    return torch.einsum(spec, psi, psi.conj()).reshape(dim, dim)


def _all_rdms(state: torch.Tensor, n: int):
    """All single-qubit (n, 2, 2) and pairwise (n(n-1)/2, 4, 4) reduced
    density matrices (``analysis.py:105-115``)."""
    singles = torch.stack([_ptrace_body(state, (q,), n) for q in range(n)])
    pairs = [_ptrace_body(state, (i, j), n)
             for i in range(n) for j in range(i + 1, n)]
    pairs = (torch.stack(pairs) if pairs
             else torch.zeros((0, 4, 4), dtype=state.dtype,
                              device=state.device))
    return singles, pairs


def _fidelity(psi: torch.Tensor, phi: torch.Tensor) -> float:
    return float(torch.sum(psi.conj() * phi).abs().square())


def ensemble_fidelity_purity(ideal: torch.Tensor, states: torch.Tensor
                             ) -> tuple[float, float]:
    """Mean fidelity |<ideal|psi_t>|^2 and ensemble purity tr(rho^2) =
    mean_{t,s} |<psi_t|psi_s>|^2 of rho = mean_t |psi_t><psi_t| over T
    trajectory states ``(T, 2^n)``: two products on the states' device
    in their dtype (float32 sums, TF32 off: ``config.py``), means in
    float64. Each trajectory is renormalised, so its own norm says
    nothing about mixedness; the Gram matrix does."""
    overlaps = states @ ideal.conj()
    gram = states.conj() @ states.T
    return (float(overlaps.abs().square().double().mean()),
            float(gram.abs().square().double().mean()))


class StateAnalysis:
    """Static quantitative analysis of quantum states."""

    # ---- fidelity ------------------------------------------------------

    @staticmethod
    def state_fidelity(psi, phi) -> float:
        """|<psi|phi>|^2 for two pure states: on the device when either
        is a torch tensor, else in NumPy float64."""
        if isinstance(psi, torch.Tensor) or isinstance(phi, torch.Tensor):
            dev = (psi if isinstance(psi, torch.Tensor) else phi).device
            return _fidelity(_as_tensor(psi, dev), _as_tensor(phi, dev))
        a, b = _as_np_state(psi), _as_np_state(phi)
        return float(np.abs(np.vdot(a, b)) ** 2)

    @staticmethod
    def process_fidelity(ideal: StateVector, actual: StateVector) -> float:
        return _fidelity(ideal.device_data, actual.device_data)

    @staticmethod
    def _sanitize_density_matrix(rho: np.ndarray) -> np.ndarray:
        """Hermitian-symmetrize and trace-normalize (numerical guard)."""
        rho = (rho + rho.conj().T) / 2
        tr = np.trace(rho).real
        return rho / tr if tr > 1e-15 else rho

    @staticmethod
    def _matrix_sqrt(mat: np.ndarray) -> np.ndarray:
        eigvals, eigvecs = np.linalg.eigh(mat)
        eigvals = np.maximum(eigvals, 0.0)
        return (eigvecs * np.sqrt(eigvals)) @ eigvecs.conj().T

    @staticmethod
    def density_fidelity(rho: np.ndarray, sigma: np.ndarray) -> float:
        """Uhlmann fidelity F = (Tr sqrt(sqrt(rho) sigma sqrt(rho)))^2 with
        Hermitian/trace sanitization, in host float64."""
        rho = StateAnalysis._sanitize_density_matrix(np.asarray(rho))
        sigma = StateAnalysis._sanitize_density_matrix(np.asarray(sigma))
        sqrt_rho = StateAnalysis._matrix_sqrt(rho)
        eigvals = np.linalg.eigvalsh(sqrt_rho @ sigma @ sqrt_rho)
        fid = float(np.sum(np.sqrt(np.maximum(eigvals, 0.0))) ** 2)
        return min(fid, 1.0)

    # ---- entropy ------------------------------------------------------

    @staticmethod
    def von_neumann_entropy_dm(rho: np.ndarray) -> float:
        """S(rho) = -Tr(rho log2 rho) in bits."""
        eigvals = np.linalg.eigvalsh(np.asarray(rho))
        eigvals = eigvals[eigvals > 1e-15]
        return float(-np.sum(eigvals * np.log2(eigvals)))

    @staticmethod
    def von_neumann_entropy(state) -> float:
        """S of the full state: exactly 0 for a normalized pure state;
        otherwise the eigenvalue definition on |psi><psi|, whose one
        nonzero eigenvalue is ||psi||^2. The JAX package builds the 2^n x
        2^n outer product for it (``analysis.py:199-201``), which a
        float32 state's norm reaches whenever it misses 1 by 1e-12; the
        closed form gives the same value in O(2^n)."""
        psi = _as_np_state(state)
        norm2 = float(np.real(np.vdot(psi, psi)))
        if abs(norm2 - 1.0) < 1e-12 or norm2 <= 1e-15:
            return 0.0
        return float(-norm2 * np.log2(norm2))

    @staticmethod
    def entanglement_entropy(state, subsystem_qubits: list[int],
                             device=None) -> float:
        """S of the reduced density matrix of ``subsystem_qubits`` (bits)."""
        rho_sub = StateAnalysis.partial_trace(state, subsystem_qubits,
                                              device)
        return StateAnalysis.von_neumann_entropy_dm(rho_sub)

    # ---- partial trace --------------------------------------------------

    @staticmethod
    def partial_trace(state, keep_qubits: list[int],
                      device=None) -> np.ndarray:
        """Reduced density matrix of ``keep_qubits`` (complex128 on the
        host), contracting |psi> where it lives (a NumPy state on
        ``device``, default ``CONFIG.device``)."""
        arr = _as_tensor(state, device)
        n = (state.num_qubits if isinstance(state, StateVector)
             else int(np.log2(arr.shape[-1])))
        return _host(_ptrace_body(arr, tuple(sorted(keep_qubits)), n))

    # ---- purity --------------------------------------------------------

    @staticmethod
    def purity_dm(rho: np.ndarray) -> float:
        rho = np.asarray(rho)
        return float(np.real(np.einsum("ij,ji->", rho, rho)))

    @staticmethod
    def purity(state, device=None) -> float:
        """Tr(rho^2) = (<psi|psi>)^2 for a pure state vector."""
        norm2 = float(_as_tensor(state, device).abs().square().sum())
        return float(norm2**2)

    # ---- entanglement measures ------------------------------------------

    @staticmethod
    def mutual_information(state, qubit_a: int, qubit_b: int,
                           device=None) -> float:
        """I(A:B) = S(A) + S(B) - S(AB) in bits, clamped at 0."""
        state = _as_tensor(state, device)
        sa = StateAnalysis.entanglement_entropy(state, [qubit_a])
        sb = StateAnalysis.entanglement_entropy(state, [qubit_b])
        sab = StateAnalysis.entanglement_entropy(state, [qubit_a, qubit_b])
        return float(max(0.0, sa + sb - sab))

    @staticmethod
    def pairwise_mutual_information(state: StateVector) -> np.ndarray:
        """(n, n) symmetric MI matrix: the reduced density matrices come
        from one pass on the device; entropies finish in host float64."""
        n = state.num_qubits
        singles_d, pairs_d = _all_rdms(state.device_data, n)
        singles, pairs = _host(singles_d), _host(pairs_d)
        s1 = np.array([StateAnalysis.von_neumann_entropy_dm(singles[q])
                       for q in range(n)])
        mi = np.zeros((n, n))
        idx = 0
        for i in range(n):
            for j in range(i + 1, n):
                sab = StateAnalysis.von_neumann_entropy_dm(pairs[idx])
                mi[i, j] = mi[j, i] = max(0.0, s1[i] + s1[j] - sab)
                idx += 1
        return mi

    @staticmethod
    def concurrence(state, qubit_a: int, qubit_b: int,
                    device=None) -> float:
        """Wootters concurrence of the (qubit_a, qubit_b) reduced state."""
        rho = StateAnalysis.partial_trace(state, [qubit_a, qubit_b], device)
        return StateAnalysis.concurrence_dm(rho)

    @staticmethod
    def concurrence_dm(rho: np.ndarray) -> float:
        sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
        yy = np.kron(sy, sy)
        rho_tilde = yy @ np.conj(rho) @ yy
        eigvals = np.real(np.linalg.eigvals(rho @ rho_tilde))
        lambdas = np.sort(np.sqrt(np.maximum(eigvals, 0.0)))[::-1]
        return float(max(0.0, lambdas[0] - lambdas[1:].sum()))

    # ---- expectation values ----------------------------------------------

    @staticmethod
    def expectation_value(state, observable, target_qubits: list[int],
                          device=None) -> complex:
        """<psi|O|psi> by applying O as a gate (no 2^n x 2^n matrix)."""
        psi = _as_tensor(state, device)
        n = int(np.log2(psi.shape[-1]))
        opsi = apply_gate(psi, observable,
                          tuple(int(t) for t in target_qubits), n)
        return complex(torch.sum(psi.conj() * opsi).item())

    @staticmethod
    def pauli_expectation(state, pauli: str, qubit: int,
                          device=None) -> float:
        if pauli.upper() not in _PAULI:
            raise ValueError(f"Unknown Pauli: {pauli}. Use 'X', 'Y', or 'Z'.")
        val = StateAnalysis.expectation_value(state, _PAULI[pauli.upper()],
                                              [qubit], device)
        return float(np.real(val))

    @staticmethod
    def pauli_string_expectation(state, qubits: list[int], paulis: str,
                                 device=None) -> float:
        """<prod_i P_i> for a mixed X/Y/Z string: the 2^k observable
        built as a kron and applied as a gate."""
        paulis = paulis.upper()
        if len(paulis) != len(qubits):
            raise ValueError(
                f"{len(qubits)} qubits but {len(paulis)} Paulis")
        if any(p not in _PAULI for p in paulis):
            raise ValueError(f"Paulis must be X/Y/Z, got {paulis!r}")
        if len(set(qubits)) != len(qubits):
            raise ValueError("duplicate qubits in Pauli string "
                             f"{sorted(qubits)}")
        if not qubits:
            return 1.0
        if isinstance(state, PlanarStateVector):
            return state.expectation_pauli_string(list(qubits), paulis)
        obs = np.array([[1.0]], dtype=np.complex128)
        for p in paulis:
            obs = np.kron(obs, _PAULI[p])
        val = StateAnalysis.expectation_value(state, obs, list(qubits),
                                              device)
        return float(np.real(val))

    @staticmethod
    def hamiltonian_expectation(state, terms, device=None) -> float:
        """<H> for H = sum_t coeff_t * prod_i P_i, ``terms`` a list of
        ``(coeff, qubits, paulis)`` triples: one expectation pass each."""
        if not isinstance(state, PlanarStateVector):
            state = _as_tensor(state, device)
        total = 0.0
        for coeff, qubits, paulis in terms:
            total += float(coeff) * StateAnalysis.pauli_string_expectation(
                state, list(qubits), paulis)
        return total


# ---------------------------------------------------------------------------
# Entanglement event detection
# ---------------------------------------------------------------------------

class EntanglementEventType(Enum):
    CREATION = "creation"
    DISENTANGLEMENT = "disentanglement"
    INCREASE = "increase"
    DECREASE = "decrease"


@dataclass
class EntanglementEvent:
    step: int
    qubit_pair: tuple[int, int]
    event_type: EntanglementEventType
    magnitude: float
    entropy_before: float
    entropy_after: float


class EntanglementEventDetector:
    """Detects pairwise entanglement creation/destruction step by step
    (``analysis.py:386-483``).

    Hysteresis (``epsilon_on`` to enter the entangled state, ``epsilon_off``
    — default epsilon/2 — to leave it) plus a persistence filter of N
    consecutive steps suppress noise-driven event spam. The state machine
    is host-side Python; the per-step MI matrix comes from one pass over
    the state's reduced density matrices on its device.
    """

    def __init__(self, epsilon: float = 0.01,
                 epsilon_on: float | None = None,
                 epsilon_off: float | None = None,
                 persistence: int = 1):
        self.epsilon = epsilon
        self.epsilon_on = epsilon_on if epsilon_on is not None else epsilon
        self.epsilon_off = (epsilon_off if epsilon_off is not None
                            else epsilon * 0.5)
        self.persistence = max(1, persistence)
        self._prev_mi: dict[tuple[int, int], float] = {}
        self._entangled: dict[tuple[int, int], bool] = {}
        self._pending: dict[tuple[int, int], int] = {}
        self._pending_type: dict[tuple[int, int], EntanglementEventType] = {}
        self._events: list[EntanglementEvent] = []
        self._pair_history: dict[tuple[int, int],
                                 list[tuple[int, float]]] = {}

    def process_step(self, state: StateVector,
                     step_index: int) -> list[EntanglementEvent]:
        n = state.num_qubits
        mi_matrix = StateAnalysis.pairwise_mutual_information(state)
        step_events: list[EntanglementEvent] = []

        for i in range(n):
            for j in range(i + 1, n):
                pair = (i, j)
                mi = float(mi_matrix[i, j])
                self._pair_history.setdefault(pair, []).append(
                    (step_index, mi))

                prev = self._prev_mi.get(pair, 0.0)
                was_entangled = self._entangled.get(pair, False)
                delta = mi - prev

                candidate: EntanglementEventType | None = None
                if not was_entangled and mi >= self.epsilon_on:
                    candidate = EntanglementEventType.CREATION
                elif was_entangled and mi < self.epsilon_off:
                    candidate = EntanglementEventType.DISENTANGLEMENT
                elif abs(delta) > self.epsilon:
                    candidate = (EntanglementEventType.INCREASE if delta > 0
                                 else EntanglementEventType.DECREASE)

                if candidate is None:
                    self._pending.pop(pair, None)
                    self._pending_type.pop(pair, None)
                else:
                    if self._pending_type.get(pair) == candidate:
                        self._pending[pair] = self._pending.get(pair, 0) + 1
                    else:
                        self._pending[pair] = 1
                        self._pending_type[pair] = candidate

                    if self._pending[pair] >= self.persistence:
                        if candidate == EntanglementEventType.CREATION:
                            self._entangled[pair] = True
                        elif candidate == EntanglementEventType.DISENTANGLEMENT:
                            self._entangled[pair] = False
                        event = EntanglementEvent(
                            step=step_index, qubit_pair=pair,
                            event_type=candidate, magnitude=abs(delta),
                            entropy_before=prev, entropy_after=mi)
                        step_events.append(event)
                        self._events.append(event)
                        self._pending[pair] = 0
                        self._pending_type.pop(pair, None)

                self._prev_mi[pair] = mi

        return step_events

    def get_timeline(self) -> list[EntanglementEvent]:
        return list(self._events)

    def get_pair_history(self, qa: int, qb: int) -> list[tuple[int, float]]:
        pair = (min(qa, qb), max(qa, qb))
        return list(self._pair_history.get(pair, []))

    def get_all_pair_histories(self):
        return dict(self._pair_history)

    def reset(self) -> None:
        self._prev_mi.clear()
        self._entangled.clear()
        self._pending.clear()
        self._pending_type.clear()
        self._events.clear()
        self._pair_history.clear()


# ---------------------------------------------------------------------------
# Convergence analysis
# ---------------------------------------------------------------------------

def counts_to_array(counts: dict[str, int], num_qubits: int) -> np.ndarray:
    arr = np.zeros(2**num_qubits)
    for bitstring, c in counts.items():
        arr[int(bitstring, 2)] = c
    return arr


class ConvergenceAnalysis:
    """Shot-count convergence metrics (vectorized NumPy reductions,
    ``analysis.py:497-539``)."""

    @staticmethod
    def tvd(ideal_probs: np.ndarray, empirical_counts: dict[str, int],
            total_shots: int) -> float:
        """0.5 * sum |p_ideal - p_empirical|, in [0, 1]."""
        ideal_probs = np.asarray(ideal_probs, dtype=np.float64)
        num_qubits = int(np.log2(len(ideal_probs)))
        emp = counts_to_array(empirical_counts, num_qubits) / total_shots
        return float(0.5 * np.abs(ideal_probs - emp).sum())

    @staticmethod
    def kl_divergence(ideal_probs: np.ndarray,
                      empirical_counts: dict[str, int],
                      total_shots: int, epsilon: float = 1e-10) -> float:
        """D_KL(ideal || empirical) with epsilon smoothing, in bits."""
        p = np.asarray(ideal_probs, dtype=np.float64)
        num_qubits = int(np.log2(len(p)))
        q = counts_to_array(empirical_counts, num_qubits) / total_shots
        mask = p >= epsilon
        kl = np.sum(p[mask] * np.log2(p[mask] / (q[mask] + epsilon)))
        return float(max(0.0, kl))

    @staticmethod
    def shot_convergence(state: StateVector, shot_counts: list[int],
                         seed: int | None = None) -> list[dict]:
        """TVD and KL vs shot count, child-seeded per point."""
        from .measurement import MeasurementEngine

        ideal_probs = state.probabilities
        rng = np.random.default_rng(seed)
        results = []
        for shots in shot_counts:
            child_rng = np.random.default_rng(rng.integers(0, 2**63))
            counts = MeasurementEngine.sample(state, shots, rng=child_rng)
            results.append({
                "shots": shots,
                "tvd": ConvergenceAnalysis.tvd(ideal_probs, counts, shots),
                "kl_divergence": ConvergenceAnalysis.kl_divergence(
                    ideal_probs, counts, shots),
            })
        return results


# ---------------------------------------------------------------------------
# Benchmark analysis
# ---------------------------------------------------------------------------

def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def qv_model_circuit(m: int):
    """The model circuit of ``quantum_volume_at_scale`` at width m
    (``analysis.py:678-689``): m layers, each an Rz Ry Rz column trio on
    every qubit (angles 0: the trials bind them) and an alternating CNOT
    brick."""
    from .circuit import GateInstance, QuantumCircuit

    circuit = QuantumCircuit(num_qubits=m)
    col = 0
    for layer in range(m):
        for q in range(m):
            circuit.add_gate(GateInstance("Rz", [q], [0.0], col))
            circuit.add_gate(GateInstance("Ry", [q], [0.0], col + 1))
            circuit.add_gate(GateInstance("Rz", [q], [0.0], col + 2))
        col += 3
        for q in range(layer % 2, m - 1, 2):
            circuit.add_gate(GateInstance("CNOT", [q, q + 1], [], col))
        col += 1
    return circuit


def noisy_param_rows(program, noise_model, rows: torch.Tensor, device,
                     generator=None, draws=None, plain: bool = False):
    """``(states (R, 2^n) complex64, draws)``: one stochastic trajectory
    per row of a ``(R, P)`` parameter batch, each with its own parameters
    and its own draws, down the route ladder of ``program.
    trajectory_route``. The unitary and monomial splices take the rows as
    one batch (operands built with ``plan.merge_overrides``); the fold and
    per-gate bodies take one parameter vector, so there the rows run one
    after the other and ``draws`` is a list with one entry per row."""
    from .ops import program as prog

    route = prog.trajectory_route(program, noise_model)
    if route in ("unitary", "monomial"):
        return prog.batched_trajectories(program, noise_model, rows,
                                         rows.shape[0], device, generator,
                                         draws, plain)
    host_rows = rows.detach().cpu().numpy().astype(np.float64)
    states, used = [], []
    for i, p in enumerate(host_rows):
        s, d = prog.batched_trajectories(
            program, noise_model, p, 1, device, generator,
            None if draws is None else draws[i], plain)
        states.append(s)
        used.append(d)
    return torch.cat(states), used


def heavy_set(probs: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the heavy outputs of each row of ``(B, 2^n)``
    probabilities: ``probs > median``. torch.median returns the lower of
    the two middle values of an even-length row, ``jnp.median`` their
    mean; no value lies strictly between the two, so the mask is the same
    either way, also when they tie."""
    return probs > torch.median(probs, dim=-1, keepdim=True).values


def heavy_output_chunk(program, noise_model, params: torch.Tensor, device,
                       trajectories_per_trial: int = 1, generator=None,
                       draws=None, plain: bool = False):
    """``(h_ideal (B,), h_noisy (B,), draws)`` for one chunk of quantum
    volume trials, the rows of a ``(B, P)`` parameter batch
    (``analysis.py:693-741``): the ideal states of all rows in one batch
    through the group executor, the heavy set ``probs > median`` of each,
    and (with channels) the heavy mass of ``trajectories_per_trial``
    trajectories per trial, each row repeated that many times and every
    repeat with its own draws (``noisy_param_rows``). ``plain`` runs the
    kernels' twins; ``draws`` replays an earlier call's."""
    from .ops.plan import group_batched_forward

    psi = group_batched_forward(program, params, device, plain)
    probs = psi.real.square() + psi.imag.square()
    del psi
    heavy = heavy_set(probs)
    h_ideal = (probs * heavy).sum(-1)
    noisy = noise_model is not None and noise_model.has_channels()
    if not noisy:
        return h_ideal, h_ideal, None
    tpt = trajectories_per_trial
    rows = params.repeat_interleave(tpt, dim=0)
    states, draws = noisy_param_rows(program, noise_model, rows, device,
                                     generator, draws, plain)
    pn = states.real.square() + states.imag.square()
    del states
    h = (pn * heavy.repeat_interleave(tpt, dim=0)).sum(-1)
    return h_ideal, h.reshape(-1, tpt).mean(-1), draws


class BenchmarkAnalysis:
    """Runtime benchmarking and quantum-volume estimation."""

    @staticmethod
    def gate_timing(num_qubits_range, gate_matrix: np.ndarray,
                    target_qubits_func: Callable[[int], list[int]],
                    repetitions: int = 20, device=None) -> list[dict]:
        """Gate-application wall time vs qubit count on ``device`` (default
        ``CONFIG.device``), each sample ending in a device synchronize."""
        device = device or CONFIG.device
        results = []
        for nq in num_qubits_range:
            targets = target_qubits_func(nq)
            sv = StateVector(nq, device=device)
            sv.apply_gate(gate_matrix, targets)  # warm up
            times = []
            for _ in range(repetitions):
                sv = StateVector(nq, device=device)
                _synchronize(device)
                t0 = time.perf_counter()
                sv.apply_gate(gate_matrix, targets)
                _synchronize(device)
                times.append((time.perf_counter() - t0) * 1000)
            results.append({
                "num_qubits": nq,
                "mean_time_ms": float(np.mean(times)),
                "std_time_ms": float(np.std(times)),
            })
        return results

    @staticmethod
    def quantum_volume(max_qubits: int = 8, num_trials: int = 100,
                       noise_model: object | None = None,
                       seed: int | None = None, device=None) -> dict:
        """Heavy-output quantum-volume estimate over random Rz Ry Rz
        layers (the reference's protocol, ``analysis.py:576-631``):
        QV = 2^m for the largest width m whose heavy-output success rate
        exceeds 2/3."""
        from .circuit import GateInstance, QuantumCircuit
        from .simulator import Simulator

        rng = np.random.default_rng(seed)
        results_per_width = []
        best_m = 1

        for m in range(2, min(max_qubits + 1, 9)):
            heavy_count = 0
            for _ in range(num_trials):
                circuit = QuantumCircuit(num_qubits=m)
                for col in range(m):
                    for q in range(m):
                        a, b, c = rng.uniform(0, 2 * np.pi, 3)
                        circuit.add_gate(GateInstance("Rz", [q], [a], col * 3))
                        circuit.add_gate(GateInstance("Ry", [q], [b],
                                                      col * 3 + 1))
                        circuit.add_gate(GateInstance("Rz", [q], [c],
                                                      col * 3 + 2))

                ideal_probs = Simulator(device=device).run(
                    circuit, shots=0).final_state.probabilities
                if noise_model is not None:
                    actual_probs = Simulator(
                        noise_model=noise_model, device=device).run(
                            circuit, shots=0).final_state.probabilities
                else:
                    actual_probs = ideal_probs

                median_prob = float(np.median(ideal_probs))
                heavy_prob = float(
                    np.sum(actual_probs[ideal_probs > median_prob]))
                if heavy_prob > 2.0 / 3.0:
                    heavy_count += 1

            success_rate = heavy_count / num_trials
            passed = success_rate > 2.0 / 3.0
            results_per_width.append({
                "width": m,
                "success_rate": success_rate,
                "passed": passed,
            })
            if passed:
                best_m = m

        return {
            "quantum_volume": 2**best_m,
            "log2_qv": best_m,
            "results_per_width": results_per_width,
        }

    @staticmethod
    def quantum_volume_at_scale(widths=(4, 8, 12, 16, 20),
                                num_trials: int = 100,
                                noise_model: object | None = None,
                                seed: int | None = None,
                                chunk: int = 10,
                                trajectories_per_trial: int = 1,
                                on_width: Callable | None = None,
                                device=None) -> dict:
        """Heavy-output quantum volume far beyond the reference's 8-qubit
        cap (``analysis.py:634-786``). Per width m the model circuit
        (``qv_model_circuit``) is fixed and the trials randomize its
        angles, so ``chunk`` trials run as the rows of one parameter batch
        (``heavy_output_chunk``): the group executor for the ideal lane,
        the batched trajectory bodies for the noisy one, on ``device``
        (default ``CONFIG.device``) at every width.

        Per trial: ideal probabilities -> median -> heavy set; the noisy
        heavy-output probability is the heavy-set mass of one (or
        ``trajectories_per_trial``) stochastic trajectories, an unbiased
        estimator of tr(rho P_heavy). A width passes when the two-sided
        2-sigma lower bound of the mean noisy heavy-output probability
        clears 2/3. The parameter rows are the JAX package's for the same
        seed (the padding to a multiple of ``chunk`` is drawn, as there,
        and not run); the trajectories' draws come from a
        ``torch.Generator`` seeded where the JAX package forks its key.
        """
        from .ops import program as prog
        from .utils.seeding import generator_from_rng

        device = device or CONFIG.device
        rng = np.random.default_rng(seed)
        out_widths = []
        best_m = 0

        for m in widths:
            t_width = time.perf_counter()
            program = prog.compile_circuit(qv_model_circuit(m))
            pad = (-num_trials) % chunk
            params_all = rng.uniform(0.0, 2 * np.pi,
                                     size=(num_trials + pad,
                                           program.num_params)).astype(
                                               np.float32)
            gen = generator_from_rng(rng, device)
            h_ideal_l, h_noisy_l = [], []
            for i in range(0, num_trials, chunk):
                rows = torch.from_numpy(
                    params_all[i:min(i + chunk, num_trials)]).to(device)
                hi, hn, _ = heavy_output_chunk(
                    program, noise_model, rows, device,
                    trajectories_per_trial, gen)
                h_ideal_l.append(hi.cpu().numpy())
                h_noisy_l.append(hn.cpu().numpy())
            h_ideal = np.concatenate(h_ideal_l)
            h_noisy = np.concatenate(h_noisy_l)

            mean = float(np.mean(h_noisy))
            stderr = float(np.std(h_noisy, ddof=1) / np.sqrt(num_trials))
            passed = bool(mean - 2.0 * stderr > 2.0 / 3.0)
            out_widths.append({
                "width": int(m),
                "heavy_output_mean": mean,
                "heavy_output_stderr": stderr,
                "heavy_output_ideal_mean": float(np.mean(h_ideal)),
                "num_trials": int(num_trials),
                "trajectories_per_trial": int(trajectories_per_trial),
                "passed": passed,
                "seconds": round(time.perf_counter() - t_width, 3),
            })
            if passed:
                best_m = max(best_m, int(m))
            if on_width is not None:
                # incremental hook: callers persist each finished width
                on_width(out_widths[-1])

        return {
            "quantum_volume": 2 ** best_m if best_m else 1,
            "log2_qv": best_m,
            "threshold": 2.0 / 3.0,
            "results_per_width": out_widths,
        }
