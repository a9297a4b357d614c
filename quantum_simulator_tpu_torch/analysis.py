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

Not ported yet (ROADMAP Queue 1 item 8): ``EntanglementEventDetector``,
``ConvergenceAnalysis`` and ``BenchmarkAnalysis`` (``analysis.py:369-786``).
A ``PlanarStateVector`` (n >= 30) answers ``pauli_string_expectation`` and
``hamiltonian_expectation`` by its own read-only pass over the grouped
state.
"""

from __future__ import annotations

import string

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
    or a tensor as they are; NumPy as complex64 on ``device`` (default
    ``CONFIG.device``)."""
    if isinstance(x, StateVector):
        return x.device_data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x, dtype=np.complex64)).to(
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
        otherwise the eigenvalue definition on |psi><psi|."""
        psi = _as_np_state(state)
        norm2 = float(np.real(np.vdot(psi, psi)))
        if abs(norm2 - 1.0) < 1e-12:
            return 0.0
        return StateAnalysis.von_neumann_entropy_dm(
            np.outer(psi, psi.conj()))

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
