"""Lindblad master equation: continuous-time open-system dynamics.

    drho/dt = -i [H, rho]
              + sum_k rate_k (L_k rho L_k^dag - 1/2 {L_k^dag L_k, rho})

Counterpart of ``quantum_simulator_tpu/lindblad.py``. The generator that
the discrete Kraus channels of ``noise.py`` discretize: amplitude damping
is the ``sigma_minus`` jump, dephasing the ``z`` jump, and a Trotterized
circuit with per-gate channels converges to this equation as the step
size shrinks.

* The right-hand side is MATRIX-FREE: H is a Pauli-term list (the same
  ``(coeff, pauli_string, qubits)`` tuples as ``models/trotter.py`` and
  the optimizer Hamiltonians), and every term and jump applies to rho
  through the left / right contractions of ``density.py``, never a
  4^n x 4^n Liouvillian matrix. It accumulates in place (``add_`` with
  ``alpha``), so it holds its sum and one term at a time, not one
  temporary per term.
* Integration is classical RK4 with a static step count in a Python loop
  (the JAX package runs two nested ``lax.scan``s under one jit and caches
  the compiled function per step count; eagerly there is nothing to
  compile, so the device operators are built once per ``evolve``).
* Observables are Pauli strings evaluated on the device (``tr(P rho)`` =
  the trace of one left-application) and stay there until the end: one
  ``torch.stack`` and one host copy, no host synchronization per step.

No hand-written kernel is involved: every contraction is a
``torch.einsum`` over a strided view of rho, and at small n the loop is
bound by launches.

Memory: an RK4 step holds about five live rho buffers of 4^n complex
entries plus the einsum's temporaries, so the cap is n <= 13 (5 x 512 MiB
at complex64), enforced via ``MAX_LINDBLAD_QUBITS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import CONFIG
from .density import (DensityMatrixResult, _apply_left, _apply_right_dag,
                      _apply_unitary)
from .models.trotter import _PAULI, _validated
from .state import StateVector

#: RK4 holds ~5 live rho copies of 4^n complex entries.
MAX_LINDBLAD_QUBITS = 13

#: Named single-qubit jump operators (qubit basis |0> = [1, 0]).
JUMP_OPERATORS = {
    "sigma_minus": np.array([[0, 1], [0, 0]], dtype=np.complex128),
    "sigma_plus": np.array([[0, 0], [1, 0]], dtype=np.complex128),
    "x": _PAULI["X"],
    "y": _PAULI["Y"],
    "z": _PAULI["Z"],
}


def _pauli_term_matrix(pstr: str) -> np.ndarray:
    """kron of Paulis in string order (``targets[0]`` = MSB of the
    matrix index, the package-wide convention)."""
    mat = np.array([[1.0 + 0j]])
    for ch in pstr:
        mat = np.kron(mat, _PAULI[ch])
    return mat


def _normalize_jumps(jump_operators, num_qubits: int):
    """-> list of (rate, L 2x2 complex, qubit).  Each entry of
    ``jump_operators`` is ``(rate, op, qubit)`` with ``op`` a name from
    ``JUMP_OPERATORS`` or an explicit 2x2 matrix."""
    out = []
    for rate, op, qubit in jump_operators:
        rate = float(rate)
        if rate < 0:
            raise ValueError(f"jump rate must be >= 0, got {rate}")
        qubit = int(qubit)
        if not 0 <= qubit < num_qubits:
            raise ValueError(f"jump qubit {qubit} out of range")
        if isinstance(op, str):
            try:
                mat = JUMP_OPERATORS[op.lower()]
            except KeyError:
                raise ValueError(
                    f"unknown jump operator {op!r}; named ops: "
                    f"{sorted(JUMP_OPERATORS)}") from None
        else:
            mat = np.asarray(op, dtype=np.complex128)
            if mat.shape != (2, 2):
                raise ValueError("matrix jump operators must be 2x2 "
                                 f"(got {mat.shape})")
        if rate > 0:
            out.append((rate, mat, qubit))
    return out


@dataclass
class LindbladResult:
    """Evolution record: ``times[i]`` pairs with ``expectations[:, i]``
    (row k = k-th requested observable, real parts of tr(P rho));
    ``final`` is the full density matrix at ``times[-1]``."""

    times: np.ndarray                 # (n_records,)
    expectations: np.ndarray          # (n_observables, n_records)
    final: DensityMatrixResult
    observable_labels: list[str]


class LindbladSimulator:
    """Integrate the Lindblad equation for an n-qubit open system on
    ``device`` (default ``CONFIG.device``).

    ``hamiltonian_terms``: ``[(coeff, pauli_string, qubits), ...]``, the
    shared Hamiltonian format (identity components drop exactly:
    c*[I, rho] = 0).  ``jump_operators``: ``[(rate, op, qubit), ...]``
    with ``op`` a ``JUMP_OPERATORS`` name or a 2x2 matrix; ``rate`` is
    the Lindblad prefactor (so ``("sigma_minus", gamma)`` gives
    population decay exp(-gamma t)).
    """

    def __init__(self, num_qubits: int, hamiltonian_terms=(),
                 jump_operators=(), device=None):
        if num_qubits < 1 or num_qubits > MAX_LINDBLAD_QUBITS:
            raise ValueError(
                f"num_qubits must be 1..{MAX_LINDBLAD_QUBITS} (RK4 holds "
                "~5 live 4^n density matrices)")
        self.num_qubits = num_qubits
        self._device = device or CONFIG.device
        self._terms = [
            (coeff, _pauli_term_matrix(pstr), tuple(qubits))
            for coeff, pstr, qubits in _validated(num_qubits,
                                                  list(hamiltonian_terms))]
        self._jumps = _normalize_jumps(jump_operators, num_qubits)

    def _put(self, arr, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self._device, dtype=dtype)

    # -- rho0 coercion ------------------------------------------------------

    def _initial_rho(self, initial, dtype) -> torch.Tensor:
        n = self.num_qubits
        dim = 1 << n

        def put(arr) -> torch.Tensor:
            return self._put(arr, dtype)

        if initial is None:
            rho = torch.zeros((dim, dim), dtype=dtype, device=self._device)
            rho[0, 0] = 1.0
            return rho
        if isinstance(initial, StateVector):
            if initial.num_qubits != n:
                raise ValueError("initial state has wrong qubit count")
            psi = initial.data
            return put(np.outer(psi, np.conj(psi)))
        if isinstance(initial, DensityMatrixResult):
            # a copy: the evolution must not alias the caller's result
            return initial.device_rho.to(device=self._device, dtype=dtype,
                                         copy=True)
        arr = np.asarray(initial, dtype=np.complex128)
        if arr.shape == (dim,):
            return put(np.outer(arr, np.conj(arr)))
        if arr.shape == (dim, dim):
            return put(arr)
        raise ValueError(f"initial must be a {dim}-vector, {dim}x{dim} "
                         f"matrix, StateVector or DensityMatrixResult")

    # -- evolution ----------------------------------------------------------

    def _device_operators(self, obs_key, dtype):
        """The Hamiltonian terms, jumps and observables as device
        tensors, built once per ``evolve``."""
        def put(mat) -> torch.Tensor:
            return self._put(mat, dtype)

        terms = [(c, put(u), tg) for c, u, tg in self._terms]
        jumps = [(rate, put(L), put(np.conj(L.T) @ L), (q,))
                 for rate, L, q in self._jumps]
        obs_ops = [(put(_pauli_term_matrix(pstr)), tuple(qubits))
                   for pstr, qubits in obs_key]
        return terms, jumps, obs_ops

    def evolve(self, t_final: float, n_steps: int, initial=None,
               observables=(), record_every: int = 1,
               dtype=None) -> LindbladResult:
        """Integrate to ``t_final`` in ``n_steps`` RK4 steps.

        ``observables``: ``[(pauli_string, qubits), ...]`` recorded at
        t=0 and after every ``record_every``-th step (must divide
        ``n_steps``)."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if record_every < 1 or n_steps % record_every:
            raise ValueError("record_every must divide n_steps")
        dtype = dtype or CONFIG.dtype
        obs_key = tuple((str(pstr).upper(), tuple(int(q) for q in qubits))
                        for pstr, qubits in observables)
        for pstr, qubits in obs_key:
            _validated(self.num_qubits, [(1.0, pstr, list(qubits))])
        n = self.num_qubits
        terms, jumps, obs_ops = self._device_operators(obs_key, dtype)
        dt = float(t_final) / n_steps

        def rhs(rho: torch.Tensor) -> torch.Tensor:
            """dt * (Hamiltonian commutator + dissipators)."""
            acc = torch.zeros_like(rho)
            for coeff, u, tg in terms:
                acc.add_(_apply_left(rho, u, tg, n), alpha=-1j * coeff)
                acc.add_(_apply_right_dag(rho, u, tg, n), alpha=1j * coeff)
            for rate, L, LdL, tg in jumps:
                acc.add_(_apply_unitary(rho, L, tg, n), alpha=rate)
                acc.add_(_apply_left(rho, LdL, tg, n), alpha=-0.5 * rate)
                acc.add_(_apply_right_dag(rho, LdL, tg, n),
                         alpha=-0.5 * rate)
            return acc.mul_(dt)

        def rk4(r: torch.Tensor) -> torch.Tensor:
            """r + (k1 + 2 k2 + 2 k3 + k4) / 6, summed as the k's come:
            r, the sum, the next stage's argument and one k are live."""
            k = rhs(r)                                   # k1
            out = torch.add(r, k, alpha=1.0 / 6.0)
            arg = torch.add(r, k, alpha=0.5)
            del k
            k = rhs(arg)                                 # k2
            out.add_(k, alpha=1.0 / 3.0)
            torch.add(r, k, alpha=0.5, out=arg)
            del k
            k = rhs(arg)                                 # k3
            out.add_(k, alpha=1.0 / 3.0)
            torch.add(r, k, out=arg)
            del k
            k = rhs(arg)                                 # k4
            return out.add_(k, alpha=1.0 / 6.0)

        def measure(rho: torch.Tensor) -> torch.Tensor:
            real = rho.real.dtype   # float64 from a complex128 rho
            if not obs_ops:
                return torch.zeros((0,), dtype=real, device=rho.device)
            vals = [torch.diagonal(_apply_left(rho, u, tg, n)).sum().real
                    for u, tg in obs_ops]
            return torch.stack(vals).to(real)

        rho = self._initial_rho(initial, dtype)
        records = [measure(rho)]
        for step in range(1, n_steps + 1):
            rho = rk4(rho)
            if step % record_every == 0:
                records.append(measure(rho))
        n_windows = n_steps // record_every
        times = np.linspace(0.0, float(t_final), n_windows + 1)
        labels = [f"{pstr}@{list(qs)}" for pstr, qs in obs_key]
        return LindbladResult(
            times=times,
            expectations=torch.stack(records).cpu().numpy().T,
            final=DensityMatrixResult(num_qubits=n, device_rho=rho),
            observable_labels=labels)

    def dense_liouvillian(self) -> np.ndarray:
        """The 4^n x 4^n Liouvillian matrix on vec(rho) (row-major:
        vec[i * 2^n + j] = rho[i, j]), on the host in NumPy, for
        validation and spectral analysis at small n (n <= 6)."""
        n = self.num_qubits
        if n > 6:
            raise ValueError("dense Liouvillian is 4^n x 4^n; n capped at 6")
        dim = 1 << n
        eye = np.eye(dim, dtype=np.complex128)

        def embed(u, targets):
            """u (2^k x 2^k, targets[0] = MSB) -> dim x dim operator,
            the NumPy mirror of ``ops.apply.apply_gate`` applied to
            every identity column at once."""
            k = len(targets)
            u_t = np.asarray(u, np.complex128).reshape([2] * (2 * k))
            cols = np.eye(dim, dtype=np.complex128).reshape([2] * n + [dim])
            moved = np.tensordot(u_t, cols,
                                 axes=(list(range(k, 2 * k)), list(targets)))
            # moved axes: u's k output qubit axes, then the untouched row
            # axes in qubit order, then the column axis: restore order.
            pos = {q: i for i, q in enumerate(targets)}
            rest = [q for q in range(n) if q not in pos]
            for i, q in enumerate(rest):
                pos[q] = k + i
            perm = [pos[q] for q in range(n)] + [n]
            return np.transpose(moved, perm).reshape(dim, dim)

        L_total = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
        for coeff, u, tg in self._terms:
            H = coeff * embed(u, tg)
            L_total += -1j * (np.kron(H, eye) - np.kron(eye, H.T))
        for rate, Lm, q in self._jumps:
            Lf = embed(Lm, (q,))
            LdL = np.conj(Lf.T) @ Lf
            L_total += rate * (np.kron(Lf, np.conj(Lf))
                               - 0.5 * np.kron(LdL, eye)
                               - 0.5 * np.kron(eye, LdL.T))
        return L_total
