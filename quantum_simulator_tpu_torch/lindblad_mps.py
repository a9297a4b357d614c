"""Lindblad dynamics at MPS widths: quantum-trajectory unravelling.

Counterpart of ``quantum_simulator_tpu/lindblad_mps.py``. ``lindblad.py``
integrates the master equation exactly but holds a 4^n density matrix;
this module unravels the same equation into Monte-Carlo wave-function
trajectories on the MPS engine, for chains of 40+ qubits under a
bond-dimension cap. Per time step ``dt`` (CPTP per step, first order in
the generator):

* **Hamiltonian**: a first- or second-order Trotter step of
  ``exp(-i H dt)``; every Pauli term applies in closed form
  (``exp(-i c dt P) = cos(c dt) I - i sin(c dt) P``) as a dense k-site
  gate routed through the MPS;
* **dissipators**: each jump ``(rate, L, qubit)`` is the binary Kraus
  channel ``{K0 = sqrt(I - rate dt L^dag L), K1 = sqrt(rate dt) L}``,
  drawn per trajectory by the engine's Kraus machinery.

The JAX package ``vmap``s one traced trajectory and ``lax.scan``s record
windows past the bond-growth fixed point; the port runs the
``n_trajectories`` as one batch of MPS (``mps._BatchMPS``) and loops every
step, recording at t = 0 and every ``record_every``-th step, the same
points. The jump draws are one Gumbel row per (trajectory, step, jump):
``gumbels=`` takes them ((T, n_steps, n_jump, 2), the JAX package's
``categorical`` draws), else a ``torch.Generator`` seeded from ``seed``
draws them step by step on the device. The trajectories, their norms and
records are in ``CONFIG.dtype``'s precision (complex128 under
``config.enable_complex128``); the Gumbel rows stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import CONFIG
from .lindblad import JUMP_OPERATORS, _normalize_jumps, _pauli_term_matrix
from .models.trotter import _PAULI, _validated
from .mps import _BatchMPS, _transfer, gumbel_from_uniform

__all__ = ["MPSLindbladSimulator", "MPSLindbladResult", "JUMP_OPERATORS"]


def _expectation_pstr(tensors, ops: dict) -> torch.Tensor:
    """<psi|P|psi> per row by one transfer contraction over (B, l, 2, r)
    tensors; any canonical form (the bra carries the whole conjugate
    network). -> (B,) in the tensors' real dtype."""
    t0 = tensors[0]
    env = torch.ones((t0.shape[0], 1, 1), dtype=t0.dtype, device=t0.device)
    for i, t in enumerate(tensors):
        op = ops.get(i)
        env = _transfer(env, t, t if op is None else op @ t)
    return env[:, 0, 0].real


def _kraus_pair(rate: float, L: np.ndarray, dt: float) -> np.ndarray:
    """Binary Kraus channel for one jump over one step: ``K1 = sqrt(rate
    dt) L`` and ``K0 = sqrt(I - K1^dag K1)`` by a 2x2 eigendecomposition,
    CPTP by construction and equal to the dissipator's step map to
    O(dt^2)."""
    M = rate * dt * (np.conj(L.T) @ L)
    w, v = np.linalg.eigh(M)
    if w.max() >= 1.0:
        raise ValueError(
            f"rate*dt*||L^dag L|| = {w.max():.3f} >= 1; shrink dt "
            "(more steps) so the no-jump Kraus stays positive")
    k0 = (v * np.sqrt(np.maximum(1.0 - w, 0.0))) @ np.conj(v.T)
    k1 = np.sqrt(rate * dt) * L
    return np.stack([k0, k1])


def trotter_gates(terms, dt: float, order: int, device, dtype) -> list:
    """One Trotter step of ``exp(-i H dt)`` as ``[(positions, matrix)]``
    on the device: each Pauli term ``exp(-i c t P) = cos(c t) I - i
    sin(c t) P``, in term order (first order) or forward at dt/2 then
    backward (second order)."""

    def term_gate(coeff, pstr, qubits, step_dt):
        P = _pauli_term_matrix(pstr)
        theta = float(coeff) * step_dt
        g = np.cos(theta) * np.eye(P.shape[0]) - 1j * np.sin(theta) * P
        return list(qubits), torch.from_numpy(g).to(device, dtype)

    if order == 2:
        fwd = [term_gate(c, p, q, 0.5 * dt) for c, p, q in terms]
        return fwd + fwd[::-1]
    return [term_gate(c, p, q, dt) for c, p, q in terms]


@dataclass
class MPSLindbladResult:
    """Trajectory-averaged record: ``times[i]`` pairs with
    ``expectations[k, i]`` (mean over trajectories of observable k) and
    ``stderr[k, i]`` (standard error of that mean)."""

    times: np.ndarray                 # (n_records,)
    expectations: np.ndarray          # (n_observables, n_records)
    stderr: np.ndarray                # (n_observables, n_records)
    observable_labels: list[str]
    n_trajectories: int
    truncation_weight: float          # mean discarded Schmidt weight


class MPSLindbladSimulator:
    """``LindbladSimulator``'s surface past the 2^n wall, on ``device``
    (default ``CONFIG.device``).

    ``hamiltonian_terms`` are ``(coeff, pauli_string, qubits)`` tuples,
    ``jump_operators`` ``(rate, op, qubit)`` with named or 2x2-matrix
    ops; ``chi`` caps the bond dimension, ``order`` picks the Trotter
    splitting."""

    def __init__(self, num_qubits: int, hamiltonian_terms=(),
                 jump_operators=(), chi: int = 32, order: int = 2,
                 device=None):
        if num_qubits < 1:
            raise ValueError("num_qubits must be >= 1")
        if order not in (1, 2):
            raise ValueError("order must be 1 or 2")
        self.num_qubits = num_qubits
        self.chi = int(chi)
        self.order = order
        self.device = device or CONFIG.device
        self._terms = _validated(num_qubits, list(hamiltonian_terms))
        self._jumps = _normalize_jumps(jump_operators, num_qubits)

    def evolve(self, t_final: float, n_steps: int,
               n_trajectories: int = 64, initial=None,
               observables=(), record_every: int = 1,
               seed: int = 0, dtype=None, mesh=None,
               gumbels=None) -> MPSLindbladResult:
        """Unravel to ``t_final`` in ``n_steps`` steps, averaging
        ``n_trajectories`` trajectories run as one batch.

        ``initial``: computational-basis bit list (product states only);
        ``observables``: ``[(pauli_string, qubits)]`` recorded at t = 0
        and every ``record_every``-th step. ``mesh=`` (a
        ``parallel.ShardMesh``) splits the trajectories over its ranks,
        each rank running its contiguous block, and gathers the records:
        on the same draws the result is the one without a mesh (the
        generator's draws are then made for all trajectories first, in
        the order the steps would draw them)."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if record_every < 1 or n_steps % record_every:
            raise ValueError("record_every must divide n_steps")
        dtype = dtype or CONFIG.dtype
        n = self.num_qubits
        bits = list(initial) if initial is not None else [0] * n
        if len(bits) != n or any(b not in (0, 1) for b in bits):
            raise ValueError("initial must be n bits (product state)")
        obs_key = tuple((str(pstr).upper(), tuple(int(q) for q in qs))
                        for pstr, qs in observables)
        for pstr, qs in obs_key:
            _validated(n, [(1.0, pstr, list(qs))])
        dt = float(t_final) / n_steps
        gates = trotter_gates(self._terms, dt, self.order, self.device,
                              dtype)
        kstacks = [(q, torch.from_numpy(_kraus_pair(rate, L, dt)).to(
            self.device, dtype)) for rate, L, q in self._jumps]
        obs = [{qb: torch.from_numpy(_PAULI[ch]).to(self.device, dtype)
                for ch, qb in zip(pstr, qubits)}
               for pstr, qubits in obs_key]
        T, n_jump = n_trajectories, len(kstacks)
        gen = None
        if gumbels is not None:
            gumbels = torch.as_tensor(gumbels, dtype=torch.float32,
                                      device=self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            if mesh is not None and n_jump:
                gumbels = torch.stack([gumbel_from_uniform(torch.rand(
                    (T, n_jump, 2), generator=gen, device=self.device))
                    for _ in range(n_steps)], dim=1)

        def trajectories(rows: torch.Tensor, g=None):
            """Records ``(B, n_records, K)`` and discarded weights ``(B,)``
            of the ``B = len(rows)`` trajectories with Gumbel rows ``g``
            (None: the generator's, step by step)."""
            B = rows.shape[0]
            mps = _BatchMPS.product(bits, self.chi, B, self.device, dtype)

            def measure():
                if not obs:
                    return torch.zeros((B, 0), dtype=dtype.to_real(),
                                       device=self.device)
                return torch.stack([_expectation_pstr(mps.tensors, o)
                                    for o in obs], dim=1)

            recs = [measure()]
            for s in range(n_steps):
                for positions, gate in gates:
                    mps.apply(positions, gate)
                if n_jump:
                    g_step = (g[:, s] if g is not None else
                              gumbel_from_uniform(torch.rand(
                                  (B, n_jump, 2), generator=gen,
                                  device=self.device)))
                    for j, (q, kstack) in enumerate(kstacks):
                        mps.apply_kraus_1q(q, kstack, g_step[:, j])
                if (s + 1) % record_every == 0:
                    recs.append(measure())
            return torch.stack(recs, dim=1).double(), mps.discarded.double()

        rows = torch.arange(T, device=self.device)
        inputs = (rows,) if gumbels is None else (rows, gumbels)
        if mesh is None:
            recs, discarded = trajectories(*inputs)
        else:
            from .parallel.distributed import check_mesh
            recs, discarded = check_mesh(mesh).map_trials(trajectories,
                                                          *inputs)
        recs = recs.cpu().numpy()                             # (T, R, K)
        mean = recs.mean(axis=0).T
        err = (recs.std(axis=0, ddof=1).T / np.sqrt(T)
               if T > 1 else np.zeros_like(mean))
        return MPSLindbladResult(
            times=np.linspace(0.0, float(t_final),
                              n_steps // record_every + 1),
            expectations=mean,
            stderr=err,
            observable_labels=[f"{p}@{list(q)}" for p, q in obs_key],
            n_trajectories=T,
            truncation_weight=float(discarded.mean()))
