"""Dynamical two-point correlators at MPS widths.

Counterpart of ``quantum_simulator_tpu/correlators.py``.
``C_ij(t) = <psi| P_i(t) P_j |psi>`` is a mixed matrix element, so two
states evolve under the same Trotter circuit,

    C_ij(t) = <psi(t)| P_i |phi(t)>,    |phi(0)> = P_j |psi(0)>,

and one operator-inserted transfer contraction reads each record point.
The two evolutions share their bond profile (a one-site Pauli changes no
bond), so the port runs them as the two rows of one batch of MPS
(``mps._BatchMPS``), each truncated on its own, as the JAX package's two
traced evolutions are. It loops every step and records at t = 0 and every
``record_every``-th step, the points of the JAX package's record windows.
The evolutions run in ``CONFIG.dtype`` (complex128 under
``config.enable_complex128``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CONFIG
from .lindblad_mps import trotter_gates
from .models.trotter import _PAULI, _validated
from .mps import MPSState, _BatchMPS, _transfer

__all__ = ["mps_two_point_correlator"]


def _mixed_element(mps: _BatchMPS, site: int, op: torch.Tensor):
    """``<row 0| op_site |row 1>`` by one transfer contraction."""
    t0 = mps.tensors[0]
    env = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
    for i, t in enumerate(mps.tensors):
        ket = t[1] if i != site else op @ t[1]
        env = _transfer(env, t[0], ket)
    return env[0, 0]


def mps_two_point_correlator(num_qubits: int, hamiltonian_terms,
                             t_final: float, n_steps: int,
                             site_i: int, site_j: int,
                             pauli_i: str = "Z", pauli_j: str = "Z",
                             chi: int = 32, initial=None,
                             record_every: int = 1,
                             order: int = 2, dtype=None, device=None):
    """-> ``(times, C)`` with ``C[k] = <psi(t_k)| P_i |phi(t_k)>``
    complex128, ``t_k`` the record grid (t = 0 first).

    ``initial`` is a product-state bit list (default all zeros) or any
    ``MPSState`` (a DMRG ground state turns the correlator into
    spectroscopy); an MPS start is re-canonicalised by two norm-preserving
    QR sweeps on entry. Runs on ``device`` (default ``CONFIG.device``; an
    ``MPSState`` start is moved there)."""
    n = num_qubits
    if not (0 <= site_i < n and 0 <= site_j < n):
        raise ValueError("correlator sites out of range")
    if pauli_i not in "XYZ" or pauli_j not in "XYZ":
        raise ValueError("pauli_i/pauli_j must be X, Y, or Z")
    if n_steps < 1 or record_every < 1 or n_steps % record_every:
        raise ValueError("record_every must divide n_steps (both >= 1)")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    dtype = dtype or CONFIG.dtype
    device = device or CONFIG.device
    terms = _validated(n, list(hamiltonian_terms))
    if isinstance(initial, MPSState):
        if initial.num_qubits != n:
            raise ValueError("initial MPSState has wrong qubit count")
        mps = _BatchMPS([t.to(device, dtype)[None].expand(2, -1, -1, -1)
                         for t in initial.tensors], chi)
        # Two QR sweeps (norm-preserving, no truncation): the truncation
        # discipline must not trust the caller's canonical form.
        mps.move_center_to(n - 1)
        mps.move_center_to(0)
    else:
        bits = list(initial) if initial is not None else [0] * n
        if len(bits) != n or any(b not in (0, 1) for b in bits):
            raise ValueError("initial must be n bits (product state) "
                             "or an MPSState")
        mps = _BatchMPS.product(bits, chi, 2, device, dtype)
    gates = trotter_gates(terms, float(t_final) / n_steps, order, device,
                          dtype)
    op_i = torch.from_numpy(_PAULI[pauli_i]).to(device, dtype)
    # Row 1 gets P_j: |phi(0)> = P_j |psi(0)> (a one-site unitary keeps
    # the canonical form).
    mps.apply_1q(site_j, torch.stack([
        torch.eye(2, dtype=dtype, device=device),
        torch.from_numpy(_PAULI[pauli_j]).to(device, dtype)]))

    recs = [_mixed_element(mps, site_i, op_i)]
    for s in range(n_steps):
        for positions, g in gates:
            mps.apply(positions, g)
        if (s + 1) % record_every == 0:
            recs.append(_mixed_element(mps, site_i, op_i))
    times = np.linspace(0.0, float(t_final), n_steps // record_every + 1)
    return times, torch.stack(recs).cpu().numpy().astype(np.complex128)
