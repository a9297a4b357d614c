"""DMRG ground-state search on the MPS engine: ground states of local
Hamiltonians at 100+ qubits.

Counterpart of ``quantum_simulator_tpu/dmrg.py``, with its algorithm kept
as it is; only the loops change. The JAX package compiles the whole
multi-sweep optimisation into one program (``lax.scan`` over sweeps and
half-sweeps); the port runs the same sweeps as Python loops over device
tensors:

* the Hamiltonian lowers once to a matrix-product operator by the
  finite-state-machine construction (one "ready" lane, one "done" lane,
  one in-flight lane per term crossing each bond), padded to a uniform
  ``(D, D, 2, 2)`` stack;
* the state is the padded ``(n, chi, 2, chi)`` stack with the projector
  boundary (edge bond index 0 only) and the spectral shift
  (``_shifted_mpo``): with them the padding is inert and the
  excited-state penalty cannot escape into the unphysical edge indices;
* each local two-site problem is solved by a fixed-K Lanczos iteration
  with full re-orthogonalisation, branchless on breakdown (dead Krylov
  vectors zero out and get a +1e9 diagonal penalty; no host read inside a
  sweep), then split by a truncated SVD with the discarded-weight ledger.

The returned ``MPSState`` has its orthogonality centre at site 0, so the
whole observable surface of ``mps`` applies. Ritz values, sweep energies
and discarded weights are in the state's real precision: float32, as in
the JAX package, or float64 under ``config.enable_complex128`` (with the
Lanczos tridiagonal, which JAX builds in float32 in its mode too; the
breakdown threshold stays JAX's 1e-6).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import CONFIG
from .mps import (MPSState, _PAULI_2X2, _parse_terms, expectation_hamiltonian,
                  thin_svd)


class DMRGResult(NamedTuple):
    """Ground-state search result.

    ``energy`` is re-measured on the final state by an independent
    contraction (``mps.expectation_hamiltonian``), not the last Ritz
    value; ``sweep_energies`` traces the Lanczos ground-energy estimate
    at the end of each sweep; ``truncation_weight`` is the squared
    Schmidt weight the final sweep discarded."""

    energy: float
    state: MPSState
    sweep_energies: list
    truncation_weight: float


# --------------------------------------------------------------------------
# Pauli-term list -> MPO (finite-state-machine construction)
# --------------------------------------------------------------------------


def terms_to_mpo(num_qubits: int, terms, dtype=None,
                 device=None) -> torch.Tensor:
    """Lower ``(coeff, pauli_string, qubits)`` terms to a padded MPO stack
    ``W[n, D, D, 2, 2]`` on ``device`` with boundary lanes 0 ("ready")
    and D-1 ("done"). Each multi-site term occupies one in-flight lane on
    every bond its support strictly crosses, so D = 2 + max crossing
    count (3 for a ZZ chain, 5 for Heisenberg). Identity-only terms fold
    into the done lane at site 0."""
    dtype = dtype or CONFIG.dtype
    parsed = _parse_terms(num_qubits, terms)
    n = num_qubits
    lanes: list[dict] = [{} for _ in range(n + 1)]
    for ti, (coeff, ops, a, c) in enumerate(parsed):
        if not ops or a == c:
            continue
        for b in range(a + 1, c + 1):
            lanes[b][ti] = 1 + len(lanes[b])
    d_max = 2 + max((len(x) for x in lanes), default=0)
    w = np.zeros((n, d_max, d_max, 2, 2), dtype=np.complex128)
    eye = np.eye(2)
    done = d_max - 1
    for i in range(n):
        w[i, 0, 0] = eye
        w[i, done, done] = eye
    for ti, (coeff, ops, a, c) in enumerate(parsed):
        if not ops:
            w[0, 0, done] += coeff * eye
            continue
        p = {q: _PAULI_2X2[s] for q, s in ops.items()}
        if a == c:
            w[a, 0, done] += coeff * p[a]
            continue
        w[a, 0, lanes[a + 1][ti]] = coeff * p[a]
        for i in range(a + 1, c):
            w[i, lanes[i][ti], lanes[i + 1][ti]] = p.get(i, eye)
        w[c, lanes[c][ti], done] = p[c]
    return torch.from_numpy(w).to(device=device or CONFIG.device,
                                  dtype=dtype)


# --------------------------------------------------------------------------
# Local solver: fixed-K Lanczos with full re-orthogonalisation
# --------------------------------------------------------------------------


def _lanczos_ground(matvec, theta0: torch.Tensor, k: int):
    """Lowest Ritz (value, vector) of the Hermitian operator ``matvec``
    from start ``theta0`` in K Lanczos steps. Breakdown (beta ~ 0) is
    handled without a branch: dead Krylov vectors zero out and their
    tridiagonal diagonal gets a +1e9 penalty."""
    shape = theta0.shape
    v = theta0.reshape(-1)
    v = v / torch.vdot(v, v).real.clamp_min(1e-30).sqrt()
    vs = [v]
    real = v.dtype.to_real()
    one = torch.ones((), dtype=real, device=v.device)
    alive = [one]
    alphas, betas = [], []
    w = matvec(v.reshape(shape)).reshape(-1)
    alphas.append(torch.vdot(v, w).real)
    w = w - alphas[0].to(v.dtype) * v
    for _ in range(1, k):
        for u in vs:
            w = w - torch.vdot(u, w) * u
        b = torch.vdot(w, w).real.clamp_min(0.0).sqrt()
        ok = (b > 1e-6).to(real)
        v = torch.where(ok > 0, w / b.clamp_min(1e-30).to(w.dtype),
                        torch.zeros_like(w))
        vs.append(v)
        alive.append(alive[-1] * ok)
        betas.append(b * alive[-1])
        w = matvec(v.reshape(shape)).reshape(-1)
        alphas.append(torch.vdot(v, w).real)
        w = w - alphas[-1].to(v.dtype) * v
    m = torch.stack(alive)
    tri = torch.diag(torch.stack(alphas).to(real) * m + (1.0 - m) * 1e9)
    if betas:
        off = torch.stack(betas).to(real) * m[1:]
        tri = tri + torch.diag(off, 1) + torch.diag(off, -1)
    evals, evecs = torch.linalg.eigh(tri)
    c = evecs[:, 0].to(v.dtype)
    ground = (c[:, None] * torch.stack(vs)).sum(0)
    ground = ground / torch.vdot(ground, ground).real.clamp_min(
        1e-30).sqrt().to(ground.dtype)
    return evals[0], ground.reshape(shape)


# --------------------------------------------------------------------------
# Sweeps
# --------------------------------------------------------------------------


def _heff_matvec(lc, w1, w2, rc):
    """Two-site effective Hamiltonian as a matvec closure. Environments
    lc[d, bra, ket], rc[f, bra, ket]; MPO w[d, e, p, p'] with p the output
    (bra-side) physical index."""

    def mv(v):  # v[l', p', q', r'] -> out[l, p, q, r]
        x = torch.einsum("dab,bpqr->dapqr", lc, v)
        x = torch.einsum("depP,daPqr->eapqr", w1, x)
        x = torch.einsum("efqQ,eapQr->fapqr", w2, x)
        return torch.einsum("fbc,fapqc->apqb", rc, x)

    return mv


def _split_theta(theta: torch.Tensor, chi: int, right_canonical: bool):
    """Truncated SVD split of theta[l, 2, 2, r] at the middle bond ->
    (left[l, 2, k], right[k, 2, r], discarded weight)."""
    l, r = theta.shape[0], theta.shape[3]
    u, s, vh = thin_svd(theta.reshape(l * 2, 2 * r))
    k = min(l * 2, 2 * r, chi)
    sk = s[:k]
    kept = (sk * sk).sum()
    disc = ((s * s).sum() - kept).clamp_min(0.0)
    sk = sk / kept.clamp_min(1e-30).sqrt()
    if right_canonical:
        left = (u[:, :k] * sk[None, :].to(u.dtype)).reshape(l, 2, k)
        right = vh[:k, :].reshape(k, 2, r)
    else:
        left = u[:, :k].reshape(l, 2, k)
        right = (sk[:, None].to(vh.dtype) * vh[:k, :]).reshape(k, 2, r)
    return left, right, disc


def _l_update(lc, w1, a):
    """einsum("dab,apc,depP,bPf->ecf", lc, conj(a), w1, a), pairwise."""
    x = torch.einsum("dab,bPf->daPf", lc, a)
    x = torch.einsum("depP,daPf->eapf", w1, x)
    return torch.einsum("apc,eapf->ecf", a.conj(), x)


def _r_update(rc, w2, a):
    """einsum("efqQ,aqc,bQg,fcg->eab", w2, conj(a), a, rc), pairwise."""
    x = torch.einsum("bQg,fcg->fbQc", a, rc)
    x = torch.einsum("efqQ,fbQc->ebqc", w2, x)
    return torch.einsum("aqc,ebqc->eab", a.conj(), x)


def _lov_update(lov, phi_i, a):
    """lov[j, bra, ket] through one site of (conj(a), phi_j)."""
    x = torch.einsum("jlk,jkpb->jlpb", lov, phi_i)
    return torch.einsum("lpa,jlpb->jab", a.conj(), x)


def _rov_update(rov, phi_i1, a):
    x = torch.einsum("jrg,jbqg->jbqr", rov, phi_i1)
    return torch.einsum("aqr,jbqr->jab", a.conj(), x)


def _penalty_vectors(phis, lov_i, rov_i2, i: int):
    """v_j[l, p, q, r]: phi_j's coefficients in the current
    mixed-canonical two-site basis."""
    x = torch.einsum("jlk,jkpm->jlpm", lov_i, phis[:, i])
    x = torch.einsum("jlpm,jmqb->jlpqb", x, phis[:, i + 1])
    return torch.einsum("jlpqb,jrb->jlpqr", x, rov_i2)


def _run_sweeps(w_stack, a_stack, phis, w_pen: float, chi: int,
                sweeps: int, k: int):
    """The sweep program: -> (final padded stack as a list of site
    tensors, sweep energies (sweeps,) in the state's real dtype, last
    sweep's discarded weight). ``phis`` (n_prev, n, chi, 2, chi) are
    earlier states whose projectors the local solves penalise with weight
    ``w_pen``."""
    n, d = w_stack.shape[0], w_stack.shape[1]
    dtype, device = a_stack.dtype, a_stack.device
    n_prev = phis.shape[0]
    a = list(a_stack.unbind(0))

    def boundary_env(lane):
        # Projector boundary (edge bond index 0 only), not the identity:
        # an identity boundary hands every unphysical edge index a full
        # copy of the spectrum, which the excited-state penalty cannot
        # see (the penalised states live at index 0), so the sweeps would
        # escape into it and find the penalised states again. With
        # projectors the unphysical edge components are exact H_eff
        # zero-modes, and the spectral shift keeps the physical minimum
        # strictly below zero.
        e = torch.zeros((d, chi, chi), dtype=dtype, device=device)
        e[lane, 0, 0] = 1.0
        return e

    def boundary_ov():
        e = torch.zeros((n_prev, chi, chi), dtype=dtype, device=device)
        e[:, 0, 0] = 1.0
        return e

    renv = [None] * (n + 1)
    rov = [None] * (n + 1)
    renv[n], rov[n] = boundary_env(d - 1), boundary_ov()
    for i in range(n - 1, -1, -1):
        renv[i] = _r_update(renv[i + 1], w_stack[i], a[i])
        rov[i] = (_rov_update(rov[i + 1], phis[:, i], a[i]) if n_prev
                  else rov[i + 1])
    lenv = [boundary_env(0)] + [None] * n
    lov = [boundary_ov()] + [None] * n

    def local_solve(i, lc, rc, right_canonical, vjs):
        w1, w2 = w_stack[i], w_stack[i + 1]
        theta = torch.einsum("lpa,aqr->lpqr", a[i], a[i + 1])
        base_mv = _heff_matvec(lc, w1, w2, rc)
        if n_prev:
            def mv(v):
                amps = torch.einsum("jlpqr,lpqr->j", vjs.conj(), v)
                return base_mv(v) + w_pen * torch.einsum(
                    "j,jlpqr->lpqr", amps, vjs)
        else:
            mv = base_mv
        e, theta = _lanczos_ground(mv, theta, k)
        left, right, disc = _split_theta(theta, chi, right_canonical)
        a[i], a[i + 1] = left, right
        return e, disc

    energies, disc = [], None
    for _ in range(sweeps):
        # Left -> right: renv entries right of i+1 are from the previous
        # right-to-left pass and stay valid until this pass reaches them;
        # the overlap environments follow the same discipline.
        for i in range(n - 1):
            vjs = (_penalty_vectors(phis, lov[i], rov[i + 2], i)
                   if n_prev else None)
            local_solve(i, lenv[i], renv[i + 2], False, vjs)
            lenv[i + 1] = _l_update(lenv[i], w_stack[i], a[i])
            if n_prev:
                lov[i + 1] = _lov_update(lov[i], phis[:, i], a[i])
        # Right -> left; the ledger restarts so the reported weight is
        # the final pass's.
        disc = torch.zeros((), dtype=dtype.to_real(), device=device)
        for i in range(n - 2, -1, -1):
            vjs = (_penalty_vectors(phis, lov[i], rov[i + 2], i)
                   if n_prev else None)
            e, dsc = local_solve(i, lenv[i], renv[i + 2], True, vjs)
            disc = disc + dsc
            renv[i + 1] = _r_update(renv[i + 2], w_stack[i + 1], a[i + 1])
            if n_prev:
                rov[i + 1] = _rov_update(rov[i + 2], phis[:, i + 1],
                                         a[i + 1])
        energies.append(e)
    return a, torch.stack(energies), disc


def _product_stack(n: int, chi: int, bits, dtype, device) -> torch.Tensor:
    a0 = np.zeros((n, chi, 2, chi), dtype=np.complex128)
    for i, b in enumerate(bits):
        a0[i, 0, b, 0] = 1.0
    return torch.from_numpy(a0).to(device=device, dtype=dtype)


def _wrap_result(a_final, energies, disc, n, chi, terms, shift):
    """Trim the edge bonds to 1 (exact: H_eff is a projector on the padded
    edge index) and re-measure the energy by the independent
    contraction."""
    tensors = list(a_final)
    tensors[0] = tensors[0][:1]
    tensors[-1] = tensors[-1][:, :, :1]
    state = MPSState(tuple(tensors), n, chi, float(disc))
    return DMRGResult(expectation_hamiltonian(state, terms), state,
                      [float(e) + shift for e in energies.cpu().numpy()],
                      float(disc))


def _shifted_mpo(terms, n, dtype, device):
    """(shift, MPO) with the spectral shift -(sum|coeff| + 1) folded in:
    sum|coeff| bounds the spectral radius, so the shifted H is strictly
    negative definite and the projector-boundary zero-modes can never win
    a local minimisation."""
    shift = sum(abs(float(c)) for c, _, _ in terms) + 1.0
    return shift, terms_to_mpo(n, list(terms) + [(-shift, "I", [0])],
                               dtype, device)


def _pad_state_stack(state: MPSState, chi: int) -> torch.Tensor:
    """An MPSState's ragged tensors padded to a (n, chi, 2, chi) stack
    (for the excited-state penalty environments)."""
    out = []
    for t in state.tensors:
        l, _, r = t.shape
        if l > chi or r > chi:
            raise ValueError(
                f"previous state has bond dim {max(l, r)} > chi={chi}; "
                "excited-state sweeps need chi >= every prior state's")
        out.append(torch.nn.functional.pad(t, (0, chi - r, 0, 0,
                                               0, chi - l)))
    return torch.stack(out)


def dmrg_ground_state(terms, num_qubits: int, chi: int = 32,
                      sweeps: int = 4, lanczos_k: int = 12,
                      init_bits=None, device=None) -> DMRGResult:
    """Ground state of ``H = sum coeff * P`` by two-site DMRG on
    ``device`` (default ``CONFIG.device``).

    ``terms`` uses the ``models.hamiltonians`` format. ``init_bits``
    seeds the search with a product state (default: the Neel pattern
    0101...). A purely diagonal Hamiltonian makes every basis state an
    exact H_eff eigenstate, so the local solves cannot flow away from a
    product-state start: pass the intended ``init_bits`` or add a small
    transverse field."""
    n = int(num_qubits)
    if n < 2:
        raise ValueError("DMRG needs at least 2 sites")
    if chi < 2:
        raise ValueError("chi must be >= 2")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    if lanczos_k < 2:
        raise ValueError("lanczos_k must be >= 2")
    terms = [tuple(t) for t in terms]   # a one-shot iterable is read twice
    dtype = CONFIG.dtype
    device = device or CONFIG.device
    shift, w_stack = _shifted_mpo(terms, n, dtype, device)
    if init_bits is None:
        init_bits = [i % 2 for i in range(n)]
    init_bits = [int(b) for b in init_bits]
    if len(init_bits) != n or any(b not in (0, 1) for b in init_bits):
        raise ValueError("init_bits must be n entries of 0/1")
    phis = torch.zeros((0, n, chi, 2, chi), dtype=dtype, device=device)
    a_final, energies, disc = _run_sweeps(
        w_stack, _product_stack(n, chi, init_bits, dtype, device), phis,
        0.0, chi, int(sweeps), int(lanczos_k))
    return _wrap_result(a_final, energies, disc, n, chi, terms, shift)


def dmrg_excited_states(terms, num_qubits: int, n_states: int = 2,
                        chi: int = 32, sweeps: int = 4,
                        lanczos_k: int = 12, penalty: float | None = None,
                        init_bits=None, device=None) -> list[DMRGResult]:
    """The ``n_states`` lowest eigenstates by penalised DMRG: state k
    minimises ``H + w * sum_{j<k} |psi_j><psi_j|``.

    ``penalty`` defaults to ``4 * sum|coeff| + 1``, which lifts every
    penalised state above the whole physical spectrum. The k-th excited
    search seeds from the base start (``init_bits`` or Neel) with site
    ``k-1`` flipped. Residual overlaps are not enforced beyond the
    penalty (check them with ``mps.overlap``)."""
    if n_states < 1:
        raise ValueError("n_states must be >= 1")
    n = int(num_qubits)
    dtype = CONFIG.dtype
    device = device or CONFIG.device
    terms = [tuple(t) for t in terms]
    if penalty is None:
        penalty = 4.0 * sum(abs(float(c)) for c, _, _ in terms) + 1.0
    results = [dmrg_ground_state(terms, n, chi=chi, sweeps=sweeps,
                                 lanczos_k=lanczos_k, init_bits=init_bits,
                                 device=device)]
    if init_bits is None:
        init_bits = [i % 2 for i in range(n)]
    shift, w_stack = _shifted_mpo(terms, n, dtype, device)
    for k in range(1, n_states):
        phis = torch.stack([_pad_state_stack(r.state, chi).to(device)
                            for r in results])
        bits = list(init_bits)
        bits[(k - 1) % n] ^= 1  # symmetry-breaking kick
        w_pen = (float(penalty) if dtype == torch.complex128
                 else float(np.float32(penalty)))
        a_final, energies, disc = _run_sweeps(
            w_stack, _product_stack(n, chi, bits, dtype, device), phis,
            w_pen, chi, int(sweeps), int(lanczos_k))
        results.append(_wrap_result(a_final, energies, disc, n, chi,
                                    terms, shift))
    results.sort(key=lambda r: r.energy)
    return results
