"""The port's DMRG (``dmrg.py``) against the JAX package's, on the CPU.

The JAX references are its jitted programs (one sweep program per
(n, D, chi, sweeps, K, previous states), compiled once per file). The same
Hamiltonian, start and sweep count go through both; the port's sweeps are
Python loops over the same padded stack, projector boundary, spectral
shift and branchless Lanczos. Tolerances:

* MPO stacks: equal (the same NumPy construction);
* DMRG energies, the last sweep's energy (a float32 Ritz value) and
  Lanczos Ritz values: 1e-5 of JAX's; truncation weights 1e-6. Earlier
  sweeps are not compared: from a product start the two-site splits are
  rank deficient, and the columns kept for zero singular values (to fill
  chi) span a subspace neither package defines, so the unconverged
  Ritz values of the first sweep differ (by 1e-4 to 1e-2 mid-sweep at
  K = 6) until the sweeps converge;
* states: ``|<jax|port>|`` within 1e-5 of 1 (the two LAPACKs may pick
  other phases and signs of the same factors);
* the excited-state sweep is fed JAX's own ground state (carried by
  ``interop.mps_state_from_numpy``) as its penalty state;
* the JAX tests' laws on the port alone: dense ``eigvalsh`` (2e-4, and
  5e-4 / 1e-3 for excited spectra), the free-fermion energy of the open
  TFIM chain (relative 1e-4 at n = 40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulator_tpu import dmrg as jd
from quantum_simulator_tpu_torch import dmrg as td
from quantum_simulator_tpu_torch import mps as tm
from quantum_simulator_tpu_torch.interop import mps_state_from_numpy
from quantum_simulator_tpu_torch.models.hamiltonians import (
    heisenberg_chain, tfim_chain)
from tests.oracle import dense_hamiltonian
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
E_TOL = 1e-5
TRUNC_TOL = 1e-6


def _mixed_terms(n):
    """Anisotropic Heisenberg + fields + a repeated term + a constant:
    every lane kind of the MPO."""
    return (heisenberg_chain(n, jx=0.7, jy=-0.4, jz=1.0)
            + [(-0.6, "X", [q]) for q in range(n)]
            + [(-0.3, "ZZ", [0, 1]), (0.8, "I", [0]), (0.2, "ZIZ", [0, 1, 2])])


CASES = {"mixed-chi4": (4, _mixed_terms(4), 4),
         "tfim-chi2": (4, tfim_chain(4, j=-1.0, h=-0.9), 2)}
SWEEPS, K = 3, 6


def _carry(js):
    return mps_state_from_numpy([np.asarray(t) for t in js.tensors],
                                js.num_qubits, js.chi, js.truncation_weight,
                                device=CPU)


@pytest.fixture(scope="module")
def ground():
    out = {}
    for name, (n, terms, chi) in CASES.items():
        jr = jd.dmrg_ground_state(terms, n, chi=chi, sweeps=SWEEPS,
                                  lanczos_k=K)
        tr = td.dmrg_ground_state(terms, n, chi=chi, sweeps=SWEEPS,
                                  lanczos_k=K, device=CPU)
        out[name] = (jr, tr)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_ground_state_matches_jax(ground, case):
    jr, tr = ground[case]
    assert tr.energy == pytest.approx(jr.energy, abs=E_TOL)
    assert tr.sweep_energies[-1] == pytest.approx(jr.sweep_energies[-1],
                                                  abs=E_TOL)
    assert tr.truncation_weight == pytest.approx(jr.truncation_weight,
                                                 abs=TRUNC_TOL)
    assert abs(tm.overlap(_carry(jr.state), tr.state)) == pytest.approx(
        1.0, abs=E_TOL)
    # The independent contraction on JAX's state gives JAX's energy.
    n, terms, _ = CASES[case]
    assert tm.expectation_hamiltonian(_carry(jr.state), terms) == \
        pytest.approx(jr.energy, abs=E_TOL)


def test_truncated_case_truncates(ground):
    assert ground["tfim-chi2"][0].truncation_weight > 1e-6
    assert ground["mixed-chi4"][1].truncation_weight < 1e-8


def test_excited_sweep_on_jax_penalty_state(ground):
    """The penalised sweep program fed JAX's ground state as the state to
    push away from, in both packages: the same Ritz values."""
    n, terms, chi = CASES["mixed-chi4"]
    jr, _ = ground["mixed-chi4"]
    penalty = 4.0 * sum(abs(c) for c, _, _ in terms) + 1.0
    bits = [1, 1, 0, 1]
    shift, w = jd._shifted_mpo(terms, n, jnp.complex64)
    _, j_es, j_disc = jd._run_program(
        n, int(w.shape[1]), chi, SWEEPS, K, jnp.complex64, w,
        jd._product_stack(n, chi, bits, jnp.complex64),
        jnp.stack([jd._pad_state_stack(jr.state, chi)]),
        jnp.float32(penalty))
    t_shift, t_w = td._shifted_mpo(terms, n, torch.complex64, CPU)
    assert t_shift == shift
    phis = torch.stack([td._pad_state_stack(_carry(jr.state), chi)])
    _, t_es, t_disc = td._run_sweeps(
        t_w, td._product_stack(n, chi, bits, torch.complex64, CPU), phis,
        float(np.float32(penalty)), chi, SWEEPS, K)
    assert float(t_es[-1]) == pytest.approx(float(j_es[-1]), abs=E_TOL)
    assert float(t_disc) == pytest.approx(float(j_disc), abs=TRUNC_TOL)


def test_excited_states_match_jax():
    n, terms, chi = CASES["mixed-chi4"]
    want = jd.dmrg_excited_states(terms, n, n_states=2, chi=chi,
                                  sweeps=SWEEPS, lanczos_k=K)
    got = td.dmrg_excited_states(terms, n, n_states=2, chi=chi,
                                 sweeps=SWEEPS, lanczos_k=K, device=CPU)
    np.testing.assert_allclose([r.energy for r in got],
                               [r.energy for r in want], atol=E_TOL)
    for a, b in zip(want, got):
        assert abs(tm.overlap(_carry(a.state), b.state)) == pytest.approx(
            1.0, abs=E_TOL)


@pytest.mark.parametrize("n,terms", [(8, tfim_chain(8)),
                                     (8, heisenberg_chain(8)),
                                     (6, _mixed_terms(6))],
                         ids=["tfim", "heisenberg", "mixed"])
def test_mpo_stack_equals_jax(n, terms):
    want = np.asarray(jd.terms_to_mpo(n, terms))
    got = td.terms_to_mpo(n, terms, device=CPU).numpy()
    np.testing.assert_array_equal(got, want)


def test_lanczos_ritz_value_matches_jax():
    """One local solve: the same Hermitian matrix, start and K."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    h = (a + a.conj().T).astype(np.complex64)
    v0 = (rng.standard_normal(16) + 0j).astype(np.complex64)
    hj = jnp.asarray(h)
    ej, vj = jax.jit(lambda v: jd._lanczos_ground(lambda x: hj @ x, v, 6))(
        jnp.asarray(v0))
    ht = torch.from_numpy(h)
    et, vt = td._lanczos_ground(lambda v: ht @ v, torch.from_numpy(v0), 6)
    assert float(et) == pytest.approx(float(ej), abs=E_TOL)
    assert abs(np.vdot(np.asarray(vj), vt.numpy())) == pytest.approx(
        1.0, abs=E_TOL)
    # A Krylov space that closes early (rank-2 operator): the dead
    # vectors are penalised, not divided by zero.
    low = np.outer(v0, v0.conj()).astype(np.complex64)
    lt = torch.from_numpy(low)
    e2, v2 = td._lanczos_ground(lambda v: lt @ v, torch.from_numpy(v0), 6)
    assert torch.isfinite(torch.view_as_real(v2)).all()
    assert float(e2) == pytest.approx(0.0, abs=1e-4)


# --- the JAX tests' laws on the port alone (tests/test_dmrg.py) -------------

def tfim_exact_open(n, j, h):
    m = np.diag(np.full(n, -h)) + np.diag(np.full(n - 1, -j), 1)
    return -np.sum(np.linalg.svd(m, compute_uv=False))


def _law_tfim_dense():
    n, terms = 6, tfim_chain(6, j=-1.0, h=-0.9)
    want = np.linalg.eigvalsh(dense_hamiltonian(n, terms))[0]
    res = td.dmrg_ground_state(terms, n, chi=8, sweeps=4, lanczos_k=10,
                               device=CPU)
    assert isinstance(res, td.DMRGResult)
    assert res.energy == pytest.approx(want, abs=2e-4)
    assert res.truncation_weight < 1e-8
    assert res.sweep_energies[-1] == pytest.approx(res.energy, abs=2e-4)


def _law_heisenberg_dense():
    n, terms = 6, heisenberg_chain(6, jx=0.7, jy=-0.4, jz=1.0)
    want = np.linalg.eigvalsh(dense_hamiltonian(n, terms))[0]
    res = td.dmrg_ground_state(terms, n, chi=8, sweeps=4, lanczos_k=10,
                               device=CPU)
    assert res.energy == pytest.approx(want, abs=2e-4)


def _law_free_fermions_40():
    n, j, h = 40, -1.0, -0.8
    assert tfim_exact_open(8, j, h) == pytest.approx(np.linalg.eigvalsh(
        dense_hamiltonian(8, tfim_chain(8, j=j, h=h)))[0], abs=1e-10)
    res = td.dmrg_ground_state(tfim_chain(n, j=j, h=h), n, chi=12,
                               sweeps=4, lanczos_k=10, device=CPU)
    want = tfim_exact_open(n, j, h)
    assert abs(res.energy - want) / abs(want) < 1e-4


def _law_constant_and_duplicate_terms():
    n = 4
    terms = [(-1.0, "ZZ", [0, 1]), (-1.0, "ZZ", [0, 1]),
             (2.5, "I", [0]), (-0.7, "X", [2])]
    want = np.linalg.eigvalsh(dense_hamiltonian(n, terms))[0]
    res = td.dmrg_ground_state(terms, n, chi=4, sweeps=3, device=CPU)
    assert res.energy == pytest.approx(want, abs=2e-4)
    assert td.terms_to_mpo(8, tfim_chain(8), device=CPU).shape == \
        (8, 3, 3, 2, 2)
    assert td.terms_to_mpo(8, heisenberg_chain(8), device=CPU).shape == \
        (8, 5, 5, 2, 2)


def _law_validation():
    for kw in ({"chi": 1}, {"sweeps": 0}, {"lanczos_k": 1},
               {"init_bits": [0, 1]}, {"init_bits": [0, 1, 2, 0]}):
        with pytest.raises(ValueError):
            td.dmrg_ground_state(tfim_chain(4), 4, device=CPU, **kw)
    with pytest.raises(ValueError):
        td.dmrg_ground_state([(1.0, "Z", [0])], 1, device=CPU)
    with pytest.raises(ValueError):
        td.dmrg_excited_states(tfim_chain(4), 4, n_states=0, device=CPU)
    res = td.dmrg_excited_states(tfim_chain(4), 4, n_states=1, chi=4,
                                 sweeps=2, device=CPU)
    assert len(res) == 1


def _law_observables():
    n = 10
    terms = tfim_chain(n, j=-0.1, h=-1.0)
    res = td.dmrg_ground_state(terms, n, chi=8, sweeps=4, device=CPU)
    for q in (0, n // 2, n - 1):
        assert tm.expectation_pauli_string(res.state, {q: "X"}) > 0.95
    assert 0.0 <= tm.entanglement_entropy(res.state, n // 2 - 1) < 0.2
    assert tm.expectation_hamiltonian(res.state, terms) == \
        pytest.approx(res.energy, abs=1e-5)


def _law_ferromagnet():
    n = 12
    terms = ([(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
             + [(-0.05, "Z", [i]) for i in range(n)]
             + [(-0.02, "X", [i]) for i in range(n)])
    res = td.dmrg_ground_state(terms, n, chi=6, sweeps=5, device=CPU)
    p0 = abs(tm.amplitude(res.state, "0" * n)) ** 2
    p1 = abs(tm.amplitude(res.state, "1" * n)) ** 2
    assert p0 + p1 > 0.98
    res2 = td.dmrg_ground_state(terms, n, chi=6, sweeps=3,
                                init_bits=[0] * n, device=CPU)
    assert abs(tm.amplitude(res2.state, "0" * n)) ** 2 > 0.98
    assert res2.energy == pytest.approx(-(n - 1) - 0.05 * n, abs=1e-2)
    assert res2.energy < res.energy + 1e-3


def _law_excited_spectrum():
    n, terms = 6, tfim_chain(6, j=-1.0, h=-0.9)
    want = np.linalg.eigvalsh(dense_hamiltonian(n, terms))[:3]
    res = td.dmrg_excited_states(terms, n, n_states=3, chi=8, sweeps=5,
                                 device=CPU)
    np.testing.assert_allclose([r.energy for r in res], want, atol=5e-4)
    for i in range(3):
        for j in range(i + 1, 3):
            assert abs(tm.overlap(res[i].state, res[j].state)) < 1e-4


def _law_near_degenerate_pair():
    n = 8
    terms = tfim_chain(n, j=-1.0, h=-0.1)
    want = np.linalg.eigvalsh(dense_hamiltonian(n, terms))[:3]
    got = [r.energy for r in td.dmrg_excited_states(
        terms, n, n_states=3, chi=8, sweeps=6, device=CPU)]
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert got[1] - got[0] < 0.01 and got[2] - got[1] > 1.0


LAWS = {"tfim-dense": _law_tfim_dense,
        "heisenberg-dense": _law_heisenberg_dense,
        "free-fermions-40": _law_free_fermions_40,
        "constant-duplicate": _law_constant_and_duplicate_terms,
        "validation": _law_validation, "observables": _law_observables,
        "ferromagnet": _law_ferromagnet,
        "excited-spectrum": _law_excited_spectrum,
        "near-degenerate": _law_near_degenerate_pair}


@pytest.mark.parametrize("name", list(LAWS))
def test_laws_on_the_port(name):
    LAWS[name]()
