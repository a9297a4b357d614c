"""The port's MPS Lindblad trajectories (``lindblad_mps.py``) and
two-point correlators (``correlators.py``) against the JAX package's, on
the CPU.

JAX's ``MPSLindbladSimulator.evolve`` ``vmap``s one traced trajectory;
the reference jits and ``vmap``s that trajectory body with its jump draws
read from a table (``tests/torch_jax_draws.py``: ``jax_keyed_table``)
filled with JAX's own draws (its key schedule recomputed bit for bit in
NumPy), and the port is fed the same Gumbel rows (``gumbels=``), so
every jump is JAX's. The correlator has no draws: its JAX reference is
the jitted entry point. Tolerances:

* ``lindblad_mps`` records (the means and standard errors over the
  trajectories) identical under JAX's draws within 1e-5, with under 1 %
  of the port's draws within 1e-5 of a tie; the mean truncation weight
  within 1e-6;
* correlator values within 1e-5 of JAX's (float32 records, complex64
  contractions in another order), from a product state and from an
  ``MPSState`` carried from the JAX package;
* the JAX tests' laws on the port alone: the dense ``LindbladSimulator``
  (4 standard errors + 0.025), closed-form decay and dephasing, dense
  ``eigh`` / ``expm`` correlators (5e-4, and 1e-3 from a DMRG start).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import correlators as jc
from quantum_simulator_tpu import lindblad_mps as jl
from quantum_simulator_tpu import mps as jm
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import correlators as tc
from quantum_simulator_tpu_torch import lindblad_mps as tl
from quantum_simulator_tpu_torch.interop import mps_state_from_numpy
from quantum_simulator_tpu_torch.lindblad import (LindbladSimulator,
                                                  _pauli_term_matrix)
from tests import torch_jax_draws as D

CPU = "cpu"
TOL = 1e-5

H3 = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2]), (0.7, "X", [0]),
      (0.7, "X", [1]), (0.7, "X", [2]), (0.4, "XY", [0, 2])]
J3 = [(0.6, "sigma_minus", 0), (0.5, "z", 2), (0.3, "sigma_plus", 1)]
OBS3 = [("Z", [0]), ("X", [1]), ("ZZ", [0, 1]), ("YX", [2, 0])]


def test_trajectories_are_jax_draw_for_draw():
    """Second order (the default); the first-order Trotter step is the
    same ``trotter_gates`` the correlator test holds to JAX at order 1."""
    T, steps, every, seed, chi, order = 4, 6, 3, 7, 2, 2
    obs_key = tuple((p, tuple(q)) for p, q in OBS3)
    jsim = jl.MPSLindbladSimulator(3, H3, J3, chi=chi, order=order)
    one = jsim._build(steps, every, obs_key, 0.9 / steps, [0, 1, 0],
                      jnp.complex64).__wrapped__.__wrapped__
    g = D.lindblad_mps_gumbels(seed, T, steps, len(J3))

    def traj(table):
        with D.jax_keyed_table(table):
            return one(jnp.zeros(2, jnp.uint32))

    recs, disc = jax.jit(jax.vmap(traj))(
        jnp.asarray(g.reshape(T, steps * len(J3), 2)))
    recs = np.asarray(recs, np.float64)                  # (T, R, K)
    log = []
    with D.port_draws(log):
        got = tl.MPSLindbladSimulator(3, H3, J3, chi=chi, order=order,
                                      device=CPU).evolve(
            0.9, steps, n_trajectories=T, initial=[0, 1, 0],
            observables=OBS3, record_every=every, gumbels=g)
    margins = np.stack([m for _, m in log], axis=1)
    assert (margins < 1e-5).sum() <= 0.01 * margins.size
    np.testing.assert_allclose(got.expectations, recs.mean(0).T, atol=TOL)
    np.testing.assert_allclose(got.stderr, recs.std(0, ddof=1).T
                               / np.sqrt(T), atol=TOL)
    np.testing.assert_allclose(got.times, np.linspace(0, 0.9, 3))
    assert got.truncation_weight == pytest.approx(float(np.mean(disc)),
                                                  abs=1e-6)
    assert got.observable_labels == [f"{p}@{q}" for p, q in OBS3]


def _terms(n, field=0.7):
    return ([(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
            + [(field, "X", [i]) for i in range(n)])


def test_correlator_from_product_state_matches_jax():
    terms = _terms(3) + [(0.3, "YZ", [0, 2])]
    kw = dict(site_i=1, site_j=2, pauli_i="Z", pauli_j="Y", chi=4,
              record_every=2)
    times, want = jc.mps_two_point_correlator(3, terms, 0.6, 4, **kw)
    got_t, got = tc.mps_two_point_correlator(3, terms, 0.6, 4, device=CPU,
                                             **kw)
    np.testing.assert_allclose(got_t, times)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert np.abs(got.imag).max() > 1e-3


def test_correlator_from_jax_mps_state_matches_jax():
    """``initial=`` an MPS: JAX's own state of a small circuit, carried to
    the port by ``interop.mps_state_from_numpy``; first order, X / X."""
    c = jq.QuantumCircuit(4)
    for q in range(4):
        c.add_gate(jq.GateInstance("Ry", [q], [0.3 + 0.4 * q], 0))
    for q in range(3):
        c.add_gate(jq.GateInstance("CNOT", [q, q + 1], [], 1 + q))
    kw = dict(site_i=0, site_j=3, pauli_i="X", pauli_j="X", chi=4,
              record_every=2, order=1)
    _, js = jm.MPSSimulator(chi=4).run(c, shots=0)
    _, want = jc.mps_two_point_correlator(4, _terms(4), 0.4, 4, initial=js,
                                          **kw)
    carried = mps_state_from_numpy([np.asarray(t) for t in js.tensors], 4,
                                   4, js.truncation_weight, device=CPU)
    _, got = tc.mps_two_point_correlator(4, _terms(4), 0.4, 4,
                                         initial=carried, device=CPU, **kw)
    np.testing.assert_allclose(got, want, atol=TOL)


# --- the JAX tests' laws on the port alone ----------------------------------

def _law_damping_analytic():
    sim = tl.MPSLindbladSimulator(2, jump_operators=[(1.0, "sigma_minus",
                                                      0)], chi=8,
                                  device=CPU)
    res = sim.evolve(2.0, 80, n_trajectories=400, initial=[1, 0],
                     observables=[("Z", [0])], record_every=20, seed=1)
    analytic = 1.0 - 2.0 * np.exp(-res.times)
    err = np.maximum(res.stderr[0], 1e-6)
    assert np.all(np.abs(res.expectations[0] - analytic)
                  <= 3.0 * err + 0.03)
    assert res.expectations.shape == (1, 5)
    assert res.truncation_weight == 0.0


def _law_dephasing():
    sim = tl.MPSLindbladSimulator(3, jump_operators=[(0.7, "z", q)
                                                     for q in range(3)],
                                  chi=4, device=CPU)
    res = sim.evolve(1.0, 20, n_trajectories=16, initial=[0, 1, 0],
                     observables=[("Z", [0]), ("Z", [1])], seed=2,
                     record_every=5)
    assert np.allclose(res.expectations[0], 1.0, atol=1e-5)
    assert np.allclose(res.expectations[1], -1.0, atol=1e-5)


def _law_dense_lindblad():
    H = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2]),
         (0.7, "X", [0]), (0.7, "X", [1]), (0.7, "X", [2])]
    J = [(0.3, "sigma_minus", 0), (0.2, "z", 2)]
    obs = [("Z", [0]), ("X", [1]), ("ZZ", [0, 1])]
    dense = LindbladSimulator(3, H, J, device=CPU).evolve(
        1.0, 100, observables=obs, record_every=25)
    mps = tl.MPSLindbladSimulator(3, H, J, chi=8, device=CPU).evolve(
        1.0, 100, n_trajectories=300, initial=[0, 0, 0],
        observables=obs, record_every=25, seed=2)
    assert np.allclose(mps.times, dense.times)
    for k in range(3):
        assert np.all(np.abs(dense.expectations[k] - mps.expectations[k])
                      <= 4.0 * np.maximum(mps.stderr[k], 1e-6) + 0.025)


def _law_no_jumps_deterministic():
    H = [(0.9, "ZZ", [0, 1]), (0.5, "X", [0]), (0.5, "X", [1])]
    res = tl.MPSLindbladSimulator(2, H, chi=4, device=CPU).evolve(
        0.8, 16, n_trajectories=5, initial=[0, 0],
        observables=[("X", [0]), ("ZZ", [0, 1])], record_every=4, seed=0)
    assert np.allclose(res.stderr, 0.0, atol=1e-6)
    dense = LindbladSimulator(2, H, device=CPU).evolve(
        0.8, 16, observables=[("X", [0])], record_every=16)
    assert abs(res.expectations[0, -1] - dense.expectations[0, -1]) < 5e-3


def _law_wide_chain():
    H = _terms(20, 0.5)
    J = [(0.1, "sigma_minus", q) for q in range(20)]
    res = tl.MPSLindbladSimulator(20, H, J, chi=8, device=CPU).evolve(
        0.3, 6, n_trajectories=3, observables=[("Z", [10])], seed=3,
        record_every=6)
    assert res.expectations.shape == (1, 2)
    assert np.all(np.abs(res.expectations) <= 1.0 + 1e-6)
    assert np.isfinite(res.expectations).all()


def _law_kraus_pair_and_validation():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    ks = tl._kraus_pair(0.4, L, 0.05)
    np.testing.assert_allclose(ks, jl._kraus_pair(0.4, L, 0.05),
                               atol=1e-12)
    assert np.allclose(sum(np.conj(k.T) @ k for k in ks), np.eye(2),
                       atol=1e-12)
    with pytest.raises(ValueError, match="shrink dt"):
        tl._kraus_pair(10.0, 3.0 * L, 1.0)
    sim = tl.MPSLindbladSimulator(2, jump_operators=[(0.1, "z", 0)],
                                  device=CPU)
    with pytest.raises(ValueError, match="record_every"):
        sim.evolve(1.0, 10, record_every=3)
    with pytest.raises(ValueError, match="n bits"):
        sim.evolve(1.0, 10, initial=[0, 1, 0])
    with pytest.raises(ValueError, match="order"):
        tl.MPSLindbladSimulator(2, order=3)
    with pytest.raises(TypeError, match="ShardMesh"):
        sim.evolve(1.0, 10, mesh=object())


def _dense(n, terms):
    def embed(pstr, qubits):
        full = ["I"] * n
        for ch, q in zip(pstr, qubits):
            full[q] = ch
        return _pauli_term_matrix("".join(full))

    return sum(c * embed(p, q) for c, p, q in terms), embed


def _exact_correlator(n, terms, psi0, Pi, Pj, times):
    H, _ = _dense(n, terms)
    w, v = np.linalg.eigh(H)
    out = []
    for t in times:
        U = (v * np.exp(-1j * w * t)) @ v.conj().T
        out.append((U @ psi0).conj() @ Pi @ (U @ (Pj @ psi0)))
    return np.array(out)


def _law_correlator_dense():
    n = 4
    terms = _terms(n)
    _, embed = _dense(n, terms)
    psi0 = np.zeros(2 ** n, complex)
    psi0[0] = 1.0
    times, C = tc.mps_two_point_correlator(
        n, terms, 1.0, 200, site_i=1, site_j=2, pauli_i="Z", pauli_j="Y",
        chi=8, record_every=50, device=CPU)
    assert np.any(np.abs(C.imag) > 1e-2)
    exact = _exact_correlator(n, terms, psi0, embed("Z", [1]),
                              embed("Y", [2]), times)
    assert np.abs(C - exact).max() < 5e-4


def _law_correlator_t0_and_validation():
    terms = [(0.5, "X", [0])]
    _, C = tc.mps_two_point_correlator(3, terms, 0.5, 10, 0, 2, chi=4,
                                       record_every=10, device=CPU)
    assert abs(C[0] - 1.0) < 1e-6
    _, Cx = tc.mps_two_point_correlator(3, terms, 0.5, 10, 0, 2,
                                        pauli_i="X", chi=4,
                                        record_every=10, device=CPU)
    assert abs(Cx[0]) < 1e-6
    for kw, msg in (({"record_every": 3}, "record_every"),
                    ({"site_j": 5}, "out of range"),
                    ({"pauli_i": "W"}, "must be X, Y, or Z")):
        args = dict(site_i=0, site_j=1)
        args.update(kw)
        with pytest.raises(ValueError, match=msg):
            tc.mps_two_point_correlator(3, [], 1.0, 10, device=CPU, **args)


def _law_correlator_wide():
    n = 32
    times, C = tc.mps_two_point_correlator(
        n, _terms(n, 0.5), 0.4, 8, n // 2, n // 2 + 1, chi=8,
        record_every=4, device=CPU)
    assert times.shape == (3,) and C.shape == (3,)
    assert np.all(np.abs(C) <= 1.0 + 1e-5) and np.isfinite(C).all()


def _law_correlator_from_dmrg():
    n = 4
    terms = _terms(n)
    gs = tq.dmrg_ground_state(terms, n, chi=8, sweeps=6, device=CPU)
    H, embed = _dense(n, terms)
    psi0 = np.linalg.eigh(H)[1][:, 0]
    times, C = tc.mps_two_point_correlator(n, terms, 1.0, 100, 1, 2, chi=8,
                                           initial=gs.state,
                                           record_every=25, device=CPU)
    exact = _exact_correlator(n, terms, psi0, embed("Z", [1]),
                              embed("Z", [2]), times)
    assert np.abs(C - exact).max() < 1e-3
    with pytest.raises(ValueError, match="wrong qubit count"):
        tc.mps_two_point_correlator(5, terms, 1.0, 10, 0, 1,
                                    initial=gs.state, device=CPU)


LAWS = {"damping-analytic": _law_damping_analytic,
        "dephasing": _law_dephasing, "dense-lindblad": _law_dense_lindblad,
        "no-jumps": _law_no_jumps_deterministic,
        "wide-chain": _law_wide_chain,
        "kraus-pair-validation": _law_kraus_pair_and_validation,
        "correlator-dense": _law_correlator_dense,
        "correlator-t0-validation": _law_correlator_t0_and_validation,
        "correlator-wide": _law_correlator_wide,
        "correlator-dmrg": _law_correlator_from_dmrg}


@pytest.mark.parametrize("name", list(LAWS))
def test_laws_on_the_port(name):
    LAWS[name]()
