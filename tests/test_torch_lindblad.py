"""The port's Lindblad solver (``lindblad.py``) against the JAX package's
(``quantum_simulator_tpu/lindblad.py``) on the cases of
``tests/test_lindblad.py``.

Both sides integrate the same system from the same NumPy initial state on
the CPU in complex64: recorded expectations and the final rho agree within
1e-4 (the sums run in another order; RK4's own error is far below). The
final rho is also held against ``expm(dense_liouvillian() t)`` within
1e-4, and ``dense_liouvillian`` against the JAX one within 1e-12.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import lindblad as jlind
from quantum_simulator_tpu.models import tfim_chain as j_tfim_chain
from quantum_simulator_tpu_torch import lindblad as tlind
from quantum_simulator_tpu_torch.interop import density_result_from_numpy
from quantum_simulator_tpu_torch.models import tfim_chain

TOL = 1e-4

PLUS = np.array([1.0, 1.0], dtype=np.complex128) / np.sqrt(2)
EXCITED = np.array([0.0, 1.0], dtype=np.complex128)


def random_psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi / np.linalg.norm(psi)


# name -> (n, terms, jumps, initial, t, steps, observables, record_every)
CASES = {
    "amp-damp-population": (1, [], [(0.7, "sigma_minus", 0)], EXCITED,
                            2.0, 100, [("Z", [0])], 10),
    "dephasing-coherence": (1, [], [(0.4, "z", 0)], PLUS, 3.0, 120,
                            [("X", [0]), ("Z", [0])], 30),
    "rabi": (1, [(0.65, "X", [0])], [], None, 4.0, 160, [("Z", [0])], 40),
    "expm-1": (1, [(0.9, "X", [0]), (0.5, "Z", [0])],
               [(0.3, "sigma_minus", 0)], random_psi(1, 1), 0.8, 80, [], 1),
    "expm-2": (2, [(1.0, "XX", [0, 1]), (0.7, "Z", [0]), (0.4, "Z", [1])],
               [(0.25, "sigma_minus", 0), (0.15, "z", 1)], random_psi(2, 2),
               0.8, 80, [("ZZ", [0, 1])], 20),
    "expm-3": (3, [(0.8, "ZZ", [0, 1]), (0.6, "XY", [1, 2]),
                   (0.5, "X", [0])],
               [(0.2, "sigma_minus", 2), (0.1, "sigma_plus", 0)],
               random_psi(3, 3), 0.8, 80, [("XY", [1, 2]), ("Y", [0])], 40),
    "cptp": (2, [(1.0, "XX", [0, 1]), (0.5, "Z", [0])],
             [(0.4, "sigma_minus", 0), (0.2, "z", 1)],
             np.eye(4, dtype=np.complex128)[3], 2.0, 100, [], 1),
    "matrix-jump": (2, [(0.3, "IZ", [0, 1])],
                    [(0.3, np.array([[0, 1], [0, 0]]), 1),
                     (0.0, "x", 0), (0.2, "Y", 0)],
                    random_psi(2, 5), 1.0, 50, [("Z", [1])], 25),
    "ising-4": (4, "tfim", [(0.1, "z", q) for q in range(4)]
                + [(0.05, "sigma_minus", 0)], random_psi(4, 7), 0.6, 30,
                [("Z", [0]), ("XX", [0, 1])], 10),
}


def build(name):
    n, terms, jumps, initial, t, steps, obs, every = CASES[name]
    jterms = j_tfim_chain(n) if terms == "tfim" else terms
    tterms = tfim_chain(n) if terms == "tfim" else terms
    jsim = jq.LindbladSimulator(n, jterms, jumps)
    tsim = tq.LindbladSimulator(n, tterms, jumps, device="cpu")
    return jsim, tsim, (t, steps), dict(initial=initial, observables=obs,
                                        record_every=every)


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name in CASES:
        jsim, _, args, kw = build(name)
        res = jsim.evolve(*args, **kw)
        out[name] = (res.times, res.expectations, res.final.rho,
                     res.observable_labels)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_evolve_matches_jax(name, jax_results):
    _, tsim, args, kw = build(name)
    res = tsim.evolve(*args, **kw)
    times, expectations, rho, labels = jax_results[name]
    np.testing.assert_allclose(res.times, times, atol=1e-12)
    assert res.expectations.shape == expectations.shape
    assert res.expectations.dtype == np.float32
    np.testing.assert_allclose(res.expectations, expectations, atol=TOL)
    assert isinstance(res.final, tq.DensityMatrixResult)
    assert res.final.device_rho.dtype == torch.complex64
    np.testing.assert_allclose(res.final.rho, rho, atol=TOL)
    assert res.observable_labels == labels


@pytest.mark.parametrize("name", ["expm-1", "expm-2", "expm-3", "cptp",
                                  "matrix-jump", "ising-4"])
def test_final_rho_matches_expm_of_the_liouvillian(name):
    jsim, tsim, (t, steps), kw = build(name)
    L = tsim.dense_liouvillian()
    np.testing.assert_allclose(L, jsim.dense_liouvillian(), atol=1e-12)
    dim = 1 << tsim.num_qubits
    psi = kw["initial"]
    rho0 = np.outer(psi, np.conj(psi))
    exact = (scipy.linalg.expm(L * t) @ rho0.reshape(-1)).reshape(dim, dim)
    got = tsim.evolve(t, steps, initial=psi).final
    np.testing.assert_allclose(got.rho, exact, atol=TOL)
    # CPTP structure: trace 1, Hermitian, positive
    assert got.trace() == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(got.rho, np.conj(got.rho.T), atol=1e-6)
    assert np.linalg.eigvalsh(got.rho).min() > -1e-6
    assert got.purity() <= 1.0 + 1e-6


def test_analytic_decays():
    """The closed forms of ``tests/test_lindblad.py``."""
    _, tsim, args, kw = build("amp-damp-population")
    res = tsim.evolve(*args, **kw)
    np.testing.assert_allclose((1.0 - res.expectations[0]) / 2.0,
                               np.exp(-0.7 * res.times), atol=2e-5)
    _, tsim, args, kw = build("dephasing-coherence")
    res = tsim.evolve(*args, **kw)
    np.testing.assert_allclose(res.expectations[0],
                               np.exp(-0.8 * res.times), atol=2e-5)
    np.testing.assert_allclose(res.expectations[1], 0.0, atol=1e-5)
    _, tsim, args, kw = build("rabi")
    res = tsim.evolve(*args, **kw)
    np.testing.assert_allclose((1.0 - res.expectations[0]) / 2.0,
                               np.sin(1.3 * res.times / 2) ** 2, atol=2e-5)


def test_liouvillian_is_trace_preserving():
    sim = tq.LindbladSimulator(
        2, hamiltonian_terms=[(1.0, "XX", [0, 1])],
        jump_operators=[(0.5, "sigma_minus", 0), (0.3, "z", 1)],
        device="cpu")
    np.testing.assert_allclose(np.eye(4).reshape(-1)
                               @ sim.dense_liouvillian(), 0.0, atol=1e-12)


def test_discrete_channel_limit():
    """A Trotterized circuit with per-gate amplitude damping converges to
    the Lindblad solution (the port's Trotter circuits, dense rho and
    Lindblad solver together), and halving dt shrinks the error."""
    from quantum_simulator_tpu_torch.models import trotter_circuit

    omega, Gamma, t = 1.1, 0.5, 1.2
    sim = tq.LindbladSimulator(
        1, hamiltonian_terms=[(omega / 2, "X", [0])],
        jump_operators=[(Gamma, "sigma_minus", 0)], device="cpu")
    exact = sim.evolve(t, 120).final.rho
    errs = []
    for steps in (20, 40):
        circ = trotter_circuit(1, [(omega / 2, "X", [0])], t, steps)
        nm = tq.NoiseModel()
        nm.add_global_noise(tq.AmplitudeDampingNoise(
            1.0 - np.exp(-Gamma * t / len(circ.gates))))
        rho = tq.DensityMatrixSimulator(nm, device="cpu").run(circ).rho
        errs.append(np.abs(rho - exact).max())
    assert errs[1] < 2e-2 and errs[1] < 0.7 * errs[0]


@pytest.mark.parametrize("form", ["none", "vector", "matrix", "statevector",
                                  "density-result", "jax-rho"])
def test_every_initial_form(form):
    """``_initial_rho`` against the JAX one for every accepted input."""
    n = 2
    psi = random_psi(n, 11)
    rho = np.outer(psi, psi.conj())
    jsim = jq.LindbladSimulator(n)
    tsim = tq.LindbladSimulator(n, device="cpu")
    if form == "none":
        jin = tin = None
    elif form == "vector":
        jin = tin = psi
    elif form == "matrix":
        jin = tin = rho
    elif form == "statevector":
        jin = jq.StateVector(n)
        jin.data = psi
        tin = tq.StateVector.from_numpy(psi, device="cpu")
    else:
        jin = jq.DensityMatrixResult(
            num_qubits=n, device_rho=jlind.jnp.asarray(rho.astype(
                np.complex64)))
        tin = density_result_from_numpy(
            jin.rho if form == "jax-rho" else rho, device="cpu")
    want = np.asarray(jsim._initial_rho(jin, np.complex64))
    got = tsim._initial_rho(tin, torch.complex64)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    if form in ("density-result", "jax-rho"):
        # the evolution must not write into the caller's result
        assert got.data_ptr() != tin.device_rho.data_ptr()


def test_input_validation():
    assert tlind.MAX_LINDBLAD_QUBITS == jlind.MAX_LINDBLAD_QUBITS == 13
    assert set(tlind.JUMP_OPERATORS) == set(jlind.JUMP_OPERATORS) == {
        "sigma_minus", "sigma_plus", "x", "y", "z"}
    for name, mat in tlind.JUMP_OPERATORS.items():
        np.testing.assert_array_equal(mat, jlind.JUMP_OPERATORS[name])
    bad = [dict(num_qubits=14), dict(num_qubits=0),
           dict(num_qubits=1, jump_operators=[(-0.1, "z", 0)]),
           dict(num_qubits=1, jump_operators=[(0.1, "nope", 0)]),
           dict(num_qubits=1, jump_operators=[(0.1, "z", 3)]),
           dict(num_qubits=1, jump_operators=[(0.1, np.eye(4), 0)]),
           dict(num_qubits=2, hamiltonian_terms=[(1.0, "XX", [0])]),
           dict(num_qubits=2, hamiltonian_terms=[(1.0, "XX", [0, 0])])]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jq.LindbladSimulator(**kw)
        with pytest.raises(ValueError) as terr:
            tq.LindbladSimulator(device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    sim = tq.LindbladSimulator(1, device="cpu")
    jsim = jq.LindbladSimulator(1)
    for kw in (dict(n_steps=10, record_every=3), dict(n_steps=0),
               dict(n_steps=10, observables=[("XX", [0])]),
               dict(n_steps=10, initial=np.zeros(3)),
               dict(n_steps=10, initial=tq.StateVector(2, device="cpu"))):
        jkw = dict(kw)
        if isinstance(jkw.get("initial"), tq.StateVector):
            jkw["initial"] = jq.StateVector(2)
        with pytest.raises(ValueError) as jerr:
            jsim.evolve(1.0, **jkw)
        with pytest.raises(ValueError) as terr:
            sim.evolve(1.0, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="capped at 6"):
        tq.LindbladSimulator(7, device="cpu").dense_liouvillian()


def test_record_cadence_and_labels():
    sim = tq.LindbladSimulator(2, hamiltonian_terms=[(1.0, "ZZ", [0, 1])],
                               device="cpu")
    res = sim.evolve(1.0, 20, observables=[("Z", [0]), ("xy", [0, 1])],
                     record_every=5)
    assert res.times.shape == (5,)
    assert res.expectations.shape == (2, 5)
    assert res.observable_labels == ["Z@[0]", "XY@[0, 1]"]
    none = sim.evolve(1.0, 4)
    assert none.expectations.shape == (0, 5)


def test_complex128_evolution():
    """``dtype=torch.complex128`` reaches the expm solution to 1e-9."""
    _, tsim, (t, steps), kw = build("expm-2")
    psi = kw["initial"]
    got = tsim.evolve(t, 200, initial=psi, dtype=torch.complex128).final
    assert got.device_rho.dtype == torch.complex128
    exact = (scipy.linalg.expm(tsim.dense_liouvillian() * t)
             @ np.outer(psi, psi.conj()).reshape(-1)).reshape(4, 4)
    np.testing.assert_allclose(got.rho, exact, atol=1e-9)
