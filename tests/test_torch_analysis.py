"""The port's ``StateAnalysis`` and ``models`` vs the JAX package's, on
the CPU.

Every ported ``StateAnalysis`` method runs on the same seeded random
states (n = 5 and 6, made with NumPy) in both packages. Tolerances: 1e-5
for fidelities, reduced density matrices, purities, concurrences and
expectation values (both contract complex64 states, in another order);
1e-4 for entropies and mutual information, whose log2 of small
eigenvalues of a float32-built matrix amplifies that rounding. The model
builders must give the same gates, targets, params and terms.
"""

import jax
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import models as jmodels
from quantum_simulator_tpu.analysis import StateAnalysis as JSA
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import models as tmodels
from quantum_simulator_tpu_torch.analysis import StateAnalysis as TSA

CPU = "cpu"
TOL = 1e-5
ENTROPY_TOL = 1e-4


def random_amps(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (a / np.linalg.norm(a)).astype(np.complex64)


def pair(amps):
    """(JAX StateVector, port StateVector) holding the same amplitudes."""
    n = amps.shape[0].bit_length() - 1
    jsv = jq.StateVector(n)
    jsv.data = amps
    return jsv, tq.StateVector.from_numpy(amps, device=CPU)


@pytest.fixture(scope="module", params=[5, 6], ids=lambda n: f"n{n}")
def states(request):
    n = request.param
    return n, pair(random_amps(n, 10 + n)), pair(random_amps(n, 20 + n))


def random_rho(dim, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    rho = a @ a.conj().T
    return rho / np.trace(rho).real


# ---------------------------------------------------------------------------
# Fidelities and purity
# ---------------------------------------------------------------------------

def test_fidelities_match_jax(states):
    _, (ja, ta), (jb, tb) = states
    want = JSA.state_fidelity(ja.data, jb.data)
    assert TSA.state_fidelity(ta.data, tb.data) == pytest.approx(want,
                                                                 abs=TOL)
    # a tensor on either side takes the device path
    assert TSA.state_fidelity(ta.device_data, tb.data) == pytest.approx(
        JSA.state_fidelity(ja.device_data, jb.data), abs=TOL)
    assert TSA.state_fidelity(ta.data, tb.device_data) == pytest.approx(
        want, abs=TOL)
    assert TSA.process_fidelity(ta, tb) == pytest.approx(
        JSA.process_fidelity(ja, jb), abs=TOL)
    assert TSA.state_fidelity(ta.device_data, ta.device_data) == \
        pytest.approx(1.0, abs=TOL)


@pytest.mark.parametrize("dim", [2, 4, 8])
def test_density_fidelity_and_purity_dm_match_jax(dim):
    rho, sigma = random_rho(dim, dim), random_rho(dim, dim + 1)
    assert TSA.density_fidelity(rho, sigma) == pytest.approx(
        JSA.density_fidelity(rho, sigma), abs=TOL)
    assert TSA.density_fidelity(rho, rho) == pytest.approx(1.0, abs=TOL)
    assert TSA.purity_dm(rho) == pytest.approx(JSA.purity_dm(rho), abs=TOL)
    assert TSA.von_neumann_entropy_dm(rho) == pytest.approx(
        JSA.von_neumann_entropy_dm(rho), abs=ENTROPY_TOL)
    assert TSA.concurrence_dm(random_rho(4, dim)) == pytest.approx(
        JSA.concurrence_dm(random_rho(4, dim)), abs=TOL)


def test_purity_and_global_entropy_match_jax(states):
    _, (ja, ta), _ = states
    assert TSA.purity(ta) == pytest.approx(JSA.purity(ja), abs=TOL)
    assert TSA.purity(ta.device_data) == pytest.approx(JSA.purity(ja),
                                                       abs=TOL)
    assert TSA.von_neumann_entropy(ta) == pytest.approx(
        JSA.von_neumann_entropy(ja), abs=ENTROPY_TOL)
    # normalized to 1e-12: exactly 0 (a pure state)
    exact = ja.data / np.linalg.norm(ja.data)
    assert TSA.von_neumann_entropy(exact) == \
        JSA.von_neumann_entropy(exact) == 0.0
    # not normalized: the eigenvalue definition on |psi><psi|
    half = ja.data * 0.8
    assert TSA.von_neumann_entropy(half) == pytest.approx(
        JSA.von_neumann_entropy(half), abs=ENTROPY_TOL)


# ---------------------------------------------------------------------------
# Partial traces, entropies, entanglement measures
# ---------------------------------------------------------------------------

KEEPS = [[0], [3], [1, 3], [4, 0], [0, 2, 4], [4, 3, 2, 1]]


@pytest.mark.parametrize("keep", KEEPS, ids=lambda k: "-".join(map(str, k)))
def test_partial_trace_and_entropy_match_jax(states, keep):
    _, (ja, ta), _ = states
    want = JSA.partial_trace(ja, keep)
    got = TSA.partial_trace(ta, keep)
    assert got.shape == want.shape == (1 << len(keep),) * 2
    np.testing.assert_allclose(got, want, atol=TOL)
    # a bare tensor and a NumPy vector give the same matrix
    np.testing.assert_allclose(TSA.partial_trace(ta.device_data, keep), want,
                               atol=TOL)
    np.testing.assert_allclose(TSA.partial_trace(ja.data, keep, CPU), want,
                               atol=TOL)
    assert TSA.entanglement_entropy(ta, keep) == pytest.approx(
        JSA.entanglement_entropy(ja, keep), abs=ENTROPY_TOL)


def test_partial_trace_rejects_what_jax_rejects():
    _, ta = pair(random_amps(9, 1))
    with pytest.raises(ValueError, match="keep <= 8"):
        TSA.partial_trace(ta, list(range(9)))
    with pytest.raises(ValueError, match="at least one"):
        TSA.partial_trace(ta, [])


def test_mutual_information_and_concurrence_match_jax(states):
    n, (ja, ta), _ = states
    for a, b in [(0, 1), (1, n - 1), (2, 4)]:
        assert TSA.mutual_information(ta, a, b) == pytest.approx(
            JSA.mutual_information(ja, a, b), abs=ENTROPY_TOL)
        assert TSA.concurrence(ta, a, b) == pytest.approx(
            JSA.concurrence(ja, a, b), abs=TOL)
    got = TSA.pairwise_mutual_information(ta)
    want = JSA.pairwise_mutual_information(ja)
    assert got.shape == (n, n)
    np.testing.assert_allclose(got, want, atol=ENTROPY_TOL)
    np.testing.assert_array_equal(got, got.T)


def test_bell_pair_measures():
    """Known values: a Bell pair on qubits (0, 2) of three has one bit of
    entanglement entropy, concurrence 1 and mutual information 2."""
    amps = np.zeros(8, np.complex64)
    amps[0b000] = amps[0b101] = 1 / np.sqrt(2)
    _, ta = pair(amps)
    assert TSA.entanglement_entropy(ta, [0]) == pytest.approx(1.0, abs=1e-6)
    assert TSA.concurrence(ta, 0, 2) == pytest.approx(1.0, abs=1e-6)
    assert TSA.mutual_information(ta, 0, 2) == pytest.approx(2.0, abs=1e-6)
    assert TSA.pairwise_mutual_information(ta)[0, 1] == pytest.approx(
        0.0, abs=1e-6)


# ---------------------------------------------------------------------------
# Expectation values
# ---------------------------------------------------------------------------

def test_expectation_values_match_jax(states):
    _, (ja, ta), _ = states
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    obs = obs + obs.conj().T
    for targets in ([3, 1], [0, 4]):
        got = TSA.expectation_value(ta, obs, targets)
        want = JSA.expectation_value(ja, obs, targets)
        assert abs(got - want) <= TOL
    nonherm = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    got = TSA.expectation_value(ta, nonherm, [2])
    assert abs(got - JSA.expectation_value(ja, nonherm, [2])) <= TOL
    for p in "XYZxyz":
        assert TSA.pauli_expectation(ta, p, 1) == pytest.approx(
            JSA.pauli_expectation(ja, p, 1), abs=TOL)
    with pytest.raises(ValueError, match="Unknown Pauli"):
        TSA.pauli_expectation(ta, "W", 0)


@pytest.mark.parametrize("qubits,paulis", [
    ([0], "X"), ([2, 0], "ZY"), ([1, 3, 4], "XYZ"), ([4, 0, 2, 3], "yxzz"),
    ([], "")])
def test_pauli_string_expectation_matches_jax(states, qubits, paulis):
    _, (ja, ta), _ = states
    assert TSA.pauli_string_expectation(ta, qubits, paulis) == \
        pytest.approx(JSA.pauli_string_expectation(ja, qubits, paulis),
                      abs=TOL)


@pytest.mark.parametrize("qubits,paulis,match", [
    ([0, 1], "X", "Paulis"), ([0], "Q", "X/Y/Z"),
    ([1, 1], "XZ", "duplicate")])
def test_pauli_string_rejects_what_jax_rejects(qubits, paulis, match):
    ja, ta = pair(random_amps(3, 2))
    with pytest.raises(ValueError, match=match):
        JSA.pauli_string_expectation(ja, qubits, paulis)
    with pytest.raises(ValueError, match=match):
        TSA.pauli_string_expectation(ta, qubits, paulis)


def test_hamiltonian_expectation_matches_jax(states):
    n, (ja, ta), _ = states
    terms = [(c, qs, p) for c, p, qs in tmodels.tfim_chain(n, j=-1.0,
                                                          h=-0.7)]
    terms += [(0.25, [0, 3], "XY")]
    assert TSA.hamiltonian_expectation(ta, terms) == pytest.approx(
        JSA.hamiltonian_expectation(ja, terms), abs=TOL)


_PAULI_Y = np.array([[0, -1j], [1j, 0]])
NUMPY_INPUT_CASES = {
    "partial_trace": lambda sa, x, **d: sa.partial_trace(x, [1, 3], **d),
    "entanglement_entropy": lambda sa, x, **d: sa.entanglement_entropy(
        x, [0, 2], **d),
    "purity": lambda sa, x, **d: sa.purity(x, **d),
    "mutual_information": lambda sa, x, **d: sa.mutual_information(
        x, 0, 3, **d),
    "concurrence": lambda sa, x, **d: sa.concurrence(x, 1, 4, **d),
    "expectation_value": lambda sa, x, **d: sa.expectation_value(
        x, np.kron(_PAULI_Y, _PAULI_Y), [2, 0], **d),
    "pauli_expectation": lambda sa, x, **d: sa.pauli_expectation(
        x, "Y", 2, **d),
    "pauli_string_expectation": lambda sa, x, **d:
        sa.pauli_string_expectation(x, [3, 1], "XZ", **d),
    "hamiltonian_expectation": lambda sa, x, **d: sa.hamiltonian_expectation(
        x, [(0.5, [0, 1], "ZZ"), (-0.3, [2], "X")], **d),
}


@pytest.mark.parametrize("name", sorted(NUMPY_INPUT_CASES))
def test_numpy_states_go_to_the_configured_device(name, monkeypatch):
    """A NumPy state is contracted on ``device``, by default
    ``CONFIG.device``, as JAX's ``jnp.asarray`` puts it on the default
    accelerator: ``device="cpu"`` and ``CONFIG.device = "cpu"`` give
    JAX's value, and the card's default raises where there is no card
    instead of running on the host."""
    from quantum_simulator_tpu_torch.config import CONFIG

    call = NUMPY_INPUT_CASES[name]
    amps = random_amps(5, 31)
    ja, _ = pair(amps)
    want = call(JSA, ja)
    np.testing.assert_allclose(call(TSA, amps, device=CPU), want, atol=TOL)
    monkeypatch.setattr(CONFIG, "device", CPU)
    np.testing.assert_allclose(call(TSA, amps), want, atol=TOL)
    if not torch.cuda.is_available():
        monkeypatch.setattr(CONFIG, "device", "cuda")
        with pytest.raises((AssertionError, RuntimeError)):
            call(TSA, amps)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda m: m.hardware_efficient_ansatz(5, 3),
    lambda m: m.hardware_efficient_ansatz(4, 2, rotation="Rx",
                                          initial_angle=0.4),
    lambda m: m.qaoa_maxcut_ansatz(5, 2),
    lambda m: m.qaoa_maxcut_ansatz(4, 3, edges=[(0, 2), (1, 3), (0, 3)],
                                   gamma=0.3, beta=-0.2),
    lambda m: m.brickwork_circuit(6, 7, seed=9),
], ids=["hea", "hea-rx", "qaoa", "qaoa-edges", "brickwork"])
def test_ansatz_builders_match_jax(build):
    got, want = build(tmodels), build(jmodels)
    assert got.to_dict() == want.to_dict()
    assert [(g.gate_name, g.target_qubits, g.params, g.column)
            for g in got.gates] == \
        [(g.gate_name, g.target_qubits, g.params, g.column)
         for g in want.gates]


@pytest.mark.parametrize("name,args", [
    ("zz_chain", (6,)), ("zz_chain", (4, 0.5)),
    ("heisenberg_chain", (5,)), ("heisenberg_chain", (4, 0.1, 0.2, 0.3)),
    ("tfim_chain", (6,)), ("tfim_chain", (3, 2.0, -0.5)),
    ("maxcut_edges_ring", (7,))])
def test_hamiltonian_builders_match_jax(name, args):
    assert getattr(tmodels, name)(*args) == getattr(jmodels, name)(*args)


def test_models_run_in_the_port():
    """A model circuit through the port's Simulator gives the JAX
    package's state, and its Hamiltonian the same energy."""
    jc = jmodels.hardware_efficient_ansatz(5, 2, initial_angle=0.7)
    tc = tmodels.hardware_efficient_ansatz(5, 2, initial_angle=0.7)
    want = jq.Simulator().run(jc, shots=0).final_state
    got = tq.Simulator(device=CPU).run(tc, shots=0).final_state
    np.testing.assert_allclose(got.data, want.data, atol=TOL)
    terms = [(c, qs, p) for c, p, qs in tmodels.heisenberg_chain(5)]
    assert TSA.hamiltonian_expectation(got, terms) == pytest.approx(
        JSA.hamiltonian_expectation(want, terms), abs=TOL)
    assert isinstance(got.device_data, torch.Tensor)
    assert isinstance(want.device_data, jax.Array)
