"""The port's Clifford tableau engine (``clifford.py``) against the JAX
package's, on the CPU.

JAX's draws are computed with its own key schedule (in NumPy,
``tests/torch_jax_draws.py``) and fed to the port:
the measurement cascade's coin flips (``bernoulli(key, 0.5, (S, n))``),
the monitored and noisy walks' per-step uniforms (``uniform(k_t, (L,))``
over ``split(key, T)``; per shot ``split(k)`` into the walk's and the
cascade's keys). Tolerances: none. Tableaus, sampled bits, outcomes,
counts, stabilizer strings, entropies and Pauli expectations are equal
(integer and exact host arithmetic on the same inputs). The vectorised
deterministic measurement is held to the sequential rowsum form on random
stabilizer tableaus, and the law of sampled counts to the port's
statevector at TVD <= 0.05 (4096 shots, 2^6 outcomes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulator_tpu import clifford as jc
from quantum_simulator_tpu.circuit import GateInstance as JG
from quantum_simulator_tpu.circuit import QuantumCircuit as JQC
from quantum_simulator_tpu.noise import BitFlipNoise as JBF
from quantum_simulator_tpu.noise import DepolarizingNoise as JDep
from quantum_simulator_tpu.noise import NoiseModel as JNM
from quantum_simulator_tpu.noise import PhaseFlipNoise as JPF
from quantum_simulator_tpu.noise import ReadoutError as JRO
from quantum_simulator_tpu.noise import TwoQubitDepolarizingNoise as JDep2
from quantum_simulator_tpu_torch import clifford as tc
from quantum_simulator_tpu_torch import interop
from quantum_simulator_tpu_torch.circuit import GateInstance as TG
from quantum_simulator_tpu_torch.circuit import QuantumCircuit as TQC
from quantum_simulator_tpu_torch.noise import (AmplitudeDampingNoise,
                                               BitFlipNoise, DepolarizingNoise,
                                               NoiseModel, PhaseFlipNoise,
                                               ReadoutError,
                                               TwoQubitDepolarizingNoise)
from quantum_simulator_tpu_torch.simulator import Simulator
from tests import torch_jax_draws as nd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ONE_Q = ["H", "S", "S_DAG", "X", "Y", "Z", "I"]


def _gates(n, depth, seed, measure=False):
    rng = np.random.default_rng(seed)
    out, col = [], 0
    for layer in range(depth):
        for q in range(n):
            out.append((str(rng.choice(ONE_Q)), [q], col))
        col += 1
        perm = rng.permutation(n)
        for i in range(0, n - 1, 2):
            out.append((str(rng.choice(["CNOT", "CZ", "SWAP"])),
                        [int(perm[i]), int(perm[i + 1])], col))
        col += 1
        if measure:
            out.append(("Measure", [int(rng.integers(n))], col))
            col += 1
    return out


def _pair(n, gates, initial=None):
    j, t = JQC(n), TQC(n)
    for q, b in enumerate(initial or []):
        if b:
            j.set_qubit_initial_state(q, 1)
            t.set_qubit_initial_state(q, 1)
    for g, qs, col in gates:
        j.add_gate(JG(g, qs, [], col))
        t.add_gate(TG(g, qs, [], col))
    return j, t


def _same(jtab, ttab):
    return all(np.array_equal(np.asarray(a), b.cpu().numpy())
               for a, b in zip(jtab, ttab))


def _jax_uniforms(seed, T, L):
    """JAX's ``split(PRNGKey(seed), T)`` and each key's ``uniform(k,
    (L,))``, computed in NumPy (``tests/torch_jax_draws.py``)."""
    keys = nd.split(nd.key(seed), T)
    return jnp.asarray(keys), nd.uniform(keys, L)


@pytest.fixture(scope="module")
def circuits():
    """Random Clifford circuits (n = 6, 12), with |1> preps on one, and
    JAX's final tableau of each (compiled once for the module)."""
    out = []
    for n, depth, seed in ((6, 6, 1), (12, 6, 3)):
        j, t = _pair(n, _gates(n, depth, seed), [seed % 2] * n)
        out.append((j, t, jc.compile_clifford(j)()))
    return out


@pytest.mark.parametrize("k", range(2))
def test_tableau_after_circuit_matches_jax(circuits, k):
    j, t, jtab = circuits[k]
    assert _same(jtab, tc.compile_clifford(t, "cpu")())
    sched_j, sched_t = jc._lower(j), tc._lower(t)
    for a, b in zip(sched_j[:4], sched_t[:4]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("k", [1])
def test_sampled_bits_and_run_counts_match_jax(circuits, k):
    """JAX's ``run(seed)`` draws ``bernoulli(PRNGKey(rng.integers(0,
    2**63)), 0.5, (shots, n))`` and counts the cascade's rows."""
    j, t, jtab = circuits[k]
    n, shots = j.num_qubits, 96
    key = nd.key(np.random.default_rng(k).integers(0, 2 ** 63))
    rand = nd.bernoulli(key, shots * n).reshape(shots, n).astype(np.int32)
    want = np.asarray(jc._sample_fn(n)(jtab, jnp.asarray(rand)))
    got = tc.sample_bits(tc.compile_clifford(t, "cpu")(),
                         torch.from_numpy(rand))
    assert np.array_equal(want, got.numpy())
    uniq, cnts = np.unique(want.astype(np.uint8), axis=0, return_counts=True)
    jcounts = {"".join("1" if b else "0" for b in row): int(c)
               for row, c in zip(uniq, cnts)}
    counts, tab = tc.CliffordSimulator("cpu").run(
        t, shots=shots, rand_bits=torch.from_numpy(rand.astype(np.int8)))
    assert counts == jcounts
    assert _same(jtab, tab)


def _random_tableaus(n, B, seed):
    """B random stabilizer tableaus (rows of one batch)."""
    tabs = []
    for b in range(B):
        _, t = _pair(n, _gates(n, 6, 100 * seed + b))
        tabs.append(tc.compile_clifford(t, "cpu")())
    return tc.Tableau(*(torch.stack([tb[k] for tb in tabs])
                        for k in range(3)))


@pytest.mark.parametrize("n", [5, 8, 11])
def test_vectorised_measurement_equals_sequential(n, monkeypatch):
    tab = _random_tableaus(n, 12, n)
    for q in range(n):
        use = tab.x[:, :n, q]
        assert torch.equal(
            tc._deterministic_outcome(tab.x, tab.z, tab.r, use),
            tc._deterministic_outcome_sequential(tab.x, tab.z, tab.r, use))
    rand = torch.randint(0, 2, (12,), generator=torch.Generator()
                         .manual_seed(n), dtype=torch.int8)
    fast = [t.clone() for t in tab]
    slow = [t.clone() for t in tab]
    fast_out = [tc._measure_z(*fast, q, rand) for q in range(n)]
    monkeypatch.setattr(tc, "_deterministic_outcome",
                        tc._deterministic_outcome_sequential)
    slow_out = [tc._measure_z(*slow, q, rand) for q in range(n)]
    assert all(torch.equal(a, b) for a, b in zip(fast_out, slow_out))
    assert all(torch.equal(u, v) for u, v in zip(fast, slow))


def test_monitored_trajectories_match_jax():
    feedforward = [(0, "X", 1), (1, "Y", 2), (2, "Z", 0)]
    j, t = _pair(8, _gates(8, 6, 7, measure=True))
    evolve, sites = jc.compile_clifford_monitored(j, feedforward)
    L = len(jc._lower(j, collapse_measures=True)[0])
    keys, u = _jax_uniforms(3, 24, L)
    jtabs, jouts = jax.vmap(evolve)(keys)
    outs, tsites, tabs = tc.CliffordSimulator("cpu").monitored_trajectories(
        t, feedforward=feedforward, uniforms=torch.from_numpy(u))
    assert np.array_equal(np.asarray(jouts), outs) and tsites == sites
    assert len(tabs) == 24
    for i, tab in enumerate(tabs):
        assert _same(tuple(a[i] for a in jtabs), tab)


def _noise_pair(readout=False):
    jn, tn = JNM(), NoiseModel()
    jn.add_global_noise(JDep(0.1))
    tn.add_global_noise(DepolarizingNoise(0.1))
    jn.add_gate_noise("H", JBF(0.2))
    tn.add_gate_noise("H", BitFlipNoise(0.2))
    jn.add_gate_noise("S", JPF(0.3))
    tn.add_gate_noise("S", PhaseFlipNoise(0.3))
    jn.add_gate_noise("CNOT", JDep2(0.25))
    tn.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(0.25))
    if readout:
        jn.set_readout_error(JRO(0.05, 0.1))
        tn.set_readout_error(ReadoutError(0.05, 0.1))
    return jn, tn


def test_noisy_trajectories_match_jax():
    jn, tn = _noise_pair()
    j, t = _pair(7, _gates(7, 5, 21))
    L = len(jc._lower(j, noise_model=jn)[0])
    keys, u = _jax_uniforms(9, 40, L)
    jtabs = jax.vmap(jc.compile_clifford_noisy(j, jn))(keys)
    ttabs = tc.compile_clifford_noisy(t, tn, "cpu")(torch.from_numpy(u))
    assert _same(jtabs, ttabs)


def test_run_with_noise_matches_jax():
    jn, tn = _noise_pair(readout=True)
    j, t = _pair(6, _gates(6, 4, 22))
    n, shots, seed = 6, 200, 5
    want = jc.CliffordSimulator().run_with_noise(j, jn, shots, seed)
    L = len(jc._lower(j, noise_model=jn)[0])
    key = nd.key(np.random.default_rng(seed).integers(0, 2 ** 63))
    pairs = nd.split(nd.split(key, shots))          # (shots, 2, 2)
    u = nd.uniform(pairs[:, 0], L)
    rb = nd.bernoulli(pairs[:, 1], n).astype(np.int8)
    got = tc.CliffordSimulator("cpu").run_with_noise(
        t, tn, shots, seed, uniforms=torch.from_numpy(u),
        rand_bits=torch.from_numpy(rb))
    assert got == want


def test_host_reductions_match_jax(circuits):
    j, t, jtab = circuits[1]
    tab = interop.tableau_from_numpy(*map(np.asarray, jtab), device="cpu")
    assert _same(jtab, tab)
    J, T = jc.CliffordSimulator, tc.CliffordSimulator
    assert T.stabilizers(tab) == J.stabilizers(jtab)
    rng = np.random.default_rng(4)
    for size in (1, 3, 6, 9):
        sub = sorted(rng.choice(12, size, replace=False).tolist())
        assert T.entanglement_entropy(tab, sub) == \
            J.entanglement_entropy(jtab, sub)
    for _ in range(20):
        qs = rng.choice(12, int(rng.integers(1, 6)), replace=False)
        ps = [(int(q), str(rng.choice(["X", "Y", "Z"]))) for q in qs]
        assert T.expectation_pauli_string(tab, ps) == \
            J.expectation_pauli_string(jtab, ps)
    assert T.expectation_z_string(tab, [0, 5]) == \
        J.expectation_z_string(jtab, [0, 5])


def test_single_gates_match_jax():
    jtab = jc.identity_tableau(3)
    ttab = tc.identity_tableau(3, "cpu")
    assert _same(jtab, ttab)
    for name, qs in (("H", [0]), ("S", [1]), ("CNOT", [0, 2]), ("CZ", [2, 1]),
                     ("S_DAG", [2]), ("SWAP", [0, 1]), ("Y", [1]),
                     ("X", [2]), ("Z", [0]), ("I", [1])):
        jtab = jc._apply_gate(jtab, name, qs)
        ttab = tc._apply_gate(ttab, name, qs)
        assert _same(jtab, ttab), name


def test_law_against_the_statevector():
    _, t = _pair(6, _gates(6, 6, 31))
    counts, _ = tc.CliffordSimulator("cpu").run(t, shots=4096, seed=1)
    probs = Simulator(device="cpu").run(t, shots=0).final_state.probabilities
    emp = np.zeros(64)
    for k, v in counts.items():
        emp[int(k, 2)] = v / 4096
    assert np.abs(emp[probs < 1e-9]).sum() == 0
    assert 0.5 * np.abs(emp - probs).sum() <= 0.05


def test_rejections_and_validation():
    t = TQC(2)
    t.add_gate(TG("T", [0], [], 0))
    assert not tc.is_clifford_circuit(t)
    with pytest.raises(ValueError, match="non-Clifford"):
        tc.compile_clifford(t, "cpu")
    _, t = _pair(3, [("H", [0], 0), ("Measure", [0], 1)])
    with pytest.raises(ValueError, match="feedforward references"):
        tc.compile_clifford_monitored(t, [(3, "X", 1)], "cpu")
    with pytest.raises(ValueError, match="not a Pauli correction"):
        tc.compile_clifford_monitored(t, [(0, "H", 1)], "cpu")
    nm = NoiseModel()
    nm.add_global_noise(AmplitudeDampingNoise(0.1))
    with pytest.raises(ValueError, match="not a Pauli channel"):
        tc.compile_clifford_noisy(t, nm, "cpu")
    with pytest.raises(ValueError, match="2n, n"):
        interop.tableau_from_numpy(np.zeros((3, 3)), np.zeros((3, 3)),
                                   np.zeros(3), "cpu")
    with pytest.raises(ValueError, match="duplicate"):
        tc.CliffordSimulator.expectation_z_string(
            tc.identity_tableau(2, "cpu"), [0, 0])


def test_shot_batches_give_the_same_bits(monkeypatch):
    """Cut into batches by bytes, the cascade gives the same bits."""
    _, t = _pair(5, _gates(5, 4, 41))
    tab = tc.compile_clifford(t, "cpu")()
    rb = torch.randint(0, 2, (40, 5), generator=torch.Generator()
                       .manual_seed(0), dtype=torch.int8)
    whole = tc.sample_bits(tab, rb)
    monkeypatch.setattr(tc, "tableau_rows", lambda n: 7)
    assert torch.equal(tc.sample_bits(tab, rb), whole)
