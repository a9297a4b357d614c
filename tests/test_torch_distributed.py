"""The port's sharded statevector engine (``quantum_simulator_tpu_torch.
parallel.distributed``) against the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port
on a CPU mesh of the same shard count in this one process (W = 1, L
shards stacked), where the grouped route runs the kernels' plain twins.
Tolerances and why:

* per-gate states: 1e-5 (complex64 einsums in another order); the
  grouped route (14 or more local qubits): 2e-5, the tolerance of
  ``tests/test_multihost.py``;
* schedules: equal item for item (host Python on the same program);
* the sampler: the same counts from the same NumPy uniforms, except that
  a shot whose scaled uniform lies within 1e-5 of a CDF boundary may
  land on either side (the shard sums and cumsums run in another order);
* <Z>, the one-qubit rho and Pauli strings: 1e-5;
* noisy trajectories: JAX's draws fed to the port (its key schedule in
  NumPy, ``torch_jax_draws.mesh_trajectory_gumbels``), states within
  1e-5 unless a draw's margin is below 1e-5; the ensemble rho in law
  against the port's exact density matrix (0.05);
* segmented runs: one run's state within 1e-6 (each segment restores
  the layout, so a gate may apply at another local position than in one
  run, and its einsum rounds differently: 4e-8 measured).
"""

import numpy as np
import pytest
import torch

from quantum_simulator_tpu import GateInstance as JG
from quantum_simulator_tpu import QuantumCircuit as JC
from quantum_simulator_tpu.algorithms import AlgorithmTemplate
from quantum_simulator_tpu.models import brickwork_circuit as jbrickwork
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu.parallel import DistributedSimulator as JD
from quantum_simulator_tpu.parallel import distributed as jdist
from quantum_simulator_tpu_torch import (BitFlipNoise, DensityMatrixSimulator,
                                         DepolarizingNoise, NoiseModel,
                                         QuantumCircuit, interop)
from quantum_simulator_tpu_torch.analysis import StateAnalysis
from quantum_simulator_tpu_torch.noise import (AmplitudeDampingNoise,
                                               ReadoutError)
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                  make_mesh)
from quantum_simulator_tpu_torch.parallel import distributed as tdist
from tests import torch_jax_draws as nd

CPU = "cpu"


@pytest.fixture(scope="module")
def jax_sims():
    return {d: JD(n_devices=d) for d in (2, 4, 8)}


def port(c: JC) -> QuantumCircuit:
    return QuantumCircuit.from_dict(c.to_dict())


def tsim(d: int = 8) -> DistributedSimulator:
    return DistributedSimulator(n_devices=d, device=CPU)


def _circuit(n, gates, initial=None):
    c = JC(n, initial_states=initial) if initial else JC(n)
    for name, ts, ps, col in gates:
        c.add_gate(JG(name, list(ts), list(ps), column=col))
    return c


def _random_deep():
    rng = np.random.default_rng(42)
    c = JC(6)
    names1q = ["H", "X", "Y", "Z", "S", "T"]
    for col in range(12):
        q = int(rng.integers(6))
        c.add_gate(JG(names1q[col % 6], [q], [], column=col))
        q2, q3 = rng.choice(6, size=2, replace=False)
        c.add_gate(JG("CNOT", [int(q2), int(q3)], [], column=col))
    return c


def _qft5():
    c = AlgorithmTemplate.quantum_fourier_transform(5)
    c.initial_states = [1, 0, 1, 1, 0]
    return c


def _grover10():
    n = 10
    c = JC(n)
    for q in range(n):
        c.add_gate(JG("H", [q], [], column=0))
    c.add_gate(JG(f"MCZ{n}", list(range(n)), [], column=1))
    for q in range(n):
        c.add_gate(JG("H", [q], [], column=2))
        c.add_gate(JG("X", [q], [], column=3))
    c.add_gate(JG(f"MCZ{n}", list(range(n)), [], column=4))
    for q in range(n):
        c.add_gate(JG("X", [q], [], column=5))
        c.add_gate(JG("H", [q], [], column=6))
    return c


H6 = [("H", [q], [], 0) for q in range(6)]

# The geometries of tests/test_distributed.py (6 qubits over 8 shards:
# qubits 0-2 on shard bits, 3-5 local, unless named).
CASES = {
    "local_only": lambda: _circuit(6, [("H", [3], [], 0), ("X", [4], [], 0),
                                       ("CNOT", [3, 5], [], 1)]),
    "global_single": lambda: _circuit(6, [("H", [0], [], 0),
                                          ("Ry", [1], [0.7], 0),
                                          ("Z", [2], [], 1)]),
    "global_local_2q": lambda: _circuit(6, [("H", [0], [], 0),
                                            ("CNOT", [0, 5], [], 1)]),
    "both_global": lambda: _circuit(6, [("H", [0], [], 0),
                                        ("CNOT", [0, 1], [], 1),
                                        ("CZ", [1, 2], [], 2),
                                        ("SWAP", [0, 2], [], 3)]),
    "ghz_chain": lambda: _circuit(6, [("H", [0], [], 0)] + [
        ("CNOT", [0, i], [], i) for i in range(1, 6)]),
    "toffoli": lambda: _circuit(6, [("Toffoli", [0, 1, 4], [], 0)],
                                [1, 1, 0, 0, 0, 0]),
    "random_deep": _random_deep,
    "parameterized": lambda: _circuit(5, [
        ("Ry", [q], [0.3 * (q + 1)], 0) for q in range(5)] + [
        ("CNOT", [q, q + 1], [], q + 1) for q in range(4)]),
    "qft": _qft5,
    "nontrivial_initial": lambda: _circuit(5, [("H", [2], [], 0)],
                                           [1, 1, 0, 1, 0]),
    "cz_cphase_global": lambda: _circuit(6, H6 + [
        ("CZ", [0, 4], [], 1), ("CZ", [1, 2], [], 2),
        ("CPhase", [0, 5], [0.9], 3), ("Ry", [4], [0.4], 4)]),
    "mcz_wider_than_shard": lambda: _circuit(6, H6 + [
        ("MCZ6", list(range(6)), [], 1)] + [
        ("Ry", [q], [0.2 + 0.1 * q], 2) for q in range(6)]),
    "grover": _grover10,
    "diag_1q_global": lambda: _circuit(6, H6 + [
        ("Rz", [0], [0.63], 1), ("Phase", [1], [1.1], 1),
        ("Z", [2], [], 1), ("T", [0], [], 2), ("S", [1], [], 2),
        ("Ry", [4], [0.3], 3)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_jax(jax_sims, name):
    c = CASES[name]()
    want = jax_sims[8].run(c).data
    got = tsim().run(port(c))
    np.testing.assert_allclose(got.data, want, atol=1e-5)
    assert got.norm() == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_sizes_match_jax(jax_sims, d):
    c = _circuit(5, [("H", [0], [], 0), ("CNOT", [0, 4], [], 1)])
    np.testing.assert_allclose(tsim(d).run(port(c)).data,
                               jax_sims[d].run(c).data, atol=1e-5)


def test_grouped_route_matches_jax(jax_sims):
    """n = 16 over 4 shards: 14 local qubits, the grouped route (mini
    plans through the executor) on both sides."""
    c = jbrickwork(16, 4, seed=11)
    p = tprog.compile_circuit(port(c))
    assert tdist._ShardBody(p, make_mesh(4, device=CPU)).grouped
    np.testing.assert_allclose(tsim(4).run(port(c)).data,
                               jax_sims[4].run(c).data, atol=2e-5)


def test_grouped_route_wide_mcz_and_shard_diagonals(jax_sims):
    """n = 18 over 8 shards (15 local qubits): a matrix-less MCZ12, a
    CNOT across shard and local bits, and shard-bit diagonals (cphase,
    gdiag1 items) on the planar stack."""
    n = 18
    c = _circuit(n, [("H", [q], [], 0) for q in range(n)] + [
        ("MCZ12", list(range(12)), [], 1), ("CNOT", [0, 17], [], 2),
        ("Rz", [1], [0.4], 3), ("CPhase", [0, 9], [0.7], 3),
        ("Ry", [2], [0.3], 4)])
    np.testing.assert_allclose(tsim().run(port(c)).data,
                               jax_sims[8].run(c).data, atol=2e-5)


SCHEDULE_CASES = ["both_global", "toffoli", "qft", "cz_cphase_global",
                  "mcz_wider_than_shard", "diag_1q_global", "random_deep"]


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_schedule_equals_jax(name):
    c = CASES[name]()
    jp, tp = jprog.compile_circuit(c), tprog.compile_circuit(port(c))
    for g in (1, 2, 3):
        want = jdist._build_schedule(
            jp, g, {oi for oi, op in enumerate(jp.ops)
                    if jdist._is_noswap_diag(op)
                    or jdist._is_noswap_1q_diag(op)})
        assert tdist._build_schedule(tp, g, tdist.ideal_noswap(tp)) == want


def test_noisy_schedule_keeps_swaps_for_noisy_diag():
    c = _circuit(6, H6 + [("CZ", [0, 5], [], 1)])
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.1))
    tp = tprog.compile_circuit(port(c))
    sched = tdist._build_schedule(tp, 3, tdist.noisy_noswap(tp, nm))
    assert any(it[0] == "swap" for it in sched)
    assert not any(it[0] == "cphase" for it in sched)


def test_diag_only_circuit_schedules_zero_swaps():
    c = _circuit(6, [("H", [q], [], 0) for q in (3, 4, 5)] + [
        ("Rz", [0], [0.5], 1), ("CPhase", [1, 4], [0.7], 2),
        ("CZ", [2, 0], [], 3), ("MCZ3", [0, 1, 5], [], 4)],
        [1, 1, 0, 0, 0, 0])
    tp = tprog.compile_circuit(port(c))
    sched = tdist._build_schedule(tp, 3, tdist.ideal_noswap(tp))
    assert not any(it[0] == "swap" for it in sched)
    assert {"cphase", "gdiag1"} <= {it[0] for it in sched}


def _boundary_ties(probs: np.ndarray, uniforms: np.ndarray,
                   tol: float = 1e-5) -> int:
    cdf = np.cumsum(probs)
    u = uniforms.astype(np.float32).astype(np.float64) * cdf[-1]
    return int((np.abs(u[:, None] - cdf[None, :]) < tol).any(1).sum())


@pytest.mark.parametrize("d", [4, 8])
def test_sampler_counts_equal_jax(jax_sims, d):
    """The same state, the same NumPy uniforms: JAX's shard-local sampler
    and the port's give the same counts (a shot within 1e-5 of a CDF
    boundary may fall on either side)."""
    c = jbrickwork(8, 6, seed=5)
    js = jax_sims[d].run(c)
    ts = interop.distributed_state_from_numpy(js.data,
                                              make_mesh(d, device=CPU))
    shots = 3000
    want = jax_sims[d].sample(js, shots, np.random.default_rng(3))
    got = tsim(d).sample(ts, shots, np.random.default_rng(3))
    ties = _boundary_ties(np.abs(js.data) ** 2,
                          np.random.default_rng(3).random(shots))
    diff = sum(abs(got.get(k, 0) - want.get(k, 0))
               for k in set(got) | set(want))
    assert sum(got.values()) == shots
    assert diff <= 2 * ties, (diff, ties)


def test_sampler_support_and_seed():
    c = port(_circuit(4, [("H", [0], [], 0), ("CNOT", [0, 3], [], 1)]))
    sim = tsim(4)
    st = sim.run(c)
    counts = sim.sample(st, 2000, np.random.default_rng(42))
    assert sum(counts.values()) == 2000
    assert set(counts) == {"0000", "1001"}
    assert counts == sim.sample(st, 2000, np.random.default_rng(42))


def _rz_brickwork(n=10, seed=13):
    c = jbrickwork(n, 4, seed=seed)
    col = max(g.column for g in c.gates) + 1
    for q in range(0, n, 3):
        c.add_gate(JG("T", [q], [], column=col))
    for q in range(n):
        c.add_gate(JG("Rz", [q], [0.1 + 0.2 * q], column=col + 1))
    return c


@pytest.fixture(scope="module")
def observables_case(jax_sims):
    c = _rz_brickwork()
    js = jax_sims[8].run(c)
    sim = tsim()
    return c, js, sim, sim.run(port(c))


def test_expectation_z_matches_jax(jax_sims, observables_case):
    _, js, sim, ts = observables_case
    for q in (0, 2, 5, 9):
        assert sim.expectation_z(ts, q) == pytest.approx(
            jax_sims[8].expectation_z(js, q), abs=1e-5)


def test_qubit_density_matrices_match_jax(jax_sims, observables_case):
    _, js, sim, ts = observables_case
    got = sim.qubit_density_matrices(ts)
    np.testing.assert_allclose(got, jax_sims[8].qubit_density_matrices(js),
                               atol=1e-5)
    dense = StateAnalysis.partial_trace
    psi = ts.data
    for q in range(10):
        np.testing.assert_allclose(got[q], dense(psi, [q], device=CPU),
                                   atol=1e-5)


STRINGS = [([0], "X"), ([1], "Y"), ([2], "Z"), ([7], "X"), ([8], "Y"),
           ([0, 9], "XX"), ([0, 9], "YY"), ([1, 5], "YX"),
           ([0, 1, 2], "XYZ"), ([2, 6, 9], "ZXY"), ([0, 4, 9], "ZZZ"),
           ([0, 3, 5, 8], "XYXY")]


def test_pauli_strings_match_jax(jax_sims, observables_case):
    _, js, sim, ts = observables_case
    psi = js.data
    for qs, ps in STRINGS[:4]:
        assert sim.expectation_pauli_string(ts, qs, ps) == pytest.approx(
            jax_sims[8].expectation_pauli_string(js, qs, ps), abs=1e-5)
    for qs, ps in STRINGS:
        want = StateAnalysis.pauli_string_expectation(psi, qs, ps,
                                                      device=CPU)
        assert sim.expectation_pauli_string(ts, qs, ps) == pytest.approx(
            want, abs=1e-5), (qs, ps)
    assert sim.expectation_pauli_string(ts, [], "") == 1.0
    with pytest.raises(ValueError, match="duplicate"):
        sim.expectation_pauli_string(ts, [1, 1], "XX")


def test_fidelity_and_basis_rotation(jax_sims):
    c = jbrickwork(6, 6, seed=11)
    sim = tsim()
    a = sim.run(port(c))
    assert sim.fidelity(a, a) == pytest.approx(1.0, abs=1e-5)
    for basis in ("X", "Y"):
        rot = jdist.with_basis_rotation(c, basis)
        np.testing.assert_allclose(
            sim.run(tdist.with_basis_rotation(port(c), basis)).data,
            jax_sims[8].run(rot).data, atol=1e-5)
    assert tdist.with_basis_rotation(port(c), "Z") is not None
    with pytest.raises(ValueError, match="basis"):
        tdist.with_basis_rotation(port(c), "W")
    ghz = port(_circuit(6, [("H", [0], [], 0)] + [
        ("CNOT", [q, q + 1], [], q + 1) for q in range(5)]))
    counts = sim.sample_with_basis(ghz, 2000, "X", np.random.default_rng(5))
    assert sum(counts.values()) == 2000
    assert all(b.count("1") % 2 == 0 for b in counts)
    noisy = sim.sample_with_basis(QuantumCircuit(6), 4000, "Z",
                                  np.random.default_rng(1),
                                  ReadoutError(p01=0.2, p10=0.0))
    assert 0.15 < noisy.get("000000", 0) / 4000 < 0.4


NOISY_SEEDS = 6


@pytest.fixture(scope="module")
def noisy_case():
    from quantum_simulator_tpu import (AmplitudeDampingNoise as JAD,
                                       DepolarizingNoise as JDep,
                                       NoiseModel as JNM)

    c = _circuit(6, [("Ry", [q], [0.3 + 0.2 * q], 0) for q in range(6)]
                 + [("CNOT", [q, q + 1], [], 1 + q) for q in range(5)]
                 + [("CZ", [0, 5], [], 7), ("Rz", [1], [0.4], 8)])
    jnm = JNM()
    jnm.add_global_noise(JDep(0.1))
    jnm.add_gate_noise("CNOT", JAD(0.2))
    return c, jnm, NoiseModel.from_dict(jnm.to_dict())


def test_noisy_trajectories_are_jax_draw_for_draw(noisy_case):
    """JAX's sharded trajectory body with keys ``key_from_seed(s)`` and
    the port's on the Gumbel rows of those keys: the same branches, so
    the same states (a draw with a margin below 1e-5 may part)."""
    import jax.numpy as jnp

    c, jnm, tnm = noisy_case
    jp, tp = jprog.compile_circuit(c), tprog.compile_circuit(port(c))
    draws, width = tdist.noisy_draw_shape(tp, tnm)
    seeds = np.random.default_rng(0).integers(0, 2 ** 63, size=NOISY_SEEDS)
    record = []
    out = tdist.sharded_trajectory_fn(tp, tnm, make_mesh(8, device=CPU))(
        tp.initial_params, nd.mesh_trajectory_gumbels(seeds, draws, width),
        record)
    got = torch.complex(out[:, :, 0], out[:, :, 1]).reshape(NOISY_SEEDS, -1)
    margins = np.stack([m.numpy() for _, m in record], axis=1)
    fn = jdist.sharded_trajectory_fn(jp, jnm, jdist.make_mesh(8))
    params = jnp.asarray(jp.initial_params)
    for i, s in enumerate(seeds):
        from quantum_simulator_tpu.utils.seeding import key_from_seed
        from quantum_simulator_tpu.utils.xfer import to_host_complex

        want = to_host_complex(fn(params, key_from_seed(int(s))))
        if margins[i].min() < 1e-5:
            continue
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-5)


def test_noisy_trajectory_norm_zero_noise_and_fidelity():
    c = port(_circuit(5, [("H", [0], [], 0)] + [
        ("CNOT", [0, i], [], i) for i in range(1, 5)]))
    sim = tsim(4)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.3))
    ideal = sim.run(c)
    noisy = sim.run_noisy_trajectory(c, nm, seed=7)
    assert noisy.norm() == pytest.approx(1.0, abs=1e-4)
    zero = NoiseModel()
    zero.add_global_noise(DepolarizingNoise(0.0))
    assert sim.fidelity(ideal, sim.run_noisy_trajectory(c, zero, seed=1)) \
        == pytest.approx(1.0, abs=1e-4)


def _ghz(n=6):
    return port(_circuit(n, [("H", [0], [], 0)] + [
        ("CNOT", [q, q + 1], [], q + 1) for q in range(n - 1)]))


def test_ensemble_rho_in_law_against_density_matrix():
    """2000 trajectories of the noisy 6-qubit circuit: every one-qubit
    ensemble rho within 0.05 of the exact density matrix's (4.5 standard
    errors of an entry)."""
    c = QuantumCircuit.from_dict(_circuit(6, [
        ("Ry", [q], [0.4 + 0.3 * q], 0) for q in range(6)] + [
        ("CNOT", [q, q + 1], [], 1 + q) for q in range(5)]).to_dict())
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.08))
    nm.add_gate_noise("CNOT", AmplitudeDampingNoise(0.1))
    ens = tsim().ensemble_qubit_density_matrices(c, nm, n_trials=2000,
                                                 seed=3)
    rho = DensityMatrixSimulator(noise_model=nm, device=CPU).run(c).rho
    for q in range(6):
        r = rho.reshape(1 << q, 2, 1 << (5 - q), 1 << q, 2, 1 << (5 - q))
        exact = np.einsum("aibajb->ij", r)
        assert np.abs(ens[q] - exact).max() < 0.05, q
        assert np.trace(ens[q]).real == pytest.approx(1.0, abs=1e-4)


def test_run_with_noise_counts():
    nm = NoiseModel()
    nm.add_global_noise(BitFlipNoise(0.05))
    sim = tsim()
    a = sim.run_with_noise(_ghz(), nm, 400, trajectories=8, seed=11)
    assert a == sim.run_with_noise(_ghz(), nm, 400, trajectories=8, seed=11)
    assert sum(a.values()) == 400
    assert sum(sim.run_with_noise(_ghz(), nm, 5, trajectories=64,
                                  seed=1).values()) == 5
    plain = sim.run_with_noise(_ghz(), NoiseModel(), 500, seed=2)
    assert set(plain) <= {"000000", "111111"} and sum(plain.values()) == 500


def _brickwork(n, depth, seed):
    return port(jbrickwork(n, depth, seed=seed))


def test_segmented_equals_run():
    sim = tsim()
    c = _brickwork(9, 12, 3)
    calls = []
    seg = sim.run_segmented(c, 4, progress=lambda i, ns, w: calls.append(i))
    np.testing.assert_allclose(seg.data, sim.run(c).data, atol=1e-6)
    assert calls == [0, 1, 2]
    c = _brickwork(8, 7, 5)
    c.initial_states = [1, 0, 1, 0, 0, 1, 0, 1]
    np.testing.assert_allclose(sim.run(c).data,
                               sim.run_segmented(c, 3).data, atol=1e-6)
    with pytest.raises(ValueError, match="segment_columns"):
        sim.run_segmented(c, 0)


def test_segmented_grouped_route_equals_run():
    """14 local qubits: segments continue the planar stack in place."""
    sim = tsim(4)
    c = _brickwork(16, 6, 7)
    np.testing.assert_allclose(sim.run_segmented(c, 2).data,
                               sim.run(c).data, atol=1e-6)


def test_mesh_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(8)
    with pytest.raises(ValueError, match="power of 2"):
        make_mesh(6, device=CPU)
    with pytest.raises(TypeError, match="ShardMesh"):
        DistributedSimulator(mesh=object())
    with pytest.raises(ValueError, match="local qubit"):
        tsim(8).run(QuantumCircuit(3))


@pytest.mark.parametrize("complex_", [False, True])
def test_exchange_in_place_equals_transpose_twin(monkeypatch, complex_):
    """The in-place exchange, cut into chunks of 64 elements, against its
    twin (a transpose of the shard bit with the local bit), for every
    shard bit and local position of n = 11 over 8 shards."""
    from quantum_simulator_tpu_torch.ops import plan as gplan

    monkeypatch.setattr(gplan, "CHUNK_ELEMS", 64)
    mesh = make_mesh(8, device=CPU)
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((2, 8, 256), dtype=torch.complex64, generator=gen)
         if complex_ else torch.randn((2, 8, 2, 256), generator=gen))
    for g_pos in range(3):
        for l_pos in range(3, 11):
            y = x.clone()
            tdist._swap_global_local(y, g_pos, l_pos, 3, mesh)
            assert torch.equal(
                y, tdist.swap_global_local_plain(x, g_pos, l_pos, 3))
