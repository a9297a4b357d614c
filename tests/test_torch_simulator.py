"""``Simulator.run`` of the port vs the JAX package's, on the CPU.

Amplitudes must agree within 1e-5 and Z/X/Y-basis counts within a total
variation distance of 0.03 over 8192 shots drawn with the same NumPy
seed. Also: the device sampler (used at 2^20 amplitudes and above)
against exact probabilities, the package's import boundary (no JAX), and
what the port still refuses.
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.algorithms import AlgorithmTemplate
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu_torch import (CONFIG, GateInstance,
                                         MeasurementBasis, MeasurementEngine,
                                         QuantumCircuit, Simulator,
                                         StateVector)
from quantum_simulator_tpu_torch import measurement as tmeas
from quantum_simulator_tpu_torch import simulator as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOTS = 8192


def tvd(a: dict, b: dict, shots: int) -> float:
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0) - b.get(k, 0)) for k in keys) / shots


def port(jc) -> QuantumCircuit:
    return QuantumCircuit.from_dict(jc.to_dict())


# Counts are compared on circuits of at most 4 qubits: with 8192 shots
# the sampling noise of a distribution over 16 outcomes stays well under
# the 0.03 bound even where the two NumPy streams drift apart (a last-bit
# difference in one probability can shift every later binomial draw).
SMALL = {
    "bell-3": lambda: _bell3(),
    "brickwork-4": lambda: brickwork_circuit(4, 6, seed=4),
    "qft-4-from-5": lambda: _qft_from(4, 5),
    "grover-4": lambda: AlgorithmTemplate.grover_search(4, marked_state=6),
}
LARGE = {
    "brickwork-10": lambda: brickwork_circuit(10, 6, seed=4),
    "qft-9-from-5": lambda: _qft_from(9, 5),
    "grover-8": lambda: AlgorithmTemplate.grover_search(8, marked_state=77),
}


def _bell3():
    c = jq.QuantumCircuit(3)
    c.add_gate(jq.GateInstance("H", [0], [], column=0))
    c.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=1))
    c.add_gate(jq.GateInstance("Ry", [2], [0.9], column=1))
    c.add_gate(jq.GateInstance("Measure", [2], [], column=2))
    return c


def _qft_from(n, index):
    c = AlgorithmTemplate.quantum_fourier_transform(n)
    c.initial_states = [(index >> (n - 1 - q)) & 1 for q in range(n)]
    return c


def _both_runs(jc, basis, shots):
    want = jq.Simulator().run(jc, shots=shots, seed=11,
                              measurement_basis=jq.MeasurementBasis[basis])
    got = Simulator(device="cpu").run(
        port(jc), shots=shots, seed=11,
        measurement_basis=MeasurementBasis[basis])
    np.testing.assert_allclose(got.final_state.data, want.final_state.data,
                               atol=1e-5)
    return got, want


@pytest.mark.parametrize("basis", ["Z", "X", "Y"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_run_counts_match_jax(name, basis):
    got, want = _both_runs(SMALL[name](), basis, SHOTS)
    assert sum(got.measurement_counts.values()) == SHOTS
    assert tvd(got.measurement_counts, want.measurement_counts, SHOTS) \
        <= 0.03


@pytest.mark.parametrize("name", sorted(LARGE))
def test_run_amplitudes_match_jax(name):
    got, _ = _both_runs(LARGE[name](), "Z", 64)
    assert sum(got.measurement_counts.values()) == 64


def test_device_sampler_matches_exact_probabilities(monkeypatch):
    """n = 20 reaches DEVICE_SAMPLING_MIN_DIM: the inverse-CDF sampler
    runs on the state's device (here the CPU), not rng.multinomial."""
    n = 20
    c = QuantumCircuit(n)
    c.add("Ry", [0], [1.1], 0)
    c.add("Ry", [9], [2.0], 0)
    c.add("H", [19], [], 0)
    c.add("CNOT", [0, 13], [], 1)
    c.add("CNOT", [19, 4], [], 1)
    calls = []
    real_sampler = tmeas.sample_counts_device

    def spy(*a, **k):
        calls.append(1)
        return real_sampler(*a, **k)

    monkeypatch.setattr(tmeas, "sample_counts_device", spy)
    res = Simulator(device="cpu").run(c, shots=SHOTS, seed=5)
    assert calls, "the device sampler did not run"
    probs = res.final_state.probabilities
    exact = {format(int(i), f"0{n}b"): p * SHOTS
             for i, p in enumerate(probs) if p > 1e-12}
    assert set(res.measurement_counts) <= set(exact)
    assert tvd(res.measurement_counts, exact, SHOTS) <= 0.03
    again = Simulator(device="cpu").run(c, shots=SHOTS, seed=5)
    assert again.measurement_counts == res.measurement_counts


def test_device_sampler_seeded_from_one_numpy_draw():
    probs = torch.tensor([0.1, 0.0, 0.6, 0.3], dtype=torch.float32)
    gen = torch.Generator().manual_seed(123)
    a = tmeas.sample_counts_device(probs, 4000, gen)
    assert sum(a.values()) == 4000 and 1 not in a
    assert abs(a[2] / 4000 - 0.6) < 0.05


def test_import_pulls_in_no_jax():
    code = ("import sys, quantum_simulator_tpu_torch as q; "
            "q.Simulator; "
            "import quantum_simulator_tpu_torch.ops.plan, "
            "quantum_simulator_tpu_torch.ops.cuda_exec, "
            "quantum_simulator_tpu_torch.interop, "
            "quantum_simulator_tpu_torch.noise, "
            "quantum_simulator_tpu_torch.ops.unitary_traj, "
            "quantum_simulator_tpu_torch.ops.monomial_traj, "
            "quantum_simulator_tpu_torch.ops.bigtraj, "
            "quantum_simulator_tpu_torch.analysis, "
            "quantum_simulator_tpu_torch.debugger, "
            "quantum_simulator_tpu_torch.reference, "
            "quantum_simulator_tpu_torch.comparison, "
            "quantum_simulator_tpu_torch.algorithms, "
            "quantum_simulator_tpu_torch.benchmarks, "
            "quantum_simulator_tpu_torch.mitigation, "
            "quantum_simulator_tpu_torch.shadows, "
            "quantum_simulator_tpu_torch.clifford, "
            "quantum_simulator_tpu_torch.qec, "
            "quantum_simulator_tpu_torch.qec_frame, "
            "quantum_simulator_tpu_torch.qec_circuit, "
            "quantum_simulator_tpu_torch.qec_dem, "
            "quantum_simulator_tpu_torch.qec_matching, "
            "quantum_simulator_tpu_torch.native, "
            "quantum_simulator_tpu_torch.mps, "
            "quantum_simulator_tpu_torch.dmrg, "
            "quantum_simulator_tpu_torch.lindblad_mps, "
            "quantum_simulator_tpu_torch.correlators; "
            "q.CliffordSimulator; q.MPSSimulator; q.dmrg_ground_state; "
            "quantum_simulator_tpu_torch.native.native_module(required=True); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'quantum_simulator_tpu' "
            "or m.startswith('quantum_simulator_tpu.')]; "
            "assert not bad, bad; print('clean')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_config_defaults_and_tf32_off():
    assert CONFIG.device == "cuda"
    assert CONFIG.dtype == torch.complex64
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_noise_and_step_recording_not_ported_yet():
    """The name is from the slice that refused all of n >= 30. What is
    still refused there is what the JAX package refuses
    (``simulator.py:225-230, 401-412, 427-432``): a state kept per column
    or per trajectory. It raises ``ValueError`` before anything is
    allocated (an n = 30 state is no CPU test, so each call here must
    fail fast)."""
    from quantum_simulator_tpu_torch import DepolarizingNoise, NoiseModel

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    sim = Simulator(noise_model=nm, device="cpu")
    assert sim.device == "cpu"
    c = QuantumCircuit(30)
    c.add("H", [0])
    refused = {
        "trajectory_states": lambda: sim.trajectory_states(c, 2, seed=0),
        "record_steps": lambda: Simulator(device="cpu").run(
            c, record_steps=True),
        "record_steps with noise": lambda: sim.run(c, record_steps=True),
        "step-by-step with noise": lambda: next(sim.run_step_by_step(c)),
        "ensemble_density_matrix": lambda: sim.ensemble_density_matrix(
            c, 2, seed=0),
    }
    match = {"trajectory_states": "trajectory_states",
             "record_steps": "record_steps",
             "record_steps with noise": "record_steps",
             "step-by-step with noise": "step-by-step with noise",
             "ensemble_density_matrix": "trajectory_states"}
    for name, call in refused.items():
        with pytest.raises(ValueError, match=match[name]):
            call()
    c5 = QuantumCircuit(5)
    c5.add("Measure", [0], [], 0)
    with pytest.raises(ValueError, match="final_shots"):
        Simulator(device="cpu").monitored_trajectories(c5, 2, final_shots=4)
    with pytest.raises(ValueError, match="num_qubits"):
        sim.run(QuantumCircuit(CONFIG.max_qubits + 1), shots=1)
    assert not hasattr(tsim, "NOISY_MAX_QUBITS")
    assert not hasattr(tsim, "_check_noisy_size")


def test_monitored_trajectories_not_ported_yet():
    """The name is from the slice before monitored trajectories were
    ported; they run now: a Bell pair measured on both qubits gives equal
    outcomes, both values occur, and each final state is the collapsed
    basis state."""
    c = QuantumCircuit(2)
    c.add("H", [0])
    c.add("CNOT", [0, 1], [], 1)
    c.add("Measure", [0], [], 2)
    c.add("Measure", [1], [], 2)
    outs, sites, states = Simulator(device="cpu").monitored_trajectories(
        c, 40, seed=0)
    assert outs.shape == (40, 2) and sites == [(2, 0), (2, 1)]
    assert (outs[:, 0] == outs[:, 1]).all() and 0 < outs[:, 0].sum() < 40
    for t in range(40):
        probs = states[t].device_data.abs().square().numpy()
        assert probs[3 * int(outs[t, 0])] > 0.999


def test_huge_threshold_routes_like_the_jax_package(monkeypatch):
    """The routing predicate is API: from ``HUGE_MIN_QUBITS`` = 30 on
    (where the JAX package's ``auto_chunks(n) > 1``), ``run`` returns a
    ``PlanarStateVector``, ``run_step_by_step`` marginal summaries and
    ``run_with_noise`` counts with no state. The threshold is lowered
    here to drive the public methods at n = 10."""
    from quantum_simulator_tpu.ops.bigstate import auto_chunks
    from quantum_simulator_tpu_torch import (DepolarizingNoise,
                                             MarginalStateSummary,
                                             NoiseModel, PlanarStateVector)
    from quantum_simulator_tpu_torch.ops import bigstate as tbig

    for n in (16, 29, 30, 32):
        assert tbig.is_huge(n) == (auto_chunks(n, planar=True) > 1)
    c = port(brickwork_circuit(10, 3, seed=4))
    dense = Simulator(device="cpu").run(c, shots=0).final_state
    monkeypatch.setattr(tbig, "HUGE_MIN_QUBITS", 10)
    sim = Simulator(device="cpu")
    res = sim.run(c, shots=500, seed=1)
    assert isinstance(res.final_state, PlanarStateVector)
    assert sum(res.measurement_counts.values()) == 500
    probs = dense.device_data.abs().square()
    np.testing.assert_allclose(
        res.final_state.qubit_probabilities(),
        [float(probs.reshape(1 << q, 2, -1)[:, 1].sum()) for q in range(10)],
        atol=1e-5)
    steps = list(sim.run_step_by_step(c))
    assert [i for _, i in steps] == list(range(-1, len(steps) - 1))
    assert all(isinstance(s, MarginalStateSummary) for s, _ in steps)
    np.testing.assert_allclose(steps[-1][0].qubit_probabilities(),
                               res.final_state.qubit_probabilities(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="record_steps"):
        sim.run(c, record_steps=True)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    noisy = Simulator(noise_model=nm, device="cpu")
    one = noisy.run(c, shots=100, seed=2)
    assert isinstance(one.final_state, PlanarStateVector)
    np.testing.assert_allclose(one.final_state.norm_sq(), 1.0, atol=1e-4)
    many = noisy.run_with_noise(c, shots=64, seed=3)
    assert many.final_state is None
    assert sum(many.measurement_counts.values()) == 64
    mc = QuantumCircuit(10)
    mc.add("H", [0])
    mc.add("Measure", [0], [], 1)
    outs, sites, counts = sim.monitored_trajectories(mc, 3, seed=0,
                                                     final_shots=16)
    assert outs.shape == (3, 1) and sites == [(1, 0)]
    assert [sum(d.values()) for d in counts] == [16, 16, 16]
    assert sim.monitored_trajectories(mc, 2, seed=0)[2] == []


def test_state_vector_round_trip():
    rng = np.random.default_rng(2)
    amp = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    amp /= np.linalg.norm(amp)
    sv = StateVector.from_numpy(amp, device="cpu")
    assert sv.num_qubits == 4 and sv.device_data.dtype == torch.complex64
    np.testing.assert_allclose(sv.data, amp, atol=1e-6)
    np.testing.assert_allclose(sv.probabilities, np.abs(amp) ** 2,
                               atol=1e-6)
    counts = MeasurementEngine.sample(sv, 1000,
                                      rng=np.random.default_rng(0))
    assert sum(counts.values()) == 1000
    with pytest.raises(ValueError):
        StateVector.from_numpy(amp[:12], device="cpu")


def test_circuit_serde_and_hashes_match_reference():
    jc = brickwork_circuit(6, 4, seed=1)
    jc.initial_states[2] = 1
    tc = port(jc)
    assert tc.to_dict() == jc.to_dict()
    assert tc.circuit_hash() == jc.circuit_hash()
    assert tc.structure_hash() == jc.structure_hash()
    assert [[g.to_dict() for g in col] for col in tc.get_ordered_gates()] \
        == [[g.to_dict() for g in col] for col in jc.get_ordered_gates()]
    tc.gates[0].params = [0.123]
    assert tc.structure_hash() == jc.structure_hash()
    assert tc.circuit_hash() != jc.circuit_hash()


def test_measure_and_barrier_are_markers():
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("X", [0], [], 0))
    c.add_gate(GateInstance("Barrier", [1], [], 0))
    c.add_gate(GateInstance("Measure", [0], [], 1))
    res = Simulator(device="cpu").run(c, shots=0)
    assert res.measurement_counts == {"10": 0} or \
        res.measurement_counts == {}
    np.testing.assert_allclose(np.abs(res.final_state.data) ** 2,
                               [0, 0, 1, 0], atol=1e-7)


@pytest.mark.parametrize("targets", [(0, 3), (1, 2, 4), (0, 1, 2, 3, 4)])
def test_apply_cphase_matches_jax(targets):
    from quantum_simulator_tpu.ops.apply import apply_cphase as jax_cphase
    from quantum_simulator_tpu_torch.ops.apply import apply_cphase

    rng = np.random.default_rng(9)
    amp = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(
        np.complex64)
    v = np.exp(0.7j)
    want = np.asarray(jax_cphase(jax.numpy.asarray(amp), targets, v, 5))
    got = apply_cphase(torch.from_numpy(amp), targets, v, 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
