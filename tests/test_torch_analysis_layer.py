"""The port's analysis layer (``analysis.py`` beyond ``StateAnalysis``,
``algorithms.py``, ``benchmarks.py``) against the JAX package's, on the
CPU.

Tolerances and why:

* host state machines and NumPy reductions (the entanglement-event
  detector given the same MI matrices, TVD, KL, ``counts_to_array``):
  equal; event magnitudes and MI histories from each package's own
  reduced density matrices 1e-5; ``shot_convergence`` on the same state
  and seed 1e-6 (the same counts, each package's float32 probabilities);
* amplitudes (algorithm templates, quantum-volume trials with the same
  parameter rows and, with noise, the same draws): 1e-5, the executor
  tolerance of ``tests/test_group_plan.py``; batched operands 1e-6, the
  tolerance of ``tests/test_torch_traj.py``;
* heavy-output means of ideal quantum volume: 1e-5 (sums of float32
  probabilities); the noisy mean against the exact density matrix's heavy
  mass: 0.05, the law bound of the JAX package's ensemble tests.

On the CPU the dense and cross steps run the kernels' plain twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import analysis as jan
from quantum_simulator_tpu.algorithms import AlgorithmTemplate as JAlg
from quantum_simulator_tpu.benchmarks import BenchmarkSuite as JSuite
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu.ops import unitary_traj as jut
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import analysis as tan
from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate as TAlg
from quantum_simulator_tpu_torch.benchmarks import BenchmarkSuite
from quantum_simulator_tpu_torch.interop import operands_from_numpy
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.ops import unitary_traj as tut
from tests.test_torch_traj import jax_branch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

AMP_TOL = 1e-5
OP_TOL = 1e-6


def noise(channel):
    nm = jq.NoiseModel()
    nm.add_global_noise(channel)
    return nm, tq.NoiseModel.from_dict(nm.to_dict())


@pytest.fixture
def recorded(monkeypatch):
    """Every eager ``jax.random.categorical`` result, in call order."""
    draws: list[int] = []
    original = jax.random.categorical

    def recording(key, logits, *args, **kwargs):
        out = original(key, logits, *args, **kwargs)
        if not isinstance(out, jax.core.Tracer):
            draws.append(int(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", recording)
    return draws


# ---------------------------------------------------------------------------
# Entanglement events and convergence
# ---------------------------------------------------------------------------

def _event_rows(events):
    return [(e.step, e.qubit_pair, e.event_type.value) for e in events]


@pytest.mark.parametrize("persistence", [1, 2])
def test_event_detector_matches_jax(persistence):
    """The column states of a circuit that entangles and then undoes it,
    through both detectors: the same events at the same steps."""
    jc = jq.QuantumCircuit(3)
    for col, (name, qs, ps) in enumerate([
            ("H", [0], []), ("CNOT", [0, 1], []), ("Ry", [2], [0.4]),
            ("CNOT", [1, 2], []), ("CNOT", [1, 2], []),
            ("CNOT", [0, 1], []), ("H", [0], [])]):
        jc.add_gate(jq.GateInstance(name, qs, ps, column=col))
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    jdet = jan.EntanglementEventDetector(epsilon=0.1, persistence=persistence)
    tdet = tan.EntanglementEventDetector(epsilon=0.1, persistence=persistence)
    jsteps = list(jq.Simulator().run_step_by_step(jc))
    tsteps = list(tq.Simulator(device="cpu").run_step_by_step(tc))
    for (js, i), (ts, k) in zip(jsteps, tsteps):
        assert i == k
        assert _event_rows(tdet.process_step(ts, k)) == \
            _event_rows(jdet.process_step(js, i))
    assert _event_rows(tdet.get_timeline()) == _event_rows(
        jdet.get_timeline())
    assert len(tdet.get_timeline()) >= 2
    for g, w in zip(tdet.get_timeline(), jdet.get_timeline()):
        assert g.magnitude == pytest.approx(w.magnitude, abs=1e-5)
    hist = tdet.get_pair_history(1, 0)
    assert [s for s, _ in hist] == [s for s, _ in jdet.get_pair_history(0, 1)]
    np.testing.assert_allclose([m for _, m in hist],
                               [m for _, m in jdet.get_pair_history(0, 1)],
                               atol=1e-5)
    assert set(tdet.get_all_pair_histories()) == {(0, 1), (0, 2), (1, 2)}
    tdet.reset()
    assert tdet.get_timeline() == [] and tdet.get_pair_history(0, 1) == []


def test_event_state_machine_on_given_mi(monkeypatch):
    """Hysteresis and persistence on a scripted MI sequence, identical to
    the JAX machine's: creation, an increase, a decrease that stays above
    epsilon_off, then disentanglement."""
    seq = [0.0, 0.5, 0.9, 0.9, 0.4, 0.04, 0.0]
    mats = [np.array([[0.0, m], [m, 0.0]]) for m in seq]
    for mod in (jan, tan):
        it = iter(mats)
        monkeypatch.setattr(mod.StateAnalysis, "pairwise_mutual_information",
                            staticmethod(lambda state, it=it: next(it)))
    rows = []
    for mod, sv in ((jan, jq.StateVector(2)),
                    (tan, tq.StateVector(2, device="cpu"))):
        det = mod.EntanglementEventDetector(epsilon=0.1, epsilon_off=0.05)
        for step in range(len(seq)):
            det.process_step(sv, step)
        rows.append([(e.step, e.event_type.value, e.magnitude,
                      e.entropy_before, e.entropy_after)
                     for e in det.get_timeline()])
    assert rows[0] == rows[1]
    assert [r[1] for r in rows[1]] == ["creation", "increase", "decrease",
                                       "disentanglement"]


@pytest.mark.parametrize("counts,shots", [({"00": 500, "11": 500}, 1000),
                                          ({"00": 1000}, 1000),
                                          ({"01": 3, "10": 7, "11": 90}, 100)])
def test_convergence_metrics_equal_jax(counts, shots):
    probs = np.array([0.5, 0.0, 0.0, 0.5])
    np.testing.assert_array_equal(tan.counts_to_array(counts, 2),
                                  jan.counts_to_array(counts, 2))
    assert tan.ConvergenceAnalysis.tvd(probs, counts, shots) == \
        jan.ConvergenceAnalysis.tvd(probs, counts, shots)
    assert tan.ConvergenceAnalysis.kl_divergence(probs, counts, shots) == \
        jan.ConvergenceAnalysis.kl_divergence(probs, counts, shots)


def test_shot_convergence_equals_jax():
    v = np.array([0.6, 0.1j, -0.3, 0.2 + 0.1j, 0.5, 0.0, 0.3, 0.3j])
    v /= np.linalg.norm(v)
    jsv, tsv = jq.StateVector(3), tq.StateVector(3, device="cpu")
    jsv.data, tsv.data = v, v
    want = jan.ConvergenceAnalysis.shot_convergence(jsv, [100, 10000],
                                                    seed=42)
    got = tan.ConvergenceAnalysis.shot_convergence(tsv, [100, 10000],
                                                   seed=42)
    # the same seed stream draws the same counts; the ideal probabilities
    # are each package's float32 state in float64
    for g, w in zip(got, want):
        assert g["shots"] == w["shots"]
        for key in ("tvd", "kl_divergence"):
            assert g[key] == pytest.approx(w[key], abs=1e-6)
    assert got[1]["tvd"] < got[0]["tvd"] + 0.05


# ---------------------------------------------------------------------------
# Benchmark analysis
# ---------------------------------------------------------------------------

def test_gate_timing_shape():
    rows = tan.BenchmarkAnalysis.gate_timing(
        range(2, 4), np.array([[1, 1], [1, -1]]) / np.sqrt(2),
        lambda n: [0], repetitions=3, device="cpu")
    assert [r["num_qubits"] for r in rows] == [2, 3]
    assert all(r["mean_time_ms"] >= 0 and r["std_time_ms"] >= 0
               for r in rows)


def test_quantum_volume_equals_jax():
    want = jan.BenchmarkAnalysis.quantum_volume(max_qubits=3, num_trials=5,
                                                seed=42)
    got = tan.BenchmarkAnalysis.quantum_volume(max_qubits=3, num_trials=5,
                                               seed=42, device="cpu")
    assert got == want and got["log2_qv"] == 3


@pytest.mark.parametrize("row", [[0.1, 0.2, 0.2, 0.5],
                                 [0.1, 0.2, 0.3, 0.4],
                                 [0.25, 0.25, 0.25, 0.25],
                                 [0.4, 0.1, 0.1, 0.1, 0.3],
                                 [0.05, 0.3, 0.15, 0.15, 0.2, 0.15]])
def test_heavy_set_matches_jnp_median(row):
    """torch's lower median and jnp's mean of the two middle values give
    the same heavy set, ties at the middle included."""
    p = np.asarray(row, np.float32)
    want = np.asarray(p > jnp.median(jnp.asarray(p)))
    got = tan.heavy_set(torch.from_numpy(np.stack([p, p[::-1].copy()])))
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), want[::-1])


@pytest.fixture(scope="module")
def qv_ideal():
    kw = dict(widths=(4,), num_trials=7, seed=3, chunk=3)
    return (jan.BenchmarkAnalysis.quantum_volume_at_scale(**kw),
            tan.BenchmarkAnalysis.quantum_volume_at_scale(device="cpu", **kw))


def test_quantum_volume_at_scale_ideal_matches_jax(qv_ideal):
    want, got = qv_ideal
    assert (got["quantum_volume"], got["log2_qv"], got["threshold"]) == \
        (want["quantum_volume"], want["log2_qv"], want["threshold"])
    for g, w in zip(got["results_per_width"], want["results_per_width"]):
        for key in ("heavy_output_mean", "heavy_output_stderr",
                    "heavy_output_ideal_mean"):
            assert g[key] == pytest.approx(w[key], abs=AMP_TOL)
        for key in ("width", "num_trials", "trajectories_per_trial",
                    "passed"):
            assert g[key] == w[key]
        assert g["seconds"] >= 0


def _qv_case(m: int, trials: int, seed: int = 0):
    tc = tan.qv_model_circuit(m)
    jc = jq.QuantumCircuit.from_dict(tc.to_dict())
    tp, jp = tprog.compile_circuit(tc), jprog.compile_circuit(jc)
    rows = np.random.default_rng(seed).uniform(
        0, 2 * np.pi, size=(trials, tp.num_params)).astype(np.float32)
    return tp, jp, rows


def test_heavy_output_chunk_ideal_matches_jax_states():
    tp, jp, rows = _qv_case(5, 4)
    fwd = jax.jit(lambda p: jprog._forward_body(jp, p, jnp.complex64))
    hi, hn, draws = tan.heavy_output_chunk(tp, None, torch.from_numpy(rows),
                                           "cpu")
    assert draws is None and torch.equal(hi, hn)
    for t, p in enumerate(rows):
        probs = np.abs(np.asarray(fwd(jnp.asarray(p)))) ** 2
        want = probs[probs > np.median(probs)].sum()
        assert float(hi[t]) == pytest.approx(want, abs=AMP_TOL)


def _compare_operands(got, want, plan, t):
    for ax, stack in enumerate(want[0]):
        for i in range(len(plan.dense_real[ax])):
            np.testing.assert_allclose(got[0][ax][i][t].numpy(), stack[i],
                                       atol=OP_TOL)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_allclose(g[t].numpy(), w, atol=OP_TOL)


def test_param_rows_with_splice_overrides_match_jax_per_trial():
    """A (T, P) parameter batch together with unitary-splice draws: each
    row's operands are the ones JAX builds for that trial's parameters and
    key, and each row's state is JAX's trajectory for them."""
    jnm, tnm = noise(jq.DepolarizingNoise(0.05))
    tp, jp, rows = _qv_case(4, 2)
    keys = [jax.random.PRNGKey(s) for s in range(len(rows))]
    jspec = jut.unitary_insert_spec(jp, jnm)
    tspec = tut.unitary_insert_spec(tp, tnm)
    branch = torch.from_numpy(np.stack([jax_branch(jspec, k) for k in keys]))
    plan = tplan.get_group_plan(tspec.aug)
    got = tplan.build_group_operands_batched(
        tspec.aug, plan, torch.from_numpy(rows), len(rows), "cpu",
        tut.branch_overrides(tspec, branch))
    jpl = jplan.get_group_plan(jspec.aug)
    body = jax.jit(lambda p, k: jut.unitary_insert_trajectory_body(
        jp, jnm, p, k, jnp.complex64))
    states, used = tprog.batched_trajectories(
        tp, tnm, torch.from_numpy(rows), len(rows), "cpu", draws=branch)
    assert used is branch
    for t, key in enumerate(keys):
        want = operands_from_numpy(jplan.build_group_operands(
            jspec.aug, jpl, rows[t], np.complex64,
            overrides=jut._draw_overrides_host(jspec, key), xp=np))
        _compare_operands(got, want, plan, t)
        np.testing.assert_allclose(states[t].numpy(),
                                   np.asarray(body(jnp.asarray(rows[t]), key)),
                                   atol=AMP_TOL)


def test_param_rows_on_the_monomial_splice_equal_one_row_at_a_time():
    """A (T, P) parameter batch through the monomial splice (amplitude
    damping) gives each row the state of that row's parameter vector run
    alone on the same draws (the single-vector body is held to JAX's in
    ``tests/test_torch_bigtraj.py``)."""
    _, tnm = noise(jq.AmplitudeDampingNoise(0.1))
    tp, _, rows = _qv_case(4, 3, seed=1)
    assert tprog.trajectory_route(tp, tnm) == "monomial"
    got, record = tan.noisy_param_rows(tp, tnm, torch.from_numpy(rows),
                                       "cpu", torch.Generator().manual_seed(2))
    for t, p in enumerate(rows):
        one = [(idxs[t:t + 1], br[t:t + 1]) for idxs, br in record]
        want, _ = tmt.monomial_trajectory_body(
            tp, tnm, p.astype(np.float64), 1, "cpu", draws=one)
        np.testing.assert_allclose(got[t].numpy(), want[0].numpy(),
                                   atol=AMP_TOL)


def test_heavy_output_chunk_noisy_rows_and_repeats():
    """With trajectories_per_trial = 2 every trial's row is repeated and
    each repeat draws its own branches; replaying the draws through the
    twins reproduces the values, and a fold-route model (a channel with
    no splice) runs the trials one after the other."""
    jnm, tnm = noise(jq.DepolarizingNoise(0.2))
    tp, _, rows = _qv_case(4, 3, seed=2)
    gen = torch.Generator().manual_seed(4)
    hi, hn, draws = tan.heavy_output_chunk(tp, tnm, torch.from_numpy(rows),
                                           "cpu", 2, gen)
    assert draws.shape[0] == 6 and not torch.equal(draws[0::2], draws[1::2])
    hi2, hn2, _ = tan.heavy_output_chunk(tp, tnm, torch.from_numpy(rows),
                                         "cpu", 2, draws=draws, plain=True)
    np.testing.assert_allclose(hn2.numpy(), hn.numpy(), atol=AMP_TOL)
    np.testing.assert_allclose(hi2.numpy(), hi.numpy(), atol=AMP_TOL)

    from tests.test_torch_traj import _TXDamp

    fold = tq.NoiseModel()
    fold.add_global_noise(_TXDamp(0.2))
    assert tprog.trajectory_route(tp, fold) == "fold"
    hi3, hn3, d3 = tan.heavy_output_chunk(tp, fold, torch.from_numpy(rows),
                                          "cpu", 1, gen)
    assert len(d3) == 3 and hn3.shape == (3,)
    np.testing.assert_allclose(hi3.numpy(), hi.numpy(), atol=AMP_TOL)
    assert ((hn3 >= 0) & (hn3 <= 1 + 1e-5)).all()


def _bound(tc, program, row):
    """The model circuit with the parameter row bound into its gates."""
    c = tq.QuantumCircuit.from_dict(tc.to_dict())
    for gi, g in enumerate(c.gates):
        off = program.param_offset_for(gi, 0)
        if off is not None:
            g.params = [float(row[off])]
    return c


def test_quantum_volume_at_scale_noisy_law():
    """The noisy heavy-output mean against its exact value: per trial the
    heavy mass of the port's exact density matrix (dense route), averaged
    over the same trials. One trajectory's heavy mass spreads by about
    0.2, so 16 trials x 16 trajectories put the standard error of the
    mean near 0.013; the law bound is 0.05."""
    _, tnm = noise(jq.DepolarizingNoise(0.03))
    kw = dict(widths=(4,), num_trials=16, seed=0, chunk=6,
              trajectories_per_trial=16, device="cpu")
    got = tan.BenchmarkAnalysis.quantum_volume_at_scale(noise_model=tnm, **kw)
    ideal = tan.BenchmarkAnalysis.quantum_volume_at_scale(**kw)
    g = got["results_per_width"][0]
    assert g["heavy_output_ideal_mean"] == pytest.approx(
        ideal["results_per_width"][0]["heavy_output_mean"], abs=AMP_TOL)
    tc = tan.qv_model_circuit(4)
    program = tprog.compile_circuit(tc)
    rows = np.random.default_rng(0).uniform(
        0, 2 * np.pi, size=(18, program.num_params)).astype(np.float32)
    dm = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu")
    exact = []
    for row in rows[:16]:
        circ = _bound(tc, program, row)
        probs = tq.Simulator(device="cpu").run(
            circ, shots=0).final_state.probabilities
        noisy = dm.run(circ, method="dense").probabilities
        exact.append(noisy[probs > np.median(probs)].sum())
    assert g["heavy_output_mean"] < g["heavy_output_ideal_mean"]
    assert g["heavy_output_mean"] == pytest.approx(np.mean(exact), abs=0.05)
    seen = []
    tan.BenchmarkAnalysis.quantum_volume_at_scale(
        widths=(2, 3), num_trials=4, seed=1, chunk=4, on_width=seen.append,
        device="cpu")
    assert [r["width"] for r in seen] == [2, 3]


# ---------------------------------------------------------------------------
# Algorithm templates and the benchmark suite
# ---------------------------------------------------------------------------

TEMPLATES = {
    "bell": lambda A: A.bell_state(),
    "bell-13": lambda A: A.bell_state(1, 3),
    "ghz4": lambda A: A.ghz_state(4),
    "qft4": lambda A: A.quantum_fourier_transform(4),
    "iqft3": lambda A: A.inverse_qft(3),
    "grover3": lambda A: A.grover_search(3, marked_state=5),
    "grover2": lambda A: A.grover_search(2, marked_state=1),
    "grover1": lambda A: A.grover_search(1, marked_state=1),
    "grover8": lambda A: A.grover_search(8, marked_state=77,
                                         num_iterations=2),
    "dj-balanced": lambda A: A.deutsch_jozsa(4, "balanced"),
    "dj-constant": lambda A: A.deutsch_jozsa(3, "constant"),
    "teleport": lambda A: A.quantum_teleportation(),
    "bv": lambda A: A.bernstein_vazirani("1011"),
    "superdense": lambda A: A.superdense_coding(),
    "tfim": lambda A: A.tfim_quench(4, time=0.5),
    "tfim0": lambda A: A.tfim_quench(4, time=0.0),
}


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_templates_gate_for_gate_and_state(name):
    jc, tc = TEMPLATES[name](JAlg), TEMPLATES[name](TAlg)
    assert tc.to_dict() == jc.to_dict()
    want = jq.Simulator().run(jc, shots=0).final_state.data
    got = tq.Simulator(device="cpu").run(tc, shots=0).final_state.data
    np.testing.assert_allclose(got, want, atol=AMP_TOL)


def test_template_list_and_errors():
    assert TAlg.list_templates() == JAlg.list_templates()
    with pytest.raises(ValueError):
        TAlg.tfim_quench(1)
    probs = tq.Simulator(device="cpu").run(
        TAlg.grover_search(4, marked_state=11), shots=0
    ).final_state.probabilities
    assert int(np.argmax(probs)) == 11 and probs[11] > 0.8


def test_benchmark_suite_matches_jax():
    want = JSuite.get_all_benchmarks()
    got = BenchmarkSuite.get_all_benchmarks()
    assert [(g["name"], g["circuit"].to_dict(), g["expected_nonzero"],
             g["expected_fidelity_min"]) for g in got] == \
        [(w["name"], w["circuit"].to_dict(), w["expected_nonzero"],
          w["expected_fidelity_min"]) for w in want]
    results = BenchmarkSuite.run_all(seed=42, device="cpu")
    assert len(results) == 6
    for r in results:
        assert r.passed, f"{r.name}: {r.details}"
        assert r.fidelity == 1.0 and r.runtime_ms >= 0
    _, tnm = noise(jq.DepolarizingNoise(0.3))
    noisy = BenchmarkSuite.run_all(noise_model=tnm, seed=42, device="cpu")
    assert any(r.fidelity < 1.0 for r in noisy)
