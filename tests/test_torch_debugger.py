"""The port's circuit debugger, comparator and reference manager
(``debugger.py``, ``comparison.py``, ``reference.py``) against the JAX
package's, on the CPU.

The same circuits (carried over as dicts) and noise models go through
both packages. Tolerances and why:

* ideal snapshots against JAX ``CircuitDebugger.run_full_debug``: 1e-5
  per amplitude, the executor tolerance of ``tests/test_group_plan.py``;
* noisy column stacks against JAX ``plan.group_trajectory_body(...,
  record_columns=True)`` run eagerly with every ``jax.random.categorical``
  recorded and replayed through the port's ``draws``: 1e-5 per amplitude;
* reductions (fidelities, per-qubit fidelities, attribution, impact)
  against the JAX functions applied to the same stacks: 1e-6 (both reduce
  complex64 states in float32, in another order); percentages 1e-4;
* the batch-by-batch reduction over 3 or more batches against one batch:
  the same trials' draws, so 1e-6;
* distributions and fidelities of the reference manager: 1e-6.

On the CPU the dense and cross steps run the kernels' plain twins.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import debugger as jdbg
from quantum_simulator_tpu.comparison import CircuitComparator as JComparator
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu.reference import ReferenceManager as JReference
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import debugger as tdbg
from quantum_simulator_tpu_torch import simulator as tsim
from quantum_simulator_tpu_torch.comparison import CircuitComparator
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.reference import ReferenceManager
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

AMP_TOL = 1e-5
RED_TOL = 1e-6


def bell():
    c = jq.QuantumCircuit(2)
    c.add_gate(jq.GateInstance("H", [0], [], column=0))
    c.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=1))
    return c


def brick(n=5, layers=3, seed=0):
    """Ry / Rz columns and CNOT bricks, plus a Measure and a Barrier column
    (no snapshot label, no op)."""
    rng = np.random.default_rng(seed)
    c = jq.QuantumCircuit(n)
    col = 0
    for layer in range(layers):
        for q in range(n):
            name = "Rz" if (q + layer) % 3 == 0 else "Ry"
            c.add_gate(jq.GateInstance(name, [q], [float(rng.uniform(0, 6))],
                                       column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(jq.GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    c.add_gate(jq.GateInstance("Barrier", [0], [], column=col))
    c.add_gate(jq.GateInstance("Measure", [n - 1], [], column=col + 1))
    return c


CIRCUITS = {"bell": bell, "brick5": brick,
            "brick6": lambda: brick(6, 2, seed=3)}


def depol(p=0.1):
    nm = jq.NoiseModel()
    nm.add_global_noise(jq.DepolarizingNoise(p))
    return nm


def carry(jc, jnm=None):
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    tnm = None if jnm is None else tq.NoiseModel.from_dict(jnm.to_dict())
    return tc, tnm


@pytest.fixture
def recorded(monkeypatch):
    """Every ``jax.random.categorical`` result of the eager JAX calls made
    inside the test, in call order."""
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
# Snapshots and stepping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_ideal_snapshots_match_jax(name):
    jc = CIRCUITS[name]()
    tc, _ = carry(jc)
    want = jdbg.CircuitDebugger().run_full_debug(jc)
    got = tdbg.CircuitDebugger(device="cpu").run_full_debug(tc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.column_index, g.gate_labels) == (w.column_index,
                                                   w.gate_labels)
        np.testing.assert_allclose(g.state.data, w.state.data, atol=AMP_TOL)
        assert g.ideal_state is None and g.fidelity == 1.0
        assert g.entropy == pytest.approx(w.entropy, abs=1e-6)
    # and the port's own step-by-step run gives the same column states
    for g, (s, col) in zip(got, tq.Simulator(device="cpu")
                           .run_step_by_step(tc)):
        assert g.column_index == col
        np.testing.assert_allclose(g.state.data, s.data, atol=AMP_TOL)


def test_stepping_breakpoints_and_state_diff():
    tc, _ = carry(bell())
    dbg = tdbg.CircuitDebugger(device="cpu")
    snaps = dbg.run_full_debug(tc)
    assert [s.gate_labels for s in snaps] == [[], ["H(0)"], ["CNOT(0,1)"]]
    assert dbg.current_snapshot.column_index == -1
    assert dbg.step_forward().column_index == 0
    assert dbg.step_forward().column_index == 1
    assert dbg.step_forward() is None
    assert dbg.step_backward().column_index == 0
    assert dbg.goto_step(2).column_index == 1
    dbg.position = 0
    dbg.add_breakpoint(1)
    assert dbg.run_to_breakpoint().column_index == 1
    assert dbg.toggle_breakpoint(1) is False
    assert dbg.toggle_breakpoint(0) is True
    dbg.clear_breakpoints()
    assert dbg.breakpoints == set()
    want = jdbg.CircuitDebugger.compute_state_diff(
        *[jdbg.CircuitDebugger().run_full_debug(bell())[i] for i in (0, 2)])
    got = dbg.compute_state_diff(snaps[0], snaps[2])
    for key in ("fidelity", "tvd", "entropy_diff"):
        assert got[key] == pytest.approx(want[key], abs=RED_TOL)
    assert [d[:2] for d in got["amplitude_diffs"]] == \
        [d[:2] for d in want["amplitude_diffs"]]
    np.testing.assert_allclose(got["prob_diffs"], want["prob_diffs"],
                               atol=RED_TOL)


def test_noisy_run_full_debug():
    tc, tnm = carry(bell(), depol(0.5))
    snaps = tdbg.CircuitDebugger(device="cpu").run_full_debug(tc, tnm,
                                                              seed=42)
    assert snaps[0].fidelity == pytest.approx(1.0, abs=1e-5)
    assert all(s.ideal_state is not None for s in snaps)
    assert all(0.0 <= s.fidelity <= 1.0 + 1e-6 for s in snaps)
    for s in snaps:
        assert s.state.probabilities.sum() == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# Noisy column stacks: the JAX draws replayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bell", "brick5"])
def test_noisy_stacks_replay_jax_draws(name, recorded):
    jc, jnm = CIRCUITS[name](), depol(0.2)
    tc, tnm = carry(jc, jnm)
    jp, tp = jprog.compile_circuit(jc), tprog.compile_circuit(tc)
    want, draws = [], []
    for seed in range(2):
        recorded.clear()
        want.append(np.asarray(jplan.group_trajectory_body(
            jp, jnm, jnp.asarray(jp.initial_params), jax.random.PRNGKey(seed),
            jnp.complex64, record_columns=True)))
        draws.append(list(recorded))
    got, used = tplan.group_trajectory_body(
        tp, tnm, tp.initial_params, 2, "cpu", draws=torch.tensor(draws),
        record_columns=True)
    assert got.shape == (2, tp.num_columns + 1, 1 << tp.num_qubits)
    np.testing.assert_array_equal(used.numpy(), np.array(draws))
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=AMP_TOL)


def test_record_stack_is_one_buffer(monkeypatch):
    """``group_trajectory_body`` writes each column into one stack: the
    ``out`` it is given is what it returns, and no snapshot list is
    stacked into a second copy."""
    tc, tnm = carry(brick(), depol())
    tp = tprog.compile_circuit(tc)
    dim = 1 << tp.num_qubits
    stacked = []
    original = torch.stack

    def spying(tensors, *args, **kwargs):
        tensors = list(tensors)
        stacked.extend(tuple(t.shape) for t in tensors
                       if t.is_complex() and tuple(t.shape) == (4, dim))
        return original(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "stack", spying)
    out = torch.full((4, tp.num_columns + 1, dim), np.nan,
                     dtype=torch.complex64)
    got, _ = tplan.group_trajectory_body(
        tp, tnm, tp.initial_params, 4, "cpu", torch.Generator().manual_seed(1),
        record_columns=True, out=out)
    assert got is out and not stacked
    assert torch.isfinite(torch.view_as_real(out)).all()
    norms = out.abs().square().sum(-1)
    np.testing.assert_allclose(norms[:, -1].numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="out must be"):
        tplan.group_trajectory_body(
            tp, tnm, tp.initial_params, 4, "cpu", record_columns=True,
            out=out[:, :-1])


# ---------------------------------------------------------------------------
# Trial reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,p", [("bell", 0.2), ("brick5", 0.1),
                                    ("brick6", 0.0)])
def test_reductions_match_jax_on_the_same_stacks(name, p, monkeypatch):
    jc, jnm = CIRCUITS[name](), depol(p)
    tc, tnm = carry(jc, jnm)
    n = tc.num_qubits
    dbg = tdbg.CircuitDebugger(device="cpu")
    ideal, noisy = dbg._trial_stacks(tc, tnm, 6, seed=5)
    j_ideal, j_noisy = jnp.asarray(ideal.numpy()), jnp.asarray(noisy.numpy())
    monkeypatch.setattr(jdbg.CircuitDebugger, "_trial_stacks",
                        lambda self, *a: (j_ideal, j_noisy))
    np.testing.assert_allclose(
        tdbg._pairwise_fidelity(ideal, noisy).numpy(),
        np.asarray(jdbg._pairwise_fidelity(j_ideal, j_noisy)), atol=RED_TOL)
    np.testing.assert_allclose(
        tdbg._all_1q_rdms_batch(noisy[:, 1:].reshape(-1, 1 << n), n).numpy(),
        np.asarray(jdbg._all_1q_rdms_batch(
            j_noisy[:, 1:].reshape(-1, 1 << n), n)), atol=RED_TOL)

    want = jdbg.CircuitDebugger().compute_noise_attribution(jc, jnm,
                                                            n_trials=6)
    got = dbg.compute_noise_attribution(tc, tnm, n_trials=6, seed=5)
    for key in ("delta_fidelity", "delta_fidelity_std",
                "per_qubit_attribution"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   atol=RED_TOL)
    assert got.total_fidelity_loss == pytest.approx(
        want.total_fidelity_loss, abs=RED_TOL)
    np.testing.assert_allclose(got.column_attribution_pct,
                               want.column_attribution_pct, atol=1e-4)
    assert (got.is_recovery, got.no_measurable_loss, got.gate_labels) == \
        (want.is_recovery, want.no_measurable_loss, want.gate_labels)
    assert got.no_measurable_loss == (p == 0.0)

    want_i = jdbg.CircuitDebugger().compute_noise_impact(jc, jnm, n_trials=6)
    got_i = dbg.compute_noise_impact(tc, tnm, n_trials=6, seed=5)
    assert len(got_i) == len(want_i)
    for g, w in zip(got_i, want_i):
        assert (g.column_index, g.gate_labels) == (w.column_index,
                                                   w.gate_labels)
        for key in ("fidelity_before", "fidelity_after", "fidelity_drop",
                    "std_delta_fidelity"):
            assert getattr(g, key) == pytest.approx(getattr(w, key),
                                                    abs=RED_TOL)
        np.testing.assert_allclose(g.per_qubit_fidelity,
                                   w.per_qubit_fidelity, atol=RED_TOL)
    assert dbg.compute_noise_impact(tc, None) == []


def test_reduction_does_not_depend_on_the_batches(monkeypatch):
    """Each trial draws from its own row of uniforms: the stacks and the
    reductions over batches of 3 (4 batches, the memory budget cut to
    three trials' reckoning) equal those over one."""
    tc, tnm = carry(brick(), depol(0.15))
    dbg = tdbg.CircuitDebugger(device="cpu")
    tp = tprog.compile_circuit(tc)
    assert tsim.record_rows_per_batch(tp, 10) == 10
    whole = dbg._trial_stacks(tc, tnm, 10, seed=9)[1]
    f1, q1 = dbg._trial_reductions(tc, tnm, 10, seed=9)
    a1 = dbg.compute_noise_attribution(tc, tnm, n_trials=10, seed=9)
    monkeypatch.setattr(tsim, "TRAJECTORY_MEMORY_BYTES",
                        3 * (tp.num_columns + 5) * (8 << tp.num_qubits))
    assert tsim.record_rows_per_batch(tp, 10) == 3
    parts = dbg._trial_stacks(tc, tnm, 10, seed=9)[1]
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=RED_TOL)
    f3, q3 = dbg._trial_reductions(tc, tnm, 10, seed=9)
    np.testing.assert_allclose(f3, f1, atol=RED_TOL)
    np.testing.assert_allclose(q3, q1, atol=RED_TOL)
    a3 = dbg.compute_noise_attribution(tc, tnm, n_trials=10, seed=9)
    np.testing.assert_allclose(a3.delta_fidelity, a1.delta_fidelity,
                               atol=RED_TOL)
    # the contributions telescope to the last gap minus the first
    assert a1.total_fidelity_loss == pytest.approx(
        np.mean(f1[:, 0]) - np.mean(f1[:, -1]), abs=RED_TOL)


def test_run_batched_trajectories_fills_one_result():
    tc, tnm = carry(bell(), depol(0.3))
    tp = tprog.compile_circuit(tc)
    u = tplan.draw_uniforms(tp, tnm, 5, "cpu",
                            torch.Generator().manual_seed(0))
    fn = tprog.batched_trajectories_fn(tp, tnm, "cpu", record_columns=True)
    calls = []

    def counting(params, uniforms, out):
        calls.append(uniforms.shape[0])
        return fn(params, uniforms, out=out)

    got = tsim.run_batched_trajectories(counting, tp.initial_params, u,
                                        (tp.num_columns + 1, 4), 2)
    assert calls == [2, 2, 1]
    np.testing.assert_allclose(got.numpy(), fn(tp.initial_params, u).numpy(),
                               atol=RED_TOL)


# ---------------------------------------------------------------------------
# Comparator and reference manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CIRCUITS) + ["grover3"])
def test_compute_metrics_match_jax(name):
    from quantum_simulator_tpu.algorithms import AlgorithmTemplate

    jc = (AlgorithmTemplate.grover_search(3, marked_state=5)
          if name == "grover3" else CIRCUITS[name]())
    tc, _ = carry(jc)
    assert vars(CircuitComparator().compute_metrics(tc)) == \
        vars(JComparator().compute_metrics(jc))


def test_compare_identical_mismatched_and_noisy(tmp_path):
    tc, tnm = carry(bell(), depol(0.05))
    comp = CircuitComparator(device="cpu")
    res = comp.compare(tc, tc, shots=2000, seed=42)
    assert res.output_fidelity == pytest.approx(1.0, abs=1e-5)
    assert res.distribution_tvd < 0.1
    assert (res.metrics_a.gate_count, res.metrics_a.single_qubit_gates,
            res.metrics_a.multi_qubit_gates) == (2, 1, 1)
    assert res.purity_a == pytest.approx(1.0, abs=1e-4)
    mismatch = comp.compare(tq.QuantumCircuit(2), tq.QuantumCircuit(3),
                            shots=100, seed=1)
    assert np.isnan(mismatch.output_fidelity)
    noisy = comp.compare(tc, tc, shots=200, noise_model=tnm, seed=42)
    assert sum(noisy.result_a.measurement_counts.values()) == 200
    path = tmp_path / "report.json"
    CircuitComparator.export_report(res, str(path))
    data = json.loads(path.read_text())
    assert data["metrics_a"]["gate_count"] == 2 and "counts_a" in data


def test_reference_manager_matches_jax():
    jc = brick(4, 2, seed=1)
    tc, _ = carry(jc)
    jstate = jq.Simulator().run(jc, shots=0).final_state
    tstate = tq.Simulator(device="cpu").run(tc, shots=0).final_state
    jm, tm = JReference(), ReferenceManager()
    assert tm.get_distribution() is None and not tm.has_reference
    jm.store(jstate, circuit_hash=7)
    tm.store(tstate, circuit_hash=7)
    for basis in ("Z", "X", "Y", "x"):
        np.testing.assert_allclose(tm.get_distribution(basis),
                                   jm.get_distribution(basis), atol=RED_TOL)
    assert "X" in tm.reference._basis_distributions
    np.testing.assert_allclose(tm.reference.density_matrix,
                               jm.reference.density_matrix, atol=AMP_TOL)
    other = tq.StateVector(4, device="cpu")
    assert tm.fidelity_to_reference(other) == pytest.approx(
        jm.fidelity_to_reference(jq.StateVector(4)), abs=RED_TOL)
    assert tm.fidelity_to_reference(tstate) == pytest.approx(1.0, abs=1e-5)
    # the stored copy is independent of the state it came from
    tstate.apply_gate(np.array([[0, 1], [1, 0]]), [0])
    assert tm.fidelity_to_reference(tstate) < 1.0
    assert tm.check_invalidation(7) is False and tm.has_reference
    assert tm.check_invalidation(8) is True and not tm.has_reference
    assert tm.fidelity_to_reference(tstate) is None


def test_grover_circuit_roundtrips_in_fresh_registry():
    from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
    from quantum_simulator_tpu_torch.registry import GateRegistry

    d = AlgorithmTemplate.grover_search(3, marked_state=5).to_dict()
    GateRegistry.reset()
    circuit = tq.QuantumCircuit.from_dict(d)
    probs = tq.Simulator(device="cpu").run(
        circuit, shots=0).final_state.probabilities
    assert probs[5] > 0.5
    assert CircuitComparator().compute_metrics(circuit).multi_qubit_gates >= 2
