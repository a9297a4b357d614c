"""The port's controller layer, view models, circuit renderer and
``SeedManager`` against the JAX package's, on the CPU.

Mirrors ``tests/test_controller_viewmodels.py`` and the two non-GUI tests
of ``tests/test_render_gui.py``. The same edits, NumPy states and seeds go
through both packages:

- controllers: the same ``to_dict()`` (and undo / redo texts) after every
  step of the same edit / undo / redo history;
- simulation controller: final and step-by-step states within 1e-5 of the
  JAX controller's, the same step columns and progress values;
- view models: numbers within 1e-5 (complex64 states on both sides);
  Monte-Carlo ones (the fidelity sweep, ensemble rho) against a NumPy
  density matrix within five standard errors, since the two packages'
  trajectory streams differ by design;
- ``SeedManager``: child seeds and NumPy streams equal to the JAX one's;
- the renderer: the same text labels and patch positions.
"""

import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import controller as jctl
from quantum_simulator_tpu import render as jrender
from quantum_simulator_tpu import viewmodels as jvm
from quantum_simulator_tpu.reference import ReferenceManager as JReference
from quantum_simulator_tpu.utils.seeding import SeedManager as JSeedManager
from quantum_simulator_tpu_torch import controller as tctl
from quantum_simulator_tpu_torch import render as trender
from quantum_simulator_tpu_torch import viewmodels as tvm
from quantum_simulator_tpu_torch.reference import ReferenceManager
from quantum_simulator_tpu_torch.utils.seeding import SeedManager
from tests.test_torch_bridge import numpy_noisy_rho
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def bell_circuit(pkg):
    c = pkg.QuantumCircuit(2)
    c.add_gate(pkg.GateInstance("H", [0], [], column=0))
    c.add_gate(pkg.GateInstance("CNOT", [0, 1], [], column=1))
    return c


def mixed_circuit(pkg, n=4):
    """Ry/Rz/H and CNOTs: a complex, entangled state."""
    c = pkg.QuantumCircuit(n)
    rng = np.random.default_rng(11)
    for q in range(n):
        c.add_gate(pkg.GateInstance("Ry", [q], [float(rng.uniform(0, 3))],
                                    column=0))
    for q in range(0, n - 1, 2):
        c.add_gate(pkg.GateInstance("CNOT", [q, q + 1], [], column=1))
    for q in range(n):
        c.add_gate(pkg.GateInstance("Rz" if q % 2 else "H", [q],
                                    [0.7 * q] if q % 2 else [], column=2))
    for q in range(1, n - 1, 2):
        c.add_gate(pkg.GateInstance("CNOT", [q, q + 1], [], column=3))
    return c


def random_psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi / np.linalg.norm(psi)


def state_pair(psi):
    """The same amplitudes as a JAX and a port ``StateVector``."""
    jsv = jq.StateVector(int(np.log2(len(psi))))
    jsv.data = psi
    return jsv, tq.StateVector.from_numpy(psi, device="cpu")


def bell_pair():
    return state_pair(np.array([1, 0, 0, 1]) / np.sqrt(2))


def close(a, b, tol=TOL):
    """Equal structures; floats (and arrays) within ``tol``."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, tol)
    elif hasattr(a, "__dataclass_fields__"):
        close(vars(a), vars(b), tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.shape(a) == np.shape(b)
        assert np.allclose(a, b, atol=tol, rtol=0)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=tol)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# CircuitController
# ---------------------------------------------------------------------------

def _history_add_undo_redo(ctl):
    ctl.add_gate("H", [0], column=0)
    yield
    ctl.add_gate("CNOT", [0, 1], column=1)
    yield
    ctl.undo()
    yield
    ctl.redo()
    yield
    ctl.undo()
    ctl.undo()
    yield
    ctl.redo()
    yield


def _history_move_and_params(ctl):
    gate = ctl.add_gate("Rx", [0], [0.5], column=0)
    yield
    ctl.move_gate(gate, 3, [1])
    yield
    ctl.update_gate_params(gate, [1.5])
    yield
    ctl.undo()
    yield
    ctl.undo()
    yield
    ctl.redo()
    yield
    other = ctl.add_gate("CZ", [0, 1], column=4)
    ctl.remove_selected_gates([other, gate])
    yield
    ctl.undo()
    yield


def _history_qubit_count(ctl):
    ctl.add_gate("H", [2], column=0)
    ctl.add_gate("X", [0], column=1)
    yield
    ctl.set_qubit_count(2)
    yield
    ctl.undo()
    yield
    ctl.set_qubit_count(5)
    yield


def _history_template_and_clear(ctl):
    ctl.load_template("ghz_state", num_qubits=3)
    yield
    ctl.clear_circuit()
    yield
    ctl.undo()
    yield
    ctl.load_template("bell_state", qubit0=1, qubit1=0)
    yield
    ctl.undo()
    yield


HISTORIES = {"add_undo_redo": _history_add_undo_redo,
             "move_and_params": _history_move_and_params,
             "set_qubit_count": _history_qubit_count,
             "load_template_and_clear": _history_template_and_clear}


def _replay(pkg, ctl_mod, history):
    ctl = ctl_mod.CircuitController(pkg.QuantumCircuit(3))
    changes = []
    ctl.on_circuit_changed(lambda: changes.append(1))
    log = []
    for _ in history(ctl):
        log.append((ctl.circuit.to_dict(), ctl.can_undo(), ctl.can_redo(),
                    ctl.undo_stack.undo_text, ctl.undo_stack.redo_text,
                    len(changes)))
    return log


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_edit_history_equals_jax(name):
    got = _replay(tq, tctl, HISTORIES[name])
    want = _replay(jq, jctl, HISTORIES[name])
    assert got == want


TEMPLATES = [("bell_state", {}), ("ghz_state", {"num_qubits": 4}),
             ("qft", {"num_qubits": 3}), ("inverse_qft", {"num_qubits": 3}),
             ("grover", {"num_qubits": 3, "marked_state": 5}),
             ("deutsch_jozsa", {"num_qubits": 3, "oracle_type": "constant"}),
             ("teleportation", {}), ("bernstein_vazirani", {"secret": "1101"}),
             ("superdense_coding", {}),
             ("tfim_quench", {"num_qubits": 4, "time": 0.5, "steps": 2})]


@pytest.mark.parametrize("name,kwargs", TEMPLATES,
                         ids=[t[0] for t in TEMPLATES])
def test_templates_equal_jax(name, kwargs):
    got = tctl.CircuitController(tq.QuantumCircuit(2))
    want = jctl.CircuitController(jq.QuantumCircuit(2))
    got.load_template(name, **kwargs)
    want.load_template(name, **kwargs)
    assert got.circuit.to_dict() == want.circuit.to_dict()
    assert got.undo_stack.undo_text == want.undo_stack.undo_text


def test_unknown_gate_and_template_rejected():
    for ctl in (tctl.CircuitController(tq.QuantumCircuit(2)),
                jctl.CircuitController(jq.QuantumCircuit(2))):
        with pytest.raises(KeyError):
            ctl.add_gate("NotAGate", [0])
        with pytest.raises(ValueError, match="Unknown template: nope"):
            ctl.load_template("nope")
        assert not ctl.can_undo()


# ---------------------------------------------------------------------------
# SimulationController
# ---------------------------------------------------------------------------

def _collect(ctl, start, timeout=60.0):
    """Start a run, join it, and return what the callbacks saw."""
    seen = {"finished": [], "steps": [], "progress": [], "errors": []}
    ctl.on_finished = seen["finished"].append
    ctl.on_step_updated = lambda s, col: seen["steps"].append((s, col))
    ctl.on_progress = seen["progress"].append
    ctl.on_error = seen["errors"].append
    start(ctl)
    ctl.join(timeout)
    assert not ctl.is_running
    return seen


def _controllers():
    return (tctl.SimulationController(device="cpu"),
            jctl.SimulationController())


def test_full_run_callbacks_equal_jax():
    port, jax = _controllers()
    assert port.device == torch.device("cpu")
    got, want = (_collect(ctl, lambda c: c.run_simulation(
        mixed_circuit(pkg), shots=8192, seed=42))
        for ctl, pkg in ((port, tq), (jax, jq)))
    assert got["progress"] == want["progress"] == [10, 100]
    assert not got["errors"] and len(got["finished"]) == 1
    res, jres = got["finished"][0], want["finished"][0]
    assert sum(res.measurement_counts.values()) == 8192
    assert np.abs(res.final_state.data - jres.final_state.data).max() <= TOL
    counts, jcounts = res.measurement_counts, jres.measurement_counts
    assert 0.5 * sum(abs(counts.get(k, 0) - jcounts.get(k, 0))
                     for k in set(counts) | set(jcounts)) / 8192 <= 0.03


def test_step_by_step_callbacks_equal_jax():
    port, jax = _controllers()
    got, want = (_collect(ctl, lambda c: c.run_step_by_step(
        mixed_circuit(pkg), shots=0))
        for ctl, pkg in ((port, tq), (jax, jq)))
    assert [c for _, c in got["steps"]] == [c for _, c in want["steps"]] \
        == [-1, 0, 1, 2, 3]
    assert got["progress"] == want["progress"]
    for (s, _), (js, _) in zip(got["steps"], want["steps"]):
        assert np.abs(s.data - js.data).max() <= TOL
    res = got["finished"][0]
    assert res.final_state is got["steps"][-1][0]
    assert (res.measurement_counts, res.num_shots) == ({}, 0)


def test_noisy_and_error_callbacks():
    port, jax = _controllers()
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(0.1))
    port.set_noise_model(nm)
    seen = _collect(port, lambda c: c.run_simulation(bell_circuit(tq),
                                                     shots=300, seed=1))
    assert sum(seen["finished"][0].measurement_counts.values()) == 300

    class Boom:
        def has_channels(self):
            raise RuntimeError("boom")

    errors = []
    for ctl, pkg in ((port, tq), (jax, jq)):
        ctl.set_noise_model(Boom())
        seen = _collect(ctl, lambda c: c.run_simulation(bell_circuit(pkg),
                                                        shots=10))
        errors.append(seen["errors"])
    assert errors[0] == errors[1] == ["boom"]


def test_join_timeout_keeps_the_running_worker():
    """A join that times out keeps the handle: is_running stays true and
    a second start is refused while the first worker runs."""
    ctl = tctl.SimulationController(device="cpu")
    ctl.set_step_delay(150)
    ctl.run_step_by_step(bell_circuit(tq), shots=0)
    ctl.join(timeout=0.01)
    assert ctl.is_running
    with pytest.raises(RuntimeError, match="already running"):
        ctl.run_simulation(bell_circuit(tq))
    ctl.stop_simulation()
    ctl.join(timeout=10)
    assert not ctl.is_running


# ---------------------------------------------------------------------------
# View models
# ---------------------------------------------------------------------------

class TestViewModels:
    def test_statevector_rows(self):
        jsv, sv = state_pair(random_psi(4, 1))
        for kw in ({}, {"nonzero_only": True, "threshold": 0.05}):
            close(tvm.StateVectorModel.rows(sv, **kw),
                  jvm.StateVectorModel.rows(jsv, **kw))
        rows = tvm.StateVectorModel.rows(bell_pair()[1], nonzero_only=True)
        assert [r.bitstring for r in rows] == ["00", "11"]

    def test_bloch_model(self):
        for psi in (random_psi(3, 2), np.array([1, 1]) / np.sqrt(2),
                    np.array([1, 0, 0, 1]) / np.sqrt(2)):
            jsv, sv = state_pair(psi)
            close(tvm.BlochModel.snapshot(sv), jvm.BlochModel.snapshot(jsv))
        model, jmodel = tvm.BlochModel(), jvm.BlochModel()
        jsv, sv = state_pair(random_psi(2, 3))
        for _ in range(3):
            model.record_step(sv)
            jmodel.record_step(jsv)
        close(model.faded_trajectory(1), jmodel.faded_trajectory(1))
        assert tvm.identify_bloch_state(0, 0, -1) == "|1⟩"

    def test_histogram(self):
        jsv, sv = state_pair(random_psi(3, 4))
        for basis in ("Z", "X", "Y"):
            bars = tvm.HistogramModel.from_state(
                sv, 8192, basis=tq.MeasurementBasis(basis), seed=42)
            jbars = jvm.HistogramModel.from_state(
                jsv, 8192, basis=jq.MeasurementBasis(basis), seed=42)
            assert sum(c for _, c, _ in bars) == 8192
            jd = {b: f for b, _, f in jbars}
            keys = {b for b, _, _ in bars} | set(jd)
            d = {b: f for b, _, f in bars}
            assert 0.5 * sum(abs(d.get(k, 0) - jd.get(k, 0))
                             for k in keys) <= 0.03
        assert tvm.HistogramModel.from_counts({"1": 3, "0": 1}) == \
            jvm.HistogramModel.from_counts({"1": 3, "0": 1})

    def test_density_matrix_model(self):
        jsv, sv = state_pair(random_psi(3, 5))
        close(tvm.DensityMatrixModel.from_state(sv),
              jvm.DensityMatrixModel.from_state(jsv))
        assert tvm.DensityMatrixModel.from_state(
            tq.StateVector(9, device="cpu")).truncated
        nm, jnm = tq.NoiseModel(), jq.NoiseModel()
        nm.add_global_noise(tq.DepolarizingNoise(0.1))
        jnm.add_global_noise(jq.DepolarizingNoise(0.1))
        circuit, jcircuit = mixed_circuit(tq, 3), mixed_circuit(jq, 3)
        model = tvm.DensityMatrixModel(device="cpu")
        exact = model.exact(circuit, nm)
        close(exact, jvm.DensityMatrixModel().exact(jcircuit, jnm))
        assert model.exact(circuit, nm) is exact  # cached
        rho = numpy_noisy_rho(circuit, 0.1)
        assert np.abs(exact.real + 1j * exact.imag - rho).max() <= 2e-5
        # ensemble: the trajectory mean of |psi><psi| against the exact rho
        trials = 1024
        v1 = model.ensemble(circuit, nm, n_trials=trials, seed=1)
        assert model.ensemble(circuit, nm, n_trials=trials, seed=1) is v1
        assert np.abs(v1.real + 1j * v1.imag - rho).max() <= \
            5 * 0.5 / np.sqrt(trials)
        assert v1.purity < 0.95
        assert model.ensemble(tq.QuantumCircuit(9), nm).truncated

    def test_entanglement_graph(self):
        jsv, sv = state_pair(random_psi(4, 6))
        for metric in ("mutual_information", "concurrence"):
            close(tvm.EntanglementGraphModel.build(sv, metric),
                  jvm.EntanglementGraphModel.build(jsv, metric))
        g = tvm.EntanglementGraphModel.build(bell_pair()[1])
        assert g.edges[0][:2] == (0, 1)
        assert g.edges[0][2] == pytest.approx(2.0, abs=1e-4)

    def test_entropy_evolution(self):
        models = []
        for pkg, vm, sim in ((tq, tvm, tq.Simulator(device="cpu")),
                             (jq, jvm, jq.Simulator())):
            model = vm.EntropyEvolutionModel(epsilon=0.1)
            events = []
            for state, col in sim.run_step_by_step(mixed_circuit(pkg)):
                events += [(e.event_type.value, e.step, e.qubit_pair)
                           for e in model.record_step(state, col)]
            models.append((model.steps, model.total, model.per_qubit,
                           model.bipartite, events))
        close(models[0], models[1])
        assert any(e[0] == "creation" for e in models[0][4])

    def test_analysis_dashboard(self):
        jsv, sv = state_pair(random_psi(4, 7))
        mgr, jmgr = ReferenceManager(), JReference()
        mgr.store(state_pair(random_psi(4, 8))[1])
        jmgr.store(state_pair(random_psi(4, 8))[0])
        close(tvm.AnalysisDashboardModel.build(sv, mgr),
              jvm.AnalysisDashboardModel.build(jsv, jmgr))
        dash = tvm.AnalysisDashboardModel.build(bell_pair()[1])
        assert not dash.is_separable and dash.fidelity_to_reference is None
        assert dash.pairwise_concurrence["q0-q1"] == pytest.approx(
            1.0, abs=1e-4)
        assert tvm.AnalysisDashboardModel.build(
            tq.StateVector(2, device="cpu")).is_separable

    def test_debugger_inspector(self):
        (jsv, sv), (jideal, ideal) = (state_pair(random_psi(4, 9)),
                                      state_pair(random_psi(4, 10)))
        for snap, jsnap in ((SimpleNamespace(state=sv, ideal_state=ideal),
                             SimpleNamespace(state=jsv, ideal_state=jideal)),
                            (SimpleNamespace(state=sv, ideal_state=None),
                             SimpleNamespace(state=jsv, ideal_state=None))):
            close(tvm.DebuggerInspectorModel.amplitude_rows(snap, limit=6),
                  jvm.DebuggerInspectorModel.amplitude_rows(jsnap, limit=6))
        impacts = [SimpleNamespace(per_qubit_fidelity=[0.99, 0.9, 1.0]),
                   SimpleNamespace(per_qubit_fidelity=[0.95, 0.8, 0.97])]
        close(tvm.DebuggerInspectorModel.noise_heatmap(impacts),
              jvm.DebuggerInspectorModel.noise_heatmap(impacts))
        attr = SimpleNamespace(column_attribution_pct=[61.2, -3.0, 41.8],
                               is_recovery=[False, True, False])
        assert tvm.DebuggerInspectorModel.heatmap_column_overlay(attr) == \
            jvm.DebuggerInspectorModel.heatmap_column_overlay(attr) == \
            ["61%", "—", "42%"]

    def test_resource_monitor(self):
        model = tvm.ResourceMonitorModel()
        s = model.sample()
        assert s is None or s.rss_bytes > 0
        model.record_simulation("bell", 2, 0.01)
        assert model.timings[0].num_qubits == 2
        for ram in (16 * 1024**3, 80 * 10**9):
            for mode in ("sv", "dm"):
                assert tvm.ResourceMonitorModel.max_qubits_for_ram(
                    ram, mode) == jvm.ResourceMonitorModel.max_qubits_for_ram(
                    ram, mode)
            got = tvm.ResourceMonitorModel.comparison_table(ram)
            want = jvm.ResourceMonitorModel.comparison_table(ram)
            for row, jrow in zip(got, want):
                assert {k: v for k, v in row.items() if k != "simulator"} \
                    == {k: v for k, v in jrow.items() if k != "simulator"}
        sv_row, dm_row, clifford_row = \
            tvm.ResourceMonitorModel.comparison_table()
        assert sv_row["max_qubits"] == 33   # complex64 on one 80 GB card
        assert clifford_row["max_qubits"] > sv_row["max_qubits"] > \
            dm_row["max_qubits"]

    def test_resource_monitor_proc_fallback(self):
        model = tvm.ResourceMonitorModel()
        model._proc = None  # simulate psutil absent
        model._psutil = None
        s1 = model.sample()
        assert s1 is not None
        assert s1.rss_bytes > 1024 * 1024
        assert 0.0 < s1.system_memory_percent < 100.0
        assert s1.cpu_percent == 0.0  # first call primes the baseline
        # Burn CPU until the process clock has moved 20 ms (a 5 s wall
        # deadline), so the reading cannot fall between two clock ticks.
        cpu0, deadline = time.process_time(), time.monotonic() + 5.0
        while (time.process_time() - cpu0 < 0.02
               and time.monotonic() < deadline):
            sum(i * i for i in range(10_000))
        assert model.sample().cpu_percent > 0.0
        assert len(model.samples) == 2

    def test_resource_monitor_no_proc_returns_none(self, monkeypatch):
        import os as _os

        model = tvm.ResourceMonitorModel()
        model._proc = None
        model._psutil = None
        real_exists = _os.path.exists
        monkeypatch.setattr(
            "quantum_simulator_tpu_torch.viewmodels.os.path.exists",
            lambda p: (False if p == "/proc/self/statm"
                       else real_exists(p)))
        assert model.sample() is None
        assert model.samples == []


def test_fidelity_sweep_follows_the_density_matrix():
    """The port's sweep: fidelity and ensemble purity tr(rho^2) of the
    trajectory mean within five standard errors of NumPy's rho; the JAX
    sweep (the same law) within the same bound of it."""
    trials, probs = 512, [0.0, 0.1, 0.3]
    points = tvm.FidelitySweepModel.sweep(mixed_circuit(tq, 3), probs,
                                          trials=trials, seed=42,
                                          device="cpu")
    jpoints = jvm.FidelitySweepModel.sweep(mixed_circuit(jq, 3), probs,
                                           trials=trials, seed=42)
    ideal = tq.Simulator(device="cpu").run(mixed_circuit(tq, 3),
                                           shots=0).final_state.data
    assert (points[0].fidelity, points[0].purity) == (1.0, 1.0)
    tol = 5 * 0.5 / np.sqrt(trials)
    for pt, jpt, p in zip(points[1:], jpoints[1:], probs[1:]):
        rho = numpy_noisy_rho(mixed_circuit(tq, 3), p)
        fid = float(np.real(ideal.conj() @ rho @ ideal))
        pur = float(np.real(np.trace(rho @ rho)))
        assert pt.noise_prob == p
        assert pt.fidelity == pytest.approx(fid, abs=tol)
        assert jpt.fidelity == pytest.approx(fid, abs=tol)
        assert pt.purity == pytest.approx(pur + (1 - pur) / trials, abs=tol)
        assert jpt.purity == pytest.approx(pt.purity, abs=2 * tol)
    assert points[1].fidelity > points[2].fidelity
    assert points[2].purity < 0.95


def test_fidelity_sweep_purity_is_the_gram_mean_of_its_states():
    """The sweep's purity is mean_{t,s} |<psi_t|psi_s>|^2 of the very
    trajectory states it drew (float32 products on the device vs NumPy
    float64 on the host: within 1e-5)."""
    seed, trials, p = 5, 60, 0.3
    point = tvm.FidelitySweepModel.sweep(bell_circuit(tq), [p],
                                         trials=trials, seed=seed,
                                         device="cpu")[0]
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(p))
    rng = np.random.default_rng(seed)
    states = tq.Simulator(noise_model=nm, device="cpu").trajectory_states(
        bell_circuit(tq), trials, seed=int(rng.integers(0, 2**63))
    ).numpy().astype(np.complex128)
    gram = states.conj() @ states.T
    assert point.purity == pytest.approx(float(np.mean(np.abs(gram) ** 2)),
                                         abs=1e-5)
    ideal = np.array([1, 0, 0, 1]) / np.sqrt(2)
    assert point.fidelity == pytest.approx(
        float(np.mean(np.abs(states @ ideal) ** 2)), abs=1e-5)
    assert point.purity < 0.95


# ---------------------------------------------------------------------------
# SeedManager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 42, 2**40 + 7])
def test_seed_manager_streams_equal_jax(seed):
    sm, jsm = SeedManager(seed), JSeedManager(seed)
    assert sm.seed == jsm.seed == seed
    if seed is None:   # an unseeded master: fix both to one stream
        sm.set_seed(123)
        jsm.set_seed(123)
    for _ in range(3):
        assert sm.create_child_seed() == jsm.create_child_seed()
        assert np.array_equal(sm.create_child_rng().random(5),
                              jsm.create_child_rng().random(5))
    sm.reset()
    jsm.reset()
    assert sm.create_child_seed() == jsm.create_child_seed()
    # a generator fork takes one draw of the stream, as JAX's key fork does
    gen = sm.create_child_generator(device="cpu")
    jsm.create_child_key()
    assert sm.create_child_seed() == jsm.create_child_seed()
    sm.reset()
    sm.create_child_seed()
    assert gen.initial_seed() == sm.create_child_seed()


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def full_featured_circuit(pkg):
    c = pkg.QuantumCircuit(4, initial_states=[0, 1, 0, 1])
    for name, targets, params, col in [
            ("H", [0], [], 0), ("Rx", [1], [0.5], 0), ("CNOT", [0, 1], [], 1),
            ("CZ", [1, 2], [], 2), ("SWAP", [2, 3], [], 3),
            ("Toffoli", [0, 1, 2], [], 4), ("Fredkin", [3, 0, 1], [], 5),
            ("CPhase", [2, 3], [0.25], 6), ("Barrier", [0], [], 7),
            ("Measure", [0], [], 8)]:
        c.add_gate(pkg.GateInstance(name, targets, params, column=col))
    return c


def _drawing(render_mod, circuit, theme):
    import matplotlib.pyplot as plt

    fig = render_mod.CircuitRenderer(theme).figure(circuit)
    ax = fig.axes[0]
    out = ([(t.get_text(), t.get_position(), t.get_color())
            for t in ax.texts],
           [(type(p).__name__, p.get_extents().bounds) for p in ax.patches],
           [tuple(map(tuple, ln.get_xydata())) for ln in ax.lines],
           tuple(fig.get_size_inches()))
    plt.close(fig)
    return out


@pytest.mark.parametrize("theme", ["dark", "light"])
def test_renderer_draws_what_jax_draws(theme):
    got = _drawing(trender, full_featured_circuit(tq), theme)
    want = _drawing(jrender, full_featured_circuit(jq), theme)
    close(got, want, 1e-9)
    labels = [t for t, _, _ in got[0]]
    assert "q1: |1⟩" in labels and "M" in labels


def test_export_png_and_svg(tmp_path: Path):
    c = full_featured_circuit(tq)
    png = tmp_path / "circuit.png"
    svg = tmp_path / "circuit.svg"
    trender.CircuitExporter.export_png(c, png)
    trender.CircuitExporter.export_svg(c, svg, theme="light")
    assert png.stat().st_size > 1000
    assert "<svg" in svg.read_text()


def test_render_template():
    import matplotlib.pyplot as plt

    from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate

    fig = trender.CircuitRenderer().figure(
        AlgorithmTemplate.quantum_fourier_transform(3))
    assert fig is not None
    plt.close(fig)
