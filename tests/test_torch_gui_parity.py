"""The port's GUI against the JAX package's GUI, on the CPU.

Both ``MainWindow`` classes are built under the functional Qt stubs in
one process (the port's with ``device="cpu"``, where the kernels run
their plain twins), fed the same circuit, seed (``SeedManager(42)`` in
both) and noise model, and driven through the same actions. Tolerances
and why:

* ``_run_with_shots`` final and reference states, the panels' view data
  (Bloch vectors, density-matrix view, entanglement graph, entropies,
  the analysis dashboard with the fidelity against the stored reference),
  step-mode entropies and the debugger's ideal snapshots, the comparison
  panel's fidelities: 1e-5 (complex64 states; sums in another order);
* the optimizer panel's parameter-shift trajectory from the same
  initial values: 1e-4 (float32 costs, Adam amplifies their rounding);
* histogram counts: total variation distance <= 0.03 over 8192 shots, as
  ``tests/test_torch_simulator.py`` compares ``Simulator.run`` counts
  (the two frameworks' generators differ);
* stochastic flows in law: the noisy run's counts within TVD 0.03 of the
  exact noisy distribution (density matrix and readout confusion), the
  debugger's noise attribution within five standard errors of the exact
  fidelity loss; the QEC panel's cycle and threshold sweep draw for draw,
  JAX's draws computed with its key schedule (``tests/torch_jax_draws``)
  and fed to the port.

The circuit is an n = 8 Ry/Rz + CNOT brickwork, whose group plan has cross
steps (layout (2, 128)).
"""

from types import SimpleNamespace

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import viewmodels as jvm
from quantum_simulator_tpu.utils.appconfig import AppConfig as JAppConfig
from quantum_simulator_tpu_torch import viewmodels as tvm
from quantum_simulator_tpu_torch.utils.appconfig import AppConfig
from tests import torch_gui_stubs
from tests import torch_jax_draws as nd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
OPT_TOL = 1e-4
TVD_TOL = 0.03
N, DEPTH = 8, 8
SHOTS = 8192
ATTRIBUTION_TRIALS = 400


def brickwork_dict(n=N, depth=DEPTH, seed=42):
    rng = np.random.default_rng(seed)
    gates = []
    for col in range(depth):
        if col % 2 == 0:
            for q in range(n):
                gates.append({"name": "Rz" if (q + col) % 2 else "Ry",
                              "targets": [q],
                              "params": [float(rng.uniform(0, 2 * np.pi))],
                              "column": col})
        else:
            for q in range((col // 2) % 2, n - 1, 2):
                gates.append({"name": "CNOT", "targets": [q, q + 1],
                              "params": [], "column": col})
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def ghz_dict(n=3):
    gates = [{"name": "H", "targets": [0], "params": [], "column": 0}]
    gates += [{"name": "CNOT", "targets": [q, q + 1], "params": [],
               "column": q + 1} for q in range(n - 1)]
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def noise(pkg, p=0.05):
    nm = pkg.NoiseModel()
    nm.add_global_noise(pkg.DepolarizingNoise(p))
    nm.set_readout_error(pkg.ReadoutError(0.01, 0.02))
    return nm


def tvd(a: dict, b, shots: int) -> float:
    """TVD between counts ``a`` and counts or probabilities ``b``."""
    keys = set(a) | set(b)
    scale = shots if isinstance(next(iter(b.values())), (int, np.integer)) \
        else 1.0
    return 0.5 * sum(abs(a.get(k, 0) / shots - b.get(k, 0) / scale)
                     for k in keys)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.complex128),
                               np.asarray(b, dtype=np.complex128), atol=tol)


@pytest.fixture(scope="module")
def gui():
    mp = pytest.MonkeyPatch()
    if not torch_gui_stubs.install_qt(mp):
        mp.undo()
        pytest.skip("real PyQt6 present; stub-behavior tests not needed")
    from quantum_simulator_tpu.gui import main_window as jmw
    from quantum_simulator_tpu_torch.gui import main_window as tmw

    def windows():
        return (jmw.MainWindow(JAppConfig()),
                tmw.MainWindow(AppConfig(), device="cpu"))

    yield SimpleNamespace(windows=windows, jmw=jmw, tmw=tmw)
    mp.undo()
    torch_gui_stubs.purge("quantum_simulator_tpu.gui")


@pytest.fixture(scope="module")
def ran(gui):
    """One Run click (``SHOTS``) on the n = 8 brickwork in both
    windows."""
    jwin, twin = gui.windows()
    jwin.circuit_controller.circuit = jq.QuantumCircuit.from_dict(
        brickwork_dict())
    twin.circuit_controller.circuit = tq.QuantumCircuit.from_dict(
        brickwork_dict())
    for win in (jwin, twin):
        win._run_with_shots(SHOTS)
    return jwin, twin


@pytest.fixture()
def sync_threads(monkeypatch):
    """Worker threads run their target synchronously on start()."""
    import threading

    class _SyncThread:
        def __init__(self, target=None, daemon=None, args=(), kwargs=None):
            self._target = target

        def start(self):
            self._target()

        def join(self, timeout=None):
            pass

    monkeypatch.setattr(threading, "Thread", _SyncThread)


# ---------------------------------------------------------------------------
# The run pipeline and the panels' view data
# ---------------------------------------------------------------------------

def test_run_states_match(ran):
    jwin, twin = ran
    close(twin.last_result.final_state.data,
          jwin.last_result.final_state.data)
    close(twin.reference_manager.reference.state.data,
          jwin.reference_manager.reference.state.data)
    close(twin.reference_manager.reference.measurement_distribution,
          jwin.reference_manager.reference.measurement_distribution)
    assert sum(twin.last_result.measurement_counts.values()) == SHOTS
    assert twin.statusBar().messages[-1].startswith("Run complete")


def _state_pair(ran):
    jwin, twin = ran
    return jwin.statevector_panel._last_state, \
        twin.statevector_panel._last_state


def test_statevector_and_bloch_views_match(ran):
    js, ts = _state_pair(ran)
    jrows = jvm.StateVectorModel.rows(js, nonzero_only=True)
    trows = tvm.StateVectorModel.rows(ts, nonzero_only=True)
    assert [r.bitstring for r in trows] == [r.bitstring for r in jrows]
    close([r.real + 1j * r.imag for r in trows],
          [r.real + 1j * r.imag for r in jrows])
    jb = jvm.BlochModel.snapshot(ran[0].bloch_panel._last_state)
    tb = tvm.BlochModel.snapshot(ran[1].bloch_panel._last_state)
    close([(b.x, b.y, b.z, b.purity) for b in tb],
          [(b.x, b.y, b.z, b.purity) for b in jb])
    assert [b.label for b in tb] == [b.label for b in jb]


def test_density_matrix_view_matches(ran):
    js, ts = _state_pair(ran)
    jv = jvm.DensityMatrixModel.from_state(js)
    tv = tvm.DensityMatrixModel.from_state(ts)
    assert not tv.truncated and tv.real.shape == (1 << N, 1 << N)
    close(tv.real + 1j * tv.imag, jv.real + 1j * jv.imag)
    close(tv.magnitude, jv.magnitude)
    # a pure state: tr(rho^2) = 1 and S(rho) = 0
    assert tv.purity == pytest.approx(1.0, abs=TOL)
    assert tv.entropy == pytest.approx(jv.entropy, abs=TOL)


@pytest.mark.parametrize("metric", ["mutual_information", "concurrence"])
def test_entanglement_graph_matches(ran, metric):
    js, ts = _state_pair(ran)
    jg = jvm.EntanglementGraphModel.build(js, metric=metric)
    tg = tvm.EntanglementGraphModel.build(ts, metric=metric)
    close(tg.positions, jg.positions)
    assert [(i, j) for i, j, _ in tg.edges] == [(i, j) for i, j, _ in
                                                jg.edges]
    close([w for *_, w in tg.edges], [w for *_, w in jg.edges])
    assert tg.warning == jg.warning


def test_analysis_dashboard_matches(ran):
    jwin, twin = ran
    js, ts = _state_pair(ran)
    jd = jvm.AnalysisDashboardModel.build(js, jwin.reference_manager)
    td = tvm.AnalysisDashboardModel.build(ts, twin.reference_manager)
    assert td.fidelity_to_reference == pytest.approx(1.0, abs=TOL)
    for f in ("fidelity_to_reference", "purity", "entropy",
              "bipartite_entropy"):
        assert getattr(td, f) == pytest.approx(getattr(jd, f), abs=TOL), f
    assert td.nonzero_amplitudes == jd.nonzero_amplitudes
    assert td.is_separable == jd.is_separable
    assert td.per_qubit_pauli.keys() == jd.per_qubit_pauli.keys()
    for q, vals in td.per_qubit_pauli.items():
        close(list(vals.values()), list(jd.per_qubit_pauli[q].values()))
    assert td.pairwise_concurrence.keys() == jd.pairwise_concurrence.keys()
    close(list(td.pairwise_concurrence.values()),
          list(jd.pairwise_concurrence.values()))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_histogram_counts_match_in_law(gui, basis):
    jwin, twin = gui.windows()
    jwin.circuit_controller.circuit = jq.QuantumCircuit.from_dict(ghz_dict())
    twin.circuit_controller.circuit = tq.QuantumCircuit.from_dict(ghz_dict())
    jwin._run_with_shots(SHOTS, jq.MeasurementBasis(basis))
    twin._run_with_shots(SHOTS, tq.MeasurementBasis(basis))
    got = twin.histogram_panel._last_counts
    want = jwin.histogram_panel._last_counts
    assert sum(got.values()) == SHOTS
    assert tvd(got, want, SHOTS) <= TVD_TOL


def test_step_mode_entropies_match(gui):
    jwin, twin = gui.windows()
    n, depth = 5, 6
    d = brickwork_dict(n, depth)
    jwin.circuit_controller.circuit = jq.QuantumCircuit.from_dict(d)
    twin.circuit_controller.circuit = tq.QuantumCircuit.from_dict(d)
    for win in (jwin, twin):
        win._on_step_mode()
        for _ in range(depth + 2):
            win._advance_step()
        assert win.statusBar().messages[-1] == "Step mode complete"
    jm, tm = jwin.entropy_panel.model, twin.entropy_panel.model
    assert tm.steps == jm.steps == list(range(-1, depth))
    close(tm.total, jm.total)
    close(tm.per_qubit, jm.per_qubit)
    close(tm.bipartite, jm.bipartite)
    for q in range(n):
        close(twin.bloch_panel.model.trajectory(q),
              jwin.bloch_panel.model.trajectory(q))
    assert twin.editor_model.debug_column == jwin.editor_model.debug_column


# ---------------------------------------------------------------------------
# The advanced panels
# ---------------------------------------------------------------------------

def test_debugger_ideal_snapshots_match(ran):
    jwin, twin = ran
    circuit = brickwork_dict()
    jwin.debugger_panel.run_debug(jq.QuantumCircuit.from_dict(circuit),
                                  None, seed=42, block=True)
    twin.debugger_panel.run_debug(tq.QuantumCircuit.from_dict(circuit),
                                  None, seed=42, block=True)
    jsnaps = jwin.debugger_panel.debugger.snapshots
    tsnaps = twin.debugger_panel.debugger.snapshots
    assert len(tsnaps) == len(jsnaps) == DEPTH + 1
    for a, b in zip(tsnaps, jsnaps):
        assert a.column_index == b.column_index
        assert a.gate_labels == b.gate_labels
        close(a.state.data, b.state.data)
        assert a.fidelity == pytest.approx(b.fidelity, abs=TOL)
        assert a.entropy == pytest.approx(b.entropy, abs=TOL)
    assert twin.debugger_panel.status.text() == \
        jwin.debugger_panel.status.text()


def test_comparison_panel_fidelities_match(ran):
    jwin, twin = ran
    b = brickwork_dict(seed=7)
    jwin.comparison_panel.compare(
        jq.QuantumCircuit.from_dict(brickwork_dict()),
        jq.QuantumCircuit.from_dict(b), shots=1024, seed=3)
    twin.comparison_panel.compare(
        tq.QuantumCircuit.from_dict(brickwork_dict()),
        tq.QuantumCircuit.from_dict(b), shots=1024, seed=3)
    jr, tr = jwin.comparison_panel._last, twin.comparison_panel._last
    for f in ("output_fidelity", "purity_a", "purity_b", "entropy_a",
              "entropy_b"):
        assert getattr(tr, f) == pytest.approx(getattr(jr, f), abs=TOL), f
    assert vars(tr.metrics_a) == vars(jr.metrics_a)
    assert vars(tr.metrics_b) == vars(jr.metrics_b)
    assert [twin.comparison_panel.table.item(r, 0).text() for r in range(9)] \
        == [jwin.comparison_panel.table.item(r, 0).text() for r in range(9)]


def test_optimizer_parameter_shift_trajectory_matches(gui, sync_threads):
    jwin, twin = gui.windows()
    d = {"version": "1.0", "num_qubits": 4, "gates": [
        {"name": "Ry", "targets": [q], "params": [0.3 + 0.2 * q],
         "column": 0} for q in range(4)] + [
        {"name": "CNOT", "targets": [q, q + 1], "params": [], "column": 1 + q}
        for q in range(3)] + [
        {"name": "Ry", "targets": [q], "params": [1.1 - 0.3 * q],
         "column": 4} for q in range(4)]}
    for win, pkg in ((jwin, jq), (twin, tq)):
        win.circuit_controller.circuit = pkg.QuantumCircuit.from_dict(d)
        panel = win.optimizer_panel
        panel.iters_spin.setValue(6)
        panel.cost_combo.setCurrentText("zz_chain")
        panel.grad_combo.setCurrentText("parameter_shift")
        panel._on_run_clicked()
        assert not panel._busy
    jp, tp = jwin.optimizer_panel, twin.optimizer_panel
    assert len(tp._history) == len(jp._history) >= 1
    np.testing.assert_allclose(tp._history, jp._history, atol=OPT_TOL)
    np.testing.assert_allclose(tp._param_history, jp._param_history,
                               atol=OPT_TOL)


def _exact_noisy_distribution(d: dict, nm) -> dict:
    """Readout-corrupted bit-string probabilities of the port's exact
    density matrix."""
    c = tq.QuantumCircuit.from_dict(d)
    rho = tq.DensityMatrixSimulator(noise_model=nm, device="cpu").run(
        c, method="dense").rho
    p = np.clip(np.real(np.diag(rho)), 0, None)
    n = c.num_qubits
    conf = np.array([[1 - 0.01, 0.02], [0.01, 1 - 0.02]])  # P(read | true)
    p = p.reshape((2,) * n)
    for q in range(n):
        p = np.moveaxis(np.tensordot(conf, p, axes=([1], [q])), 0, q)
    p = p.reshape(-1)
    return {format(i, f"0{n}b"): float(v) for i, v in enumerate(p)}


def test_noisy_run_matches_in_law(gui):
    jwin, twin = gui.windows()
    d = ghz_dict()
    for win, pkg in ((jwin, jq), (twin, tq)):
        win.circuit_controller.circuit = pkg.QuantumCircuit.from_dict(d)
        win.noise_model = noise(pkg)
        win._refresh_noise_indicator()
        win._run_with_shots(SHOTS)
        assert sum(win.last_result.measurement_counts.values()) == SHOTS
    exact = _exact_noisy_distribution(d, noise(tq))
    assert tvd(twin.last_result.measurement_counts, exact, SHOTS) <= TVD_TOL
    assert tvd(jwin.last_result.measurement_counts, exact, SHOTS) <= TVD_TOL
    # the ideal reference is stored from the noiseless pass in both
    close(twin.reference_manager.reference.state.data,
          jwin.reference_manager.reference.state.data)


def test_noise_attribution_matches_in_law(gui):
    """Both packages' total fidelity loss (the telescoped attribution)
    within five standard errors of 1 - <psi|rho|psi> from the exact
    density matrix; a trial's fidelity lies in [0, 1], so its variance is
    at most mu (1 - mu)."""
    jwin, twin = gui.windows()
    d = brickwork_dict(n=4, depth=6)
    nm = {jq: noise(jq, 0.02), tq: noise(tq, 0.02)}
    losses = {}
    for win, pkg in ((jwin, jq), (twin, tq)):
        panel = win.debugger_panel
        panel.trials_spin.setValue(ATTRIBUTION_TRIALS)
        panel.run_debug(pkg.QuantumCircuit.from_dict(d), nm[pkg], seed=42,
                        block=True)
        losses[pkg] = panel._attribution.total_fidelity_loss
        assert len(panel._impacts) == 6
    c = tq.QuantumCircuit.from_dict(d)
    psi = tq.Simulator(device="cpu").run(c, shots=0).final_state.data
    rho = tq.DensityMatrixSimulator(noise_model=nm[tq], device="cpu").run(
        c, method="dense").rho
    mu = 1.0 - float(np.real(psi.conj() @ rho @ psi))
    se = np.sqrt(mu * (1 - mu) / ATTRIBUTION_TRIALS)
    assert 0 < mu < 1
    for pkg, loss in losses.items():
        assert abs(loss - mu) <= 5 * se, (pkg.__name__, loss, mu, se)


def test_qec_panel_cycle_and_sweep_match_draw_for_draw(gui, sync_threads,
                                                       monkeypatch):
    """The panel's cycle (seed 42) and 15-point sweep (100 trials, seed
    42) on the default code: the port fed JAX's draws gives JAX's
    syndromes, corrections and rates, and fidelities within 1e-5."""
    from quantum_simulator_tpu_torch import qec as tqec

    real_cycle = tqec.QECSimulator.run_cycle
    real_sweep = tqec.QECSimulator.threshold_sweep

    def cycle(self, logical, noise_type, p, seed=None, **kw):
        dq = self.code.data_qubits
        u = nd.uniform(nd.key_from_seed(
            np.random.default_rng(seed).integers(0, 2**63)), dq)
        return real_cycle(self, logical, noise_type, p,
                          uniforms=torch.from_numpy(np.array(u)))

    def sweep(self, probs, n_trials, noise_type="bit_flip", seed=None,
              **kw):
        rng = np.random.default_rng(seed)
        dq = self.code.data_qubits
        draws = [torch.from_numpy(np.array(nd.uniform(np.stack(
            [nd.key(s) for s in rng.integers(0, 2**63, n_trials)]), dq)))
            for _ in probs]
        return real_sweep(self, probs, n_trials, noise_type, uniforms=draws)

    monkeypatch.setattr(tqec.QECSimulator, "run_cycle", cycle)
    monkeypatch.setattr(tqec.QECSimulator, "threshold_sweep", sweep)
    jwin, twin = gui.windows()
    points = {}
    for win in (jwin, twin):
        panel = win.qec_panel
        panel.p_spin.setValue(0.1)
        panel.run_cycle()
        panel.sweep_done.connect(lambda pts, w=win: points.__setitem__(w,
                                                                       pts))
        panel.run_sweep()
        assert panel.figure.gca().get_xlabel() == "Physical error rate"
    assert twin.qec_panel.status.text() == jwin.qec_panel.status.text()
    assert len(points[twin]) == len(points[jwin]) == 15
    for a, b in zip(points[twin], points[jwin]):
        for f in ("physical_rate", "logical_rate", "success_rate",
                  "decoder_success_rate"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("avg_fidelity", "logical_z_fidelity"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), abs=TOL)
