"""The port's GUI widget glue under the functional Qt stubs, on the CPU.

Twin of ``tests/test_gui_widgets_behavior.py`` for
``quantum_simulator_tpu_torch.gui``, with the same behaviour asserted:
dialogs build the port's engine objects, the palette drag carries the
gate mime payload, the properties panel emits edits, the ``MainWindow``
run pipeline stores the reference and updates panels, and the advanced
panels' worker flows produce results (threads run synchronously via a
monkeypatched ``threading.Thread``). Every window and panel is built with
``device="cpu"``, where the kernels run their plain twins; without that
argument they take the card, and without a card they raise
(``TestNoHostFallback``).
"""

import math
import threading

import numpy as np
import pytest
import torch

from tests import qt_stub, torch_gui_stubs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture()
def qt(monkeypatch):
    if not torch_gui_stubs.install_qt(monkeypatch):
        pytest.skip("real PyQt6 present; stub-behavior tests not needed")
    yield qt_stub
    torch_gui_stubs.purge()


@pytest.fixture()
def sync_threads(monkeypatch):
    """Worker threads run their target synchronously on start()."""

    class _SyncThread:
        def __init__(self, target=None, daemon=None, args=(), kwargs=None):
            self._target = target
            self._args = args
            self._kwargs = kwargs or {}

        def start(self):
            self._target(*self._args, **self._kwargs)

        def join(self, timeout=None):
            pass

    monkeypatch.setattr(threading, "Thread", _SyncThread)


def _bell_circuit():
    from quantum_simulator_tpu_torch.circuit import (GateInstance,
                                                     QuantumCircuit)

    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], column=0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
    return c


# ---------------------------------------------------------------------------
# Dialogs
# ---------------------------------------------------------------------------

class TestDialogs:
    def test_noise_config_builds_exact_model(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import NoiseConfigDialog
        from quantum_simulator_tpu_torch.noise import (
            BitFlipNoise, DepolarizingNoise, ReadoutError,
            ThermalRelaxationNoise)

        d = NoiseConfigDialog()
        assert d.build_noise_model() is None  # nothing enabled
        # enable bit flip @ 0.03, depolarizing @ 0.12, thermal, readout
        d._rows[0][0].setChecked(True)
        d._rows[0][1].setValue(0.03)
        d._rows[2][0].setChecked(True)
        d._rows[2][1].setValue(0.12)
        d.thermal_check.setChecked(True)
        d.t1_spin.setValue(40.0)
        d.t2_spin.setValue(90.0)  # > 2*T1: must clamp to 80
        d.time_spin.setValue(2.0)
        d.readout_check.setChecked(True)
        d.p01_spin.setValue(0.02)
        d.p10_spin.setValue(0.04)
        model = d.build_noise_model()
        chans = model.global_channels
        assert [type(c) for c in chans] == [
            BitFlipNoise, DepolarizingNoise, ThermalRelaxationNoise]
        assert chans[0].probability == pytest.approx(0.03)
        assert chans[1].probability == pytest.approx(0.12)
        assert chans[2].t1 == pytest.approx(40.0)
        assert chans[2].t2 == pytest.approx(80.0)  # clamped to 2*T1
        assert chans[2].time == pytest.approx(2.0)
        ro = model.readout_error
        assert isinstance(ro, ReadoutError)
        assert (ro.p01, ro.p10) == (pytest.approx(0.02),
                                    pytest.approx(0.04))
        assert "Bit Flip p=0.03" in d.preview.text()

    def test_noise_config_roundtrips_existing_model(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import NoiseConfigDialog
        from quantum_simulator_tpu_torch.noise import (NoiseModel,
                                                       PhaseFlipNoise,
                                                       ReadoutError)

        nm = NoiseModel()
        nm.add_global_noise(PhaseFlipNoise(0.07))
        nm.set_readout_error(ReadoutError(0.01, 0.05))
        d = NoiseConfigDialog(nm)
        rebuilt = d.build_noise_model()
        assert [type(c) for c in rebuilt.global_channels] == [PhaseFlipNoise]
        assert rebuilt.global_channels[0].probability == pytest.approx(0.07)
        assert rebuilt.readout_error.p01 == pytest.approx(0.01)
        assert rebuilt.readout_error.p10 == pytest.approx(0.05)

    def test_custom_gate_rejects_non_unitary(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import CustomGateDialog
        from quantum_simulator_tpu_torch.registry import GateRegistry

        GateRegistry.reset()
        registry = GateRegistry.instance()
        try:
            d = CustomGateDialog()
            d.name_edit.setText("BadGate")
            d._cells[0][0].setText("1")
            d._cells[0][1].setText("1")  # [[1,1],[0,1]] is not unitary
            d._validate_and_accept()
            assert "not unitary" in d.status.text()
            assert "BadGate" not in registry.gate_names()
            # garbage entries surface as a parse error, not a crash
            d._cells[0][1].setText("zzz")
            d._validate_and_accept()
            assert "Parse error" in d.status.text()
        finally:
            registry.reset()

    def test_custom_gate_registers_unitary(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import CustomGateDialog
        from quantum_simulator_tpu_torch.registry import GateRegistry

        GateRegistry.reset()
        registry = GateRegistry.instance()
        try:
            d = CustomGateDialog()
            d.name_edit.setText("SqrtZ")
            # diag(1, i) — '1i' complex entry exercises the i->j mapping
            d._cells[0][0].setText("1")
            d._cells[0][1].setText("0")
            d._cells[1][0].setText("0")
            d._cells[1][1].setText("1i")
            d._validate_and_accept()
            assert d.status.text() == ""
            gd = registry.get("SqrtZ")
            assert gd.num_qubits == 1
            np.testing.assert_allclose(gd.matrix_func(),
                                       np.diag([1.0, 1.0j]), atol=1e-12)
        finally:
            registry.reset()

    def test_gate_param_dialog_pi_presets(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import GateParamDialog
        from quantum_simulator_tpu_torch.registry import GateRegistry

        gd = GateRegistry.instance().get("Rx")
        d = GateParamDialog(gd, [0.5])
        assert d.values() == [pytest.approx(0.5)]
        d._spins[0].setValue(math.pi / 2)
        assert d.values() == [pytest.approx(math.pi / 2)]

    def test_algorithm_dialog_builds_templates(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import AlgorithmDialog

        d = AlgorithmDialog()
        # default template previews without crashing; stats populated
        assert "qubits" in d.stats.text()
        by_name = {d.template_combo._items[i][1]: i
                   for i in range(d.template_combo.count())}
        d.qubits_spin.setValue(4)
        d.template_combo.setCurrentIndex(by_name["qft"])
        c = d.build_circuit()
        assert c.num_qubits == 4
        d.template_combo.setCurrentIndex(by_name["grover"])
        d.marked_spin.setValue(5)
        c = d.build_circuit()
        assert c.num_qubits == 4
        d.template_combo.setCurrentIndex(by_name["bernstein_vazirani"])
        d.secret_edit.setText("1011")
        c = d.build_circuit()
        assert c.num_qubits == 5  # len(secret) + ancilla

    def test_about_dialog(self, qt):
        from quantum_simulator_tpu_torch.gui.dialogs import AboutDialog

        assert AboutDialog().exec() == 1


# ---------------------------------------------------------------------------
# Docks: palette drag + properties edits
# ---------------------------------------------------------------------------

class _MouseEvent:
    def __init__(self, x, y, buttons=1):
        self._pos = qt_stub.QPoint(x, y)
        self._buttons = buttons

    def button(self):
        return 1  # LeftButton

    def buttons(self):
        return self._buttons

    def pos(self):
        return self._pos


class TestDocks:
    def test_palette_sections_and_click(self, qt):
        from quantum_simulator_tpu_torch.gui.docks import GatePalette

        pal = GatePalette()
        titles = [pal._toolbox.itemText(i)
                  for i in range(pal._toolbox.count())]
        assert titles[:4] == ["Single-Qubit", "Rotations", "Multi-Qubit",
                              "Measurement"]
        chosen = []
        pal.gate_chosen.connect(chosen.append)
        page = pal._toolbox.widget(0)     # Single-Qubit section
        flow = page.layout()
        btn = flow.itemAt(0).widget
        btn.click()
        assert chosen == [btn.gate_name]

    def test_palette_drag_mime_payload(self, qt):
        from quantum_simulator_tpu_torch.gui.docks import GateButton
        from quantum_simulator_tpu_torch.gui.editor_model import GATE_MIME_TYPE

        btn = GateButton("CNOT", "●⊕", "#3388ff", "CNOT gate")
        btn.mousePressEvent(_MouseEvent(5, 5))
        btn.mouseMoveEvent(_MouseEvent(30, 30))  # > 8px: starts the drag
        assert len(qt.QDrag.executed) == 1
        src, mime = qt.QDrag.executed[0]
        assert src is btn
        assert mime.hasFormat(GATE_MIME_TYPE)
        assert mime.data(GATE_MIME_TYPE) == b"CNOT"
        assert mime.text() == "CNOT"

    def test_palette_no_drag_below_threshold(self, qt):
        from quantum_simulator_tpu_torch.gui.docks import GateButton

        btn = GateButton("H", "H", "#3388ff", "Hadamard")
        btn.mousePressEvent(_MouseEvent(5, 5))
        btn.mouseMoveEvent(_MouseEvent(7, 6))  # 3px < 8px threshold
        assert qt.QDrag.executed == []

    def test_palette_refresh_picks_up_custom_gates(self, qt):
        from quantum_simulator_tpu_torch.gates import (GateDefinition,
                                                       GateType, _const)
        from quantum_simulator_tpu_torch.gui.docks import GatePalette
        from quantum_simulator_tpu_torch.registry import GateRegistry

        GateRegistry.reset()
        registry = GateRegistry.instance()
        try:
            pal = GatePalette()
            base_sections = pal._toolbox.count()
            registry.register(GateDefinition(
                name="MyU", display_name="MyU",
                gate_type=GateType.SINGLE, num_qubits=1, num_params=0,
                param_names=(), matrix_func=_const(np.eye(2)),
                symbol="MU", color="#607D8B", num_targets=1))
            pal.refresh()
            # the custom gate lands in the Single-Qubit section
            names = []
            for i in range(pal._toolbox.count()):
                flow = pal._toolbox.widget(i).layout()
                names += [flow.itemAt(j).widget.gate_name
                          for j in range(flow.count())]
            assert "MyU" in names
            assert pal._toolbox.count() >= base_sections
        finally:
            registry.reset()

    def test_properties_panel_emits_edits(self, qt):
        from quantum_simulator_tpu_torch.circuit import GateInstance
        from quantum_simulator_tpu_torch.gui.docks import PropertiesPanel

        panel = PropertiesPanel()
        gate = GateInstance("Rx", [1], [0.3], column=2)
        panel.set_gate(gate, num_qubits=3)
        assert "column 2" in panel.title.text()
        got = {}
        panel.params_changed.connect(
            lambda g, p: got.__setitem__("params", (g, p)))
        panel.targets_changed.connect(
            lambda g, t: got.__setitem__("targets", (g, t)))
        panel._param_spins[0].setValue(math.pi)
        panel._target_spins[0].setValue(0)
        panel._apply()
        assert got["params"] == (gate, [pytest.approx(math.pi)])
        assert got["targets"] == (gate, [0])
        # no-change apply emits nothing
        got.clear()
        gate2 = GateInstance("Rx", [1], [0.3], column=2)
        panel.set_gate(gate2, num_qubits=3)
        panel._apply()
        assert got == {}

    def test_properties_pi_ratio_label(self, qt):
        from quantum_simulator_tpu_torch.gui.docks import PropertiesPanel

        assert PropertiesPanel._pi_ratio_text(0.0) == "= 0"
        assert PropertiesPanel._pi_ratio_text(math.pi / 2) == "= 0.5 π"

    def test_flow_layout_wraps(self, qt):
        from quantum_simulator_tpu_torch.gui.docks import FlowLayout

        flow = FlowLayout()
        widgets = []
        for _ in range(4):
            w = qt.QWidget()
            w.setFixedSize(46, 34)
            flow.addWidget(w)
            widgets.append(w)
        # 110px wide: two 46px buttons + spacing fit per row -> 2 rows
        height = flow.heightForWidth(110)
        assert height > 34  # wrapped onto a second row
        flow.setGeometry(qt.QRect(0, 0, 110, 200))
        ys = {w.geometry.y() for w in widgets}
        assert len(ys) == 2  # two distinct rows


# ---------------------------------------------------------------------------
# MainWindow run pipeline
# ---------------------------------------------------------------------------

@pytest.fixture()
def main_window(qt, tmp_path, monkeypatch):
    from quantum_simulator_tpu_torch.utils.appconfig import AppConfig

    monkeypatch.setattr(AppConfig, "config_path",
                        classmethod(lambda cls: tmp_path / "config.json"))
    from quantum_simulator_tpu_torch.gui.main_window import MainWindow

    return MainWindow(AppConfig(), device="cpu")


class TestMainWindow:
    def test_run_pipeline_stores_reference_and_updates_panels(
            self, main_window):
        win = main_window
        win.circuit_controller.circuit = _bell_circuit()
        win._on_run_simulation()
        # reference stored for the current circuit hash
        assert win.reference_manager.reference is not None
        assert not win.reference_manager.check_invalidation(
            win.circuit_controller.circuit.circuit_hash())
        # result retained + panels fed (histogram got the counts)
        assert win.last_result is not None
        counts = win.last_result.measurement_counts
        assert set(counts) <= {"00", "11"}
        assert win.histogram_panel._last_counts == counts
        # statevector panel saw the 2-qubit state
        assert win.statevector_panel._last_state is not None
        assert win.statusBar().messages[-1].startswith("Run complete")
        # resource panel recorded the timing
        assert win.resource_panel.model.timings[-1].num_qubits == 2

    def test_run_pipeline_with_noise_keeps_ideal_reference(
            self, main_window):
        from quantum_simulator_tpu_torch.noise import (DepolarizingNoise,
                                                       NoiseModel)

        win = main_window
        win.circuit_controller.circuit = _bell_circuit()
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        win.noise_model = nm
        win._refresh_noise_indicator()
        assert "Depolarizing" in win.noise_indicator.text()
        win._run_with_shots(200)
        ref = win.reference_manager.reference
        assert ref is not None
        # the ideal reference is normalized (from the noiseless pass)
        probs = np.asarray(ref.measurement_distribution)
        assert probs.sum() == pytest.approx(1.0, abs=1e-5)
        assert sum(win.last_result.measurement_counts.values()) == 200

    def test_circuit_edit_invalidates_reference(self, main_window):
        win = main_window
        win.circuit_controller.circuit = _bell_circuit()
        win._on_run_simulation()
        win.circuit_controller.add_gate("X", [0], column=5)
        assert any("invalidated" in m for m in win.statusBar().messages)

    def test_simulation_error_shows_message_box(self, main_window, qt):
        win = main_window

        class _Boom:
            def circuit_hash(self):
                raise RuntimeError("boom")

            num_qubits = 2

        win.circuit_controller._circuit = _Boom()
        win._on_run_simulation()
        assert qt.QMessageBox.shown
        assert qt.QMessageBox.shown[-1][0] == "critical"

    def test_configure_noise_applies_dialog_model(self, main_window,
                                                  monkeypatch, qt):
        from quantum_simulator_tpu_torch.gui import main_window as mw
        from quantum_simulator_tpu_torch.noise import BitFlipNoise

        win = main_window

        class _FakeDialog:
            def __init__(self, current, parent):
                pass

            def exec(self):
                return 1

            def build_noise_model(self):
                from quantum_simulator_tpu_torch.noise import NoiseModel

                nm = NoiseModel()
                nm.add_global_noise(BitFlipNoise(0.02))
                return nm

        monkeypatch.setattr(mw, "NoiseConfigDialog", _FakeDialog)
        win._configure_noise()
        assert [type(c) for c in win.noise_model.global_channels] == [
            BitFlipNoise]
        assert "BitFlip" in win.noise_indicator.text()

    def test_save_and_open_circuit_roundtrip(self, main_window, qt,
                                             tmp_path):
        win = main_window
        win.circuit_controller.circuit = _bell_circuit()
        path = str(tmp_path / "c.qsim")
        qt.QFileDialog.next_path = path
        win._save_circuit()
        win.circuit_controller.circuit = _bell_circuit().__class__(3)
        qt.QFileDialog.next_path = path
        win._open_circuit()
        assert win.circuit_controller.circuit.num_qubits == 2
        assert win.circuit_controller.circuit.gate_count() == 2
        assert path in win.config.recent_files

    def test_step_mode_feeds_entropy_and_debug_column(self, main_window):
        win = main_window
        win.circuit_controller.circuit = _bell_circuit()
        win._on_step_mode()
        timer = win._step_timer
        for _ in range(10):  # steps + StopIteration
            timer.fire()
        assert not timer.isActive()
        assert win.statusBar().messages[-1] == "Step mode complete"
        assert len(win.entropy_panel.model.steps) >= 2

    def test_toolbar_qubit_spin_resizes_circuit(self, main_window):
        win = main_window
        win.qubit_spin.setValue(5)
        assert win.circuit_controller.circuit.num_qubits == 5


# ---------------------------------------------------------------------------
# Advanced panels: worker flows (threads run synchronously)
# ---------------------------------------------------------------------------

class TestAdvancedPanels:
    def test_debugger_panel_worker_flow(self, qt, sync_threads):
        from quantum_simulator_tpu_torch.gui.advanced_panels import (
            DebuggerPanel)
        from quantum_simulator_tpu_torch.noise import (DepolarizingNoise,
                                                       NoiseModel)

        panel = DebuggerPanel(device="cpu")
        panel.trials_spin.setValue(10)
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.05))
        panel.run_debug(_bell_circuit(), nm, seed=7)  # sync via stub Thread
        assert panel.debugger.num_steps >= 2
        assert panel._attribution is not None
        assert len(panel._impacts) > 0
        assert "fidelity" in panel.status.text().lower() \
            or panel.status.text() != ""
        # timeline stepping drives the slider
        panel._step(1)
        assert panel.slider.value() == panel.debugger.position

    def test_comparison_panel_table_and_export(self, qt, tmp_path):
        import json

        from quantum_simulator_tpu_torch.gui.advanced_panels import (
            ComparisonPanel)

        panel = ComparisonPanel(device="cpu")
        a = _bell_circuit()
        b = _bell_circuit()
        b.add("X", [0], column=5)
        panel.compare(a, b, shots=128, seed=3)
        assert panel.table.rowCount() == 9
        assert panel.table.item(0, 0).text() == "Output fidelity"
        fid = float(panel.table.item(0, 1).text())
        assert 0.0 <= fid <= 1.0
        path = str(tmp_path / "cmp.json")
        qt.QFileDialog.next_path = path
        panel._export()
        report = json.loads(open(path).read())
        assert report["output_fidelity"] == pytest.approx(fid, abs=1e-5)

    def test_optimizer_panel_worker_flow(self, qt, sync_threads):
        from quantum_simulator_tpu_torch.circuit import GateInstance
        from quantum_simulator_tpu_torch.gui.advanced_panels import (
            OptimizerPanel)

        c = _bell_circuit()
        c.add_gate(GateInstance("Ry", [0], [0.4], column=2))
        panel = OptimizerPanel(circuit_supplier=lambda: c, device="cpu")
        panel.iters_spin.setValue(5)
        panel._on_run_clicked()  # sync: finishes inline
        assert not panel._busy
        assert panel.run_btn.text() == "Optimize"
        assert len(panel._history) >= 1
        assert len(panel._param_history) >= 1
        title = panel.figure.gca().get_title()
        assert "optimal cost" in title

    def test_optimizer_panel_no_params_message(self, qt, sync_threads):
        from quantum_simulator_tpu_torch.gui.advanced_panels import (
            OptimizerPanel)

        panel = OptimizerPanel(circuit_supplier=_bell_circuit,
                               device="cpu")
        panel._on_run_clicked()
        assert panel.figure.gca().get_title() == \
            "No parameterized gates in circuit"

    def test_qec_panel_cycle_and_sweep(self, qt, sync_threads):
        from quantum_simulator_tpu_torch.gui.advanced_panels import QECPanel

        panel = QECPanel(device="cpu")
        panel.p_spin.setValue(0.05)
        panel.run_cycle()
        assert "F=" in panel.status.text()
        panel.run_sweep()  # sync worker -> sweep_done -> plot
        ax = panel.figure.gca()
        assert ax.get_xlabel() == "Physical error rate"

    def test_qec_panel_memory_requires_distance_code(self, qt,
                                                     sync_threads):
        from quantum_simulator_tpu_torch.gui.advanced_panels import QECPanel

        panel = QECPanel(device="cpu")
        panel.run_memory()  # default 3-qubit code: refused with a hint
        assert "repetition or surface" in panel.status.text()
        panel.code_combo.setCurrentText(panel.REPETITION_CODES[0])
        panel.d_spin.setValue(3)
        panel.p_spin.setValue(0.05)
        panel.run_memory()
        assert "space-time ML" in panel.status.text()


# ---------------------------------------------------------------------------
# The device: every engine on the window's device, no host fallback
# ---------------------------------------------------------------------------

PANELS_WITH_ENGINES = [
    ("panels", "DensityMatrixPanel"), ("panels", "FidelityPanel"),
    ("panels", "ResourceMonitorPanel"), ("advanced_panels", "DebuggerPanel"),
    ("advanced_panels", "ComparisonPanel"),
    ("advanced_panels", "OptimizerPanel"), ("advanced_panels", "QECPanel"),
]


class TestDevice:
    def test_window_passes_its_device_to_every_engine(self, main_window):
        win = main_window
        cpu = torch.device("cpu")
        assert win.device == cpu and win.sim_controller.device == cpu
        assert win.density_panel.model._device == cpu
        for panel in (win.fidelity_panel, win.debugger_panel,
                      win.comparison_panel, win.optimizer_panel,
                      win.qec_panel):
            assert panel._device == cpu
        assert win.debugger_panel.debugger._device == cpu
        assert "80 GB (one H100)" in win.resource_panel.info._html

    def test_bridge_toggle_serves_the_window_circuit(self, main_window,
                                                     monkeypatch):
        import functools

        from quantum_simulator_tpu_torch.bridge import SimulatorClient
        from quantum_simulator_tpu_torch.gui import main_window as mw

        win = main_window
        monkeypatch.setattr(mw, "BridgeServer",
                            functools.partial(mw.BridgeServer, port=0))
        win.circuit_controller.circuit = _bell_circuit()
        win._toggle_bridge()
        try:
            assert win.bridge_server.handler._device == torch.device("cpu")
            assert win.bridge_action.text() == "Stop bridge server"
            with SimulatorClient(port=win.bridge_server.port,
                                 timeout=60) as c:
                reply = c.run(shots=64, seed=5)
        finally:
            win._toggle_bridge()
        assert not win.bridge_server.is_running
        assert sum(reply["measurement_counts"].values()) == 64
        assert set(reply["measurement_counts"]) <= {"00", "11"}
        assert win.statusBar().messages[-1] == "Bridge stopped"

    def test_worker_thread_runs_in_the_panel_device_scope(self, qt,
                                                          monkeypatch):
        """A real worker thread enters ``device_scope`` with the device
        the panel pinned, and its result arrives."""
        from quantum_simulator_tpu_torch.circuit import GateInstance
        from quantum_simulator_tpu_torch.gui import advanced_panels as ap

        entered = []
        real_scope = ap.device_scope

        def recording(device):
            entered.append((threading.current_thread(), device))
            return real_scope(device)

        monkeypatch.setattr(ap, "device_scope", recording)
        started = []

        class _Recorded(threading.Thread):
            def start(self):
                started.append(self)
                super().start()

        monkeypatch.setattr(threading, "Thread", _Recorded)
        c = _bell_circuit()
        c.add_gate(GateInstance("Ry", [0], [0.4], column=2))
        panel = ap.OptimizerPanel(circuit_supplier=lambda: c, device="cpu")
        panel.iters_spin.setValue(3)
        panel._on_run_clicked()
        assert len(started) == 1
        started[0].join(60)
        assert not started[0].is_alive()
        assert not panel._busy and len(panel._history) >= 1
        assert [(t, d) for t, d in entered] == [(started[0],
                                                 torch.device("cpu"))]

    @pytest.mark.parametrize("module,name", PANELS_WITH_ENGINES)
    def test_panel_without_device_takes_the_card(self, qt, module, name):
        """No host fallback: the default device is the card, and a machine
        without one refuses to build the panel."""
        import importlib

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        cls = getattr(importlib.import_module(
            f"quantum_simulator_tpu_torch.gui.{module}"), name)
        with pytest.raises((AssertionError, RuntimeError)):
            cls()

    def test_window_without_device_takes_the_card(self, qt, tmp_path):
        from quantum_simulator_tpu_torch.gui.main_window import MainWindow
        from quantum_simulator_tpu_torch.utils.appconfig import AppConfig

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        with pytest.raises((AssertionError, RuntimeError)):
            MainWindow(AppConfig())
