"""The port's panel view data, themes, import gating and ``main`` twin,
on the CPU.

Twin of ``tests/test_panel_depth.py`` (debugger State Inspector rows, the
per-qubit noise heatmap and attribution overlay, the Bloch faded
trajectory; the port's engines on ``device="cpu"``), of the two GUI tests
of ``tests/test_render_gui.py`` (gating, stylesheets; its two renderer
tests have their twins in ``tests/test_torch_controller_viewmodels.py``)
and of ``tests/test_gui_imports.py``. Besides: the themes the port ships
equal the JAX package's and regenerate from the palette, the click-to-place
``CircuitView``, the resource panel's heading, the import isolation of the
port's GUI (a subprocess) and ``python -m quantum_simulator_tpu_torch.main``
without Qt and without a card.
"""

import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from quantum_simulator_tpu_torch.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu_torch.debugger import CircuitDebugger
from quantum_simulator_tpu_torch.noise import DepolarizingNoise, NoiseModel
from quantum_simulator_tpu_torch.simulator import Simulator
from quantum_simulator_tpu_torch.viewmodels import (
    BlochModel,
    DebuggerInspectorModel,
)
from tests import qt_stub, torch_gui_stubs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
JAX_THEMES = ROOT / "quantum_simulator_tpu" / "gui" / "themes"
PORT_THEMES = ROOT / "quantum_simulator_tpu_torch" / "gui" / "themes"


@pytest.fixture()
def qt(monkeypatch):
    if not torch_gui_stubs.install_qt(monkeypatch):
        pytest.skip("real PyQt6 present; stub-behavior tests not needed")
    yield qt_stub
    torch_gui_stubs.purge()


def _has_real_qt() -> bool:
    try:
        import PyQt6  # noqa: F401

        return True
    except ImportError:
        return False


def bell():
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], column=0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
    return c


# ---------------------------------------------------------------------------
# Panel depth (tests/test_panel_depth.py)
# ---------------------------------------------------------------------------

class TestInspectorRows:
    def test_bell_rows(self):
        dbg = CircuitDebugger(device="cpu")
        dbg.run_full_debug(bell(), noise_model=None, seed=1)
        dbg.goto_step(dbg.num_steps - 1)
        rows = DebuggerInspectorModel.amplitude_rows(dbg.current_snapshot)
        strings = {r.bitstring: r for r in rows}
        assert set(strings) == {"00", "11"}
        for r in rows:
            assert r.probability == pytest.approx(0.5, abs=1e-5)
            # noiseless run: no separate ideal column
            assert r.ideal_probability is None and r.delta is None

    def test_noisy_rows_have_ideal_column(self):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.2))
        dbg = CircuitDebugger(device="cpu")
        dbg.run_full_debug(bell(), noise_model=nm, seed=5)
        dbg.goto_step(dbg.num_steps - 1)
        rows = DebuggerInspectorModel.amplitude_rows(dbg.current_snapshot)
        assert rows
        assert all(r.ideal_probability is not None for r in rows)
        assert all(r.delta == pytest.approx(
            r.probability - r.ideal_probability, abs=1e-9) for r in rows)

    def test_rows_sorted_by_probability_and_limited(self):
        c = QuantumCircuit(3)
        for q in range(3):
            c.add_gate(GateInstance("H", [q], [], column=0))
        dbg = CircuitDebugger(device="cpu")
        dbg.run_full_debug(c, None, seed=0)
        dbg.goto_step(dbg.num_steps - 1)
        rows = DebuggerInspectorModel.amplitude_rows(
            dbg.current_snapshot, limit=4)
        assert len(rows) == 4
        probs = [r.probability for r in rows]
        assert probs == sorted(probs, reverse=True)

    def test_none_snapshot(self):
        assert DebuggerInspectorModel.amplitude_rows(None) == []


class TestNoiseHeatmap:
    def test_heatmap_shape_and_range(self):
        # product circuit: 1q marginals are sensitive to Pauli noise
        # (Bell would hide it: its reduced rho is I/2 either way)
        c = QuantumCircuit(2)
        c.add_gate(GateInstance("X", [0], [], column=0))
        c.add_gate(GateInstance("X", [1], [], column=1))
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.2))
        dbg = CircuitDebugger(device="cpu")
        impacts = dbg.compute_noise_impact(c, nm, n_trials=100, seed=0)
        mat = DebuggerInspectorModel.noise_heatmap(impacts)
        assert mat.shape == (2, 2)  # (qubits, columns)
        assert (mat >= -1e-6).all() and (mat <= 1.0 + 1e-6).all()
        assert mat.max() > 1e-3  # noise must register somewhere

    def test_empty_impacts(self):
        assert DebuggerInspectorModel.noise_heatmap([]).size == 0

    def test_attribution_overlay_labels(self):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(0.1))
        dbg = CircuitDebugger(device="cpu")
        attribution = dbg.compute_noise_attribution(
            bell(), nm, n_trials=20, seed=3)
        labels = DebuggerInspectorModel.heatmap_column_overlay(attribution)
        assert len(labels) == len(attribution.column_attribution_pct)
        for lab in labels:
            assert lab == "—" or lab.endswith("%")
        assert DebuggerInspectorModel.heatmap_column_overlay(None) == []


class TestFadedTrajectory:
    def test_alpha_ramp(self):
        model = BlochModel()
        sim = Simulator(device="cpu")
        for col in range(3):
            c = QuantumCircuit(1)
            if col:
                c.add_gate(GateInstance("Rx", [0], [0.5 * col], column=0))
            model.record_step(sim.run(c, shots=0).final_state)
        trail = model.faded_trajectory(0)
        assert len(trail) == 3
        alphas = [a for *_xyz, a in trail]
        assert alphas[0] == pytest.approx(0.15)
        assert alphas[-1] == pytest.approx(1.0)
        assert alphas == sorted(alphas)

    def test_empty_and_single(self):
        model = BlochModel()
        assert model.faded_trajectory(0) == []
        c = QuantumCircuit(1)
        model.record_step(Simulator(device="cpu").run(c,
                                                      shots=0).final_state)
        (trail,) = model.faded_trajectory(0)
        assert trail[3] == 1.0


# ---------------------------------------------------------------------------
# Gating, themes, widgets over the renderer (tests/test_render_gui.py)
# ---------------------------------------------------------------------------

def test_gui_gating(capsys):
    from quantum_simulator_tpu_torch.gui import HAS_QT

    assert isinstance(HAS_QT, bool)
    # Without PyQt6, main() must degrade cleanly to the port's headless
    # alternatives.
    if not HAS_QT:
        from quantum_simulator_tpu_torch import main as app_main

        assert app_main.main([]) == 1
        out = capsys.readouterr().out
        assert "python -m quantum_simulator_tpu_torch.scripts.noise_sweep" \
            in out
        assert "quantum_simulator_tpu_torch.bridge" in out


def test_theme_manager_stylesheets():
    from quantum_simulator_tpu_torch.gui.themes.theme_manager import (
        ThemeManager)

    tm = ThemeManager("dark")
    assert "QWidget" in tm.stylesheet()
    assert "QWidget" in tm.stylesheet("light")
    assert tm.stylesheet() != tm.stylesheet("light")


@pytest.mark.parametrize("theme", ["dark", "light"])
def test_themes_match_the_jax_package_and_the_palette(theme, tmp_path):
    from quantum_simulator_tpu_torch.gui.themes import palette
    from quantum_simulator_tpu_torch.gui.themes.theme_manager import (
        ThemeManager)

    shipped = (PORT_THEMES / f"{theme}.qss").read_text(encoding="utf-8")
    assert shipped == (JAX_THEMES / f"{theme}.qss").read_text(
        encoding="utf-8")
    assert ThemeManager(theme).stylesheet() == shipped
    palette.write_themes(tmp_path)
    assert (tmp_path / f"{theme}.qss").read_text(encoding="utf-8") == shipped


def test_circuit_view_click_to_place(qt, monkeypatch):
    from types import SimpleNamespace

    from quantum_simulator_tpu_torch.controller import CircuitController
    from quantum_simulator_tpu_torch.gui.circuit_view import CircuitView
    from quantum_simulator_tpu_torch.render import COL_W, ROW_H

    # the stand-in spin box lacks blockSignals, which the view calls
    def block_signals(self, block):
        if block:
            self._held, self.valueChanged._subs = self.valueChanged._subs, []
        else:
            self.valueChanged._subs = self._held
        return not block

    monkeypatch.setattr(qt.QSpinBox, "blockSignals", block_signals,
                        raising=False)
    ctl = CircuitController(QuantumCircuit(3))
    view = CircuitView(ctl)
    placed = []
    view.gate_selected.connect(placed.append)
    names = [data for _, data in view.gate_combo._items]
    view.gate_combo.setCurrentIndex(names.index("CNOT"))

    def click(column, qubit, button=1):
        view._on_click(SimpleNamespace(
            inaxes=True, xdata=(column + 0.5) * COL_W, ydata=-qubit * ROW_H,
            button=button))

    click(2, 0)
    assert "select 1 more" in view.hint_label.text()
    click(2, 2)
    (gate,) = ctl.circuit.gates
    assert (gate.gate_name, gate.target_qubits, gate.column) == (
        "CNOT", [0, 2], 2)
    assert placed == [gate]
    click(2, 2, button=3)          # right click removes it
    assert ctl.circuit.gates == []
    assert view.figure.axes        # redrawn through the renderer


def test_resource_panel_heading_names_the_memory(qt):
    from quantum_simulator_tpu_torch.gui.panels import ResourceMonitorPanel
    from quantum_simulator_tpu_torch.viewmodels import ResourceMonitorModel

    panel = ResourceMonitorPanel(device="cpu")
    html = panel.info._html
    assert "Max qubits in 80 GB (one H100)" in html
    assert "TPU" not in html
    sv = ResourceMonitorModel.comparison_table()[0]
    assert f"{sv['simulator']}: {sv['max_qubits']} qubits" in html


# ---------------------------------------------------------------------------
# Imports (tests/test_gui_imports.py) and their isolation
# ---------------------------------------------------------------------------

def _make_mock(name):
    class _MockMeta(type):
        def __getattr__(cls, attr):
            return _make_mock(attr)

    return _MockMeta(name, (), {
        "__init__": lambda self, *a, **k: None,
        "__call__": lambda self, *a, **k: None,
        "__getattr__": lambda self, attr: _make_mock(attr)(),
    })


@pytest.fixture()
def mocked_qt(monkeypatch):
    try:
        import PyQt6  # noqa: F401

        yield  # real Qt present: nothing to mock
        return
    except ImportError:
        pass

    torch_gui_stubs.purge()
    for mod in ["PyQt6", "PyQt6.QtCore", "PyQt6.QtGui", "PyQt6.QtWidgets"]:
        m = types.ModuleType(mod)
        m.__getattr__ = lambda name: _make_mock(name)
        monkeypatch.setitem(sys.modules, mod, m)

    def pyqt_signal(*a, **k):
        class _Sig:
            def connect(self, *a, **k):
                pass

            def emit(self, *a, **k):
                pass

            def __get__(self, obj, owner):
                return self

        return _Sig()

    sys.modules["PyQt6.QtCore"].pyqtSignal = pyqt_signal

    mb = types.ModuleType("matplotlib.backends.backend_qtagg")
    mb.FigureCanvasQTAgg = _make_mock("FigureCanvasQTAgg")
    monkeypatch.setitem(sys.modules,
                        "matplotlib.backends.backend_qtagg", mb)
    yield
    # Purge gui modules imported under mocks so other tests see clean state.
    torch_gui_stubs.purge()


GUI_MODULES = [
    "quantum_simulator_tpu_torch.gui.circuit_view",
    "quantum_simulator_tpu_torch.gui.editor_scene",
    "quantum_simulator_tpu_torch.gui.panels",
    "quantum_simulator_tpu_torch.gui.advanced_panels",
    "quantum_simulator_tpu_torch.gui.dialogs",
    "quantum_simulator_tpu_torch.gui.docks",
    "quantum_simulator_tpu_torch.gui.main_window",
]


def test_gui_modules_import(mocked_qt):
    for name in GUI_MODULES:
        importlib.import_module(name)


ISOLATION = """
import sys
import pytest
from tests import torch_gui_stubs
mp = pytest.MonkeyPatch()
assert torch_gui_stubs.install_qt(mp)
assert torch_gui_stubs.install_matplotlib(mp, force=True)
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "quantum_simulator_tpu"))
print("LOADED", bad)
"""


@pytest.mark.parametrize("matplotlib", ["stand-in", "real"])
def test_port_gui_imports_neither_jax_nor_the_jax_package(matplotlib):
    """Every module of the port's GUI and its ``main``, imported in a
    fresh interpreter under the Qt stand-ins (and the matplotlib one, or
    the real matplotlib), loads neither JAX nor the JAX package."""
    if _has_real_qt():
        pytest.skip("real PyQt6 present: the stand-ins are not installed")
    script = ISOLATION if matplotlib == "stand-in" else ISOLATION.replace(
        "assert torch_gui_stubs.install_matplotlib(mp, force=True)\n", "")
    names = GUI_MODULES + [
        "quantum_simulator_tpu_torch.gui",
        "quantum_simulator_tpu_torch.gui.editor_model",
        "quantum_simulator_tpu_torch.gui.themes.palette",
        "quantum_simulator_tpu_torch.gui.themes.theme_manager",
        "quantum_simulator_tpu_torch.main",
    ]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script, *names], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# python -m quantum_simulator_tpu_torch.main
# ---------------------------------------------------------------------------

def test_main_without_qt_prints_the_port_alternatives():
    """In a fresh interpreter (no stand-ins), the module entry point
    prints the port's headless alternatives and exits 1."""
    if _has_real_qt():
        pytest.skip("real PyQt6 present")
    out = subprocess.run([sys.executable, "-m",
                          "quantum_simulator_tpu_torch.main"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "PyQt6 is not installed" in out.stdout
    assert "quantum_simulator_tpu_torch.scripts.vqe_benchmark" in out.stdout
    assert "python scripts/" not in out.stdout


def test_main_without_a_card_exits_before_building(qt, capsys):
    """With Qt (here: the stand-ins) but no card, ``--device cuda`` (and
    the default device) exit 1 with a message before any window is
    built."""
    from quantum_simulator_tpu_torch import main as app_main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["--device", "cuda"], []):
        assert app_main.main(argv) == 1
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--device cpu" in err
        assert "quantum_simulator_tpu_torch.gui.main_window" \
            not in sys.modules
