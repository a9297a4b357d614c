"""Dialogs: gate params, noise config, algorithm templates, custom gates.

Counterpart of ``quantum_simulator_tpu/gui/dialogs.py``: a gate-param
dialog with pi presets, the 4-channel noise config + thermal relaxation
+ readout error (it builds the port's ``NoiseModel``), a template picker
with per-template params and a live preview (the port's
``AlgorithmTemplate`` circuits drawn by ``render.CircuitRenderer``),
unitarity-validated custom gates (the port's ``GateDefinition``
registered in its ``GateRegistry``), and about. They run no simulation.
"""

from __future__ import annotations

import math

import numpy as np
from PyQt6.QtWidgets import (
    QCheckBox,
    QComboBox,
    QDialog,
    QDialogButtonBox,
    QDoubleSpinBox,
    QFormLayout,
    QGridLayout,
    QLabel,
    QLineEdit,
    QPushButton,
    QSpinBox,
    QVBoxLayout,
)

from ..algorithms import AlgorithmTemplate
from ..gates import GateDefinition, GateType, _const
from ..noise import (
    AmplitudeDampingNoise,
    ThermalRelaxationNoise,
    BitFlipNoise,
    DepolarizingNoise,
    NoiseModel,
    PhaseFlipNoise,
    ReadoutError,
)
from ..registry import GateRegistry

_PI_PRESETS = [("π", math.pi), ("π/2", math.pi / 2), ("π/4", math.pi / 4),
               ("-π/2", -math.pi / 2), ("2π", 2 * math.pi)]


class GateParamDialog(QDialog):
    """Edit a parameterized gate's angles with quick-pi buttons."""

    def __init__(self, gate_def, params: list[float], parent=None):
        super().__init__(parent)
        self.setWindowTitle(f"{gate_def.display_name} parameters")
        layout = QVBoxLayout(self)
        form = QFormLayout()
        self._spins: list[QDoubleSpinBox] = []
        for i, name in enumerate(gate_def.param_names):
            spin = QDoubleSpinBox()
            spin.setRange(-4 * math.pi, 4 * math.pi)
            spin.setDecimals(6)
            spin.setValue(params[i] if i < len(params) else 0.0)
            self._spins.append(spin)
            form.addRow(name, spin)
        layout.addLayout(form)
        presets = QGridLayout()
        for col, (label, value) in enumerate(_PI_PRESETS):
            btn = QPushButton(label)
            btn.clicked.connect(
                lambda _, v=value: self._spins[0].setValue(v))
            presets.addWidget(btn, 0, col)
        layout.addLayout(presets)
        buttons = QDialogButtonBox(
            QDialogButtonBox.StandardButton.Ok
            | QDialogButtonBox.StandardButton.Cancel)
        buttons.accepted.connect(self.accept)
        buttons.rejected.connect(self.reject)
        layout.addWidget(buttons)

    def values(self) -> list[float]:
        return [s.value() for s in self._spins]


class NoiseConfigDialog(QDialog):
    """Enable/parameterize the 4 channels + readout error; builds a
    NoiseModel (or None when nothing is enabled)."""

    CHANNELS = [
        ("Bit Flip", BitFlipNoise),
        ("Phase Flip", PhaseFlipNoise),
        ("Depolarizing", DepolarizingNoise),
        ("Amplitude Damping", AmplitudeDampingNoise),
    ]

    def __init__(self, current: NoiseModel | None = None, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Noise configuration")
        layout = QVBoxLayout(self)
        form = QFormLayout()
        self._rows: list[tuple[QCheckBox, QDoubleSpinBox, type]] = []
        for label, cls in self.CHANNELS:
            check = QCheckBox(label)
            spin = QDoubleSpinBox()
            spin.setRange(0.0, 1.0)
            spin.setSingleStep(0.01)
            spin.setValue(0.05)
            form.addRow(check, spin)
            self._rows.append((check, spin, cls))
        # ✚ thermal relaxation row (T1 / T2 / gate time; T2 <= 2*T1)
        self.thermal_check = QCheckBox("Thermal Relaxation (T1/T2)")
        self.t1_spin = QDoubleSpinBox()
        self.t1_spin.setRange(1e-6, 1e6)
        self.t1_spin.setValue(50.0)
        self.t2_spin = QDoubleSpinBox()
        self.t2_spin.setRange(1e-6, 1e6)
        self.t2_spin.setValue(70.0)
        self.time_spin = QDoubleSpinBox()
        self.time_spin.setRange(0.0, 1e6)
        self.time_spin.setValue(1.0)
        form.addRow(self.thermal_check, QLabel("T1 / T2 / gate time:"))
        thermal_row = QGridLayout()
        thermal_row.addWidget(self.t1_spin, 0, 0)
        thermal_row.addWidget(self.t2_spin, 0, 1)
        thermal_row.addWidget(self.time_spin, 0, 2)
        form.addRow(QLabel(""), thermal_row)
        self.readout_check = QCheckBox("Readout error")
        self.p01_spin = QDoubleSpinBox()
        self.p01_spin.setRange(0.0, 1.0)
        self.p01_spin.setSingleStep(0.01)
        self.p10_spin = QDoubleSpinBox()
        self.p10_spin.setRange(0.0, 1.0)
        self.p10_spin.setSingleStep(0.01)
        form.addRow(self.readout_check, QLabel("P(1|0) / P(0|1):"))
        form.addRow(self.p01_spin, self.p10_spin)
        layout.addLayout(form)
        self.preview = QLabel("")
        layout.addWidget(self.preview)
        buttons = QDialogButtonBox(
            QDialogButtonBox.StandardButton.Ok
            | QDialogButtonBox.StandardButton.Cancel)
        buttons.accepted.connect(self.accept)
        buttons.rejected.connect(self.reject)
        layout.addWidget(buttons)
        for check, spin, _ in self._rows:
            check.stateChanged.connect(self._update_preview)
            spin.valueChanged.connect(self._update_preview)
        self._load(current)
        self._update_preview()

    def _load(self, model: NoiseModel | None) -> None:
        if model is None:
            return
        by_type = {type(ch): ch for ch in model.channels_for_gate("")}
        for check, spin, cls in self._rows:
            if cls in by_type:
                check.setChecked(True)
                spin.setValue(by_type[cls].probability)
        if ThermalRelaxationNoise in by_type:
            ch = by_type[ThermalRelaxationNoise]
            self.thermal_check.setChecked(True)
            self.t1_spin.setValue(ch.t1)
            self.t2_spin.setValue(ch.t2)
            self.time_spin.setValue(ch.time)
        if model.readout_error is not None:
            self.readout_check.setChecked(True)
            self.p01_spin.setValue(model.readout_error.p01)
            self.p10_spin.setValue(model.readout_error.p10)

    def _update_preview(self) -> None:
        active = [f"{check.text()} p={spin.value():.2f}"
                  for check, spin, _ in self._rows if check.isChecked()]
        self.preview.setText("Active: " + (", ".join(active) or "none"))

    def build_noise_model(self) -> NoiseModel | None:
        model = NoiseModel()
        any_channel = False
        for check, spin, cls in self._rows:
            if check.isChecked():
                model.add_global_noise(cls(spin.value()))
                any_channel = True
        if self.thermal_check.isChecked():
            t1 = self.t1_spin.value()
            model.add_global_noise(ThermalRelaxationNoise(
                t1, min(self.t2_spin.value(), 2 * t1),
                self.time_spin.value()))
            any_channel = True
        if self.readout_check.isChecked():
            model.set_readout_error(ReadoutError(self.p01_spin.value(),
                                                 self.p10_spin.value()))
            any_channel = True
        return model if any_channel else None


class AlgorithmDialog(QDialog):
    """Pick a template + parameters; exposes the built circuit."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Algorithm templates")
        layout = QVBoxLayout(self)
        self.template_combo = QComboBox()
        self._templates = AlgorithmTemplate.list_templates()
        for t in self._templates:
            self.template_combo.addItem(t["display"], t["name"])
        layout.addWidget(self.template_combo)
        self.description = QLabel("")
        layout.addWidget(self.description)
        form = QFormLayout()
        self.qubits_spin = QSpinBox()
        self.qubits_spin.setRange(2, 16)
        self.qubits_spin.setValue(3)
        self.marked_spin = QSpinBox()
        self.marked_spin.setRange(0, 2**16 - 1)
        self.secret_edit = QLineEdit("101")
        form.addRow("Qubits:", self.qubits_spin)
        form.addRow("Marked state (Grover):", self.marked_spin)
        form.addRow("Secret (BV):", self.secret_edit)
        layout.addLayout(form)
        # live circuit preview
        from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
        from matplotlib.figure import Figure

        from ..render import CircuitRenderer

        self._preview_fig = Figure(figsize=(5, 1.8))
        self._preview_canvas = FigureCanvasQTAgg(self._preview_fig)
        self._renderer = CircuitRenderer()
        layout.addWidget(self._preview_canvas)
        self.stats = QLabel("")
        layout.addWidget(self.stats)
        buttons = QDialogButtonBox(
            QDialogButtonBox.StandardButton.Ok
            | QDialogButtonBox.StandardButton.Cancel)
        buttons.accepted.connect(self.accept)
        buttons.rejected.connect(self.reject)
        layout.addWidget(buttons)
        self.template_combo.currentIndexChanged.connect(self._describe)
        for sig in (self.qubits_spin.valueChanged,
                    self.marked_spin.valueChanged,
                    self.secret_edit.textChanged):
            sig.connect(lambda *_: self._preview())
        self._describe()

    def _describe(self) -> None:
        t = self._templates[self.template_combo.currentIndex()]
        self.description.setText(t["description"])
        self._preview()

    def _preview(self) -> None:
        try:
            circuit = self.build_circuit()
        except Exception as e:  # bad params mid-edit: show, don't crash
            self.stats.setText(str(e))
            return
        self._preview_fig.clear()
        ax = self._preview_fig.add_subplot(111)
        self._renderer.draw(ax, circuit)
        self._preview_canvas.draw_idle()
        self.stats.setText(
            f"{circuit.num_qubits} qubits, {circuit.gate_count()} gates, "
            f"depth {circuit.get_column_count()}")

    def build_circuit(self):
        name = self.template_combo.currentData()
        n = self.qubits_spin.value()
        if name == "bell_state":
            return AlgorithmTemplate.bell_state()
        if name == "ghz_state":
            return AlgorithmTemplate.ghz_state(n)
        if name == "qft":
            return AlgorithmTemplate.quantum_fourier_transform(n)
        if name == "inverse_qft":
            return AlgorithmTemplate.inverse_qft(n)
        if name == "grover":
            return AlgorithmTemplate.grover_search(
                n, self.marked_spin.value() % (2**n))
        if name == "deutsch_jozsa":
            return AlgorithmTemplate.deutsch_jozsa(n)
        if name == "teleportation":
            return AlgorithmTemplate.quantum_teleportation()
        if name == "bernstein_vazirani":
            return AlgorithmTemplate.bernstein_vazirani(
                self.secret_edit.text() or "101")
        if name == "tfim_quench":
            return AlgorithmTemplate.tfim_quench(n)
        return AlgorithmTemplate.superdense_coding()


class CustomGateDialog(QDialog):
    """Enter a 2x2 or 4x4 complex matrix; validates unitarity and
    registers the gate."""

    def __init__(self, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Custom gate")
        layout = QVBoxLayout(self)
        form = QFormLayout()
        self.name_edit = QLineEdit("U_custom")
        self.size_combo = QComboBox()
        self.size_combo.addItems(["2x2 (1 qubit)", "4x4 (2 qubits)"])
        form.addRow("Name:", self.name_edit)
        form.addRow("Size:", self.size_combo)
        layout.addLayout(form)
        self.grid = QGridLayout()
        layout.addLayout(self.grid)
        self._cells: list[list[QLineEdit]] = []
        self.size_combo.currentIndexChanged.connect(self._rebuild_grid)
        self._rebuild_grid()
        self.status = QLabel("")
        layout.addWidget(self.status)
        buttons = QDialogButtonBox(
            QDialogButtonBox.StandardButton.Ok
            | QDialogButtonBox.StandardButton.Cancel)
        buttons.accepted.connect(self._validate_and_accept)
        buttons.rejected.connect(self.reject)
        layout.addWidget(buttons)

    def _rebuild_grid(self) -> None:
        for row in self._cells:
            for cell in row:
                cell.deleteLater()
        self._cells = []
        dim = 2 if self.size_combo.currentIndex() == 0 else 4
        for r in range(dim):
            row = []
            for c in range(dim):
                cell = QLineEdit("1" if r == c else "0")
                self.grid.addWidget(cell, r, c)
                row.append(cell)
            self._cells.append(row)

    def matrix(self) -> np.ndarray:
        dim = len(self._cells)
        m = np.zeros((dim, dim), dtype=np.complex128)
        for r in range(dim):
            for c in range(dim):
                m[r, c] = complex(self._cells[r][c].text()
                                  .replace(" ", "").replace("i", "j"))
        return m

    def _validate_and_accept(self) -> None:
        try:
            m = self.matrix()
        except ValueError as e:
            self.status.setText(f"Parse error: {e}")
            return
        if not np.allclose(m @ m.conj().T, np.eye(len(m)), atol=1e-6):
            self.status.setText("Matrix is not unitary")
            return
        name = self.name_edit.text().strip() or "U_custom"
        n_q = 1 if len(m) == 2 else 2
        GateRegistry.instance().register(GateDefinition(
            name=name, display_name=name,
            gate_type=(GateType.SINGLE if n_q == 1 else GateType.MULTI),
            num_qubits=n_q, num_params=0, param_names=(),
            matrix_func=_const(m), symbol=name[:3], color="#607D8B",
            num_targets=n_q))
        self.accept()


class AboutDialog(QDialog):
    def __init__(self, parent=None):
        super().__init__(parent)
        self.setWindowTitle("About")
        layout = QVBoxLayout(self)
        layout.addWidget(QLabel(
            "<h3>Quantum Simulator (PyTorch / CUDA)</h3>"
            "<p>Statevector simulation on an NVIDIA GPU: a group-matmul "
            "executor whose steps run hand-written CUDA kernels, batched "
            "Monte-Carlo noise trajectories, and mesh-sharded states.</p>"))
        buttons = QDialogButtonBox(QDialogButtonBox.StandardButton.Ok)
        buttons.accepted.connect(self.accept)
        layout.addWidget(buttons)
