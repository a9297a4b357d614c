"""Interactive circuit view: matplotlib canvas + edit toolbar.

A copy of ``quantum_simulator_tpu/gui/circuit_view.py``: the view renders
through the port's headless ``render.CircuitRenderer`` and edits through
the undoable ``CircuitController`` (click-to-place with a selected
palette gate, column/qubit resolved from the click position). The
drag-and-drop editor is ``editor_scene.py``. No engine, no device.
"""

from __future__ import annotations

from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
from matplotlib.figure import Figure
from PyQt6.QtCore import pyqtSignal
from PyQt6.QtWidgets import (
    QComboBox,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSpinBox,
    QVBoxLayout,
    QWidget,
)

from ..controller import CircuitController
from ..registry import GateRegistry
from ..render import COL_W, ROW_H, CircuitRenderer


class CircuitView(QWidget):
    """Renders the controller's circuit; clicks place the selected gate."""

    gate_selected = pyqtSignal(object)  # GateInstance | None

    def __init__(self, controller: CircuitController, theme: str = "dark",
                 parent=None):
        super().__init__(parent)
        self._controller = controller
        self._renderer = CircuitRenderer(theme)
        self._registry = GateRegistry.instance()
        self._pending_targets: list[int] = []

        layout = QVBoxLayout(self)

        bar = QHBoxLayout()
        bar.addWidget(QLabel("Gate:"))
        self.gate_combo = QComboBox()
        for gd in self._registry.all_gates():
            self.gate_combo.addItem(f"{gd.symbol} ({gd.name})", gd.name)
        bar.addWidget(self.gate_combo)
        bar.addWidget(QLabel("Qubits:"))
        self.qubit_spin = QSpinBox()
        self.qubit_spin.setRange(1, 32)
        self.qubit_spin.setValue(self._controller.circuit.num_qubits)
        self.qubit_spin.valueChanged.connect(
            self._controller.set_qubit_count)
        bar.addWidget(self.qubit_spin)
        undo_btn = QPushButton("Undo")
        undo_btn.clicked.connect(self._controller.undo)
        redo_btn = QPushButton("Redo")
        redo_btn.clicked.connect(self._controller.redo)
        clear_btn = QPushButton("Clear")
        clear_btn.clicked.connect(self._controller.clear_circuit)
        for b in (undo_btn, redo_btn, clear_btn):
            bar.addWidget(b)
        bar.addStretch(1)
        self.hint_label = QLabel("")
        bar.addWidget(self.hint_label)
        layout.addLayout(bar)

        self.figure = Figure(figsize=(8, 4))
        self.canvas = FigureCanvasQTAgg(self.figure)
        self.canvas.mpl_connect("button_press_event", self._on_click)
        layout.addWidget(self.canvas)

        self._controller.on_circuit_changed(self.refresh)
        self.refresh()

    # --- rendering -------------------------------------------------------

    def set_theme(self, theme: str) -> None:
        self._renderer = CircuitRenderer(theme)
        self.refresh()

    def refresh(self) -> None:
        circuit = self._controller.circuit
        self.qubit_spin.blockSignals(True)
        self.qubit_spin.setValue(circuit.num_qubits)
        self.qubit_spin.blockSignals(False)
        self.figure.clear()
        ax = self.figure.add_subplot(111)
        self.figure.patch.set_facecolor(self._renderer.bg)
        self._renderer.draw(ax, circuit)
        self.canvas.draw_idle()

    # --- editing -----------------------------------------------------------

    def _on_click(self, event) -> None:
        if event.inaxes is None or event.xdata is None:
            return
        circuit = self._controller.circuit
        column = max(0, int(event.xdata / COL_W))
        qubit = max(0, min(circuit.num_qubits - 1,
                           int(round(-event.ydata / ROW_H))))

        if event.button == 3:  # right-click: remove gate at position
            for gate in reversed(circuit.gates):
                if gate.column == column and qubit in gate.target_qubits:
                    self._controller.remove_gate(gate)
                    return
            return

        gate_name = self.gate_combo.currentData()
        gd = self._registry.get(gate_name)
        self._pending_targets.append(qubit)
        if len(self._pending_targets) < gd.num_qubits:
            self.hint_label.setText(
                f"{gd.symbol}: select {gd.num_qubits - len(self._pending_targets)} more qubit(s)")
            return
        targets = list(dict.fromkeys(self._pending_targets))
        self._pending_targets = []
        self.hint_label.setText("")
        if len(targets) < gd.num_qubits:
            return  # duplicate qubits clicked; abort placement
        gate = self._controller.add_gate(
            gate_name, targets, [0.0] * gd.num_params, column=column)
        self.gate_selected.emit(gate)
