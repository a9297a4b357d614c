"""Dock widgets: gate palette and gate properties editor.

A copy of ``quantum_simulator_tpu/gui/docks.py`` over the port's gate
registry: a sectioned palette built from the registry (``refresh()`` picks
up custom gates; a drag carries the gate's MIME payload) and a properties
editor (per-qubit target spinboxes with control/target roles, parameter
spinboxes with pi presets, apply). No engine, no device.
"""

from __future__ import annotations

import math

from PyQt6.QtCore import QMimeData, QPoint, QRect, QSize, Qt, pyqtSignal
from PyQt6.QtGui import QDrag
from PyQt6.QtWidgets import (
    QDoubleSpinBox,
    QFormLayout,
    QGroupBox,
    QHBoxLayout,
    QLabel,
    QLayout,
    QPushButton,
    QSpinBox,
    QToolBox,
    QVBoxLayout,
    QWidget,
)

from ..gates import GateType
from ..registry import GateRegistry
from .editor_model import GATE_MIME_TYPE


class FlowLayout(QLayout):
    """Left-to-right layout that wraps items onto new rows as the dock
    narrows (the palette stays usable at any width)."""

    def __init__(self, parent=None, margin: int = 4, spacing: int = 4):
        super().__init__(parent)
        self._items = []
        self._spacing = spacing
        self.setContentsMargins(margin, margin, margin, margin)

    def addItem(self, item):
        self._items.append(item)

    def count(self):
        return len(self._items)

    def itemAt(self, index):
        return self._items[index] if 0 <= index < len(self._items) else None

    def takeAt(self, index):
        return self._items.pop(index) if 0 <= index < len(self._items) \
            else None

    def expandingDirections(self):
        return Qt.Orientation(0)

    def hasHeightForWidth(self):
        return True

    def heightForWidth(self, width):
        return self._arrange(QRect(0, 0, width, 0), dry_run=True)

    def setGeometry(self, rect):
        super().setGeometry(rect)
        self._arrange(rect, dry_run=False)

    def sizeHint(self):
        return self.minimumSize()

    def minimumSize(self):
        size = QSize()
        for item in self._items:
            size = size.expandedTo(item.minimumSize())
        m = self.contentsMargins()
        return size + QSize(m.left() + m.right(), m.top() + m.bottom())

    def _arrange(self, rect, dry_run: bool) -> int:
        x, y = rect.x(), rect.y()
        row_h = 0
        for item in self._items:
            hint = item.sizeHint()
            if x + hint.width() > rect.right() and row_h > 0:
                x = rect.x()
                y += row_h + self._spacing
                row_h = 0
            if not dry_run:
                item.setGeometry(QRect(QPoint(x, y), hint))
            x += hint.width() + self._spacing
            row_h = max(row_h, hint.height())
        return y + row_h - rect.y()


class GateButton(QPushButton):
    """Palette button: click chooses the gate, dragging starts a
    ``application/x-quantum-gate`` drag that the editor scene accepts."""

    def __init__(self, gate_name: str, symbol: str, color: str,
                 tooltip: str, parent=None):
        super().__init__(symbol, parent)
        self.gate_name = gate_name
        self.setToolTip(tooltip)
        self.setFixedSize(46, 34)
        self.setStyleSheet(
            f"background-color: {color}; color: white; font-weight: bold;")
        self._press_pos: QPoint | None = None

    def mousePressEvent(self, event):
        if event.button() == Qt.MouseButton.LeftButton:
            self._press_pos = event.pos()
        super().mousePressEvent(event)

    def mouseMoveEvent(self, event):
        if (self._press_pos is None
                or not (event.buttons() & Qt.MouseButton.LeftButton)):
            return super().mouseMoveEvent(event)
        if ((event.pos() - self._press_pos).manhattanLength() < 8):
            return super().mouseMoveEvent(event)
        mime = QMimeData()
        mime.setData(GATE_MIME_TYPE, self.gate_name.encode())
        mime.setText(self.gate_name)
        drag = QDrag(self)
        drag.setMimeData(mime)
        drag.setPixmap(self.grab())
        self._press_pos = None
        drag.exec(Qt.DropAction.CopyAction)

_SECTIONS = [
    ("Single-Qubit", lambda gd: gd.gate_type == GateType.SINGLE
     and gd.num_params == 0),
    ("Rotations", lambda gd: gd.gate_type == GateType.SINGLE
     and gd.num_params > 0),
    ("Multi-Qubit", lambda gd: gd.gate_type in (GateType.CONTROLLED,
                                                GateType.MULTI)),
    ("Measurement", lambda gd: gd.gate_type in (GateType.MEASUREMENT,
                                                GateType.BARRIER)),
]


class GatePalette(QWidget):
    """Sectioned gate buttons; emits the chosen gate name."""

    gate_chosen = pyqtSignal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        layout = QVBoxLayout(self)
        self._toolbox = QToolBox()
        layout.addWidget(self._toolbox)
        self.refresh()

    def refresh(self) -> None:
        """Rebuild sections (picks up runtime-registered custom gates)."""
        while self._toolbox.count():
            w = self._toolbox.widget(0)
            self._toolbox.removeItem(0)
            w.deleteLater()
        registry = GateRegistry.instance()
        gates = registry.all_gates()
        used: set[str] = set()

        def add_section(title, members):
            page = QWidget()
            flow = FlowLayout(page)
            for gd in members:
                btn = GateButton(gd.name, gd.symbol, gd.color,
                                 gd.display_name)
                btn.clicked.connect(
                    lambda _, name=gd.name: self.gate_chosen.emit(name))
                flow.addWidget(btn)
            self._toolbox.addItem(page, title)

        for title, predicate in _SECTIONS:
            members = []
            for gd in gates:
                if gd.name in used or not predicate(gd):
                    continue
                used.add(gd.name)
                members.append(gd)
            add_section(title, members)
        # Anything uncategorized (custom gates) gets its own section.
        leftovers = [gd for gd in gates if gd.name not in used]
        if leftovers:
            add_section("Custom", leftovers)


class PropertiesPanel(QWidget):
    """Edits the selected gate's target qubits and parameters."""

    params_changed = pyqtSignal(object, list)        # (gate, new_params)
    targets_changed = pyqtSignal(object, list)       # (gate, new_targets)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._gate = None
        self._registry = GateRegistry.instance()
        layout = QVBoxLayout(self)
        self.title = QLabel("No gate selected")
        layout.addWidget(self.title)
        self._targets_box = QGroupBox("Target qubits")
        self._targets_form = QFormLayout(self._targets_box)
        layout.addWidget(self._targets_box)
        self._params_box = QGroupBox("Parameters")
        self._params_form = QFormLayout(self._params_box)
        layout.addWidget(self._params_box)
        apply_btn = QPushButton("Apply")
        apply_btn.clicked.connect(self._apply)
        layout.addWidget(apply_btn)
        layout.addStretch(1)
        self._target_spins: list[QSpinBox] = []
        self._param_spins: list[QDoubleSpinBox] = []

    def set_gate(self, gate, num_qubits: int) -> None:
        self._gate = gate
        for form in (self._targets_form, self._params_form):
            while form.rowCount():
                form.removeRow(0)
        self._target_spins = []
        self._param_spins = []
        if gate is None:
            self.title.setText("No gate selected")
            return
        gd = self._registry.get(gate.gate_name)
        self.title.setText(f"{gd.display_name} @ column {gate.column}")
        for i, q in enumerate(gate.target_qubits):
            role = ("control" if i < gd.num_controls else "target")
            spin = QSpinBox()
            spin.setRange(0, num_qubits - 1)
            spin.setValue(q)
            self._target_spins.append(spin)
            self._targets_form.addRow(f"{role} {i}", spin)
        presets = [("π", math.pi), ("π/2", math.pi / 2),
                   ("π/4", math.pi / 4), ("-π/2", -math.pi / 2),
                   ("0", 0.0)]
        for i, name in enumerate(gd.param_names):
            spin = QDoubleSpinBox()
            spin.setRange(-4 * math.pi, 4 * math.pi)
            spin.setDecimals(6)
            spin.setValue(gate.params[i] if i < len(gate.params) else 0.0)
            self._param_spins.append(spin)
            row = QWidget()
            hbox = QHBoxLayout(row)
            hbox.setContentsMargins(0, 0, 0, 0)
            hbox.addWidget(spin, 1)
            for label, value in presets:
                btn = QPushButton(label)
                btn.setFixedWidth(36)
                btn.clicked.connect(
                    lambda _, s=spin, v=value: s.setValue(v))
                hbox.addWidget(btn)
            self._params_form.addRow(name, row)
            ratio = QLabel(self._pi_ratio_text(spin.value()))
            spin.valueChanged.connect(
                lambda v, lab=ratio: lab.setText(self._pi_ratio_text(v)))
            self._params_form.addRow("", ratio)

    @staticmethod
    def _pi_ratio_text(value: float) -> str:
        """Human-readable multiple of pi (e.g. '= 0.5 π')."""
        if abs(value) < 1e-12:
            return "= 0"
        ratio = value / math.pi
        return f"= {ratio:.4g} π"

    def _apply(self) -> None:
        if self._gate is None:
            return
        new_targets = [s.value() for s in self._target_spins]
        if new_targets != self._gate.target_qubits:
            self.targets_changed.emit(self._gate, new_targets)
        new_params = [s.value() for s in self._param_spins]
        if new_params != self._gate.params:
            self.params_changed.emit(self._gate, new_params)
