"""QGraphicsScene drag-and-drop circuit editor (thin shell over
``editor_model.CircuitEditorModel`` — every decision lives in the model).

A copy of ``quantum_simulator_tpu/gui/editor_scene.py`` over the port's
editor model. Interactions:
* drag a gate button from the palette (MIME ``application/x-quantum-gate``)
  onto a wire — a drop indicator tracks the snapped cell; multi-qubit
  gates pop a target-selection dialog pre-filled with the model's
  proposal;
* drag a placed gate to move it — it snaps to the grid and the move is
  committed through the undo stack on release;
* double-click a column header toggles a breakpoint line; the debugger
  highlights its current column;
* click a wire label to toggle the qubit's |0>/|1> initial state;
* view: Ctrl+wheel zoom 0.25-4x, rubber-band selection, Del removes the
  selection, Ctrl+Z/Y undo/redo, Ctrl+0 resets zoom.
"""

from __future__ import annotations

from PyQt6.QtCore import QPointF, QRectF, Qt, pyqtSignal
from PyQt6.QtGui import (
    QBrush,
    QColor,
    QFont,
    QPainter,
    QPen,
)
from PyQt6.QtWidgets import (
    QDialog,
    QDialogButtonBox,
    QFormLayout,
    QGraphicsItem,
    QGraphicsRectItem,
    QGraphicsScene,
    QGraphicsView,
    QSpinBox,
)

from .editor_model import (
    COL_W,
    GATE_H,
    GATE_MIME_TYPE,
    GATE_W,
    ROW_H,
    TOP_Y,
    WIRE_X0,
    CircuitEditorModel,
    GateVisual,
)

_WIRE_COLOR = QColor("#6c7086")
_BREAK_COLOR = QColor("#f38ba8")
_DEBUG_COLOR = QColor(137, 180, 250, 60)
_INDICATOR_OK = QColor(166, 227, 161, 120)
_INDICATOR_BAD = QColor(243, 139, 168, 120)
_TEXT_COLOR = QColor("#cdd6f4")


class TargetDialog(QDialog):
    """Pick target qubits for a multi-qubit gate drop."""

    def __init__(self, gate_name: str, proposal, num_qubits: int,
                 parent=None):
        super().__init__(parent)
        self.setWindowTitle(f"{gate_name} targets")
        form = QFormLayout(self)
        self._spins = []
        labels = (["control"] * (len(proposal) - 1) + ["target"]
                  if gate_name in ("CNOT", "CZ", "Toffoli", "CPhase")
                  else [f"qubit {i}" for i in range(len(proposal))])
        for i, q in enumerate(proposal):
            spin = QSpinBox()
            spin.setRange(0, num_qubits - 1)
            spin.setValue(q)
            form.addRow(labels[i], spin)
            self._spins.append(spin)
        buttons = QDialogButtonBox(
            QDialogButtonBox.StandardButton.Ok
            | QDialogButtonBox.StandardButton.Cancel)
        buttons.accepted.connect(self.accept)
        buttons.rejected.connect(self.reject)
        form.addRow(buttons)

    def targets(self) -> tuple[int, ...]:
        return tuple(s.value() for s in self._spins)


class GateItem(QGraphicsRectItem):
    """A placed gate: movable, selectable, snaps through the model."""

    def __init__(self, visual: GateVisual, scene: "CircuitScene"):
        self._v = visual
        self._scene_ref = scene
        x = scene.model.column_x(visual.column) - GATE_W / 2
        y = scene.model.qubit_y(min(visual.targets)) - GATE_H / 2
        h = ((max(visual.targets) - min(visual.targets)) * ROW_H + GATE_H)
        super().__init__(0, 0, GATE_W, h)
        self.setPos(x, y)
        self.setFlag(QGraphicsItem.GraphicsItemFlag.ItemIsMovable, True)
        self.setFlag(QGraphicsItem.GraphicsItemFlag.ItemIsSelectable, True)
        plain_box = visual.kind in ("single", "measure")
        self.setBrush(QBrush(QColor(visual.color)) if plain_box
                      else QBrush(Qt.BrushStyle.NoBrush))
        self.setPen(QPen(QColor("#11111b"), 1.5) if plain_box
                    else QPen(Qt.PenStyle.NoPen))
        self._drag_origin = None

    @property
    def gate(self):
        return self._v.gate

    def _row_center_y(self, qubit: int) -> float:
        """Item-local y of a target qubit's wire."""
        return (qubit - min(self._v.targets)) * ROW_H + GATE_H / 2

    def paint(self, painter: QPainter, option, widget=None):
        super().paint(painter, option, widget)
        v = self._v
        cx = GATE_W / 2
        color = QColor(v.color)
        painter.setRenderHint(QPainter.RenderHint.Antialiasing)
        if v.kind == "barrier":
            pen = QPen(QColor("#6c7086"), 2, Qt.PenStyle.DashLine)
            painter.setPen(pen)
            painter.drawLine(QPointF(cx, 0),
                             QPointF(cx, self.rect().height()))
            return
        if v.kind == "swap":
            painter.setPen(QPen(color, 2.5))
            ys = [self._row_center_y(q) for q in v.targets]
            painter.drawLine(QPointF(cx, min(ys)), QPointF(cx, max(ys)))
            for y in ys:
                painter.drawLine(QPointF(cx - 7, y - 7),
                                 QPointF(cx + 7, y + 7))
                painter.drawLine(QPointF(cx - 7, y + 7),
                                 QPointF(cx + 7, y - 7))
            return
        if v.kind == "controlled":
            painter.setPen(QPen(color, 2.2))
            ys = [self._row_center_y(q) for q in v.targets]
            painter.drawLine(QPointF(cx, min(ys)), QPointF(cx, max(ys)))
            controls = v.targets[:v.num_controls] if v.num_controls \
                else v.targets[:-1]
            target_qs = [q for q in v.targets if q not in controls]
            painter.setBrush(QBrush(color))
            for q in controls:
                painter.drawEllipse(QPointF(cx, self._row_center_y(q)),
                                    5, 5)
            for q in target_qs:
                y = self._row_center_y(q)
                if v.symbol in ("Z", "CZ", "●"):
                    painter.drawEllipse(QPointF(cx, y), 5, 5)
                else:
                    painter.setBrush(QBrush(Qt.BrushStyle.NoBrush))
                    painter.drawEllipse(QPointF(cx, y), 11, 11)
                    painter.drawLine(QPointF(cx - 11, y),
                                     QPointF(cx + 11, y))
                    painter.drawLine(QPointF(cx, y - 11),
                                     QPointF(cx, y + 11))
            return
        # single-qubit box (and measurement, which draws an arc + arrow)
        painter.setPen(QPen(_TEXT_COLOR))
        painter.setFont(QFont("monospace", 10, QFont.Weight.Bold))
        if v.kind == "measure":
            r = self.rect()
            painter.drawArc(
                QRectF(r.x() + 8, r.y() + 10, r.width() - 16,
                       r.height() - 10),
                30 * 16, 120 * 16)
            painter.drawLine(
                QPointF(r.center().x(), r.bottom() - 8),
                QPointF(r.right() - 10, r.y() + 10))
        else:
            painter.drawText(self.rect(),
                             Qt.AlignmentFlag.AlignCenter, v.symbol)

    def mousePressEvent(self, event):
        self._drag_origin = self.pos()
        super().mousePressEvent(event)

    def mouseReleaseEvent(self, event):
        super().mouseReleaseEvent(event)
        if self._drag_origin is None:
            return
        moved = self.pos() != self._drag_origin
        self._drag_origin = None
        if not moved:
            return
        model = self._scene_ref.model
        center = self.pos() + QPointF(GATE_W / 2, GATE_H / 2)
        plan = model.plan_move(self._v.gate, center.x(), center.y())
        if plan is None:
            self._scene_ref.rebuild()      # snap back: invalid move
            return
        column, targets = plan
        if not model.commit_move(self._v.gate, column, targets):
            self._scene_ref.rebuild()


class CircuitScene(QGraphicsScene):
    """Renders the model's draw list; routes drops/moves through it."""

    gate_activated = pyqtSignal(object)    # double-clicked GateInstance
    selection_changed_gates = pyqtSignal(list)

    def __init__(self, model: CircuitEditorModel | None = None, parent=None):
        super().__init__(parent)
        self.model = model or CircuitEditorModel()
        self.model.on_changed(self.rebuild)
        self._indicator: QGraphicsRectItem | None = None
        self.selectionChanged.connect(self._on_selection)
        self.rebuild()

    # -- scene construction ---------------------------------------------
    def rebuild(self):
        self.clear()
        self._indicator = None
        model = self.model
        w, h = model.scene_size()
        self.setSceneRect(0, 0, w, h)

        wire_pen = QPen(_WIRE_COLOR, 1.2)
        for q, label in model.wire_labels():
            y = model.qubit_y(q)
            self.addLine(WIRE_X0 - COL_W / 2, y, w - 10, y, wire_pen)
            text = self.addText(label, QFont("monospace", 10))
            text.setDefaultTextColor(_TEXT_COLOR)
            text.setPos(8, y - 12)
            text.setData(0, ("wire-label", q))

        if model.debug_column is not None:
            x = model.column_x(model.debug_column)
            rect = self.addRect(QRectF(x - COL_W / 2, 0, COL_W, h),
                                QPen(Qt.PenStyle.NoPen),
                                QBrush(_DEBUG_COLOR))
            rect.setZValue(-1)

        for col in sorted(model.breakpoints):
            x = model.column_x(col) - COL_W / 2
            pen = QPen(_BREAK_COLOR, 2, Qt.PenStyle.DashLine)
            self.addLine(x, 0, x, h, pen)

        for visual in model.gate_visuals():
            self.addItem(GateItem(visual, self))

    # -- selection --------------------------------------------------------
    def _on_selection(self):
        gates = [it.gate for it in self.selectedItems()
                 if isinstance(it, GateItem)]
        self.model.set_selection(gates)
        self.selection_changed_gates.emit(gates)

    # -- palette drag-and-drop ---------------------------------------------
    def dragEnterEvent(self, event):
        if event.mimeData().hasFormat(GATE_MIME_TYPE):
            event.acceptProposedAction()

    def dragMoveEvent(self, event):
        if not event.mimeData().hasFormat(GATE_MIME_TYPE):
            return
        name = bytes(event.mimeData().data(GATE_MIME_TYPE)).decode()
        pos = event.scenePos()
        plan = self.model.plan_drop(name, pos.x(), pos.y())
        self._show_indicator(plan)
        event.acceptProposedAction()

    def dragLeaveEvent(self, event):
        self._hide_indicator()

    def dropEvent(self, event):
        self._hide_indicator()
        if not event.mimeData().hasFormat(GATE_MIME_TYPE):
            return
        name = bytes(event.mimeData().data(GATE_MIME_TYPE)).decode()
        pos = event.scenePos()
        plan = self.model.plan_drop(name, pos.x(), pos.y())
        if not plan.valid:
            return
        targets = None
        if plan.needs_target_dialog:
            dialog = TargetDialog(name, plan.targets,
                                  self.model.circuit.num_qubits)
            if dialog.exec() != QDialog.DialogCode.Accepted:
                return
            targets = dialog.targets()
        self.model.commit_drop(plan, targets)
        event.acceptProposedAction()

    def _show_indicator(self, plan):
        self._hide_indicator()
        if plan.column < 0:
            return
        x = self.model.column_x(plan.column) - GATE_W / 2
        ys = [self.model.qubit_y(q) for q in plan.targets]
        y = min(ys) - GATE_H / 2
        h = max(ys) - min(ys) + GATE_H
        color = _INDICATOR_OK if plan.valid else _INDICATOR_BAD
        self._indicator = self.addRect(
            QRectF(x, y, GATE_W, h), QPen(color.darker(), 1),
            QBrush(color))
        self._indicator.setZValue(10)

    def _hide_indicator(self):
        if self._indicator is not None:
            self.removeItem(self._indicator)
            self._indicator = None

    # -- clicks --------------------------------------------------------------
    def mousePressEvent(self, event):
        item = self.itemAt(event.scenePos(), self.views()[0].transform()
                           if self.views() else None) \
            if self.views() else None
        if item is not None and item.data(0) and \
                item.data(0)[0] == "wire-label":
            self.model.toggle_initial_state(item.data(0)[1])
            return
        super().mousePressEvent(event)

    def mouseDoubleClickEvent(self, event):
        pos = event.scenePos()
        if pos.y() < TOP_Y - ROW_H / 2:   # column header strip
            snapped = self.model.snap(pos.x(), TOP_Y)
            if snapped is not None:
                self.model.toggle_breakpoint(snapped.column)
                self.rebuild()
            return
        gate = self.model.hit_test(pos.x(), pos.y())
        if gate is not None:
            self.gate_activated.emit(gate)
            return
        super().mouseDoubleClickEvent(event)

    def keyPressEvent(self, event):
        if event.key() in (Qt.Key.Key_Delete, Qt.Key.Key_Backspace):
            self.model.delete_selection()
            return
        super().keyPressEvent(event)


class CircuitEditorView(QGraphicsView):
    """Zoom/rubber-band/shortcut host for the scene."""

    MIN_ZOOM, MAX_ZOOM = 0.25, 4.0

    def __init__(self, scene: CircuitScene, parent=None):
        super().__init__(scene, parent)
        self._zoom = 1.0
        self.setAcceptDrops(True)
        self.setRenderHint(QPainter.RenderHint.Antialiasing)
        self.setDragMode(QGraphicsView.DragMode.RubberBandDrag)

    def wheelEvent(self, event):
        if event.modifiers() & Qt.KeyboardModifier.ControlModifier:
            factor = 1.15 if event.angleDelta().y() > 0 else 1 / 1.15
            new_zoom = min(self.MAX_ZOOM,
                           max(self.MIN_ZOOM, self._zoom * factor))
            factor = new_zoom / self._zoom
            self._zoom = new_zoom
            self.scale(factor, factor)
            return
        super().wheelEvent(event)

    def keyPressEvent(self, event):
        model = self.scene().model
        ctrl = event.modifiers() & Qt.KeyboardModifier.ControlModifier
        if ctrl and event.key() == Qt.Key.Key_Z:
            model.controller.undo()
        elif ctrl and event.key() == Qt.Key.Key_Y:
            model.controller.redo()
        elif ctrl and event.key() == Qt.Key.Key_A:
            for item in self.scene().items():
                if isinstance(item, GateItem):
                    item.setSelected(True)
        elif ctrl and event.key() == Qt.Key.Key_0:
            self.resetTransform()
            self._zoom = 1.0
        else:
            super().keyPressEvent(event)
