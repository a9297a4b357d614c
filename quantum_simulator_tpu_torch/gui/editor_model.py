"""Toolkit-free interactive circuit-editor logic.

A copy of ``quantum_simulator_tpu/gui/editor_model.py`` over the port's
``CircuitController`` and gate registry. Everything the drag-and-drop
editor decides — grid snapping, drop resolution (including default
multi-qubit target proposals), move validation/commit through the undo
stack, cell-occupancy checks, breakpoint toggling, debug-column
highlighting, selection — lives here, with the Qt scene
(``editor_scene.py``) reduced to a rendering/event shell, so the editor is
testable without PyQt6. It runs no simulation and touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..circuit import GateInstance
from ..controller import CircuitController
from ..gates import GateType
from ..registry import GateRegistry

# Grid geometry (scene coordinates).
COL_W = 60
ROW_H = 50
WIRE_X0 = 120          # x of column 0's center
TOP_Y = 40             # y of qubit 0's wire
GATE_W = 44
GATE_H = 36

#: QMimeData type carried by palette drags.
GATE_MIME_TYPE = "application/x-quantum-gate"


@dataclass(frozen=True)
class GridPos:
    column: int
    qubit: int


@dataclass(frozen=True)
class DropPlan:
    """Resolved palette drop: where the gate would land and whether the
    view must ask the user for extra target qubits first."""

    gate_name: str
    column: int
    targets: tuple[int, ...]       # proposed (first = drop row)
    needs_target_dialog: bool      # True for multi-qubit gates
    valid: bool
    reason: str = ""


@dataclass
class GateVisual:
    """Draw-list entry the scene renders (no Qt types)."""

    gate: GateInstance
    kind: str                      # single|controlled|swap|measure|barrier
    symbol: str
    color: str
    column: int
    targets: tuple[int, ...]
    num_controls: int


class CircuitEditorModel:
    """The editor's brain: geometry, drop/move resolution, overlays."""

    def __init__(self, controller: CircuitController | None = None):
        self.controller = controller or CircuitController()
        self.registry = GateRegistry.instance()
        self.breakpoints: set[int] = set()
        self.debug_column: int | None = None
        self.selected: list[GateInstance] = []
        self._changed_callbacks: list = []
        self.controller.on_circuit_changed(self._emit_changed)

    # -- change notification -------------------------------------------------
    def on_changed(self, callback) -> None:
        self._changed_callbacks.append(callback)

    def _emit_changed(self) -> None:
        for cb in self._changed_callbacks:
            cb()

    # -- geometry -------------------------------------------------------------
    @property
    def circuit(self):
        return self.controller.circuit

    def column_x(self, column: int) -> float:
        return WIRE_X0 + column * COL_W

    def qubit_y(self, qubit: int) -> float:
        return TOP_Y + qubit * ROW_H

    def snap(self, x: float, y: float) -> GridPos | None:
        """Nearest grid cell, or None outside the wire area."""
        column = round((x - WIRE_X0) / COL_W)
        qubit = round((y - TOP_Y) / ROW_H)
        if column < 0 or qubit < 0 or qubit >= self.circuit.num_qubits:
            return None
        return GridPos(column=int(column), qubit=int(qubit))

    def scene_size(self) -> tuple[float, float]:
        cols = max(12, self.num_columns() + 3)
        return (WIRE_X0 + cols * COL_W,
                TOP_Y + self.circuit.num_qubits * ROW_H + 40)

    def num_columns(self) -> int:
        gates = self.circuit.gates
        return (max(g.column for g in gates) + 1) if gates else 0

    # -- occupancy ------------------------------------------------------------
    def occupied_cells(self, exclude: GateInstance | None = None
                       ) -> set[tuple[int, int]]:
        cells = set()
        for g in self.circuit.gates:
            if g is exclude:
                continue
            for q in g.target_qubits:
                cells.add((g.column, q))
        return cells

    def cell_free(self, column: int, qubits, exclude=None) -> bool:
        occupied = self.occupied_cells(exclude)
        return all((column, q) not in occupied for q in qubits)

    # -- palette drops ----------------------------------------------------
    def required_targets(self, gate_name: str) -> int:
        gd = self.registry.get(gate_name)
        return gd.num_controls + gd.num_targets

    def plan_drop(self, gate_name: str, x: float, y: float) -> DropPlan:
        pos = self.snap(x, y)
        if pos is None:
            return DropPlan(gate_name, -1, (), False, False,
                            "outside the circuit grid")
        k = self.required_targets(gate_name)
        n = self.circuit.num_qubits
        if k > n:
            return DropPlan(gate_name, pos.column, (pos.qubit,), False,
                            False, f"gate needs {k} qubits, circuit has {n}")
        # default proposal: drop row, then next free rows downward/up
        targets = [pos.qubit]
        step = 1 if pos.qubit + k - 1 < n else -1
        q = pos.qubit
        while len(targets) < k:
            q += step
            if not 0 <= q < n:
                return DropPlan(gate_name, pos.column, tuple(targets),
                                False, False, "not enough room for targets")
            targets.append(q)
        free = self.cell_free(pos.column, targets)
        return DropPlan(gate_name=gate_name, column=pos.column,
                        targets=tuple(targets),
                        needs_target_dialog=(k > 1), valid=free,
                        reason="" if free else "cell occupied")

    def commit_drop(self, plan: DropPlan,
                    targets: tuple[int, ...] | None = None,
                    params: list[float] | None = None) -> bool:
        """Place the planned gate through the undo stack."""
        if not plan.valid and targets is None:
            return False
        final_targets = list(targets if targets is not None
                             else plan.targets)
        if len(set(final_targets)) != len(final_targets):
            return False
        if not self.cell_free(plan.column, final_targets):
            return False
        gd = self.registry.get(plan.gate_name)
        if params is None:
            params = [0.0] * gd.num_params
        self.controller.add_gate(plan.gate_name, final_targets,
                                 list(params), plan.column)
        return True

    # -- drag-to-move -----------------------------------------------------
    def plan_move(self, gate: GateInstance, x: float, y: float
                  ) -> tuple[int, tuple[int, ...]] | None:
        """(new_column, new_targets) for dropping ``gate``'s TOPMOST
        (minimum) target at scene point (x, y) — the scene draws the
        item's origin at min(targets), so the anchor must match — with
        qubit spacing preserved; None when out of range or colliding."""
        pos = self.snap(x, y)
        if pos is None:
            return None
        dq = pos.qubit - min(gate.target_qubits)
        new_targets = tuple(q + dq for q in gate.target_qubits)
        n = self.circuit.num_qubits
        if not all(0 <= q < n for q in new_targets):
            return None
        if not self.cell_free(pos.column, new_targets, exclude=gate):
            return None
        return pos.column, new_targets

    def commit_move(self, gate: GateInstance, column: int,
                    targets: tuple[int, ...]) -> bool:
        if (column, tuple(targets)) == (gate.column,
                                        tuple(gate.target_qubits)):
            return False
        self.controller.move_gate(gate, column, list(targets))
        return True

    # -- selection / deletion ----------------------------------------------
    def hit_test(self, x: float, y: float) -> GateInstance | None:
        pos = self.snap(x, y)
        if pos is None:
            return None
        for g in self.circuit.gates:
            if g.column == pos.column and pos.qubit in g.target_qubits:
                return g
        return None

    def set_selection(self, gates) -> None:
        self.selected = list(gates)

    def delete_selection(self) -> int:
        if not self.selected:
            return 0
        count = len(self.selected)
        self.controller.remove_selected_gates(list(self.selected))
        self.selected = []
        return count

    # -- overlays -----------------------------------------------------------
    def toggle_breakpoint(self, column: int) -> bool:
        """Returns True if the column now has a breakpoint."""
        if column in self.breakpoints:
            self.breakpoints.discard(column)
            return False
        self.breakpoints.add(column)
        return True

    def set_debug_column(self, column: int | None) -> None:
        self.debug_column = column

    def toggle_initial_state(self, qubit: int) -> int:
        self.circuit.toggle_qubit_initial_state(qubit)
        self._emit_changed()
        return self.circuit.initial_states[qubit]

    # -- draw list -----------------------------------------------------------
    def wire_labels(self) -> list[tuple[int, str]]:
        return [(q, f"q{q}: |{self.circuit.initial_states[q]}⟩")
                for q in range(self.circuit.num_qubits)]

    def gate_visuals(self) -> list[GateVisual]:
        out = []
        for g in self.circuit.gates:
            gd = self.registry.get(g.gate_name)
            if gd.gate_type == GateType.BARRIER:
                kind = "barrier"
            elif gd.gate_type == GateType.MEASUREMENT:
                kind = "measure"
            elif g.gate_name == "SWAP":
                kind = "swap"
            elif gd.num_controls > 0 or gd.gate_type == GateType.CONTROLLED:
                kind = "controlled"
            else:
                kind = "single"
            out.append(GateVisual(
                gate=g, kind=kind, symbol=gd.symbol, color=gd.color,
                column=g.column, targets=tuple(g.target_qubits),
                num_controls=gd.num_controls))
        return out
