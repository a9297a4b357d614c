"""The port's circuit editor on the CPU: the toolkit-free model and the
Qt scene under the functional stubs.

Twin of ``tests/test_editor_model.py`` and
``tests/test_editor_scene_behavior.py`` for
``quantum_simulator_tpu_torch.gui.editor_model`` / ``editor_scene``, with
the same behaviour asserted: grid snapping, palette drops (default
multi-qubit targets, occupancy, dialog overrides), drag-to-move through
the undo stack, overlays and selection; the scene's drop / move / paint /
shortcut branches against real model mutations and recorded draw calls.
The editor runs no simulation and touches no device.
"""

import pytest

from quantum_simulator_tpu_torch.circuit import QuantumCircuit
from quantum_simulator_tpu_torch.controller import CircuitController
from quantum_simulator_tpu_torch.gui.editor_model import (
    COL_W,
    ROW_H,
    TOP_Y,
    WIRE_X0,
    CircuitEditorModel,
)
from tests import qt_stub, torch_gui_stubs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture()
def qt(monkeypatch):
    if not torch_gui_stubs.install_qt(monkeypatch):
        pytest.skip("real PyQt6 present; stub-behavior tests not needed")
    yield qt_stub
    torch_gui_stubs.purge()


# ---------------------------------------------------------------------------
# The model (no Qt)
# ---------------------------------------------------------------------------

@pytest.fixture()
def model():
    return CircuitEditorModel(CircuitController(QuantumCircuit(4)))


def scene_xy(model, column, qubit):
    return model.column_x(column), model.qubit_y(qubit)


class TestSnapping:
    def test_exact_grid_points(self, model):
        pos = model.snap(*scene_xy(model, 3, 2))
        assert (pos.column, pos.qubit) == (3, 2)

    def test_snaps_to_nearest(self, model):
        x = WIRE_X0 + 3 * COL_W + COL_W * 0.3
        y = TOP_Y + 2 * ROW_H - ROW_H * 0.3
        pos = model.snap(x, y)
        assert (pos.column, pos.qubit) == (3, 2)

    def test_outside_grid_is_none(self, model):
        assert model.snap(-200.0, TOP_Y) is None
        assert model.snap(WIRE_X0, TOP_Y + 100 * ROW_H) is None


class TestPaletteDrop:
    def test_single_qubit_drop_into_column_3(self, model):
        """The VERDICT acceptance: drag H from the palette into column 3
        and the model updates through the undo stack."""
        plan = model.plan_drop("H", *scene_xy(model, 3, 1))
        assert plan.valid and not plan.needs_target_dialog
        assert (plan.column, plan.targets) == (3, (1,))
        assert model.commit_drop(plan)
        gates = model.circuit.gates
        assert len(gates) == 1
        assert gates[0].gate_name == "H"
        assert gates[0].column == 3 and gates[0].target_qubits == [1]
        # through the undo stack:
        model.controller.undo()
        assert model.circuit.gates == []
        model.controller.redo()
        assert len(model.circuit.gates) == 1

    def test_multi_qubit_proposes_downward_targets(self, model):
        plan = model.plan_drop("CNOT", *scene_xy(model, 0, 1))
        assert plan.valid and plan.needs_target_dialog
        assert plan.targets == (1, 2)

    def test_multi_qubit_near_bottom_proposes_upward(self, model):
        plan = model.plan_drop("Toffoli", *scene_xy(model, 0, 3))
        assert plan.valid
        assert plan.targets == (3, 2, 1)

    def test_occupied_cell_invalid(self, model):
        first = model.plan_drop("X", *scene_xy(model, 2, 1))
        assert model.commit_drop(first)
        again = model.plan_drop("Y", *scene_xy(model, 2, 1))
        assert not again.valid and again.reason == "cell occupied"
        assert not model.commit_drop(again)

    def test_dialog_targets_override_proposal(self, model):
        plan = model.plan_drop("CNOT", *scene_xy(model, 1, 0))
        assert model.commit_drop(plan, targets=(0, 3))
        assert model.circuit.gates[0].target_qubits == [0, 3]

    def test_duplicate_dialog_targets_rejected(self, model):
        plan = model.plan_drop("CNOT", *scene_xy(model, 1, 0))
        assert not model.commit_drop(plan, targets=(2, 2))

    def test_gate_larger_than_circuit(self):
        m = CircuitEditorModel(CircuitController(QuantumCircuit(2)))
        plan = m.plan_drop("Toffoli", m.column_x(0), m.qubit_y(0))
        assert not plan.valid and "needs 3 qubits" in plan.reason

    def test_drop_outside_grid(self, model):
        plan = model.plan_drop("H", -500.0, -500.0)
        assert not plan.valid


class TestDragToMove:
    def test_move_snaps_and_commits_undoably(self, model):
        plan = model.plan_drop("H", *scene_xy(model, 0, 0))
        model.commit_drop(plan)
        gate = model.circuit.gates[0]
        move = model.plan_move(gate, *scene_xy(model, 5, 2))
        assert move == (5, (2,))
        assert model.commit_move(gate, *move)
        assert gate.column == 5 and gate.target_qubits == [2]
        model.controller.undo()
        assert gate.column == 0 and gate.target_qubits == [0]

    def test_move_preserves_multiqubit_spacing(self, model):
        plan = model.plan_drop("CNOT", *scene_xy(model, 0, 0))
        model.commit_drop(plan, targets=(0, 2))
        gate = model.circuit.gates[0]
        move = model.plan_move(gate, *scene_xy(model, 1, 1))
        assert move == (1, (1, 3))

    def test_move_out_of_range_is_none(self, model):
        plan = model.plan_drop("CNOT", *scene_xy(model, 0, 0))
        model.commit_drop(plan, targets=(0, 3))
        gate = model.circuit.gates[0]
        # shifting down by 1 pushes target 3 -> 4, out of a 4-qubit grid
        assert model.plan_move(gate, *scene_xy(model, 0, 1)) is None

    def test_move_onto_occupied_cell_is_none(self, model):
        model.commit_drop(model.plan_drop("X", *scene_xy(model, 2, 2)))
        model.commit_drop(model.plan_drop("H", *scene_xy(model, 0, 0)))
        h_gate = model.circuit.gates[1]
        assert model.plan_move(h_gate, *scene_xy(model, 2, 2)) is None

    def test_noop_move_not_committed(self, model):
        model.commit_drop(model.plan_drop("H", *scene_xy(model, 1, 1)))
        gate = model.circuit.gates[0]
        assert not model.commit_move(gate, 1, (1,))


class TestOverlaysAndSelection:
    def test_breakpoint_toggle(self, model):
        assert model.toggle_breakpoint(2) is True
        assert model.breakpoints == {2}
        assert model.toggle_breakpoint(2) is False
        assert model.breakpoints == set()

    def test_debug_column(self, model):
        model.set_debug_column(4)
        assert model.debug_column == 4
        model.set_debug_column(None)
        assert model.debug_column is None

    def test_hit_test(self, model):
        model.commit_drop(model.plan_drop("X", *scene_xy(model, 2, 1)))
        gate = model.hit_test(*scene_xy(model, 2, 1))
        assert gate is model.circuit.gates[0]
        assert model.hit_test(*scene_xy(model, 0, 0)) is None

    def test_delete_selection_undoable(self, model):
        model.commit_drop(model.plan_drop("X", *scene_xy(model, 0, 0)))
        model.commit_drop(model.plan_drop("Y", *scene_xy(model, 1, 1)))
        model.set_selection(list(model.circuit.gates))
        assert model.delete_selection() == 2
        assert model.circuit.gates == []
        model.controller.undo()
        model.controller.undo()
        assert len(model.circuit.gates) == 2

    def test_initial_state_toggle(self, model):
        assert model.toggle_initial_state(1) == 1
        assert model.wire_labels()[1] == (1, "q1: |1⟩")
        assert model.toggle_initial_state(1) == 0

    def test_gate_visual_kinds(self, model):
        model.commit_drop(model.plan_drop("H", *scene_xy(model, 0, 0)))
        model.commit_drop(
            model.plan_drop("CNOT", *scene_xy(model, 1, 0)), (0, 1))
        model.commit_drop(
            model.plan_drop("SWAP", *scene_xy(model, 2, 2)), (2, 3))
        kinds = [v.kind for v in model.gate_visuals()]
        assert kinds == ["single", "controlled", "swap"]

    def test_changed_callback_fires(self, model):
        fired = []
        model.on_changed(lambda: fired.append(1))
        model.commit_drop(model.plan_drop("H", *scene_xy(model, 0, 0)))
        assert fired


class TestReviewRegressions:
    def test_move_anchor_is_min_target(self, model):
        """A CNOT placed with control BELOW target (target_qubits=[1, 0])
        must move relative to its topmost qubit — the scene draws the item
        origin at min(targets)."""
        plan = model.plan_drop("CNOT", *scene_xy(model, 0, 1))
        assert model.commit_drop(plan, targets=(1, 0))
        gate = model.circuit.gates[0]
        # drop the item's top (qubit 0's row) onto qubit 2's row
        move = model.plan_move(gate, *scene_xy(model, 0, 2))
        assert move == (0, (3, 2))


# ---------------------------------------------------------------------------
# The Qt scene under the stubs
# ---------------------------------------------------------------------------

@pytest.fixture()
def scene_mod(qt):
    import quantum_simulator_tpu_torch.gui.editor_scene as es

    return es


class _Mime:
    def __init__(self, fmt, payload):
        self._fmt = fmt
        self._payload = payload

    def hasFormat(self, fmt):
        return fmt == self._fmt

    def data(self, fmt):
        return self._payload


class _DragEvent:
    def __init__(self, mime, x, y):
        self._mime = mime
        self._pos = (x, y)
        self.accepted = False

    def mimeData(self):
        return self._mime

    def scenePos(self):
        from tests.qt_stub import QPointF

        return QPointF(*self._pos)

    def acceptProposedAction(self):
        self.accepted = True


class _KeyEvent:
    def __init__(self, key, modifiers=0):
        self._key = key
        self._mods = modifiers

    def key(self):
        return self._key

    def modifiers(self):
        return self._mods


def _drop(scene, name, x, y):
    from quantum_simulator_tpu_torch.gui.editor_model import GATE_MIME_TYPE

    return _DragEvent(_Mime(GATE_MIME_TYPE, name.encode()), x, y)


class TestDragDrop:
    def test_single_qubit_drop_adds_gate(self, scene_mod):
        scene = scene_mod.CircuitScene()
        model = scene.model
        x = model.column_x(0)
        y = model.qubit_y(1)
        ev = _drop(scene, "H", x, y)
        scene.dropEvent(ev)
        assert ev.accepted
        gates = model.circuit.gates
        assert len(gates) == 1
        assert gates[0].gate_name == "H" and gates[0].target_qubits == [1]

    def test_drag_move_shows_indicator_and_leave_hides(self, scene_mod):
        scene = scene_mod.CircuitScene()
        model = scene.model
        ev = _drop(scene, "X", model.column_x(0), model.qubit_y(0))
        scene.dragMoveEvent(ev)
        assert scene._indicator is not None
        assert ev.accepted
        scene.dragLeaveEvent(None)
        assert scene._indicator is None

    def test_invalid_drop_occupied_cell(self, scene_mod):
        scene = scene_mod.CircuitScene()
        model = scene.model
        x, y = model.column_x(0), model.qubit_y(0)
        scene.dropEvent(_drop(scene, "H", x, y))
        before = len(model.circuit.gates)
        ev = _drop(scene, "X", x, y)   # same cell: occupied
        scene.dropEvent(ev)
        assert len(model.circuit.gates) == before
        assert not ev.accepted

    def test_multiqubit_drop_uses_dialog_targets(self, scene_mod,
                                                 monkeypatch):
        scene = scene_mod.CircuitScene()
        model = scene.model

        class _FakeDialog:
            def __init__(self, name, proposal, num_qubits, parent=None):
                self._proposal = proposal

            def exec(self):
                from tests.qt_stub import QDialog

                return QDialog.DialogCode.Accepted

            def targets(self):
                return (2, 0)   # override the proposal

        monkeypatch.setattr(scene_mod, "TargetDialog", _FakeDialog)
        ev = _drop(scene, "CNOT", model.column_x(0), model.qubit_y(1))
        scene.dropEvent(ev)
        gates = model.circuit.gates
        assert len(gates) == 1
        assert gates[0].gate_name == "CNOT"
        assert gates[0].target_qubits == [2, 0]

    def test_multiqubit_drop_cancelled_dialog(self, scene_mod,
                                              monkeypatch):
        scene = scene_mod.CircuitScene()
        model = scene.model

        class _Cancel:
            def __init__(self, *a, **k):
                pass

            def exec(self):
                from tests.qt_stub import QDialog

                return QDialog.DialogCode.Rejected

        monkeypatch.setattr(scene_mod, "TargetDialog", _Cancel)
        ev = _drop(scene, "CNOT", model.column_x(0), model.qubit_y(1))
        scene.dropEvent(ev)
        assert len(model.circuit.gates) == 0

    def test_target_dialog_builds_spins_from_proposal(self, scene_mod):
        dialog = scene_mod.TargetDialog("CNOT", (0, 1), 4)
        assert dialog.targets() == (0, 1)


class TestMoveCommit:
    def _scene_with_gate(self, scene_mod, name="H", q=0):
        scene = scene_mod.CircuitScene()
        model = scene.model
        scene.dropEvent(_drop(scene, name, model.column_x(0),
                              model.qubit_y(q)))
        item = next(it for it in scene.items()
                    if isinstance(it, scene_mod.GateItem))
        return scene, model, item

    def test_drag_to_new_cell_commits_through_model(self, scene_mod):
        from tests.qt_stub import QPointF

        from quantum_simulator_tpu_torch.gui.editor_model import (
            GATE_H,
            GATE_W,
        )

        scene, model, item = self._scene_with_gate(scene_mod)
        gate = item.gate
        item.mousePressEvent(None)
        # drag to column 2, qubit 3
        nx = model.column_x(2) - GATE_W / 2
        ny = model.qubit_y(3) - GATE_H / 2
        item.setPos(QPointF(nx, ny))
        item.mouseReleaseEvent(None)
        assert gate.column == 2
        assert gate.target_qubits == [3]

    def test_release_without_move_is_noop(self, scene_mod):
        scene, model, item = self._scene_with_gate(scene_mod)
        gate = item.gate
        col0, q0 = gate.column, list(gate.target_qubits)
        item.mousePressEvent(None)
        item.mouseReleaseEvent(None)   # no position change
        assert gate.column == col0 and gate.target_qubits == q0

    def test_invalid_move_snaps_back(self, scene_mod):
        from tests.qt_stub import QPointF

        scene, model, item = self._scene_with_gate(scene_mod)
        gate = item.gate
        item.mousePressEvent(None)
        item.setPos(QPointF(-5000.0, -5000.0))   # off the grid
        item.mouseReleaseEvent(None)
        assert gate.column == 0 and gate.target_qubits == [0]
        # rebuild() replaced the items: a fresh item sits at the old cell
        items = [it for it in scene.items()
                 if isinstance(it, scene_mod.GateItem)]
        assert len(items) == 1 and items[0].gate is gate


class TestPaintBranches:
    def _painted(self, scene_mod, name, targets):
        from tests.qt_stub import QPainter

        from quantum_simulator_tpu_torch.gui.editor_model import (
            CircuitEditorModel,
        )

        model = CircuitEditorModel()
        model.circuit.set_num_qubits(4)
        model.controller.add_gate(name, list(targets), [], 0)
        scene = scene_mod.CircuitScene(model)
        item = next(it for it in scene.items()
                    if isinstance(it, scene_mod.GateItem))
        painter = QPainter()
        item.paint(painter, None)
        return painter

    def test_controlled_cnot_draws_dot_and_oplus(self, scene_mod):
        p = self._painted(scene_mod, "CNOT", (0, 2))
        # 1 control dot + 1 target circle = 2 ellipses; the oplus cross
        # adds 2 lines on top of the spanning line
        assert p.count("ellipse") == 2
        assert p.count("line") == 3

    def test_cz_draws_two_dots(self, scene_mod):
        p = self._painted(scene_mod, "CZ", (0, 1))
        assert p.count("ellipse") == 2
        assert p.count("line") == 1   # just the spanning line

    def test_swap_draws_crosses(self, scene_mod):
        p = self._painted(scene_mod, "SWAP", (0, 3))
        assert p.count("line") == 1 + 4  # spanning line + 2 crosses

    def test_measure_draws_arc_and_needle(self, scene_mod):
        p = self._painted(scene_mod, "Measure", (1,))
        assert p.count("arc") == 1
        assert p.count("line") == 1

    def test_single_qubit_draws_symbol_text(self, scene_mod):
        p = self._painted(scene_mod, "H", (2,))
        assert p.count("text") == 1

    def test_barrier_draws_dashed_line(self, scene_mod):
        p = self._painted(scene_mod, "Barrier", (0,))
        assert p.count("line") == 1
        assert p.count("text") == 0

    def test_toffoli_two_controls(self, scene_mod):
        p = self._painted(scene_mod, "Toffoli", (0, 1, 3))
        # 2 control dots + 1 oplus circle
        assert p.count("ellipse") == 3


class TestSceneInteractions:
    def test_double_click_header_toggles_breakpoint(self, scene_mod):
        from tests.qt_stub import QPointF

        scene = scene_mod.CircuitScene()
        model = scene.model

        class _Ev:
            def scenePos(self):
                return QPointF(model.column_x(1), 0.0)

        scene.mouseDoubleClickEvent(_Ev())
        assert 1 in model.breakpoints
        scene.mouseDoubleClickEvent(_Ev())
        assert 1 not in model.breakpoints

    def test_double_click_gate_emits_activated(self, scene_mod):
        from tests.qt_stub import QPointF

        scene = scene_mod.CircuitScene()
        model = scene.model
        scene.dropEvent(_drop(scene, "Rx", model.column_x(0),
                              model.qubit_y(0)))
        seen = []
        scene.gate_activated.connect(seen.append)

        class _Ev:
            def scenePos(self):
                return QPointF(model.column_x(0), model.qubit_y(0))

        scene.mouseDoubleClickEvent(_Ev())
        assert len(seen) == 1 and seen[0].gate_name == "Rx"

    def test_delete_key_removes_selection(self, scene_mod):
        from tests.qt_stub import Qt

        scene = scene_mod.CircuitScene()
        model = scene.model
        scene.dropEvent(_drop(scene, "H", model.column_x(0),
                              model.qubit_y(0)))
        item = next(it for it in scene.items()
                    if isinstance(it, scene_mod.GateItem))
        item.setSelected(True)
        scene._on_selection()
        scene.keyPressEvent(_KeyEvent(Qt.Key.Key_Delete))
        assert len(model.circuit.gates) == 0

    def test_wire_label_click_toggles_initial_state(self, scene_mod):
        from tests.qt_stub import QPointF

        scene = scene_mod.CircuitScene()
        model = scene.model
        view = scene_mod.CircuitEditorView(scene)  # registers as a view
        label = next(it for it in scene.items()
                     if it.data(0) and it.data(0)[0] == "wire-label")
        scene._test_item_at = label

        class _Ev:
            def scenePos(self):
                return QPointF(8.0, model.qubit_y(label.data(0)[1]))

        q = label.data(0)[1]
        assert model.circuit.initial_states[q] == 0
        scene.mousePressEvent(_Ev())
        assert model.circuit.initial_states[q] == 1

    def test_breakpoint_and_debug_column_render(self, scene_mod):
        scene = scene_mod.CircuitScene()
        model = scene.model
        model.toggle_breakpoint(0)
        model.set_debug_column(1)
        scene.rebuild()
        kinds = [getattr(it, "kind", None) for it in scene.items()]
        assert "rect" in kinds    # debug column highlight
        assert kinds.count("line") > model.circuit.num_qubits  # + bp line


class TestViewShortcuts:
    def _view(self, scene_mod):
        scene = scene_mod.CircuitScene()
        return scene, scene_mod.CircuitEditorView(scene)

    def test_ctrl_wheel_zoom_clamps(self, scene_mod):
        from tests.qt_stub import Qt

        scene, view = self._view(scene_mod)

        class _Wheel:
            def __init__(self, dy):
                self._dy = dy

            def modifiers(self):
                return Qt.KeyboardModifier.ControlModifier

            def angleDelta(self):
                class _D:
                    def __init__(self, dy):
                        self._dy = dy

                    def y(self):
                        return self._dy

                return _D(self._dy)

        for _ in range(40):
            view.wheelEvent(_Wheel(120))
        assert view._zoom == pytest.approx(view.MAX_ZOOM)
        for _ in range(80):
            view.wheelEvent(_Wheel(-120))
        assert view._zoom == pytest.approx(view.MIN_ZOOM)

    def test_ctrl_z_y_route_to_controller(self, scene_mod):
        from tests.qt_stub import Qt

        scene, view = self._view(scene_mod)
        model = scene.model
        scene.dropEvent(_drop(scene, "H", model.column_x(0),
                              model.qubit_y(0)))
        assert len(model.circuit.gates) == 1
        view.keyPressEvent(_KeyEvent(
            Qt.Key.Key_Z, Qt.KeyboardModifier.ControlModifier))
        assert len(model.circuit.gates) == 0
        view.keyPressEvent(_KeyEvent(
            Qt.Key.Key_Y, Qt.KeyboardModifier.ControlModifier))
        assert len(model.circuit.gates) == 1

    def test_ctrl_a_selects_all_and_ctrl_0_resets(self, scene_mod):
        from tests.qt_stub import Qt

        scene, view = self._view(scene_mod)
        model = scene.model
        scene.dropEvent(_drop(scene, "H", model.column_x(0),
                              model.qubit_y(0)))
        scene.dropEvent(_drop(scene, "X", model.column_x(1),
                              model.qubit_y(1)))
        view.keyPressEvent(_KeyEvent(
            Qt.Key.Key_A, Qt.KeyboardModifier.ControlModifier))
        sel = [it for it in scene.selectedItems()
               if isinstance(it, scene_mod.GateItem)]
        assert len(sel) == 2
        view.keyPressEvent(_KeyEvent(
            Qt.Key.Key_0, Qt.KeyboardModifier.ControlModifier))
        assert view._zoom == 1.0 and "reset" in view.scaled
