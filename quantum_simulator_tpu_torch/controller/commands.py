"""Undoable circuit-edit commands + a toolkit-independent undo stack.

A copy of ``quantum_simulator_tpu/controller/commands.py``: the 7 command
classes (Add/Remove/Move/UpdateParams/SetQubitCount/Clear/LoadTemplate) on
a plain-Python ``UndoStack``, so the edit history is testable without a
GUI toolkit.
"""

from __future__ import annotations

from typing import Callable

from ..circuit import GateInstance, QuantumCircuit


class Command:
    """One undoable edit. Subclasses implement redo() and undo()."""

    text: str = ""

    def redo(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def undo(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class UndoStack:
    """Linear undo/redo history. ``push`` executes the command."""

    def __init__(self, on_change: Callable[[], None] | None = None):
        self._done: list[Command] = []
        self._undone: list[Command] = []
        self._on_change = on_change

    def _notify(self):
        if self._on_change is not None:
            self._on_change()

    def push(self, command: Command) -> None:
        command.redo()
        self._done.append(command)
        self._undone.clear()
        self._notify()

    def undo(self) -> None:
        if self._done:
            cmd = self._done.pop()
            cmd.undo()
            self._undone.append(cmd)
            self._notify()

    def redo(self) -> None:
        if self._undone:
            cmd = self._undone.pop()
            cmd.redo()
            self._done.append(cmd)
            self._notify()

    def can_undo(self) -> bool:
        return bool(self._done)

    def can_redo(self) -> bool:
        return bool(self._undone)

    def clear(self) -> None:
        self._done.clear()
        self._undone.clear()
        self._notify()

    @property
    def undo_text(self) -> str:
        return self._done[-1].text if self._done else ""

    @property
    def redo_text(self) -> str:
        return self._undone[-1].text if self._undone else ""


class AddGateCommand(Command):
    def __init__(self, circuit: QuantumCircuit, gate: GateInstance):
        self._circuit = circuit
        self._gate = gate
        self.text = f"Add {gate.gate_name}"

    def redo(self) -> None:
        self._circuit.add_gate(self._gate)

    def undo(self) -> None:
        self._circuit.remove_gate(self._gate)


class RemoveGateCommand(Command):
    def __init__(self, circuit: QuantumCircuit, gate: GateInstance):
        self._circuit = circuit
        self._gate = gate
        self.text = f"Remove {gate.gate_name}"

    def redo(self) -> None:
        self._circuit.remove_gate(self._gate)

    def undo(self) -> None:
        self._circuit.add_gate(self._gate)


class MoveGateCommand(Command):
    def __init__(self, circuit: QuantumCircuit, gate: GateInstance,
                 new_column: int, new_targets: list[int]):
        self._circuit = circuit
        self._gate = gate
        self._new = (new_column, list(new_targets))
        self._old = (gate.column, list(gate.target_qubits))
        self.text = f"Move {gate.gate_name}"

    def redo(self) -> None:
        self._circuit.move_gate(self._gate, self._new[0], self._new[1])

    def undo(self) -> None:
        self._circuit.move_gate(self._gate, self._old[0], self._old[1])


class UpdateGateParamsCommand(Command):
    def __init__(self, circuit: QuantumCircuit, gate: GateInstance,
                 new_params: list[float]):
        self._gate = gate
        self._new = list(new_params)
        self._old = list(gate.params)
        self.text = f"Edit {gate.gate_name} params"

    def redo(self) -> None:
        self._gate.params = list(self._new)

    def undo(self) -> None:
        self._gate.params = list(self._old)


class SetQubitCountCommand(Command):
    def __init__(self, circuit: QuantumCircuit, count: int):
        self._circuit = circuit
        self._count = count
        self._old_count = circuit.num_qubits
        self._old_gates = list(circuit.gates)
        self._old_initial = list(circuit.initial_states)
        self.text = f"Set qubits to {count}"

    def redo(self) -> None:
        self._circuit.set_num_qubits(self._count)

    def undo(self) -> None:
        self._circuit.num_qubits = self._old_count
        self._circuit.gates = list(self._old_gates)
        self._circuit.initial_states = list(self._old_initial)


class ClearCircuitCommand(Command):
    def __init__(self, circuit: QuantumCircuit):
        self._circuit = circuit
        self._old_gates = list(circuit.gates)
        self.text = "Clear circuit"

    def redo(self) -> None:
        self._circuit.clear()

    def undo(self) -> None:
        self._circuit.gates = list(self._old_gates)


class LoadTemplateCommand(Command):
    def __init__(self, circuit: QuantumCircuit, template: QuantumCircuit,
                 name: str):
        self._circuit = circuit
        self._template = template
        self._old_qubits = circuit.num_qubits
        self._old_gates = list(circuit.gates)
        self._old_initial = list(circuit.initial_states)
        self.text = f"Load template {name}"

    def redo(self) -> None:
        self._circuit.num_qubits = self._template.num_qubits
        self._circuit.initial_states = list(self._template.initial_states)
        self._circuit.gates = [
            GateInstance(g.gate_name, list(g.target_qubits), list(g.params),
                         g.column)
            for g in self._template.gates
        ]

    def undo(self) -> None:
        self._circuit.num_qubits = self._old_qubits
        self._circuit.gates = list(self._old_gates)
        self._circuit.initial_states = list(self._old_initial)
