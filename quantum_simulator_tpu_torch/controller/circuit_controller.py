"""Circuit edit controller: every mutation goes through the undo stack.

A copy of ``quantum_simulator_tpu/controller/circuit_controller.py``:
add/remove/move/update-params/set-qubit-count/clear/load-template routed
through an undo stack, the template builder map over the port's
``AlgorithmTemplate``, and a circuit-changed notification. Qt-free:
``on_circuit_changed`` is a plain callback list a GUI can bind to.
"""

from __future__ import annotations

from typing import Callable

from ..algorithms import AlgorithmTemplate
from ..circuit import GateInstance, QuantumCircuit
from ..registry import GateRegistry
from .commands import (
    AddGateCommand,
    ClearCircuitCommand,
    LoadTemplateCommand,
    MoveGateCommand,
    RemoveGateCommand,
    SetQubitCountCommand,
    UndoStack,
    UpdateGateParamsCommand,
)


class CircuitController:
    """Owns a QuantumCircuit and an undo stack; notifies observers."""

    def __init__(self, circuit: QuantumCircuit | None = None):
        self._circuit = circuit if circuit is not None else QuantumCircuit(4)
        self._observers: list[Callable[[], None]] = []
        self._undo_stack = UndoStack(on_change=self._emit_changed)
        self._registry = GateRegistry.instance()

    # --- observation ----------------------------------------------------

    def on_circuit_changed(self, callback: Callable[[], None]) -> None:
        self._observers.append(callback)

    def _emit_changed(self) -> None:
        for cb in self._observers:
            cb()

    # --- circuit access ---------------------------------------------------

    @property
    def circuit(self) -> QuantumCircuit:
        return self._circuit

    @circuit.setter
    def circuit(self, new_circuit: QuantumCircuit) -> None:
        self._circuit = new_circuit
        self._undo_stack.clear()
        self._emit_changed()

    @property
    def undo_stack(self) -> UndoStack:
        return self._undo_stack

    # --- edits -----------------------------------------------------------

    def add_gate(self, gate_name: str, target_qubits: list[int],
                 params: list[float] | None = None,
                 column: int = 0) -> GateInstance:
        gate_def = self._registry.get(gate_name)  # validates name
        if params is None:
            params = [0.0] * gate_def.num_params
        gate = GateInstance(gate_name, list(target_qubits), list(params),
                            column)
        self._undo_stack.push(AddGateCommand(self._circuit, gate))
        return gate

    def remove_gate(self, gate: GateInstance) -> None:
        self._undo_stack.push(RemoveGateCommand(self._circuit, gate))

    def remove_selected_gates(self, gates: list[GateInstance]) -> None:
        for gate in gates:
            if gate in self._circuit.gates:
                self._undo_stack.push(RemoveGateCommand(self._circuit, gate))

    def move_gate(self, gate: GateInstance, new_column: int,
                  new_targets: list[int]) -> None:
        self._undo_stack.push(
            MoveGateCommand(self._circuit, gate, new_column, new_targets))

    def update_gate_params(self, gate: GateInstance,
                           new_params: list[float]) -> None:
        self._undo_stack.push(
            UpdateGateParamsCommand(self._circuit, gate, new_params))

    def set_qubit_count(self, count: int) -> None:
        self._undo_stack.push(SetQubitCountCommand(self._circuit, count))

    def clear_circuit(self) -> None:
        self._undo_stack.push(ClearCircuitCommand(self._circuit))

    def load_template(self, template_name: str, **kwargs) -> None:
        template = self._build_template(template_name, **kwargs)
        self._undo_stack.push(
            LoadTemplateCommand(self._circuit, template, template_name))

    @staticmethod
    def _build_template(template_name: str, **kwargs) -> QuantumCircuit:
        builders = {
            "bell_state": AlgorithmTemplate.bell_state,
            "ghz_state": lambda: AlgorithmTemplate.ghz_state(
                kwargs.get("num_qubits", 3)),
            "qft": lambda: AlgorithmTemplate.quantum_fourier_transform(
                kwargs.get("num_qubits", 3)),
            "inverse_qft": lambda: AlgorithmTemplate.inverse_qft(
                kwargs.get("num_qubits", 3)),
            "grover": lambda: AlgorithmTemplate.grover_search(
                kwargs.get("num_qubits", 3),
                kwargs.get("marked_state", 0)),
            "deutsch_jozsa": lambda: AlgorithmTemplate.deutsch_jozsa(
                kwargs.get("num_qubits", 3),
                kwargs.get("oracle_type", "balanced")),
            "teleportation": AlgorithmTemplate.quantum_teleportation,
            "bernstein_vazirani": lambda: AlgorithmTemplate.bernstein_vazirani(
                kwargs.get("secret", "101")),
            "superdense_coding": AlgorithmTemplate.superdense_coding,
            "tfim_quench": lambda: AlgorithmTemplate.tfim_quench(
                kwargs.get("num_qubits", 4),
                kwargs.get("time", 1.0),
                kwargs.get("steps")),
        }
        builder = builders.get(template_name)
        if builder is None:
            raise ValueError(f"Unknown template: {template_name}")
        if template_name == "bell_state":
            return builder(kwargs.get("qubit0", 0), kwargs.get("qubit1", 1))
        return builder()

    # --- undo/redo ---------------------------------------------------------

    def undo(self) -> None:
        self._undo_stack.undo()

    def redo(self) -> None:
        self._undo_stack.redo()

    def can_undo(self) -> bool:
        return self._undo_stack.can_undo()

    def can_redo(self) -> bool:
        return self._undo_stack.can_redo()
