"""MVC controller layer: undoable circuit edits + async simulation runs.

Counterpart of ``quantum_simulator_tpu/controller/``. Framework-agnostic
(no Qt): the undo stack and the worker thread use plain Python, with
callback hooks a GUI toolkit can bind signals to, so every edit/undo/redo
path is unit-testable headless. Simulations run on the controller's device
(default ``CONFIG.device``, the card).
"""

from .commands import (
    AddGateCommand,
    ClearCircuitCommand,
    Command,
    LoadTemplateCommand,
    MoveGateCommand,
    RemoveGateCommand,
    SetQubitCountCommand,
    UndoStack,
    UpdateGateParamsCommand,
)
from .circuit_controller import CircuitController
from .simulation_controller import SimulationController

__all__ = [
    "AddGateCommand",
    "CircuitController",
    "ClearCircuitCommand",
    "Command",
    "LoadTemplateCommand",
    "MoveGateCommand",
    "RemoveGateCommand",
    "SetQubitCountCommand",
    "SimulationController",
    "UndoStack",
    "UpdateGateParamsCommand",
]
