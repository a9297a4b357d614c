"""Parameterized circuit ansätze (variational model zoo).

Counterpart of ``quantum_simulator_tpu/models/ansatz.py``: the same
circuits, gate for gate (hardware-efficient, QAOA MaxCut, random
brickwork), built as the port's ``QuantumCircuit``.
"""

from __future__ import annotations

import numpy as np

from ..circuit import GateInstance, QuantumCircuit


def hardware_efficient_ansatz(num_qubits: int, num_layers: int,
                              rotation: str = "Ry",
                              initial_angle: float = 0.0) -> QuantumCircuit:
    """Rotation layers + linear CNOT entangler chains + a final rotation
    layer — ``num_qubits * (num_layers + 1)`` parameters."""
    c = QuantumCircuit(num_qubits)
    col = 0
    for _ in range(num_layers):
        for q in range(num_qubits):
            c.add_gate(GateInstance(rotation, [q], [initial_angle],
                                    column=col))
        col += 1
        for q in range(num_qubits - 1):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
            col += 1
    for q in range(num_qubits):
        c.add_gate(GateInstance(rotation, [q], [initial_angle], column=col))
    return c


def qaoa_maxcut_ansatz(num_qubits: int, p_layers: int,
                       edges: list[tuple[int, int]] | None = None,
                       gamma: float = 0.1,
                       beta: float = 0.1) -> QuantumCircuit:
    """Standard QAOA: |+>^n then p alternating cost (ZZ phase per edge via
    CNOT-Rz-CNOT) and mixer (Rx) layers — 2p parameter groups."""
    if edges is None:
        edges = [(i, (i + 1) % num_qubits) for i in range(num_qubits)]
    c = QuantumCircuit(num_qubits)
    col = 0
    for q in range(num_qubits):
        c.add_gate(GateInstance("H", [q], [], column=col))
    col += 1
    for _ in range(p_layers):
        for i, j in edges:
            c.add_gate(GateInstance("CNOT", [i, j], [], column=col))
            col += 1
            c.add_gate(GateInstance("Rz", [j], [2 * gamma], column=col))
            col += 1
            c.add_gate(GateInstance("CNOT", [i, j], [], column=col))
            col += 1
        for q in range(num_qubits):
            c.add_gate(GateInstance("Rx", [q], [2 * beta], column=col))
        col += 1
    return c


def brickwork_circuit(num_qubits: int, depth: int,
                      seed: int | None = None) -> QuantumCircuit:
    """Random brickwork: alternating random-Ry columns and staggered CNOT
    brick columns (the benchmark workload family)."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(num_qubits)
    for col in range(depth):
        if col % 2 == 0:
            for q in range(num_qubits):
                c.add_gate(GateInstance(
                    "Ry", [q], [float(rng.uniform(0, 2 * np.pi))],
                    column=col))
        else:
            offset = (col // 2) % 2
            for q in range(offset, num_qubits - 1, 2):
                c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
    return c
