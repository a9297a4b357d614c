"""EfficientSU2 (Qiskit circuit library; the hardware-efficient ansatz of
Kandala et al., Nature 549, 242 (2017)) as a circuit dict, NumPy only.

Layout as Qiskit's ``EfficientSU2(n, su2_gates, entanglement, reps)``:
``reps`` times a rotation layer and an entangling layer, then a final
rotation layer. A rotation layer applies each of ``su2_gates`` to every
qubit in turn (``ry`` on qubits 0..n-1, then ``rz`` on 0..n-1); the
``linear`` entangling layer is CX(0, 1), CX(1, 2), ..., CX(n-2, n-1), each
in its own column. Parameter k of the circuit (Qiskit's ``θ[k]``) is the
k-th rotation in that order, drawn uniform on [0, 2π) from ``rng``.
Qubit 0 is the most significant bit of the simulator's basis index, where
Qiskit's qubit 0 is the least: the gates are the same, the bitstrings read
reversed.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = {"ry": "Ry", "rz": "Rz"}


def num_params(config: dict) -> int:
    return (len(config["su2_gates"]) * config["num_qubits"]
            * (config["reps"] + 1))


def layout(config: dict) -> list[tuple[str, tuple[int, ...], int, int]]:
    """(gate, targets, column, parameter index or -1) in circuit order."""
    n, reps = config["num_qubits"], config["reps"]
    if config["entanglement"] != "linear":
        raise ValueError("only linear entanglement is built")
    out, col, k = [], 0, 0
    for layer in range(reps + 1):
        for g in config["su2_gates"]:
            for q in range(n):
                out.append((_ROTATIONS[g], (q,), col, k))
                k += 1
            col += 1
        if layer < reps:
            for q in range(n - 1):
                out.append(("CNOT", (q, q + 1), col, -1))
                col += 1
    return out


def circuit(config: dict, rng: np.random.Generator) -> dict:
    """The circuit dict with fresh angles from ``rng``."""
    angles = rng.uniform(0.0, 2.0 * np.pi, num_params(config))
    gates = [{"name": name, "targets": list(t),
              "params": [float(angles[k])] if k >= 0 else [],
              "column": col}
             for name, t, col, k in layout(config)]
    return {"version": "1.0", "num_qubits": config["num_qubits"],
            "gates": gates}
