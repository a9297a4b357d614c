"""Circuit file serialization (.qsim / .json / .qasm).

Counterpart of ``quantum_simulator_tpu/utils/serialization.py``: the same
file format (version "1.0", same key names, ``initial_states`` omitted
when all zero), so a file written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..circuit import QuantumCircuit


class CircuitSerializer:
    """JSON save/load for quantum circuits.

    ``.qasm`` paths route through :mod:`..qasm` (OpenQASM 2.0), so
    existing QASM files open directly in the editor / scripts.
    """

    FILE_VERSION = "1.0"
    FILE_EXTENSION = ".qsim"
    QASM_EXTENSION = ".qasm"

    @staticmethod
    def save(circuit: QuantumCircuit, filepath: Path | str) -> None:
        filepath = Path(filepath)
        if filepath.suffix.lower() == CircuitSerializer.QASM_EXTENSION:
            from ..qasm import to_qasm
            filepath.write_text(to_qasm(circuit), encoding="utf-8")
            return
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(circuit.to_dict(), f, indent=2, ensure_ascii=False)

    @staticmethod
    def load(filepath: Path | str) -> QuantumCircuit:
        filepath = Path(filepath)
        if filepath.suffix.lower() == CircuitSerializer.QASM_EXTENSION:
            from ..qasm import from_qasm
            return from_qasm(filepath.read_text(encoding="utf-8"))
        with open(filepath, "r", encoding="utf-8") as f:
            return QuantumCircuit.from_dict(json.load(f))
