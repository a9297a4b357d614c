"""Singleton gate registry.

Counterpart of ``quantum_simulator_tpu/registry.py:62-223``: every built-in
gate, runtime-registrable custom gates, and the on-demand ``MCZ<k>``
family (dense up to k = 10, a matrix-less controlled phase above). The
``ExpP[...]`` Trotter gates come with the port of ``models/``.
"""

from __future__ import annotations

import re

from .gates import (
    CNOT_MATRIX,
    CZ_MATRIX,
    FREDKIN_MATRIX,
    GateDefinition,
    GateType,
    H_MATRIX,
    I_MATRIX,
    PARAM_BUILDERS,
    S_DAG_MATRIX,
    S_MATRIX,
    SWAP_MATRIX,
    T_DAG_MATRIX,
    T_MATRIX,
    TOFFOLI_MATRIX,
    X_MATRIX,
    Y_MATRIX,
    Z_MATRIX,
    _const,
    cphase_matrix,
    mcz_matrix,
    phase_matrix,
    rx_matrix,
    ry_matrix,
    rz_matrix,
    u3_matrix,
)


def _single(name, display, mat, symbol, color):
    return GateDefinition(
        name=name, display_name=display, gate_type=GateType.SINGLE,
        num_qubits=1, num_params=0, param_names=(),
        matrix_func=_const(mat), symbol=symbol, color=color,
    )


def _param(name, display, func, n_params, param_names, symbol, color):
    return GateDefinition(
        name=name, display_name=display, gate_type=GateType.SINGLE,
        num_qubits=1, num_params=n_params, param_names=param_names,
        matrix_func=func, symbol=symbol, color=color,
        param_builder=PARAM_BUILDERS.get(name),
    )


class GateRegistry:
    """Singleton registry mapping gate names to GateDefinition objects."""

    _instance: GateRegistry | None = None

    def __init__(self):
        self._gates: dict[str, GateDefinition] = {}

    @classmethod
    def instance(cls) -> GateRegistry:
        if cls._instance is None:
            cls._instance = cls()
            cls._instance._register_builtins()
        return cls._instance

    @classmethod
    def reset(cls):
        """Reset the singleton (for testing)."""
        cls._instance = None

    def _register_builtins(self):
        for args in [
            ("I", "Identity", I_MATRIX, "I", "#888888"),
            ("H", "Hadamard", H_MATRIX, "H", "#4A90D9"),
            ("X", "Pauli-X", X_MATRIX, "X", "#E74C3C"),
            ("Y", "Pauli-Y", Y_MATRIX, "Y", "#2ECC71"),
            ("Z", "Pauli-Z", Z_MATRIX, "Z", "#3498DB"),
            ("S", "S Gate", S_MATRIX, "S", "#9B59B6"),
            ("S_DAG", "S† Gate", S_DAG_MATRIX, "S†", "#8E44AD"),
            ("T", "T Gate", T_MATRIX, "T", "#E67E22"),
            ("T_DAG", "T† Gate", T_DAG_MATRIX, "T†", "#D35400"),
        ]:
            self.register(_single(*args))

        self.register(_param("Rx", "Rotation-X", rx_matrix, 1, ("θ",), "Rx", "#E91E63"))
        self.register(_param("Ry", "Rotation-Y", ry_matrix, 1, ("θ",), "Ry", "#00BCD4"))
        self.register(_param("Rz", "Rotation-Z", rz_matrix, 1, ("θ",), "Rz", "#FF9800"))
        self.register(_param("Phase", "Phase Gate", phase_matrix, 1, ("φ",), "P", "#795548"))
        self.register(
            _param("U3", "Universal U3", u3_matrix, 3,
                   ("θ", "φ", "λ"), "U3", "#607D8B")
        )

        self.register(GateDefinition(
            name="CPhase", display_name="Controlled-Phase",
            gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=1, param_names=("φ",),
            matrix_func=cphase_matrix, symbol="CP", color="#5D4037",
            num_controls=1, num_targets=1,
            param_builder=PARAM_BUILDERS["CPhase"]))
        self.register(GateDefinition(
            name="CNOT", display_name="Controlled-NOT", gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(CNOT_MATRIX), symbol="CX", color="#FF5722",
            num_controls=1, num_targets=1))
        self.register(GateDefinition(
            name="CZ", display_name="Controlled-Z", gate_type=GateType.CONTROLLED,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(CZ_MATRIX), symbol="CZ", color="#673AB7",
            num_controls=1, num_targets=1))
        self.register(GateDefinition(
            name="SWAP", display_name="SWAP", gate_type=GateType.MULTI,
            num_qubits=2, num_params=0, param_names=(),
            matrix_func=_const(SWAP_MATRIX), symbol="SW", color="#009688",
            num_controls=0, num_targets=2))
        self.register(GateDefinition(
            name="Toffoli", display_name="Toffoli (CCX)", gate_type=GateType.CONTROLLED,
            num_qubits=3, num_params=0, param_names=(),
            matrix_func=_const(TOFFOLI_MATRIX), symbol="CCX", color="#F44336",
            num_controls=2, num_targets=1))
        self.register(GateDefinition(
            name="Fredkin", display_name="Fredkin (CSWAP)", gate_type=GateType.CONTROLLED,
            num_qubits=3, num_params=0, param_names=(),
            matrix_func=_const(FREDKIN_MATRIX), symbol="CSW", color="#4CAF50",
            num_controls=1, num_targets=2))

        self.register(GateDefinition(
            name="Measure", display_name="Measurement", gate_type=GateType.MEASUREMENT,
            num_qubits=1, num_params=0, param_names=(),
            matrix_func=_const(I_MATRIX), symbol="M", color="#FFC107"))
        self.register(GateDefinition(
            name="Barrier", display_name="Barrier", gate_type=GateType.BARRIER,
            num_qubits=1, num_params=0, param_names=(),
            matrix_func=_const(I_MATRIX), symbol="||", color="#BDBDBD"))

    def register(self, gate_def: GateDefinition):
        self._gates[gate_def.name] = gate_def

    def get(self, name: str) -> GateDefinition:
        if name not in self._gates:
            # MCZ_k gates are synthesized on demand so circuits saved with
            # them (Grover) deserialize in a fresh process.
            m = re.fullmatch(r"MCZ(\d+)", name)
            k = int(m.group(1)) if m else 0
            if 2 <= k <= 10:
                self.register(GateDefinition(
                    name=name,
                    display_name=f"Multi-Controlled-Z ({k})",
                    gate_type=GateType.CONTROLLED, num_qubits=k,
                    num_params=0, param_names=(),
                    matrix_func=_const(mcz_matrix(k)),
                    symbol="MCZ", color="#455A64",
                    num_controls=k - 1, num_targets=1))
                return self._gates[name]
            if 10 < k <= 32:
                # The dense 2^k x 2^k matrix is unaffordable: the
                # definition carries only the controlled phase, applied
                # as a bit-mask elementwise pass.
                def _no_matrix(*_a, _k=k):
                    raise MemoryError(
                        f"MCZ{_k} has no dense matrix (2^{_k} x 2^{_k}); "
                        "it is applied as an elementwise phase pass")

                self.register(GateDefinition(
                    name=name,
                    display_name=f"Multi-Controlled-Z ({k})",
                    gate_type=GateType.CONTROLLED, num_qubits=k,
                    num_params=0, param_names=(),
                    matrix_func=_no_matrix,
                    symbol="MCZ", color="#455A64",
                    num_controls=k - 1, num_targets=1,
                    cphase_value=-1.0 + 0.0j))
                return self._gates[name]
            raise KeyError(f"Gate '{name}' not found in registry")
        return self._gates[name]
