"""Circuit -> ordered op list + parameter vector.

Counterpart of ``quantum_simulator_tpu/ops/program.py``: ``ProgramOp``,
``CircuitProgram`` and ``compile_circuit`` (``program.py:41-158``). The
port runs eagerly and has no per-structure compile, so ``forward_fn``
always routes to the group executor (``ops/plan.py``) at every n; the JAX
package routes there only on a TPU (``program.py:342``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..gates import GateType
from ..registry import GateRegistry
from .apply import basis_state_index


@dataclass(frozen=True)
class ProgramOp:
    """One unitary in execution order (Measure/Barrier already dropped)."""

    gate_name: str
    targets: tuple[int, ...]
    param_offset: int
    num_params: int
    column_index: int  # index into the circuit's non-empty-column sequence
    static_matrix: np.ndarray | None  # baked matrix of a fixed gate
    builder: Callable | None          # matrix builder of a parameterized gate
    gate_index: int = -1              # index into circuit.gates
    # Controlled-phase-form diagonal too wide to materialize (MCZ_k,
    # k > 10): diag = ones except the all-targets-set entry = v.
    cphase_value: complex | None = None


@dataclass(frozen=True)
class CircuitProgram:
    num_qubits: int
    initial_index: int
    ops: tuple[ProgramOp, ...]
    num_columns: int
    num_params: int
    initial_params: np.ndarray
    compile_key: tuple

    def op_matrix(self, op: ProgramOp, params, dtype=np.complex64
                  ) -> np.ndarray:
        """Host NumPy matrix of ``op`` at the parameter vector ``params``."""
        if op.cphase_value is not None:
            raise NotImplementedError(
                f"{op.gate_name} on {len(op.targets)} qubits has no dense "
                "matrix; executors apply it as a DiagProductStep")
        if op.static_matrix is not None:
            return np.asarray(op.static_matrix, dtype=dtype)
        p = [float(params[op.param_offset + j]) for j in range(op.num_params)]
        return np.asarray(op.builder(*p)).astype(dtype)


def compile_circuit(circuit) -> CircuitProgram:
    """Lower a QuantumCircuit to an ordered static op list + param vector
    (``quantum_simulator_tpu/ops/program.py:95-158``)."""
    registry = GateRegistry.instance()
    ops: list[ProgramOp] = []
    params: list[float] = []
    key_parts: list = [circuit.num_qubits, tuple(circuit.initial_states)]

    gate_ids = {id(g): gi for gi, g in enumerate(circuit.gates)}
    columns = circuit.get_ordered_gates()
    for col_idx, column in enumerate(columns):
        for inst in column:
            gd = registry.get(inst.gate_name)
            if gd.gate_type in (GateType.MEASUREMENT, GateType.BARRIER):
                continue
            gate_index = gate_ids.get(id(inst), -1)
            targets = tuple(inst.target_qubits)
            if gd.num_params > 0 and gd.param_builder is not None:
                if len(inst.params) != gd.num_params:
                    raise ValueError(
                        f"{inst.gate_name} takes {gd.num_params} "
                        f"parameter(s), got {len(inst.params)}")
                offset = len(params)
                params.extend(float(p) for p in inst.params)
                ops.append(ProgramOp(inst.gate_name, targets, offset,
                                     gd.num_params, col_idx, None,
                                     gd.param_builder, gate_index))
                key_parts.append((inst.gate_name, targets, col_idx))
            elif gd.cphase_value is not None:
                ops.append(ProgramOp(inst.gate_name, targets, 0, 0, col_idx,
                                     None, None, gate_index,
                                     cphase_value=gd.cphase_value))
                key_parts.append((inst.gate_name, targets, col_idx,
                                  complex(gd.cphase_value)))
            else:
                # Fixed gate, or a custom parameterized gate: bake the
                # matrix and fold its values into the key.
                mat = np.asarray(gd.matrix_func(*inst.params),
                                 dtype=np.complex128)
                ops.append(ProgramOp(inst.gate_name, targets, 0, 0, col_idx,
                                     mat, None, gate_index))
                key_parts.append((inst.gate_name, targets, col_idx,
                                  mat.tobytes()))
    key_parts.append(("columns", len(columns)))

    return CircuitProgram(
        num_qubits=circuit.num_qubits,
        initial_index=basis_state_index(circuit.initial_states),
        ops=tuple(ops),
        num_columns=len(columns),
        num_params=len(params),
        initial_params=np.asarray(params, dtype=np.float64),
        compile_key=tuple(key_parts),
    )


def forward_fn(program: CircuitProgram, device) -> Callable:
    """``f(params) -> complex state (2^n,)`` on ``device`` through the
    group executor."""
    from .plan import group_forward_body

    return lambda params: group_forward_body(program, params, device)
