"""Circuit -> ordered op list + parameter vector.

Counterpart of ``quantum_simulator_tpu/ops/program.py``: ``ProgramOp``,
``CircuitProgram`` and ``compile_circuit`` (``program.py:41-158``), and
the entry points of the executors. The port runs eagerly and has no
per-structure compile, so ``forward_fn`` always routes to the group
executor (``ops/plan.py``) at every n; the JAX package routes there only
on a TPU (``program.py:342``). The trajectory entry points
(``batched_trajectories``, ``trajectory_fn``, ``steps_fn``) route noise
to the splice bodies, the fold body or the per-gate body
(``trajectory_route``), and ``monitored_trajectories`` routes mid-circuit
measurement to the monomial splice or to the per-gate monitored body.

The variational path has two bodies. ``forward_body`` is the per-gate
body (``program.py:175-180, 351-354``): one ``apply_gate`` per op on a
``(..., 2^n)`` state, differentiable through the torch gate builders, for
autodiff and ``multi_start``. ``batched_forward_fn`` is the port's form of
the JAX package's ``vmap`` over parameter rows (``program.py:384-391``):
the batched group executor, one kernel launch per dense and cross step
for the whole batch (``plan.group_batched_forward``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..config import CONFIG
from ..gates import GateType
from ..registry import GateRegistry
from .apply import (apply_cphase, apply_gate, basis_state_index,
                    collapse_qubit, prob_qubit_zero, probabilities)


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
    # Differentiable torch builder of a parameterized gate (batched).
    torch_builder: Callable | None = None


@dataclass(frozen=True)
class CircuitProgram:
    num_qubits: int
    initial_index: int
    ops: tuple[ProgramOp, ...]
    num_columns: int
    num_params: int
    initial_params: np.ndarray
    compile_key: tuple

    def param_offset_for(self, gate_index: int, param_index: int
                         ) -> int | None:
        """Position in the parameter vector of ``circuit.gates
        [gate_index]``'s ``param_index``-th parameter, or None when that
        gate's matrix was baked (``program.py:70-80``)."""
        for op in self.ops:
            if op.gate_index == gate_index:
                if op.num_params == 0:
                    return None
                return op.param_offset + param_index
        return None

    def op_matrix_torch(self, op: ProgramOp,
                        params: torch.Tensor) -> torch.Tensor:
        """Torch matrix of ``op`` on ``params``' device: ``(..., D, D)``
        complex for a parameterized op and a ``(..., P)`` parameter
        tensor (differentiable), ``(D, D)`` ``CONFIG.dtype`` for a fixed
        one."""
        if op.static_matrix is not None:
            return torch.from_numpy(np.asarray(
                op.static_matrix, dtype=CONFIG.np_complex)).to(params.device)
        if op.torch_builder is None:
            raise ValueError(f"{op.gate_name} has no torch builder: its "
                             "parameters cannot run as a torch batch")
        return op.torch_builder(*[params[..., op.param_offset + j]
                                  for j in range(op.num_params)])

    def op_matrix(self, op: ProgramOp, params, dtype=None) -> np.ndarray:
        """Host NumPy matrix of ``op`` at the parameter vector ``params``,
        in ``dtype`` (default ``CONFIG.np_complex``)."""
        dtype = dtype or CONFIG.np_complex
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
                                     gd.param_builder, gate_index,
                                     torch_builder=gd.torch_matrix_func))
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


def param_tensor(params, device=None) -> torch.Tensor:
    """Parameters as a float tensor: a tensor stays as it is (and keeps
    its autograd graph); anything else becomes ``CONFIG.real_dtype`` on
    ``device`` (default ``CONFIG.device``): float32 angles alone would
    cost the complex128 mode about 1e-8."""
    if isinstance(params, torch.Tensor):
        return params
    return torch.as_tensor(np.asarray(params, dtype=CONFIG.np_real),
                           device=device or CONFIG.device)


def forward_body(program: CircuitProgram, params, device=None
                 ) -> torch.Tensor:
    """The per-gate forward (``program.py:175-180``): one ``apply_gate``
    (or ``apply_cphase``) per op from the initial basis state. ``params``
    of shape ``(P,)`` gives a ``(2^n,)`` ``CONFIG.dtype`` state, ``(B, P)`` a
    ``(B, 2^n)`` batch, one row per parameter row. Differentiable in
    ``params`` (autodiff, ``multi_start``); no kernel is involved."""
    params = param_tensor(params, device)
    n = program.num_qubits
    state = torch.zeros(tuple(params.shape[:-1]) + (1 << n,),
                        dtype=CONFIG.dtype, device=params.device)
    state[..., program.initial_index] = 1.0
    for op in program.ops:
        if op.cphase_value is not None:
            state = apply_cphase(state, op.targets, op.cphase_value, n)
        else:
            state = apply_gate(state, program.op_matrix_torch(op, params),
                               op.targets, n)
    return state


def batched_forward_fn(program: CircuitProgram, device=None,
                       plain: bool = False) -> Callable:
    """``f(params_batch (B, P)) -> states (B, 2^n)`` complex: the same
    structure at many parameter points in one batch, every dense and
    cross step one kernel launch (``plain``: the twins)."""
    from .plan import group_batched_forward

    return lambda params: group_batched_forward(
        program, params, device or CONFIG.device, plain)


class _NoNoise:
    """Channel-free noise stand-in for reusing the trajectory bodies."""

    @staticmethod
    def kraus_stacks_for_gate(gate_name: str):
        return []

    @staticmethod
    def spec_key():
        return ()

    @staticmethod
    def has_channels() -> bool:
        return False


def trajectory_route(program: CircuitProgram, noise_model) -> str:
    """Which trajectory body serves this noise model, fastest applicable
    first (``program.py:534-573``):

    * ``"unitary"``: mixed-unitary channels splice as unitaries into the
      plan's composition windows (``ops/unitary_traj.py``);
    * ``"monomial"``: monomial channels (amplitude damping, thermal
      relaxation, any mix with the mixed-unitary family) splice as
      classical draws given one basis sample per window
      (``ops/monomial_traj.py``);
    * ``"fold"``: any other channel, when every op has a fold applier:
      one state pass per gate with its draws folded into the operator
      (``bigtraj.fold_trajectory_body``);
    * ``"per-gate"``: ``plan.group_trajectory_body``, for ops without a
      fold applier (and for column snapshots, ``trajectory_fn``).

    The port takes the group path at every n, as its forward does; the
    JAX package's per-gate einsum body below n = 19 is a TPU compile-time
    choice with the same law (``program.py:329-336``)."""
    from .bigtraj import fold_supported
    from .monomial_traj import monomial_insert_supported
    from .unitary_traj import unitary_insert_supported

    if unitary_insert_supported(program, noise_model):
        return "unitary"
    if monomial_insert_supported(program, noise_model):
        return "monomial"
    if fold_supported(program):
        return "fold"
    return "per-gate"


def batched_trajectories(program: CircuitProgram, noise_model, params,
                         n_traj: int, device, generator=None, draws=None,
                         plain: bool = False):
    """``(states (T, 2^n) CONFIG.dtype, draws)`` of ``n_traj`` stochastic
    trajectories in one batch on ``device``: every dense and cross step of
    the batch is one kernel launch (``plain``: the twins). ``draws`` from
    an earlier call with the same arguments replays its branches."""
    route = trajectory_route(program, noise_model)
    if route == "unitary":
        from .unitary_traj import unitary_insert_trajectory_body as body
    elif route == "monomial":
        from .monomial_traj import monomial_trajectory_body as body
    elif route == "fold":
        from .bigtraj import fold_trajectory_body as body
    else:
        from .plan import group_trajectory_body

        return group_trajectory_body(program, noise_model, params, n_traj,
                                     device, generator, draws, plain=plain)
    return body(program, noise_model, params, n_traj, device, generator,
                draws, plain)


def batched_trajectories_fn(program: CircuitProgram, noise_model,
                            device, record_columns: bool = False
                            ) -> Callable:
    """``f(params, n_traj, generator) -> states (T, 2^n)``. With
    ``record_columns`` (``program.py:495-531``, served by the per-gate
    body as the JAX selector does, ``program.py:561-573``): ``f(params,
    uniforms, out=None) -> (T, columns + 1, 2^n)`` column snapshots, one
    trajectory per row of ``uniforms`` (``plan.draw_uniforms``), written
    into ``out`` when given."""
    if record_columns:
        from .plan import group_trajectory_body

        return lambda params, uniforms, out=None: group_trajectory_body(
            program, noise_model, params, uniforms.shape[0],
            uniforms.device, record_columns=True, out=out,
            uniforms=uniforms)[0]
    return lambda params, n_traj, generator: batched_trajectories(
        program, noise_model, params, n_traj, device, generator)[0]


def trajectory_fn(program: CircuitProgram, noise_model, device,
                  record_columns: bool = False) -> Callable:
    """``f(params, generator) -> state (2^n,)``: one stochastic trajectory;
    with ``record_columns``, ``(columns + 1, 2^n)`` snapshots through the
    per-gate body (``program.py:426-450``)."""
    from .plan import group_trajectory_body

    if record_columns:
        return lambda params, generator: group_trajectory_body(
            program, noise_model, params, 1, device, generator,
            record_columns=True)[0][0]
    return lambda params, generator: batched_trajectories(
        program, noise_model, params, 1, device, generator)[0][0]


def steps_fn(program: CircuitProgram, device) -> Callable:
    """``f(params) -> (columns + 1, 2^n)``: the ideal state before the
    first column and after each column (``program.py:406-418``: the
    per-gate body with no channels)."""
    from .plan import group_trajectory_body

    return lambda params: group_trajectory_body(
        program, _NoNoise, params, 1, device, record_columns=True)[0][0]


# ---------------------------------------------------------------------------
# Monitored trajectories (mid-circuit measurement that collapses)
# ---------------------------------------------------------------------------

# From this many qubits on the JAX package's monitored path is the group
# plan only (``program.py:336``); the port refuses the same inputs there.
MONITORED_SPLICE_ONLY_MIN_QUBITS = 19


def _apply_channel_stochastic(state: torch.Tensor, kraus: torch.Tensor,
                              qubit: int, n: int, generator) -> torch.Tensor:
    """One stochastic Kraus draw per row of a ``(T, 2^n)`` state: branch
    probabilities from the qubit's reduced density matrix, one categorical
    per trajectory, the drawn operator applied and the row rescaled
    (``program.py:199-219``)."""
    from .plan import categorical

    st = state.reshape(state.shape[0], 1 << qubit, 2, -1)
    rho = torch.einsum("taib,tajb->tij", st, st.conj())
    norms = torch.einsum("mij,tjk,mik->tm", kraus, rho, kraus.conj()).real
    idx = categorical(norms + 1e-30, generator)
    out = torch.einsum("tij,tajb->taib", kraus[idx], st).reshape(state.shape)
    p = norms.gather(1, idx[:, None]).clamp(min=1e-30)
    return out * torch.rsqrt(p)


def monitored_body(program: CircuitProgram, noise_model, events, params,
                   n_traj: int, device, generator=None):
    """``n_traj`` monitored trajectories gate by gate on the flat complex
    state (``program.py:229-276``). ``events`` is a static list of
    ``(op_position, qubit)``: the measurement fires after exactly
    ``op_position`` ops, with one uniform per event and trajectory, and
    collapses its qubit; each gate's channels are drawn after it. Returns
    ``(states (T, 2^n) CONFIG.dtype, outcomes (T, M) int64)``. No kernel is
    involved: this body serves what the monomial splice cannot (other
    channels), at small n."""
    n = program.num_qubits
    channels_for = noise_model.kraus_stacks_for_gate
    state = torch.zeros((n_traj, 1 << n), dtype=CONFIG.dtype,
                        device=device)
    state[:, program.initial_index] = 1.0
    outcomes = torch.zeros((n_traj, len(events)), dtype=torch.long,
                           device=device)
    ev_i = 0
    for pos in range(len(program.ops) + 1):
        while ev_i < len(events) and events[ev_i][0] == pos:
            q = events[ev_i][1]
            p0 = prob_qubit_zero(state, q, n)
            total = probabilities(state).sum(-1).clamp(min=1e-30)
            u = torch.rand(n_traj, device=device, generator=generator)
            bit = (u >= p0 / total).long()
            state = collapse_qubit(state, q, bit, n)
            outcomes[:, ev_i] = bit
            ev_i += 1
        if pos == len(program.ops):
            break
        op = program.ops[pos]
        if op.cphase_value is not None:
            state = apply_cphase(state, op.targets, op.cphase_value, n)
        else:
            state = apply_gate(state, program.op_matrix(op, params),
                               op.targets, n)
        for kraus_np in channels_for(op.gate_name):
            kraus = torch.from_numpy(np.asarray(
                kraus_np, dtype=CONFIG.np_complex)).to(device)
            for q in op.targets:
                state = _apply_channel_stochastic(state, kraus, q, n,
                                                  generator)
    return state, outcomes


def monitored_trajectories(program: CircuitProgram, noise_model, events,
                           params, n_traj: int, device, generator=None,
                           plain: bool = False):
    """``(states (T, 2^n) CONFIG.dtype, outcomes (T, M) int64)`` of
    ``n_traj`` monitored trajectories in one batch
    (``program.py:453-492``): the monomial splice through the group plan,
    every dense and cross step one batched kernel launch, wherever the
    noise channels are monomial (always for the reference channel family
    and for noise-free circuits); the per-gate body otherwise, which the
    JAX package offers below n = 19 only."""
    from .monomial_traj import (monomial_insert_supported,
                                monomial_monitored_body)

    nm = noise_model if noise_model is not None else _NoNoise
    events = tuple(events)
    if monomial_insert_supported(program, nm, events):
        states, outcomes, _ = monomial_monitored_body(
            program, nm, events, params, n_traj, device, generator,
            plain=plain)
        return states, outcomes
    if program.num_qubits >= MONITORED_SPLICE_ONLY_MIN_QUBITS:
        raise ValueError(
            "monitored group path needs monomial Kraus channels "
            "(the reference channel family); this noise model has "
            "a non-monomial custom channel — use MPSSimulator / "
            "Clifford monitored engines or n <= 18")
    return monitored_body(program, nm, events, params, n_traj, device,
                          generator)
