"""Mixed-unitary noise trajectories as unitaries spliced into the plan.

Counterpart of ``quantum_simulator_tpu/ops/unitary_traj.py:61-339``. For
channels whose Kraus operators are each proportional to a unitary
(depolarizing, bit flip, phase flip, two-qubit depolarizing) the branch
probabilities are state-independent and ``K_m / sqrt(c_m)`` is exactly
unitary, so a trajectory is the ideal circuit with independently drawn
unitaries spliced in after each gate. The spliced ops feed the group plan,
which composes them into the same per-axis operators as the ideal forward:
one pass per composition window instead of one per gate and draw.

The splice spec (the augmented program, the draw schedule and the
classification dummies) is the JAX package's, op for op. The port runs a
batch of T trajectories at once: the draws are made on the device from a
``torch.Generator`` (one categorical per stack over all T x draws), the
operands are built on the device with a leading trajectory axis
(``plan.build_group_operands_batched``), and every dense and cross step
is one batched kernel launch. ``branch`` replays given draws (the tests
feed the JAX package's).

``unitary_insert_evolve`` is the n >= 30 form: it evolves a provided
grouped state and builds no complex result. Left behind: the interactive
skeleton path (``interactive_trajectory_fn``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG
from . import program as prog
from .bigtraj import phase_real_stack, trajectory_is_real
from .plan import (
    GenericStep,
    OperandOverrides,
    basis_state,
    build_group_operands_batched,
    execute_group_plan,
    get_group_plan,
)

# Classification-only dummies for spliced ops: the plan reads their
# static_matrix for realness and diagonality; operand values come from
# OperandOverrides. Non-diagonal and non-SWAP, so spliced ops take the
# dense-matrix routes, with realness matching the injected draws.
_DUMMY_R1 = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)
_DUMMY_C1 = np.array([[1.0, 1.0], [1.0j, -1.0j]]) / np.sqrt(2)


def mixed_unitary_stack(stack: np.ndarray):
    """``(m, D, D)`` Kraus stack -> ``(probs, units)`` when every
    operator is proportional to a unitary (``K^H K = c I``) and the
    channel is trace-preserving, else None."""
    st = np.asarray(stack, np.complex128)
    if st.ndim != 3 or st.shape[1] != st.shape[2]:
        return None
    d = st.shape[1]
    probs, units = [], []
    for K in st:
        M = K.conj().T @ K
        c = float(np.real(np.trace(M))) / d
        if c < 1e-12 or not np.allclose(M, c * np.eye(d), atol=1e-9):
            return None
        probs.append(c)
        units.append(K / np.sqrt(c))
    probs = np.asarray(probs)
    if not np.isclose(probs.sum(), 1.0, atol=1e-6):
        return None
    return probs, np.stack(units)


class _StackSpec(NamedTuple):
    probs: np.ndarray        # (m,) static branch probabilities
    units: np.ndarray        # (m, D, D) complex64 unitaries
    units_real: object       # (m, D, D) float64 phase-real forms, or None
    exact: np.ndarray        # (m, D, D) complex128 unitaries


class _Draw(NamedTuple):
    aug_index: int           # spliced op's index in aug.ops
    stack_id: int
    draw_index: int          # column of the (T, total_draws) branch tensor


class UnitaryInsertSpec(NamedTuple):
    aug: prog.CircuitProgram
    draws: tuple
    stacks: tuple            # tuple[_StackSpec]
    total_draws: int
    real: bool               # whole trajectory stays real (phase-real)


_SPEC_CACHE: dict[tuple, UnitaryInsertSpec | None] = {}


def _dummy_op(targets, mat, column_index) -> prog.ProgramOp:
    return prog.ProgramOp("__MU_KRAUS__", tuple(targets), 0, 0,
                          column_index, mat, None, -1)


def unitary_insert_spec(program: prog.CircuitProgram, noise_model
                        ) -> UnitaryInsertSpec | None:
    """Host-side splice plan, or None when any channel on any gate is not
    mixed-unitary. Per op: one draw per (stack, target) for 1q stacks,
    one per stack for a 2q stack on a 2-target gate."""
    key = (program.compile_key, noise_model.spec_key())
    if key in _SPEC_CACHE:
        return _SPEC_CACHE[key]
    spec = _build_spec(program, noise_model)
    if len(_SPEC_CACHE) > 128:
        _SPEC_CACHE.pop(next(iter(_SPEC_CACHE)))
    _SPEC_CACHE[key] = spec
    return spec


def _build_spec(program, noise_model):
    real = trajectory_is_real(program, noise_model)
    stacks: list[_StackSpec] = []
    stack_ids: dict[bytes, int] = {}
    by_gate: dict[str, list[int] | None] = {}

    def stack_id_for(raw) -> int | None:
        skey = raw.tobytes()
        sid = stack_ids.get(skey)
        if sid is not None:
            return sid
        mu = mixed_unitary_stack(raw)
        if mu is None:
            return None
        probs, units = mu
        ur = phase_real_stack(units) if real else None
        sid = len(stacks)
        stacks.append(_StackSpec(probs, units.astype(np.complex64), ur,
                                 units))
        stack_ids[skey] = sid
        return sid

    aug_ops: list[prog.ProgramOp] = []
    draws: list[_Draw] = []
    draw = 0
    for op in program.ops:
        if op.gate_name not in by_gate:
            sids = []
            for raw in noise_model.kraus_stacks_for_gate(op.gate_name):
                sid = stack_id_for(np.asarray(raw))
                if sid is None:
                    sids = None
                    break
                sids.append(sid)
            by_gate[op.gate_name] = sids
        sids = by_gate[op.gate_name]
        if sids is None:
            return None
        aug_ops.append(op)
        k = len(op.targets)
        for sid in sids:
            d = stacks[sid].units.shape[1]
            if d == 2:
                for q in op.targets:
                    dummy = _DUMMY_R1 if real else _DUMMY_C1
                    draws.append(_Draw(len(aug_ops), sid, draw))
                    aug_ops.append(_dummy_op((q,), dummy, op.column_index))
                    draw += 1
            elif d == 1 << k and k == 2:
                dummy = (np.kron(_DUMMY_R1, _DUMMY_R1) if real
                         else np.kron(_DUMMY_C1, _DUMMY_C1))
                draws.append(_Draw(len(aug_ops), sid, draw))
                aug_ops.append(_dummy_op(op.targets, dummy, op.column_index))
                draw += 1
            else:
                return None  # arity mismatch or a wide correlated stack

    aug = prog.CircuitProgram(
        num_qubits=program.num_qubits,
        initial_index=program.initial_index,
        ops=tuple(aug_ops),
        num_columns=program.num_columns,
        num_params=program.num_params,
        initial_params=program.initial_params,
        compile_key=program.compile_key + (
            ("mu-traj", noise_model.spec_key(), real),),
    )
    return UnitaryInsertSpec(aug, tuple(draws), tuple(stacks), draw, real)


def unitary_insert_supported(program, noise_model) -> bool:
    return unitary_insert_spec(program, noise_model) is not None


def draw_branches(spec: UnitaryInsertSpec, n_traj: int, device,
                  generator: torch.Generator | None) -> torch.Tensor:
    """(T, total_draws) branch indices: per stack, one inverse-CDF
    categorical over all of its T x draws (the probabilities are static)."""
    branch = torch.zeros((n_traj, spec.total_draws), dtype=torch.long,
                         device=device)
    for sid, st in enumerate(spec.stacks):
        cols = [d.draw_index for d in spec.draws if d.stack_id == sid]
        if not cols:
            continue
        cdf = torch.cumsum(torch.as_tensor(st.probs, dtype=torch.float64,
                                           device=device), dim=0)
        u = torch.rand((n_traj, len(cols)), dtype=torch.float64,
                       device=device, generator=generator) * cdf[-1]
        sel = torch.searchsorted(cdf, u, right=True).clamp_(
            max=len(st.probs) - 1)
        branch[:, torch.as_tensor(cols, device=device)] = sel
    return branch


def branch_overrides(spec: UnitaryInsertSpec,
                     branch: torch.Tensor) -> OperandOverrides:
    """Gather the chosen (exactly unitary) branch operators into operand
    overrides with a leading trajectory axis (``_draw_overrides_host``)."""
    device = branch.device
    pool_rows: list[torch.Tensor] = []
    base = 0
    pool_map: dict[int, int] = {}
    per_op: dict[int, torch.Tensor] = {}
    for sid, st in enumerate(spec.stacks):
        dlist = [d for d in spec.draws if d.stack_id == sid]
        if not dlist:
            continue
        units = torch.from_numpy(np.asarray(
            st.units_real if spec.real else st.exact,
            dtype=CONFIG.np_complex)).to(device)
        chosen = units[branch[:, torch.as_tensor(
            [d.draw_index for d in dlist], device=device)]]
        if st.units.shape[1] == 2:
            pool_rows.append(chosen)
            for r, d in enumerate(dlist):
                pool_map[d.aug_index] = base + r
            base += len(dlist)
        else:
            for r, d in enumerate(dlist):
                per_op[d.aug_index] = chosen[:, r]
    return OperandOverrides(
        pool_rows=torch.cat(pool_rows, dim=1) if pool_rows else None,
        pool_map=pool_map, per_op=per_op)


def finalize(x: torch.Tensor, planar: bool) -> torch.Tensor:
    """Batched grouped state -> (T, 2^n) ``CONFIG.dtype``, each trajectory
    normalized once: the spliced operators are exactly unitary, but fp32
    products drift by about 1e-6 per op (``unitary_traj.py:335-339``)."""
    T = x.shape[0]
    flat = (torch.complex(x[:, 0], x[:, 1]) if planar
            else x.to(CONFIG.dtype)).reshape(T, -1)
    nsq = flat.real.square().sum(-1) + flat.imag.square().sum(-1)
    return flat * torch.rsqrt(nsq.clamp(min=1e-30))[:, None]


def unitary_insert_trajectory_body(program, noise_model, params,
                                   n_traj: int, device,
                                   generator: torch.Generator | None = None,
                                   branch: torch.Tensor | None = None,
                                   plain: bool = False):
    """``n_traj`` stochastic trajectories with every noise draw spliced as
    a unitary into the group plan. Returns ``(states (T, 2^n) complex,
    branch (T, total_draws))``; ``branch`` given replays those draws,
    ``plain`` runs the kernels' plain twins."""
    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has channels that are not "
                         "mixed-unitary; use the monomial or per-gate body")
    if branch is None:
        branch = draw_branches(spec, n_traj, device, generator)
    aug = spec.aug
    plan = get_group_plan(aug)
    operands = build_group_operands_batched(
        aug, plan, params, n_traj, device, branch_overrides(spec, branch))
    planar = not plan.all_real
    x = basis_state(plan, aug.initial_index, device, planar, n_traj)
    x = execute_group_plan(plan, operands, aug, params, x, planar, plain,
                           batched=True)
    return finalize(x, planar), branch


def unitary_insert_evolve_ok(program, noise_model) -> bool:
    """Gate of the n >= 30 splice route: mixed-unitary noise and no
    ``GenericStep`` in the spliced plan (``unitary_traj.py:206-222``). A
    ``GenericStep`` would make the plan planar while the caller built the
    state from ``trajectory_is_real``; such circuits stay on the fold
    executor, whose bit contraction serves dense gates across three
    groups."""
    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        return False
    return not any(isinstance(s, GenericStep)
                   for s in get_group_plan(spec.aug).steps)


def unitary_insert_evolve(program, noise_model, params, x: torch.Tensor,
                          generator: torch.Generator | None = None,
                          branch: torch.Tensor | None = None,
                          plain: bool = False):
    """Splice evolution of a provided batched grouped state, real ``(T,
    *axes)`` or planar ``(T, 2, *axes)`` as the spliced plan says: the
    n >= 30 form of ``unitary_insert_trajectory_body``
    (``unitary_traj.py:379-418``). Returns ``(x, branch)`` and builds no
    complex result. No renormalization: every spliced operator is exactly
    unitary, so the norm drifts by rounding in the state's precision
    only."""
    spec = unitary_insert_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has channels that are not "
                         "mixed-unitary; use bigtraj.huge_trajectory_evolve")
    n_traj = x.shape[0]
    if branch is None:
        branch = draw_branches(spec, n_traj, x.device, generator)
    plan = get_group_plan(spec.aug)
    operands = build_group_operands_batched(
        spec.aug, plan, params, n_traj, x.device,
        branch_overrides(spec, branch))
    x = execute_group_plan(plan, operands, spec.aug, params, x,
                           not plan.all_real, plain, batched=True)
    return x, branch
