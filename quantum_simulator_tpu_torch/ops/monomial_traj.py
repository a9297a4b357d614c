"""General-Kraus (monomial) noise trajectories as classical draws spliced
into the group plan.

Counterpart of the trajectory part of
``quantum_simulator_tpu/ops/monomial_traj.py`` (``:78-469``). Every
reference channel (and thermal relaxation) has Kraus operators that are
monomial in the computational basis: ``K_m |j> = c_{m,j} |f_m(j)>``. With
one auxiliary basis sample ``b ~ |psi|^2`` per composition window, every
pending noise site becomes an independent classical draw from the static
``|c|^2`` table at b's bits, and same-qubit site chains update b through
the static maps ``f_m``; the marginal over b is exactly the sequential
stochastic-Kraus law. A trajectory therefore runs a window of gates
through the group plan, draws one basis sample, draws the window's sites,
and splices the chosen Kraus operators into the next window as operand
overrides. The law equals ``plan.group_trajectory_body``'s; the draws
per key do not.

The spec (segments, windows and sites) is the JAX package's. The port
runs T trajectories at once: one basis sample per trajectory per window
(a per-axis categorical on the device), the site draws gathered from the
static ``w2`` / ``fmap`` tables, and every dense and cross step one
batched kernel launch.

Projective mid-circuit measurement is the monomial channel ``{|0><0|,
|1><1|}`` whose draw given b is the sampled bit itself, so monitored
circuits (``events``) run through the same windows
(``monomial_monitored_body``). ``monomial_insert_evolve`` and
``monomial_monitored_evolve`` are the n >= 30 forms: they evolve a
provided grouped state, normalize it once in place and build no complex
result.

Tracing (``utils/profiling``): a span ``mono.window`` around each
segment's plan lookup, batched operand build and execution, ``mono.sample``
around each window's basis sample (with one ``Pass`` record of kind
``"sample"``: its first marginal reads the whole state) and ``mono.draws``
around its site draws. ``_run_windows.windows`` counts the window
boundaries served (one basis sample of the whole batch each) and
``_run_windows.sites`` the sites drawn at them (per batch, not per
trajectory).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG
from ..utils.profiling import span, state_pass
from . import program as prog
from .bigtraj import normalize_, trajectory_is_real
from .plan import (
    GenericStep,
    GroupLayout,
    OperandOverrides,
    build_group_operands_batched,
    categorical,
    execute_group_plan,
    get_group_plan,
    layout_basis_state,
)
from .unitary_traj import finalize

# Classification dummies (see unitary_traj): the plan reads static_matrix
# for realness and diagonality; operand values come from OperandOverrides.
_DUMMY_R1 = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2)
_DUMMY_C1 = np.array([[1.0, 1.0], [1.0j, -1.0j]]) / np.sqrt(2)

# Measurement pseudo-stack: the projectors onto |0> and |1>.
_MEASURE_STACK = np.stack([np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]
                          ).astype(np.complex128)


class MonomialStack(NamedTuple):
    """Static per-stack data for a monomial (m, D, D) Kraus stack."""

    kraus: np.ndarray        # (m, D, D) complex64 raw Kraus operators
    kraus_real: object       # (m, D, D) float64 phase-real forms, or None
    w2: np.ndarray           # (m, D) float64: |c_{m,j}|^2 per input j
    fmap: np.ndarray         # (m, D) int32: f_m(j) (identity where c=0)
    exact: np.ndarray        # (m, D, D) complex128 raw Kraus operators


def monomial_stack(raw: np.ndarray) -> MonomialStack | None:
    """(m, D, D) Kraus stack -> MonomialStack when every operator is a
    generalized permutation matrix (<= 1 nonzero per column and per row)
    and the stack is trace-preserving; else None."""
    st = np.asarray(raw, np.complex128)
    if st.ndim != 3 or st.shape[1] != st.shape[2]:
        return None
    m, D, _ = st.shape
    w2 = np.zeros((m, D), np.float64)
    fmap = np.tile(np.arange(D, dtype=np.int32), (m, 1))
    for mi, K in enumerate(st):
        used_rows: set[int] = set()
        for j in range(D):
            nz = np.flatnonzero(np.abs(K[:, j]) > 1e-12)
            if nz.size > 1:
                return None
            if nz.size == 1:
                r = int(nz[0])
                if r in used_rows:
                    return None  # two columns hit one row: interference
                used_rows.add(r)
                w2[mi, j] = abs(K[r, j]) ** 2
                fmap[mi, j] = r
    if not np.allclose(w2.sum(axis=0), 1.0, atol=1e-6):
        return None  # not trace-preserving
    return MonomialStack(kraus=st.astype(np.complex64),
                         kraus_real=_phase_real_generic(st),
                         w2=w2, fmap=fmap, exact=st)


def _phase_real_generic(stack: np.ndarray):
    """(m, D, D) -> float64 real forms when every operator is real up to
    a global phase, else None."""
    out = []
    for K in np.asarray(stack):
        flat = K.reshape(-1)
        a = flat[int(np.argmax(np.abs(flat)))]
        if abs(a) < 1e-30:
            out.append(np.zeros_like(K, dtype=np.float64))
            continue
        R = K * (np.conj(a) / abs(a))
        if not np.allclose(R.imag, 0.0, atol=1e-10):
            return None
        out.append(R.real)
    return np.stack(out)


class _Site(NamedTuple):
    window: int              # which window's boundary sample it draws on
    seg_pos: int             # dummy-op index within segments[window + 1]
    stack_id: int
    targets: tuple[int, ...]
    key_index: int           # the site's draw slot; -1 for a measurement
    event_index: int         # measurement outcome slot; -1 for noise


class MonomialSpec(NamedTuple):
    segments: tuple          # tuple[CircuitProgram]: len = n_windows + 1
    windows: tuple           # windows[w] = tuple[_Site] (in draw order)
    stacks: tuple            # tuple[MonomialStack]
    n_site_keys: int
    real: bool
    n_events: int


_SPEC_CACHE: dict[tuple, MonomialSpec | None] = {}


def _dummy_op(targets, mat, column_index) -> prog.ProgramOp:
    return prog.ProgramOp("__MONO_KRAUS__", tuple(targets), 0, 0,
                          column_index, mat, None, -1)


def monomial_spec(program: prog.CircuitProgram, noise_model,
                  events: tuple = ()) -> MonomialSpec | None:
    """Host-side splice plan, or None when any channel is not monomial.
    ``events`` are monitored ``(op_position, qubit)`` measurement sites,
    each firing before the op at that position."""
    key = (program.compile_key, noise_model.spec_key(), tuple(events))
    if key in _SPEC_CACHE:
        return _SPEC_CACHE[key]
    spec = _build_spec(program, noise_model, tuple(events))
    if len(_SPEC_CACHE) > 128:
        _SPEC_CACHE.pop(next(iter(_SPEC_CACHE)))
    _SPEC_CACHE[key] = spec
    return spec


def _build_spec(program, noise_model, events):
    # projectors are real, so the trajectory's realness decides
    real = trajectory_is_real(program, noise_model)
    stacks: list[MonomialStack] = []
    stack_ids: dict[bytes, int] = {}
    by_gate: dict[str, list[int] | None] = {}

    def stack_id_for(raw) -> int | None:
        skey = np.asarray(raw).tobytes()
        sid = stack_ids.get(skey)
        if sid is not None:
            return sid
        ms = monomial_stack(raw)
        if ms is None or (real and ms.kraus_real is None):
            return None
        sid = len(stacks)
        stacks.append(ms)
        stack_ids[skey] = sid
        return sid

    measure_sid = stack_id_for(_MEASURE_STACK) if events else -1

    # Walk the ops with the events between them; windows close when an op
    # touches a pending site's target. segments[w] holds the gates of
    # window w; the window's spliced dummies head segments[w + 1].
    segments: list[list] = [[]]
    windows: list[list[_Site]] = []
    pending: list[tuple] = []   # (stack_id, targets, key_index, event)
    pending_qubits: set[int] = set()
    site_keys = 0

    def close_window():
        nonlocal pending, pending_qubits
        if not pending:
            return
        w = len(windows)
        seg: list = []
        sites: list[_Site] = []
        for sid, targets, ki, ev in pending:
            if stacks[sid].kraus.shape[1] == 2:
                dummy = _DUMMY_R1 if real else _DUMMY_C1
            else:
                dummy = (np.kron(_DUMMY_R1, _DUMMY_R1) if real
                         else np.kron(_DUMMY_C1, _DUMMY_C1))
            sites.append(_Site(w, len(seg), sid, targets, ki, ev))
            seg.append(_dummy_op(targets, dummy, 0))
        windows.append(sites)
        segments.append(seg)
        pending = []
        pending_qubits = set()

    def pend_site(sid, targets, ev=-1):
        nonlocal site_keys
        ki = -1
        if ev < 0:
            ki = site_keys
            site_keys += 1
        pending.append((sid, tuple(targets), ki, ev))
        pending_qubits.update(targets)

    ev_i = 0
    for pos in range(len(program.ops) + 1):
        while ev_i < len(events) and events[ev_i][0] == pos:
            pend_site(measure_sid, (events[ev_i][1],), ev=ev_i)
            ev_i += 1
        if pos == len(program.ops):
            break
        op = program.ops[pos]
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
        if pending_qubits & set(op.targets):
            close_window()
        segments[-1].append(op)
        k = len(op.targets)
        for sid in sids:
            D = stacks[sid].kraus.shape[1]
            if D == 2:
                for q in op.targets:
                    pend_site(sid, (q,))
            elif D == 1 << k and k == 2:
                pend_site(sid, op.targets)
            else:
                return None  # arity mismatch or a wide correlated stack
    close_window()

    seg_programs = tuple(prog.CircuitProgram(
        num_qubits=program.num_qubits,
        initial_index=program.initial_index,
        ops=tuple(seg_ops),
        num_columns=1,
        num_params=program.num_params,
        initial_params=program.initial_params,
        compile_key=program.compile_key + (
            ("mono-seg", w, noise_model.spec_key(), events, real),),
    ) for w, seg_ops in enumerate(segments))
    return MonomialSpec(seg_programs, tuple(tuple(ws) for ws in windows),
                        tuple(stacks), site_keys, real, len(events))


def monomial_insert_supported(program, noise_model,
                              events: tuple = ()) -> bool:
    return monomial_spec(program, noise_model, tuple(events)) is not None


def _lead_marginal(y: torch.Tensor, planar: bool) -> torch.Tensor:
    """``(T, A)`` marginal of the leading data axis of a batched grouped
    state (or of a conditional slice of one): one norm reduction over the
    other axes and the planes, which reads the state once and writes no
    temporary of its size."""
    lead = 1 + int(planar)
    rest = tuple(d for d in range(1, y.ndim) if d != lead)
    if not rest:
        return y.square()
    return torch.linalg.vector_norm(y, dim=rest).square()


def _sample_axes(x: torch.Tensor, planar: bool, layout: GroupLayout,
                 generator, forced: torch.Tensor | None = None):
    """One basis sample per trajectory from the batched grouped state: a
    categorical on the first axis's marginal, then on each next axis's
    marginal given the earlier picks (``monomial_traj.py:316-339``): the
    first marginal reads the whole state, every later one a slice 1/S of
    the one before. Returns ``(per-axis indices (T, rank), |psi|^2
    (T,))``; ``forced`` replays given indices."""
    rows = torch.arange(x.shape[0], device=x.device)
    y = x
    idxs = []
    nsq = None
    for ax in range(len(layout.axis_sizes)):
        m = _lead_marginal(y, planar)
        if ax == 0:
            nsq = m.sum(-1)
        a = forced[:, ax] if forced is not None else categorical(
            m + 1e-30, generator)
        idxs.append(a)
        y = y[rows, :, a] if planar else y[rows, a]
    return torch.stack(idxs, dim=1), nsq


def _decode_bit(idxs: torch.Tensor, layout: GroupLayout, q: int):
    ax = layout.axis_of(q)
    shift = layout.axis_bits[ax] - 1 - layout.pos_in_axis(q)
    return (idxs[:, ax] >> shift) & 1


def _window_draws(spec: MonomialSpec, window, idxs, nsq, layout: GroupLayout,
                  generator, forced: torch.Tensor | None = None):
    """Classical draws of one window's sites given each trajectory's
    boundary basis sample (``monomial_traj.py:353-410``). Returns the
    next segment's overrides, the (T, sites) branch indices and the
    ``(event slot, (T,) outcome)`` updates of the window's measurements,
    whose branch is the sampled bit itself. The first operand is scaled
    by ``1/|psi|`` so the spliced product's norm stays O(1); the true
    branch probabilities fold into the final exact normalization."""
    device = idxs.device
    inv_norm = torch.rsqrt(nsq.clamp(min=1e-30))
    bit_state: dict[int, torch.Tensor] = {}
    pool_rows: list[torch.Tensor] = []
    pool_map: dict[int, int] = {}
    per_op: dict[int, torch.Tensor] = {}
    branches = []
    outcomes: list[tuple[int, torch.Tensor]] = []

    def bit(q):
        if q not in bit_state:
            bit_state[q] = _decode_bit(idxs, layout, q)
        return bit_state[q]

    for si, site in enumerate(window):
        st = spec.stacks[site.stack_id]
        if len(site.targets) == 1:
            bv = bit(site.targets[0])
        else:
            bv = bit(site.targets[0]) * 2 + bit(site.targets[1])
        D = st.kraus.shape[1]
        if site.event_index >= 0:
            m = bv
            outcomes.append((site.event_index, bv))
            scale = torch.ones_like(inv_norm)
        else:
            w2_t = torch.from_numpy(np.ascontiguousarray(
                st.w2.T, CONFIG.np_real)).to(device)
            probs = w2_t[bv]                                    # (T, m)
            m = forced[:, si] if forced is not None else categorical(
                probs + 1e-30, generator)
            scale = torch.rsqrt(probs.gather(1, m[:, None]).squeeze(
                1).clamp(min=1e-30))
        branches.append(m)
        if si == 0:
            scale = scale * inv_norm
        mats = torch.from_numpy(np.asarray(
            st.kraus_real if spec.real else st.exact,
            dtype=CONFIG.np_complex)).to(device)
        operand = mats[m] * scale[:, None, None]
        fm_flat = torch.from_numpy(st.fmap.reshape(-1).astype(
            np.int64)).to(device)
        newv = fm_flat[m * D + bv]
        if len(site.targets) == 1:
            bit_state[site.targets[0]] = newv
        else:
            bit_state[site.targets[0]] = (newv >> 1) & 1
            bit_state[site.targets[1]] = newv & 1
        if D == 2:
            pool_map[site.seg_pos] = len(pool_rows)
            pool_rows.append(operand[:, None])
        else:
            per_op[site.seg_pos] = operand
    rows = torch.cat(pool_rows, dim=1) if pool_rows else None
    return (OperandOverrides(pool_rows=rows, pool_map=pool_map,
                             per_op=per_op), torch.stack(branches, dim=1),
            outcomes)


def _run_windows(spec: MonomialSpec, params, x: torch.Tensor, planar: bool,
                 generator, draws, plain: bool):
    """Every segment through the group plan with a basis sample and the
    window's draws between them (``_run_spec``, and the window loop of
    ``_chunked_windows_evolve``). Returns ``(x, outcomes (T, events)
    int64, record)``: ``record[w]`` = (basis indices (T, rank), site
    branches (T, sites)) of window w; passing it back as ``draws``
    replays the trajectories."""
    n_traj, device = x.shape[0], x.device
    layout = GroupLayout.for_qubits(spec.segments[0].num_qubits)
    outcomes = torch.zeros((n_traj, spec.n_events), dtype=torch.long,
                           device=device)
    record = []
    overrides = None
    n_windows = len(spec.windows)
    for w in range(n_windows + 1):
        seg = spec.segments[w]
        with span("mono.window"):
            plan = get_group_plan(seg)
            operands = build_group_operands_batched(seg, plan, params,
                                                    n_traj, device, overrides)
            x = execute_group_plan(plan, operands, seg, params, x, planar,
                                   plain, batched=True)
            del operands
        if w == n_windows:
            break
        forced = draws[w] if draws is not None else (None, None)
        with span("mono.sample"):
            state_pass("sample", x, 1)
            idxs, nsq = _sample_axes(x, planar, layout, generator, forced[0])
        with span("mono.draws"):
            overrides, branches, updates = _window_draws(
                spec, spec.windows[w], idxs, nsq, layout, generator,
                forced[1])
        _run_windows.windows += 1
        _run_windows.sites += len(spec.windows[w])
        for ev, bv in updates:
            outcomes[:, ev] = bv
        record.append((idxs, branches))
    return x, outcomes, record


_run_windows.windows = 0    # window boundaries served, one sample each
_run_windows.sites = 0      # sites drawn at them


def _body_planar(spec: MonomialSpec) -> bool:
    return not (spec.real and all(get_group_plan(s).all_real
                                  for s in spec.segments))


def monomial_trajectory_body(program, noise_model, params, n_traj: int,
                             device, generator=None, draws=None,
                             plain: bool = False):
    """``n_traj`` stochastic trajectories with every (monomial-channel)
    noise draw spliced into the group plan, windows separated by basis
    samples (``_run_spec`` and ``_finalize``). Returns ``(states (T, 2^n)
    CONFIG.dtype, draws)``; passing ``draws`` replays them."""
    spec = monomial_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has non-monomial channels; use the "
                         "fold body (bigtraj.fold_trajectory_body)")
    planar = _body_planar(spec)
    x = layout_basis_state(GroupLayout.for_qubits(program.num_qubits),
                           program.initial_index, device, planar, n_traj)
    x, _, record = _run_windows(spec, params, x, planar, generator, draws,
                                plain)
    return finalize(x, planar), record


def monomial_monitored_body(program, noise_model, events, params,
                            n_traj: int, device, generator=None, draws=None,
                            plain: bool = False):
    """``n_traj`` monitored trajectories through the group plan:
    projective collapse at the static ``(op_position, qubit)`` events,
    with optional monomial noise (``monomial_traj.py:592-610``). Returns
    ``(states (T, 2^n) CONFIG.dtype, outcomes (T, M) int64, draws)``."""
    spec = monomial_spec(program, noise_model, tuple(events))
    if spec is None:
        raise ValueError("noise model has non-monomial channels; "
                         "monitored group path unavailable")
    planar = _body_planar(spec)
    x = layout_basis_state(GroupLayout.for_qubits(program.num_qubits),
                           program.initial_index, device, planar, n_traj)
    x, outcomes, record = _run_windows(spec, params, x, planar, generator,
                                       draws, plain)
    return finalize(x, planar), outcomes, record


# ---------------------------------------------------------------------------
# The n >= 30 forms: a provided grouped state, no complex result
# ---------------------------------------------------------------------------

def _generic_free(spec: MonomialSpec | None) -> bool:
    return spec is not None and not any(
        isinstance(s, GenericStep)
        for seg in spec.segments for s in get_group_plan(seg).steps)


def monomial_insert_evolve_ok(program, noise_model) -> bool:
    """Gate of the n >= 30 monomial splice route: monomial channels and no
    ``GenericStep`` in any segment plan (``monomial_traj.py:472-485``; see
    ``unitary_traj.unitary_insert_evolve_ok``)."""
    return _generic_free(monomial_spec(program, noise_model))


def monomial_monitored_evolve_ok(program, noise_model,
                                 events: tuple) -> bool:
    """Gate of the n >= 30 monitored route: monomial (or no) noise and no
    ``GenericStep`` in any segment plan."""
    return _generic_free(monomial_spec(program, noise_model, tuple(events)))


def monomial_insert_evolve(program, noise_model, params, x: torch.Tensor,
                           generator=None, draws=None, plain: bool = False):
    """Monomial-splice evolution of a provided batched grouped state (real
    or planar as ``trajectory_is_real`` says), normalized once in place:
    ``(x, draws)`` (``monomial_traj.py:536-552``)."""
    spec = monomial_spec(program, noise_model)
    if spec is None:
        raise ValueError("noise model has non-monomial channels; use "
                         "bigtraj.huge_trajectory_evolve")
    x, _, record = _run_windows(spec, params, x, not spec.real, generator,
                                draws, plain)
    return normalize_(x), record


def monomial_monitored_evolve(program, noise_model, events, params,
                              x: torch.Tensor, generator=None, draws=None,
                              plain: bool = False):
    """Monitored evolution of a provided batched grouped state: the
    n >= 30 form of ``monomial_monitored_body``
    (``monomial_traj.py:570-589``). Returns ``(x, outcomes (T, M) int64,
    draws)``."""
    spec = monomial_spec(program, noise_model, tuple(events))
    if spec is None:
        raise ValueError("noise model has non-monomial channels; the "
                         "huge monitored path needs the reference "
                         "channel family (or no noise)")
    x, outcomes, record = _run_windows(spec, params, x, not spec.real,
                                       generator, draws, plain)
    return normalize_(x), outcomes, record
