"""The per-gate fold executor, the huge-state trajectory entry points and
the realness analysis of noisy trajectories.

Counterpart of ``quantum_simulator_tpu/ops/bigtraj.py``.

* ``phase_real_stack``, ``trajectory_is_real`` (``:73-108``): Kraus
  stacks that are real up to a global phase per operator (all four
  reference channels: Y realifies to ``-iY``) keep an all-real circuit's
  trajectory real, so its state is one real plane instead of two. A
  per-branch global phase is unobservable: branch probabilities, later
  draws, marginals, samples and reduced density matrices do not change.
* The fold executor (``huge_trajectory_evolve``, ``:539-696``), for
  channels that are neither mixed-unitary nor monomial. The branch
  probabilities of a gate's draws need only the reduced density matrix
  rho of its <= 3 targets, and rho evolves under the gate and each drawn
  Kraus operator by 2^k x 2^k algebra, so the gate and all its draws fold
  into one operator ``(K_sel / sqrt(p)) .. @ U`` that touches the state
  once: an axis gate is one ``dense_axis`` launch, a cross gate one
  ``cross_bit_axis`` launch, for the whole batch with one operator per
  trajectory. The next unit's rho is a reduction over the state just
  written (``_rho_from``). Probabilities, draws and folds stay on the
  device: no host synchronisation inside the gate loop.
* The n >= 30 entry points (``huge_trajectory_sample_fn``,
  ``huge_monitored_sample_fn``, ``huge_trajectory_gram_fn``) as plain
  functions over the three evolutions (unitary splice, monomial splice,
  fold). Every body takes a leading batch of trajectories; n >= 30 calls
  them with a batch of 1. Under ``enable_complex128`` every state,
  operator and reduction here is float64 / complex128.

Left behind: the chunked passes (``_apply_pass``, ``_norm_sq_chunked``)
and the donation chain with its caches and layouts, which bound XLA's
out-of-place steps; here the kernels write in place and the reductions
run over views.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import CONFIG
from . import plan as gplan
from .plan import (
    GroupLayout,
    _diag_product_value,
    _op_is_real,
    apply_cphase_grouped,
    apply_gate_grouped,
    categorical,
    chunk_ranges,
    expose_bits,
    layout_basis_state,
)

_FOLD_MAX_TARGETS = 3   # joint-rho folding bound: 8 x 8 trace algebra
# Rows of one block of a Gram product: sums in the state's precision run
# over this many terms, the blocks' partial sums are added in float64.
_GRAM_BLOCK = 4096

def phase_real_stack(stack: np.ndarray) -> np.ndarray | None:
    """``(m, 2, 2)`` complex Kraus stack -> float64 real stack when every
    operator is real up to a global phase, else None
    (``Y -> -iY = [[0, -1], [1, 0]]``); callers cast it to their
    precision."""
    out = []
    for K in np.asarray(stack):
        flat = K.reshape(-1)
        j = int(np.argmax(np.abs(flat)))
        a = flat[j]
        if abs(a) < 1e-30:
            out.append(np.zeros((2, 2)))
            continue
        R = K * (np.conj(a) / abs(a))
        if not np.allclose(R.imag, 0.0, atol=1e-10):
            return None
        out.append(R.real)
    return np.stack(out)


def trajectory_is_real(program, noise_model) -> bool:
    """True when the whole stochastic trajectory stays real: every circuit
    operator real and every Kraus stack phase-real."""
    if not all(_op_is_real(op) for op in program.ops):
        return False
    seen: set[str] = set()
    for op in program.ops:
        if op.gate_name in seen:
            continue
        seen.add(op.gate_name)
        for st in noise_model.kraus_stacks_for_gate(op.gate_name):
            if phase_real_stack(st) is None:
                return False
    return True


# ---------------------------------------------------------------------------
# Reductions over the batched grouped state
# ---------------------------------------------------------------------------

def _gram(xr: torch.Tensor, lead: int, tdims: list[int],
          planar: bool) -> torch.Tensor:
    """``(T, D, D)`` ``CONFIG.dtype`` Gram ``G[P, R] = sum_rest psi[.. P ..]
    conj(psi[.. R ..])`` over the dims ``tdims`` (after ``lead``; the first
    is the MSB of the D-index) of a batched state ``(T, [2,] *dims)``. The
    state is cut along its largest other dim; each chunk is copied with the
    target dims last and multiplied with itself in blocks of
    ``_GRAM_BLOCK`` rows, whose partial sums add up in float64."""
    dims = tuple(xr.shape[lead:])
    T = xr.shape[0]
    D = int(np.prod([dims[d] for d in tdims], dtype=np.int64))
    others = [d for d in range(len(dims)) if d not in tdims]
    order = (list(range(lead)) + [lead + d for d in others]
             + [lead + d for d in tdims])
    rr = torch.zeros((T, D, D), dtype=torch.float64, device=xr.device)
    ri = torch.zeros_like(rr)

    def add(v):
        m = v.permute(order).reshape(tuple(v.shape[:lead]) + (-1, D))
        blk = min(m.shape[-2], _GRAM_BLOCK)
        m = m.reshape(tuple(v.shape[:lead]) + (-1, blk, D))
        g = torch.matmul(m.transpose(-1, -2), m)
        if not planar:
            rr.add_(g.sum(1, dtype=torch.float64))
            return
        rr.add_(g.sum((1, 2), dtype=torch.float64))
        c = torch.matmul(m[:, 1].transpose(-1, -2), m[:, 0]).sum(
            1, dtype=torch.float64)
        ri.add_(c - c.transpose(-1, -2))

    free = [d for d in others if dims[d] > 1]
    if free:
        cut = max(free, key=lambda d: dims[d])
        for start, width in chunk_ranges(dims[cut], xr.numel()):
            add(xr.narrow(lead + cut, start, width))
    else:
        add(xr)
    return torch.complex(rr, ri).to(CONFIG.dtype)


def _rho_from(x: torch.Tensor, tbits, planar: bool) -> torch.Tensor:
    """``(T, 2^k, 2^k)`` complex reduced density matrices of the target
    bits ``(axis, pos)`` (in the op's target order: the first target is
    the MSB of the rho index) of a batched grouped state
    (``bigtraj.py:141-171``). Unnormalized: the trace is ``|psi|^2``."""
    lead = 1 + int(planar)
    new_shape, index = expose_bits(tuple(x.shape[lead:]), tbits)
    return _gram(x.reshape(tuple(x.shape[:lead]) + new_shape), lead,
                 [index[t] for t in tbits], planar)


def batched_norm_sq(x: torch.Tensor) -> torch.Tensor:
    """``(T,)`` float64 ``|psi|^2`` of each trajectory of a batched
    grouped state (planes included), chunk by chunk."""
    flat = x.reshape(x.shape[0], -1)
    total = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    step = max(1, gplan.CHUNK_ELEMS // x.shape[0])
    for start in range(0, flat.shape[1], step):
        total += flat[:, start:start + step].square().sum(
            -1, dtype=torch.float64)
    return total


def normalize_(x: torch.Tensor) -> torch.Tensor:
    """Scale each trajectory of a batched grouped state to norm 1, in
    place: one exact division that changes no branch."""
    inv = torch.rsqrt(batched_norm_sq(x).clamp(min=1e-30)).to(x.dtype)
    return x.mul_(inv.reshape((-1,) + (1,) * (x.ndim - 1)))


# ---------------------------------------------------------------------------
# Appliers and draw algebra
# ---------------------------------------------------------------------------

def _matrix_kind(layout: GroupLayout, targets) -> str:
    """'axis' | 'cross' | 'bits' by target structure alone."""
    axes_bits: dict[int, int] = {}
    for q in targets:
        ax = layout.axis_of(q)
        axes_bits[ax] = axes_bits.get(ax, 0) + 1
    if len(axes_bits) == 1:
        return "axis"
    if len(axes_bits) == 2 and min(axes_bits.values()) == 1:
        return "cross"
    return "bits"


def _classify(layout: GroupLayout, op) -> str:
    """'axis' | 'cross' | 'bits' | 'prod', or ``ValueError`` for a gate
    the fold executor has no applier for: more than three targets across
    three groups and not of controlled-phase form
    (``bigtraj.py:286-306``). 'axis' is a ``dense_axis`` launch, 'cross'
    a ``cross_bit_axis`` launch, 'bits' a contraction against the exposed
    bits, 'prod' a broadcast product."""
    if op.cphase_value is not None:
        return "prod"
    kind = _matrix_kind(layout, op.targets)
    if kind != "bits":
        return kind
    if _diag_product_value(op) is not None:
        return "prod"
    if len(op.targets) <= _FOLD_MAX_TARGETS:
        return "bits"
    raise ValueError(
        f"{op.gate_name} on {len(op.targets)} qubits {op.targets} is "
        "neither <= 3 targets nor controlled-phase-form; the fold "
        "executor has no applier for it")


def _embed_kraus_np(stack: np.ndarray, k: int, j: int) -> np.ndarray:
    """Embed a (m, 2, 2) stack at target position j of a k-qubit space
    (first target = MSB): (m, 2^k, 2^k)."""
    pre = np.eye(1 << j)
    post = np.eye(1 << (k - 1 - j))
    return np.stack([np.kron(np.kron(pre, K), post) for K in stack])


def _branch_norms(Kt: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """``p[t, m] = tr(K_m rho_t K_m^+)`` for a stacked (m, D, D) set."""
    return torch.einsum("mij,tjk,mik->tm", Kt, rho, Kt.conj()).real


def _draw_and_fold(Kt: torch.Tensor, rho: torch.Tensor, generator,
                   forced: torch.Tensor | None):
    """One stochastic Kraus draw per trajectory: ``(K_sel / sqrt(p),
    rho after, branch index)``, with the clamping of
    ``plan.group_trajectory_body``; ``forced`` replays given indices."""
    norms = _branch_norms(Kt, rho)
    idx = forced if forced is not None else categorical(norms + 1e-30,
                                                        generator)
    p = norms.gather(1, idx[:, None]).squeeze(1).clamp(min=1e-30)
    Ksel = Kt[idx] * torch.rsqrt(p)[:, None, None]
    return Ksel, Ksel @ rho @ Ksel.conj().transpose(-1, -2), idx


def _initial_rho(program, targets) -> torch.Tensor:
    """(D, D) rho of ``targets`` in the initial basis state (one-hot)."""
    n = program.num_qubits
    v = 0
    for q in targets:
        v = (v << 1) | ((program.initial_index >> (n - 1 - q)) & 1)
    e = torch.zeros((1 << len(targets),) * 2, dtype=CONFIG.dtype)
    e[v, v] = 1.0
    return e


# ---------------------------------------------------------------------------
# The fold executor
# ---------------------------------------------------------------------------

def _fold_units(program, noise_model, layout: GroupLayout, planar: bool):
    """Host-side unit plan (``bigtraj.py:561-599``): ``('fold', op index,
    first draw, stacks)`` for a gate and all its draws as one operator,
    ``('apply', ...)`` for a bare wide op whose draws follow as ``('kraus',
    op index, draw, (stack, qubit))``. A small controlled-phase diagonal
    with channels folds densely. Returns ``(units, total_draws)``."""
    units: list[tuple] = []
    draw = 0
    stacks_cache: dict[str, list] = {}
    for oi, op in enumerate(program.ops):
        if op.gate_name not in stacks_cache:
            raw = noise_model.kraus_stacks_for_gate(op.gate_name)
            stacks_cache[op.gate_name] = [
                np.asarray(st if planar else phase_real_stack(st),
                           CONFIG.np_complex) for st in raw]
        stacks = stacks_cache[op.gate_name]
        kind = _classify(layout, op)
        k = len(op.targets)
        fold_prod = kind == "prod" and stacks and k <= _FOLD_MAX_TARGETS
        if (kind != "prod" or fold_prod) and k <= _FOLD_MAX_TARGETS:
            units.append(("fold", oi, draw, stacks))
            draw += len(stacks) * k
        else:
            units.append(("apply", oi, draw, None))
            for st in stacks:
                for q in op.targets:
                    units.append(("kraus", oi, draw, (st, q)))
                    draw += 1
    return units, draw


def huge_trajectory_evolve(program, noise_model, params, x: torch.Tensor,
                           generator: torch.Generator | None = None,
                           draws: torch.Tensor | None = None,
                           plain: bool = False, from_basis: bool = False):
    """Fold-executor evolution of a provided batched grouped state, planar
    ``(T, 2, *axes)`` or real ``(T, *axes)`` as ``trajectory_is_real``
    says, in place where the kernels run. The draw order and clamping are
    those of ``plan.group_trajectory_body``, so given the same branch
    indices both take the same trajectory. Returns ``(x, draws (T,
    total_draws))``; passing ``draws`` replays them. ``from_basis``: ``x``
    is the untouched basis state, whose first rho needs no reduction."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)
    T, device = x.shape[0], x.device
    units, total_draws = _fold_units(program, noise_model, layout, planar)
    replay = draws is not None
    if not replay:
        draws = torch.zeros((T, total_draws), dtype=torch.long,
                            device=device)

    def tbits_of(qubits):
        return tuple((layout.axis_of(q), layout.pos_in_axis(q))
                     for q in qubits)

    def rho_need(unit):
        kind, oi, _, extra = unit
        if kind == "fold":
            return program.ops[oi].targets if extra else None
        return (extra[1],) if kind == "kraus" else None

    def op_matrix(op) -> torch.Tensor:
        if op.cphase_value is not None:
            m = np.eye(1 << len(op.targets), dtype=CONFIG.np_complex)
            m[-1, -1] = complex(op.cphase_value)
        else:
            m = program.op_matrix(op, params)
        return torch.from_numpy(np.ascontiguousarray(m)).to(device)[None]

    def draw(Kt, rho, d):
        Ksel, rho, idx = _draw_and_fold(Kt, rho, generator,
                                        draws[:, d] if replay else None)
        if not replay:
            draws[:, d] = idx
        return Ksel, rho

    rho = None
    for ui, unit in enumerate(units):
        kind, oi, draw_base, extra = unit
        op = program.ops[oi]
        need = rho_need(unit)
        if need is not None and rho is None:
            if ui == 0 and from_basis:
                rho = _initial_rho(program, need).to(device)[None].expand(
                    T, -1, -1)
            else:
                rho = _rho_from(x, tbits_of(need), planar)
        if kind == "fold":
            Ue = op_matrix(op)
            if extra:
                k = len(op.targets)
                rho_c = Ue @ rho @ Ue.conj().transpose(-1, -2)
                d = draw_base
                for st in extra:
                    for j in range(k):
                        Kt = torch.from_numpy(_embed_kraus_np(
                            st, k, j).astype(CONFIG.np_complex)).to(device)
                        Ksel, rho_c = draw(Kt, rho_c, d)
                        Ue = Ksel @ Ue
                        d += 1
            x = apply_gate_grouped(x, Ue, op.targets, layout, plain, planar)
        elif kind == "apply":
            v = (op.cphase_value if op.cphase_value is not None
                 else _diag_product_value(op))
            if v is not None:
                x = apply_cphase_grouped(x, op.targets, v, layout, planar)
            else:
                x = apply_gate_grouped(x, op_matrix(op), op.targets, layout,
                                       plain, planar)
        else:
            st, q = extra
            Ksel, _ = draw(torch.from_numpy(st).to(device), rho, draw_base)
            x = apply_gate_grouped(x, Ksel, (q,), layout, plain, planar)
        nxt = rho_need(units[ui + 1]) if ui + 1 < len(units) else None
        rho = _rho_from(x, tbits_of(nxt), planar) if nxt is not None \
            else None
    if total_draws:
        # each draw rescaled by an estimate of 1/sqrt(p) in the state's
        # precision; one exact division restores |psi| = 1 and changes no
        # branch
        x = normalize_(x)
    return x, draws


def fold_supported(program) -> bool:
    """True when every op has a fold applier (``_classify`` raises only
    for gates of more than three targets that are not of controlled-phase
    form): the routing check of ``program.trajectory_route``."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    try:
        for op in program.ops:
            _classify(layout, op)
    except ValueError:
        return False
    return True


def _basis(program, noise_model, n_traj: int, device):
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)
    return layout_basis_state(layout, program.initial_index, device, planar,
                              n_traj), planar


def fold_trajectory_body(program, noise_model, params, n_traj: int, device,
                         generator: torch.Generator | None = None,
                         draws: torch.Tensor | None = None,
                         plain: bool = False):
    """``n_traj`` folded stochastic trajectories from the basis state:
    ``(states (T, 2^n) CONFIG.dtype, draws)``, the draw schedule of
    ``plan.group_trajectory_body`` with one state pass per gate instead of
    one per gate and draw (``bigtraj.py:759-783``)."""
    x, planar = _basis(program, noise_model, n_traj, device)
    x, draws = huge_trajectory_evolve(program, noise_model, params, x,
                                      generator, draws, plain,
                                      from_basis=True)
    if planar:
        return gplan._combine(x), draws
    return x.reshape(n_traj, -1).to(CONFIG.dtype), draws


def trajectory_evolve_route(program, noise_model) -> str:
    """Which evolution serves a provided grouped state
    (``bigtraj.py:699-727``): ``"unitary"`` or ``"monomial"`` where the
    splice applies and no segment plan holds a ``GenericStep``, else
    ``"fold"``."""
    from .monomial_traj import monomial_insert_evolve_ok
    from .unitary_traj import unitary_insert_evolve_ok

    if unitary_insert_evolve_ok(program, noise_model):
        return "unitary"
    if monomial_insert_evolve_ok(program, noise_model):
        return "monomial"
    return "fold"


def huge_trajectory_state_body(program, noise_model, params, n_traj: int,
                               device, generator=None, draws=None,
                               plain: bool = False):
    """``(x, planar, draws)``: ``n_traj`` noisy trajectories from the basis
    state as a batched grouped state, never flattened to complex
    (``bigtraj.py:730-742``). ``draws`` replays what an earlier call
    returned."""
    from .monomial_traj import monomial_insert_evolve
    from .unitary_traj import unitary_insert_evolve

    x, planar = _basis(program, noise_model, n_traj, device)
    route = trajectory_evolve_route(program, noise_model)
    if route == "unitary":
        x, draws = unitary_insert_evolve(program, noise_model, params, x,
                                         generator, draws, plain)
    elif route == "monomial":
        x, draws = monomial_insert_evolve(program, noise_model, params, x,
                                          generator, draws, plain)
    else:
        x, draws = huge_trajectory_evolve(program, noise_model, params, x,
                                          generator, draws, plain,
                                          from_basis=True)
    return x, planar, draws


# ---------------------------------------------------------------------------
# Axis Grams -> per-qubit reduced density matrices
# ---------------------------------------------------------------------------

def axis_grams(x: torch.Tensor, planar: bool) -> tuple[torch.Tensor, ...]:
    """Per-data-axis Gram matrices ``G_ax[t, p, q] = sum_rest psi[..p..]
    conj(psi[..q..])`` of a batched grouped state, ``(T, S, S)``
    ``CONFIG.dtype`` each (``bigtraj.py:790-816``). Every single-qubit
    reduced density matrix follows by a small partial trace on the
    host."""
    lead = 1 + int(planar)
    return tuple(_gram(x, lead, [ax], planar)
                 for ax in range(x.ndim - lead))


def gram_to_qubit_rho(gram: np.ndarray, axis_bits: int,
                      pos: int) -> np.ndarray:
    """Partial-trace an (S, S) axis Gram down to the 2 x 2 reduced density
    matrix of the bit at MSB-first ``pos``."""
    pre = 1 << pos
    post = 1 << (axis_bits - pos - 1)
    return np.einsum("aibajb->ij",
                     np.asarray(gram).reshape(pre, 2, post, pre, 2, post))


def qubit_rhos_from_grams(grams, num_qubits: int) -> np.ndarray:
    """(n, 2, 2) complex128 per-qubit reduced density matrices from one
    trajectory's per-axis (S, S) Grams (or, the map being linear, from
    their sum over trajectories)."""
    layout = GroupLayout.for_qubits(num_qubits)
    host = [np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g,
                       dtype=np.complex128) for g in grams]
    out = np.empty((num_qubits, 2, 2), np.complex128)
    for q in range(num_qubits):
        ax = layout.axis_of(q)
        out[q] = gram_to_qubit_rho(host[ax], layout.axis_bits[ax],
                                   layout.pos_in_axis(q))
    return out


# ---------------------------------------------------------------------------
# Measurement-basis rotation as one composed pass per axis
# ---------------------------------------------------------------------------

_H_NP = (1.0 / np.sqrt(2.0)) * np.array([[1.0, 1.0], [1.0, -1.0]])
# Y basis: S-dagger then H per qubit
_HSD_NP = _H_NP @ np.diag([1.0, -1.0j])


def apply_basis_rotation(x: torch.Tensor, basis: str, layout: GroupLayout,
                         planar: bool, plain: bool = False
                         ) -> tuple[torch.Tensor, bool]:
    """Rotate a batched grouped state into the X or Y measurement basis
    with one kron operator per axis (H^k for X, (H S+)^k for Y): one
    ``dense_axis`` launch each. A real state rotating to Y gets a zero
    imaginary plane first. Returns ``(x, planar)``."""
    if basis == "Z":
        return x, planar
    m = _H_NP if basis == "X" else _HSD_NP
    if basis == "Y" and not planar:
        x = torch.stack([x, torch.zeros_like(x)], dim=1)
        planar = True
    dense = gplan.cuda_exec.dense_axis_plain if plain \
        else gplan.cuda_exec.dense_axis
    T = x.shape[0]
    for ax, bits in enumerate(layout.axis_bits):
        op = m
        for _ in range(bits - 1):
            op = np.kron(op, m)
        if basis == "X":
            opnd = torch.from_numpy(op.real).to(x.device, x.dtype)
        else:
            opnd = torch.from_numpy(np.stack([op.real, op.imag])).to(
                x.device, x.dtype)
        x = dense(x.contiguous(), opnd[None].expand((T,) + opnd.shape), ax,
                  planar, True)
    return x, planar


# ---------------------------------------------------------------------------
# The n >= 30 entry points
# ---------------------------------------------------------------------------

class TrajectorySample(NamedTuple):
    """What one huge-path trajectory hands back; absent parts are None."""

    state: torch.Tensor | None      # grouped state without the batch axis
    marginals: tuple | None
    indices: torch.Tensor | None    # (shots,) int64 basis indices
    draws: object                   # replays the trajectory


def huge_trajectory_sample_fn(program, noise_model, shots: int, device,
                              keep_state: bool = False, basis: str = "Z",
                              plain: bool = False) -> tuple[Callable, bool]:
    """``(run, planar)`` where ``run(params, generator, sample_generator,
    draws=None)`` runs one stochastic trajectory and returns a
    ``TrajectorySample``: with ``keep_state`` the state and its axis
    marginals, with ``shots > 0`` that many Z-basis indices. ``basis``
    rotates before sampling and so needs ``keep_state=False``: run the
    trajectory again with the returned ``draws`` for the unrotated state
    (``bigtraj.py:1088-1122``)."""
    from .bigstate import sample_state_indices, state_axis_marginals

    if shots <= 0 and not keep_state:
        raise ValueError(
            "shots=0 with keep_state=False would evolve the trajectory "
            "and return nothing; pass keep_state=True (state+marginals) "
            "or use huge_trajectory_gram_fn for ensemble reductions")
    if basis != "Z" and keep_state:
        raise ValueError("basis rotation overwrites the state; use "
                         "keep_state=False (run again with the returned "
                         "draws for the unrotated state)")
    layout = GroupLayout.for_qubits(program.num_qubits)
    planar = not trajectory_is_real(program, noise_model)

    def run(params, generator, sample_generator=None, draws=None):
        x, _, draws = huge_trajectory_state_body(
            program, noise_model, params, 1, device, generator, draws,
            plain)
        marg = state_axis_marginals(x[0], planar) if keep_state else None
        idx = None
        if shots > 0:
            xs, pl = apply_basis_rotation(x, basis, layout, planar, plain)
            idx = sample_state_indices(xs[0], shots, pl, sample_generator)
        return TrajectorySample(x[0] if keep_state else None, marg, idx,
                                draws)

    return run, planar


def huge_monitored_sample_fn(program, noise_model, events: tuple,
                             shots: int, device, plain: bool = False
                             ) -> tuple[Callable, bool]:
    """``(run, planar)`` for n >= 30 monitored trajectories: ``run(params,
    generator, sample_generator, draws=None) -> (outcomes (M,) int64,
    indices (shots,) int64 or None)``: mid-circuit collapse through the
    monomial splice, then Z-basis sampling of the final state; the state
    never leaves the function (``bigtraj.py:1125-1176``). Noise, if any,
    must be monomial."""
    from .bigstate import sample_state_indices
    from .monomial_traj import monomial_monitored_evolve, monomial_spec

    spec = monomial_spec(program, noise_model, tuple(events))
    if spec is None:
        raise ValueError(
            "huge monitored trajectories need monomial noise channels "
            "(the reference family) or a noise-free circuit")
    planar = not spec.real
    layout = GroupLayout.for_qubits(program.num_qubits)

    def run(params, generator, sample_generator=None, draws=None):
        x = layout_basis_state(layout, program.initial_index, device,
                               planar, 1)
        x, outs, _ = monomial_monitored_evolve(
            program, noise_model, events, params, x, generator, draws,
            plain)
        idx = (sample_state_indices(x[0], shots, planar, sample_generator)
               if shots > 0 else None)
        return outs[0], idx

    return run, planar


def huge_trajectory_gram_fn(program, noise_model, device,
                            plain: bool = False) -> tuple[Callable, bool]:
    """``(run, planar)`` where ``run(params, generator)`` runs one
    trajectory and returns only its per-axis (S, S) Grams, the state
    freed: the n >= 30 ensemble-reduction primitive
    (``bigtraj.py:1179-1197``)."""
    planar = not trajectory_is_real(program, noise_model)

    def run(params, generator):
        x, _, _ = huge_trajectory_state_body(
            program, noise_model, params, 1, device, generator, None, plain)
        return tuple(g[0] for g in axis_grams(x, planar))

    return run, planar
