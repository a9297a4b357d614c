"""Large states (n >= 30): results, reductions and sampling that never
copy the state.

Counterpart of ``quantum_simulator_tpu/ops/bigstate.py``. From
``HUGE_MIN_QUBITS`` on, ``Simulator`` returns the executor's grouped
tensor as it is, planar ``(2, *axis_sizes)`` or real ``(*axis_sizes,)``,
wrapped in a ``PlanarStateVector``: a planar float32 state is
8 / 16 / 32 GiB at n = 30 / 31 / 32 (a real one half of that) on an 80 GB
card, twice that in float64 under ``enable_complex128`` (to n = 31), so a
complex copy, a full probability vector with its cumulative sum, or a
``2^n``-long histogram would each cost as much as the state again. Every
reduction here returns the state's precision or float64. What is
carried over:

* ``state_axis_marginals``, ``planar_norm_sq``: reductions over views of
  about ``plan.CHUNK_ELEMS`` elements, accumulated in float64;
* ``sample_state_indices``: the two-level inverse CDF
  (``bigstate.py:756-902``): per-block sums and a small block CDF, then,
  for each batch of at most ``SAMPLE_BATCH`` draws, the draws' S-wide
  tiles gathered from the state itself. It returns int64 basis indices,
  so n = 32 needs no special case;
* ``PlanarStateVector`` with its marginal, Z-string and Pauli-string
  expectations, and ``MarginalStateSummary`` / ``huge_step_marginals_fn``
  for column-by-column stepping.

Left behind: the chunk schedule (``auto_chunks``,
``execute_group_plan_chunked``), the bf16 probabilities tier and the
donation and layout plumbing. They bound XLA's out-of-place steps on a
smaller device; the port's kernels write in place and its other steps
run over views (``plan.apply_in_chunks``), so the executor holds one
state. The JAX sampler squares the whole state into a probability matrix
to keep XLA from relayouting its input; here a tile is a strided view,
so no such matrix is built.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import numpy as np
import torch

from ..utils.profiling import span
from . import plan as gplan
from .plan import GroupLayout, chunk_ranges

# From this many qubits on, results are planar and never complex: the JAX
# package's ``auto_chunks(n) > 1`` threshold (``simulator.py:107-114``),
# which is API (the kind of result a caller gets), without its backend
# condition.
HUGE_MIN_QUBITS = 30

# Draws per tile-gather batch (bounds the gathered tiles: 2048 x 2^14
# amplitudes a plane, 128 MiB of float32 or 256 MiB of float64).
SAMPLE_BATCH = 2048


def is_huge(num_qubits: int) -> bool:
    return num_qubits >= HUGE_MIN_QUBITS


def planar_probabilities(x: torch.Tensor) -> torch.Tensor:
    """``(2^n,)`` ``|amp|^2`` of a planar state in its precision: one
    output, no other temporary."""
    return _chunk_probabilities(x, True).reshape(-1)


def planar_norm_sq(x: torch.Tensor) -> torch.Tensor:
    """``sum x^2`` of a planar or real state as a float64 scalar tensor,
    chunk by chunk."""
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    step = gplan.CHUNK_ELEMS
    for start in range(0, flat.numel(), step):
        total += flat[start:start + step].square().sum(dtype=torch.float64)
    return total


def _chunk_probabilities(v: torch.Tensor, planar: bool) -> torch.Tensor:
    """``|amp|^2`` of a state or of a chunk view of one (a new tensor)."""
    if not planar:
        return v.square()
    out = v[0].square()
    out.addcmul_(v[1], v[1])
    return out


def state_axis_marginals(x: torch.Tensor, planar: bool
                         ) -> tuple[torch.Tensor, ...]:
    """Per-data-axis probability marginals: for each tensor axis the
    ``(axis_size,)`` vector of ``|amp|^2`` summed over every other axis,
    in the state's precision. The state is cut along its first two axes
    into chunks; each chunk's squares are reduced once per axis and
    accumulated in float64."""
    with span("bigstate.marginals"):
        lead = int(planar)
        shape = tuple(x.shape[lead:])
        rank = len(shape)
        if rank == 1:
            return (_chunk_probabilities(x, planar),)
        a0, a1 = shape[0], shape[1]
        rows = x.reshape(tuple(x.shape[:lead]) + (a0 * a1,) + shape[2:])
        m01 = torch.zeros(a0 * a1, dtype=torch.float64, device=x.device)
        rest = [torch.zeros(s, dtype=torch.float64, device=x.device)
                for s in shape[2:]]
        for start, width in chunk_ranges(a0 * a1, x.numel()):
            sq = _chunk_probabilities(rows.narrow(lead, start, width), planar)
            m01[start:start + width] = sq.reshape(width, -1).sum(
                -1, dtype=torch.float64)
            for k, acc in enumerate(rest):
                acc += sq.sum(dim=[d for d in range(sq.ndim) if d != k + 1],
                              dtype=torch.float64)
        m01 = m01.reshape(a0, a1)
        return tuple(m.to(x.dtype) for m in [m01.sum(1), m01.sum(0)] + rest)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_planar_indices(x: torch.Tensor, shots: int,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """Two-level inverse-CDF sampler over a planar ``(2, *axes)`` state."""
    return sample_state_indices(x, shots, True, generator)


def sample_state_indices(x: torch.Tensor, shots: int, planar: bool = True,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """``shots`` basis indices (int64, on the state's device) drawn from
    ``|amp|^2`` of a planar ``(2, *axes)`` or real ``(*axes,)`` state
    without a full-length CDF (``bigstate.py:761-902``).

    The data axes are MSB-first groups of the basis index, so the state
    flattens in basis order into ``nblocks`` tiles of ``S`` amplitudes
    (``S`` = the trailing two axes, 2^14 from n = 14 on).

    1. block sums, chunk by chunk in float64, and their ``nblocks``-long
       CDF; each draw ``u`` in ``(0, total]`` takes the first block whose
       CDF reaches it, and the fraction of that block's mass it lies at;
    2. per batch of at most ``SAMPLE_BATCH`` draws, the draws' tiles are
       gathered from the state, squared and summed in float64 along the
       tile; the draw takes the first entry whose in-tile CDF reaches its
       fraction of the tile's sum.

    With ``u > 0`` and "first entry that reaches" on both levels, a draw
    never lands on a block or an entry of zero probability, however the
    two levels' sums round."""
    with span("bigstate.sample"):
        lead = int(planar)
        shape = tuple(x.shape[lead:])
        tile = shape[-2:] if len(shape) >= 3 else shape[-1:]
        S = int(np.prod(tile, dtype=np.int64))
        nblocks = int(np.prod(shape, dtype=np.int64)) // S
        flat = x.reshape(tuple(x.shape[:lead]) + (nblocks, S))
        bsums = torch.empty(nblocks, dtype=torch.float64, device=x.device)
        for start, width in chunk_ranges(nblocks, x.numel()):
            sq = _chunk_probabilities(flat.narrow(lead, start, width), planar)
            bsums[start:start + width] = sq.sum(-1, dtype=torch.float64)
        bcdf = torch.cumsum(bsums, dim=0)
        u = (1.0 - torch.rand(shots, dtype=torch.float64, device=x.device,
                              generator=generator)) * bcdf[-1]
        b = torch.searchsorted(bcdf, u).clamp_(max=nblocks - 1)
        below = torch.where(b > 0, bcdf[(b - 1).clamp(min=0)],
                            torch.zeros_like(u))
        frac = ((u - below) / bsums[b].clamp(min=1e-300)).clamp_(0.0, 1.0)
        out = torch.empty(shots, dtype=torch.long, device=x.device)
        for start in range(0, shots, SAMPLE_BATCH):
            bb = b[start:start + SAMPLE_BATCH]
            tiles = _chunk_probabilities(flat.index_select(lead, bb), planar)
            tcdf = torch.cumsum(tiles.double(), dim=1)
            target = frac[start:start + SAMPLE_BATCH, None] * tcdf[:, -1:]
            j = torch.searchsorted(tcdf, target).squeeze(1).clamp_(max=S - 1)
            out[start:start + SAMPLE_BATCH] = bb * S + j
        return out


def indices_to_counts(idx: torch.Tensor, num_qubits: int) -> dict[str, int]:
    """``{bitstring: count}`` of drawn basis indices; only the ``shots``
    indices leave the device (``simulator.py:394-398``)."""
    vals, cnts = np.unique(idx.cpu().numpy(), return_counts=True)
    return {format(int(v), f"0{num_qubits}b"): int(c)
            for v, c in zip(vals, cnts)}


# ---------------------------------------------------------------------------
# Marginal summaries and column-by-column stepping
# ---------------------------------------------------------------------------

def qubit_probs_from_marginals(marginals, num_qubits: int) -> np.ndarray:
    """``(n,)`` per-qubit P(|1>) from per-axis probability marginals."""
    layout = GroupLayout.for_qubits(num_qubits)
    host = [np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m,
                       dtype=np.float64) for m in marginals]
    p1 = np.empty(num_qubits)
    for q in range(num_qubits):
        ax = layout.axis_of(q)
        bit = layout.axis_bits[ax] - 1 - layout.pos_in_axis(q)
        idx = (np.arange(layout.axis_sizes[ax]) >> bit) & 1
        p1[q] = host[ax][idx == 1].sum()
    total = host[0].sum()
    return p1 / total if total > 0 else p1


class MarginalStateSummary:
    """Per-column snapshot for n >= 30 stepping: per-axis probability
    marginals only (a few KB), never a state copy. Gives the per-qubit
    probabilities; the amplitudes of every column would each be a state
    (``bigstate.py:937-973``)."""

    def __init__(self, axis_marginals, num_qubits: int):
        self._marginals = axis_marginals
        self._num_qubits = num_qubits
        self._qp = None

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def axis_marginals(self):
        return self._marginals

    def qubit_probabilities(self) -> np.ndarray:
        if self._qp is None:
            self._qp = qubit_probs_from_marginals(self._marginals,
                                                  self._num_qubits)
        return self._qp

    def expectation_z(self, qubit: int) -> float:
        return float(1.0 - 2.0 * self.qubit_probabilities()[qubit])

    @property
    def data(self):
        raise MemoryError(
            f"Per-column states at n={self._num_qubits} are marginal "
            "summaries only; use qubit_probabilities()/expectation_z, or "
            "Simulator.run for the final state.")


def _column_program(program, col: int):
    """Sub-program of one column's ops (same parameter vector: offsets
    index the full one)."""
    ops_c = tuple(op for op in program.ops if op.column_index == col)
    return replace(program, ops=ops_c,
                   compile_key=program.compile_key + ("col", col))


def huge_step_marginals_fn(program, device, plain: bool = False
                           ) -> tuple[Callable, int]:
    """``(f, num_columns)`` where ``f(params)`` runs the circuit column by
    column on one state in place and returns the per-axis marginals of
    the initial state and after each column; a column with no op repeats
    the previous marginals (``bigstate.py:986-1031``)."""
    full_plan = gplan.get_group_plan(program)
    planar = not full_plan.all_real
    col_programs = [_column_program(program, c)
                    for c in range(program.num_columns)]

    def run(params):
        x = gplan.basis_state(full_plan, program.initial_index, device,
                              planar)
        outs = [state_axis_marginals(x, planar)]
        for cp in col_programs:
            if not cp.ops:
                outs.append(outs[-1])
                continue
            plan_c = gplan.get_group_plan(cp)
            operands = gplan.operands_to(
                gplan.build_group_operands(cp, plan_c, params), device)
            # a real column of a planar circuit runs its real operators
            # on both planes
            x = gplan.execute_group_plan(plan_c, operands, cp, params, x,
                                         planar, plain)
            outs.append(state_axis_marginals(x, planar))
        return outs

    return run, program.num_columns


# ---------------------------------------------------------------------------
# Pauli-string sums
# ---------------------------------------------------------------------------

def _axis_parity_vector(layout: GroupLayout, ax: int, qubits) -> np.ndarray:
    """``(S_ax,)`` float64 vector of (-1)^(parity of this axis's queried
    bits) over the axis index (exact in any precision)."""
    bits = layout.axis_bits[ax]
    sel = 0
    for q in qubits:
        sel |= 1 << (bits - 1 - layout.pos_in_axis(q))
    v = np.arange(layout.axis_sizes[ax]) & sel
    pc = np.zeros_like(v)
    while np.any(v):
        pc += v & 1
        v >>= 1
    return np.where(pc % 2 == 1, -1.0, 1.0)


def pauli_string_sum(x: torch.Tensor, planar: bool,
                     perm_masks: tuple[tuple[int, int], ...],
                     sign_vecs: dict) -> tuple[float, float]:
    """``(re, im)`` of ``S = sum_j conj(x[j ^ mask]) * prod_ax
    sign_ax(j_ax) * x[j]`` as a read-only pass (``bigstate.py:402-497``,
    and with no mask ``:500-531``). ``perm_masks`` is ``((axis,
    xor_mask), ...)`` for the axes that carry X or Y bits; ``sign_vecs``
    maps an axis to its ``(S_ax,)`` +-1 vector on the device. The state is
    cut along its largest axis that carries no X or Y bit, so the
    permuted copy is a chunk's; a string with X or Y bits on every axis
    permutes the whole state at once."""
    lead = int(planar)
    shape = tuple(x.shape[lead:])
    rank = len(shape)
    perm_axes = {ax for ax, _ in perm_masks}
    free = [a for a, s in enumerate(shape) if a not in perm_axes and s > 1]
    perms = [(ax, torch.arange(shape[ax], device=x.device) ^ mask)
             for ax, mask in perm_masks]

    def inner(blk, vecs):
        t = blk
        for ax, idx in perms:
            t = t.index_select(lead + ax, idx)
        if planar:
            pr = t[0] * blk[0]
            pr.addcmul_(t[1], blk[1])
            pi = None
            if perms:
                pi = t[0] * blk[1]
                pi.addcmul_(t[1], blk[0], value=-1.0)
        else:
            pr, pi = t * blk, None
        for ax, v in vecs.items():
            vshape = [1] * rank
            vshape[ax] = v.shape[0]
            pr.mul_(v.reshape(vshape))
            if pi is not None:
                pi.mul_(v.reshape(vshape))
        return (pr.sum(dtype=torch.float64),
                pi.sum(dtype=torch.float64) if pi is not None else 0.0)

    if not free:
        re, im = inner(x, sign_vecs)
        return float(re), float(im)
    cut = max(free, key=lambda a: shape[a])
    re = torch.zeros((), dtype=torch.float64, device=x.device)
    im = torch.zeros((), dtype=torch.float64, device=x.device)
    for start, width in chunk_ranges(shape[cut], x.numel()):
        vecs = {ax: (v.narrow(0, start, width) if ax == cut else v)
                for ax, v in sign_vecs.items()}
        r, m = inner(x.narrow(lead + cut, start, width), vecs)
        re += r
        im += m
    return float(re), float(im)


# ---------------------------------------------------------------------------
# The host-facing state
# ---------------------------------------------------------------------------

class PlanarStateVector:
    """Host-facing wrapper of the executor's grouped state: the n >= 30
    stand-in for ``StateVector`` (``bigstate.py:1034-1284``). The tensor
    is planar ``(2, *axis_sizes)`` or, for an all-real evolution, real
    ``(*axis_sizes,)`` (``planar=False``), float32 or (under
    ``enable_complex128``) float64. It serves the queries
    that need no complex copy; ``.data`` raises ``MemoryError``."""

    def __init__(self, state: torch.Tensor, num_qubits: int,
                 planar: bool = True, axis_marginals=None):
        self._state = state
        self._planar = planar
        self._num_qubits = num_qubits
        self._axis_marginals = axis_marginals
        self._marg_host = None
        self._qp = None

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def is_planar(self) -> bool:
        return self._planar

    @property
    def state_data(self) -> torch.Tensor:
        """The device tensor: ``(2, *axes)`` planar or ``(*axes,)`` real."""
        return self._state

    @property
    def planar_data(self) -> torch.Tensor:
        """``(2, *axes)`` planar view; for a real state this stacks a zero
        imaginary plane, a second state's worth of memory."""
        if self._planar:
            return self._state
        return torch.stack([self._state, torch.zeros_like(self._state)])

    @property
    def data(self):
        raise MemoryError(
            f"A dense complex host copy of a {self._num_qubits}-qubit state "
            f"is {(16 << self._num_qubits) / 2**30:.0f} GiB; use "
            ".amplitude(index), .probabilities_device or the expectation "
            "methods instead.")

    @property
    def probabilities_device(self) -> torch.Tensor:
        """``(2^n,)`` in the state's precision on the device: half a
        planar state's memory again, a real state's whole."""
        if self._planar:
            return planar_probabilities(self._state)
        return self._state.square().reshape(-1)

    def norm_sq(self) -> float:
        return float(planar_norm_sq(self._state))

    def _get_marginals(self) -> list[np.ndarray]:
        """Host copies of the per-axis marginals, computed at most once."""
        if self._marg_host is None:
            if self._axis_marginals is None:
                self._axis_marginals = state_axis_marginals(self._state,
                                                            self._planar)
            self._marg_host = [m.double().cpu().numpy()
                               for m in self._axis_marginals]
        return self._marg_host

    def qubit_probabilities(self) -> np.ndarray:
        """``(n,)`` per-qubit P(|1>), from the marginals captured with the
        run or computed once on first use."""
        if self._qp is None:
            self._qp = qubit_probs_from_marginals(self._get_marginals(),
                                                  self._num_qubits)
        return self._qp

    def expectation_z(self, qubit: int) -> float:
        """``<Z_qubit> = 1 - 2 P(1)``."""
        return float(1.0 - 2.0 * self.qubit_probabilities()[qubit])

    def expectation_z_string(self, qubits) -> float:
        """``<prod Z_q>`` for any qubit set. A string inside one group is
        a host sum over that axis's marginal (its joint distribution of
        up to 7 qubits); a string across groups is one parity-weighted
        pass over the state."""
        qubits = sorted(set(int(q) for q in qubits))
        if not qubits:
            return 1.0
        if qubits[0] < 0 or qubits[-1] >= self._num_qubits:
            raise ValueError(
                f"qubits {qubits} out of range for n={self._num_qubits}")
        layout = GroupLayout.for_qubits(self._num_qubits)
        by_axis: dict[int, list[int]] = {}
        for q in qubits:
            by_axis.setdefault(layout.axis_of(q), []).append(q)
        if len(by_axis) == 1:
            ax, qs = next(iter(by_axis.items()))
            m = self._get_marginals()[ax]
            total = m.sum()
            parity = _axis_parity_vector(layout, ax, qs)
            return float((m * parity).sum() / total) if total > 0 else 0.0
        num, _ = pauli_string_sum(self._state, self._planar, (),
                                  self._sign_vecs(layout, by_axis))
        total = float(self._get_marginals()[0].sum())
        return num / total if total > 0 else 0.0

    def _sign_vecs(self, layout: GroupLayout, by_axis: dict) -> dict:
        return {ax: torch.from_numpy(_axis_parity_vector(
            layout, ax, qs)).to(self._state.device, self._state.dtype)
            for ax, qs in sorted(by_axis.items())}

    def expectation_pauli_string(self, qubits, paulis: str) -> float:
        """``<prod_i P_i on qubit_i>`` for any mixed X/Y/Z string, without
        rotating or copying the state: the string is a signed permutation,
        so ``<P> = Re[i^k sum_j conj(x[j ^ mask]) sign(j) x[j]]`` with k
        the number of Y's. For a real state an odd-Y string is exactly
        0."""
        qubits = [int(q) for q in qubits]
        paulis = paulis.upper()
        if len(paulis) != len(qubits):
            raise ValueError(
                f"{len(qubits)} qubits but {len(paulis)} Paulis")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"duplicate qubits in {qubits}")
        if any(p not in "XYZ" for p in paulis):
            raise ValueError(f"Paulis must be X/Y/Z, got {paulis!r}")
        if not qubits:
            return 1.0
        if min(qubits) < 0 or max(qubits) >= self._num_qubits:
            raise ValueError(
                f"qubits {qubits} out of range for n={self._num_qubits}")
        if all(p == "Z" for p in paulis):
            return self.expectation_z_string(qubits)
        k = sum(1 for p in paulis if p == "Y")
        if not self._planar and k % 2 == 1:
            return 0.0
        layout = GroupLayout.for_qubits(self._num_qubits)
        perm_by_axis: dict[int, int] = {}
        sign_by_axis: dict[int, list[int]] = {}
        for q, p in zip(qubits, paulis):
            ax = layout.axis_of(q)
            bit = 1 << (layout.axis_bits[ax] - 1 - layout.pos_in_axis(q))
            if p in "XY":
                perm_by_axis[ax] = perm_by_axis.get(ax, 0) ^ bit
            if p in "ZY":
                sign_by_axis.setdefault(ax, []).append(q)
        perm_masks = tuple(sorted(perm_by_axis.items()))
        s_re, s_im = pauli_string_sum(
            self._state, self._planar, perm_masks,
            self._sign_vecs(layout, sign_by_axis))
        e = (s_re, -s_im, -s_re, s_im)[k % 4]
        total = float(self._get_marginals()[0].sum())
        return e / total if total > 0 else 0.0

    def amplitude(self, index: int) -> complex:
        """One basis amplitude (two floats leave the device)."""
        flat = self._state.reshape((2, -1) if self._planar else (-1,))
        if not self._planar:
            return complex(float(flat[index]), 0.0)
        pair = flat[:, index].cpu()
        return complex(float(pair[0]), float(pair[1]))

    def __repr__(self) -> str:
        shape = tuple(self._state.shape[int(self._planar):])
        return (f"PlanarStateVector(num_qubits={self._num_qubits}, "
                f"axes={shape}, planar={self._planar})")
