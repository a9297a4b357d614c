"""Group-matmul circuit executor: the port's forward path at every n.

Counterpart of ``quantum_simulator_tpu/ops/plan.py``. The n qubits are
grouped into axes of at most 7 bits (``GroupLayout``, ``plan.py:68-102``)
and the state is a planar float32 tensor ``(2, *axis_sizes)``, or a real
``(*axis_sizes,)`` one when every operator of the plan is real (float64
under ``config.enable_complex128``: every operand, state and result here
follows ``CONFIG.dtype`` / ``CONFIG.real_dtype``). The host
planner (``build_group_plan``, ``plan.py:287-510``) and the NumPy operand
build (``plan.py:517-982``, its ``xp=np`` mode) are carried over as they
are, so the port takes the same steps as the JAX package:

* ``AxisMatmulStep`` -> the ``dense_axis`` CUDA kernel (``cuda_exec.py``);
* ``CrossStep`` -> the ``cross_bit_axis`` CUDA kernel;
* ``BitPairStep`` -> a transpose for an exact SWAP, else a K=4 einsum; on
  the card each run of exact swaps on disjoint bit pairs (``swap_runs``)
  is one ``swap_bits`` CUDA kernel launch, in place over the whole state;
* ``DiagPairStep`` -> the ``diag_pair`` CUDA kernel, in place over the
  whole state in one launch (its plain twin, an elementwise einsum, on the
  CPU);
* ``DiagProductStep`` -> elementwise torch ops;
* ``GenericStep`` -> the segmented einsum of ``ops/apply.py``.

An ideal run builds its operands once on the host and moves them to the
device. Noisy trajectories run as batches: ``build_group_operands_batched``
builds every trajectory's operands on the device with a leading
trajectory axis (the noise draws enter as ``OperandOverrides``), and the
executor takes a state ``(T, [2,] *axis_sizes)``, so each dense and cross
step is one batched kernel launch. A batch of parameter rows (the
variational path, ``group_batched_forward``) takes the same route: each
parameterized op gets one matrix per row, built on the device by the
torch gate builders and injected as an override. The per-gate trajectory body
(``group_trajectory_body``) is at the end of the module. The port stores a
complex operator as two real planes ``(re, im)`` where the JAX package
stores the blocked ``[[re, -im], [im, re]]`` form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import CONFIG
from ..utils.profiling import is_recording, span, state_pass
from . import cuda_exec
from . import program as prog
from .apply import apply_gate
from .cuda_exec import _blocked, _cross_spec, _split_axis_bit

GROUP_BITS = 7

# Parameterized gates whose matrix is diagonal for every parameter value.
_DIAGONAL_PARAM_GATES = frozenset({"Rz", "Phase", "CPhase", "MCZ"})

# Parameterized gates whose matrix is real for every parameter value.
_REAL_PARAM_GATES = frozenset({"Ry"})

_SWAP_MATRIX = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


# ---------------------------------------------------------------------------
# Layout and plan structure
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupLayout:
    """Qubits -> tensor axes. Axis 0 is the most significant group (may
    hold fewer than 7 bits); the last axis holds the 7 least significant
    qubits. Qubit 0 is the MSB of the basis index."""

    num_qubits: int
    axis_sizes: tuple[int, ...]
    axis_bits: tuple[int, ...]

    @classmethod
    def for_qubits(cls, n: int) -> "GroupLayout":
        bits = []
        rem = n
        while rem > 0:
            take = min(GROUP_BITS, rem)
            bits.append(take)
            rem -= take
        bits = tuple(reversed(bits))
        return cls(num_qubits=n, axis_sizes=tuple(1 << b for b in bits),
                   axis_bits=bits)

    def axis_of(self, qubit: int) -> int:
        bitpos = self.num_qubits - 1 - qubit
        return len(self.axis_bits) - 1 - bitpos // GROUP_BITS

    def pos_in_axis(self, qubit: int) -> int:
        """MSB-first bit position of the qubit within its axis."""
        bitpos = self.num_qubits - 1 - qubit
        return self.axis_bits[self.axis_of(qubit)] - 1 - bitpos % GROUP_BITS


@dataclass(frozen=True)
class AxisMatmulStep:
    axis: int
    op_index: int   # into that axis's operator stack


@dataclass(frozen=True)
class CrossStep:
    slice_axis: int
    slice_pos: int          # MSB-first bit position within slice_axis
    op_axis: int
    index: int              # into the plan's cross-op list


@dataclass(frozen=True)
class BitPairStep:
    slice_axis: int
    slice_pos: int
    op_axis: int
    op_pos: int
    index: int              # into the plan's bitpair-spec/op lists


@dataclass(frozen=True)
class DiagPairStep:
    axis_a: int
    axis_b: int
    index: int              # into the plan's diag-op list


@dataclass(frozen=True)
class DiagProductStep:
    axes: tuple[int, ...]
    index: int              # into the plan's prod-diag segment list


@dataclass(frozen=True)
class GenericStep:
    program_op: int


@dataclass(frozen=True)
class DenseSegment:
    axis: int
    subcolumns: tuple[tuple[int, ...], ...]   # program op indices


@dataclass(frozen=True)
class CrossSpec:
    op_index: int
    slice_axis: int
    op_axis: int
    pre_op_subcolumns: tuple[tuple[int, ...], ...] = ()
    pre_slice_ops: tuple[int, ...] = ()


@dataclass(frozen=True)
class BitPairSpec:
    op_index: int
    slice_axis: int
    is_swap: bool


@dataclass(frozen=True)
class DiagSegment:
    axis_a: int
    axis_b: int
    index: int
    op_indices: tuple[int, ...]


@dataclass(frozen=True)
class DiagProductSegment:
    axes: tuple[int, ...]
    index: int
    op_index: int


@dataclass(frozen=True)
class GroupPlan:
    layout: GroupLayout
    steps: tuple
    dense_segments: tuple[DenseSegment, ...]
    cross_specs: tuple[CrossSpec, ...]
    diag_segments: tuple[DiagSegment, ...]
    prod_segments: tuple[DiagProductSegment, ...] = ()
    bitpair_specs: tuple[BitPairSpec, ...] = ()
    dense_real: tuple[tuple[bool, ...], ...] = ()   # [axis][op_index]
    cross_real: tuple[bool, ...] = ()
    diag_real: tuple[bool, ...] = ()
    prod_real: tuple[bool, ...] = ()
    bitpair_real: tuple[bool, ...] = ()
    all_real: bool = False


def _op_is_diagonal(op: prog.ProgramOp) -> bool:
    if op.cphase_value is not None:
        return True
    if op.static_matrix is not None:
        m = op.static_matrix
        return bool(np.allclose(m, np.diag(np.diagonal(m))))
    return op.gate_name in _DIAGONAL_PARAM_GATES


def _diag_product_value(op: prog.ProgramOp) -> complex | None:
    """v for controlled-phase-form diagonals (ones except the all-ones
    entry = v); None otherwise."""
    if op.cphase_value is not None:
        return complex(op.cphase_value)
    if op.static_matrix is None or not _op_is_diagonal(op):
        return None
    d = np.diagonal(op.static_matrix)
    if np.allclose(d[:-1], 1.0) and not np.isclose(d[-1], 1.0):
        return complex(d[-1])
    return None


def _op_is_real(op: prog.ProgramOp) -> bool:
    if op.cphase_value is not None:
        return bool(np.isclose(np.imag(op.cphase_value), 0.0))
    if op.static_matrix is not None:
        return bool(np.allclose(np.imag(op.static_matrix), 0.0))
    return op.gate_name in _REAL_PARAM_GATES


def build_group_plan(program: prog.CircuitProgram) -> GroupPlan:
    """Host planner, step for step ``quantum_simulator_tpu/ops/plan.py:
    287-510``: maximal composition windows per axis, diagonal pairs,
    product diagonals, crosses with folded predecessors, bit pairs and
    the generic fallback, then the adjacent-dense peephole merge and the
    static realness analysis."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    n_axes = len(layout.axis_sizes)
    steps: list = []
    dense_segments: list[DenseSegment] = []
    cross_specs: list[CrossSpec] = []
    diag_segments: list[DiagSegment] = []
    prod_segments: list[DiagProductSegment] = []
    bitpair_specs: list[BitPairSpec] = []
    counts = [0] * n_axes

    pend_dense: list[dict] = [{"ops": [], "bits": set()}
                              for _ in range(n_axes)]
    pend_diag: dict[tuple[int, int], dict] = {}

    def _subcolumns(ops_bits: list[tuple[int, set]]) -> tuple:
        subs: list[tuple[list[int], set]] = []
        for oi, bits in ops_bits:
            if subs and not (subs[-1][1] & bits):
                subs[-1][0].append(oi)
                subs[-1][1].update(bits)
            else:
                subs.append(([oi], set(bits)))
        return tuple(tuple(s[0]) for s in subs)

    def flush_dense(ax: int):
        p = pend_dense[ax]
        if not p["ops"]:
            return
        dense_segments.append(DenseSegment(
            axis=ax, subcolumns=_subcolumns(p["ops"])))
        steps.append(AxisMatmulStep(axis=ax, op_index=counts[ax]))
        counts[ax] += 1
        pend_dense[ax] = {"ops": [], "bits": set()}

    def flush_diag(pair: tuple[int, int]):
        p = pend_diag.pop(pair, None)
        if p is None or not p["ops"]:
            return
        idx = len(diag_segments)
        diag_segments.append(DiagSegment(
            axis_a=pair[0], axis_b=pair[1], index=idx,
            op_indices=tuple(p["ops"])))
        steps.append(DiagPairStep(axis_a=pair[0], axis_b=pair[1],
                                  index=idx))

    def flush_all():
        for pair in list(pend_diag):
            flush_diag(pair)
        for ax in range(n_axes):
            flush_dense(ax)

    for oi, op in enumerate(program.ops):
        bits_by_axis: dict[int, set] = {}
        for q in op.targets:
            bits_by_axis.setdefault(layout.axis_of(q), set()).add(
                layout.pos_in_axis(q))
        axes = sorted(bits_by_axis)

        if len(axes) == 1:
            ax = axes[0]
            for pair in list(pend_diag):
                if ax in pair and pend_diag[pair]["bits"].get(
                        ax, set()) & bits_by_axis[ax]:
                    flush_diag(pair)
            pend_dense[ax]["ops"].append((oi, bits_by_axis[ax]))
            pend_dense[ax]["bits"] |= bits_by_axis[ax]
            continue

        if len(axes) == 2 and _op_is_diagonal(op):
            a, b = axes
            for ax in (a, b):
                if pend_dense[ax]["bits"] & bits_by_axis[ax]:
                    flush_dense(ax)
            p = pend_diag.setdefault((a, b), {"ops": [], "bits": {}})
            p["ops"].append(oi)
            for ax in (a, b):
                p["bits"].setdefault(ax, set()).update(bits_by_axis[ax])
            continue

        if len(axes) >= 3 and _diag_product_value(op) is not None:
            for ax in axes:
                if pend_dense[ax]["bits"] & bits_by_axis[ax]:
                    flush_dense(ax)
            idx = len(prod_segments)
            prod_segments.append(DiagProductSegment(
                axes=tuple(axes), index=idx, op_index=oi))
            steps.append(DiagProductStep(axes=tuple(axes), index=idx))
            continue

        lone = [ax for ax in axes if len(bits_by_axis[ax]) == 1]
        if len(axes) == 2 and lone:
            # slice the lone-bit axis; when both qualify, put the operator
            # on the smaller axis
            if len(lone) == 2:
                slice_axis = max(lone, key=lambda ax: layout.axis_sizes[ax])
            else:
                slice_axis = lone[0]
            op_axis = axes[0] if axes[0] != slice_axis else axes[1]
            for pair in list(pend_diag):
                if any(ax in pair and pend_diag[pair]["bits"].get(
                        ax, set()) & bits_by_axis[ax] for ax in axes):
                    flush_diag(pair)
            slice_q = next(q for q in op.targets
                           if layout.axis_of(q) == slice_axis)
            slice_pos = layout.pos_in_axis(slice_q)
            # Fold conflicting pendings into the cross.
            pre_op_subcols: tuple = ()
            pre_slice: tuple = ()
            p_op = pend_dense[op_axis]
            if p_op["bits"] & bits_by_axis[op_axis]:
                pre_op_subcols = _subcolumns(p_op["ops"])
                pend_dense[op_axis] = {"ops": [], "bits": set()}
            p_sl = pend_dense[slice_axis]
            if p_sl["bits"] & bits_by_axis[slice_axis]:
                if p_sl["bits"] <= {slice_pos}:
                    pre_slice = tuple(o for o, _ in p_sl["ops"])
                    pend_dense[slice_axis] = {"ops": [], "bits": set()}
                else:
                    flush_dense(slice_axis)
            if (not pre_op_subcols and not pre_slice
                    and len(op.targets) == 2):
                op_q = next(q for q in op.targets
                            if layout.axis_of(q) == op_axis)
                is_swap = (op.static_matrix is not None
                           and np.allclose(op.static_matrix, _SWAP_MATRIX))
                bitpair_specs.append(BitPairSpec(
                    op_index=oi, slice_axis=slice_axis, is_swap=is_swap))
                steps.append(BitPairStep(
                    slice_axis=slice_axis, slice_pos=slice_pos,
                    op_axis=op_axis, op_pos=layout.pos_in_axis(op_q),
                    index=len(bitpair_specs) - 1))
                continue
            cross_specs.append(CrossSpec(
                op_index=oi, slice_axis=slice_axis, op_axis=op_axis,
                pre_op_subcolumns=pre_op_subcols, pre_slice_ops=pre_slice))
            steps.append(CrossStep(
                slice_axis=slice_axis, slice_pos=slice_pos,
                op_axis=op_axis, index=len(cross_specs) - 1))
            continue

        flush_all()
        steps.append(GenericStep(program_op=oi))

    flush_all()

    # Peephole: merge adjacent AxisMatmulSteps on the same axis.
    per_axis: list[list[DenseSegment]] = [[] for _ in range(n_axes)]
    for seg in dense_segments:
        per_axis[seg.axis].append(seg)
    resolved: list = []
    for st in steps:
        if isinstance(st, AxisMatmulStep):
            seg = per_axis[st.axis][st.op_index]
            if resolved and isinstance(resolved[-1], DenseSegment) \
                    and resolved[-1].axis == seg.axis:
                resolved[-1] = DenseSegment(
                    axis=seg.axis,
                    subcolumns=resolved[-1].subcolumns + seg.subcolumns)
            else:
                resolved.append(seg)
        else:
            resolved.append(st)
    steps = []
    dense_segments = []
    counters = [0] * n_axes
    for item in resolved:
        if isinstance(item, DenseSegment):
            steps.append(AxisMatmulStep(axis=item.axis,
                                        op_index=counters[item.axis]))
            counters[item.axis] += 1
            dense_segments.append(item)
        else:
            steps.append(item)

    def _real(oi: int) -> bool:
        return _op_is_real(program.ops[oi])

    dense_real_by_axis: list[list[bool]] = [[] for _ in range(n_axes)]
    for seg in dense_segments:
        dense_real_by_axis[seg.axis].append(
            all(_real(oi) for sub in seg.subcolumns for oi in sub))
    cross_real = tuple(
        _real(s.op_index)
        and all(_real(oi) for sub in s.pre_op_subcolumns for oi in sub)
        and all(_real(oi) for oi in s.pre_slice_ops)
        for s in cross_specs)
    diag_real = tuple(all(_real(oi) for oi in seg.op_indices)
                      for seg in diag_segments)
    prod_real = tuple(_real(seg.op_index) for seg in prod_segments)
    bitpair_real = tuple(_real(s.op_index) for s in bitpair_specs)
    all_real = (all(r for ax in dense_real_by_axis for r in ax)
                and all(cross_real) and all(diag_real) and all(prod_real)
                and all(bitpair_real)
                and not any(isinstance(s, GenericStep) for s in steps))

    return GroupPlan(layout=layout, steps=tuple(steps),
                     dense_segments=tuple(dense_segments),
                     cross_specs=tuple(cross_specs),
                     diag_segments=tuple(diag_segments),
                     prod_segments=tuple(prod_segments),
                     bitpair_specs=tuple(bitpair_specs),
                     dense_real=tuple(tuple(ax) for ax in dense_real_by_axis),
                     cross_real=cross_real, diag_real=diag_real,
                     prod_real=prod_real, bitpair_real=bitpair_real,
                     all_real=all_real)


# ---------------------------------------------------------------------------
# Operator building on the host (NumPy)
# ---------------------------------------------------------------------------

def _reorder_gate_matrix(u: np.ndarray, pos: list[int]) -> np.ndarray:
    """Permute a gate matrix from target order to ascending-position order."""
    k = len(pos)
    order = sorted(range(k), key=lambda i: pos[i])
    if order == list(range(k)):
        return u
    g = u.reshape((2,) * (2 * k))
    perm = tuple(order) + tuple(k + i for i in order)
    return g.transpose(perm).reshape(1 << k, 1 << k)


def _permute_matrix_bits(m: np.ndarray, bit_order: list[int]) -> np.ndarray:
    """Reorder a (2^B, 2^B) matrix whose bits follow ``bit_order`` into
    ascending bit order."""
    B = len(bit_order)
    perm = [bit_order.index(p) for p in sorted(bit_order)]
    g = m.reshape((2,) * (2 * B))
    g = g.transpose(tuple(perm) + tuple(B + i for i in perm))
    return g.reshape(1 << B, 1 << B)


def reorder_gate_targets(u, targets, qubit_order):
    """Permute a 2^k gate matrix from ``targets`` order to ``qubit_order``."""
    k = len(targets)
    order = [list(targets).index(q) for q in qubit_order]
    if order == list(range(k)):
        return u
    g = u.reshape((2,) * (2 * k))
    perm = tuple(order) + tuple(k + i for i in order)
    return g.transpose(perm).reshape(1 << k, 1 << k)


_EMBED_MASKS: dict[tuple, np.ndarray] = {}


def _embed_masks(positions: tuple[int, ...], axis_bits: int) -> np.ndarray:
    """(4^k, S, S) 0/1 masks: the embedding of a 2^k operator U at the
    given bit positions is sum_e U.flat[e] * masks[e] (``plan.py:1263``)."""
    key = (positions, axis_bits)
    cached = _EMBED_MASKS.get(key)
    if cached is not None:
        return cached
    k = len(positions)
    dim = 1 << axis_bits
    masks = np.zeros((4**k, dim, dim), dtype=np.float32)
    idx = np.arange(dim)
    non_target_mask = 0
    for b in range(axis_bits):
        if b not in positions:
            non_target_mask |= 1 << (axis_bits - 1 - b)

    def target_code(v: int) -> int:
        code = 0
        for p in positions:
            code = (code << 1) | ((v >> (axis_bits - 1 - p)) & 1)
        return code

    for row in range(dim):
        cols = idx[(idx & non_target_mask) == (row & non_target_mask)]
        r_code = target_code(row)
        for col in cols:
            masks[r_code * (1 << k) + target_code(int(col)), row, col] = 1.0
    _EMBED_MASKS[key] = masks
    return masks


def _embed_in_axis(u: np.ndarray, positions: tuple[int, ...],
                   axis_bits: int) -> np.ndarray:
    """Embed a 2^k operator on the given MSB-first bit positions of an
    ``axis_bits``-bit axis into a (2^axis_bits, 2^axis_bits) operator."""
    masks = _embed_masks(positions, axis_bits)
    flat = u.reshape(-1)
    re = np.tensordot(np.real(flat).astype(CONFIG.np_real), masks, axes=1)
    if not np.iscomplexobj(u):
        return re.astype(u.dtype)
    im = np.tensordot(np.imag(flat).astype(CONFIG.np_real), masks, axes=1)
    return (re + 1j * im).astype(u.dtype)


class _GateMatrixPool:
    """Per-op gate matrices plus one (P, 2, 2) pool of the single-qubit
    ones (``plan.py:553-707``, NumPy mode). Ops in ``skip`` take their
    matrices from ``OperandOverrides`` instead and are left out, as in
    the JAX pool."""

    def __init__(self, program: prog.CircuitProgram, params, dtype,
                 skip: frozenset = frozenset()):
        self._per_op: dict[int, np.ndarray] = {}
        by_name: dict[tuple, list[int]] = {}
        static_cache: dict[bytes, np.ndarray] = {}
        static_1q: dict[bytes, tuple[np.ndarray, int]] = {}
        for oi, op in enumerate(program.ops):
            if oi in skip:
                continue  # injected matrix: see OperandOverrides
            if op.cphase_value is not None:
                continue  # matrix-less wide diagonal: DiagProductStep only
            if op.static_matrix is None and op.num_params > 0:
                by_name.setdefault((op.gate_name, op.builder),
                                   []).append(oi)
            else:
                key = op.static_matrix.tobytes()
                mat = static_cache.get(key)
                if mat is None:
                    mat = np.asarray(op.static_matrix, dtype=dtype)
                    static_cache[key] = mat
                self._per_op[oi] = mat
                if len(op.targets) == 1 and key not in static_1q:
                    static_1q[key] = (op.static_matrix, len(static_1q))

        # 1q pool: eye at row 0, one row per distinct static 1q matrix,
        # then one row block per parameterized builder.
        self._pool_index: dict[int, int] = {}
        pool_parts = [np.eye(2, dtype=dtype)[None]]
        for mat, _ in static_1q.values():
            pool_parts.append(mat.astype(dtype)[None])
        pool_parts = [np.asarray(np.concatenate(pool_parts), dtype=dtype)]
        base = 1 + len(static_1q)
        for oi, op in enumerate(program.ops):
            if oi in skip:
                continue
            if len(op.targets) == 1 and op.static_matrix is not None:
                self._pool_index[oi] = \
                    1 + static_1q[op.static_matrix.tobytes()][1]

        for (_, builder), indices in by_name.items():
            ops = [program.ops[i] for i in indices]
            mats = [np.asarray(builder(*[float(params[op.param_offset + j])
                                         for j in range(op.num_params)]))
                    .astype(dtype) for op in ops]
            stack = np.stack(mats)
            for row, oi in enumerate(indices):
                self._per_op[oi] = stack[row]
            if len(ops[0].targets) == 1:
                for row, oi in enumerate(indices):
                    self._pool_index[oi] = base + row
                pool_parts.append(stack)
                base += len(indices)

        self.pool_1q = (np.concatenate(pool_parts)
                        if len(self._pool_index) else None)

    def matrix(self, oi: int) -> np.ndarray:
        return self._per_op[oi]

    def pool_index(self, oi: int) -> int:
        return self._pool_index[oi]


def _batched_1q_subcolumns(pool: _GateMatrixPool,
                           tables: np.ndarray) -> np.ndarray:
    """(B, bits) pool-index tables -> (B, 2^bits, 2^bits) kron products
    (index 0 = identity)."""
    gathered = np.take(pool.pool_1q, tables, axis=0)
    acc = gathered[:, 0]
    size = 2
    for b in range(1, tables.shape[1]):
        acc = np.einsum("brc,bij->bricj", acc, gathered[:, b]).reshape(
            tables.shape[0], size * 2, size * 2)
        size *= 2
    return acc


def _subcolumn_operator(program: prog.CircuitProgram, pool,
                        op_indices: tuple[int, ...], layout: GroupLayout,
                        axis: int, dtype) -> np.ndarray:
    """(S, S) operator: interleaved kron of the sub-column's gates (all
    bits disjoint) and identity on untouched bits."""
    bits = layout.axis_bits[axis]
    items: list[tuple[int, tuple[int, ...], np.ndarray]] = []
    covered: set[int] = set()
    for oi in op_indices:
        op = program.ops[oi]
        pos = [layout.pos_in_axis(q) for q in op.targets]
        u = _reorder_gate_matrix(pool.matrix(oi), pos)
        spos = tuple(sorted(pos))
        items.append((spos[0], spos, u))
        covered |= set(spos)
    run: list[int] = []
    for p in range(bits):
        if p in covered:
            if run:
                items.append((run[0], tuple(run),
                              np.eye(1 << len(run), dtype=dtype)))
                run = []
        else:
            run.append(p)
    if run:
        items.append((run[0], tuple(run), np.eye(1 << len(run), dtype=dtype)))
    items.sort(key=lambda it: it[0])

    acc = None
    bit_order: list[int] = []
    for _, spos, u in items:
        bit_order.extend(spos)
        acc = u if acc is None else np.kron(acc, u)
    if bit_order != sorted(bit_order):
        acc = _permute_matrix_bits(acc, bit_order)
    return acc


def _indicator_masks(targets: tuple[int, ...], layout: GroupLayout
                     ) -> list[tuple[int, np.ndarray]]:
    """Per-axis all-targets-set indicator vectors (axis, (S,) real)."""
    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    out = []
    for ax in sorted(by_axis):
        bits = layout.axis_bits[ax]
        size = layout.axis_sizes[ax]
        mask = np.ones(size, CONFIG.np_real)
        for q in by_axis[ax]:
            bit = bits - 1 - layout.pos_in_axis(q)
            mask *= ((np.arange(size) >> bit) & 1).astype(CONFIG.np_real)
        out.append((ax, mask))
    return out


def _planes(m: np.ndarray, axis: int = 0) -> np.ndarray:
    """Complex array -> real (re, im) planes stacked at ``axis``."""
    return np.stack([np.real(m), np.imag(m)], axis=axis).astype(
        CONFIG.np_real)


def build_group_operands(program: prog.CircuitProgram, plan: GroupPlan,
                         params, dtype=None):
    """Host NumPy operands in ``dtype`` (default ``CONFIG.np_complex``),
    in the port's layout:

    * ``axis_stacks[ax]``: (m, 2, S, S) planes of each composed operator;
    * ``cross_ops[i]``: (2, 2, S, 2, S) planes indexed (plane, i, y, k, x);
    * ``diag_ops[i]``: (2, S_a, S_b) planes of each pair diagonal;
    * ``prod_ops[i]``: (per-axis indicator masks, Re(v-1), Im(v-1));
    * ``bitpair_ops[i]``: (2, 2, 2, 2, 2) planes, or None for a SWAP.

    The arithmetic is that of ``build_group_operands(..., xp=np)``
    (``quantum_simulator_tpu/ops/plan.py:818-982``)."""
    with span("plan.operands"):
        layout = plan.layout
        dtype = dtype or CONFIG.np_complex
        with span("operands.gates"):
            pool = _GateMatrixPool(program, params, dtype)

            # Batch every all-1q sub-column of each axis width into one
            # kron chain.
            classes: dict[int, list[np.ndarray]] = {}
            class_ref: dict[tuple[int, int], int] = {}
            for si, seg in enumerate(plan.dense_segments):
                bits = layout.axis_bits[seg.axis]
                for bi, sub in enumerate(seg.subcolumns):
                    if not all(len(program.ops[oi].targets) == 1
                               for oi in sub):
                        continue
                    table = np.zeros(bits, dtype=np.int32)
                    for oi in sub:
                        q = program.ops[oi].targets[0]
                        table[layout.pos_in_axis(q)] = pool.pool_index(oi)
                    class_ref[(si, bi)] = len(classes.setdefault(bits, []))
                    classes[bits].append(table)
            batched = {bits: _batched_1q_subcolumns(pool, np.stack(tables))
                       for bits, tables in classes.items()}

        with span("operands.dense"):
            axis_lists: list[list] = [[] for _ in layout.axis_sizes]
            for si, seg in enumerate(plan.dense_segments):
                bits = layout.axis_bits[seg.axis]
                combined = None
                for bi, sub in enumerate(seg.subcolumns):
                    row = class_ref.get((si, bi))
                    if row is not None:
                        sc = batched[bits][row]
                    else:
                        sc = _subcolumn_operator(program, pool, sub, layout,
                                                 seg.axis, dtype)
                    combined = (sc if combined is None
                                else np.matmul(sc, combined))
                axis_lists[seg.axis].append(combined)

            axis_stacks = []
            for ax, ops in enumerate(axis_lists):
                if not ops:
                    ops = [np.eye(layout.axis_sizes[ax], dtype=dtype)]
                axis_stacks.append(_planes(np.stack(ops), axis=1))

        with span("operands.cross"):
            cross_ops = []
            for spec in plan.cross_specs:
                op = program.ops[spec.op_index]
                slice_q = next(q for q in op.targets
                               if layout.axis_of(q) == spec.slice_axis)
                op_qs = sorted((q for q in op.targets
                                if layout.axis_of(q) == spec.op_axis),
                               key=lambda q: layout.pos_in_axis(q))
                u = reorder_gate_targets(pool.matrix(spec.op_index),
                                         op.targets, [slice_q] + op_qs)
                gl = 1 << len(op_qs)
                u4 = u.reshape(2, gl, 2, gl)
                pos = tuple(layout.pos_in_axis(q) for q in op_qs)
                bits = layout.axis_bits[spec.op_axis]
                blocks = [[_embed_in_axis(u4[i, :, kk, :], pos, bits)
                           for kk in (0, 1)] for i in (0, 1)]
                if spec.pre_slice_ops:
                    # folded 1q gates on the sliced bit:
                    # B'_ik = sum_j B_ij us_jk
                    us = None
                    for oi in spec.pre_slice_ops:
                        m = pool.matrix(oi)
                        us = m if us is None else np.matmul(m, us)
                    blocks = [[blocks[i][0] * us[0, kk]
                               + blocks[i][1] * us[1, kk]
                               for kk in (0, 1)] for i in (0, 1)]
                if spec.pre_op_subcolumns:
                    # pending op-axis operator applies before the cross:
                    # blocks @ M
                    m = None
                    for sub in spec.pre_op_subcolumns:
                        sc = _subcolumn_operator(program, pool, sub, layout,
                                                 spec.op_axis, dtype)
                        m = sc if m is None else np.matmul(sc, m)
                    blocks = [[np.matmul(blocks[i][kk], m)
                               for kk in (0, 1)] for i in (0, 1)]
                C = np.stack([np.stack(row, axis=0) for row in blocks], axis=0)
                # (i, y, k, x)
                cross_ops.append(_planes(C.transpose(0, 2, 1, 3)))

        with span("operands.rest"):
            bitpair_ops = []
            for spec in plan.bitpair_specs:
                if spec.is_swap:
                    bitpair_ops.append(None)  # executes as a transpose
                    continue
                op = program.ops[spec.op_index]
                slice_q = next(q for q in op.targets
                               if layout.axis_of(q) == spec.slice_axis)
                op_q = next(q for q in op.targets if q != slice_q)
                u = reorder_gate_targets(pool.matrix(spec.op_index),
                                         op.targets, [slice_q, op_q])
                bitpair_ops.append(_planes(u.reshape(2, 2, 2, 2)))

            prod_ops = []
            for seg in plan.prod_segments:
                v = _diag_product_value(program.ops[seg.op_index])
                facs = tuple(m for _, m in _indicator_masks(
                    program.ops[seg.op_index].targets, layout))
                prod_ops.append((facs, float(np.real(v - 1)),
                                 float(np.imag(v - 1))))

            diag_ops = []
            for seg in plan.diag_segments:
                sa = layout.axis_sizes[seg.axis_a]
                sb = layout.axis_sizes[seg.axis_b]
                D = np.ones((sa, sb), dtype=dtype)
                for oi in seg.op_indices:
                    op = program.ops[oi]
                    k = len(op.targets)
                    if op.cphase_value is not None:
                        dv = np.ones(1 << k, np.complex128)
                        dv[-1] = op.cphase_value
                        d = np.asarray(dv, dtype=dtype)
                    else:
                        d = np.diagonal(pool.matrix(oi))
                    code_a = np.zeros(sa, dtype=np.int32)
                    code_b = np.zeros(sb, dtype=np.int32)
                    for j, q in enumerate(op.targets):
                        shift = k - 1 - j
                        p = layout.pos_in_axis(q)
                        if layout.axis_of(q) == seg.axis_a:
                            ab = layout.axis_bits[seg.axis_a]
                            code_a |= (((np.arange(sa) >> (ab - 1 - p)) & 1)
                                       << shift).astype(np.int32)
                        else:
                            bb = layout.axis_bits[seg.axis_b]
                            code_b |= (((np.arange(sb) >> (bb - 1 - p)) & 1)
                                       << shift).astype(np.int32)
                    D = D * d[code_a[:, None] + code_b[None, :]]
                diag_ops.append(_planes(D))

        return axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops


def operands_to(operands, device):
    """Move a host operand tuple to ``device`` (one copy per array)."""
    with span("plan.operands_to"):
        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device)

        axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = operands
        return ([put(a) for a in axis_stacks], [put(a) for a in cross_ops],
                [put(a) for a in diag_ops],
                [(tuple(put(m) for m in facs), cre, cim)
                 for facs, cre, cim in prod_ops],
                [put(a) for a in bitpair_ops])


# ---------------------------------------------------------------------------
# Batched operator building on the device (noisy trajectories)
# ---------------------------------------------------------------------------

class OperandOverrides(NamedTuple):
    """Per-trajectory matrices injected for designated ops
    (``plan.py:540-551``): the noise draws of the splice executors
    (``ops/unitary_traj.py``, ``ops/monomial_traj.py``). Override ops
    carry a classification-only dummy ``static_matrix`` whose realness and
    diagonality match the injected values: the plan reads the dummy, the
    operands read the override."""

    pool_rows: torch.Tensor | None    # (T, R, 2, 2) complex 1q matrices
    pool_map: dict                     # op index -> row in pool_rows
    per_op: dict                       # op index -> (T, D, D) complex


class _DevicePool:
    """Gate matrices on the device with a leading batch axis: 1 for a
    matrix every trajectory shares (built by the host pool), T for an
    override. The 1q pool is the host pool's rows (identity at row 0)
    followed by the override rows, as in the JAX pool."""

    def __init__(self, program, params, device,
                 overrides: OperandOverrides | None):
        self.overrides = overrides
        self.device = device
        self._skip = (frozenset(overrides.pool_map) | frozenset(
            overrides.per_op)) if overrides else frozenset()
        self.host = _GateMatrixPool(program, params, CONFIG.np_complex,
                                    self._skip)
        rows = self.host.pool_1q
        if rows is None:
            rows = np.eye(2, dtype=CONFIG.np_complex)[None]
        self.static_rows = torch.from_numpy(
            np.ascontiguousarray(rows)).to(device)[None]
        self.n_static = rows.shape[0]
        self._cache: dict[int, torch.Tensor] = {}
        self._full = None

    def is_override(self, oi: int) -> bool:
        return oi in self._skip

    def pool_index(self, oi: int) -> int:
        if self.overrides is not None and oi in self.overrides.pool_map:
            return self.n_static + self.overrides.pool_map[oi]
        return self.host.pool_index(oi)

    def rows(self, per_trajectory: bool) -> torch.Tensor:
        """(1, P, 2, 2) shared rows, or (T, P + R, 2, 2) with overrides."""
        if not per_trajectory:
            return self.static_rows
        if self._full is None:
            extra = self.overrides.pool_rows
            self._full = torch.cat([self.static_rows.expand(
                extra.shape[0], -1, -1, -1), extra.to(CONFIG.dtype)], dim=1)
        return self._full

    def matrix(self, oi: int) -> torch.Tensor:
        """(1, D, D) shared or (T, D, D) per-trajectory matrix of op oi."""
        if self.overrides is not None:
            m = self.overrides.per_op.get(oi)
            if m is not None:
                return m.to(CONFIG.dtype)
            r = self.overrides.pool_map.get(oi)
            if r is not None:
                return self.overrides.pool_rows[:, r].to(CONFIG.dtype)
        m = self._cache.get(oi)
        if m is None:
            m = torch.from_numpy(np.ascontiguousarray(
                self.host.matrix(oi), dtype=CONFIG.np_complex)).to(
                    self.device)[None]
            self._cache[oi] = m
        return m


def _t_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product of (Ba, m, m) and (Bb, n, n): out[(r i),
    (c j)] = a[r, c] b[i, j]; batch axes of 1 broadcast."""
    m, n = a.shape[-1], b.shape[-1]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * n, m * n))


def _t_permute_bits(u: torch.Tensor, order: list[int]) -> torch.Tensor:
    """Batched (B, 2^k, 2^k) matrix with its row and column bits taken in
    ``order`` (the torch form of the NumPy transposes above)."""
    k = len(order)
    if order == list(range(k)):
        return u
    g = u.reshape((u.shape[0],) + (2,) * (2 * k))
    g = g.permute((0,) + tuple(1 + i for i in order)
                  + tuple(1 + k + i for i in order))
    return g.reshape(u.shape)


def _t_reorder_gate_matrix(u: torch.Tensor, pos: list[int]) -> torch.Tensor:
    return _t_permute_bits(u, sorted(range(len(pos)), key=lambda i: pos[i]))


def _t_reorder_targets(u: torch.Tensor, targets, qubit_order) -> torch.Tensor:
    return _t_permute_bits(u, [list(targets).index(q) for q in qubit_order])


def _t_batched_1q_subcolumns(rows: torch.Tensor,
                             tables: np.ndarray) -> torch.Tensor:
    """(B, P, 2, 2) pool rows and (N, bits) index tables -> (B, N, 2^bits,
    2^bits) kron products (index 0 = identity)."""
    gathered = rows[:, torch.from_numpy(tables).to(rows.device)]
    acc = gathered[:, :, 0]
    for b in range(1, tables.shape[1]):
        acc = _t_kron(acc, gathered[:, :, b])
    return acc


def _t_subcolumn_operator(program, pool: _DevicePool, op_indices, layout,
                          axis: int) -> torch.Tensor:
    """(B, S, S) operator of a sub-column (``_subcolumn_operator``)."""
    bits = layout.axis_bits[axis]
    items: list = []
    covered: set[int] = set()
    for oi in op_indices:
        op = program.ops[oi]
        pos = [layout.pos_in_axis(q) for q in op.targets]
        u = _t_reorder_gate_matrix(pool.matrix(oi), pos)
        spos = tuple(sorted(pos))
        items.append((spos[0], spos, u))
        covered |= set(spos)
    run: list[int] = []

    def eye(k: int) -> torch.Tensor:
        return torch.eye(1 << k, dtype=CONFIG.dtype,
                         device=pool.device)[None]

    for p in range(bits):
        if p in covered:
            if run:
                items.append((run[0], tuple(run), eye(len(run))))
                run = []
        else:
            run.append(p)
    if run:
        items.append((run[0], tuple(run), eye(len(run))))
    items.sort(key=lambda it: it[0])
    acc = None
    bit_order: list[int] = []
    for _, spos, u in items:
        bit_order.extend(spos)
        acc = u if acc is None else _t_kron(acc, u)
    if bit_order != sorted(bit_order):
        acc = _t_permute_bits(acc, [bit_order.index(p)
                                    for p in sorted(bit_order)])
    return acc


_DEVICE_MASKS: dict[tuple, torch.Tensor] = {}


def _t_embed_in_axis(u: torch.Tensor, positions: tuple[int, ...],
                     axis_bits: int) -> torch.Tensor:
    """Batched ``_embed_in_axis``: (B, 2^k, 2^k) -> (B, S, S); each output
    entry takes exactly one input entry, so the products are exact."""
    flat = u.reshape(u.shape[0], -1)
    key = (positions, axis_bits, str(u.device), flat.real.dtype)
    masks = _DEVICE_MASKS.get(key)
    if masks is None:
        m = _embed_masks(positions, axis_bits)
        masks = torch.from_numpy(m.reshape(m.shape[0], -1)).to(
            device=u.device, dtype=flat.real.dtype)
        _DEVICE_MASKS[key] = masks
    S = 1 << axis_bits
    re = (flat.real @ masks).reshape(-1, S, S)
    im = (flat.imag @ masks).reshape(-1, S, S)
    return torch.complex(re, im)


def _t_planes(m: torch.Tensor, n_traj: int) -> torch.Tensor:
    """(B, ...) complex -> (T, 2, ...) real (re, im) planes; a shared
    (B = 1) operator is repeated with stride 0, not copied."""
    out = torch.stack([m.real, m.imag], dim=1)
    return out.expand((n_traj,) + tuple(out.shape[1:]))


def param_overrides(program: prog.CircuitProgram,
                    params: torch.Tensor) -> OperandOverrides:
    """Per-row matrices of every parameterized op for a ``(B, P)``
    parameter batch, built on its device by the torch gate builders (one
    call per builder over all of its ops): one-qubit ops as pool rows,
    wider ones per op, as the noise draws enter (``OperandOverrides``).
    The plan's realness and diagonality depend on the gate names only
    (``_REAL_PARAM_GATES``, ``_DIAGONAL_PARAM_GATES``), so no dummy
    matrix is needed."""
    by_builder: dict[tuple, list[int]] = {}
    for oi, op in enumerate(program.ops):
        if op.static_matrix is None and op.num_params > 0:
            by_builder.setdefault((op.gate_name, op.torch_builder,
                                   len(op.targets)), []).append(oi)
    rows: list[torch.Tensor] = []
    pool_map: dict[int, int] = {}
    per_op: dict[int, torch.Tensor] = {}
    n_rows = 0
    for (name, builder, k), indices in by_builder.items():
        if builder is None:
            raise ValueError(f"{name} has no torch builder: its parameters "
                             "cannot run as a batch")
        offs = torch.as_tensor([program.ops[oi].param_offset
                                for oi in indices], device=params.device)
        mats = builder(*[params[:, offs + j] for j in
                         range(program.ops[indices[0]].num_params)])
        mats = mats.to(CONFIG.dtype)             # (B, len(indices), D, D)
        if k == 1:
            for r, oi in enumerate(indices):
                pool_map[oi] = n_rows + r
            n_rows += len(indices)
            rows.append(mats)
        else:
            for r, oi in enumerate(indices):
                per_op[oi] = mats[:, r]
    return OperandOverrides(torch.cat(rows, dim=1) if rows else None,
                            pool_map, per_op)


def merge_overrides(first: OperandOverrides,
                    second: OperandOverrides) -> OperandOverrides:
    """One ``OperandOverrides`` from two that touch disjoint ops (a
    parameter batch's rows and a splice's draws, ``analysis.py:693-743``;
    spliced draw ops carry no parameters): the second's pool rows follow
    the first's, its ``pool_map`` shifted past them."""
    parts = [r for r in (first.pool_rows, second.pool_rows) if r is not None]
    shift = 0 if first.pool_rows is None else first.pool_rows.shape[1]
    pool_map = dict(first.pool_map)
    pool_map.update({oi: shift + r for oi, r in second.pool_map.items()})
    return OperandOverrides(
        torch.cat([p.to(CONFIG.dtype) for p in parts], dim=1)
        if parts else None,
        pool_map, {**first.per_op, **second.per_op})


def build_group_operands_batched(program: prog.CircuitProgram,
                                 plan: GroupPlan, params, n_traj: int,
                                 device,
                                 overrides: OperandOverrides | None = None):
    """Operands of ``n_traj`` trajectories, built on ``device`` in torch
    ``CONFIG.dtype`` with the arithmetic of ``build_group_operands`` (TF32
    stays off, ``config.py``). ``params`` is one parameter vector shared by
    the batch, or a ``(n_traj, P)`` tensor of parameter rows, whose
    parameterized ops then take one matrix per row (``param_overrides``,
    merged with ``overrides``: each row has its own parameters and its own
    noise draws, as the JAX package's vmap over trials gives,
    ``analysis.py:693-743``). Each operand has a leading trajectory
    axis:

    * ``axis_stacks[ax][i]``: (T, 2, S, S);
    * ``cross_ops[i]``: (T, 2, 2, S, 2, S);
    * ``diag_ops[i]``: (T, 2, S_a, S_b);
    * ``prod_ops[i]``: as in ``build_group_operands``, on the device;
    * ``bitpair_ops[i]``: (T, 2, 2, 2, 2, 2), or None for a SWAP.

    An operand no override touches is computed once and shared across
    the trajectories with stride 0. The JAX package builds these operands
    outside any kernel too (``plan.py:818-982`` under vmap)."""
    with span("plan.operands_batched"):
        layout = plan.layout
        T = n_traj
        if isinstance(params, torch.Tensor) and params.ndim == 2:
            if params.shape[0] != T:
                raise ValueError(f"a parameter batch of shape "
                                 f"{tuple(params.shape)} for {T} rows")
            rows = param_overrides(program, params)
            overrides = (rows if overrides is None
                         else merge_overrides(rows, overrides))
            params = program.initial_params   # the host pool builds fixed ops
        pool = _DevicePool(program, params, device, overrides)

        def touched(ops) -> bool:
            return any(pool.is_override(oi) for oi in ops)

        # Every all-1q sub-column of each axis width goes through one gather
        # and kron chain; shared and per-trajectory ones apart.
        classes: dict[tuple[int, bool], list[np.ndarray]] = {}
        class_ref: dict[tuple[int, int], tuple] = {}
        for si, seg in enumerate(plan.dense_segments):
            bits = layout.axis_bits[seg.axis]
            for bi, sub in enumerate(seg.subcolumns):
                if not all(len(program.ops[oi].targets) == 1 for oi in sub):
                    continue
                table = np.zeros(bits, dtype=np.int64)
                for oi in sub:
                    q = program.ops[oi].targets[0]
                    table[layout.pos_in_axis(q)] = pool.pool_index(oi)
                key = (bits, touched(sub))
                class_ref[(si, bi)] = (key, len(classes.setdefault(key, [])))
                classes[key].append(table)
        batched = {key: _t_batched_1q_subcolumns(pool.rows(key[1]),
                                                 np.stack(tables))
                   for key, tables in classes.items()}

        axis_stacks: list[list[torch.Tensor]] = [[] for _ in layout.axis_sizes]
        for si, seg in enumerate(plan.dense_segments):
            combined = None
            for bi, sub in enumerate(seg.subcolumns):
                ref = class_ref.get((si, bi))
                if ref is not None:
                    sc = batched[ref[0]][:, ref[1]]
                else:
                    sc = _t_subcolumn_operator(program, pool, sub, layout,
                                               seg.axis)
                combined = (sc if combined is None
                            else torch.matmul(sc, combined))
            axis_stacks[seg.axis].append(_t_planes(combined, T))
        del batched
        for ax, ops in enumerate(axis_stacks):
            if not ops:
                ops.append(_t_planes(torch.eye(layout.axis_sizes[ax],
                                               dtype=CONFIG.dtype,
                                               device=device)[None], T))

        cross_ops = []
        for spec in plan.cross_specs:
            op = program.ops[spec.op_index]
            slice_q = next(q for q in op.targets
                           if layout.axis_of(q) == spec.slice_axis)
            op_qs = sorted((q for q in op.targets
                            if layout.axis_of(q) == spec.op_axis),
                           key=lambda q: layout.pos_in_axis(q))
            u = _t_reorder_targets(pool.matrix(spec.op_index), op.targets,
                                   [slice_q] + op_qs)
            gl = 1 << len(op_qs)
            u4 = u.reshape(u.shape[0], 2, gl, 2, gl)
            pos = tuple(layout.pos_in_axis(q) for q in op_qs)
            bits = layout.axis_bits[spec.op_axis]
            blocks = [[_t_embed_in_axis(u4[:, i, :, kk, :], pos, bits)
                       for kk in (0, 1)] for i in (0, 1)]
            if spec.pre_slice_ops:
                us = None
                for oi in spec.pre_slice_ops:
                    m = pool.matrix(oi)
                    us = m if us is None else torch.matmul(m, us)
                blocks = [[blocks[i][0] * us[:, 0, kk, None, None]
                           + blocks[i][1] * us[:, 1, kk, None, None]
                           for kk in (0, 1)] for i in (0, 1)]
            if spec.pre_op_subcolumns:
                m = None
                for sub in spec.pre_op_subcolumns:
                    sc = _t_subcolumn_operator(program, pool, sub, layout,
                                               spec.op_axis)
                    m = sc if m is None else torch.matmul(sc, m)
                blocks = [[torch.matmul(blocks[i][kk], m)
                           for kk in (0, 1)] for i in (0, 1)]
            C = torch.stack([torch.stack(row, dim=1) for row in blocks], dim=1)
            cross_ops.append(_t_planes(C.permute(0, 1, 3, 2, 4), T))

        bitpair_ops = []
        for spec in plan.bitpair_specs:
            if spec.is_swap:
                bitpair_ops.append(None)
                continue
            op = program.ops[spec.op_index]
            slice_q = next(q for q in op.targets
                           if layout.axis_of(q) == spec.slice_axis)
            op_q = next(q for q in op.targets if q != slice_q)
            u = _t_reorder_targets(pool.matrix(spec.op_index), op.targets,
                                   [slice_q, op_q])
            bitpair_ops.append(_t_planes(u.reshape(-1, 2, 2, 2, 2), T))

        prod_ops = []
        for seg in plan.prod_segments:
            v = _diag_product_value(program.ops[seg.op_index])
            facs = tuple(torch.from_numpy(m).to(device) for _, m in
                         _indicator_masks(program.ops[seg.op_index].targets,
                                          layout))
            prod_ops.append((facs, float(np.real(v - 1)),
                             float(np.imag(v - 1))))

        diag_ops = []
        for seg in plan.diag_segments:
            sa = layout.axis_sizes[seg.axis_a]
            sb = layout.axis_sizes[seg.axis_b]
            D = torch.ones((1, sa, sb), dtype=CONFIG.dtype, device=device)
            for oi in seg.op_indices:
                op = program.ops[oi]
                k = len(op.targets)
                if op.cphase_value is not None:
                    dv = np.ones(1 << k, CONFIG.np_complex)
                    dv[-1] = op.cphase_value
                    d = torch.from_numpy(dv).to(device)[None]
                else:
                    d = torch.diagonal(pool.matrix(oi), dim1=-2, dim2=-1)
                code_a = np.zeros(sa, dtype=np.int64)
                code_b = np.zeros(sb, dtype=np.int64)
                for j, q in enumerate(op.targets):
                    shift = k - 1 - j
                    p = layout.pos_in_axis(q)
                    if layout.axis_of(q) == seg.axis_a:
                        ab = layout.axis_bits[seg.axis_a]
                        code_a |= ((np.arange(sa) >> (ab - 1 - p)) & 1) \
                            << shift
                    else:
                        bb = layout.axis_bits[seg.axis_b]
                        code_b |= ((np.arange(sb) >> (bb - 1 - p)) & 1) \
                            << shift
                idx = torch.from_numpy(code_a[:, None] + code_b[None, :]).to(
                    device)
                D = D * d[:, idx]
            diag_ops.append(_t_planes(D, T))

        return axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

# A state of at least this many bytes (a planar n = 29 or a real n = 30
# one in float32; a planar n = 28 or a real n = 29 one in float64 under
# ``enable_complex128``) runs its non-kernel steps chunk by chunk over
# views, each result copied over its chunk: the kernels write in place,
# and at n >= 30 no step may allocate a second state (planar: 8 / 16 /
# 32 GiB at n = 30 / 31 / 32 in float32, 16 / 32 GiB at n = 30 / 31 in
# float64, on an 80 GB card).
INPLACE_MIN_BYTES = 4 << 30
# Elements (not bytes) of one chunk of such a pass, and of the chunked
# reductions of ``ops/bigstate.py`` and ``ops/bigtraj.py``: 256 MiB of
# float32, 512 MiB of float64. A chunk's temporaries are a few chunks,
# against a 16-32 GiB float64 state.
CHUNK_ELEMS = 1 << 26


def is_big(x: torch.Tensor) -> bool:
    return x.numel() * x.element_size() >= INPLACE_MIN_BYTES


def chunk_ranges(size: int, numel: int) -> list[tuple[int, int]]:
    """(start, width) pieces of an axis of ``size`` such that a tensor of
    ``numel`` elements cut along it has pieces of about ``CHUNK_ELEMS``
    elements (sizes are powers of two; one piece for a small tensor)."""
    chunks = max(1, min(size, numel // CHUNK_ELEMS))
    while size % chunks:
        chunks -= 1
    width = size // chunks
    return [(i * width, width) for i in range(chunks)]


def apply_in_chunks(x: torch.Tensor, lead: int, involved, fn,
                    sliced: bool = False) -> torch.Tensor:
    """``x <- fn(x)`` over views of ``x`` cut along its largest data axis
    outside ``involved`` (``lead`` = leading batch and plane dims), each
    result copied over its view: the peak is the state plus one chunk's
    temporaries. ``sliced``: ``fn(view, axis, start, width)``, for
    transforms that slice an operand alongside. With no free axis the
    whole state goes through ``fn`` at once."""
    ax = _chunk_axis(x, lead, involved)
    if ax is None:
        return fn(x, None, 0, 0) if sliced else fn(x)
    for start, width in chunk_ranges(x.shape[lead + ax], x.numel()):
        view = x.narrow(lead + ax, start, width)
        view.copy_(fn(view, ax, start, width) if sliced else fn(view))
    return x


def _chunk_axis(x: torch.Tensor, lead: int, involved) -> int | None:
    """The data axis ``apply_in_chunks`` cuts ``x`` along: its largest
    outside ``involved``; None where there is none."""
    shape = tuple(x.shape[lead:])
    free = [a for a, s in enumerate(shape) if a not in involved and s > 1]
    return max(free, key=lambda a: shape[a]) if free else None


def chunk_count(x: torch.Tensor, lead: int, involved) -> int:
    """How many pieces ``apply_in_chunks`` runs ``x`` in."""
    ax = _chunk_axis(x, lead, involved)
    if ax is None:
        return 1
    return len(chunk_ranges(x.shape[lead + ax], x.numel()))


def expose_bits(shape: tuple[int, ...], tbits) -> tuple[tuple, dict]:
    """Reshape plan exposing each target bit ``(axis, MSB-first pos)`` of
    a grouped data shape as its own size-2 dimension. Returns
    ``(new_shape, {(axis, pos): new dim index})``
    (``bigtraj.py:115-138``)."""
    by_axis: dict[int, list[int]] = {}
    for ax, p in tbits:
        by_axis.setdefault(ax, []).append(p)
    new_shape: list[int] = []
    index: dict[tuple[int, int], int] = {}
    for ax, size in enumerate(shape):
        bits = size.bit_length() - 1
        poss = sorted(by_axis.get(ax, []))
        prev = 0
        for p in poss:
            if p - prev:
                new_shape.append(1 << (p - prev))
            index[(ax, p)] = len(new_shape)
            new_shape.append(2)
            prev = p + 1
        rem = bits - prev
        if rem > 0 or not poss:
            new_shape.append(1 << max(rem, 0))
    return tuple(new_shape), index


def apply_gate_bits(x: torch.Tensor, u: torch.Tensor, tbits, planar: bool,
                    batched: bool) -> torch.Tensor:
    """A ``2^k`` gate contracted directly against the k exposed state
    bits ``tbits`` (first = MSB of the gate index): the form for gates
    spanning three axes, or two with no lone bit (``bigtraj.py:412-461``).
    ``x`` is ``([T,] [2,] *data)``; ``u`` complex ``(D, D)``, or
    ``(T, D, D)`` with one gate per trajectory. Out of place."""
    b = int(batched)
    lead = b + int(planar)
    k = len(tbits)
    new_shape, index = expose_bits(tuple(x.shape[lead:]), tbits)
    bit_axes = [index[t] for t in tbits]
    shared = [chr(ord("e") + i) for i in range(len(new_shape))]
    P = [chr(ord("A") + i) for i in range(k)]
    R = [chr(ord("N") + i) for i in range(k)]
    xin, xout = list(shared), list(shared)
    for t in range(k):
        xin[bit_axes[t]] = R[t]
        xout[bit_axes[t]] = P[t]
    per_traj = u.ndim == 3
    ut = u.reshape(tuple(u.shape[:-2]) + (2,) * (2 * k))
    tz = "Z" if batched else ""
    uz = "Z" if per_traj else ""
    opsub = "".join(P) + "".join(R)
    xr = x.reshape(tuple(x.shape[:lead]) + new_shape)
    if planar:
        d = int(per_traj)
        opnd = _blocked(torch.stack([ut.real, ut.imag], dim=d).to(x.dtype),
                        d)
        spec = (f"{uz}cd{opsub},{tz}d{''.join(xin)}"
                f"->{tz}c{''.join(xout)}")
    else:
        opnd = ut.real.to(x.dtype)
        spec = f"{uz}{opsub},{tz}{''.join(xin)}->{tz}{''.join(xout)}"
    return torch.einsum(spec, opnd, xr).reshape(x.shape)


def _split_two_bits(shape: tuple[int, ...], ax_a: int, pos_a: int,
                    ax_b: int, pos_b: int):
    """Shape exposing bit ``pos_a`` of ``ax_a`` and bit ``pos_b`` of
    ``ax_b`` as size-2 dims; returns (new_shape, idx_a, idx_b)."""
    if ax_a > ax_b:
        new_shape, ia = _split_axis_bit(shape, ax_a, pos_a)
        new_shape, ib = _split_axis_bit(new_shape, ax_b, pos_b)
        return new_shape, ia + 2, ib
    new_shape, ib = _split_axis_bit(shape, ax_b, pos_b)
    new_shape, ia = _split_axis_bit(new_shape, ax_a, pos_a)
    return new_shape, ia, ib + 2


def apply_bitpair(x, plan, step, bitpair_ops, planar: bool,
                  batched: bool = False):
    """BitPairStep: an exact SWAP transposes the two bit dims; anything
    else is a K=4 einsum (``plan.py:1090-1112``)."""
    spec = plan.bitpair_specs[step.index]
    lead = x.ndim - len(plan.layout.axis_sizes)
    shape = tuple(x.shape[lead:])
    new_shape, bs, bo = _split_two_bits(shape, step.slice_axis,
                                        step.slice_pos, step.op_axis,
                                        step.op_pos)
    xr = x.reshape(tuple(x.shape[:lead]) + new_shape)
    if spec.is_swap:
        xr = xr.transpose(lead + bs, lead + bo)
    else:
        b = int(batched)
        real = plan.bitpair_real[step.index]
        q = bitpair_ops[step.index]
        xr = torch.einsum(
            _cross_spec(len(new_shape), bs, bo, real, planar, batched),
            q.select(b, 0) if real else _blocked(q, b), xr)
    return xr.reshape(x.shape)


def apply_prod_diag(x, facs, cre: float, cim: float, rank: int,
                    axes: tuple[int, ...], planar: bool,
                    batched: bool = False) -> torch.Tensor:
    """``x += (v-1) * x * prod mask_ax`` as broadcast elementwise ops."""
    ind = None
    for ax, m in zip(axes, facs):
        shape = [1] * rank
        shape[ax] = m.shape[0]
        f = m.reshape(shape)
        ind = f if ind is None else ind * f
    if not planar:
        return x + cre * (x * ind)  # real state => v real
    b = int(batched)
    xr, xi = x.select(b, 0), x.select(b, 1)
    tr = xr * ind
    ti = xi * ind
    return torch.stack([xr + cre * tr - cim * ti,
                        xi + cre * ti + cim * tr], dim=b)


def _whole_pass(x: torch.Tensor, lead: int, involved, fn, kind: str,
                swap: bool = False) -> torch.Tensor:
    """``fn`` over the whole state, or chunk by chunk over a big one
    (``apply_in_chunks``); while a ``recording()`` is open, one pass
    record of the state's bytes and the chunks it ran in."""
    big = is_big(x)
    if is_recording():
        state_pass(kind, x, chunk_count(x, lead, involved) if big else 1,
                   swap)
    return apply_in_chunks(x, lead, involved, fn) if big else fn(x)


def _data_bit(layout: GroupLayout, axis: int, pos: int) -> int:
    """The data-index bit of bit ``pos`` (MSB-first) of ``axis``."""
    return (sum(layout.axis_bits[axis + 1:]) + layout.axis_bits[axis] - 1
            - pos)


def step_bits(layout: GroupLayout, step: BitPairStep) -> tuple[int, int]:
    """The two data-index bits a ``BitPairStep`` acts on."""
    return (_data_bit(layout, step.slice_axis, step.slice_pos),
            _data_bit(layout, step.op_axis, step.op_pos))


def swap_runs(plan: GroupPlan) -> list[tuple[int, ...]]:
    """The maximal runs of consecutive exact-swap bit-pair steps of
    ``plan`` whose bit pairs share no bit, as positions in ``plan.steps``.
    Any other step, a non-swap bit pair, or a swap sharing a bit with one
    already in the run ends a run (the last starts the next)."""
    runs: list[tuple[int, ...]] = []
    cur: list[int] = []
    used: set[int] = set()
    for i, step in enumerate(plan.steps):
        if not (isinstance(step, BitPairStep)
                and plan.bitpair_specs[step.index].is_swap):
            if cur:
                runs.append(tuple(cur))
            cur, used = [], set()
            continue
        bits = set(step_bits(plan.layout, step))
        if bits & used:
            runs.append(tuple(cur))
            cur, used = [], set()
        cur.append(i)
        used |= bits
    if cur:
        runs.append(tuple(cur))
    return runs


def apply_bitpair_step(x: torch.Tensor, plan: GroupPlan, step: BitPairStep,
                       bitpair_ops, planar: bool, batched: bool = False,
                       run: tuple[BitPairStep, ...] | None = None
                       ) -> torch.Tensor:
    """One whole ``BitPairStep``: ``apply_bitpair`` over the state, or
    chunk by chunk over a big one (``apply_in_chunks``). With ``run``, a
    run of exact swaps on disjoint bit pairs that starts at ``step`` (one
    of ``swap_runs``): the ``swap_bits`` kernel applies the whole run to
    the state in place, in one launch (one pass of one chunk); its twin,
    one gather, on the CPU."""
    with span("step.bitpair"):
        if run is not None:
            if run[0] is not step or not all(
                    plan.bitpair_specs[s.index].is_swap for s in run):
                raise ValueError("apply_bitpair_step: run must be exact "
                                 "swaps starting at step")
            if is_recording():
                state_pass("bitpair", x, 1, True)
            return cuda_exec.swap_bits(
                x.contiguous(), [step_bits(plan.layout, s) for s in run],
                planar, batched)

        def fn(v):
            return apply_bitpair(v, plan, step, bitpair_ops, planar, batched)
        return _whole_pass(x, int(batched) + int(planar),
                           {step.slice_axis, step.op_axis}, fn, "bitpair",
                           plan.bitpair_specs[step.index].is_swap)


def apply_diag_pair_step(x: torch.Tensor, plan: GroupPlan,
                         step: DiagPairStep, diag_ops, planar: bool,
                         batched: bool = False,
                         plain: bool = False) -> torch.Tensor:
    """One whole ``DiagPairStep``. On a CUDA state the ``diag_pair``
    kernel multiplies the pair diagonal into the whole state in place, in
    one launch, big or not (one pass of one chunk). On the CPU, or with
    ``plain=True``, its plain twin: an elementwise einsum over the state,
    or chunk by chunk over a big one (``apply_in_chunks``)."""
    with span("step.diag"):
        b = int(batched)
        d = diag_ops[step.index]
        if plan.diag_real[step.index]:
            d = d.select(b, 0)
        if not plain and x.device.type != "cpu":
            if is_recording():
                state_pass("diag", x, 1)
            return cuda_exec.diag_pair(x.contiguous(), d, step.axis_a,
                                       step.axis_b, planar, batched)

        def fn(v):
            return cuda_exec.diag_pair_plain(v, d, step.axis_a, step.axis_b,
                                             planar, batched)
        return _whole_pass(x, b + int(planar), {step.axis_a, step.axis_b},
                           fn, "diag")


def execute_group_plan(plan: GroupPlan, operands, program, params,
                       x: torch.Tensor, planar: bool = True,
                       plain: bool = False,
                       batched: bool = False) -> torch.Tensor:
    """Run all steps on ``x``: planar ``(2, *axis_sizes)``, or real
    ``(*axis_sizes,)`` with ``planar=False`` (only for ``plan.all_real``).
    Dense, cross and pair-diagonal steps go through the ``cuda_exec``
    kernel wrappers, and on a CUDA state each run of exact swaps on
    disjoint bit pairs (``swap_runs``) is one ``swap_bits`` launch;
    ``plain=True`` calls their plain PyTorch twins instead on any device
    and runs each swap step on its own (the reference executor the kernels
    are checked and timed against).

    ``batched``: ``x`` has a leading trajectory axis ``(T, [2,] ...)`` and
    ``operands`` come from ``build_group_operands_batched``; every dense,
    cross and pair-diagonal step is then one batched kernel launch with
    one operator per trajectory, and the other steps take the batch as a
    leading dim.
    ``params`` may then be a ``(T, P)`` tensor of parameter rows.

    Takes ownership of ``x``: on a CUDA tensor the kernels write in place,
    so ``x`` may be overwritten by the run; pass a state you no longer
    need (or a clone). A state of ``INPLACE_MIN_BYTES`` or more also runs
    its other steps in place, chunk by chunk (``apply_in_chunks``), so no
    step holds a second state (the pair-diagonal and swap kernels need no
    chunks: they write each amplitude where it, or its partner, was
    read)."""
    layout = plan.layout
    shape = tuple(layout.axis_sizes)
    rank = len(shape)
    b = int(batched)
    lead = b + int(planar)
    big = is_big(x)

    def run(fn, involved, sliced=False):
        if big:
            return apply_in_chunks(x, lead, involved, fn, sliced)
        return fn(x, None, 0, 0) if sliced else fn(x)

    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = operands
    dense = cuda_exec.dense_axis_plain if plain else cuda_exec.dense_axis
    cross = (cuda_exec.cross_bit_axis_plain if plain
             else cuda_exec.cross_bit_axis)

    # On the card each run of disjoint swaps is one launch, made at the
    # run's first step.
    runs = ({r[0]: tuple(plan.steps[i] for i in r) for r in swap_runs(plan)}
            if not plain and x.device.type != "cpu" else {})

    with span("plan.execute"):
        skip = 0
        for i, step in enumerate(plan.steps):
            if skip:
                skip -= 1
                continue
            # einsum and transpose results may be strided views; the
            # kernels take contiguous states
            if isinstance(step, AxisMatmulStep):
                with span("step.dense"):
                    real = plan.dense_real[step.axis][step.op_index]
                    op = axis_stacks[step.axis][step.op_index]
                    x = dense(x.contiguous(), op.select(b, 0) if real else op,
                              step.axis, planar, batched)
            elif isinstance(step, CrossStep):
                with span("step.cross"):
                    real = plan.cross_real[step.index]
                    cop = cross_ops[step.index]
                    x = cross(x.contiguous(),
                              cop.select(b, 0) if real else cop,
                              step.slice_axis, step.slice_pos, step.op_axis,
                              planar, batched)
            elif isinstance(step, BitPairStep):
                swaps = runs.get(i)
                skip = len(swaps) - 1 if swaps else 0
                x = apply_bitpair_step(x, plan, step, bitpair_ops, planar,
                                       batched, run=swaps)
            elif isinstance(step, DiagPairStep):
                x = apply_diag_pair_step(x, plan, step, diag_ops, planar,
                                         batched, plain=plain)
            elif isinstance(step, DiagProductStep):
                with span("step.prod"):
                    x = run(_prod_chunk_fn(prod_ops[step.index], rank,
                                           step.axes, planar, batched), (),
                            sliced=True)
            else:  # GenericStep (never in an all-real plan, never an override)
                with span("step.generic"):
                    op = program.ops[step.program_op]
                    if isinstance(params, torch.Tensor) and params.ndim == 2 \
                            and op.static_matrix is None:
                        u = program.op_matrix_torch(op, params)  # per row
                    else:
                        u = program.op_matrix(op, params)
                    if big:     # no complex copy of a state this size
                        tbits = tuple((layout.axis_of(q),
                                       layout.pos_in_axis(q))
                                      for q in op.targets)
                        ut = torch.as_tensor(u, dtype=CONFIG.dtype,
                                             device=x.device)
                        x = run(lambda v, ut=ut, tbits=tbits:
                                apply_gate_bits(v, ut, tbits, planar,
                                                batched),
                                {a for a, _ in tbits})
                        continue
                    lead_shape = tuple(x.shape[:b])
                    flat = torch.complex(x.select(b, 0),
                                         x.select(b, 1)).reshape(
                        lead_shape + (-1,))
                    shaped = apply_gate(flat, u, op.targets,
                                        layout.num_qubits).reshape(
                        lead_shape + shape)
                    x = torch.stack([shaped.real, shaped.imag], dim=b)
    return x


def _prod_chunk_fn(prod_op, rank: int, axes: tuple[int, ...], planar: bool,
                   batched: bool):
    """``fn(view, axis, start, width)`` applying a product diagonal to a
    chunk cut along ``axis``: that axis's indicator factor, if it has
    one, is cut alongside."""
    facs, cre, cim = prod_op

    def fn(v, ax, start, width):
        f = tuple(m.narrow(0, start, width) if a == ax else m
                  for a, m in zip(axes, facs))
        return apply_prod_diag(v, f, cre, cim, rank, axes, planar, batched)

    return fn


def basis_state(plan: GroupPlan, index: int, device, planar: bool = True,
                n_traj: int | None = None) -> torch.Tensor:
    """One-hot basis state in ``CONFIG.real_dtype``, planar
    ``(2, *axis_sizes)`` or real;
    ``n_traj`` adds a leading trajectory axis (one copy each)."""
    return layout_basis_state(plan.layout, index, device, planar, n_traj)


def layout_basis_state(layout: GroupLayout, index: int, device,
                       planar: bool = True,
                       n_traj: int | None = None) -> torch.Tensor:
    shape = tuple(layout.axis_sizes)
    lead = () if n_traj is None else (n_traj,)
    x = torch.zeros(lead + ((2,) if planar else ()) + shape,
                    dtype=CONFIG.real_dtype, device=device)
    re = x.reshape(lead + ((2,) if planar else ()) + (-1,))
    if planar:
        re = re.select(len(lead), 0)
    re[..., index] = 1.0
    return x


_PLANS: dict[tuple, GroupPlan] = {}


def get_group_plan(program: prog.CircuitProgram) -> GroupPlan:
    """``build_group_plan`` cached by the program's compile key (the
    trajectory executors rebuild their segment programs per chunk)."""
    with span("plan.lookup"):
        plan = _PLANS.get(program.compile_key)
        if plan is None:
            plan = build_group_plan(program)
            if len(_PLANS) > 128:
                _PLANS.pop(next(iter(_PLANS)))
            _PLANS[program.compile_key] = plan
        return plan


def group_forward_state_body(program: prog.CircuitProgram, params, device,
                             plain: bool = False
                             ) -> tuple[torch.Tensor, bool]:
    """Forward pass returning ``(x, planar)``: the executor's grouped
    state as it is, planar ``(2, *axis_sizes)`` real or, for an
    all-real plan, real ``(*axis_sizes,)``. No complex copy is built
    (``bigstate.py:323-360``)."""
    plan = get_group_plan(program)
    operands = operands_to(build_group_operands(program, plan, params),
                           device)
    planar = not plan.all_real
    x = basis_state(plan, program.initial_index, device, planar)
    return execute_group_plan(plan, operands, program, params, x, planar,
                              plain), planar


def group_forward_body(program: prog.CircuitProgram, params, device,
                       plain: bool = False) -> torch.Tensor:
    """Forward pass through the group plan: ``CONFIG.dtype`` state
    ``(2^n,)`` on ``device`` (``plan.py:1556-1572``, with the all-real
    branch)."""
    x, planar = group_forward_state_body(program, params, device, plain)
    if planar:
        return torch.complex(x[0], x[1]).reshape(-1)
    return x.reshape(-1).to(CONFIG.dtype)


def group_batched_forward(program: prog.CircuitProgram, params_batch,
                          device, plain: bool = False) -> torch.Tensor:
    """``(B, 2^n)`` complex states of the circuit at each row of a
    ``(B, P)`` parameter batch: the port's form of the JAX package's
    ``vmap(forward_body)`` (``program.py:384-391``). The operands are built
    on ``device`` with one matrix per row for every parameterized op, and
    every dense and cross step is one batched kernel launch (``plain``:
    the twins). No renormalization: the JAX forward has none."""
    params = prog.param_tensor(params_batch, device)
    if params.ndim != 2:
        raise ValueError(f"expected a (B, P) parameter batch, got shape "
                         f"{tuple(params.shape)}")
    B = params.shape[0]
    plan = get_group_plan(program)
    operands = build_group_operands_batched(program, plan, params, B,
                                            device)
    planar = not plan.all_real
    x = basis_state(plan, program.initial_index, device, planar, B)
    x = execute_group_plan(plan, operands, program, params, x, planar,
                           plain, batched=True)
    del operands
    if planar:
        return _combine(x)
    return x.reshape(B, -1).to(CONFIG.dtype)


# ---------------------------------------------------------------------------
# Per-gate trajectory body (``plan.py:1134-1535``), batched over
# trajectories: noise after every gate forbids composition, so each gate
# and each drawn Kraus operator is its own step.
# ---------------------------------------------------------------------------

def categorical(weights: torch.Tensor,
                generator: torch.Generator | None,
                uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """One index per row of ``(T, m)`` non-negative weights, drawn by
    inverse CDF on float64 uniforms from ``generator`` (on the weights'
    device), or on the given ``(T,)`` ``uniforms``. The law of
    ``jax.random.categorical(key, log(w))``; the numbers differ."""
    cdf = torch.cumsum(weights.to(torch.float64), dim=-1)
    if uniforms is None:
        uniforms = torch.rand(cdf.shape[:-1], dtype=torch.float64,
                              device=cdf.device, generator=generator)
    u = uniforms[..., None] * cdf[..., -1:]
    idx = torch.searchsorted(cdf, u, right=True).squeeze(-1)
    return idx.clamp_(max=weights.shape[-1] - 1)


def total_draws(program: prog.CircuitProgram, noise_model) -> int:
    """Kraus draws of one trajectory of ``group_trajectory_body``: one per
    channel and target of every op."""
    return sum(len(noise_model.kraus_stacks_for_gate(op.gate_name))
               * len(op.targets) for op in program.ops)


def draw_uniforms(program: prog.CircuitProgram, noise_model, n_traj: int,
                  device, generator: torch.Generator | None
                  ) -> torch.Tensor:
    """``(T, total_draws)`` float64 uniforms, one row per trajectory: fed
    to ``group_trajectory_body``, they make each trajectory's branches
    depend on its own row only, whatever batches the rows are cut into
    (the port's form of one PRNG key per trajectory)."""
    return torch.rand((n_traj, total_draws(program, noise_model)),
                      dtype=torch.float64, device=device,
                      generator=generator)


def apply_gate_grouped(x: torch.Tensor, u: torch.Tensor,
                       targets: tuple[int, ...], layout: GroupLayout,
                       plain: bool = False,
                       planar: bool = True) -> torch.Tensor:
    """Apply a (B, 2^k, 2^k) complex gate (B = 1 shared, or one per
    trajectory) to a batched grouped state, planar ``(T, 2, *axis_sizes)``
    or real ``(T, *axis_sizes)`` (then ``u``'s real part acts)
    (``plan.py:1387-1440``, ``bigtraj.py:333-461``): a one-axis gate
    embeds into a dense operator (the ``dense_axis`` kernel), a two-axis
    gate with a lone bit becomes a cross operator (``cross_bit_axis``),
    anything else is contracted against its exposed bits
    (``apply_gate_bits``; chunk by chunk in place for a big state)."""
    T = x.shape[0]

    def planes(m: torch.Tensor) -> torch.Tensor:
        p = _t_planes(m, T)
        return p if planar else p.select(1, 0)

    axes = sorted({layout.axis_of(q) for q in targets})
    if len(axes) == 1:
        ax = axes[0]
        qubits = sorted(targets, key=lambda q: layout.pos_in_axis(q))
        full = _t_embed_in_axis(_t_reorder_targets(u, targets, qubits),
                                tuple(layout.pos_in_axis(q) for q in qubits),
                                layout.axis_bits[ax])
        dense = cuda_exec.dense_axis_plain if plain else cuda_exec.dense_axis
        return dense(x.contiguous(), planes(full), ax, planar, True)
    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    lone = [ax for ax in axes if len(by_axis[ax]) == 1]
    if len(axes) == 2 and lone:
        # both lone: the operator goes on the smaller axis, as the planner
        # puts it
        slice_axis = max(lone, key=lambda ax: layout.axis_sizes[ax])
        op_axis = axes[0] if axes[0] != slice_axis else axes[1]
        slice_q = by_axis[slice_axis][0]
        op_qubits = sorted(by_axis[op_axis],
                           key=lambda q: layout.pos_in_axis(q))
        gl = 1 << len(op_qubits)
        u4 = _t_reorder_targets(u, targets, [slice_q] + op_qubits).reshape(
            -1, 2, gl, 2, gl)
        pos = tuple(layout.pos_in_axis(q) for q in op_qubits)
        bits = layout.axis_bits[op_axis]
        blocks = [[_t_embed_in_axis(u4[:, i, :, j, :], pos, bits)
                   for j in (0, 1)] for i in (0, 1)]
        C = torch.stack([torch.stack(row, dim=1) for row in blocks], dim=1)
        cross = (cuda_exec.cross_bit_axis_plain if plain
                 else cuda_exec.cross_bit_axis)
        return cross(x.contiguous(), planes(C.permute(0, 1, 3, 2, 4)),
                     slice_axis, layout.pos_in_axis(slice_q), op_axis, planar,
                     True)
    tbits = tuple((layout.axis_of(q), layout.pos_in_axis(q))
                  for q in targets)
    ub = u[0] if u.shape[0] == 1 else u

    def fn(v):
        return apply_gate_bits(v, ub, tbits, planar, True)

    if is_big(x):
        return apply_in_chunks(x, 1 + int(planar), set(axes), fn)
    return fn(x)


def apply_cphase_grouped(x: torch.Tensor, targets: tuple[int, ...],
                         v: complex, layout: GroupLayout,
                         planar: bool = True) -> torch.Tensor:
    """Controlled-phase-form diagonal on a batched grouped state, planar
    or real (then ``v`` is real): one broadcast pass
    (``plan.py:1134-1150``), chunk by chunk in place for a big state."""
    facs = tuple(torch.from_numpy(m).to(x.device)
                 for _, m in _indicator_masks(targets, layout))
    axes = tuple(sorted({layout.axis_of(q) for q in targets}))
    fn = _prod_chunk_fn((facs, float(np.real(v)) - 1.0, float(np.imag(v))),
                        len(layout.axis_sizes), axes, planar, True)
    if is_big(x):
        return apply_in_chunks(x, 1 + int(planar), (), fn, sliced=True)
    return fn(x, None, 0, 0)


def _rho_q_grouped(x: torch.Tensor, q: int,
                   layout: GroupLayout) -> torch.Tensor:
    """(T, 2, 2) single-qubit reduced density matrices of a planar batched
    state (``plan.py:1443-1454``)."""
    ax = layout.axis_of(q)
    pos = layout.pos_in_axis(q)
    shape = tuple(layout.axis_sizes)
    pre = int(np.prod(shape[:ax], dtype=np.int64)) << pos
    post = (shape[ax] >> (pos + 1)) * int(np.prod(shape[ax + 1:],
                                                  dtype=np.int64))
    y = x.reshape(x.shape[0], 2, pre, 2, post)
    # elementwise products and sums over the two halves of the qubit: an
    # einsum becomes a batched matmul with a 2 x 2 output, which runs far
    # below the card's memory rate and took most of the per-gate body
    a, b = y[:, :, :, 0], y[:, :, :, 1]            # (T, plane, pre, post)
    p0 = a.square().sum((1, 2, 3))
    p1 = b.square().sum((1, 2, 3))
    re = (a * b).sum((1, 2, 3))
    im = (a[:, 1] * b[:, 0]).sum((1, 2)) - (a[:, 0] * b[:, 1]).sum((1, 2))
    zero = torch.zeros_like(p0)
    off = torch.complex(re, im)
    return torch.stack([
        torch.stack([torch.complex(p0, zero), off], -1),
        torch.stack([off.conj(), torch.complex(p1, zero)], -1)], -2)


def _combine(x: torch.Tensor) -> torch.Tensor:
    """Planar batched state -> (T, 2^n) complex."""
    return torch.complex(x[:, 0], x[:, 1]).reshape(x.shape[0], -1)


def _write_column(out: torch.Tensor, col: int, x: torch.Tensor) -> None:
    """Copy a planar batched state into ``out[:, col]`` of a ``(T, C+1,
    2^n)`` complex stack, plane by plane: no complex temporary."""
    T = x.shape[0]
    dst = torch.view_as_real(out[:, col])
    dst[..., 0].copy_(x[:, 0].reshape(T, -1))
    dst[..., 1].copy_(x[:, 1].reshape(T, -1))


def group_trajectory_body(program: prog.CircuitProgram, noise_model,
                          params, n_traj: int, device,
                          generator: torch.Generator | None = None,
                          draws: torch.Tensor | None = None,
                          record_columns: bool = False,
                          plain: bool = False,
                          out: torch.Tensor | None = None,
                          uniforms: torch.Tensor | None = None):
    """``n_traj`` stochastic-Kraus trajectories over the group layout
    (``plan.py:1457-1535``): after every gate, for each channel and each
    target, branch probabilities from the target's reduced density
    matrix, one categorical draw per trajectory, the drawn Kraus operator
    applied (one batched kernel launch with one operator per trajectory)
    and the state rescaled; one exact normalization at the end.

    Returns ``(states, draws)``: states ``(T, 2^n)`` ``CONFIG.dtype``, or ``(T,
    columns + 1, 2^n)`` with ``record_columns`` (the initial state, then
    one snapshot after each column), each column written as it is reached
    into one stack allocated up front, or into ``out`` when given;
    ``draws`` the ``(T, total_draws)`` branch indices. Passing ``draws``
    replays those branches; passing ``uniforms`` (``draw_uniforms``)
    draws them from those rows instead of ``generator``."""
    layout = GroupLayout.for_qubits(program.num_qubits)
    T = n_traj
    if record_columns:
        shape = (T, program.num_columns + 1, 1 << program.num_qubits)
        if out is None:
            out = torch.empty(shape, dtype=CONFIG.dtype, device=device)
        elif tuple(out.shape) != shape or out.dtype != CONFIG.dtype \
                or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous {CONFIG.dtype} "
                             f"tensor of shape {shape}")
    n_draws = total_draws(program, noise_model)
    if draws is None:
        draws = torch.zeros((T, n_draws), dtype=torch.long, device=device)
        replay = False
    else:
        replay = True
    # Every gate matrix and Kraus stack goes to the device before the
    # first step: a copy from pageable host memory waits for the stream,
    # so one per gate would idle the card between gates.
    mats = [None if op.cphase_value is not None else torch.from_numpy(
        program.op_matrix(op, params)).to(device)[None]
        for op in program.ops]
    stacks: dict[str, list[torch.Tensor]] = {}
    for op in program.ops:
        if op.gate_name in stacks:
            continue
        raw = noise_model.kraus_stacks_for_gate(op.gate_name)
        if any(k.shape[1] != 2 for k in raw):
            raise ValueError(
                "the per-gate trajectory body applies one-qubit Kraus "
                "stacks; a multi-qubit stack needs the splice executors "
                "(ops/unitary_traj.py, ops/monomial_traj.py)")
        stacks[op.gate_name] = [torch.from_numpy(np.asarray(
            k, dtype=CONFIG.np_complex)).to(device) for k in raw]
    x = layout_basis_state(layout, program.initial_index, device, True, T)
    if record_columns:
        _write_column(out, 0, x)
    d = 0
    op_i = 0
    for col in range(program.num_columns):
        while (op_i < len(program.ops)
               and program.ops[op_i].column_index == col):
            op = program.ops[op_i]
            if op.cphase_value is not None:
                x = apply_cphase_grouped(x, op.targets, op.cphase_value,
                                         layout)
            else:
                x = apply_gate_grouped(x, mats[op_i], op.targets, layout,
                                       plain)
            for kraus in stacks[op.gate_name]:
                for q in op.targets:
                    rho = _rho_q_grouped(x, q, layout)
                    norms = torch.einsum("mij,tjk,mik->tm", kraus, rho,
                                         kraus.conj()).real
                    if replay:
                        idx = draws[:, d]
                    else:
                        idx = categorical(
                            norms + 1e-30, generator,
                            None if uniforms is None else uniforms[:, d])
                        draws[:, d] = idx
                    x = apply_gate_grouped(x, kraus[idx], (q,), layout,
                                           plain)
                    p = norms.gather(1, idx[:, None]).squeeze(1)
                    inv = torch.rsqrt(p.clamp(min=1e-30))
                    x.mul_(inv.reshape((T,) + (1,) * (x.ndim - 1)))
                    d += 1
            op_i += 1
        if record_columns:
            _write_column(out, col + 1, x)
    if n_draws:
        # one exact division restores ||psi|| = 1; it changes no branch
        nsq = x.square().reshape(T, -1).sum(-1)
        x = x * torch.rsqrt(nsq).reshape((T,) + (1,) * (x.ndim - 1))
        if record_columns:
            _write_column(out, program.num_columns, x)
    if record_columns:
        return out, draws
    return _combine(x), draws
