"""Group-matmul circuit executor: the port's forward path at every n.

Counterpart of ``quantum_simulator_tpu/ops/plan.py``. The n qubits are
grouped into axes of at most 7 bits (``GroupLayout``, ``plan.py:68-102``)
and the state is a planar float32 tensor ``(2, *axis_sizes)``, or a real
``(*axis_sizes,)`` one when every operator of the plan is real. The host
planner (``build_group_plan``, ``plan.py:287-510``) and the NumPy operand
build (``plan.py:517-982``, its ``xp=np`` mode) are carried over as they
are, so the port takes the same steps as the JAX package:

* ``AxisMatmulStep`` -> the ``dense_axis`` CUDA kernel (``cuda_exec.py``);
* ``CrossStep`` -> the ``cross_bit_axis`` CUDA kernel;
* ``BitPairStep`` -> a transpose for an exact SWAP, else a K=4 einsum;
* ``DiagPairStep`` / ``DiagProductStep`` -> elementwise torch ops;
* ``GenericStep`` -> the segmented einsum of ``ops/apply.py``.

Operands are built once per run on the host and moved to the device.
The port stores a complex operator as two float32 planes ``(re, im)``
where the JAX package stores the blocked ``[[re, -im], [im, re]]`` form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_exec
from . import program as prog
from .apply import apply_gate
from .cuda_exec import _blocked, _cross_spec, _split_axis_bit

GROUP_BITS = 7

_F32 = np.float32

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


def count_state_passes(plan: GroupPlan) -> int:
    """Whole-state sweeps: one per dense / cross / diag-pair step and per
    non-swap bit-pair step; a run of adjacent swap bit-pairs counts once.
    DiagProductSteps are excluded (``plan.py:1234-1253``)."""
    passes = 0
    prev_swap = False
    for s in plan.steps:
        if (isinstance(s, BitPairStep)
                and plan.bitpair_specs[s.index].is_swap):
            if not prev_swap:
                passes += 1
            prev_swap = True
            continue
        prev_swap = False
        if isinstance(s, (AxisMatmulStep, CrossStep, DiagPairStep,
                          BitPairStep)):
            passes += 1
    return passes


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
    re = np.tensordot(np.real(flat).astype(_F32), masks, axes=1)
    if not np.iscomplexobj(u):
        return re.astype(u.dtype)
    im = np.tensordot(np.imag(flat).astype(_F32), masks, axes=1)
    return (re + 1j * im).astype(u.dtype)


class _GateMatrixPool:
    """Per-op gate matrices plus one (P, 2, 2) pool of the single-qubit
    ones (``plan.py:553-707``, NumPy mode)."""

    def __init__(self, program: prog.CircuitProgram, params, dtype):
        self._per_op: dict[int, np.ndarray] = {}
        by_name: dict[tuple, list[int]] = {}
        static_cache: dict[bytes, np.ndarray] = {}
        static_1q: dict[bytes, tuple[np.ndarray, int]] = {}
        for oi, op in enumerate(program.ops):
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
        pool_parts = [np.eye(2, dtype=np.complex64)[None]]
        for mat, _ in static_1q.values():
            pool_parts.append(mat.astype(np.complex64)[None])
        pool_parts = [np.asarray(np.concatenate(pool_parts), dtype=dtype)]
        base = 1 + len(static_1q)
        for oi, op in enumerate(program.ops):
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
    """Per-axis all-targets-set indicator vectors (axis, (S,) f32)."""
    by_axis: dict[int, list[int]] = {}
    for q in targets:
        by_axis.setdefault(layout.axis_of(q), []).append(q)
    out = []
    for ax in sorted(by_axis):
        bits = layout.axis_bits[ax]
        size = layout.axis_sizes[ax]
        mask = np.ones(size, np.float32)
        for q in by_axis[ax]:
            bit = bits - 1 - layout.pos_in_axis(q)
            mask *= ((np.arange(size) >> bit) & 1).astype(np.float32)
        out.append((ax, mask))
    return out


def _planes(m: np.ndarray, axis: int = 0) -> np.ndarray:
    """Complex array -> float32 (re, im) planes stacked at ``axis``."""
    return np.stack([np.real(m), np.imag(m)], axis=axis).astype(_F32)


def build_group_operands(program: prog.CircuitProgram, plan: GroupPlan,
                         params, dtype=np.complex64):
    """Host NumPy operands, in the port's layout:

    * ``axis_stacks[ax]``: (m, 2, S, S) planes of each composed operator;
    * ``cross_ops[i]``: (2, 2, S, 2, S) planes indexed (plane, i, y, k, x);
    * ``diag_ops[i]``: (2, S_a, S_b) planes of each pair diagonal;
    * ``prod_ops[i]``: (per-axis indicator masks, Re(v-1), Im(v-1));
    * ``bitpair_ops[i]``: (2, 2, 2, 2, 2) planes, or None for a SWAP.

    The arithmetic is that of ``build_group_operands(..., xp=np)``
    (``quantum_simulator_tpu/ops/plan.py:818-982``)."""
    layout = plan.layout
    pool = _GateMatrixPool(program, params, dtype)

    # Batch every all-1q sub-column of each axis width into one kron chain.
    classes: dict[int, list[np.ndarray]] = {}
    class_ref: dict[tuple[int, int], int] = {}
    for si, seg in enumerate(plan.dense_segments):
        bits = layout.axis_bits[seg.axis]
        for bi, sub in enumerate(seg.subcolumns):
            if not all(len(program.ops[oi].targets) == 1 for oi in sub):
                continue
            table = np.zeros(bits, dtype=np.int32)
            for oi in sub:
                q = program.ops[oi].targets[0]
                table[layout.pos_in_axis(q)] = pool.pool_index(oi)
            class_ref[(si, bi)] = len(classes.setdefault(bits, []))
            classes[bits].append(table)
    batched = {bits: _batched_1q_subcolumns(pool, np.stack(tables))
               for bits, tables in classes.items()}

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
            combined = sc if combined is None else np.matmul(sc, combined)
        axis_lists[seg.axis].append(combined)

    axis_stacks = []
    for ax, ops in enumerate(axis_lists):
        if not ops:
            ops = [np.eye(layout.axis_sizes[ax], dtype=dtype)]
        axis_stacks.append(_planes(np.stack(ops), axis=1))

    cross_ops = []
    for spec in plan.cross_specs:
        op = program.ops[spec.op_index]
        slice_q = next(q for q in op.targets
                       if layout.axis_of(q) == spec.slice_axis)
        op_qs = sorted((q for q in op.targets
                        if layout.axis_of(q) == spec.op_axis),
                       key=lambda q: layout.pos_in_axis(q))
        u = reorder_gate_targets(pool.matrix(spec.op_index), op.targets,
                                 [slice_q] + op_qs)
        gl = 1 << len(op_qs)
        u4 = u.reshape(2, gl, 2, gl)
        pos = tuple(layout.pos_in_axis(q) for q in op_qs)
        bits = layout.axis_bits[spec.op_axis]
        blocks = [[_embed_in_axis(u4[i, :, kk, :], pos, bits)
                   for kk in (0, 1)] for i in (0, 1)]
        if spec.pre_slice_ops:
            # folded 1q gates on the sliced bit: B'_ik = sum_j B_ij us_jk
            us = None
            for oi in spec.pre_slice_ops:
                m = pool.matrix(oi)
                us = m if us is None else np.matmul(m, us)
            blocks = [[blocks[i][0] * us[0, kk] + blocks[i][1] * us[1, kk]
                       for kk in (0, 1)] for i in (0, 1)]
        if spec.pre_op_subcolumns:
            # pending op-axis operator applies before the cross: blocks @ M
            m = None
            for sub in spec.pre_op_subcolumns:
                sc = _subcolumn_operator(program, pool, sub, layout,
                                         spec.op_axis, dtype)
                m = sc if m is None else np.matmul(sc, m)
            blocks = [[np.matmul(blocks[i][kk], m)
                       for kk in (0, 1)] for i in (0, 1)]
        C = np.stack([np.stack(row, axis=0) for row in blocks], axis=0)
        cross_ops.append(_planes(C.transpose(0, 2, 1, 3)))  # (i, y, k, x)

    bitpair_ops = []
    for spec in plan.bitpair_specs:
        if spec.is_swap:
            bitpair_ops.append(None)  # executes as a transpose
            continue
        op = program.ops[spec.op_index]
        slice_q = next(q for q in op.targets
                       if layout.axis_of(q) == spec.slice_axis)
        op_q = next(q for q in op.targets if q != slice_q)
        u = reorder_gate_targets(pool.matrix(spec.op_index), op.targets,
                                 [slice_q, op_q])
        bitpair_ops.append(_planes(u.reshape(2, 2, 2, 2)))

    prod_ops = []
    for seg in plan.prod_segments:
        v = _diag_product_value(program.ops[seg.op_index])
        facs = tuple(m for _, m in _indicator_masks(
            program.ops[seg.op_index].targets, layout))
        prod_ops.append((facs, float(np.real(v - 1)), float(np.imag(v - 1))))

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
# Execution
# ---------------------------------------------------------------------------

def _diag_spec(rank: int, axis_a: int, axis_b: int, op_real: bool = False,
               planar: bool = True) -> str:
    subs = "".join(cuda_exec._AXIS_LETTERS[:rank])
    if op_real and not planar:
        return f"{subs[axis_a]}{subs[axis_b]},{subs}->{subs}"
    if op_real:
        return f"{subs[axis_a]}{subs[axis_b]},d{subs}->d{subs}"
    return f"cd{subs[axis_a]}{subs[axis_b]},d{subs}->c{subs}"


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


def apply_bitpair(x, plan, step, bitpair_ops, planar: bool):
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
        real = plan.bitpair_real[step.index]
        q = bitpair_ops[step.index]
        xr = torch.einsum(_cross_spec(len(new_shape), bs, bo, real, planar),
                          q[0] if real else _blocked(q), xr)
    return xr.reshape(x.shape)


def apply_prod_diag(x, facs, cre: float, cim: float, rank: int,
                    axes: tuple[int, ...], planar: bool) -> torch.Tensor:
    """``x += (v-1) * x * prod mask_ax`` as broadcast elementwise ops."""
    ind = None
    for ax, m in zip(axes, facs):
        shape = [1] * rank
        shape[ax] = m.shape[0]
        f = m.reshape(shape)
        ind = f if ind is None else ind * f
    if not planar:
        return x + cre * (x * ind)  # real state => v real
    xr, xi = x[0], x[1]
    tr = xr * ind
    ti = xi * ind
    return torch.stack([xr + cre * tr - cim * ti,
                        xi + cre * ti + cim * tr])


def execute_group_plan(plan: GroupPlan, operands, program, params,
                       x: torch.Tensor, planar: bool = True,
                       plain: bool = False) -> torch.Tensor:
    """Run all steps on ``x``: planar ``(2, *axis_sizes)``, or real
    ``(*axis_sizes,)`` with ``planar=False`` (only for ``plan.all_real``).
    Dense and cross steps go through the ``cuda_exec`` kernel wrappers;
    ``plain=True`` calls their plain PyTorch twins instead on any device
    (the reference executor the kernels are checked and timed against).

    Takes ownership of ``x``: on a CUDA tensor the kernels write in place,
    so ``x`` may be overwritten by the run; pass a state you no longer
    need (or a clone)."""
    layout = plan.layout
    shape = tuple(layout.axis_sizes)
    rank = len(shape)
    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = operands
    dense = cuda_exec.dense_axis_plain if plain else cuda_exec.dense_axis
    cross = (cuda_exec.cross_bit_axis_plain if plain
             else cuda_exec.cross_bit_axis)

    for step in plan.steps:
        # einsum and transpose results may be strided views; the kernels
        # take contiguous states
        if isinstance(step, AxisMatmulStep):
            real = plan.dense_real[step.axis][step.op_index]
            op = axis_stacks[step.axis][step.op_index]
            x = dense(x.contiguous(), op[0] if real else op, step.axis,
                      planar)
        elif isinstance(step, CrossStep):
            real = plan.cross_real[step.index]
            cop = cross_ops[step.index]
            x = cross(x.contiguous(), cop[0] if real else cop,
                      step.slice_axis, step.slice_pos, step.op_axis, planar)
        elif isinstance(step, BitPairStep):
            x = apply_bitpair(x, plan, step, bitpair_ops, planar)
        elif isinstance(step, DiagPairStep):
            real = plan.diag_real[step.index]
            d = diag_ops[step.index]
            x = torch.einsum(
                _diag_spec(rank, step.axis_a, step.axis_b, real, planar),
                d[0] if real else _blocked(d), x)
        elif isinstance(step, DiagProductStep):
            facs, cre, cim = prod_ops[step.index]
            x = apply_prod_diag(x, facs, cre, cim, rank, step.axes, planar)
        else:  # GenericStep (never in an all-real plan)
            op = program.ops[step.program_op]
            u = program.op_matrix(op, params, np.complex64)
            flat = torch.complex(x[0], x[1]).reshape(-1)
            shaped = apply_gate(flat, u, op.targets,
                                layout.num_qubits).reshape(shape)
            x = torch.stack([shaped.real, shaped.imag])
    return x


def basis_state(plan: GroupPlan, index: int, device,
                planar: bool = True) -> torch.Tensor:
    """One-hot float32 basis state, planar ``(2, *axis_sizes)`` or real."""
    shape = tuple(plan.layout.axis_sizes)
    x = torch.zeros(((2,) if planar else ()) + shape, dtype=torch.float32,
                    device=device)
    (x[0] if planar else x).view(-1)[index] = 1.0
    return x


def group_forward_body(program: prog.CircuitProgram, params, device,
                       plain: bool = False) -> torch.Tensor:
    """Forward pass through the group plan: complex64 state ``(2^n,)`` on
    ``device`` (``plan.py:1556-1572``, with the all-real branch)."""
    plan = build_group_plan(program)
    operands = operands_to(build_group_operands(program, plan, params),
                           device)
    planar = not plan.all_real
    x = basis_state(plan, program.initial_index, device, planar)
    x = execute_group_plan(plan, operands, program, params, x, planar,
                           plain)
    if planar:
        return torch.complex(x[0], x[1]).reshape(-1)
    return x.reshape(-1).to(torch.complex64)
