"""Hand-written CUDA kernels for the dense, cross and pair-diagonal
group-plan steps.

Counterpart of ``quantum_simulator_tpu/ops/pallas_exec.py``. Two kernels
carry every matrix product of the main path:

* ``dense_axis`` replaces ``lower_dense`` (``pallas_exec.py:178-222``):
  ``x <- U x`` along one grouped axis of size S <= 128;
* ``cross_bit_axis`` replaces ``lower_cross`` (``pallas_exec.py:229-338``):
  ``y[i,.,a,.] = sum_k sum_b C[i,a,k,b] x[k,.,b,.]`` where ``i``/``k`` are
  one bit of ``slice_axis`` and ``a``/``b`` run over ``op_axis``.

Both are one CUDA template (``csrc/fiber_matmul.cuh``): the state is a
set of "fibers", each a K-long column of rows whose offsets are
``(r // S) * bit_stride + (r % S) * op_stride``; one block owns each tile
of fibers, multiplies the operator into it (3xTF32 on the tensor cores
for K >= ``MMA_MIN_K``, fp32 FMA below) and writes the result over it. A
complex K = 256 cross step whose operator serves the whole launch
(``takes_cluster``) runs on a thread-block cluster instead: its CTAs split
the operator's rows and keep them resident, and one cluster owns each
tile.
The wrappers below reduce the state to that strided view
(``dense_geometry``, ``cross_geometry``), choose how a tile is copied
(``copy_plan``), check what the kernel takes and raise on anything else.
Every geometry the planner emits is covered, including a sliced bit
inside the last axis, which Pallas declines.

A third kernel, ``diag_pair`` (``csrc/diag_pair.cu``), serves every
``DiagPairStep``: ``x[i] <- d[i_a, i_b] x[i]`` over the whole state in
place, one launch, where the JAX package leaves the step to XLA as an
elementwise einsum (``_diag_spec``, its plain twin here). It replaces no
Pallas kernel and is no fiber kernel: it launches outside ``_launch``,
leaves no launch record and is not in ``KERNELS``. A fourth, ``swap_bits``
(``csrc/swap_bits.cu``), is the same kind: it applies a run of SWAP gates
on disjoint qubit pairs (the composed permutation of the index bits) to
the whole state in place in one launch, where the JAX package transposes
two bit dims a swap; its twin is one gather (``swap_bits_plain``).

Each wrapper has a plain PyTorch twin (``*_plain``: ``torch.einsum`` on the
JAX package's ``_dense_spec`` / ``_cross_spec`` forms, in the state's
dtype). The wrapper takes the twin only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches, ``cross_bit_axis.cluster_launches`` those of them that the
cluster kernel served.

A float64 state (``config.enable_complex128``) goes to the float64 kernels
(``dense_axis_f64``, ``cross_bit_axis_f64``: ``csrc/fiber_matmul_f64.cu``,
DMMA on the FP64 tensor cores for K >= ``F64_MMA_MIN_K``, FP64 FMA below),
each with its own count and a copy plan in doubles (``copy_plan(g, 8)``);
``dense_axis`` and ``cross_bit_axis`` route a float64 CUDA state there
and count only their float32 launches. State and operator must share one
dtype: a mixed pair raises.

Both wrappers also take a batch of B trajectories (``batched=True``): the
state ``(B, [2,] *axis_sizes)`` and an operator with a leading B axis,
one per trajectory, or one shared operator repeated with stride 0
(``expand``). That is the noisy-trajectory path, where JAX vmaps the
executor over PRNG keys (``program.batched_trajectories_fn``) and every
step becomes one operation with a different operator per trajectory: one
launch serves the whole batch, and ``launches`` counts batched launches.
The twins take the same leading axis (one einsum with a batch index).

The JAX package gates its kernels behind ``CONFIG.pallas_steps`` and a
rank >= 5 rule tuned to XLA on the TPU; the port carries neither.
In place, like the Pallas kernels (``input_output_aliases``): on a CUDA
tensor a wrapper overwrites its input and returns that same tensor, so a
step holds one state; the plain twins (and so the CPU path) return a new
tensor. Neither kernel has a backward pass (the Pallas ones have no VJP
either).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import profiling
from . import _build

_AXIS_LETTERS = "abefghjlmnopqrstuvwz"  # reserved: c d i k x y


# ---------------------------------------------------------------------------
# Einsum forms (``quantum_simulator_tpu/ops/plan.py:1024-1072``)
# ---------------------------------------------------------------------------

def _dense_spec(rank: int, axis: int, op_real: bool = False,
                planar: bool = True, batched: bool = False) -> str:
    """``batched``: a leading trajectory index ``T`` on the operator, the
    state and the result (one operator per trajectory)."""
    t = "T" if batched else ""
    subs = list(_AXIS_LETTERS[:rank])
    out = list(subs)
    out[axis] = "y"
    if op_real and not planar:
        return f"{t}y{subs[axis]},{t}{''.join(subs)}->{t}{''.join(out)}"
    if op_real:
        return f"{t}y{subs[axis]},{t}d{''.join(subs)}->{t}d{''.join(out)}"
    return f"{t}cdy{subs[axis]},{t}d{''.join(subs)}->{t}c{''.join(out)}"


def _cross_spec(rank_new: int, bit_axis: int, op_axis_new: int,
                op_real: bool = False, planar: bool = True,
                batched: bool = False) -> str:
    t = "T" if batched else ""
    subs = list(_AXIS_LETTERS[:rank_new])
    subs[bit_axis] = "k"
    subs[op_axis_new] = "x"
    out = list(subs)
    out[bit_axis] = "i"
    out[op_axis_new] = "y"
    if op_real and not planar:
        return f"{t}iykx,{t}{''.join(subs)}->{t}{''.join(out)}"
    if op_real:
        return f"{t}iykx,{t}d{''.join(subs)}->{t}d{''.join(out)}"
    return f"{t}cdiykx,{t}d{''.join(subs)}->{t}c{''.join(out)}"


def _diag_spec(rank: int, axis_a: int, axis_b: int, op_real: bool = False,
               planar: bool = True, batched: bool = False) -> str:
    t = "T" if batched else ""
    subs = "".join(_AXIS_LETTERS[:rank])
    if op_real and not planar:
        return f"{t}{subs[axis_a]}{subs[axis_b]},{t}{subs}->{t}{subs}"
    if op_real:
        return f"{t}{subs[axis_a]}{subs[axis_b]},{t}d{subs}->{t}d{subs}"
    return f"{t}cd{subs[axis_a]}{subs[axis_b]},{t}d{subs}->{t}c{subs}"


def _split_axis_bit(shape: tuple[int, ...], axis: int, pos: int):
    """New shape exposing bit ``pos`` (MSB-first) of ``axis`` as its own
    dimension; returns (new_shape, bit_axis_index)."""
    bits = shape[axis].bit_length() - 1
    pre = 1 << pos
    post = 1 << (bits - pos - 1)
    return shape[:axis] + (pre, 2, post) + shape[axis + 1:], axis + 1


def _blocked(planes: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """(re, im) planes at ``dim`` -> the blocked ``[[re, -im], [im, re]]``
    (2, 2) pair of dims there, the form the einsums contract against."""
    re, im = planes.select(dim, 0), planes.select(dim, 1)
    return torch.stack([torch.stack([re, -im], dim), torch.stack([im, re],
                                                                 dim)], dim)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _layout_shape(x: torch.Tensor, planar: bool,
                  batched: bool = False) -> tuple[int, ...]:
    return tuple(x.shape[int(batched) + int(planar):])


def dense_axis_plain(x: torch.Tensor, op: torch.Tensor, axis: int,
                     planar: bool, batched: bool = False) -> torch.Tensor:
    """``U x`` along ``axis``: ``op`` is a real (S, S) or complex
    (2, S, S) (re, im) operator; ``x`` real or planar ``(2, ...)``.
    ``batched``: ``x`` and ``op`` carry a leading trajectory axis and
    trajectory ``t`` takes ``op[t]`` (one einsum with a batch index)."""
    b = int(batched)
    real = op.ndim == 2 + b
    if not real and not planar:
        raise ValueError("a complex operator needs a planar state")
    rank = len(_layout_shape(x, planar, batched))
    return torch.einsum(_dense_spec(rank, axis, real, planar, batched),
                        op if real else _blocked(op, b), x)


def cross_bit_axis_plain(x: torch.Tensor, cop: torch.Tensor,
                         slice_axis: int, slice_pos: int, op_axis: int,
                         planar: bool, batched: bool = False
                         ) -> torch.Tensor:
    """Cross step: ``cop`` is a real (2, S, 2, S) or complex
    (2, 2, S, 2, S) operator indexed (i, y, k, x); ``batched`` as for
    ``dense_axis_plain``."""
    b = int(batched)
    real = cop.ndim == 4 + b
    if not real and not planar:
        raise ValueError("a complex operator needs a planar state")
    shape = _layout_shape(x, planar, batched)
    new_shape, bit_axis = _split_axis_bit(shape, slice_axis, slice_pos)
    o = op_axis + (2 if op_axis > slice_axis else 0)
    lead = tuple(x.shape[:b + int(planar)])
    xr = x.reshape(lead + new_shape)
    out = torch.einsum(
        _cross_spec(len(new_shape), bit_axis, o, real, planar, batched),
        cop if real else _blocked(cop, b), xr)
    return out.reshape(x.shape)


def diag_pair_plain(x: torch.Tensor, d: torch.Tensor, axis_a: int,
                    axis_b: int, planar: bool,
                    batched: bool = False) -> torch.Tensor:
    """``x[i] <- d[i_a, i_b] x[i]``: ``d`` is a real (S_a, S_b) or complex
    (2, S_a, S_b) (re, im) table over ``axis_a`` x ``axis_b``; ``batched``
    as for ``dense_axis_plain``. One elementwise einsum, out of place."""
    b = int(batched)
    real = d.ndim == 2 + b
    if not real and not planar:
        raise ValueError("a complex table needs a planar state")
    rank = len(_layout_shape(x, planar, batched))
    return torch.einsum(_diag_spec(rank, axis_a, axis_b, real, planar,
                                   batched),
                        d if real else _blocked(d, b), x)


def swap_pairs(pairs, n_bits: int) -> tuple[tuple[int, int], ...]:
    """``pairs`` of data-index bits as (low, high); raises on a bit out of
    ``range(n_bits)``, a pair of one bit, or a bit two pairs share (a
    SWAP(a, b) then SWAP(b, c) is a 3-cycle, not one exchange)."""
    out, seen = [], set()
    for p, q in pairs:
        lo, hi = sorted((int(p), int(q)))
        if lo == hi or lo < 0 or hi >= n_bits:
            raise ValueError(f"swap_bits: pair ({p}, {q}) for {n_bits} bits")
        if lo in seen or hi in seen:
            raise ValueError(f"swap_bits: pair ({p}, {q}) shares a bit with "
                             f"another pair of {tuple(pairs)}")
        seen.update((lo, hi))
        out.append((lo, hi))
    return tuple(out)


def swap_index_map(n_bits: int, pairs, device=None) -> torch.Tensor:
    """pi as an index tensor: entry i is i with bits lo and hi exchanged
    for every pair."""
    i = torch.arange(1 << n_bits, device=device)
    out = i.clone()
    for lo, hi in swap_pairs(pairs, n_bits):
        d = ((i >> lo) ^ (i >> hi)) & 1
        out ^= (d << lo) | (d << hi)
    return out


def swap_bits_plain(x: torch.Tensor, pairs, planar: bool,
                    batched: bool = False) -> torch.Tensor:
    """``x[i] <- x[pi(i)]`` over the data index of each plane (and
    trajectory): pi exchanges the bits of each of ``pairs``, which share no
    bit. One gather through ``swap_index_map``, out of place."""
    lead = int(batched) + int(planar)
    n = _prod(x.shape[lead:]).bit_length() - 1
    flat = x.reshape(tuple(x.shape[:lead]) + (1 << n,))
    return flat[..., swap_index_map(n, pairs, x.device)].reshape(x.shape)


# ---------------------------------------------------------------------------
# Strided fiber view the kernels take
# ---------------------------------------------------------------------------

class Geometry(NamedTuple):
    """Element offsets of a state seen as fibers x rows.

    Fiber ``g`` = (outer o, mid m, inner t), t fastest, starts at
    ``o * so + m * sm + t``; row ``r`` of a fiber adds
    ``(r // S) * bit_stride + (r % S) * op_stride``. The imaginary plane
    of a complex step sits ``plane_stride`` after the real one."""

    n_outer: int
    so: int
    n_mid: int
    sm: int
    n_inner: int
    S: int
    op_stride: int
    bit_stride: int
    plane_stride: int


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= d
    return out


def dense_geometry(shape: tuple[int, ...], axis: int, planar: bool,
                   op_real: bool) -> Geometry:
    """State ``(planes, P, S, Q)``: a real operator treats the two planes
    as more fibers; a complex one reads both planes of each fiber."""
    P, S, Q = _prod(shape[:axis]), shape[axis], _prod(shape[axis + 1:])
    total = P * S * Q
    n_outer = P * (2 if planar and op_real else 1)
    return Geometry(n_outer, S * Q, 1, 0, Q, S, Q, 0,
                    0 if op_real else total)


def cross_geometry(shape: tuple[int, ...], slice_axis: int, slice_pos: int,
                   op_axis: int, planar: bool, op_real: bool) -> Geometry:
    """Canonical view (outer, bit, mid, op, inner), or its mirror
    (outer, op, mid, bit, inner) when ``op_axis < slice_axis``."""
    A = shape[slice_axis]
    S = shape[op_axis]
    pre = 1 << slice_pos
    post = A // (2 * pre)
    total = _prod(shape)
    if slice_axis < op_axis:
        B = _prod(shape[slice_axis + 1:op_axis])
        T = _prod(shape[op_axis + 1:])
        n_outer = _prod(shape[:slice_axis]) * pre
        g = Geometry(n_outer, 2 * post * B * S * T, post * B, S * T, T, S,
                     T, post * B * S * T, 0)
    else:
        B = _prod(shape[op_axis + 1:slice_axis])
        T = _prod(shape[slice_axis + 1:])
        n_outer = _prod(shape[:op_axis])
        g = Geometry(n_outer, S * B * A * T, B * pre, 2 * post * T,
                     post * T, S, B * A * T, post * T, 0)
    if planar and op_real:
        return g._replace(n_outer=2 * g.n_outer)
    return g._replace(plane_stride=0 if op_real else total)


# Contraction depths from this one up take the tensor-core path
# (``kMmaMinK`` in ``csrc/fiber_matmul.cuh``).
MMA_MIN_K = 32


def tile_fibers(K: int, real: bool, cluster: bool = False) -> int:
    """Fibers per tile at depth K: ``SimtTile`` / ``MmaTile<K, ...>::F`` of
    ``csrc/fiber_matmul.cuh``, or ``ClusterTile::F`` for a launch that
    ``takes_cluster`` (``tests/test_torch_gpu.py`` checks the two
    agree)."""
    if cluster:
        return 16
    if K < MMA_MIN_K:
        return 4096 // K
    if real:
        return {32: 128, 128: 128}.get(K, 64)
    return 64 if K == 32 else 32


def takes_cluster(K: int, real: bool, op_batch_stride: int,
                  vec: int) -> bool:
    """Whether a cross launch takes the cluster kernel: a complex K = 256
    operator that serves the whole batch (stride 0), with 16-byte copies
    (``copy_plan``). A cluster of CTAs splits the operator's rows, each
    keeping its share resident, and one cluster owns each fiber tile
    (``csrc/fiber_matmul.cuh``). ``cluster_path`` in
    ``csrc/cross_bit_axis.cu`` is the kernel's side of the rule
    (``tests/test_torch_gpu.py`` checks the two agree)."""
    return K == 256 and not real and op_batch_stride == 0 and vec == 4


# Contraction depths from this one up take the float64 kernels' DMMA path
# (``kF64MmaMinK`` in ``csrc/fiber_matmul_f64.cu``); below, FP64 FMA.
F64_MMA_MIN_K = 16


def tile_fibers_f64(K: int, real: bool) -> int:
    """Fibers per tile of the float64 kernels at depth K:
    ``F64FmaTile`` / ``F64MmaTile<K, ...>::F`` of ``csrc/fiber_matmul_f64.cu``
    (``tests/test_torch_gpu.py`` checks the two agree)."""
    if K < F64_MMA_MIN_K:
        return 256 * min(K, 4) * 4 // K
    if real:
        return {256: 64, 128: 128}.get(K, 256)
    return {256: 32, 128: 64, 64: 128}.get(K, 256)


def copy_plan(g: Geometry, itemsize: int = 4) -> tuple[bool, int]:
    """How a fiber tile is copied: ``(rows, vec)``.

    ``rows`` is True when each fiber's rows are contiguous (op axis last:
    ``n_inner == 1``, ``op_stride == 1``): the tile is stored row-major and
    copy chunks run along the rows. Otherwise chunks run along a run of
    ``n_inner`` contiguous fibers. ``vec`` is the elements per chunk, of
    ``itemsize`` bytes each (float32: 4, 2 or 1; float64: 2 or 1), the
    widest chunk of at most 16 bytes that divides the contiguous run and
    every stride, so every chunk is contiguous and aligned."""
    rows = g.n_inner == 1 and g.op_stride == 1
    run = g.S if rows else g.n_inner
    strides = (run, g.so, g.sm, g.bit_stride, g.plane_stride) + (
        () if rows else (g.op_stride,))
    vec = next(v for v in (4, 2, 1)
               if v * itemsize <= 16 and all(s % v == 0 for s in strides))
    return rows, vec


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, op: torch.Tensor, op_shape: tuple[int, ...],
           planar: bool, batched: bool, name: str) -> bool:
    """Validate a CUDA launch; returns True for a real operator. A batched
    operator may repeat one block with stride 0 (shared by every
    trajectory) or hold one contiguous block per trajectory at any
    stride that keeps 16-byte copies aligned."""
    want = torch.float64 if name.endswith("_f64") else torch.float32
    if x.dtype != want or op.dtype != want:
        raise TypeError(f"{name}: needs {want} state and operator, got "
                        f"{x.dtype} / {op.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: state on {x.device}, expected CUDA or CPU")
    if op.device != x.device:
        raise ValueError(f"{name}: operator on {op.device}, state on "
                         f"{x.device}")
    b = int(batched)
    block = op[0] if batched else op
    if not x.is_contiguous() or not block.is_contiguous():
        raise ValueError(f"{name}: state and operator must be contiguous")
    if batched and (op.shape[0] != x.shape[0]
                    or op.stride(0) * op.element_size() % 16):
        raise ValueError(f"{name}: batched operator of shape "
                         f"{tuple(op.shape)} and stride {op.stride(0)} for "
                         f"{x.shape[0]} trajectories")
    if planar and x.shape[b] != 2:
        raise ValueError(f"{name}: planar state needs a plane axis of 2 "
                         f"after {b} batch axes, got shape {tuple(x.shape)}")
    real = tuple(block.shape) == op_shape
    if not real and tuple(block.shape) != (2,) + op_shape:
        raise ValueError(f"{name}: operator shape {tuple(op.shape)}, "
                         f"expected {op_shape} or {(2,) + op_shape}"
                         f"{' per trajectory' if batched else ''}")
    if not real and not planar:
        raise ValueError(f"{name}: a complex operator needs a planar state")
    return real


@functools.lru_cache(maxsize=None)
def _view(kind: str, shape: tuple[int, ...], geom, planar: bool,
          real: bool, itemsize: int) -> tuple[Geometry, tuple[bool, int]]:
    """Geometry and copy plan of a launch, cached: an executor repeats a
    few shapes, and at n=16 a launch's host work is most of its time."""
    g = (dense_geometry(shape, geom, planar, real) if kind == "dense"
         else cross_geometry(shape, *geom, planar, real))
    return g, copy_plan(g, itemsize)


def _launch(fn_name: str, x: torch.Tensor, op: torch.Tensor, K: int,
            real: bool, view: tuple[Geometry, tuple[bool, int]],
            batched: bool) -> bool:
    """Launch a kernel over ``x`` in place on the current stream, with a
    launch record while the recorder is on (``utils/profiling.py``). A
    batch of B trajectories: trajectory b's state starts ``b *
    x[0].numel()`` elements in and its operator ``b * op.stride(0)``
    elements in. Returns whether the cluster kernel served it."""
    g, (rows, vec) = view
    n_batch, xb, wb = ((x.shape[0], x[0].numel(), op.stride(0)) if batched
                       else (1, 0, 0))
    cluster = fn_name == "qs_cross_bit_axis" and takes_cluster(K, real, wb,
                                                               vec)
    profiling.launch(fn_name.removeprefix("qs_"), x, op, K, not real,
                     batched, "cluster" if cluster else "tile")
    chunk = x.element_size() * vec
    if x.data_ptr() % chunk or op.data_ptr() % 16:
        raise ValueError(f"{fn_name}: state or operator not aligned for "
                         f"{chunk}-byte copies")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(_build.library(), fn_name)(
            x.data_ptr(), op.data_ptr(), K, int(not real), int(rows), vec,
            g.n_outer, g.so, g.n_mid, g.sm, g.n_inner, g.S, g.op_stride,
            g.bit_stride, g.plane_stride, n_batch, xb, wb, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: launch failed with CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    return cluster


def _dense_launch(name: str, x: torch.Tensor, op: torch.Tensor, axis: int,
                  planar: bool, batched: bool) -> None:
    shape = _layout_shape(x, planar, batched)
    S = shape[axis]
    real = _check(x, op, (S, S), planar, batched, name)
    _launch(f"qs_{name}", x, op, S, real,
            _view("dense", shape, axis, planar, real, x.element_size()),
            batched)


def _cross_launch(name: str, x: torch.Tensor, cop: torch.Tensor,
                  slice_axis: int, slice_pos: int, op_axis: int,
                  planar: bool, batched: bool) -> bool:
    shape = _layout_shape(x, planar, batched)
    S = shape[op_axis]
    if slice_axis == op_axis or not 0 <= slice_pos < \
            shape[slice_axis].bit_length() - 1:
        raise ValueError(f"{name}: bad geometry ({slice_axis}, "
                         f"{slice_pos}, {op_axis}) for shape {shape}")
    real = _check(x, cop, (2, S, 2, S), planar, batched, name)
    return _launch(f"qs_{name}", x, cop, 2 * S, real,
                   _view("cross", shape, (slice_axis, slice_pos, op_axis),
                         planar, real, x.element_size()), batched)


def dense_axis(x: torch.Tensor, op: torch.Tensor, axis: int,
               planar: bool, batched: bool = False) -> torch.Tensor:
    """AxisMatmulStep: the ``dense_axis`` kernel on a CUDA tensor (in
    place: returns ``x``), the plain twin on a CPU one (a new tensor).
    ``batched``: ``x`` is ``(B, [2,] ...)`` and ``op`` ``(B, [2,] S, S)``,
    one operator per trajectory (stride 0 shares one), in one launch. A
    float64 CUDA state goes to ``dense_axis_f64``."""
    if x.device.type == "cpu":
        return dense_axis_plain(x, op, axis, planar, batched)
    if x.dtype == torch.float64:
        return dense_axis_f64(x, op, axis, planar, batched)
    _dense_launch("dense_axis", x, op, axis, planar, batched)
    dense_axis.launches += 1
    return x


def dense_axis_f64(x: torch.Tensor, op: torch.Tensor, axis: int,
                   planar: bool, batched: bool = False) -> torch.Tensor:
    """``dense_axis`` on a float64 state and operator: the float64 kernel
    on a CUDA tensor (in place), the plain twin on a CPU one."""
    if x.device.type == "cpu":
        return dense_axis_plain(x, op, axis, planar, batched)
    _dense_launch("dense_axis_f64", x, op, axis, planar, batched)
    dense_axis_f64.launches += 1
    return x


def cross_bit_axis(x: torch.Tensor, cop: torch.Tensor, slice_axis: int,
                   slice_pos: int, op_axis: int, planar: bool,
                   batched: bool = False) -> torch.Tensor:
    """CrossStep: the ``cross_bit_axis`` kernel on a CUDA tensor (in
    place: returns ``x``), the plain twin on a CPU one (a new tensor);
    ``batched`` as for ``dense_axis``. A float64 CUDA state goes to
    ``cross_bit_axis_f64``."""
    if x.device.type == "cpu":
        return cross_bit_axis_plain(x, cop, slice_axis, slice_pos, op_axis,
                                    planar, batched)
    if x.dtype == torch.float64:
        return cross_bit_axis_f64(x, cop, slice_axis, slice_pos, op_axis,
                                  planar, batched)
    if _cross_launch("cross_bit_axis", x, cop, slice_axis, slice_pos,
                     op_axis, planar, batched):
        cross_bit_axis.cluster_launches += 1
    cross_bit_axis.launches += 1
    return x


def cross_bit_axis_f64(x: torch.Tensor, cop: torch.Tensor, slice_axis: int,
                       slice_pos: int, op_axis: int, planar: bool,
                       batched: bool = False) -> torch.Tensor:
    """``cross_bit_axis`` on a float64 state and operator: the float64
    kernel on a CUDA tensor (in place), the plain twin on a CPU one."""
    if x.device.type == "cpu":
        return cross_bit_axis_plain(x, cop, slice_axis, slice_pos, op_axis,
                                    planar, batched)
    _cross_launch("cross_bit_axis_f64", x, cop, slice_axis, slice_pos,
                  op_axis, planar, batched)
    cross_bit_axis_f64.launches += 1
    return x


class DiagGeometry(NamedTuple):
    """Amplitude ``i`` of a plane (``n_plane`` of them) reads table entry
    ``((i >> shift_a) & (size_a - 1)) * size_b + ((i >> shift_b) &
    (size_b - 1))``: the shifts are log2 of the elements after each axis."""

    n_plane: int
    shift_a: int
    size_a: int
    shift_b: int
    size_b: int


def diag_geometry(shape: tuple[int, ...], axis_a: int,
                  axis_b: int) -> DiagGeometry:
    if axis_a == axis_b or not (0 <= axis_a < len(shape)
                                and 0 <= axis_b < len(shape)):
        raise ValueError(f"diag_pair: bad axes ({axis_a}, {axis_b}) for "
                         f"shape {shape}")
    if any(s < 1 or s & (s - 1) for s in shape):
        raise ValueError(f"diag_pair: shape {shape} has an axis that is "
                         "not a power of two")

    def shift(axis: int) -> int:
        return _prod(shape[axis + 1:]).bit_length() - 1
    return DiagGeometry(_prod(shape), shift(axis_a), shape[axis_a],
                        shift(axis_b), shape[axis_b])


def diag_packs(g: DiagGeometry, inner: int, itemsize: int, x_ptr: int,
               d_ptr: int, d_batch_stride: int) -> bool:
    """Whether the kernel moves 16-byte packs: the innermost axis
    (``inner`` elements) holds whole packs and the state is aligned; where
    ``axis_b`` is innermost, the table's packs are aligned too. Else one
    amplitude a thread."""
    return (x_ptr % 16 == 0 and inner * itemsize % 16 == 0
            and (g.shift_b != 0 or (d_ptr % 16 == 0
                                    and d_batch_stride * itemsize % 16 == 0)))


def diag_pair(x: torch.Tensor, d: torch.Tensor, axis_a: int, axis_b: int,
              planar: bool, batched: bool = False) -> torch.Tensor:
    """DiagPairStep: the ``diag_pair`` kernel on a CUDA tensor (in place,
    one launch over the whole state: returns ``x``), the plain twin on a
    CPU one (a new tensor). ``d``: a real ``([T,] S_a, S_b)`` or complex
    ``([T,] 2, S_a, S_b)`` table, one per trajectory or one shared with
    stride 0. float32 or float64, state and table alike. Not a fiber
    kernel: no ``_launch``, no launch record."""
    if x.device.type == "cpu":
        return diag_pair_plain(x, d, axis_a, axis_b, planar, batched)
    if x.device.type != "cuda":
        raise ValueError(f"diag_pair: state on {x.device}, expected CUDA "
                         "or CPU")
    if x.dtype not in (torch.float32, torch.float64) or d.dtype != x.dtype:
        raise TypeError(f"diag_pair: needs a float32 or float64 state and "
                        f"table of one dtype, got {x.dtype} / {d.dtype}")
    if d.device != x.device:
        raise ValueError(f"diag_pair: table on {d.device}, state on "
                         f"{x.device}")
    b = int(batched)
    shape = _layout_shape(x, planar, batched)
    g = diag_geometry(shape, axis_a, axis_b)
    block = d[0] if batched else d
    if not x.is_contiguous() or not block.is_contiguous():
        raise ValueError("diag_pair: state and table must be contiguous")
    if batched and d.shape[0] != x.shape[0]:
        raise ValueError(f"diag_pair: batched table of shape "
                         f"{tuple(d.shape)} for {x.shape[0]} trajectories")
    if planar and x.shape[b] != 2:
        raise ValueError(f"diag_pair: planar state needs a plane axis of 2 "
                         f"after {b} batch axes, got shape {tuple(x.shape)}")
    table = (g.size_a, g.size_b)
    real = tuple(block.shape) == table
    if not real and tuple(block.shape) != (2,) + table:
        raise ValueError(f"diag_pair: table shape {tuple(d.shape)}, "
                         f"expected {table} or {(2,) + table}"
                         f"{' per trajectory' if batched else ''}")
    if not real and not planar:
        raise ValueError("diag_pair: a complex table needs a planar state")
    n_batch, xb, db = ((x.shape[0], x[0].numel(), d.stride(0)) if batched
                       else (1, 0, 0))
    vec = diag_packs(g, shape[-1], x.element_size(), x.data_ptr(),
                     d.data_ptr(), db)
    form = 2 if not planar else (1 if real else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.library().qs_diag_pair(
            x.data_ptr(), d.data_ptr(), int(x.dtype == torch.float64), form,
            int(vec), *g, n_batch, xb, db, stream)
    if rc != 0:
        raise RuntimeError(f"qs_diag_pair: launch failed with CUDA error "
                           f"{rc} ({_build.error_string(rc)})")
    diag_pair.launches += 1
    return x


# The geometry ``qs_swap_bits`` takes (``csrc/swap_bits.cu``): its limits
# and the number of words it is packed into.
SWAP_MAX_ROW_BITS = 6
SWAP_MAX_PAIRS = 16
SWAP_MAX_FIXED = 31
SWAP_MAX_TILE_BITS = 12
SWAP_GEOM_WORDS = (7 + 2 * SWAP_MAX_PAIRS + SWAP_MAX_FIXED
                   + SWAP_MAX_ROW_BITS + SWAP_MAX_TILE_BITS)
# The kernel's mode flags: tiles exchanged as they are (else their bits
# permuted through shared memory); 16-byte packs (else one element).
SWAP_EXCHANGE, SWAP_PACKS = 1, 2


class SwapGeometry(NamedTuple):
    """A run of disjoint bit swaps as the ``swap_bits`` kernel walks it.

    A tile is ``2^row_bits`` rows of ``2^col_bits`` columns: the columns
    are the lowest data bits (256 bytes), row bit j is data bit
    ``row_pos[j]``; tile element e takes the value of the partner's
    element whose bit i is bit ``perm[i]`` of e. The other data bits are
    ``pairs`` (K of them, both bits outside the tiles) and ``fixed``
    bits. A plane holds ``2^unit_shift`` units of work, two tiles each:
    unit bits ``[0, K - 1)`` are the pairs' low bits but one, the next K
    say which pairs differ (d), the rest are the fixed bits. With d != 0
    the unit is a tile and its partner (the lowest differing pair's low
    bit 0 in the first), with d = 0 two tiles pi leaves in place (the top
    pair's bits 00 and 11); with no pair, one tile."""

    n_units: int
    plane: int
    unit_shift: int
    col_bits: int
    row_bits: int
    pairs: tuple[tuple[int, int], ...]
    fixed: tuple[int, ...]
    row_pos: tuple[int, ...]
    perm: tuple[int, ...]


def swap_geometry(n_bits: int, n_outer: int, pairs,
                  itemsize: int) -> SwapGeometry:
    """The tiles of ``n_outer`` planes of ``2^n_bits`` elements of
    ``itemsize`` bytes: the row bits are the partners of the swapped
    column bits, then the lowest bits that no pair moves, up to 64 rows."""
    pairs = swap_pairs(pairs, n_bits)
    if n_bits > 32:
        raise ValueError(f"swap_bits: {n_bits} bits, at most 32 a plane")
    c = min((256 // itemsize).bit_length() - 1, n_bits)
    partner = {}
    for lo, hi in pairs:
        partner[lo], partner[hi] = hi, lo
    rows = [partner[b] for b in range(c) if partner.get(b, 0) >= c]
    fixed = [b for b in range(c, n_bits) if b not in partner]
    rows = sorted(rows + fixed[:SWAP_MAX_ROW_BITS - len(rows)])
    outside = tuple(sorted(pr for pr in pairs
                           if pr[0] >= c and pr[0] not in rows))
    fixed = tuple(b for b in fixed if b not in rows)
    pos = list(range(c)) + rows
    index = {p: i for i, p in enumerate(pos)}
    perm = tuple(index[partner.get(p, p)] for p in pos)
    shift = 2 * len(outside) + len(fixed) - (len(outside) > 0)
    return SwapGeometry(n_outer << shift, 1 << n_bits, shift, c, len(rows),
                        outside, fixed, tuple(rows), perm)


def swap_mode(g: SwapGeometry, itemsize: int, x_ptr: int) -> int:
    """``SWAP_EXCHANGE`` where no pair has a bit in the tiles (their bits
    stay put), plus ``SWAP_PACKS`` where a row holds whole 16-byte packs
    and the state is aligned."""
    mode = 0 if any(p != i for i, p in enumerate(g.perm)) else SWAP_EXCHANGE
    if x_ptr % 16 == 0 and (itemsize << g.col_bits) % 16 == 0:
        mode |= SWAP_PACKS
    return mode


def swap_words(g: SwapGeometry) -> list[int]:
    """``g`` packed as ``qs_swap_bits`` reads it, arrays padded."""
    def pad(vals, size):
        return list(vals) + [0] * (size - len(vals))
    lo, hi = (list(b) for b in zip(*g.pairs)) if g.pairs else ([], [])
    words = ([g.n_units, g.plane, g.unit_shift, g.col_bits, g.row_bits,
              len(g.pairs), len(g.fixed)]
             + pad(lo, SWAP_MAX_PAIRS) + pad(hi, SWAP_MAX_PAIRS)
             + pad(g.fixed, SWAP_MAX_FIXED) + pad(g.row_pos, SWAP_MAX_ROW_BITS)
             + pad(g.perm, SWAP_MAX_TILE_BITS))
    assert len(words) == SWAP_GEOM_WORDS
    return words


def swap_bits(x: torch.Tensor, pairs, planar: bool,
              batched: bool = False) -> torch.Tensor:
    """A run of SWAP gates on disjoint qubit pairs: ``x[i] <- x[pi(i)]``,
    pi exchanging the data-index bits of each of ``pairs``. The
    ``swap_bits`` kernel on a CUDA tensor (in place, one launch over the
    whole state: returns ``x``), the plain twin on a CPU one (a new
    tensor). float32 or float64, planar or real, batched or not. Not a
    fiber kernel: no ``_launch``, no launch record. ``launches`` counts
    launches, ``swaps`` the pairs they served."""
    if x.device.type == "cpu":
        return swap_bits_plain(x, pairs, planar, batched)
    if x.device.type != "cuda":
        raise ValueError(f"swap_bits: state on {x.device}, expected CUDA "
                         "or CPU")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"swap_bits: needs a float32 or float64 state, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("swap_bits: the state must be contiguous")
    b = int(batched)
    if planar and x.shape[b] != 2:
        raise ValueError(f"swap_bits: planar state needs a plane axis of 2 "
                         f"after {b} batch axes, got shape {tuple(x.shape)}")
    shape = _layout_shape(x, planar, batched)
    if any(s < 1 or s & (s - 1) for s in shape):
        raise ValueError(f"swap_bits: shape {shape} has an axis that is not "
                         "a power of two")
    n = _prod(shape).bit_length() - 1
    pairs = swap_pairs(pairs, n)
    g = swap_geometry(n, x.numel() >> n, pairs, x.element_size())
    words = (ctypes.c_longlong * SWAP_GEOM_WORDS)(*swap_words(g))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.library().qs_swap_bits(
            x.data_ptr(), int(x.dtype == torch.float64),
            swap_mode(g, x.element_size(), x.data_ptr()), words,
            SWAP_GEOM_WORDS, stream)
    if rc != 0:
        raise RuntimeError(f"qs_swap_bits: launch failed with CUDA error "
                           f"{rc} ({_build.error_string(rc)})")
    swap_bits.launches += 1
    swap_bits.swaps += len(pairs)
    return x


dense_axis.launches = 0
cross_bit_axis.launches = 0
cross_bit_axis.cluster_launches = 0   # of them, on the cluster kernel
dense_axis_f64.launches = 0
cross_bit_axis_f64.launches = 0
diag_pair.launches = 0        # float32 and float64 alike
swap_bits.launches = 0        # float32 and float64 alike
swap_bits.swaps = 0           # the pairs (swap steps) its launches served

# The float32 kernels (the default engine) and the float64 ones
# (``config.enable_complex128``).
KERNELS = (dense_axis, cross_bit_axis)
KERNELS_F64 = (dense_axis_f64, cross_bit_axis_f64)


def reset_launch_counts() -> None:
    for k in KERNELS + KERNELS_F64 + (diag_pair, swap_bits):
        k.launches = 0
    cross_bit_axis.cluster_launches = 0
    swap_bits.swaps = 0
