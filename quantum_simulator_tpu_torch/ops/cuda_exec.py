"""Hand-written CUDA kernels for the dense and cross group-plan steps.

Counterpart of ``quantum_simulator_tpu/ops/pallas_exec.py``. Two kernels
carry every FLOP of the main path:

* ``dense_axis`` replaces ``lower_dense`` (``pallas_exec.py:178-222``):
  ``x <- U x`` along one grouped axis of size S <= 128;
* ``cross_bit_axis`` replaces ``lower_cross`` (``pallas_exec.py:229-338``):
  ``y[i,.,a,.] = sum_k sum_b C[i,a,k,b] x[k,.,b,.]`` where ``i``/``k`` are
  one bit of ``slice_axis`` and ``a``/``b`` run over ``op_axis``.

Both are one CUDA template (``csrc/fiber_matmul.cuh``): the state is a
set of "fibers", each a K-long column of rows whose offsets are
``(r // S) * bit_stride + (r % S) * op_stride``; one block owns each tile
of fibers, multiplies the operator into it (3xTF32 on the tensor cores
for K >= ``MMA_MIN_K``, fp32 FMA below) and writes the result over it.
The wrappers below reduce the state to that strided view
(``dense_geometry``, ``cross_geometry``), choose how a tile is copied
(``copy_plan``), check what the kernel takes and raise on anything else.
Every geometry the planner emits is covered, including a sliced bit
inside the last axis, which Pallas declines.

Each wrapper has a plain PyTorch twin (``*_plain``: ``torch.einsum`` on the
JAX package's ``_dense_spec`` / ``_cross_spec`` forms, in the state's
dtype). The wrapper takes the twin only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches.

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


def tile_fibers(K: int, real: bool) -> int:
    """Fibers per tile at depth K: ``SimtTile`` / ``MmaTile<K, ...>::F`` of
    ``csrc/fiber_matmul.cuh`` (``chip_smoke.py`` checks the two agree)."""
    if K < MMA_MIN_K:
        return 4096 // K
    if real:
        return {32: 128, 128: 128}.get(K, 64)
    return 64 if K == 32 else 32


# Contraction depths from this one up take the float64 kernels' DMMA path
# (``kF64MmaMinK`` in ``csrc/fiber_matmul_f64.cu``); below, FP64 FMA.
F64_MMA_MIN_K = 16


def tile_fibers_f64(K: int, real: bool) -> int:
    """Fibers per tile of the float64 kernels at depth K:
    ``F64FmaTile`` / ``F64MmaTile<K, ...>::F`` of ``csrc/fiber_matmul_f64.cu``
    (``chip_smoke.py`` checks the two agree)."""
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
            batched: bool) -> None:
    """Launch a kernel over ``x`` in place on the current stream, with a
    launch record while the recorder is on (``utils/profiling.py``). A
    batch of B trajectories: trajectory b's state starts ``b *
    x[0].numel()`` elements in and its operator ``b * op.stride(0)``
    elements in."""
    profiling.launch(fn_name.removeprefix("qs_"), x, op, K, not real,
                     batched)
    g, (rows, vec) = view
    chunk = x.element_size() * vec
    if x.data_ptr() % chunk or op.data_ptr() % 16:
        raise ValueError(f"{fn_name}: state or operator not aligned for "
                         f"{chunk}-byte copies")
    n_batch, xb, wb = ((x.shape[0], x[0].numel(), op.stride(0)) if batched
                       else (1, 0, 0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(_build.library(), fn_name)(
            x.data_ptr(), op.data_ptr(), K, int(not real), int(rows), vec,
            g.n_outer, g.so, g.n_mid, g.sm, g.n_inner, g.S, g.op_stride,
            g.bit_stride, g.plane_stride, n_batch, xb, wb, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: launch failed with CUDA error {rc} "
                           f"({_build.error_string(rc)})")


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
                  planar: bool, batched: bool) -> None:
    shape = _layout_shape(x, planar, batched)
    S = shape[op_axis]
    if slice_axis == op_axis or not 0 <= slice_pos < \
            shape[slice_axis].bit_length() - 1:
        raise ValueError(f"{name}: bad geometry ({slice_axis}, "
                         f"{slice_pos}, {op_axis}) for shape {shape}")
    real = _check(x, cop, (2, S, 2, S), planar, batched, name)
    _launch(f"qs_{name}", x, cop, 2 * S, real,
            _view("cross", shape, (slice_axis, slice_pos, op_axis), planar,
                  real, x.element_size()), batched)


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
    _cross_launch("cross_bit_axis", x, cop, slice_axis, slice_pos, op_axis,
                  planar, batched)
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


dense_axis.launches = 0
cross_bit_axis.launches = 0
dense_axis_f64.launches = 0
cross_bit_axis_f64.launches = 0

# The float32 kernels (the default engine) and the float64 ones
# (``config.enable_complex128``).
KERNELS = (dense_axis, cross_bit_axis)
KERNELS_F64 = (dense_axis_f64, cross_bit_axis_f64)


def reset_launch_counts() -> None:
    for k in KERNELS + KERNELS_F64:
        k.launches = 0
