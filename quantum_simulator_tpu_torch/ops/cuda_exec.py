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
``(r // S) * bit_stride + (r % S) * op_stride``; a block stages a slice of
the operator in shared memory and multiplies it into a tile of fibers.
The wrappers below reduce the state to that strided view
(``dense_geometry``, ``cross_geometry``), check what the kernel takes and
raise on anything else. Every geometry the planner emits is covered,
including a sliced bit inside the last axis, which Pallas declines.

Each wrapper has a plain PyTorch twin (``*_plain``: ``torch.einsum`` on the
JAX package's ``_dense_spec`` / ``_cross_spec`` forms). The wrapper takes
the twin only for a tensor on the CPU; a CUDA tensor launches the kernel
or raises. ``<wrapper>.launches`` counts kernel launches.

The JAX package gates its kernels behind ``CONFIG.pallas_steps`` and a
rank >= 5 rule tuned to XLA on the TPU; the port carries neither.
Out-of-place: each launch writes a fresh output, so a step holds two
states at its peak. Neither kernel has a backward pass (the Pallas ones
have no VJP either).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

_AXIS_LETTERS = "abefghjlmnopqrstuvwz"  # reserved: c d i k x y


# ---------------------------------------------------------------------------
# Einsum forms (``quantum_simulator_tpu/ops/plan.py:1024-1072``)
# ---------------------------------------------------------------------------

def _dense_spec(rank: int, axis: int, op_real: bool = False,
                planar: bool = True) -> str:
    subs = list(_AXIS_LETTERS[:rank])
    out = list(subs)
    out[axis] = "y"
    if op_real and not planar:
        return f"y{subs[axis]},{''.join(subs)}->{''.join(out)}"
    if op_real:
        return f"y{subs[axis]},d{''.join(subs)}->d{''.join(out)}"
    return f"cdy{subs[axis]},d{''.join(subs)}->c{''.join(out)}"


def _cross_spec(rank_new: int, bit_axis: int, op_axis_new: int,
                op_real: bool = False, planar: bool = True) -> str:
    subs = list(_AXIS_LETTERS[:rank_new])
    subs[bit_axis] = "k"
    subs[op_axis_new] = "x"
    out = list(subs)
    out[bit_axis] = "i"
    out[op_axis_new] = "y"
    if op_real and not planar:
        return f"iykx,{''.join(subs)}->{''.join(out)}"
    if op_real:
        return f"iykx,d{''.join(subs)}->d{''.join(out)}"
    return f"cdiykx,d{''.join(subs)}->c{''.join(out)}"


def _split_axis_bit(shape: tuple[int, ...], axis: int, pos: int):
    """New shape exposing bit ``pos`` (MSB-first) of ``axis`` as its own
    dimension; returns (new_shape, bit_axis_index)."""
    bits = shape[axis].bit_length() - 1
    pre = 1 << pos
    post = 1 << (bits - pos - 1)
    return shape[:axis] + (pre, 2, post) + shape[axis + 1:], axis + 1


def _blocked(planes: torch.Tensor) -> torch.Tensor:
    """(2, ...) (re, im) planes -> the blocked ``[[re, -im], [im, re]]``
    (2, 2, ...) operator the einsum forms contract against."""
    re, im = planes[0], planes[1]
    return torch.stack([torch.stack([re, -im]), torch.stack([im, re])])


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _layout_shape(x: torch.Tensor, planar: bool) -> tuple[int, ...]:
    return tuple(x.shape[1:] if planar else x.shape)


def dense_axis_plain(x: torch.Tensor, op: torch.Tensor, axis: int,
                     planar: bool) -> torch.Tensor:
    """``U x`` along ``axis``: ``op`` is a real (S, S) or complex
    (2, S, S) (re, im) operator; ``x`` real or planar ``(2, ...)``."""
    real = op.ndim == 2
    if not real and not planar:
        raise ValueError("a complex operator needs a planar state")
    rank = len(_layout_shape(x, planar))
    return torch.einsum(_dense_spec(rank, axis, real, planar),
                        op if real else _blocked(op), x)


def cross_bit_axis_plain(x: torch.Tensor, cop: torch.Tensor,
                         slice_axis: int, slice_pos: int, op_axis: int,
                         planar: bool) -> torch.Tensor:
    """Cross step: ``cop`` is a real (2, S, 2, S) or complex
    (2, 2, S, 2, S) operator indexed (i, y, k, x)."""
    real = cop.ndim == 4
    if not real and not planar:
        raise ValueError("a complex operator needs a planar state")
    shape = _layout_shape(x, planar)
    new_shape, bit_axis = _split_axis_bit(shape, slice_axis, slice_pos)
    o = op_axis + (2 if op_axis > slice_axis else 0)
    lead = (2,) if planar else ()
    xr = x.reshape(lead + new_shape)
    out = torch.einsum(_cross_spec(len(new_shape), bit_axis, o, real, planar),
                       cop if real else _blocked(cop), xr)
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, op: torch.Tensor, op_shape: tuple[int, ...],
           planar: bool, name: str) -> bool:
    """Validate a CUDA launch; returns True for a real operator."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: state on {x.device}, expected CUDA or CPU")
    if op.device != x.device:
        raise ValueError(f"{name}: operator on {op.device}, state on "
                         f"{x.device}")
    if x.dtype != torch.float32 or op.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype} / {op.dtype}")
    if not x.is_contiguous() or not op.is_contiguous():
        raise ValueError(f"{name}: state and operator must be contiguous")
    if planar and x.shape[0] != 2:
        raise ValueError(f"{name}: planar state needs a leading plane "
                         f"axis of 2, got shape {tuple(x.shape)}")
    real = tuple(op.shape) == op_shape
    if not real and tuple(op.shape) != (2,) + op_shape:
        raise ValueError(f"{name}: operator shape {tuple(op.shape)}, "
                         f"expected {op_shape} or {(2,) + op_shape}")
    if not real and not planar:
        raise ValueError(f"{name}: a complex operator needs a planar state")
    return real


def _launch(fn_name: str, x: torch.Tensor, op: torch.Tensor, K: int,
            real: bool, g: Geometry) -> torch.Tensor:
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(_build.library(), fn_name)(
            x.data_ptr(), y.data_ptr(), op.data_ptr(), K, int(not real),
            g.n_outer, g.so, g.n_mid, g.sm, g.n_inner, g.S, g.op_stride,
            g.bit_stride, g.plane_stride, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: launch failed with CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    return y


def dense_axis(x: torch.Tensor, op: torch.Tensor, axis: int,
               planar: bool) -> torch.Tensor:
    """AxisMatmulStep: the ``dense_axis`` kernel on a CUDA tensor, the
    plain twin on a CPU one. Returns a new tensor."""
    if x.device.type == "cpu":
        return dense_axis_plain(x, op, axis, planar)
    shape = _layout_shape(x, planar)
    S = shape[axis]
    real = _check(x, op, (S, S), planar, "dense_axis")
    y = _launch("qs_dense_axis", x, op, S, real,
                dense_geometry(shape, axis, planar, real))
    dense_axis.launches += 1
    return y


def cross_bit_axis(x: torch.Tensor, cop: torch.Tensor, slice_axis: int,
                   slice_pos: int, op_axis: int,
                   planar: bool) -> torch.Tensor:
    """CrossStep: the ``cross_bit_axis`` kernel on a CUDA tensor, the
    plain twin on a CPU one. Returns a new tensor."""
    if x.device.type == "cpu":
        return cross_bit_axis_plain(x, cop, slice_axis, slice_pos, op_axis,
                                    planar)
    shape = _layout_shape(x, planar)
    S = shape[op_axis]
    if slice_axis == op_axis or not 0 <= slice_pos < \
            shape[slice_axis].bit_length() - 1:
        raise ValueError(f"cross_bit_axis: bad geometry ({slice_axis}, "
                         f"{slice_pos}, {op_axis}) for shape {shape}")
    real = _check(x, cop, (2, S, 2, S), planar, "cross_bit_axis")
    y = _launch("qs_cross_bit_axis", x, cop, 2 * S, real,
                cross_geometry(shape, slice_axis, slice_pos, op_axis, planar,
                               real))
    cross_bit_axis.launches += 1
    return y


dense_axis.launches = 0
cross_bit_axis.launches = 0

KERNELS = (dense_axis, cross_bit_axis)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
