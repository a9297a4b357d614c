"""Distributed statevector engine: a shard mesh on PyTorch.

Counterpart of ``quantum_simulator_tpu/parallel/distributed.py``. The
amplitude vector of an n-qubit state is split across D = 2^g shards:
basis index = [g shard bits | n - g local bits], qubit 0 the most
significant bit, so qubit q < g lives in the shard index and qubit
q >= g in the local block.

**The mesh** (``ShardMesh``). JAX's model is a process owning devices
with one shard on each. The port's is PyTorch's: W ranks (a
``torch.distributed`` group, or W = 1 without one), each holding L shards
stacked as one tensor on that rank's device, D = W * L a power of 2.
Shard index = ``rank * L + local`` (rank-major, as ``make_multihost_mesh``
orders devices), so the rank bits are the most significant shard bits
and a qubit on one of them travels over the slowest link. One GPU per
rank is PyTorch's idiom; several GPUs inside one process are not
supported.

**Execution** follows JAX's hand-rolled shard_map: the host builds one
static schedule (``_build_schedule``) and every rank walks it.

* A gate whose targets are all local applies to every shard at once. The
  per-gate route applies it to the ``(L, 2^(n-g))`` complex stack with
  ``ops/apply``; from ``_GROUPED_SHARD_MIN_QUBITS`` local qubits on, the
  gate runs between exchanges become mini group plans (built once per
  body) run by ``plan.execute_group_plan`` on the planar
  ``(L, 2, *axis_sizes)`` stack, so each dense and cross step is ONE
  launch of ``dense_axis`` / ``cross_bit_axis`` for all L shards with one
  operator shared with stride 0.
* A gate on a shard-index qubit first swaps it with a local position
  (``_swap_global_local``): between two shards of one rank an in-place
  swap of two quarter regions of the stack, chunk by chunk with a
  temporary of one chunk; across ranks ``dist.batch_isend_irecv`` of the
  half a shard does not keep (JAX's ``ppermute`` pairs). A layout
  tracker defers the swap back, and the layout is restored at the end.
* Product-form diagonals and 1q diagonals on shard qubits multiply each
  shard by a scalar from its shard index (an ``(L,)`` vector), with no
  exchange.

Reductions sum over the local shards, then ``dist.all_reduce``; JAX's
``all_gather`` is ``dist.all_gather``. A state stays planar
``(L, 2, 2^(n-g))`` on the device (``DistributedStateVector``): JAX's
grouped body returns ``x[0] + 1j * x[1]``, a second whole state, and only
``.data`` here builds a complex copy (on the host). The noisy body draws
``argmax(log w + g)`` over given Gumbel rows (JAX:
``jax.random.categorical`` on split keys).

The planes are float32, or float64 under ``config.enable_complex128``:
both routes, their operands and per-shard factors, the exchanges, the
checkpoints, the sampler and every reduction then follow the state's
precision (JAX's grouped body keeps float32 planes in its mode); the
Gumbel rows and the sampler's uniforms stay float32.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..circuit import GateInstance, QuantumCircuit
from ..config import CONFIG, require_width
from ..mps import gumbel_from_uniform
from ..ops import plan as gplan
from ..ops import program as prog
from ..ops.apply import apply_cphase, apply_gate, reduced_density_matrix_1q
from ..ops.bigstate import SAMPLE_BATCH
from ..simulator import TRAJECTORY_MEMORY_BYTES
from ..utils.seeding import generator_from_rng

AMP_AXIS = "amp"

# Shards at least this large run the group-matmul executor on gate runs
# between exchanges instead of per-gate einsums (JAX's threshold).
_GROUPED_SHARD_MIN_QUBITS = 14


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardMesh:
    """W ranks x L shards per rank on ``device``, named like a JAX mesh:
    ``axis_names`` and ``shape[axis]`` (``shape`` is a dict), the product
    of ``axis_sizes`` being ``n_devices`` = W * L. ``group`` is the
    process group of the ranks (None: the default group)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    local: int
    device: torch.device
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        d = self.world * self.local
        if math.prod(self.axis_sizes) != d:
            raise ValueError(f"mesh axes {self.axis_sizes} do not hold "
                             f"{self.world} ranks x {self.local} shards")
        if d < 1 or d & (d - 1):
            raise ValueError(f"n_devices must be a power of 2, got {d}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_devices(self) -> int:
        return self.world * self.local

    @property
    def first_shard(self) -> int:
        return self.rank * self.local

    def shard_ids(self) -> list[int]:
        return list(range(self.first_shard, self.first_shard + self.local))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place (a no-op for one rank)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, rank-major."""
        if self.world == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def broadcast(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0, group=self.group)
        return int(t[0])

    def exchange(self, send: torch.Tensor, partner: int) -> torch.Tensor:
        """Send ``send`` to rank ``partner`` and receive its tensor of
        the same shape (``batch_isend_irecv``: JAX's ``ppermute``)."""
        send = send.contiguous()
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, partner, self.group),
            dist.P2POp(dist.irecv, recv, partner, self.group)])
        for r in reqs:
            r.wait()
        return recv

    def map_trials(self, fn: Callable, *inputs):
        """``fn`` over this rank's contiguous block of the trials (dim 0
        of each input), the outputs gathered back to every trial on
        every rank. Trials are independent, so the result equals
        ``fn(*inputs)``; with one rank it is that call."""
        if self.world == 1:
            return fn(*inputs)
        n = inputs[0].shape[0]
        per = -(-n // self.world)
        lo = min(n, self.rank * per)
        out = fn(*(a[lo:lo + per] for a in inputs))
        single = not isinstance(out, tuple)
        gathered = []
        for o in ((out,) if single else out):
            host = isinstance(o, np.ndarray)
            t = torch.as_tensor(o).to(self.device)
            pad = torch.zeros((per - t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=self.device)
            full = self.all_gather(torch.cat([t, pad]))[:n]
            gathered.append(full.cpu().numpy() if host
                            else full.to(torch.as_tensor(o).device))
        return gathered[0] if single else tuple(gathered)


def check_mesh(mesh) -> ShardMesh:
    if not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh= takes a parallel.ShardMesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def mesh_device(device=None, rank: int = 0) -> torch.device:
    """The device a rank's shards live on: ``device`` (default
    ``CONFIG.device``); a bare ``"cuda"`` is GPU ``rank`` modulo the
    process's GPUs. Without a CUDA device a CUDA mesh raises: there is no
    silent CPU path."""
    dev = torch.device(device or CONFIG.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device "
                               "(torch.cuda.is_available() is false); "
                               "pass device='cpu' for a CPU mesh")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, axis_name: str = AMP_AXIS,
              device=None) -> ShardMesh:
    """1-D mesh of ``n_devices`` shards (a power of 2; default 1) stacked
    in this one process on ``device`` (default ``CONFIG.device``)."""
    n = 1 if n_devices is None else int(n_devices)
    return ShardMesh((axis_name,), (n,), n, mesh_device(device))


def _log2(mesh: ShardMesh) -> int:
    return mesh.n_devices.bit_length() - 1


# ---------------------------------------------------------------------------
# The schedule (host bookkeeping, as in the JAX package)
# ---------------------------------------------------------------------------

class _Layout:
    """Tracks the logical-qubit -> physical-position permutation while
    the schedule is built."""

    def __init__(self, n: int):
        self.pos_of = list(range(n))   # logical qubit -> physical position
        self.qubit_at = list(range(n))  # physical position -> logical qubit

    def swap_positions(self, p1: int, p2: int):
        q1, q2 = self.qubit_at[p1], self.qubit_at[p2]
        self.qubit_at[p1], self.qubit_at[p2] = q2, q1
        self.pos_of[q1], self.pos_of[q2] = p2, p1


_SWAP_MAT = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


def _is_noswap_diag(op: prog.ProgramOp) -> bool:
    """Product-form diagonals (MCZ_k any width, CZ, CPhase): on a shard
    qubit a per-shard scalar, so never a swap, even wider than a shard."""
    return (op.gate_name == "CPhase"
            or gplan._diag_product_value(op) is not None)


def _is_noswap_1q_diag(op: prog.ProgramOp) -> bool:
    """1-target diagonals (Rz / Phase / Z / S / T ...): on a shard qubit
    one per-shard scalar."""
    return len(op.targets) == 1 and gplan._op_is_diagonal(op)


def _build_schedule(program: prog.CircuitProgram, g: int,
                    noswap: set[int] = frozenset()) -> list[tuple]:
    """The layout-tracked item list of ``distributed.py:160-252``:

      ("swap", g_pos, l_pos)    exchange shard-index bit with local bit
      ("gate", op_i, local_ts)  apply program op at these local positions
      ("cphase", op_i, local_ts, global_ts)  product-form diagonal with
                                shard targets (ops in ``noswap``)
      ("gdiag1", op_i, g_pos)   1q diagonal on a shard qubit
      ("lswap", la, lb)         in-shard SWAP (restore phase only)

    ending with the restore sequence back to the identity layout."""
    n = program.num_qubits
    n_local = n - g
    max_arity = max((len(op.targets)
                     for oi, op in enumerate(program.ops)
                     if oi not in noswap), default=0)
    if max_arity > n_local:
        raise ValueError(
            f"a {max_arity}-qubit gate needs at least {max_arity} local "
            f"qubits per shard; n={n} over 2^{g} devices leaves only "
            f"{n_local} — use a smaller mesh")
    layout = _Layout(n)
    items: list[tuple] = []

    for oi, op in enumerate(program.ops):
        positions = [layout.pos_of[q] for q in op.targets]
        if oi in noswap and any(p < g for p in positions):
            if _is_noswap_diag(op):
                items.append(("cphase", oi,
                              tuple(sorted(p - g
                                           for p in positions if p >= g)),
                              tuple(sorted(p
                                           for p in positions if p < g))))
            else:
                items.append(("gdiag1", oi, positions[0]))
            continue
        for i, p in enumerate(positions):
            if p < g:
                taken = set(layout.pos_of[q] for q in op.targets)
                scratch = next(sp for sp in range(n - 1, g - 1, -1)
                               if sp not in taken)
                items.append(("swap", p, scratch))
                layout.swap_positions(p, scratch)
                positions[i] = scratch
        items.append(("gate", oi, tuple(p - g for p in positions)))

    for p_target in range(g):
        if layout.qubit_at[p_target] == p_target:
            continue
        s = layout.pos_of[p_target]
        if s >= g:
            items.append(("swap", p_target, s))
            layout.swap_positions(p_target, s)
        else:
            taken = {s, p_target}
            scratch = next(sp for sp in range(n - 1, g - 1, -1)
                           if sp not in taken)
            items.append(("swap", s, scratch))
            layout.swap_positions(s, scratch)
            items.append(("swap", p_target, scratch))
            layout.swap_positions(p_target, scratch)
    for p_target in range(g, n):
        while layout.qubit_at[p_target] != p_target:
            s = layout.pos_of[p_target]
            items.append(("lswap", p_target - g, s - g))
            layout.swap_positions(p_target, s)
    return items


def ideal_noswap(program: prog.CircuitProgram) -> set[int]:
    return {oi for oi, op in enumerate(program.ops)
            if _is_noswap_diag(op) or _is_noswap_1q_diag(op)}


def noisy_noswap(program: prog.CircuitProgram, noise_model) -> set[int]:
    """No-swap diagonals only for ops without channels: a Kraus draw
    needs its target local (``distributed.py:513-520``)."""
    return {oi for oi in ideal_noswap(program)
            if not noise_model.kraus_stacks_for_gate(
                program.ops[oi].gate_name)}


# ---------------------------------------------------------------------------
# Shard-local primitives
# ---------------------------------------------------------------------------

def _float_view(x: torch.Tensor) -> torch.Tensor:
    """A stack as real ``(R, L, C, N')``: planar ``(R, L, 2, N)`` as it
    is, complex ``(R, L, N)`` as ``(R, L, 1, 2N)`` (re, im interleaved,
    so every bit of the basis index keeps its place)."""
    if x.is_complex():
        return torch.view_as_real(x).reshape(x.shape[:2] + (1, -1))
    return x


def _swap_chunks(a: torch.Tensor, b: torch.Tensor) -> None:
    """Swap two equally shaped views in place, one chunk at a time."""
    dim = max(range(a.ndim), key=lambda d: a.shape[d])
    for start, width in gplan.chunk_ranges(a.shape[dim], a.numel()):
        va, vb = a.narrow(dim, start, width), b.narrow(dim, start, width)
        tmp = va.clone()
        va.copy_(vb)
        vb.copy_(tmp)


def _swap_global_local(x: torch.Tensor, g_pos: int, l_pos: int, g: int,
                       mesh: ShardMesh) -> None:
    """Exchange shard-index bit ``g_pos`` with physical position
    ``l_pos`` (>= g) in place: new(gbit = m, lbit = b) = old(gbit = b,
    lbit = m). A shard keeps the half whose local bit equals its own
    shard bit and trades the other half with the shard across bit
    ``g_pos`` (``distributed.py:79-106``). ``x`` is a contiguous
    ``(R, L, 2, N)`` planar or ``(R, L, N)`` complex stack."""
    bit_shift = g - 1 - g_pos
    mask = 1 << bit_shift
    v = _float_view(x)
    R, L, C = v.shape[:3]
    a = 1 << (l_pos - g)
    v = v.reshape(R, L, C, a, 2, -1)
    if mask < L:
        # both shards of every pair on this rank: shard bit 0's lbit-1
        # quarter <-> shard bit 1's lbit-0 quarter
        v8 = v.reshape(R, L // (2 * mask), 2, mask, C, a, 2, v.shape[-1])
        _swap_chunks(v8[:, :, 0, :, :, :, 1], v8[:, :, 1, :, :, :, 0])
        return
    my_bit = (mesh.first_shard >> bit_shift) & 1
    partner = mesh.rank ^ (mask // L)
    slot = v[:, :, :, :, 1 - my_bit]
    dim = max(range(slot.ndim), key=lambda d: slot.shape[d])
    for start, width in gplan.chunk_ranges(slot.shape[dim], slot.numel()):
        part = slot.narrow(dim, start, width)
        part.copy_(mesh.exchange(part, partner))


def swap_global_local_plain(x: torch.Tensor, g_pos: int, l_pos: int,
                            g: int) -> torch.Tensor:
    """The plain twin of ``_swap_global_local`` for a one-rank stack: the
    exchange is a transpose of the shard bit with the local bit, out of
    place (the reference the in-place chunked swap is checked against)."""
    v = _float_view(x)
    R, L, C = v.shape[:3]
    mask = 1 << (g - 1 - g_pos)
    v = v.reshape(R, L // (2 * mask), 2, mask, C, 1 << (l_pos - g), 2, -1)
    out = v.transpose(2, 6).reshape(R, L, C, -1)
    if x.is_complex():
        return torch.view_as_complex(out.reshape(R, L, -1, 2).contiguous())
    return out.reshape(x.shape)


def _scale_chunks(x: torch.Tensor, factor: Callable) -> None:
    """``x *= factor(start, width)`` in place along the last axis, chunk
    by chunk: ``x`` a planar ``(R, L, 2, N)`` or complex ``(R, L, N)``
    stack, ``factor`` a complex tensor broadcastable to
    ``(R, L, width)``."""
    N = x.shape[-1]
    for start, width in gplan.chunk_ranges(N, x.numel()):
        f = factor(start, width)
        if x.is_complex():
            x[..., start:start + width].mul_(f)
            continue
        xr = x[:, :, 0, start:start + width]
        xi = x[:, :, 1, start:start + width]
        fr, fi = f.real, f.imag
        re = fr * xr - fi * xi
        xi.copy_(fi * xr + fr * xi)
        xr.copy_(re)


def _bits_of(ids: torch.Tensor, pos: int, width: int) -> torch.Tensor:
    """Bit ``pos`` (MSB-first of ``width`` bits) of each index."""
    return (ids >> (width - 1 - pos)) & 1


def _row_params(params, device) -> torch.Tensor:
    """Parameters as an ``(R, P)`` tensor of rows (R = 1 for one vector),
    ``CONFIG.real_dtype`` unless given as a tensor."""
    p = prog.param_tensor(params, device).to(device)
    return p if p.ndim == 2 else p[None]


def _op_value(op: prog.ProgramOp, rows: torch.Tensor):
    """The product-form diagonal's phase v: a constant, or for CPhase
    ``e^{i phi}`` per row, shaped ``(R, 1, 1)``."""
    if op.gate_name == "CPhase" and op.num_params > 0:
        return torch.polar(torch.ones_like(rows[:, op.param_offset]),
                           rows[:, op.param_offset])[:, None, None]
    return complex(gplan._diag_product_value(op))


def _diag1_values(op: prog.ProgramOp, rows: torch.Tensor):
    """(d0, d1) of a 1q diagonal: constants, or ``(R, 1)`` per row for
    Rz / Phase (``distributed.py:136-148``)."""
    if op.static_matrix is not None:
        d = np.diagonal(op.static_matrix)
        return complex(d[0]), complex(d[1])
    theta = rows[:, op.param_offset][:, None]
    one = torch.ones_like(theta)
    if op.gate_name == "Rz":
        return torch.polar(one, -0.5 * theta), torch.polar(one, 0.5 * theta)
    if op.gate_name == "Phase":
        return torch.complex(one, torch.zeros_like(one)), \
            torch.polar(one, theta)
    raise ValueError(f"not a known 1q diagonal: {op.gate_name}")


def _op_matrix(program, op: prog.ProgramOp, rows: torch.Tensor):
    """A gate matrix for ``apply_gate`` on an ``(R, L, N)`` stack: the
    static ``(D, D)`` matrix, or ``(R, 1, D, D)``, one per parameter row."""
    if op.static_matrix is not None:
        return np.asarray(op.static_matrix, dtype=CONFIG.np_complex)
    return program.op_matrix_torch(op, rows)[:, None]


def _repeat_rows(op, shards: int):
    """An operand of R rows -> R * shards rows, shard-minor: a stride-0
    (shared) operand stays a stride-0 view, a per-row one is repeated."""
    if op is None:
        return None
    if op.stride(0) == 0:
        return op[:1].expand((op.shape[0] * shards,) + tuple(op.shape[1:]))
    return op.repeat_interleave(shards, dim=0)


# ---------------------------------------------------------------------------
# The shard body
# ---------------------------------------------------------------------------

class _ShardBody:
    """One program's schedule on a mesh: the per-shard body of
    ``distributed.py:306-482`` (both routes, JAX's threshold) and, with a
    noise model, of ``:499-589``. ``forward`` runs it on every local
    shard at once."""

    def __init__(self, program: prog.CircuitProgram, mesh: ShardMesh,
                 noise_model=None):
        n = program.num_qubits
        g = _log2(mesh)
        n_local = n - g
        if n_local < 1:
            raise ValueError("need at least 1 local qubit per shard")
        self.program, self.mesh, self.g, self.n_local = program, mesh, g, \
            n_local
        self.noise_model = noise_model
        noswap = (ideal_noswap(program) if noise_model is None
                  else noisy_noswap(program, noise_model))
        self.schedule = _build_schedule(program, g, noswap)
        self.grouped = (noise_model is None
                        and n_local >= _GROUPED_SHARD_MIN_QUBITS)
        self.ids = torch.tensor(mesh.shard_ids(), device=mesh.device)
        self.segments = self._segments() if self.grouped else None

    @property
    def swaps(self) -> int:
        return sum(1 for it in self.schedule if it[0] == "swap")

    # -- grouped route: gate runs between exchanges as mini plans --------

    def _local_op(self, oi: int, local_ts) -> prog.ProgramOp:
        if oi < 0:  # restore-phase in-shard SWAP
            return prog.ProgramOp("SWAP", local_ts, 0, 0, 0, _SWAP_MAT,
                                  None, -1)
        return dataclasses.replace(self.program.ops[oi], targets=local_ts)

    def _segments(self) -> list[tuple]:
        p = self.program
        segments: list[tuple] = []
        run: list[tuple] = []

        def close_run():
            if run:
                ops = tuple(self._local_op(oi, ts) for oi, ts in run)
                mp = prog.CircuitProgram(
                    num_qubits=self.n_local, initial_index=0, ops=ops,
                    num_columns=len(ops), num_params=p.num_params,
                    initial_params=p.initial_params, compile_key=())
                segments.append(("run", mp, gplan.build_group_plan(mp)))
                run.clear()

        for item in self.schedule:
            if item[0] == "gate":
                run.append(item[1:])
            elif item[0] == "lswap":
                run.append((-1, (item[1], item[2])))
            else:
                close_run()
                segments.append(item)
        close_run()
        return segments

    def _operands(self, mp, plan, rows: torch.Tensor):
        """The run's operands for R rows x L shards: one operator per row
        shared by its L shards (stride 0 with one row)."""
        L = self.mesh.local
        R = rows.shape[0]
        if R == 1:
            return gplan.build_group_operands_batched(
                mp, plan, rows[0].double().cpu().numpy(), L,
                self.mesh.device)
        ops = gplan.build_group_operands_batched(mp, plan, rows, R,
                                                 self.mesh.device)
        axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = ops
        return ([[_repeat_rows(o, L) for o in s] for s in axis_stacks],
                [_repeat_rows(o, L) for o in cross_ops],
                [_repeat_rows(o, L) for o in diag_ops], prod_ops,
                [_repeat_rows(o, L) for o in bitpair_ops])

    # -- the body ---------------------------------------------------------

    def initial(self, R: int, complex_: bool) -> torch.Tensor:
        """|initial_index> as an ``(R, L, 2, N)`` planar or ``(R, L, N)``
        complex stack: 1 in the shard that holds it, if on this rank."""
        L, N = self.mesh.local, 1 << self.n_local
        shape = (R, L, N) if complex_ else (R, L, 2, N)
        x = torch.zeros(shape, dtype=CONFIG.dtype if complex_
                        else CONFIG.real_dtype, device=self.mesh.device)
        dev = (self.program.initial_index >> self.n_local) \
            - self.mesh.first_shard
        if 0 <= dev < L:
            idx = self.program.initial_index & (N - 1)
            if complex_:
                x[:, dev, idx] = 1.0
            else:
                x[:, dev, 0, idx] = 1.0
        return x

    def _cphase(self, x, op, local_ts, global_ts, rows) -> None:
        """``x *= v`` where every target bit is set: the shard bits give
        a per-shard 0/1, the local ones a mask built per chunk."""
        gsel = torch.ones_like(self.ids)
        for p in global_ts:
            gsel = gsel * _bits_of(self.ids, p, self.g)
        if not bool(gsel.any()):
            return
        v = _op_value(op, rows)
        nl = self.n_local

        def factor(start, width):
            ind = gsel[:, None].bool()
            if local_ts:
                idx = torch.arange(start, start + width,
                                   device=self.ids.device)
                for lp in local_ts:
                    ind = ind & (_bits_of(idx, lp, nl) == 1)[None]
            one = torch.ones((), dtype=CONFIG.dtype, device=ind.device)
            return torch.where(ind, torch.as_tensor(
                v, dtype=CONFIG.dtype, device=ind.device), one)

        _scale_chunks(x, factor)

    def _gdiag1(self, x, op, g_pos: int, rows) -> None:
        """``x *= d[shard bit]``: one complex scalar per shard."""
        d0, d1 = _diag1_values(op, rows)
        bit = _bits_of(self.ids, g_pos, self.g).bool()
        dev = x.device
        f = torch.where(bit[None, :],
                        torch.as_tensor(d1, dtype=CONFIG.dtype, device=dev),
                        torch.as_tensor(d0, dtype=CONFIG.dtype,
                                        device=dev))[..., None]
        _scale_chunks(x, lambda start, width: f)

    def _exchange(self, x, g_pos: int, l_pos: int) -> None:
        _swap_global_local(x, g_pos, l_pos, self.g, self.mesh)

    def forward(self, params, x: torch.Tensor | None = None,
                plain: bool = False, gumbels: torch.Tensor | None = None,
                record: list | None = None) -> torch.Tensor:
        """Run the schedule. ``params``: one vector (``(P,)``) or a batch
        of rows ``(R, P)``; ``x``: an ``(L, 2, N)`` / ``(R, L, 2, N)``
        planar stack to continue from (default |initial>); result the
        planar stack of the same rank. ``plain``: the grouped route runs
        the kernels' plain twins. With a noise model ``gumbels`` are
        ``(R, draws, K)`` (one row per trajectory) and ``record`` (a list)
        receives each draw's ``(branch (R,), margin (R,))``."""
        one = not (isinstance(params, torch.Tensor) and params.ndim == 2)
        rows = _row_params(params, self.mesh.device)
        if gumbels is not None:
            gumbels = torch.as_tensor(gumbels, dtype=torch.float32,
                                      device=self.mesh.device)
        R = rows.shape[0] if gumbels is None else gumbels.shape[0]
        if x is not None and x.ndim == 3:
            x = x[None]
        if self.grouped:
            x = self._grouped(rows, x, plain)
        else:
            z = (self.initial(R, True) if x is None else
                 torch.complex(x[:, :, 0], x[:, :, 1]).to(CONFIG.dtype))
            z = self._per_gate(z.contiguous(), rows, gumbels, record)
            x = torch.stack([z.real, z.imag], dim=2).to(CONFIG.real_dtype)
        return x[0] if one and gumbels is None else x

    def _grouped(self, rows, x, plain: bool) -> torch.Tensor:
        R = rows.shape[0]
        L, N = self.mesh.local, 1 << self.n_local
        x = self.initial(R, False) if x is None else x.contiguous()
        exec_params = (rows[0].double().cpu().numpy() if R == 1
                       else rows.repeat_interleave(L, dim=0))
        for seg in self.segments:
            if seg[0] == "swap":
                self._exchange(x, seg[1], seg[2])
            elif seg[0] == "cphase":
                self._cphase(x, self.program.ops[seg[1]], seg[2], seg[3],
                             rows)
            elif seg[0] == "gdiag1":
                self._gdiag1(x, self.program.ops[seg[1]], seg[2], rows)
            else:
                _, mp, plan = seg
                operands = self._operands(mp, plan, rows)
                xs = x.reshape((R * L, 2) + tuple(plan.layout.axis_sizes))
                xs = gplan.execute_group_plan(plan, operands, mp,
                                              exec_params, xs, True, plain,
                                              batched=True)
                del operands
                x = xs.contiguous().reshape(R, L, 2, N)
        return x

    def _per_gate(self, z, rows, gumbels, record) -> torch.Tensor:
        p, nl = self.program, self.n_local
        draw = 0
        for item in self.schedule:
            kind = item[0]
            if kind == "swap":
                z = z.contiguous()
                self._exchange(z, item[1], item[2])
                continue
            if kind == "cphase":
                self._cphase(z, p.ops[item[1]], item[2], item[3], rows)
                continue
            if kind == "gdiag1":
                self._gdiag1(z, p.ops[item[1]], item[2], rows)
                continue
            if kind == "lswap":
                z = apply_gate(z, _SWAP_MAT, (item[1], item[2]), nl)
                continue
            op, local_ts = p.ops[item[1]], item[2]
            if op.cphase_value is not None:
                z = apply_cphase(z, local_ts, op.cphase_value, nl)
            else:
                z = apply_gate(z, _op_matrix(p, op, rows), local_ts, nl)
            if self.noise_model is None:
                continue
            for kraus_np in self.noise_model.kraus_stacks_for_gate(
                    op.gate_name):
                if kraus_np.shape[-1] != 2:
                    raise ValueError(
                        "the sharded trajectory body draws one-qubit "
                        "Kraus channels only")
                kraus = torch.from_numpy(kraus_np.astype(
                    CONFIG.np_complex)).to(z.device)
                for lq in local_ts:
                    z = self._kraus_draw(z, kraus, lq, gumbels[:, draw],
                                         record)
                    draw += 1
            z = z.contiguous()
        return z

    def _kraus_draw(self, z, kraus, lq: int, g_row, record):
        """One Kraus draw on local qubit ``lq`` of every trajectory: the
        branch weights from the GLOBAL one-qubit reduced density matrix
        (local shards summed, then over ranks), the drawn operator
        applied and the state renormalized (``distributed.py:567-587``)."""
        rho = reduced_density_matrix_1q(z, lq, self.n_local).sum(1)
        rho = self.mesh.all_reduce(rho.contiguous())           # (R, 2, 2)
        norms = torch.einsum("mij,rjk,mik->rm", kraus, rho,
                             kraus.conj()).real
        logits = torch.log(norms + 1e-30) + g_row[:, :kraus.shape[0]]
        idx = logits.argmax(-1)
        if record is not None:
            top = logits.topk(min(2, logits.shape[-1]), -1).values
            record.append((idx.cpu(), (top[:, 0] - top[:, -1]).cpu()))
        z = apply_gate(z, kraus[idx][:, None], (lq,), self.n_local)
        scale = norms.gather(1, idx[:, None]).clamp_min(1e-30).rsqrt()
        return z * scale[:, :, None].to(z.dtype)


def local_forward_body(program: prog.CircuitProgram,
                       mesh: ShardMesh) -> Callable:
    """The per-shard forward body: ``params -> (L, 2, 2^(n-g))`` planar
    stack of this rank's shards (``(R, L, 2, 2^(n-g))`` for a batch of
    parameter rows). JAX's body reads its shard from shard_map's
    ``axis_index``; here the mesh says which shards the rank holds."""
    return _ShardBody(program, mesh).forward


def sharded_forward_fn(program: prog.CircuitProgram,
                       mesh: ShardMesh) -> Callable:
    """``f(params) -> (L, 2, 2^(n-g))`` planar stack over ``mesh`` (JAX:
    the jitted shard_map of the local body; here the body itself)."""
    return local_forward_body(program, mesh)


def sharded_apply_fn(program: prog.CircuitProgram,
                     mesh: ShardMesh) -> Callable:
    """``f(state, params) -> state``: applies a program to an EXISTING
    planar stack (the segmented-execution primitive; the state passed in
    is consumed: the grouped route writes it in place)."""
    body = _ShardBody(program, mesh)
    return lambda state, params: body.forward(params, state)


def noisy_draw_shape(program: prog.CircuitProgram,
                     noise_model) -> tuple[int, int]:
    """(draws, K) of one sharded trajectory: one draw per channel and
    target of every op (JAX's ``total_draws``, at least 1) and the
    largest Kraus count."""
    draws, width = 0, 1
    for op in program.ops:
        stacks = noise_model.kraus_stacks_for_gate(op.gate_name)
        draws += len(stacks) * len(op.targets)
        width = max([width] + [s.shape[0] for s in stacks])
    return max(1, draws), width


def sharded_trajectory_fn(program: prog.CircuitProgram, noise_model,
                          mesh: ShardMesh) -> Callable:
    """``f(params, gumbels (T, draws, K), record=None) -> (T, L, 2, N)``:
    T stochastic-Kraus trajectories with every draw made consistently
    across the mesh (global branch weights by all_reduce, one Gumbel row
    per trajectory shared by its shards)."""
    body = _ShardBody(program, mesh, noise_model)
    return lambda params, gumbels, record=None: body.forward(
        params, gumbels=gumbels, record=record)


def draw_gumbels(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    return gumbel_from_uniform(torch.rand(shape, generator=generator,
                                          device=device))


def with_basis_rotation(circuit: QuantumCircuit,
                        basis: str) -> QuantumCircuit:
    """A copy of ``circuit`` with the measurement-basis rotation appended
    as gate columns: X = H on every qubit, Y = S_DAG then H."""
    basis = str(getattr(basis, "value", basis)).upper()
    if basis not in ("Z", "X", "Y"):
        raise ValueError(f"unknown measurement basis {basis!r}")
    if basis == "Z":
        return circuit
    out = QuantumCircuit.from_dict(circuit.to_dict())
    col = 1 + max((g.column for g in out.gates), default=-1)
    if basis == "Y":
        for q in range(out.num_qubits):
            out.add_gate(GateInstance("S_DAG", [q], [], column=col))
        col += 1
    for q in range(out.num_qubits):
        out.add_gate(GateInstance("H", [q], [], column=col))
    return out


# ---------------------------------------------------------------------------
# Reductions over a planar stack
# ---------------------------------------------------------------------------

def _probs(block: torch.Tensor) -> torch.Tensor:
    """|amp|^2 of one shard's ``(2, N)`` planes."""
    return block[0].square() + block[1].square()


def _f64(v) -> torch.Tensor:
    return v.sum(dtype=torch.float64)


def _conj_dot(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(re, im) of sum conj(a) * b over planar ``(2, ...)`` blocks."""
    return (_f64(a[0] * b[0]) + _f64(a[1] * b[1]),
            _f64(a[0] * b[1]) - _f64(a[1] * b[0]))


def _shard_groups(x: torch.Tensor) -> list[tuple[int, int]]:
    """``(lo, hi)`` ranges of the shard axis of a ``(B, L, 2, N)`` batch
    of stacks, each of at most ``CHUNK_ELEMS`` elements or one shard:
    the reductions take one group at a time."""
    L = x.shape[1]
    per = max(1, gplan.CHUNK_ELEMS // x[:, :1].numel())
    return [(lo, min(L, lo + per)) for lo in range(0, L, per)]


def _partner_groups(x: torch.Tensor, flip: int, mesh: ShardMesh):
    """Yield ``(lo, hi, partner)`` over the shard groups of a ``(B, L, 2,
    N)`` batch: ``partner[:, i]`` holds the block of shard ``(first + lo
    + i) ^ flip``, gathered on this rank or received from the partner
    rank (which asks for the same local shards in the same turn)."""
    L = mesh.local
    local_flip, rank_flip = flip & (L - 1), flip // L
    for lo, hi in _shard_groups(x):
        part = (x[:, lo:hi] if local_flip == 0 else
                x[:, [l ^ local_flip for l in range(lo, hi)]])
        if rank_flip:
            part = mesh.exchange(part, mesh.rank ^ rank_flip)
        yield lo, hi, part


def _rowsum(t: torch.Tensor) -> torch.Tensor:
    """Float64 sums over every axis but the first."""
    return t.sum(dim=tuple(range(1, t.ndim)), dtype=torch.float64)


def _bloch(x: torch.Tensor, n: int, mesh: ShardMesh) -> torch.Tensor:
    """``(B, n, 3)`` float64 (z, Re c, Im c) of each qubit of a ``(B, L,
    2, 2^(n-g))`` batch of stacks (``_qubit_bloch_body``,
    ``distributed.py:628-673``): z = <Z_q>, c = sum over bit_q = 0 of
    conj(x_j) x_{j ^ m}. Local qubits pair inside a shard, shard-bit
    qubits with the partner shard; shards go in groups of bounded
    size, then one all_reduce."""
    g = _log2(mesh)
    nl = n - g
    B = x.shape[0]
    zc = torch.zeros((B, n, 3), dtype=torch.float64, device=x.device)
    ids = torch.tensor(mesh.shard_ids(), device=x.device)
    for lo, hi in _shard_groups(x):
        xs = x[:, lo:hi]
        G = hi - lo
        p = xs.square().sum((2, 3), dtype=torch.float64)        # (B, G)
        for q in range(g):
            sign = 1.0 - 2.0 * _bits_of(ids[lo:hi], q, g).double()
            zc[:, q, 0] += (p * sign).sum(1)
        for q in range(g, n):
            v = xs.reshape(B, G, 2, 1 << (q - g), 2, -1)
            x0, x1 = v[:, :, :, :, 0], v[:, :, :, :, 1]
            zc[:, q, 0] += _rowsum(x0.square()) - _rowsum(x1.square())
            zc[:, q, 1] += _rowsum(x0[:, :, 0] * x1[:, :, 0]) + _rowsum(
                x0[:, :, 1] * x1[:, :, 1])
            zc[:, q, 2] += _rowsum(x0[:, :, 0] * x1[:, :, 1]) - _rowsum(
                x0[:, :, 1] * x1[:, :, 0])
    for q in range(g):
        for lo, hi, part in _partner_groups(x, 1 << (g - 1 - q), mesh):
            xs = x[:, lo:hi]
            keep = (_bits_of(ids[lo:hi], q, g) == 0).double()
            re = (xs[:, :, 0] * part[:, :, 0]).sum(-1, dtype=torch.float64) \
                + (xs[:, :, 1] * part[:, :, 1]).sum(-1, dtype=torch.float64)
            im = (xs[:, :, 0] * part[:, :, 1]).sum(-1, dtype=torch.float64) \
                - (xs[:, :, 1] * part[:, :, 0]).sum(-1, dtype=torch.float64)
            zc[:, q, 1] += (re * keep).sum(1)
            zc[:, q, 2] += (im * keep).sum(1)
    return mesh.all_reduce(zc)


def _rhos(zc: np.ndarray) -> np.ndarray:
    """(n, 2, 2) rho_q = [[(1 + z) / 2, conj(c)], [c, (1 - z) / 2]]."""
    z, c = zc[:, 0], zc[:, 1] + 1j * zc[:, 2]
    return np.stack([np.stack([(1 + z) / 2, np.conj(c)], -1),
                     np.stack([c, (1 - z) / 2 + 0j], -1)], -2)


# Amplitudes per tile of the sampler's two-level search (the tile of
# ``bigstate.sample_state_indices``).
SAMPLE_TILE = 1 << 14


def _local_indices(probs: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """For each float64 target t in [0, sum), the first index whose
    inclusive CDF of ``probs`` exceeds t (``searchsorted(..., side=
    "right")``, clipped to the last index), in two float64 levels: the
    CDF of the tile sums, then the CDF inside each target's tile."""
    N = probs.shape[0]
    S = min(N, SAMPLE_TILE)
    tiles = probs.reshape(-1, S)
    tcdf = torch.cumsum(tiles.sum(1, dtype=torch.float64), 0)
    out = torch.empty(targets.shape[0], dtype=torch.int64,
                      device=probs.device)
    for s in range(0, targets.shape[0], SAMPLE_BATCH):
        t = targets[s:s + SAMPLE_BATCH]
        b = torch.searchsorted(tcdf, t, right=True).clamp_(
            max=tiles.shape[0] - 1)
        below = torch.where(b > 0, tcdf[(b - 1).clamp(min=0)],
                            torch.zeros_like(t))
        cdf = torch.cumsum(tiles[b].double(), 1)
        j = torch.searchsorted(cdf, (t - below)[:, None], right=True)
        out[s:s + SAMPLE_BATCH] = b * S + j[:, 0].clamp_(max=S - 1)
    return out


class DistributedStateVector:
    """An n-qubit state sharded across a mesh: this rank's planar
    ``(L, 2, 2^(n-g))`` stack on the mesh's device: float32 planes, or
    float64 under ``config.enable_complex128``."""

    def __init__(self, planar: torch.Tensor, num_qubits: int,
                 mesh: ShardMesh):
        self._data = planar
        self._num_qubits = num_qubits
        self._mesh = mesh

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def device_data(self) -> torch.Tensor:
        """This rank's planar stack (no copy)."""
        return self._data

    @property
    def mesh(self) -> ShardMesh:
        return self._mesh

    def _gathered(self) -> torch.Tensor:
        return self._mesh.all_gather(self._data).double().cpu()

    @property
    def probabilities(self) -> np.ndarray:
        """Host copy of |amp|^2 (gathers every rank's shards)."""
        x = self._gathered()
        return (x[:, 0].square() + x[:, 1].square()).reshape(-1).numpy()

    @property
    def data(self) -> np.ndarray:
        """Host complex128 copy (gathers every rank's shards)."""
        x = self._gathered()
        return torch.complex(x[:, 0], x[:, 1]).reshape(-1).numpy()

    def norm(self) -> float:
        s = torch.stack([_f64(_probs(b)) for b in self._data]).sum()
        return float(self._mesh.all_reduce(s))


def _check_mesh_amplitude_cap(circuit: QuantumCircuit,
                              mesh: ShardMesh) -> None:
    """Per-card amplitude cap: each rank's card holds 2^n / W amplitudes
    (its L shards), so W ranks extend ``CONFIG.max_qubits`` by log2(W)
    (JAX: one shard per device, log2(D)), and under
    ``config.enable_complex128`` the float64 cap by as much."""
    require_width(circuit.num_qubits, "DistributedSimulator", mesh.world)
    cap = CONFIG.max_qubits + max(0, mesh.world.bit_length() - 1)
    if circuit.num_qubits > cap:
        raise ValueError(
            f"num_qubits must be <= {cap} on a {mesh.world}-rank mesh "
            f"(= max_qubits {CONFIG.max_qubits} + log2(ranks)), got "
            f"{circuit.num_qubits}")


class DistributedSimulator:
    """Circuit execution over a shard mesh (forward path, noisy
    trajectories, sampling and shard-local reductions)."""

    def __init__(self, mesh: ShardMesh | None = None,
                 n_devices: int | None = None, device=None):
        self._mesh = (check_mesh(mesh) if mesh is not None
                      else make_mesh(n_devices, device=device))

    @property
    def mesh(self) -> ShardMesh:
        return self._mesh

    @property
    def _g(self) -> int:
        return _log2(self._mesh)

    def run(self, circuit: QuantumCircuit) -> DistributedStateVector:
        _check_mesh_amplitude_cap(circuit, self._mesh)
        program = prog.compile_circuit(circuit)
        state = sharded_forward_fn(program, self._mesh)(
            program.initial_params)
        return DistributedStateVector(state, circuit.num_qubits, self._mesh)

    def run_segmented(self, circuit: QuantumCircuit, segment_columns: int,
                      progress: Callable | None = None,
                      checkpoint_dir: str | None = None,
                      resume: bool = True) -> DistributedStateVector:
        """``run`` split into column segments of ``segment_columns``
        (``distributed.py:797-881``): the same state, with
        ``progress(seg_idx, n_segments, wall_s)`` after each segment (the
        device synchronized) and, with ``checkpoint_dir``, the state saved
        after every segment (``parallel/checkpoint``, the JAX package's
        files) and a rerun of the same circuit, segmenting and mesh size
        resuming from the newest checkpoint (``checkpoint.resume_segment``:
        in a new process too). Structurally equal segments share one body
        (schedule and mini plans)."""
        _check_mesh_amplitude_cap(circuit, self._mesh)
        if segment_columns < 1:
            raise ValueError("segment_columns must be >= 1")
        from . import checkpoint as ckpt

        n = circuit.num_qubits
        n_cols = 1 + max((gt.column for gt in circuit.gates), default=-1)
        bounds = list(range(0, max(n_cols, 1), segment_columns))
        start_seg = 0
        ck_meta = digest = None
        if checkpoint_dir:
            ck_meta = {"circuit_hash": circuit.circuit_hash(),
                       "segment_columns": segment_columns,
                       "num_qubits": n,
                       "n_devices": self._mesh.n_devices}
            digest = ckpt.circuit_digest(circuit)
            if resume and self._mesh.rank == 0 and \
                    os.path.isdir(checkpoint_dir):
                start_seg = ckpt.resume_segment(
                    ckpt.read_latest(checkpoint_dir), ck_meta, digest)
            # rank 0 decides for every rank: the hash differs per process
            start_seg = self._mesh.broadcast(start_seg)
            if start_seg:
                latest = ckpt.read_latest(checkpoint_dir)
                saved = ckpt.load_manifest(latest).get("dtype", "complex64")
                if saved != ckpt.complex_name(CONFIG.real_dtype):
                    raise ValueError(
                        f"the checkpoint in {checkpoint_dir} holds a "
                        f"{saved} state and the engine runs "
                        f"{CONFIG.dtype}: resume it in the mode that wrote "
                        f"it (config.enable_complex128 / enable_complex64) "
                        f"or pass resume=False")
                state = ckpt.load_sharded_state(latest, self._mesh)
        if start_seg == 0:
            init = QuantumCircuit(n)
            init.initial_states = list(circuit.initial_states)
            state = self.run(init).device_data

        bodies: dict[int, _ShardBody] = {}
        n_segments = len(bounds)
        for si, lo in enumerate(bounds):
            if si < start_seg:
                continue
            hi = lo + segment_columns
            seg = QuantumCircuit(n)
            for gt in sorted(circuit.gates, key=lambda x: x.column):
                if lo <= gt.column < hi:
                    seg.add_gate(GateInstance(
                        gt.gate_name, list(gt.target_qubits),
                        list(gt.params), column=gt.column - lo))
            if not seg.gates:
                continue
            program = prog.compile_circuit(seg)
            key = seg.structure_hash()
            if key not in bodies:
                bodies[key] = _ShardBody(program, self._mesh)
            t0 = time.perf_counter()
            state = bodies[key].forward(program.initial_params, state)
            if progress is not None:
                if state.is_cuda:
                    torch.cuda.synchronize(state.device)
                progress(si, n_segments, time.perf_counter() - t0)
            if checkpoint_dir:
                seg_name = f"seg_{si}"
                ckpt.save_sharded_state(
                    state, os.path.join(checkpoint_dir, seg_name),
                    self._mesh, meta={"run": ck_meta,
                                      "next_segment": si + 1,
                                      "circuit_digest": digest})
                ckpt.write_latest(checkpoint_dir, seg_name, self._mesh)
        return DistributedStateVector(state, n, self._mesh)

    # -- noisy trajectories ----------------------------------------------

    def _gumbels(self, program, noise_model, T: int, rng,
                 gumbels) -> torch.Tensor:
        if gumbels is not None:
            return torch.as_tensor(gumbels, dtype=torch.float32,
                                   device=self._mesh.device)
        draws, width = noisy_draw_shape(program, noise_model)
        return draw_gumbels((T, draws, width),
                            generator_from_rng(rng, self._mesh.device),
                            self._mesh.device)

    def _trajectories(self, program, noise_model, gumbels):
        """Yield planar ``(T_chunk, L, 2, N)`` trajectory stacks, T cut so
        a chunk's complex stacks (about 3 per trajectory: the state and
        the einsum temporaries) stay within ``TRAJECTORY_MEMORY_BYTES``."""
        fn = sharded_trajectory_fn(program, noise_model, self._mesh)
        per = 3 * CONFIG.dtype.itemsize * self._mesh.local << (
            program.num_qubits - self._g)
        chunk = max(1, TRAJECTORY_MEMORY_BYTES // per)
        for start in range(0, gumbels.shape[0], chunk):
            yield fn(program.initial_params, gumbels[start:start + chunk])

    def run_noisy_trajectory(self, circuit: QuantumCircuit, noise_model,
                             seed: int | None = None, gumbels=None
                             ) -> DistributedStateVector:
        """One stochastic-Kraus trajectory over the mesh; ``gumbels``
        ``(1, draws, K)`` (``noisy_draw_shape``) override the draws of a
        generator seeded from ``seed``."""
        _check_mesh_amplitude_cap(circuit, self._mesh)
        program = prog.compile_circuit(circuit)
        g = self._gumbels(program, noise_model, 1,
                          np.random.default_rng(seed), gumbels)
        state = sharded_trajectory_fn(program, noise_model, self._mesh)(
            program.initial_params, g[:1])[0]
        return DistributedStateVector(state, circuit.num_qubits, self._mesh)

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1024,
                       trajectories: int | None = None,
                       seed: int | None = None,
                       rng: np.random.Generator | None = None,
                       gumbels=None) -> dict[str, int]:
        """Noisy counts on the mesh: T = min(shots, 16) trajectories by
        default (``distributed.py:896-936``), run as batches, each
        sampled ~shots / T times shard-locally. The draws are ``gumbels``
        ``(T, draws, K)`` or come from a generator seeded from ``rng``;
        the shots' uniforms come from ``rng`` after them."""
        _check_mesh_amplitude_cap(circuit, self._mesh)
        if rng is None:
            rng = np.random.default_rng(seed)
        if noise_model is None or not noise_model.has_channels():
            return self.sample(self.run(circuit), shots, rng=rng)
        T = max(1, min(shots, 16 if trajectories is None else trajectories))
        program = prog.compile_circuit(circuit)
        g = self._gumbels(program, noise_model, T, rng, gumbels)
        base, extra = divmod(shots, T)
        total: dict[str, int] = {}
        i = 0
        for stack in self._trajectories(program, noise_model, g[:T]):
            for st in stack:
                take = base + (1 if i < extra else 0)
                i += 1
                if take == 0:
                    continue
                state = DistributedStateVector(st, circuit.num_qubits,
                                               self._mesh)
                for bits, cnt in self.sample(state, take, rng=rng).items():
                    total[bits] = total.get(bits, 0) + cnt
        return total

    def ensemble_qubit_density_matrices(self, circuit: QuantumCircuit,
                                        noise_model, n_trials: int = 50,
                                        seed: int | None = None,
                                        gumbels=None) -> np.ndarray:
        """(n, 2, 2) single-qubit reduced density matrices averaged over
        ``n_trials`` stochastic-Kraus trajectories on the mesh."""
        n = circuit.num_qubits
        if noise_model is None or not noise_model.has_channels():
            return self.qubit_density_matrices(self.run(circuit))
        program = prog.compile_circuit(circuit)
        T = max(1, n_trials)
        g = self._gumbels(program, noise_model, T,
                          np.random.default_rng(seed), gumbels)
        acc = np.zeros((n, 3))
        for stack in self._trajectories(program, noise_model, g[:T]):
            acc += _bloch(stack, n, self._mesh).sum(0).cpu().numpy()
        return _rhos(acc / T)

    # -- reductions --------------------------------------------------------

    def _shard_bit(self, d: int, q: int) -> int:
        return (d >> (self._g - 1 - q)) & 1

    def qubit_density_matrices(self, state: DistributedStateVector
                               ) -> np.ndarray:
        """(n, 2, 2) single-qubit reduced density matrices of a sharded
        pure state, every qubit in one pass per qubit and no gather: 3n
        numbers leave the device (``_bloch``)."""
        zc = _bloch(state.device_data[None], state.num_qubits, self._mesh)
        return _rhos(zc[0].cpu().numpy())

    def expectation_z(self, state: DistributedStateVector,
                      qubit: int) -> float:
        """<Z_qubit>: a shard sign (shard-bit qubit) or the two halves of
        each shard (local qubit), summed, then over ranks."""
        mesh, g = self._mesh, self._g
        x = state.device_data
        nl = state.num_qubits - g
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for l, blk in enumerate(x):
            if qubit < g:
                sign = 1.0 - 2.0 * self._shard_bit(mesh.first_shard + l,
                                                   qubit)
                total += sign * _f64(_probs(blk))
            else:
                li = qubit - g
                v = blk.reshape(2, 1 << li, 2, 1 << (nl - 1 - li))
                total += _f64(v[:, :, 0].square()) - _f64(
                    v[:, :, 1].square())
        return float(mesh.all_reduce(total))

    def fidelity(self, a: DistributedStateVector,
                 b: DistributedStateVector) -> float:
        """|<a|b>|^2 between two sharded states."""
        s = torch.zeros(2, dtype=torch.float64,
                        device=a.device_data.device)
        for xa, xb in zip(a.device_data, b.device_data):
            re, im = _conj_dot(xa, xb)
            s[0] += re
            s[1] += im
        s = self._mesh.all_reduce(s)
        return float(s[0] ** 2 + s[1] ** 2)

    def expectation_pauli_string(self, state: DistributedStateVector,
                                 qubits, paulis: str) -> float:
        """<prod P_i> for an X / Y / Z string on a sharded state
        (``distributed.py:1022-1122``): a Pauli string is a signed
        permutation, <P> = Re[i^k sum_j conj(x[j ^ mask]) sign(j) x[j]].
        The shard part of the mask pairs each shard with its partner,
        local flips reverse the exposed bit dims, the signs multiply
        them; then one all_reduce."""
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
        n = state.num_qubits
        if min(qubits) < 0 or max(qubits) >= n:
            raise ValueError(f"qubits {qubits} out of range for n={n}")
        mesh, g = self._mesh, self._g
        nl = n - g
        dev_flip = dev_sign = loc_flip = loc_sign = 0
        for q, p in zip(qubits, paulis):
            if q < g:
                bit = 1 << (g - 1 - q)
                dev_flip |= bit if p in "XY" else 0
                dev_sign |= bit if p in "ZY" else 0
            else:
                bit = 1 << (n - 1 - q)
                loc_flip |= bit if p in "XY" else 0
                loc_sign |= bit if p in "ZY" else 0
        k = paulis.count("Y")
        positions = [b for b in range(nl)
                     if (loc_flip | loc_sign) >> (nl - 1 - b) & 1]
        dims: list[int] = []
        flip_axes: list[int] = []
        sign_axes: list[int] = []
        prev = 0
        for b in positions:
            if b - prev:
                dims.append(1 << (b - prev))
            if loc_flip >> (nl - 1 - b) & 1:
                flip_axes.append(1 + len(dims))
            if loc_sign >> (nl - 1 - b) & 1:
                sign_axes.append(1 + len(dims))
            dims.append(2)
            prev = b + 1
        if nl - prev:
            dims.append(1 << (nl - prev))
        shape = (2,) + tuple(dims)
        x = state.device_data
        s = torch.zeros(2, dtype=torch.float64, device=x.device)
        pm = torch.tensor([1.0, -1.0], device=x.device)
        for lo, hi, part in _partner_groups(x[None], dev_flip, mesh):
            for l in range(lo, hi):
                blk = x[l].reshape(shape)
                t = part[0, l - lo].reshape(shape)
                if flip_axes:
                    t = torch.flip(t, flip_axes)
                pr = t[0] * blk[0] + t[1] * blk[1]
                pi = t[0] * blk[1] - t[1] * blk[0]
                for sa in sign_axes:
                    view = [1] * (len(shape) - 1)
                    view[sa - 1] = 2
                    pr = pr * pm.reshape(view)
                    pi = pi * pm.reshape(view)
                par = sum(self._shard_bit(mesh.first_shard + l, b)
                          for b in range(g) if dev_sign >> (g - 1 - b) & 1)
                sign = -1.0 if par % 2 else 1.0
                s[0] += sign * _f64(pr)
                s[1] += sign * _f64(pi)
        s_re, s_im = (float(v) for v in mesh.all_reduce(s))
        return (s_re, -s_im, -s_re, s_im)[k % 4]

    def sample(self, state: DistributedStateVector, shots: int,
               rng: np.random.Generator | None = None) -> dict[str, int]:
        """Counts by a shard-local inverse-CDF sampler
        (``distributed.py:1123-1181``): one shared cumsum of the shard
        sums defines every shard's interval, each shard claims the
        uniforms in its interval and resolves them locally, and a sum
        over shards and ranks combines the (shard, local index) pairs.
        No 2^n vector is built. Inside a shard the port searches two
        levels in float64 (``_local_indices``) where JAX takes one float32
        cumsum of the whole shard: on the card such a cumsum of 2^29
        amplitudes neither repeats bit for bit nor keeps the 2^-32
        spacing of the CDF, so the same uniforms would not give the same
        shots."""
        rng = rng or np.random.default_rng()
        mesh = self._mesh
        x = state.device_data
        n = state.num_qubits
        nl = n - self._g
        D = mesh.n_devices
        u = torch.from_numpy(rng.random(shots, dtype=np.float64).astype(
            np.float32)).to(x.device)
        sums = mesh.all_gather(torch.stack([_probs(b).sum() for b in x]))
        bounds = torch.cumsum(sums, 0)
        # the float32 uniforms scale in the state's precision
        u_scaled = u.to(bounds.dtype) * bounds[D - 1]
        shard_of = torch.zeros(shots, dtype=torch.int64, device=x.device)
        local_of = torch.zeros_like(shard_of)
        for l, blk in enumerate(x):
            d = mesh.first_shard + l
            prefix = bounds[d - 1] if d > 0 else torch.zeros_like(bounds[0])
            claimed = (u_scaled >= prefix) & (
                (u_scaled < bounds[d]) | (d == D - 1))
            which = claimed.nonzero()[:, 0]
            if which.numel() == 0:
                continue
            shard_of[which] = d
            local_of[which] = _local_indices(
                _probs(blk), u_scaled[which].double() - prefix.double())
        shard_of = mesh.all_reduce(shard_of)
        local_of = mesh.all_reduce(local_of)
        idx = ((shard_of << nl) | local_of).cpu().numpy()
        values, freq = np.unique(idx, return_counts=True)
        return {format(int(v), f"0{n}b"): int(c)
                for v, c in zip(values, freq)}

    def sample_with_basis(self, circuit: QuantumCircuit, shots: int,
                          basis: str = "Z",
                          rng: np.random.Generator | None = None,
                          readout_error=None) -> dict[str, int]:
        """Counts in the X / Y / Z basis: the rotation runs as gate
        columns on the mesh; readout error in the reference's shot mode
        only (host-side bitstring corruption)."""
        rotated = with_basis_rotation(circuit, basis)
        counts = self.sample(self.run(rotated), shots, rng=rng)
        if readout_error is not None:
            counts = readout_error.corrupt_counts(
                counts, rng or np.random.default_rng())
        return counts
