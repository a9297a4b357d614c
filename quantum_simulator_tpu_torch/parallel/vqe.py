"""Sharded VQE training step over a (traj x amp) mesh.

Counterpart of ``quantum_simulator_tpu/parallel/vqe.py``. Two parallel
axes:

* ``amp``: the 2^n amplitude vector of each evaluation is split across
  ``amp`` shards (``parallel/distributed.py``), which lie on one rank;
* ``traj``: the 1 + 2P parameter-shift evaluations of one gradient are
  split across the traj rows. In one process the rows are more batch: a
  ``(rows, amp)`` stack of shards through one body, every dense and cross
  step one launch for all of them with one operator per row. Across
  ranks each rank takes its traj rows and the costs are gathered with
  ``dist.all_gather``.

One ``step`` computes every shifted cost, assembles the parameter-shift
gradient and applies an Adam update with the JAX package's constants
(``vqe.py:166-188``), in float32, or under ``config.enable_complex128``
in float64 with the state: the observable's coefficients, the costs, the
Adam carry and its bias terms follow ``CONFIG.real_dtype`` (JAX keeps
them float32 in its mode).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import CONFIG, require_width
from ..ops import program as prog
from ..simulator import TRAJECTORY_MEMORY_BYTES
from .distributed import ShardMesh, _ShardBody, check_mesh, mesh_device
from .multihost import group_rank_world

TRAJ_AXIS = "traj"
AMP_AXIS = "amp"


def make_vqe_mesh(n_devices: int | None = None, *, max_amp: int = 4,
                  traj_axis: str = TRAJ_AXIS, amp_axis: str = AMP_AXIS,
                  device=None) -> ShardMesh:
    """2-D (traj x amp) mesh of ``n_devices`` shards (default one per
    rank of the process group) split evenly over its ranks, each rank's
    on its ``device`` (default ``CONFIG.device``). The amp axis takes the
    largest power of two <= ``max_amp`` dividing the count; the rest is
    the traj axis."""
    rank, world = group_rank_world()
    n = world if n_devices is None else int(n_devices)
    if n < world or n % world or n & (n - 1):
        raise ValueError(f"n_devices must be a power of 2 and a multiple "
                         f"of the {world} ranks, got {n}")
    amp = 1
    while amp * 2 <= min(max_amp, n) and n % (amp * 2) == 0:
        amp *= 2
    return ShardMesh((traj_axis, amp_axis), (n // amp, amp), n // world,
                     mesh_device(device, rank), rank, world)


def shard_local_z_sign(qubit: int, n: int, g: int,
                       shard_ids: torch.Tensor) -> torch.Tensor:
    """+-1 Z-parity factor of ``qubit`` as seen by the shards
    ``shard_ids``: ``(L, 1)`` from the shard index for a shard-bit qubit,
    ``(2^(n-g),)`` over the local block for a local one. Qubit 0 is the
    most significant bit; no 2^n vector is built."""
    if qubit < g:
        bit = (shard_ids >> (g - 1 - qubit)) & 1
        return (1.0 - 2.0 * bit.float())[:, None]
    idx = torch.arange(1 << (n - g), device=shard_ids.device)
    return 1.0 - 2.0 * ((idx >> (n - 1 - qubit)) & 1).float()


class VQEState(NamedTuple):
    """Adam optimizer carry (``CONFIG.real_dtype`` tensors, ``t`` an
    int)."""

    params: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: int


@dataclass(frozen=True)
class ShardedVQEStep:
    """Parameter-shift + Adam step over a (traj x amp) mesh."""

    step: Callable[[VQEState], tuple]  # (state) -> (state, cost)
    init: VQEState
    mesh: ShardMesh
    num_params: int

    def run(self, iterations: int) -> tuple[VQEState, list[float]]:
        state, costs = self.init, []
        for _ in range(iterations):
            state, cost = self.step(state)
            costs.append(float(cost))
        return state, costs


def sharded_vqe_step(circuit, mesh: ShardMesh, *, qubit: int = 0,
                     observable: list[tuple[float, list[int]]] | None = None,
                     learning_rate: float = 0.1,
                     traj_axis: str = TRAJ_AXIS, amp_axis: str = AMP_AXIS
                     ) -> ShardedVQEStep:
    """Build the sharded VQE step for ``circuit``: the cost is a Z-string
    Hamiltonian ``sum_i c_i <Z_{q...}>`` (``observable=[(coeff,
    [qubits]), ...]``, default ``<Z_qubit>``), each term a +-1 parity per
    shard and per local amplitude summed over the amp shards. The
    (1 + 2P)-row batch of parameter vectors (base and the +-pi/2 shifts),
    padded to a multiple of the traj rows, is split over the traj rows."""
    mesh = check_mesh(mesh)
    program = prog.compile_circuit(circuit)
    n = program.num_qubits
    require_width(n, "the sharded VQE step", mesh.world)
    real, np_real = CONFIG.real_dtype, CONFIG.np_real
    amp, traj = mesh.shape[amp_axis], mesh.shape[traj_axis]
    g = amp.bit_length() - 1
    if (1 << g) != amp:
        raise ValueError(f"amp axis size must be a power of 2, got {amp}")
    if mesh.local % amp:
        raise ValueError(f"the amp axis ({amp} shards) must lie within "
                         f"one rank's {mesh.local} shards")
    n_params = program.num_params
    if n_params == 0:
        raise ValueError("circuit has no trainable parameters")
    if observable is None:
        observable = [(1.0, [qubit])]
    for _, qs in observable:
        if not all(0 <= q < n for q in qs):
            raise ValueError(f"observable qubits out of range: {qs}")

    dev = mesh.device
    amp_mesh = ShardMesh((amp_axis,), (amp,), amp, dev)
    body = _ShardBody(program, amp_mesh)
    ids = torch.arange(amp, device=dev)
    signs, coeffs = [], []
    for coeff, qs in observable:
        s = torch.ones((amp, 1 << (n - g)), dtype=real, device=dev)
        for q in qs:
            s = s * shard_local_z_sign(q, n, g, ids)
        signs.append(s)
        coeffs.append(float(coeff))
    signs = torch.stack(signs)                          # (terms, amp, N)
    coeffs = torch.tensor(coeffs, dtype=real, device=dev)

    rows_total = 1 + 2 * n_params
    rows_padded = -(-rows_total // traj) * traj
    rows_per_traj = rows_padded // traj
    local_rows = (mesh.local // amp) * rows_per_traj
    first_row = mesh.rank * local_rows
    per_row = 3 * amp * 2 * real.itemsize << (n - g)
    chunk = max(1, TRAJECTORY_MEMORY_BYTES // per_row)

    def costs_of(rows: torch.Tensor) -> torch.Tensor:
        out = []
        for s in range(0, rows.shape[0], chunk):
            x = body.forward(rows[s:s + chunk])         # (R, amp, 2, N)
            probs = x[:, :, 0].square() + x[:, :, 1].square()
            per_term = torch.einsum("ran,tan->rt", probs, signs)
            out.append(per_term @ coeffs)
        return torch.cat(out)

    shift = math.pi / 2
    coeff = 1.0 / (2.0 * math.sin(shift))
    b1, b2, eps = 0.9, 0.999, 1e-8

    def train_step(state: VQEState):
        params = state.params
        eye = torch.eye(n_params, dtype=params.dtype, device=dev) * shift
        rows = torch.cat([
            params[None, :], params[None, :] + eye, params[None, :] - eye,
            torch.zeros((rows_padded - rows_total, n_params),
                        dtype=params.dtype, device=dev)])
        costs = mesh.all_gather(
            costs_of(rows[first_row:first_row + local_rows]))
        grad = (costs[1:1 + n_params]
                - costs[1 + n_params:rows_total]) * coeff
        t = state.t + 1
        m = b1 * state.m + (1 - b1) * grad
        v = b2 * state.v + (1 - b2) * grad ** 2
        m_hat = m / (1 - np_real(b1) ** np_real(t))
        v_hat = v / (1 - np_real(b2) ** np_real(t))
        new_params = params - learning_rate * m_hat / (torch.sqrt(v_hat)
                                                       + eps)
        return VQEState(new_params, m, v, t), costs[0]

    init = VQEState(
        params=torch.as_tensor(program.initial_params, dtype=real,
                               device=dev),
        m=torch.zeros(n_params, dtype=real, device=dev),
        v=torch.zeros(n_params, dtype=real, device=dev),
        t=0)
    return ShardedVQEStep(step=train_step, init=init, mesh=mesh,
                          num_params=n_params)
