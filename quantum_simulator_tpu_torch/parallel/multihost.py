"""Multi-process seam: process-group init and rank-spanning meshes.

Counterpart of ``quantum_simulator_tpu/parallel/multihost.py``. Where JAX
forms its process group with ``jax.distributed.initialize`` and then sees
every chip of the slice, the port joins a ``torch.distributed`` group
(``initialize_multihost``: NCCL for a CUDA device, gloo for the CPU) and
builds a mesh over its ranks (``make_multihost_mesh``): one rank per
process, one device per rank, L shards stacked on it, shard index
``rank * L + local``. The shard programs of ``parallel/distributed.py``
then exchange over the group wherever a swap crosses ranks.
``MultiHostSpec`` and ``amp_axis_split`` are the JAX package's host logic,
copied.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .distributed import AMP_AXIS, ShardMesh, mesh_device

# How long a rank waits for the others (init, collectives) before failing.
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class MultiHostSpec:
    """Resolved multi-process topology."""

    coordinator: str
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls, coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None) -> "MultiHostSpec":
        """Resolve from explicit args, falling back to the conventional
        environment variables (COORDINATOR_ADDRESS / NUM_PROCESSES /
        PROCESS_ID), defaulting to a single-process group."""
        coordinator = coordinator or os.environ.get(
            "COORDINATOR_ADDRESS", "localhost:8476")
        if num_processes is None:
            num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(os.environ.get("PROCESS_ID", "0"))
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{num_processes} processes")
        return cls(coordinator=coordinator, num_processes=num_processes,
                   process_id=process_id)


def initialize_multihost(spec: MultiHostSpec | None = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> MultiHostSpec:
    """Join the process group at ``tcp://<coordinator>`` with the spec's
    world size and rank (a no-op for one process): NCCL when ``device``
    (default ``CONFIG.device``) is a CUDA device, gloo for the CPU."""
    spec = spec or MultiHostSpec.from_env()
    if spec.num_processes > 1 and not dist.is_initialized():
        dev = mesh_device(device, spec.process_id)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{spec.coordinator}",
            world_size=spec.num_processes, rank=spec.process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    return spec


def amp_axis_split(n_devices: int, n_hosts: int,
                   devices_per_host: int | None = None
                   ) -> tuple[int, int]:
    """Factor a 1-D amplitude mesh into (slow, fast) axis sizes: the host
    factor first, so the most significant shard bits (low-index qubits)
    map to the slowest links."""
    if n_devices % n_hosts:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"{n_hosts} hosts")
    per_host = devices_per_host or n_devices // n_hosts
    if n_hosts * per_host != n_devices:
        raise ValueError("hosts x devices_per_host != n_devices")
    for v in (n_hosts, per_host):
        if v & (v - 1):
            raise ValueError(f"mesh factors must be powers of 2, got {v}")
    return n_hosts, per_host


def group_rank_world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_multihost_mesh(axis_name: str = AMP_AXIS,
                        n_devices: int | None = None,
                        device=None) -> ShardMesh:
    """1-D amplitude mesh over every rank of the process group, rank-major
    (shard bit k crosses ranks iff k < log2(ranks)): ``n_devices``
    (default one per rank) split evenly over the ranks, each rank's shards
    on its ``device`` (default ``CONFIG.device``; ``"cuda"`` is GPU
    ``rank`` modulo the GPUs)."""
    rank, world = group_rank_world()
    n = world if n_devices is None else int(n_devices)
    if n & (n - 1) or n < world or n % world:
        raise ValueError(f"n_devices must be a power of 2 and a multiple "
                         f"of the {world} ranks, got {n}")
    return ShardMesh((axis_name,), (n,), n // world,
                     mesh_device(device, rank), rank, world)
