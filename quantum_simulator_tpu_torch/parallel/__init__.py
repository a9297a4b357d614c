"""Mesh-sharded statevector simulation on PyTorch: the port of
``quantum_simulator_tpu/parallel`` (W ranks of a ``torch.distributed``
group, L shards stacked on each rank's device)."""

from .distributed import (
    DistributedSimulator,
    DistributedStateVector,
    ShardMesh,
    local_forward_body,
    make_mesh,
    sharded_forward_fn,
)
from .multihost import (
    MultiHostSpec,
    amp_axis_split,
    initialize_multihost,
    make_multihost_mesh,
)
from .vqe import ShardedVQEStep, VQEState, make_vqe_mesh, sharded_vqe_step

__all__ = [
    "DistributedSimulator",
    "DistributedStateVector",
    "MultiHostSpec",
    "ShardMesh",
    "ShardedVQEStep",
    "VQEState",
    "amp_axis_split",
    "initialize_multihost",
    "make_multihost_mesh",
    "local_forward_body",
    "make_mesh",
    "make_vqe_mesh",
    "sharded_forward_fn",
    "sharded_vqe_step",
]
