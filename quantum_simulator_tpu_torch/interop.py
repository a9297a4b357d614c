"""Carry data built by the JAX package, as NumPy, into the port's layout.

``quantum_simulator_tpu.ops.plan.build_group_operands(..., xp=np)``
returns its complex operators in the blocked ``[[re, -im], [im, re]]``
form that feeds the TPU's matrix unit. The port keeps the two planes
``(re, im)`` instead (``ops/plan.build_group_operands``). With these
converters a test feeds identical operators to both executors;
``density_result_from_numpy`` carries a density matrix across the same
way, ``tableau_from_numpy`` a stabilizer tableau,
``mps_state_from_numpy`` a matrix-product state and
``distributed_state_from_numpy`` a state onto a shard mesh. This module
imports neither JAX nor the JAX package: it takes plain arrays. (The
counterpart of the JAX package's ``interop.py``, the OpenQASM 2.0 import /
export, is ``qasm.py``.)
"""

from __future__ import annotations

import numpy as np
import torch


def _planes(blocked, axis: int = 0) -> np.ndarray:
    """Blocked (..., 2[c], 2[d], ...) at ``axis`` -> (re, im) planes: the
    d = 0 column holds (re, im)."""
    return np.ascontiguousarray(
        np.take(np.asarray(blocked, dtype=np.float32), 0, axis=axis + 1))


def operands_from_numpy(jax_operands):
    """The JAX package's operand 5-tuple (NumPy mode) -> the port's."""
    axis_stacks, cross_ops, diag_ops, prod_ops, bitpair_ops = jax_operands
    return ([_planes(a, axis=1) for a in axis_stacks],
            [_planes(c) for c in cross_ops],
            [_planes(d) for d in diag_ops],
            [(tuple(np.asarray(m, dtype=np.float32) for m in facs),
              float(cre), float(cim)) for facs, cre, cim in prod_ops],
            [None if b is None else _planes(b) for b in bitpair_ops])


def params_from_numpy(initial_params) -> np.ndarray:
    """A parameter vector (any array-like) -> the port's float64 vector."""
    return np.asarray(initial_params, dtype=np.float64).reshape(-1)


def density_result_from_numpy(rho, device=None):
    """A ``(2^n, 2^n)`` density matrix as a NumPy array (for instance the
    JAX package's ``DensityMatrixResult.rho``) -> the port's
    ``DensityMatrixResult`` on ``device`` (default ``CONFIG.device``), for
    ``LindbladSimulator.evolve(initial=...)`` and the tests."""
    from .config import CONFIG
    from .density import DensityMatrixResult

    arr = np.asarray(rho, dtype=np.complex128)
    n = arr.shape[0].bit_length() - 1 if arr.ndim == 2 else -1
    if n < 1 or arr.shape != (1 << n, 1 << n):
        raise ValueError(f"expected a (2^n, 2^n) matrix, got {arr.shape}")
    return DensityMatrixResult(
        num_qubits=n,
        device_rho=torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device or CONFIG.device, dtype=CONFIG.dtype))


def tableau_from_numpy(x, z, r, device=None):
    """A CHP tableau as NumPy arrays (for instance the JAX package's
    ``Tableau``: ``(2n, n)`` x and z, ``(2n,)`` r, int32 0/1, or a batch
    of them) -> the port's ``clifford.Tableau`` (int8) on ``device``
    (default ``CONFIG.device``)."""
    from .clifford import Tableau
    from .config import CONFIG

    x, z, r = (np.asarray(a) for a in (x, z, r))
    if x.shape != z.shape or x.shape[-2] != 2 * x.shape[-1] \
            or r.shape != x.shape[:-1]:
        raise ValueError(f"expected (..., 2n, n) x and z and (..., 2n) r, "
                         f"got {x.shape}, {z.shape}, {r.shape}")
    return Tableau(*(torch.from_numpy(np.ascontiguousarray(a & 1).astype(
        np.int8)).to(device or CONFIG.device) for a in (x, z, r)))


def mps_state_from_numpy(tensors, num_qubits: int, chi: int,
                         truncation_weight: float = 0.0, device=None):
    """An MPS as NumPy site tensors (for instance the JAX package's
    ``MPSState.tensors``, each ``(l, 2, r)``, centre at site 0) -> the
    port's ``mps.MPSState`` on ``device`` (default ``CONFIG.device``), in
    ``CONFIG.dtype``."""
    from .config import CONFIG
    from .mps import MPSState

    arrs = [np.asarray(t) for t in tensors]
    if len(arrs) != num_qubits or any(
            a.ndim != 3 or a.shape[1] != 2 for a in arrs):
        raise ValueError(f"expected {num_qubits} (l, 2, r) site tensors")
    if any(a.shape[2] != b.shape[0] for a, b in zip(arrs, arrs[1:])) \
            or arrs[0].shape[0] != 1 or arrs[-1].shape[2] != 1:
        raise ValueError("site tensors' bonds do not chain (edge bonds 1)")
    return MPSState(
        tuple(torch.from_numpy(np.ascontiguousarray(a, np.complex128)).to(
            device=device or CONFIG.device, dtype=CONFIG.dtype)
            for a in arrs),
        int(num_qubits), int(chi), float(truncation_weight))


def distributed_state_from_numpy(array, mesh):
    """A ``(2^n,)`` complex state as a NumPy array (for instance the JAX
    package's ``DistributedStateVector.data``) -> the port's
    ``parallel.DistributedStateVector`` on ``mesh``: this rank's shards,
    planar float32 on the mesh's device."""
    from .parallel.distributed import DistributedStateVector, check_mesh

    mesh = check_mesh(mesh)
    arr = np.asarray(array, dtype=np.complex128).reshape(-1)
    n = arr.size.bit_length() - 1
    if arr.size != 1 << n or arr.size < 2 * mesh.n_devices:
        raise ValueError(f"expected 2^n amplitudes with at least 2 per "
                         f"shard of {mesh.n_devices}, got {arr.size}")
    blocks = arr.reshape(mesh.n_devices, -1)[
        mesh.first_shard:mesh.first_shard + mesh.local]
    planar = np.stack([blocks.real, blocks.imag], axis=1).astype(np.float32)
    return DistributedStateVector(torch.from_numpy(planar).to(mesh.device),
                                  n, mesh)
