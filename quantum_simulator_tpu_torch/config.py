"""Global engine configuration for the PyTorch / CUDA port.

Counterpart of ``quantum_simulator_tpu/config.py:26-65`` (``EngineConfig``).
The port runs eagerly, so it has no compile cache and no Pallas switch
(``pallas_steps``): on a CUDA tensor every dense and cross group-plan step
launches its hand-written kernel (``ops/cuda_exec.py``).

Precision policy: the JAX package passes ``Precision.HIGHEST`` on every
contraction (on the TPU a multi-pass split of fp32 onto the bf16 matrix
unit). The port's form of that rule: single-pass TF32 stays off for every
float32 matrix product and convolution PyTorch runs (the flags below, set
at import), and the hand-written kernels reach the tensor cores only
through a 3-pass TF32 split (hi/lo parts, three products summed in fp32),
held to float64 as tightly as an fp32 product (``csrc/fiber_matmul.cuh``).

Verification mode (``enable_complex128``, ``config.py:133-155`` of the JAX
package): every family then computes in float64 planes, complex128
amplitudes: the statevector family (``Simulator`` and the executors under
it: the group plan, its operands, the per-gate and trajectory bodies, and
from n = 30 on the chunked large-state path of ``ops/bigstate.py`` and
``ops/bigtraj.py`` with vec(rho) at 2n = 30) up to
``COMPLEX128_MAX_QUBITS`` (31), the shard mesh (``parallel/``: the
per-gate and grouped bodies, the sampler, the reductions, the checkpoints
and the sharded VQE step) up to that cap plus log2 of its ranks, and the
MPS family (``MPSSimulator``, its cost function, DMRG, the MPS Lindblad
trajectories and the correlator). Every dense and cross step of a float64
state on the card launches the float64 kernels
(``csrc/fiber_matmul_f64.cu``: FP64 tensor cores and FP64 FMA, no TF32 in
any form). Wider statevectors raise under the mode (``require_width``): a
float64 planar state is 64 GiB at n = 32, and the chunked path holds up to
1.75x its state on an 80 GB card. Draws may stay float32 (Gumbel rows,
uniforms); what they are compared with follows the state. Torch needs no
x64 switch.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class EngineConfig:
    """Mutable global knobs for the simulation engine."""

    # Dtype of the complex statevector a run returns.
    dtype: torch.dtype = torch.complex64
    # Device the simulator runs on; ``Simulator(device=...)`` overrides it.
    device: str = "cuda"
    # Cap on amplitude simulation (2**32 planar f32 amplitudes = 32 GiB).
    max_qubits: int = 32
    # Structural cap on the circuit IR itself.
    max_circuit_qubits: int = 4096

    @property
    def real_dtype(self) -> torch.dtype:
        """Dtype of the executor's (re, im) planes and real states."""
        return torch.float64 if self.dtype == torch.complex128 \
            else torch.float32

    @property
    def np_complex(self):
        """NumPy mirror of ``dtype`` for host-built operands."""
        return np.complex128 if self.dtype == torch.complex128 \
            else np.complex64

    @property
    def np_real(self):
        """NumPy mirror of ``real_dtype``."""
        return np.float64 if self.dtype == torch.complex128 else np.float32


CONFIG = EngineConfig()

# Widest statevector under ``enable_complex128``: a float64 planar state
# is 32 GiB at n = 31 (56 GiB at the chunked path's 1.75x peak) and
# 64 GiB at n = 32, past an 80 GB card with any temporary beside it.
COMPLEX128_MAX_QUBITS = 31


def statevector_dtype() -> torch.dtype:
    return CONFIG.dtype


def np_dtype():
    """NumPy dtype mirror for host-side reference computations."""
    return np.complex128


def enable_complex128() -> None:
    """Switch the engine to complex128 verification mode: the statevector
    family at n <= ``COMPLEX128_MAX_QUBITS``, the shard mesh and the MPS
    family compute in float64 on the CPU and on the card (see the module
    docstring). Call before building operands or states that should carry
    the new precision."""
    CONFIG.dtype = torch.complex128


def enable_complex64() -> None:
    """Back to the default complex64 engine."""
    CONFIG.dtype = torch.complex64


def require_width(num_qubits: int, what: str, ranks: int = 1) -> None:
    """Raise under ``enable_complex128`` for a statevector of more than
    ``COMPLEX128_MAX_QUBITS`` qubits per card (``what`` names the path):
    its float64 planar state does not fit the card beside the chunked
    path's temporaries. A mesh of ``ranks`` ranks (a power of 2, one card
    each) holds 2^n / ranks amplitudes a card, so its cap is log2(ranks)
    higher."""
    cap = COMPLEX128_MAX_QUBITS + max(0, ranks.bit_length() - 1)
    if CONFIG.dtype == torch.complex128 and num_qubits > cap:
        gib = (16 << num_qubits) / 2**30
        per = f" ({gib / ranks:.0f} GiB a card on {ranks} ranks)" \
            if ranks > 1 else ""
        raise ValueError(
            f"{what}: a {num_qubits}-qubit float64 planar state is "
            f"{gib:.0f} GiB{per}; complex128 verification mode "
            f"(enable_complex128) covers statevectors of n <= {cap} "
            f"qubits (call enable_complex64 first)")


def pinned_device(device=None) -> torch.device:
    """``device`` (default ``CONFIG.device``) with its CUDA index fixed.

    A bare ``"cuda"`` names the calling thread's current device, and every
    thread starts on device 0: the front ends resolve it where they are
    built and make it current on their worker threads (``device_scope``),
    so work never moves to another card with the thread that runs it."""
    dev = torch.device(device or CONFIG.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_scope(device: torch.device):
    """Make a CUDA ``device`` current on the calling thread (a no-op for
    any other device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
