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
"""

from __future__ import annotations

import contextlib
import dataclasses

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


CONFIG = EngineConfig()


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
