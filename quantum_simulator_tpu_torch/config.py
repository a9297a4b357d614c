"""Global engine configuration for the PyTorch / CUDA port.

Counterpart of ``quantum_simulator_tpu/config.py:26-65`` (``EngineConfig``).
The port runs eagerly, so it has no compile cache and no Pallas switch
(``pallas_steps``): on a CUDA tensor every dense and cross group-plan step
launches its hand-written kernel (``ops/cuda_exec.py``).

Precision policy: the JAX package passes ``Precision.HIGHEST`` on every
contraction. The port's form of that rule is to keep TF32 off for every
float32 matrix product and convolution PyTorch runs, set here at import.
"""

from __future__ import annotations

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
