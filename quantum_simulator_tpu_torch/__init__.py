"""quantum_simulator_tpu_torch — the PyTorch / CUDA port of quantum_simulator_tpu.

The JAX package ``quantum_simulator_tpu`` is the reference. This package
runs its ideal ``Simulator.run`` path on an NVIDIA H100: the same host
planner and NumPy operand build, a torch executor, and hand-written CUDA
kernels (``csrc/``) for every dense and cross group-plan step. It imports
torch and NumPy, never JAX and never the JAX package.
"""

from .circuit import GateInstance, QuantumCircuit
from .config import CONFIG, EngineConfig
from .gates import GateDefinition, GateType
from .measurement import MeasurementBasis, MeasurementEngine
from .registry import GateRegistry
from .simulator import SimulationResult, Simulator
from .state import StateVector

__version__ = "0.1.0"

__all__ = [
    "CONFIG",
    "EngineConfig",
    "GateDefinition",
    "GateInstance",
    "GateRegistry",
    "GateType",
    "MeasurementBasis",
    "MeasurementEngine",
    "QuantumCircuit",
    "SimulationResult",
    "Simulator",
    "StateVector",
]
