"""quantum_simulator_tpu_torch — the PyTorch / CUDA port of quantum_simulator_tpu.

The JAX package ``quantum_simulator_tpu`` is the reference. This package
runs its ``Simulator`` paths on an NVIDIA H100, ideal, noisy and monitored,
up to 32 qubits (from n = 30 on with planar results): the same
host planner and NumPy operand build, a torch executor, noisy
trajectories batched on the device (``noise``, ``ops/unitary_traj``,
``ops/monomial_traj``), and hand-written CUDA kernels (``csrc/``) for
every dense and cross group-plan step. The variational path
(``optimizer``, ``analysis.StateAnalysis``, ``models``) runs parameter
batches through the same kernels. The exact open-system path
(``density.DensityMatrixSimulator``: dense rho, and the vec(rho)
superoperator program through the same executor and kernels;
``lindblad.LindbladSimulator``) and the Trotter circuits of
``models/trotter.py`` complete it, with OpenQASM 2.0 import / export in
``qasm.py``. The analysis layer sits on top: the circuit debugger with
batched noise attribution (``debugger``), quantum volume at scale
(``analysis.BenchmarkAnalysis``), classical shadows (``shadows``), error
mitigation (``mitigation``: ZNE, PEC, readout inversion), circuit
comparison, reference states, algorithm templates and the acceptance
benchmark suite. The bit engines run beyond the statevector wall: the
batched Clifford tableau (``clifford``), the statevector and Pauli-frame
QEC engines (``qec``, ``qec_frame``), circuit-level QEC with its detector
error model (``qec_circuit``, ``qec_dem``) and the union-find matcher
(``qec_matching``) over the port's own host C (``native``). The MPS
family runs arbitrary gates past the 2^n wall: ``mps.MPSSimulator``
(ideal, noisy, monitored and variational batches of MPS), DMRG
(``dmrg``), MPS Lindblad trajectories (``lindblad_mps``), two-point
correlators (``correlators``) and MPS shadows. The parallel layer
(``parallel``) shards a state over a mesh of ``torch.distributed`` ranks,
each holding a stack of shards on its device. The host front ends sit
on top of all of it: the Live Bridge (``bridge``: a JSON-over-TCP server
and its client), the controller layer (``controller``: undoable edits and
a simulation worker thread), the panels' view models (``viewmodels``), the
circuit renderer (``render``, headless matplotlib) and
``utils.seeding.SeedManager``; every entry point among them that simulates
takes ``device=`` (default ``CONFIG.device``, the card). It imports torch
and NumPy, never JAX and never the JAX package.
"""

from .analysis import StateAnalysis
from .circuit import GateInstance, QuantumCircuit
from .clifford import CliffordSimulator
from .config import CONFIG, EngineConfig
from .density import DensityMatrixResult, DensityMatrixSimulator
from .dmrg import DMRGResult, dmrg_excited_states, dmrg_ground_state
from .gates import GateDefinition, GateType
from .lindblad import LindbladResult, LindbladSimulator
from .measurement import MeasurementBasis, MeasurementEngine
from .mitigation import (PECResult, ReadoutMitigator, ZNEResult,
                         fold_circuit, pec_expectation,
                         quasi_inverse_pauli, richardson_extrapolate,
                         zne_expectation)
from .mps import MPSSimulator, MPSState
from .noise import (AmplitudeDampingNoise, BitFlipNoise, DepolarizingNoise,
                    NoiseChannel, NoiseModel, PhaseFlipNoise, ReadoutError,
                    ThermalRelaxationNoise, TwoQubitDepolarizingNoise)
from .optimizer import (BarrenPlateauAnalysis, CircuitOptimizer,
                        CostFunction, DeviceCost, GradientEstimator,
                        MPSParameterizedConfig, MultiStartResult,
                        OptimizationResult, ParameterBinding,
                        ParameterizedCircuitConfig)
from .ops.bigstate import MarginalStateSummary, PlanarStateVector
from .qasm import from_qasm, to_qasm
from .registry import GateRegistry
from .shadows import ShadowData, collect_shadows
from .simulator import SimulationResult, Simulator
from .state import StateVector

__version__ = "0.1.0"

__all__ = [
    "AmplitudeDampingNoise",
    "BarrenPlateauAnalysis",
    "BitFlipNoise",
    "CONFIG",
    "CircuitOptimizer",
    "CliffordSimulator",
    "CostFunction",
    "DensityMatrixResult",
    "DMRGResult",
    "DensityMatrixSimulator",
    "DepolarizingNoise",
    "DeviceCost",
    "EngineConfig",
    "GateDefinition",
    "GateInstance",
    "GateRegistry",
    "GateType",
    "GradientEstimator",
    "LindbladResult",
    "LindbladSimulator",
    "MPSParameterizedConfig",
    "MPSSimulator",
    "MPSState",
    "MarginalStateSummary",
    "MeasurementBasis",
    "MeasurementEngine",
    "MultiStartResult",
    "NoiseChannel",
    "NoiseModel",
    "OptimizationResult",
    "PECResult",
    "ParameterBinding",
    "ParameterizedCircuitConfig",
    "PhaseFlipNoise",
    "PlanarStateVector",
    "QuantumCircuit",
    "ReadoutError",
    "ReadoutMitigator",
    "ShadowData",
    "SimulationResult",
    "Simulator",
    "StateAnalysis",
    "StateVector",
    "ThermalRelaxationNoise",
    "TwoQubitDepolarizingNoise",
    "ZNEResult",
    "collect_shadows",
    "dmrg_excited_states",
    "dmrg_ground_state",
    "fold_circuit",
    "from_qasm",
    "pec_expectation",
    "quasi_inverse_pauli",
    "richardson_extrapolate",
    "to_qasm",
    "zne_expectation",
]
