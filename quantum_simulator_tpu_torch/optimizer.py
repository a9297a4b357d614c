"""Variational optimization: VQE/QAOA cost functions, gradients, Adam.

Counterpart of ``quantum_simulator_tpu/optimizer.py:54-834``: the same
parameter bindings (``Gate[i].pj``), cost factories, parameter-shift
(+-s with 1/(2 sin s)) and central finite-difference gradients, Adam with
bias correction, convergence on |dcost| < tol, best-iterate selection,
``request_stop``, a batched multi-start and the barren-plateau analyses.

Where the JAX package compiles, the port runs batches:

* **Batched costs** (parameter shift, finite differences, plateau
  sampling): JAX vmaps the per-gate body; the port runs the batched group
  executor (``ops/plan.group_batched_forward``) on every chunk of parameter
  rows, so each dense and cross step of a chunk is one launch of
  ``dense_axis`` / ``cross_bit_axis`` with one operator per row. Chunks are
  cut to ``simulator.TRAJECTORY_MEMORY_BYTES`` (``param_rows_per_batch``).
  At n >= 30, and for costs or gates with no torch form, each row is one
  ``Simulator.run``, as the JAX package's huge path does.
* **Autodiff** and **multi_start** differentiate the per-gate torch body
  (``ops/program.forward_body``) with ``torch.autograd``, as the JAX
  package differentiates its per-gate body with ``jax.value_and_grad``;
  no kernel is involved. ``multi_start`` replaces ``lax.scan`` + ``vmap``
  with a loop over iterations on a batch of starts, in float32 (float64
  under ``config.enable_complex128``) on the device.
* **MPS configs** (``MPSParameterizedConfig``): the rows run as one
  batch of MPS through ``mps.build_batched_cost_fn`` (parameter shift
  and finite differences only; reverse mode is refused, as in JAX).
* **Hamiltonian costs**: JAX applies every Pauli string one qubit at a
  time; the port evaluates the same sum by flip mask
  (``_pauli_terms_device``): one state-sized product per set of flipped
  qubits and one marginal per support, contracted with each term's
  per-qubit phases, so a Heisenberg chain reads the batch a few times per
  bond instead of a few times per term and qubit.

Cost functions carry a host callable ``(StateVector) -> float`` and a
torch ``device_fn(psi, n)`` that maps ``(..., 2^n)`` states to ``(...)``
costs. Every entry point takes ``device`` (default ``CONFIG.device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .analysis import StateAnalysis
from .circuit import QuantumCircuit
from .config import CONFIG
from .gates import I_MATRIX, X_MATRIX, Y_MATRIX, Z_MATRIX
from .ops import program as prog
from .ops.apply import apply_gate
from .ops.bigstate import HUGE_MIN_QUBITS
from .ops.plan import group_batched_forward
from .registry import GateRegistry
from .simulator import Simulator, param_rows_per_batch
from .state import StateVector

_PAULI_NP = {"I": I_MATRIX, "X": X_MATRIX, "Y": Y_MATRIX, "Z": Z_MATRIX}

# From the huge threshold on costs take one row at a time through
# Simulator.run (whose state is then a PlanarStateVector), and reverse
# mode is refused (several whole states would be resident).
HUGE_QUBITS = HUGE_MIN_QUBITS


# ---------------------------------------------------------------------------
# Parameter binding
# ---------------------------------------------------------------------------

@dataclass
class ParameterBinding:
    """Maps an optimization variable to a gate parameter slot."""

    gate_index: int
    param_index: int
    name: str = ""


class ParameterizedCircuitConfig:
    """A circuit plus the list of its tunable parameters."""

    def __init__(self, circuit: QuantumCircuit,
                 bindings: list[ParameterBinding]):
        self._circuit = circuit
        self._bindings = bindings

    @property
    def circuit(self) -> QuantumCircuit:
        return self._circuit

    @property
    def bindings(self) -> list[ParameterBinding]:
        return self._bindings

    @property
    def num_params(self) -> int:
        return len(self._bindings)

    def get_values(self) -> np.ndarray:
        vals = np.zeros(self.num_params)
        for i, b in enumerate(self._bindings):
            vals[i] = self._circuit.gates[b.gate_index].params[b.param_index]
        return vals

    def bind_values(self, values: np.ndarray) -> QuantumCircuit:
        """Copy of the circuit with the bound parameters set (the batched
        path scatters values into the program's parameter rows instead)."""
        qc = self._circuit.copy()
        for i, b in enumerate(self._bindings):
            qc.gates[b.gate_index].params[b.param_index] = float(values[i])
        return qc

    @classmethod
    def auto_detect(cls, circuit: QuantumCircuit
                    ) -> "ParameterizedCircuitConfig":
        """Bind every parameter of every registered parameterized gate,
        named ``Gate[i].pj``."""
        registry = GateRegistry.instance()
        bindings = []
        for gi, gate in enumerate(circuit.gates):
            try:
                gate_def = registry.get(gate.gate_name)
            except KeyError:
                continue
            for pi in range(gate_def.num_params):
                bindings.append(ParameterBinding(
                    gi, pi, f"{gate.gate_name}[{gi}].p{pi}"))
        return cls(circuit, bindings)

    def compiled(self):
        """(program, offsets): offsets[i] is the program-parameter
        position of binding i, or None if any bound gate was baked."""
        program = prog.compile_circuit(self._circuit)
        offsets = []
        for b in self._bindings:
            off = program.param_offset_for(b.gate_index, b.param_index)
            if off is None:
                return program, None
            offsets.append(off)
        return program, np.asarray(offsets, dtype=np.int64)


class MPSParameterizedConfig(ParameterizedCircuitConfig):
    """A parameterized circuit whose cost evaluations run on the MPS
    engine (``mps.build_batched_cost_fn``) instead of a dense 2^n state:
    variational optimization at 50+ qubits
    (``quantum_simulator_tpu/optimizer.py:128-164``).

    Works with every ``CircuitOptimizer`` surface that evaluates costs in
    batch: ``run`` / ``step`` with ``gradient_method`` "parameter_shift"
    or "finite_difference", and the barren-plateau detectors. The cost
    must be Hamiltonian-shaped (``CostFunction.vqe_hamiltonian`` /
    ``qaoa_maxcut`` / ``z_expectation`` carry their Pauli terms).
    Reverse-mode paths ("autodiff", ``multi_start``) are refused:
    differentiating through truncated SVDs divides by Schmidt-value gaps
    that circuits started from product states routinely make zero."""

    engine = "mps"

    def __init__(self, circuit: QuantumCircuit,
                 bindings: list[ParameterBinding], chi: int = 64):
        super().__init__(circuit, bindings)
        if chi < 1:
            raise ValueError("chi must be >= 1")
        self.chi = chi

    @classmethod
    def auto_detect(cls, circuit: QuantumCircuit,
                    chi: int = 64) -> "MPSParameterizedConfig":
        base = ParameterizedCircuitConfig.auto_detect(circuit)
        return cls(base.circuit, base.bindings, chi=chi)

    def compiled(self):
        raise ValueError(
            "MPSParameterizedConfig has no dense compiled program; use "
            "gradient_method='parameter_shift' or 'finite_difference' "
            "(autodiff/multi_start need the statevector engine)")


# ---------------------------------------------------------------------------
# Cost functions (host callable + torch device body)
# ---------------------------------------------------------------------------

class DeviceCost:
    """A cost with a host API (StateVector -> float) and a torch
    ``device_fn(psi, num_qubits)`` mapping ``(..., 2^n)`` complex states
    to ``(...)`` real costs. Hamiltonian-shaped costs also carry their
    ``(coeff, pauli_string, qubits)`` ``terms`` and a ``constant``."""

    def __init__(self, host_fn: Callable[[StateVector], float],
                 device_fn: Callable | None = None,
                 key: tuple | None = None,
                 terms: list | None = None,
                 constant: float = 0.0):
        self._host_fn = host_fn
        self.device_fn = device_fn
        self.terms = terms
        self.constant = float(constant)
        self.key = key

    def __call__(self, state: StateVector) -> float:
        return self._host_fn(state)


def _vdot_real(psi: torch.Tensor, opsi: torch.Tensor) -> torch.Tensor:
    """Re <psi|opsi> over the last axis."""
    return torch.sum(psi.conj() * opsi, dim=-1).real


def _expose_bits(n: int, qubits: tuple[int, ...]):
    """A shape of the 2^n axis with each of the sorted ``qubits`` as a
    dim of 2 (qubit 0 the most significant bit) between merged runs of
    the others, and the indices of those dims."""
    shape: list[int] = []
    dims: list[int] = []
    prev = -1
    for q in qubits:
        shape.append(1 << (q - prev - 1))
        dims.append(len(shape))
        shape.append(2)
        prev = q
    shape.append(1 << (n - 1 - prev))
    return shape, dims


def _pauli_terms_device(terms):
    """``device_fn`` of sum_i c_i <P_i> (``optimizer.py:279-284``). A
    Pauli string maps |x> to v(x_S) |x ^ m> (m: its X/Y qubits, v: a
    phase of its support S), so <P> = sum_x v(x_S) t_m(x) with t_m(x) =
    conj(psi[x ^ m]) psi[x]. The phase is a product of one 2-vector per
    qubit of S, so the marginal of t_m on S is contracted with those
    vectors one qubit at a time, for a string of any width. Each flip
    mask m costs one state-sized t_m, shared by its terms (the Z strings
    share |psi|^2); each support one marginal of t_m, contracted with the
    vectors of all its terms at once (the coefficient folded into the
    first). The sums are reductions in the state's real dtype, as in the
    per-term application. A qubit named twice in a string takes the product of
    its Paulis in the order they apply, as there."""
    ident = 0.0
    groups: dict[tuple, list[np.ndarray]] = {}   # (m, S) -> (k, 2) each
    for coeff, pauli_str, qubits in terms:
        per_qubit: dict[int, np.ndarray] = {}
        for p, q in zip(pauli_str, qubits):
            if p != "I":
                per_qubit[int(q)] = _PAULI_NP[p] @ per_qubit.get(
                    int(q), np.eye(2))
        support = tuple(sorted(per_qubit))
        if not support:
            ident += coeff
            continue
        flips = tuple(q for q in support if abs(per_qubit[q][0, 0]) < 0.5)
        # column b of M_q has its entry in row b ^ f
        f = np.array([[per_qubit[q][int(q in flips), 0],
                       per_qubit[q][1 - int(q in flips), 1]]
                      for q in support])
        f[0] *= coeff
        groups.setdefault((flips, support), []).append(f)
    host = {k: torch.from_numpy(np.stack(v, axis=-1).astype(np.complex128))
            for k, v in groups.items()}           # (k, 2, terms)
    on_device: dict = {}   # the factors by device and dtype, copied once

    def device(psi, n):
        fs = on_device.get((psi.device, psi.dtype))
        if fs is None:
            fs = on_device[(psi.device, psi.dtype)] = {
                k: v.to(device=psi.device, dtype=psi.dtype)
                for k, v in host.items()}
        lead = tuple(psi.shape[:-1])
        total = torch.zeros(lead, dtype=psi.real.dtype, device=psi.device)
        if ident:
            total = total + ident * psi.abs().square().sum(-1)
        t, t_flips = None, None
        for (flips, support), f in sorted(fs.items()):
            if flips != t_flips:
                if flips:
                    shape, dims = _expose_bits(n, flips)
                    x = psi.reshape(lead + tuple(shape))
                    t = x.flip([len(lead) + d for d in dims]).conj() * x
                else:
                    t = psi.abs().square()
                t_flips = flips
            shape, dims = _expose_bits(n, support)
            env = [len(lead) + i for i in range(len(shape))
                   if i not in dims]
            y = t.reshape(lead + tuple(shape)).sum(env).reshape(lead + (-1, 1))
            for j in range(len(support) - 1, -1, -1):   # last qubit first
                y = (y.reshape(lead + (-1, 2, y.shape[-1])) * f[j]).sum(-2)
            total = total + y.sum((-2, -1)).real
        del t
        return total

    return device


class CostFunction:
    """Factories building DeviceCost objects (reference API shape)."""

    @staticmethod
    def expectation_value(observable: np.ndarray,
                          target_qubits: list[int]) -> DeviceCost:
        obs_np = np.asarray(observable, dtype=np.complex128)
        targets = tuple(int(q) for q in target_qubits)

        def host(state: StateVector) -> float:
            return float(np.real(StateAnalysis.expectation_value(
                state, obs_np, list(targets))))

        def device(psi, n):
            return _vdot_real(psi, apply_gate(psi, obs_np, targets, n))

        return DeviceCost(host, device,
                          key=("expval", targets, obs_np.tobytes()))

    @staticmethod
    def state_fidelity(target_state: np.ndarray) -> DeviceCost:
        """Cost = 1 - |<target|psi>|^2."""
        target_np = np.asarray(target_state, dtype=np.complex128)

        def host(state: StateVector) -> float:
            return 1.0 - StateAnalysis.state_fidelity(target_np, state.data)

        def device(psi, n):
            target = torch.from_numpy(target_np).to(psi.device, psi.dtype)
            return 1.0 - torch.sum(target.conj() * psi,
                                   dim=-1).abs().square()

        return DeviceCost(host, device, key=("fid", target_np.tobytes()))

    @staticmethod
    def z_expectation(qubit: int) -> DeviceCost:
        return CostFunction.vqe_hamiltonian([(1.0, "Z", [qubit])])

    @staticmethod
    def vqe_hamiltonian(terms: list[tuple[float, str, list[int]]]
                        ) -> DeviceCost:
        """Cost = sum_i c_i <P_i> for Pauli strings P_i."""
        terms = [(float(c), str(p).upper(), [int(q) for q in qs])
                 for c, p, qs in terms]

        def host(state) -> float:
            total = 0.0
            for coeff, pauli_str, qubits in terms:
                live = [(p, q) for p, q in zip(pauli_str, qubits)
                        if p != "I"]
                if not live:
                    total += coeff
                    continue
                total += coeff * StateAnalysis.pauli_string_expectation(
                    state, [q for _, q in live],
                    "".join(p for p, _ in live))
            return total

        key = ("vqe", tuple((c, p, tuple(q)) for c, p, q in terms))
        return DeviceCost(host, _pauli_terms_device(terms), key=key,
                          terms=terms)

    @staticmethod
    def qaoa_maxcut(edges: list[tuple[int, int]]) -> DeviceCost:
        """C = sum_{(i,j) in E} (1 - <Z_i Z_j>) / 2, returned as the
        reference does (maximize the cut = minimize -C)."""
        edges = [(int(i), int(j)) for i, j in edges]
        terms = [(-0.5, "ZZ", [i, j]) for i, j in edges]
        zz_part = CostFunction.vqe_hamiltonian(terms)

        def host(state: StateVector) -> float:
            return len(edges) * 0.5 + zz_part(state)

        def device(psi, n):
            return len(edges) * 0.5 + zz_part.device_fn(psi, n)

        return DeviceCost(host, device, key=("maxcut", tuple(edges)),
                          terms=terms, constant=len(edges) * 0.5)


# ---------------------------------------------------------------------------
# Batched evaluation plumbing
# ---------------------------------------------------------------------------

def _param_rows(program, offsets: np.ndarray, values: torch.Tensor
                ) -> torch.Tensor:
    """(B, P) program parameters: the program's own values with the bound
    positions set from ``values`` (B, K), in ``values``' dtype and with
    its autograd graph (``optimizer.py:325``)."""
    base = torch.as_tensor(program.initial_params, dtype=values.dtype,
                           device=values.device)
    rows = base.expand(values.shape[0], -1)
    if not offsets.size:
        return rows
    off = torch.as_tensor(offsets, device=values.device)
    return rows.index_copy(1, off, values)


def _device_costs(program, cost: DeviceCost, offsets: np.ndarray,
                  values_batch: np.ndarray, device,
                  plain: bool = False) -> np.ndarray:
    """Costs at every row of ``values_batch`` through the batched group
    executor, chunk by chunk (``plain``: the kernels' twins)."""
    n = program.num_qubits
    values = torch.as_tensor(np.asarray(values_batch, dtype=CONFIG.np_real),
                             device=device)
    rows = param_rows_per_batch(program, values.shape[0])
    out = []
    for start in range(0, values.shape[0], rows):
        params = _param_rows(program, offsets, values[start:start + rows])
        psi = group_batched_forward(program, params, device, plain)
        out.append(cost.device_fn(psi, n))
        del psi
    return torch.cat(out).double().cpu().numpy()


def _shift_matrix(values: np.ndarray, shift: float) -> np.ndarray:
    """(2P, P) matrix of +-shift perturbed parameter vectors: rows [0..P)
    are +shift on param i, rows [P..2P) are -shift."""
    p = len(values)
    tiled = np.tile(values, (2 * p, 1))
    tiled[np.arange(p), np.arange(p)] += shift
    tiled[p + np.arange(p), np.arange(p)] -= shift
    return tiled


def _torch_form(program, offsets, cost_fn) -> bool:
    """Whether the batched executor and autograd can evaluate this cost:
    every bound parameter is a runtime one, every runtime-parameter gate
    has a torch builder, and the cost has a torch body."""
    return (offsets is not None and isinstance(cost_fn, DeviceCost)
            and cost_fn.device_fn is not None
            and all(op.torch_builder is not None for op in program.ops
                    if op.static_matrix is None and op.num_params > 0))


def _check_reverse_mode(config: ParameterizedCircuitConfig, cost_fn,
                        what: str):
    """(program, offsets) for a reverse-mode entry point, or ValueError
    (``optimizer.py:512-524, 712-720``)."""
    if config.circuit.num_qubits >= HUGE_QUBITS:
        raise ValueError(
            f"{what} cannot run on n >= {HUGE_QUBITS} circuits: reverse-mode "
            "residuals need several whole states resident at once "
            "(>= 2x8 GiB); use parameter_shift, which re-simulates")
    program, offsets = config.compiled()
    if not _torch_form(program, offsets, cost_fn):
        raise ValueError(
            f"{what} requires traceable gates and a DeviceCost")
    return program, offsets


class GradientEstimator:
    """Gradient estimation for parameterized circuits."""

    @staticmethod
    def _batched_costs(config: ParameterizedCircuitConfig, cost_fn,
                       values_batch: np.ndarray,
                       seed: int | None = None,
                       device=None) -> np.ndarray:
        """The cost at each row of ``values_batch``: through the batched
        group executor when the circuit and cost have a torch form, else
        one ``Simulator.run`` per row (n >= 30, custom gates, host-only
        costs). MPS-engine configs evaluate on the MPS variational path
        (no 2^n state exists to fall back to)."""
        device = device or CONFIG.device
        if getattr(config, "engine", None) == "mps":
            if not isinstance(cost_fn, DeviceCost) or cost_fn.terms is None:
                raise ValueError(
                    "the MPS engine evaluates Hamiltonian-shaped costs "
                    "only (CostFunction.vqe_hamiltonian / qaoa_maxcut / "
                    "z_expectation carry their Pauli terms; there is no "
                    "dense state for host-callable costs)")
            from . import mps
            fn = mps.build_batched_cost_fn(
                config.circuit, config.bindings, cost_fn.terms,
                config.chi, constant=cost_fn.constant, device=device)
            return fn(values_batch).double().cpu().numpy()
        if config.circuit.num_qubits < HUGE_QUBITS:
            program, offsets = config.compiled()
            if _torch_form(program, offsets, cost_fn):
                return _device_costs(program, cost_fn, offsets,
                                     values_batch, device)
        sim = Simulator(device=device)
        out = np.zeros(len(values_batch))
        for i, vals in enumerate(values_batch):
            state = sim.run(config.bind_values(vals), shots=0,
                            seed=seed).final_state
            out[i] = cost_fn(state)
            del state    # two n >= 30 states need not coexist
        return out

    @staticmethod
    def parameter_shift(config: ParameterizedCircuitConfig,
                        cost_fn, values: np.ndarray,
                        shift: float = np.pi / 2,
                        seed: int | None = None,
                        device=None) -> np.ndarray:
        """grad_i = [f(theta_i + s) - f(theta_i - s)] / (2 sin s); the 2P
        shifted circuits run as one batch."""
        p = len(values)
        if p == 0:
            return np.zeros(0)
        batch = _shift_matrix(np.asarray(values, dtype=np.float64), shift)
        costs = GradientEstimator._batched_costs(config, cost_fn, batch,
                                                 seed, device)
        return (costs[:p] - costs[p:]) / (2.0 * np.sin(shift))

    @staticmethod
    def finite_difference(config: ParameterizedCircuitConfig,
                          cost_fn, values: np.ndarray,
                          epsilon: float = 1e-4,
                          seed: int | None = None,
                          device=None) -> np.ndarray:
        """Central finite difference, batched like parameter_shift."""
        p = len(values)
        if p == 0:
            return np.zeros(0)
        batch = _shift_matrix(np.asarray(values, dtype=np.float64), epsilon)
        costs = GradientEstimator._batched_costs(config, cost_fn, batch,
                                                 seed, device)
        return (costs[:p] - costs[p:]) / (2 * epsilon)

    @staticmethod
    def autodiff(config: ParameterizedCircuitConfig, cost_fn: DeviceCost,
                 values: np.ndarray, device=None
                 ) -> tuple[float, np.ndarray]:
        """(cost, grad) by reverse mode through the per-gate torch body:
        exact, one forward and one backward pass, any torch-form gate."""
        program, offsets = _check_reverse_mode(config, cost_fn, "autodiff")
        device = device or CONFIG.device
        v = torch.tensor(np.asarray(values, dtype=CONFIG.np_real),
                         device=device, requires_grad=True)
        params = _param_rows(program, offsets, v[None])[0]
        c = cost_fn.device_fn(prog.forward_body(program, params),
                              program.num_qubits)
        (g,) = torch.autograd.grad(c, v, allow_unused=True)
        if g is None:      # no bound parameter
            g = torch.zeros_like(v)
        return float(c.detach()), g.double().cpu().numpy()


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class BarrenPlateauAnalysis:
    """Layer-wise barren plateau analysis result."""

    per_layer_variance: list[list[float]]
    per_layer_mean_variance: list[float]
    per_qubit_variance: list[float]
    depth_scaling: list[tuple[int, float]]
    overall_mean_variance: float
    overall_is_barren: bool
    threshold: float
    n_samples: int
    param_layer_map: list[int]


@dataclass
class OptimizationResult:
    """Result of a parameter optimization run."""

    optimal_values: np.ndarray
    optimal_cost: float
    history: list[tuple[np.ndarray, float]]
    converged: bool
    iterations: int


@dataclass
class MultiStartResult:
    """Result of a batched multi-start optimization.

    ``cost_histories[s, t]`` is start ``s``'s cost at its t-th visited
    point (pre-update: ``cost_histories[s, 0]`` is the initial cost)."""

    optimal_values: np.ndarray          # (K,) best parameters overall
    optimal_cost: float
    best_start: int
    start_values: np.ndarray            # (S, K) per-start best params
    start_costs: np.ndarray             # (S,) per-start best costs
    cost_histories: np.ndarray          # (S, iterations)
    iterations: int
    n_starts: int


def _multi_start_adam(program, cost: DeviceCost, offsets: np.ndarray,
                      inits: torch.Tensor, n_iter: int, lr: float,
                      beta1: float, beta2: float):
    """Adam from every row of ``inits`` (S, K) at once, in their dtype on its
    device (``optimizer.py:385-408``): each iteration records the cost at
    the current point, keeps the best point in the carry, then updates;
    a final evaluation competes for best. Returns (best_values (S, K),
    best_costs (S,), costs (S, n_iter))."""
    n = program.num_qubits
    real = inits.dtype     # float32, float64 under enable_complex128
    lr, b1, b2 = (torch.tensor(x, dtype=real) for x in (lr, beta1, beta2))

    def value_and_grad(values):
        v = values.detach().requires_grad_(True)
        c = cost.device_fn(prog.forward_body(
            program, _param_rows(program, offsets, v)), n)
        (g,) = torch.autograd.grad(c.sum(), v)
        return c.detach(), g

    values = inits
    m = torch.zeros_like(values)
    v = torch.zeros_like(values)
    best_c = torch.full((values.shape[0],), float("inf"), dtype=real,
                        device=values.device)
    best_v = values
    costs = []
    for t in range(n_iter):
        c, g = value_and_grad(values)
        better = c < best_c
        best_c = torch.where(better, c, best_c)
        best_v = torch.where(better[:, None], values, best_v)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        t1 = torch.tensor(t + 1, dtype=real)
        m_hat = m / (1 - torch.pow(b1, t1))
        v_hat = v / (1 - torch.pow(b2, t1))
        values = values - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        costs.append(c)
    with torch.no_grad():
        final_c = cost.device_fn(prog.forward_body(
            program, _param_rows(program, offsets, values)), n)
    better = final_c < best_c
    best_c = torch.where(better, final_c, best_c)
    best_v = torch.where(better[:, None], values, best_v)
    hist = (torch.stack(costs, dim=1) if costs
            else torch.zeros((values.shape[0], 0), dtype=real))
    return best_v, best_c, hist


# ---------------------------------------------------------------------------
# Adam optimizer
# ---------------------------------------------------------------------------

class CircuitOptimizer:
    """Adam over circuit parameters.

    ``gradient_method``: "parameter_shift" (batched +-pi/2 rule, exact for
    rotation gates), "finite_difference", or "autodiff" (reverse mode
    through the per-gate body). ``device`` defaults to ``CONFIG.device``.
    """

    def __init__(self, config: ParameterizedCircuitConfig,
                 cost_fn, learning_rate: float = 0.1,
                 beta1: float = 0.9, beta2: float = 0.999,
                 max_iterations: int = 100, tolerance: float = 1e-6,
                 gradient_method: str = "parameter_shift", device=None):
        self._config = config
        self._cost_fn = cost_fn
        self._lr = learning_rate
        self._beta1 = beta1
        self._beta2 = beta2
        self._max_iter = max_iterations
        self._tol = tolerance
        self._grad_method = gradient_method
        self._device = device or CONFIG.device

        n = config.num_params
        self._values = config.get_values().copy()
        self._m = np.zeros(n)
        self._v = np.zeros(n)
        self._t = 0
        self._history: list[tuple[np.ndarray, float]] = []
        self._stop_requested = False

    @property
    def values(self) -> np.ndarray:
        return self._values.copy()

    @property
    def history(self) -> list[tuple[np.ndarray, float]]:
        return self._history

    def request_stop(self) -> None:
        self._stop_requested = True

    def _evaluate_cost(self, values: np.ndarray,
                       seed: int | None = None) -> float:
        costs = GradientEstimator._batched_costs(
            self._config, self._cost_fn, values[None, :], seed,
            self._device)
        return float(costs[0])

    def step(self, seed: int | None = None) -> tuple[np.ndarray, float]:
        """One Adam step. Returns (values, cost at the new values): the
        reference records the cost after each update, so autodiff's
        pre-update cost is not reused (``optimizer.py:629-658``)."""
        self._t += 1
        if self._grad_method == "autodiff":
            _, grad = GradientEstimator.autodiff(
                self._config, self._cost_fn, self._values, self._device)
        elif self._grad_method == "finite_difference":
            grad = GradientEstimator.finite_difference(
                self._config, self._cost_fn, self._values, seed=seed,
                device=self._device)
        else:
            grad = GradientEstimator.parameter_shift(
                self._config, self._cost_fn, self._values, seed=seed,
                device=self._device)

        self._m = self._beta1 * self._m + (1 - self._beta1) * grad
        self._v = self._beta2 * self._v + (1 - self._beta2) * grad**2
        m_hat = self._m / (1 - self._beta1**self._t)
        v_hat = self._v / (1 - self._beta2**self._t)
        self._values = self._values - self._lr * m_hat / (
            np.sqrt(v_hat) + 1e-8)

        cost = self._evaluate_cost(self._values, seed)
        self._history.append((self._values.copy(), cost))
        return self._values.copy(), cost

    def run(self, callback: Callable[[int, np.ndarray, float], None]
            | None = None, seed: int | None = None) -> OptimizationResult:
        """Full optimization loop with convergence on |dcost| < tol and
        best-iterate selection."""
        self._stop_requested = False
        converged = False
        for i in range(self._max_iter):
            if self._stop_requested:
                break
            values, cost = self.step(seed=seed)
            if callback is not None:
                callback(i, values, cost)
            if len(self._history) >= 2:
                if abs(cost - self._history[-2][1]) < self._tol:
                    converged = True
                    break

        best_idx = min(range(len(self._history)),
                       key=lambda j: self._history[j][1])
        return OptimizationResult(
            optimal_values=self._history[best_idx][0],
            optimal_cost=self._history[best_idx][1],
            history=self._history,
            converged=converged,
            iterations=len(self._history),
        )

    @classmethod
    def multi_start(cls, config: ParameterizedCircuitConfig,
                    cost_fn: DeviceCost, n_starts: int = 8,
                    max_iterations: int = 100,
                    learning_rate: float = 0.1,
                    beta1: float = 0.9, beta2: float = 0.999,
                    seed: int | None = None,
                    init_values: np.ndarray | None = None,
                    device=None) -> MultiStartResult:
        """Optimize from ``n_starts`` initializations at once: every
        start's Adam loop (autodiff gradients through the per-gate body)
        runs as one batch on the device, and the global best is selected
        on the host. Initializations are uniform in [-pi, pi) (or
        ``init_values`` of shape (n_starts, num_params))."""
        if config.num_params == 0:
            raise ValueError("circuit has no parameters to optimize")
        program, offsets = _check_reverse_mode(config, cost_fn,
                                               "multi_start")
        if init_values is None:
            rng = np.random.default_rng(seed)
            init_values = rng.uniform(
                -np.pi, np.pi, size=(n_starts, config.num_params))
        else:
            init_values = np.asarray(init_values, dtype=np.float64)
            if init_values.shape != (n_starts, config.num_params):
                raise ValueError(
                    f"init_values must be ({n_starts}, "
                    f"{config.num_params}), got {init_values.shape}")
        inits = torch.as_tensor(init_values.astype(CONFIG.np_real),
                                device=device or CONFIG.device)
        best_v, best_c, costs = _multi_start_adam(
            program, cost_fn, offsets, inits, max_iterations,
            learning_rate, beta1, beta2)
        best_v = best_v.double().cpu().numpy()
        best_c = best_c.double().cpu().numpy()
        costs = costs.double().cpu().numpy()
        k = int(np.argmin(best_c))
        return MultiStartResult(
            optimal_values=best_v[k],
            optimal_cost=float(best_c[k]),
            best_start=k,
            start_values=best_v,
            start_costs=best_c,
            cost_histories=costs,
            iterations=max_iterations,
            n_starts=n_starts,
        )

    # --- barren plateau analysis ------------------------------------------

    def _gradient_samples(self, n_samples: int,
                          seed: int | None) -> np.ndarray:
        """(n_samples, P) parameter-shift gradients at random points. The
        points are drawn as the JAX package draws them (per sample: the
        uniform point, then a seed); every sample's shifted rows run
        together, cut into batches by memory."""
        rng = np.random.default_rng(seed)
        n_params = self._config.num_params
        if n_params == 0:
            return np.zeros((n_samples, 0))
        points = []
        for _ in range(n_samples):
            points.append(rng.uniform(-np.pi, np.pi, size=n_params))
            rng.integers(0, 2**63)   # the per-sample seed of the reference
        shift = np.pi / 2
        batch = np.concatenate([_shift_matrix(p, shift) for p in points])
        costs = GradientEstimator._batched_costs(
            self._config, self._cost_fn, batch,
            device=self._device).reshape(n_samples, 2, n_params)
        return (costs[:, 0] - costs[:, 1]) / (2.0 * np.sin(shift))

    def detect_barren_plateau(self, n_samples: int = 50,
                              seed: int | None = None) -> dict:
        """Gradient variance over random parameter points; barren when the
        mean variance falls below 1e-4."""
        grads = self._gradient_samples(n_samples, seed)
        per_param_var = np.var(grads, axis=0)
        mean_var = float(np.mean(per_param_var))
        return {
            "mean_variance": mean_var,
            "per_param": per_param_var.tolist(),
            "is_barren": mean_var < 1e-4,
        }

    def detect_barren_plateau_layered(self, n_samples: int = 50,
                                      seed: int | None = None
                                      ) -> BarrenPlateauAnalysis:
        """Variance grouped by circuit layer (``gate_to_layer_map``) and
        by first target qubit."""
        circuit = self._config.circuit
        g2l = circuit.gate_to_layer_map()
        param_layer_map: list[int] = []
        param_qubit_map: list[int] = []
        for binding in self._config.bindings:
            gate = circuit.gates[binding.gate_index]
            param_layer_map.append(g2l[binding.gate_index])
            param_qubit_map.append(
                gate.target_qubits[0] if gate.target_qubits else 0)

        grads = self._gradient_samples(n_samples, seed)
        per_param_var = np.var(grads, axis=0)

        layer_indices: dict[int, list[int]] = {}
        for pi, layer in enumerate(param_layer_map):
            layer_indices.setdefault(layer, []).append(pi)

        per_layer_variance: list[list[float]] = []
        per_layer_mean: list[float] = []
        depth_scaling: list[tuple[int, float]] = []
        for layer in sorted(layer_indices):
            layer_vars = [float(per_param_var[pi])
                          for pi in layer_indices[layer]]
            per_layer_variance.append(layer_vars)
            mean_v = float(np.mean(layer_vars))
            per_layer_mean.append(mean_v)
            depth_scaling.append((layer, mean_v))

        qubit_indices: dict[int, list[int]] = {}
        for pi, q in enumerate(param_qubit_map):
            qubit_indices.setdefault(q, []).append(pi)
        max_qubit = max(qubit_indices, default=0)
        per_qubit_variance = [
            float(np.mean([per_param_var[pi] for pi in qubit_indices[q]]))
            if q in qubit_indices else 0.0
            for q in range(max_qubit + 1)
        ]

        overall_mean = float(np.mean(per_param_var))
        return BarrenPlateauAnalysis(
            per_layer_variance=per_layer_variance,
            per_layer_mean_variance=per_layer_mean,
            per_qubit_variance=per_qubit_variance,
            depth_scaling=depth_scaling,
            overall_mean_variance=overall_mean,
            overall_is_barren=overall_mean < 1e-4,
            threshold=1e-4,
            n_samples=n_samples,
            param_layer_map=param_layer_map,
        )
