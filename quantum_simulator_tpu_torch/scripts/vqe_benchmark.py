"""VQE optimization benchmark: hardware-efficient ansatz + Adam.

The port's twin of ``scripts/vqe_benchmark.py``, with its arguments,
defaults and JSON keys. ``--grad``: "autodiff" (reverse mode through
``torch.autograd`` over the per-gate body), "parameter_shift" or
"finite_difference" (batched rows through the group executor and its
kernels). ``--starts N`` runs N Adam loops as one batch
(``CircuitOptimizer.multi_start``); ``--engine mps --chi`` evaluates costs
as bond-dimension-chi MPS contractions (``MPSParameterizedConfig``).

Usage:
    python -m quantum_simulator_tpu_torch.scripts.vqe_benchmark \
        --qubits 4 --layers 3 --hamiltonian zz [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..circuit import GateInstance, QuantumCircuit
from ..optimizer import (CircuitOptimizer, CostFunction,
                         MPSParameterizedConfig, ParameterizedCircuitConfig)
from ..utils.cli import add_device_argument, emit, open_device


def _build_ansatz(n_qubits: int, n_layers: int) -> QuantumCircuit:
    """Hardware-efficient ansatz: Ry layers + CNOT chains + final Ry."""
    c = QuantumCircuit(n_qubits)
    col = 0
    for _ in range(n_layers):
        for q in range(n_qubits):
            c.add_gate(GateInstance("Ry", [q], [0.0], column=col))
        col += 1
        for q in range(n_qubits - 1):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    for q in range(n_qubits):
        c.add_gate(GateInstance("Ry", [q], [0.0], column=col))
    return c


HAMILTONIANS = {
    "z0": lambda n: CostFunction.z_expectation(0),
    "zz": lambda n: CostFunction.vqe_hamiltonian(
        [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]),
    "heisenberg": lambda n: CostFunction.vqe_hamiltonian(
        [(-1.0, "XX", [i, i + 1]) for i in range(n - 1)]
        + [(-1.0, "YY", [i, i + 1]) for i in range(n - 1)]
        + [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]),
}


def run_benchmark(n_qubits: int, n_layers: int, hamiltonian_name: str,
                  lr: float, max_iters: int, seed: int,
                  grad_method: str = "autodiff", n_starts: int = 1,
                  engine: str = "statevector", chi: int = 32,
                  device=None) -> dict:
    circuit = _build_ansatz(n_qubits, n_layers)
    config = ParameterizedCircuitConfig.auto_detect(circuit)
    cost_fn = HAMILTONIANS[hamiltonian_name](n_qubits)

    rng = np.random.default_rng(seed)
    init_vals = rng.uniform(-np.pi, np.pi, size=config.num_params)
    for i, b in enumerate(config.bindings):
        circuit.gates[b.gate_index].params[b.param_index] = float(
            init_vals[i])
    if engine == "mps":
        # Reverse mode through truncated SVDs is unsafe: the MPS engine
        # takes parameter-shift gradients.
        if n_starts > 1:
            raise SystemExit("--starts > 1 needs autodiff; "
                             "--engine mps uses parameter_shift")
        if grad_method == "autodiff":
            grad_method = "parameter_shift"
        config = MPSParameterizedConfig.auto_detect(circuit, chi=chi)
    else:
        config = ParameterizedCircuitConfig.auto_detect(circuit)

    if n_starts > 1:
        # Every start's Adam loop in one batch; start 0 uses the
        # single-start initialization.
        inits = np.vstack(
            [init_vals[None, :],
             rng.uniform(-np.pi, np.pi,
                         size=(n_starts - 1, config.num_params))])
        t0 = time.perf_counter()
        ms = CircuitOptimizer.multi_start(
            config, cost_fn, n_starts=n_starts, max_iterations=max_iters,
            learning_rate=lr, init_values=inits, device=device)
        elapsed = time.perf_counter() - t0
        cost_trace = [float(c) for c in ms.cost_histories[ms.best_start]]
        return {
            "n_qubits": n_qubits,
            "n_layers": n_layers,
            "n_params": config.num_params,
            "hamiltonian": hamiltonian_name,
            "learning_rate": lr,
            "max_iterations": max_iters,
            "actual_iterations": ms.iterations,
            "converged": False,
            "optimal_cost": float(ms.optimal_cost),
            "initial_cost": cost_trace[0] if cost_trace else None,
            "cost_improvement": ((cost_trace[0] - ms.optimal_cost)
                                 if cost_trace else 0),
            "elapsed_seconds": round(elapsed, 3),
            "gradient_method": "autodiff",
            "cost_trace": cost_trace,
            "n_starts": n_starts,
            "best_start": ms.best_start,
            "start_costs": [float(c) for c in ms.start_costs],
        }

    optimizer = CircuitOptimizer(
        config=config, cost_fn=cost_fn, learning_rate=lr,
        max_iterations=max_iters, gradient_method=grad_method,
        device=device)
    t0 = time.perf_counter()
    result = optimizer.run(seed=seed)
    elapsed = time.perf_counter() - t0

    cost_trace = [float(h[1]) for h in result.history]
    return {
        "n_qubits": n_qubits,
        "n_layers": n_layers,
        "n_params": config.num_params,
        "hamiltonian": hamiltonian_name,
        "learning_rate": lr,
        "max_iterations": max_iters,
        "actual_iterations": result.iterations,
        "converged": result.converged,
        "optimal_cost": float(result.optimal_cost),
        "initial_cost": cost_trace[0] if cost_trace else None,
        "cost_improvement": ((cost_trace[0] - result.optimal_cost)
                             if cost_trace else 0),
        "elapsed_seconds": round(elapsed, 3),
        "gradient_method": grad_method,
        "cost_trace": cost_trace,
        "engine": engine,
        **({"chi": chi} if engine == "mps" else {}),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="VQE optimization benchmark")
    parser.add_argument("--qubits", type=int, default=2)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--hamiltonian", choices=list(HAMILTONIANS),
                        default="z0")
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--grad", choices=["autodiff", "parameter_shift",
                                           "finite_difference"],
                        default="autodiff")
    parser.add_argument(
        "--starts", type=int, default=1,
        help="multi-start: N full Adam loops in one batch on the device "
             "(forces autodiff; start 0 = the --seed init)")
    parser.add_argument(
        "--engine", choices=["statevector", "mps"], default="statevector",
        help="mps: evaluate costs as bond-dimension-chi MPS contractions "
             "(VQE at 40+ qubits; parameter-shift gradients)")
    parser.add_argument("--chi", type=int, default=32,
                        help="MPS bond dimension (with --engine mps)")
    parser.add_argument("--output", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "vqe_benchmark")
    if device is None:
        return 1

    print(f"Running VQE benchmark: qubits={args.qubits}, "
          f"layers={args.layers}, H={args.hamiltonian}, lr={args.lr}, "
          f"iters={args.iters}, seed={args.seed}, grad={args.grad}, "
          f"engine={args.engine}, device={device}")
    result = run_benchmark(args.qubits, args.layers, args.hamiltonian,
                           args.lr, args.iters, args.seed, args.grad,
                           n_starts=args.starts, engine=args.engine,
                           chi=args.chi, device=device)
    emit({"experiment": "vqe_benchmark", "seed": args.seed,
          "result": result}, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
