"""VQE at scale: the same optimizer API from 4 to 30+ qubits.

The twin of ``examples/vqe_at_scale.py``, on ``--device``: the identical
``CircuitOptimizer`` / ``CostFunction.vqe_hamiltonian`` surface serves
every regime:

* n <= ~20: the 2P+1 parameter-shift evaluations run as one batch of
  parameter rows through the group executor and its kernels;
* n >= 30: each forward runs the large-state executor and the Hamiltonian
  evaluates as chunked Pauli-string passes;
* --engine mps: costs evaluate as bond-dimension-chi MPS contractions,
  bounded by the ansatz's entanglement instead of 2^n.

Run small (default):
    python -m quantum_simulator_tpu_torch.examples.vqe_at_scale
Run huge (one card):
    python -m quantum_simulator_tpu_torch.examples.vqe_at_scale \
        --qubits 30 --layers 1 --iters 3
Run wide (MPS):
    python -m quantum_simulator_tpu_torch.examples.vqe_at_scale \
        --qubits 50 --engine mps --iters 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import GateInstance, QuantumCircuit
from ..dmrg import dmrg_ground_state
from ..optimizer import (CircuitOptimizer, CostFunction,
                         MPSParameterizedConfig, ParameterizedCircuitConfig)
from ..utils.cli import add_device_argument, open_device


def ansatz(n: int, layers: int, seed: int = 7) -> QuantumCircuit:
    """Hardware-efficient ansatz: Ry layers + CNOT chains (the same
    shape ``scripts/vqe_benchmark.py`` uses)."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for _ in range(layers):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q],
                                    [float(rng.uniform(-np.pi, np.pi))],
                                    column=col))
        col += 1
        for q in range(n - 1):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    for q in range(n):
        c.add_gate(GateInstance("Ry", [q],
                                [float(rng.uniform(-np.pi, np.pi))],
                                column=col))
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--qubits", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--engine", choices=["statevector", "mps"],
                    default="statevector")
    ap.add_argument("--chi", type=int, default=16)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "vqe_at_scale")
    if device is None:
        return 1

    circuit = ansatz(args.qubits, args.layers)
    if args.engine == "mps":
        config = MPSParameterizedConfig.auto_detect(circuit, chi=args.chi)
    else:
        config = ParameterizedCircuitConfig.auto_detect(circuit)
    # Transverse-field-Ising-style Hamiltonian: sum Z_i Z_{i+1} + 0.5 X_i
    terms = [(1.0, "ZZ", [q, q + 1]) for q in range(args.qubits - 1)]
    terms += [(0.5, "X", [q]) for q in range(args.qubits)]
    cost = CostFunction.vqe_hamiltonian(terms)

    opt = CircuitOptimizer(config, cost, learning_rate=args.lr,
                           max_iterations=args.iters, device=device)
    t0 = time.time()

    def progress(i, _values, c):
        print(f"  iter {i:3d}: cost = {c:+.6f} "
              f"({time.time() - t0:.1f}s)", flush=True)

    result = opt.run(callback=progress)
    print(f"n={args.qubits}: optimal cost {result.optimal_cost:+.6f} "
          f"after {result.iterations} iterations "
          f"({time.time() - t0:.1f}s, {config.num_params} params)")
    if args.engine == "mps":
        # The MPS stack also gives the variational target: a DMRG
        # ground-state solve of the same Hamiltonian at the same bond
        # dimension, which no 2^n engine can produce here.
        t1 = time.time()
        gs = dmrg_ground_state(terms, args.qubits, chi=args.chi,
                               sweeps=4, device=device)
        print(f"DMRG ground-state target: {gs.energy:+.6f} "
              f"({time.time() - t1:.1f}s) — VQE gap "
              f"{result.optimal_cost - gs.energy:+.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
