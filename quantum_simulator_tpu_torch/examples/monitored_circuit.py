"""Measurement-induced entanglement transition on the Clifford engine.

The twin of ``examples/monitored_circuit.py``. Random Clifford brickwork
interleaved with rate-p mid-circuit measurements is the canonical
monitored-circuit model: below a critical measurement rate the
steady-state half-cut entanglement entropy grows with system size (volume
law); above it, measurements pin the state near a product state (area
law). It needs mid-circuit collapse, exact entanglement entropy and widths
far beyond amplitude simulation: the batched tableau of ``clifford.py`` on
``--device`` (tableau evolution, the branchless measurement and the
GF(2)-rank entropy).

Run:  python -m quantum_simulator_tpu_torch.examples.monitored_circuit
          [--qubits 32] [--depth 32] [--trajectories 8]
          [--rates 0.05,0.15,0.3,0.6] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import CliffordSimulator, GateInstance, QuantumCircuit
from ..utils.cli import add_device_argument, open_device


def monitored_brickwork(n: int, depth: int, p_meas: float,
                        rng: np.random.Generator) -> QuantumCircuit:
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add_gate(GateInstance(
                str(rng.choice(["H", "S", "S_DAG", "X", "Z"])), [q], [],
                column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
        for q in range(n):
            if rng.random() < p_meas:
                c.add_gate(GateInstance("Measure", [q], [], column=col))
        col += 1
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qubits", type=int, default=32)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--trajectories", type=int, default=8)
    ap.add_argument("--rates", type=str, default="0.05,0.15,0.3,0.6")
    ap.add_argument("--seed", type=int, default=7)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "monitored_circuit")
    if device is None:
        return 1
    rates = [float(r) for r in args.rates.split(",")]
    n = args.qubits
    rng = np.random.default_rng(args.seed)
    sim = CliffordSimulator(device=device)

    print(f"monitored brickwork: n={n}, depth={args.depth}, "
          f"{args.trajectories} trajectories/rate")
    half = list(range(n // 2))
    for p in rates:
        c = monitored_brickwork(n, args.depth, p, rng)
        n_meas = sum(1 for g in c.gates if g.gate_name == "Measure")
        t0 = time.perf_counter()
        _, _, tabs = sim.monitored_trajectories(
            c, args.trajectories, seed=args.seed)
        entropies = [CliffordSimulator.entanglement_entropy(tab, half)
                     for tab in tabs]
        dt = time.perf_counter() - t0
        print(f"  p={p:4.2f}: S(half-cut) = {np.mean(entropies):5.2f} "
              f"+- {np.std(entropies):4.2f} bits   "
              f"({n_meas} measurements, {dt:.1f}s)")
    print("volume-law entropy at low p collapsing toward area law at "
          "high p = the measurement-induced transition")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
