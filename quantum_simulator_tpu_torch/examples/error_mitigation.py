"""The NISQ mitigation loop end to end: noisy run -> mitigate -> report.

The twin of ``examples/error_mitigation.py``. Three mitigation strategies
on one Trotterized-TFIM observable, each against the exact noiseless
value, with every density matrix and sampled run on ``--device``:

1. **ZNE** (unitary folding + Richardson) under global depolarizing
   noise: any channel, no knowledge of the noise beyond "more folding =
   more noise".
2. **PEC** (quasi-probability cancellation) under per-CNOT correlated
   two-qubit depolarizing noise: exact in expectation, at a gamma^2
   sampling overhead it reports.
3. **Readout inversion** (tensored confusion matrices) on sampled counts
   with a miscalibrated meter.

Run:  python -m quantum_simulator_tpu_torch.examples.error_mitigation
          [--n 4] [--steps 3] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import (DensityMatrixSimulator, DepolarizingNoise, NoiseModel,
                QuantumCircuit, ReadoutError, ReadoutMitigator, Simulator,
                TwoQubitDepolarizingNoise, pec_expectation, zne_expectation)
from ..utils.cli import add_device_argument, open_device


def tfim_trotter_circuit(n: int, steps: int, dt: float = 0.2,
                         h: float = 1.0, j: float = 1.0) -> QuantumCircuit:
    """First-order Trotter circuit for the open TFIM chain, built from
    the plain gate set so every mitigation transform applies."""
    c = QuantumCircuit(num_qubits=n)
    for _ in range(steps):
        for q in range(n):
            c.add("Rx", [q], [2 * h * dt])
        for q in range(n - 1):
            # exp(-i J dt Z Z) = CNOT . Rz(2 J dt) . CNOT
            c.add("CNOT", [q, q + 1])
            c.add("Rz", [q + 1], [2 * j * dt])
            c.add("CNOT", [q, q + 1])
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "error_mitigation")
    if device is None:
        return 1

    circuit = tfim_trotter_circuit(args.n, args.steps)
    ideal = float(DensityMatrixSimulator(device=device).run(
        circuit).expectation_z(0))
    print(f"TFIM-{args.n}, {args.steps} Trotter steps, "
          f"{circuit.gate_count()} gates")
    print(f"ideal <Z0>                 : {ideal:+.6f}")

    # --- 1. ZNE under global depolarizing noise -------------------------
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.004))
    sim = DensityMatrixSimulator(noise_model=nm, device=device)
    res = zne_expectation(
        lambda c: float(sim.run(c).expectation_z(0)), circuit,
        scales=(1, 3, 5))
    print(f"noisy (global depol)       : {res.raw_values[0]:+.6f}  "
          f"err {abs(res.raw_values[0] - ideal):.2e}")
    print(f"ZNE  (scales 1,3,5)        : {res.value:+.6f}  "
          f"err {abs(res.value - ideal):.2e}")

    # --- 2. PEC under per-CNOT correlated noise --------------------------
    nm2 = NoiseModel()
    nm2.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(0.01))
    sim2 = DensityMatrixSimulator(noise_model=nm2, device=device)
    evaluate = lambda c: float(sim2.run(c).expectation_z(0))  # noqa: E731
    noisy2 = evaluate(circuit)
    n_cnots = sum(g.gate_name == "CNOT" for g in circuit.gates)
    pec = pec_expectation(evaluate, circuit, nm2,
                          samples=2000 if n_cnots > 5 else None, seed=0)
    mode = "exact enum" if pec.samples is None else f"{pec.samples} samples"
    print(f"noisy (2q depol per CNOT)  : {noisy2:+.6f}  "
          f"err {abs(noisy2 - ideal):.2e}")
    print(f"PEC  ({mode}, gamma={pec.gamma:.2f}): {pec.value:+.6f}  "
          f"err {abs(pec.value - ideal):.2e}")

    # --- 3. Readout inversion on sampled counts -------------------------
    err = ReadoutError(p01=0.03, p10=0.07)
    nm3 = NoiseModel()
    nm3.set_readout_error(err)
    nm3.set_seed(7)
    shots = 100_000
    counts = Simulator(noise_model=nm3, device=device).run_with_noise(
        circuit, shots=shots, seed=7).measurement_counts
    mit = ReadoutMitigator.from_readout_error(err, args.n)
    raw_z = 0.0
    for bits, cnt in counts.items():
        raw_z += (1 - 2 * int(bits[0])) * cnt / shots
    mit_z = mit.expectation_z(counts, 0)
    print(f"sampled <Z0>, noisy meter  : {raw_z:+.6f}  "
          f"err {abs(raw_z - ideal):.2e}")
    print(f"readout-inverted           : {mit_z:+.6f}  "
          f"err {abs(mit_z - ideal):.2e}")
    shot_floor = 3.0 / np.sqrt(shots)
    if not abs(mit_z - ideal) < abs(raw_z - ideal) + shot_floor:
        raise RuntimeError(f"readout inversion made <Z0> worse: {mit_z} "
                           f"vs raw {raw_z} (ideal {ideal})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
