"""End-to-end tour of the port (on the card by default, or the host).

    python -m quantum_simulator_tpu_torch.examples.quickstart
        [--device cpu] [--out-dir DIR] [--no-export]

The twin of ``examples/quickstart.py``. The circuit diagram goes into
``--out-dir`` (default: a new temporary directory); ``--no-export`` skips
it, for machines without matplotlib. The mesh section always runs, on two
shards stacked on the one device.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from .. import (CliffordSimulator, DensityMatrixSimulator, DepolarizingNoise,
                GateInstance, MPSSimulator, NoiseModel, QuantumCircuit,
                ReadoutError, Simulator)
from .. import mps as mps_mod
from ..analysis import StateAnalysis
from ..debugger import CircuitDebugger
from ..dmrg import dmrg_excited_states
from ..models import hardware_efficient_ansatz, tfim_chain, zz_chain
from ..optimizer import (CircuitOptimizer, CostFunction,
                         ParameterizedCircuitConfig)
from ..parallel import (DistributedSimulator, make_mesh, make_vqe_mesh,
                        sharded_vqe_step)
from ..qec import QECSimulator, SteaneCode
from ..qec_frame import FrameQECSimulator
from ..utils.cli import add_device_argument, open_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None,
                    help="where the circuit diagram goes (default: a new "
                         "temporary directory)")
    ap.add_argument("--no-export", action="store_true",
                    help="skip the PNG export (needs matplotlib)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "quickstart")
    if device is None:
        return 1

    # --- 1. Build and run a GHZ circuit --------------------------------
    ghz = QuantumCircuit(4)
    ghz.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, 4):
        ghz.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    result = Simulator(device=device).run(ghz, shots=1000, seed=42)
    print("GHZ-4 counts:", result.measurement_counts)

    # --- 2. Analysis -----------------------------------------------------
    state = result.final_state
    print(f"bipartite entropy: "
          f"{StateAnalysis.entanglement_entropy(state, [0, 1]):.3f} bits, "
          f"I(q0:q3) = {StateAnalysis.mutual_information(state, 0, 3):.3f}")

    # --- 3. Noisy Monte-Carlo (one batch on the device) ------------------
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.03))
    nm.set_readout_error(ReadoutError(p01=0.01, p10=0.02))
    noisy = Simulator(noise_model=nm, device=device).run_with_noise(
        ghz, shots=5000, seed=7)
    top = sorted(noisy.measurement_counts.items(), key=lambda kv: -kv[1])[:4]
    print("noisy top counts:", dict(top))

    # --- 4. Debug where the noise bites ---------------------------------
    attribution = CircuitDebugger(device=device).compute_noise_attribution(
        ghz, nm, n_trials=50, seed=42)
    worst = int(np.argmax(attribution.column_attribution_pct))
    print(f"noisiest column: {worst} "
          f"({attribution.column_attribution_pct[worst]:.0f}% of loss, "
          f"gates {attribution.gate_labels[worst]})")

    # --- 5. VQE with autodiff gradients ----------------------------------
    ansatz = hardware_efficient_ansatz(4, 2)
    config = ParameterizedCircuitConfig.auto_detect(ansatz)
    cost = CostFunction.vqe_hamiltonian(zz_chain(4))
    opt = CircuitOptimizer(config, cost, learning_rate=0.2,
                           max_iterations=60, gradient_method="autodiff",
                           device=device)
    vqe = opt.run(seed=42)
    print(f"VQE energy: {vqe.optimal_cost:.4f} "
          f"({vqe.iterations} iterations, {config.num_params} params)")

    # --- 6. QEC: Steane code corrects a noisy cycle ----------------------
    qec = QECSimulator(SteaneCode(), device)
    cycle = qec.run_cycle(0, "depolarizing", 0.05, seed=3)
    print(f"Steane cycle: syndrome={cycle.syndrome} "
          f"corrections={cycle.correction_applied} "
          f"F: {cycle.fidelity_before:.3f} -> {cycle.fidelity_after:.3f}")

    # --- 7. Export the circuit diagram ------------------------------------
    if not args.no_export:
        from ..render import CircuitExporter

        out_dir = args.out_dir or tempfile.mkdtemp(prefix="quickstart-")
        out = os.path.join(out_dir, "ghz4.png")
        CircuitExporter.export_png(ghz, out)
        print("circuit diagram written to", out)

    # --- 7b. Exact density matrix (deterministic channel evolution) -------
    dm = DensityMatrixSimulator(noise_model=nm, device=device).run(ghz)
    print(f"exact noisy rho: trace={dm.trace():.6f} "
          f"purity={dm.purity():.4f} (no Monte-Carlo error)")

    # --- 8. Mesh-sharded run + sharded VQE step ----------------------------
    # Two shards stacked on the one device (a process group spreads them
    # over ranks instead).
    dsim = DistributedSimulator(make_mesh(2, device=device))
    dstate = dsim.run(ghz)
    print("sharded GHZ counts:", dsim.sample(dstate, 200))
    mesh_ansatz = hardware_efficient_ansatz(4, 2, initial_angle=0.7)
    step = sharded_vqe_step(mesh_ansatz, make_vqe_mesh(2, device=device))
    _, costs = step.run(8)
    print(f"sharded VQE <Z0>: {costs[0]:.4f} -> {costs[-1]:.4f}")

    # --- 9. Beyond amplitudes: the bit-algebra engines ---------------------
    # Clifford circuits at hundreds of qubits (stabilizer tableau):
    wide = QuantumCircuit(128)
    wide.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(127):
        wide.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    counts, tab = CliffordSimulator(device=device).run(wide, shots=100,
                                                       seed=0)
    print("GHZ-128 support:", sorted(k[:4] + "..." for k in counts),
          "| half-cut entropy:",
          CliffordSimulator.entanglement_entropy(tab, list(range(64))),
          "bit")

    # Arbitrary (non-Clifford) gates at 100 qubits while entanglement
    # fits the bond dimension: the MPS engine, with a ledger of what
    # truncation discarded (0.0 == exact).
    twist = QuantumCircuit(100)
    twist.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(99):
        twist.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    twist.add_gate(GateInstance("Rz", [50], [0.7], column=100))
    counts, mstate = MPSSimulator(chi=8, device=device).run(
        twist, shots=200, seed=0)
    print("twisted GHZ-100 support:", sorted(k[:4] + "..." for k in counts),
          "| truncated weight:", mstate.truncation_weight,
          "| <X^100>:", round(mps_mod.expectation_pauli_string(
              mstate, "X" * 100), 4))

    # Ground-state physics past the 2^n wall: two-site DMRG on the same
    # Hamiltonian term lists VQE optimizes, plus the first excited state
    # (paramagnetic phase, h > |j|, where the gap is open).
    spectrum = dmrg_excited_states(tfim_chain(24, j=-1.0, h=-1.3), 24,
                                   n_states=2, chi=8, sweeps=3,
                                   device=device)
    print(f"TFIM-24 via DMRG: E0 = {spectrum[0].energy:.4f}, "
          f"gap = {spectrum[1].energy - spectrum[0].energy:.4f} "
          f"(orthogonality |<0|1>| = "
          f"{abs(mps_mod.overlap(spectrum[0].state, spectrum[1].state)):.1e})")

    # QEC memory with no 2^n state (Pauli-frame engine):
    res = FrameQECSimulator.ml_memory_experiment(
        distance=9, noise_prob=0.03, n_rounds=10, n_trials=2048,
        meas_error_prob=0.03, seed=1, device=device)
    print(f"d=9 memory, 10 rounds, p=q=0.03: exact-ML logical failure "
          f"{res['ml_failure_probability']:.4f} vs single-shot "
          f"{res['final_syndrome_failure_probability']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
