#!/usr/bin/env python3
"""Dry run of the PyTorch port's parallel layer on a shard mesh.

    python3 torch_dryrun_multichip.py [--devices 8] [--device cpu]

The port's counterpart of ``__graft_entry__.dryrun_multichip``: the same
four checks at tiny sizes, on a mesh of ``--devices`` shards stacked on
``--device`` (the port's default device, the card, unless named) in
this one process (``parallel.make_mesh``; a process
group started with ``torch.distributed`` gives a rank-spanning mesh
instead, ``parallel.make_multihost_mesh``):

(a) one sharded VQE step (parameter shift + Adam) over the (traj x amp)
    mesh on a 4-qubit, 2-layer Ry + CNOT ansatz: finite cost and
    parameters;
(b) noisy ``run_with_noise`` on the amplitude mesh: 64 shard-local shots
    over 4 trajectories, every shot counted;
(c) a Steane frame-QEC sweep with its trials split over the mesh;
(d) QFT-12 on a basis input over the mesh, every H on a shard qubit an
    exchange: fidelity against the analytic DFT row > 1 - 1e-4.

It imports torch and the port only, never JAX.
"""

from __future__ import annotations

import argparse

import numpy as np


def _flagship_circuit(n_qubits: int, layers: int):
    from quantum_simulator_tpu_torch import GateInstance, QuantumCircuit

    c = QuantumCircuit(n_qubits)
    col = 0
    for layer in range(layers):
        for q in range(n_qubits):
            c.add_gate(GateInstance("Ry", [q], [0.1 * (q + layer + 1)],
                                    column=col))
        col += 1
        for q in range(layer % 2, n_qubits - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    return c


def dryrun_multichip(n_devices: int, device: str | None = None) -> None:
    from quantum_simulator_tpu_torch import (DepolarizingNoise, NoiseModel,
                                             qec, qec_frame)
    from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh,
                                                      make_vqe_mesh,
                                                      sharded_vqe_step)

    # (a) the sharded VQE step
    mesh = make_vqe_mesh(n_devices, device=device)
    vqe = sharded_vqe_step(_flagship_circuit(4, 2), mesh)
    state, cost = vqe.step(vqe.init)
    cost = float(cost)
    if not np.isfinite(cost) or not bool(state.params.isfinite().all()):
        raise RuntimeError(f"non-finite VQE step: cost {cost}")
    print(f"dryrun_multichip OK: mesh=({mesh.shape['traj']}x"
          f"{mesh.shape['amp']}) traj x amp, {vqe.num_params} params, "
          f"<Z0> = {cost:.6f}")

    # (b) noisy run_with_noise with shard-local sampling
    amp_mesh = make_mesh(n_devices, device=device)
    sim = DistributedSimulator(amp_mesh)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    n_noisy = max(4, (n_devices - 1).bit_length() + 2)
    counts = sim.run_with_noise(_flagship_circuit(n_noisy, 2), nm,
                                shots=64, trajectories=4, seed=7)
    if sum(counts.values()) != 64 or any(len(b) != n_noisy for b in counts):
        raise RuntimeError(f"shard-local sampling lost shots: {counts}")
    print(f"dryrun_multichip noisy OK: n={n_noisy} amp-sharded over "
          f"{n_devices} shards, 4 trajectories, 64 shard-local shots, "
          f"{len(counts)} distinct bitstrings")

    # (c) the frame-QEC sweep with its trials split over the mesh
    fsim = qec_frame.FrameQECSimulator.from_code(qec.SteaneCode(), device)
    ok_before, ok_after, _ = fsim.sweep_raw(0.05, 8 * n_devices,
                                            "bit_flip", seed=11,
                                            mesh=amp_mesh)
    rate = 1.0 - float(ok_after.float().mean())
    if ok_before.shape != (8 * n_devices,) or not 0.0 <= rate <= 0.5:
        raise RuntimeError(f"implausible Steane logical rate {rate}")
    print(f"dryrun_multichip qec OK: Steane frame sweep, {8 * n_devices} "
          f"trials over {n_devices} shards, logical error rate {rate:.3f}")

    # (d) QFT-12 on a basis input: exchanges on every shard-qubit H
    n = 12
    b = 0b101001011010
    qft = AlgorithmTemplate.quantum_fourier_transform(n)
    qft.initial_states = [(b >> (n - 1 - q)) & 1 for q in range(n)]
    psi = sim.run(qft).data
    analytic = np.exp(2j * np.pi * b * np.arange(1 << n) / (1 << n)) \
        / np.sqrt(1 << n)
    fid = abs(np.vdot(analytic, psi)) ** 2 / max(
        float(np.vdot(psi, psi).real), 1e-30)
    if not fid > 1 - 1e-4:
        raise RuntimeError(f"QFT-12 cross-shard fidelity {fid}")
    print(f"dryrun_multichip qft exchange OK: fidelity {fid:.7f} (n={n} "
          f"over {n_devices} shards, basis input b={b:#x})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="shards of the mesh (a power of 2)")
    ap.add_argument("--device", default=None,
                    help="device the shards are stacked on (default: the "
                    "port's device, the card; 'cpu' for a CPU mesh)")
    args = ap.parse_args()
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
