"""Run a circuit on a shard-mesh statevector and sample it.

The port's twin of ``scripts/sharded_run.py``, with its arguments and JSON
keys: the amplitude vector is split over ``--devices`` shards
(``parallel.make_mesh``: one rank holding every shard, stacked on
``--device``), gates on shard-index qubits exchange data between shards,
and sampling is shard-local. The JAX ``--virtual-cpu`` flag is
``--device cpu`` here, with the same ``--devices``.

``--multihost`` joins a ``torch.distributed`` process group
(``parallel.initialize_multihost``; coordinator, process count and rank
from COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID) and spreads the
shards over its ranks: gloo with ``--device cpu``, NCCL on cards. The NCCL
path has not run on two GPUs yet; only the gloo path is tested.

Usage:
    python -m quantum_simulator_tpu_torch.scripts.sharded_run \
        --template ghz --qubits 8 --devices 4 --shots 1000 [--device cpu]
    python -m quantum_simulator_tpu_torch.scripts.sharded_run \
        --qsim my_circuit.qsim --devices 8
"""

from __future__ import annotations

import argparse

import numpy as np

from ..algorithms import AlgorithmTemplate
from ..models import brickwork_circuit
from ..noise import DepolarizingNoise, NoiseModel
from ..parallel import (DistributedSimulator, initialize_multihost,
                        make_mesh, make_multihost_mesh)
from ..utils.cli import add_device_argument, emit, open_device
from ..utils.serialization import CircuitSerializer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Mesh-sharded statevector run")
    parser.add_argument("--template", choices=["ghz", "qft", "brickwork"],
                        default="ghz")
    parser.add_argument("--qubits", type=int, default=8)
    parser.add_argument("--depth", type=int, default=8,
                        help="depth for --template brickwork")
    parser.add_argument("--qsim", type=str, default=None,
                        help="load a .qsim circuit instead of a template")
    parser.add_argument("--devices", type=int, default=None,
                        help="shards of the mesh (power of 2; default: one "
                             "per rank)")
    parser.add_argument("--shots", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--noise-p", type=float, default=0.0,
                        help="depolarizing probability for one noisy "
                             "trajectory demo")
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group "
                             "(COORDINATOR_ADDRESS, NUM_PROCESSES, "
                             "PROCESS_ID env vars) and spread the shards "
                             "over its ranks; NCCL on cards is untested "
                             "on two GPUs")
    parser.add_argument("--output", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "sharded_run")
    if device is None:
        return 1

    if args.multihost:
        spec = initialize_multihost(device=device)
        print(f"Multi-host: process {spec.process_id}/"
              f"{spec.num_processes} via {spec.coordinator}")
        mesh = make_multihost_mesh(n_devices=args.devices, device=device)
    else:
        mesh = make_mesh(args.devices, device=device)

    if args.qsim:
        circuit = CircuitSerializer.load(args.qsim)
    elif args.template == "ghz":
        circuit = AlgorithmTemplate.ghz_state(args.qubits)
    elif args.template == "qft":
        circuit = AlgorithmTemplate.quantum_fourier_transform(args.qubits)
    else:
        circuit = brickwork_circuit(args.qubits, args.depth, seed=args.seed)

    sim = DistributedSimulator(mesh)
    mesh_size = mesh.n_devices
    print(f"Mesh: {mesh_size} shards on {device} | circuit: "
          f"n={circuit.num_qubits}, {circuit.gate_count()} gates")

    state = sim.run(circuit)
    counts = sim.sample(state, args.shots, np.random.default_rng(args.seed))
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
    result = {
        "experiment": "sharded_run",
        "mesh_devices": int(mesh_size),
        "num_qubits": circuit.num_qubits,
        "norm": state.norm(),
        "shots": args.shots,
        "top_counts": dict(top),
    }
    if args.noise_p > 0:
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(args.noise_p))
        noisy = sim.run_noisy_trajectory(circuit, nm, seed=args.seed)
        result["noisy_trajectory_fidelity"] = sim.fidelity(state, noisy)
    emit(result, args.output, note="Saved to")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
