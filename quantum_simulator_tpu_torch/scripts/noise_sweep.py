"""Noise probability sweep: fidelity / entropy / purity vs noise rate.

The port's twin of ``scripts/noise_sweep.py``, with its arguments, defaults
and JSON keys: all trials at a sweep point run as one batch of trajectories
on the device (``Simulator.trajectory_states``), and the fidelities and
norms are reductions there (complex64, float32 accumulation; TF32 stays
off).

Usage:
    python -m quantum_simulator_tpu_torch.scripts.noise_sweep \
        --circuit bell --noise depolarizing --seed 42 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..circuit import GateInstance, QuantumCircuit
from ..noise import BitFlipNoise, DepolarizingNoise, NoiseModel, PhaseFlipNoise
from ..simulator import Simulator
from ..utils.cli import add_device_argument, emit, open_device


def _chain_circuit(num_qubits: int) -> QuantumCircuit:
    c = QuantumCircuit(num_qubits)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, num_qubits):
        c.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    return c


CIRCUITS = {
    "bell": lambda: _chain_circuit(2),
    "ghz3": lambda: _chain_circuit(3),
    "ghz4": lambda: _chain_circuit(4),
}

NOISE_TYPES = {
    "bit_flip": BitFlipNoise,
    "phase_flip": PhaseFlipNoise,
    "depolarizing": DepolarizingNoise,
}


def run_sweep(circuit: QuantumCircuit, noise_cls, probabilities: np.ndarray,
              n_trials: int, seed: int, device) -> list[dict]:
    rng = np.random.default_rng(seed)
    ideal = Simulator(device=device).run(circuit, shots=0,
                                         seed=seed).final_state.device_data

    results = []
    for p in probabilities:
        trial_seed = int(rng.integers(0, 2**63))
        nm = NoiseModel()
        nm.add_global_noise(noise_cls(float(p)))
        sim = Simulator(noise_model=nm, device=device)
        states = sim.trajectory_states(circuit, n_trials, seed=trial_seed)
        overlaps = torch.einsum("d,td->t", ideal.conj(), states)
        fids = overlaps.abs().square().double().cpu().numpy()
        norms = states.abs().square().sum(dim=1).double().cpu().numpy()
        # Trajectories are pure states: S(|psi><psi|) = 0, purity = norm^2.
        results.append({
            "noise_prob": float(p),
            "mean_fidelity": float(fids.mean()),
            "mean_entropy": 0.0,
            "mean_purity": float((norms**2).mean()),
        })
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Noise probability sweep experiment")
    parser.add_argument("--circuit", choices=list(CIRCUITS), default="bell")
    parser.add_argument("--noise", choices=list(NOISE_TYPES),
                        default="depolarizing")
    parser.add_argument("--min-p", type=float, default=0.0)
    parser.add_argument("--max-p", type=float, default=0.3)
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--trials", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "noise_sweep")
    if device is None:
        return 1

    circuit = CIRCUITS[args.circuit]()
    probs = np.linspace(args.min_p, args.max_p, args.steps)
    print(f"Running noise sweep: circuit={args.circuit}, noise={args.noise}, "
          f"p=[{args.min_p:.3f}, {args.max_p:.3f}], "
          f"steps={args.steps}, trials={args.trials}, seed={args.seed}, "
          f"device={device}")
    results = run_sweep(circuit, NOISE_TYPES[args.noise], probs,
                        args.trials, args.seed, device)
    emit({"experiment": "noise_sweep", "circuit": args.circuit,
          "noise_type": args.noise, "n_trials": args.trials,
          "seed": args.seed, "results": results}, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
