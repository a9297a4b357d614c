"""Quench dynamics at 50 qubits: a domain wall melting under the
transverse-field Ising Hamiltonian, watched through the MPS engine.

The twin of ``examples/quench_dynamics.py``, on ``--device``. The initial
product state |0...0 1...1> evolves under ``H = J sum Z Z + h sum X`` by
second-order Trotter circuits (``models/trotter.py``); correlations spread
outward from the wall at the Lieb-Robinson velocity, and the per-site <Z_i>
profile shows the light cone. Entanglement across the wall grows linearly
in time, and the ``truncation_weight`` ledger reports the moment the run
stops being exact at this chi.

    python -m quantum_simulator_tpu_torch.examples.quench_dynamics
    python -m quantum_simulator_tpu_torch.examples.quench_dynamics \
        --qubits 80 --chi 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from .. import MPSSimulator, mps
from ..algorithms import AlgorithmTemplate
from ..models.hamiltonians import tfim_chain
from ..utils.cli import add_device_argument, open_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--qubits", type=int, default=50)
    ap.add_argument("--chi", type=int, default=24)
    ap.add_argument("--time", type=float, default=2.0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--steps-per-frame", type=int, default=4)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "quench_dynamics")
    if device is None:
        return 1

    n = args.qubits
    terms = tfim_chain(n, j=-1.0, h=-0.6)
    sim = MPSSimulator(chi=args.chi, device=device)
    dt_frame = args.time / args.frames

    def profile(state):
        zs = [mps.expectation_pauli_string(state, {q: "Z"})
              for q in range(n)]
        return "".join("#" if z > 0.5 else ("." if z < -0.5 else "~")
                       for z in zs)

    print(f"TFIM domain-wall quench: n={n}, chi={args.chi}, "
          f"dt/frame={dt_frame:.2f} "
          f"(# = <Z> up, . = down, ~ = melted)")
    t0 = time.time()
    for f in range(args.frames + 1):
        # Evolution restarts from t=0 each frame: the circuit is the
        # state's program, so frame f is one run of f*steps Trotter steps
        # (the tfim_quench algorithm template).
        c = AlgorithmTemplate.tfim_quench(
            n, time=f * dt_frame,
            steps=max(1, f * args.steps_per_frame), j=-1.0, h=-0.6)
        _, state = sim.run(c, shots=0)
        wall_entropy = mps.entanglement_entropy(state, n // 2 - 1)
        print(f"t={f * dt_frame:4.1f}  {profile(state)}  "
              f"S_wall={wall_entropy:.2f}b  "
              f"trunc={state.truncation_weight:.1e}  "
              f"({time.time() - t0:.0f}s)")
    energy = mps.expectation_hamiltonian(state, terms)
    print(f"final <H> = {energy:+.4f} (initial {-(n - 1) + 2.0:+.4f}; "
          f"drift = Trotter + truncation error)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
