"""DMRG ground/excited-state solver CLI: spectra past the 2^n wall.

The port's twin of ``scripts/dmrg_solve.py``, with its arguments, defaults
and JSON keys: two-site DMRG (``dmrg``) on the device, over the Hamiltonian
menu of ``vqe_benchmark``.

Usage:
    python -m quantum_simulator_tpu_torch.scripts.dmrg_solve \
        --qubits 64 --hamiltonian tfim --chi 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from .. import mps
from ..dmrg import dmrg_excited_states, dmrg_ground_state
from ..models.hamiltonians import heisenberg_chain, tfim_chain, zz_chain
from ..utils.cli import add_device_argument, emit, open_device

HAMILTONIANS = {
    "zz": lambda n, j, h: zz_chain(n, coeff=j),
    "tfim": lambda n, j, h: tfim_chain(n, j=j, h=h),
    "heisenberg": lambda n, j, h: heisenberg_chain(n, jx=j, jy=j, jz=j),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="DMRG ground/excited-state solver")
    parser.add_argument("--qubits", type=int, default=24)
    parser.add_argument("--hamiltonian", choices=list(HAMILTONIANS),
                        default="tfim")
    parser.add_argument("--j", type=float, default=-1.0,
                        help="coupling coefficient")
    parser.add_argument("--h", type=float, default=-1.0,
                        help="field coefficient (tfim)")
    parser.add_argument("--chi", type=int, default=32)
    parser.add_argument("--sweeps", type=int, default=4)
    parser.add_argument("--states", type=int, default=1,
                        help="number of lowest eigenstates")
    parser.add_argument("--lanczos-k", type=int, default=12)
    parser.add_argument("--output", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "dmrg_solve")
    if device is None:
        return 1

    terms = HAMILTONIANS[args.hamiltonian](args.qubits, args.j, args.h)
    print(f"DMRG: n={args.qubits}, H={args.hamiltonian}, chi={args.chi}, "
          f"sweeps={args.sweeps}, states={args.states}, device={device}")
    t0 = time.perf_counter()
    if args.states == 1:
        results = [dmrg_ground_state(terms, args.qubits, chi=args.chi,
                                     sweeps=args.sweeps,
                                     lanczos_k=args.lanczos_k,
                                     device=device)]
    else:
        results = dmrg_excited_states(terms, args.qubits,
                                      n_states=args.states, chi=args.chi,
                                      sweeps=args.sweeps,
                                      lanczos_k=args.lanczos_k,
                                      device=device)
    elapsed = time.perf_counter() - t0

    overlaps = [
        {"i": i, "j": j,
         "abs_overlap": abs(mps.overlap(results[i].state,
                                        results[j].state))}
        for i in range(len(results)) for j in range(i + 1, len(results))
    ]
    output = {
        "experiment": "dmrg_solve",
        "n_qubits": args.qubits,
        "hamiltonian": args.hamiltonian,
        "j": args.j,
        "h": args.h,
        "chi": args.chi,
        "sweeps": args.sweeps,
        "lanczos_k": args.lanczos_k,
        "elapsed_seconds": round(elapsed, 3),
        "energies": [r.energy for r in results],
        "gaps": [results[k + 1].energy - results[k].energy
                 for k in range(len(results) - 1)],
        "truncation_weights": [r.truncation_weight for r in results],
        "sweep_energies": [r.sweep_energies for r in results],
        "overlaps": overlaps,
        "entanglement_entropy_midcut": [
            float(mps.entanglement_entropy(r.state, args.qubits // 2 - 1))
            for r in results],
    }
    for k, e in enumerate(output["energies"]):
        print(f"  E{k} = {e:+.6f}  (trunc "
              f"{output['truncation_weights'][k]:.1e})")
    if output["gaps"]:
        print(f"  gap = {output['gaps'][0]:+.6f}")
    print(f"  {elapsed:.1f}s")
    emit(output, args.output, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
