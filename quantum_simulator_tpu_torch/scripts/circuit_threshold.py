"""Circuit-level surface-code threshold study.

The port's twin of ``scripts/circuit_threshold.py``, with its arguments,
defaults and report keys: physical depolarizing rate x code distance
through the circuit-level pipeline (``qec_circuit.circuit_level_memory``:
real extraction circuits sampled by the linearized Pauli-frame engine on
the device, decoded on the measured detector error model by the C
union-find loop), with per-round logical error rates, Lambda factors
(error suppression per +2 of distance) and the crossing estimate. Where
the JAX script prints its report only to a file, the twin prints it to
stdout when no ``--output`` is given.

Run:  python -m quantum_simulator_tpu_torch.scripts.circuit_threshold
          [--distances 3,5,7] [--probs 0.001,0.002,0.004,0.008]
          [--rounds d] [--trials 20000] [--basis z] [--output FILE]
          [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..qec_circuit import circuit_level_memory
from ..utils.cli import add_device_argument, emit, open_device


def lambda_factors(rows: list[dict], probs: list[float]) -> dict:
    """Per probability, the per-round rate ratio of each distance to the
    next. A larger distance with zero failures at this trial count is
    evidence for scaling: its ratio is inf (pairs where both are zero are
    below the sweep's resolution and dropped)."""
    lambdas = {}
    for p in probs:
        per_round = {r["distance"]: r["per_round_logical_rate"]
                     for r in rows if r["noise_prob"] == p}
        ds = sorted(per_round)
        ratios = []
        for a, b in zip(ds, ds[1:]):
            if per_round[b] > 0:
                ratios.append(per_round[a] / per_round[b])
            elif per_round[a] > 0:
                ratios.append(float("inf"))
        if ratios:
            lambdas[p] = ratios
    return lambdas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--distances", type=str, default="3,5,7")
    ap.add_argument("--probs", type=str,
                    default="0.001,0.002,0.004,0.008")
    ap.add_argument("--rounds", type=int, default=0,
                    help="syndrome rounds (0 = use d rounds per code)")
    ap.add_argument("--trials", type=int, default=20000)
    ap.add_argument("--basis", choices=("z", "x"), default="z")
    ap.add_argument("--two-qubit-depol", action="store_true",
                    help="standard circuit noise: correlated 15-Pauli "
                         "depolarizing per CNOT + 1q depolarizing per "
                         "1q gate")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output", type=str, default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "circuit_threshold")
    if device is None:
        return 1
    distances = [int(d) for d in args.distances.split(",")]
    probs = [float(p) for p in args.probs.split(",")]

    rows = []
    for d in distances:
        R = args.rounds or d
        for p in probs:
            t0 = time.perf_counter()
            res = circuit_level_memory(
                distance=d, n_rounds=R, noise_prob=p,
                n_trials=args.trials, seed=args.seed, basis=args.basis,
                two_qubit_depol=args.two_qubit_depol, device=device)
            dt = time.perf_counter() - t0
            rows.append(res | {"wall_s": round(dt, 2)})
            print(f"d={d} R={R} p={p:g}: logical "
                  f"{res['logical_failure_probability']:.5f}  per-round "
                  f"{res['per_round_logical_rate']:.2e}  "
                  f"({args.trials / dt:,.0f} trials/s end-to-end)",
                  flush=True)

    lambdas = lambda_factors(rows, probs)
    for p, ratios in lambdas.items():
        print(f"p={p:g}: Lambda = "
              + ", ".join("inf" if x == float("inf") else f"{x:.1f}x"
                          for x in ratios))
    below = [p for p in probs
             if lambdas.get(p) and all(x > 1.0 for x in lambdas[p])]
    est = max(below) if below else None
    print(f"threshold bracket: scaling still helps at p <= {est}"
          if est is not None else
          "threshold bracket: no p in the sweep shows clean scaling "
          "(all-zero failure counts mean the sweep needs more trials "
          "or higher p)")

    report = {"basis": args.basis, "trials": args.trials, "rows": rows,
              "lambda": {str(k): ["inf" if x == float("inf") else x
                                  for x in v]
                         for k, v in lambdas.items()},
              "scaling_helps_up_to": est}
    emit(report, args.output, note="wrote")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
