"""Physics parity check: the port's engine vs the reference NumPy engine.

The port's twin of ``scripts/parity_check.py``. It runs the SAME
experiments on both engines and compares them with that script's own
``compare`` and tolerances:

1. GHZ-3 ideal amplitudes: exact match (<= 1e-6, the BASELINE bar);
2. Bell-pair depolarizing noise sweep: mean fidelities within 4-sigma
   Monte-Carlo bands;
3. bit-flip QEC threshold sweep: logical error rates within error bars;
4. 2-qubit readout distribution transform: exact match (<= 1e-9);
5. measurement sampling: total-variation distance between the count
   distributions at most 0.02 for 10,000 shots.

The port's half runs on ``--device`` (the card by default): every
simulation, the trajectory batches of the Bell sweep and its fidelity
reduction (complex64, float32 accumulation) stay there, and the
fidelities come to the host as float64. The reference half is the
upstream NumPy engine in a subprocess on the host, with ``PYTHONPATH``
pinned to the checkout named by ``--reference`` (the directory that holds
its ``quantum_sim`` package) and no bytecode written there. There is no
default: without ``--reference``, or where that directory holds no
``quantum_sim``, the script exits 2 after the port's half. Nothing else
stands in for the reference.

Usage:
    python -m quantum_simulator_tpu_torch.scripts.parity_check \
        --reference PATH [--trials 200] [--output parity.json] \
        [--device cpu]

Exit code 0 iff every check passes, 1 if one fails, 2 without the
reference.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..circuit import GateInstance, QuantumCircuit
from ..noise import DepolarizingNoise, NoiseModel, ReadoutError
from ..qec import BitFlipCode, QECSimulator
from ..simulator import Simulator
from ..utils.cli import add_device_argument, open_device

_REF_SNIPPET = r"""
import json, sys
import numpy as np

trials = int(sys.argv[1])
out = {}

from quantum_sim.engine.circuit import QuantumCircuit, GateInstance
from quantum_sim.engine.simulator import Simulator
from quantum_sim.engine.noise import NoiseModel, DepolarizingNoise, ReadoutError
from quantum_sim.engine.analysis import StateAnalysis
from quantum_sim.engine.qec import QECSimulator, BitFlipCode

def ghz3():
    c = QuantumCircuit(3)
    c.add_gate(GateInstance("H", [0], [], 0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], 1))
    c.add_gate(GateInstance("CNOT", [0, 2], [], 2))
    return c

# 1. GHZ-3 amplitudes
state = Simulator().run(ghz3(), shots=0, seed=42).final_state.data
out["ghz3_amps"] = [[float(a.real), float(a.imag)] for a in state]

# 2. Bell depolarizing sweep
def bell():
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], 0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], 1))
    return c

rng = np.random.default_rng(42)
ideal = Simulator().run(bell(), shots=0, seed=42).final_state.data
sweep = []
for p in (0.05, 0.15, 0.3):
    fids = []
    for _ in range(trials):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(float(p)))
        nm.set_seed(int(rng.integers(0, 2**63)))
        s = Simulator(noise_model=nm).run(bell(), shots=0).final_state.data
        fids.append(StateAnalysis.state_fidelity(ideal, s))
    sweep.append({"p": p, "mean": float(np.mean(fids)),
                  "std": float(np.std(fids))})
out["bell_sweep"] = sweep

# 3. Bit-flip QEC threshold points
sim = QECSimulator(BitFlipCode())
points = []
for p in (0.05, 0.2):
    tp = sim.threshold_sweep([p], n_trials=trials, noise_type="bit_flip",
                             seed=42)[0]
    points.append({"p": p, "logical": tp.logical_rate})
out["qec_points"] = points

# 4. Readout transform
ro = ReadoutError(p01=0.03, p10=0.07)
probs = np.array([0.4, 0.3, 0.2, 0.1])
out["readout"] = ro.apply_to_distribution(probs, 2).tolist()

# 5. Bell counts distribution (10k shots)
counts = Simulator().run(bell(), shots=10000, seed=123).measurement_counts
out["bell_counts"] = counts

print(json.dumps(out))
"""


def has_reference(root: str | None) -> bool:
    """True iff ``root`` is a checkout holding the ``quantum_sim`` package."""
    return root is not None and os.path.isdir(os.path.join(root,
                                                           "quantum_sim"))


def run_reference(trials: int, root: str | None) -> dict | None:
    if not has_reference(root):
        return None
    with tempfile.TemporaryDirectory() as td:
        spath = os.path.join(td, "refparity.py")
        with open(spath, "w") as f:
            f.write(_REF_SNIPPET)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.abspath(root)
        env["PYTHONDONTWRITEBYTECODE"] = "1"
        out = subprocess.run([sys.executable, spath, str(trials)],
                             capture_output=True, text=True, timeout=1800,
                             cwd=td, env=env, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])


def ghz3() -> QuantumCircuit:
    c = QuantumCircuit(3)
    c.add_gate(GateInstance("H", [0], [], 0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], 1))
    c.add_gate(GateInstance("CNOT", [0, 2], [], 2))
    return c


def bell() -> QuantumCircuit:
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], 0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], 1))
    return c


def run_ours(trials: int, device) -> dict:
    """The port's half of every experiment on ``device``."""
    out: dict = {}
    state = Simulator(device=device).run(ghz3(), shots=0,
                                         seed=42).final_state.data
    out["ghz3_amps"] = [[float(a.real), float(a.imag)] for a in state]

    rng = np.random.default_rng(42)
    ideal = Simulator(device=device).run(bell(), shots=0,
                                         seed=42).final_state.device_data
    sweep = []
    for p in (0.05, 0.15, 0.3):
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(float(p)))
        states = Simulator(noise_model=nm, device=device).trajectory_states(
            bell(), trials, seed=int(rng.integers(0, 2**63)))
        overlaps = torch.einsum("d,td->t", ideal.conj(), states)
        fids = overlaps.abs().square().cpu().numpy().astype(np.float64)
        sweep.append({"p": p, "mean": float(fids.mean()),
                      "std": float(fids.std())})
    out["bell_sweep"] = sweep

    sim = QECSimulator(BitFlipCode(), device=device)
    points = []
    for p in (0.05, 0.2):
        tp = sim.threshold_sweep([p], n_trials=trials,
                                 noise_type="bit_flip", seed=42)[0]
        points.append({"p": p, "logical": tp.logical_rate})
    out["qec_points"] = points

    ro = ReadoutError(p01=0.03, p10=0.07)
    probs = np.array([0.4, 0.3, 0.2, 0.1])
    out["readout"] = ro.apply_to_distribution(probs, 2).tolist()

    counts = Simulator(device=device).run(bell(), shots=10000,
                                          seed=123).measurement_counts
    out["bell_counts"] = counts
    return out


def compare(ref: dict, ours: dict, trials: int) -> list[dict]:
    checks = []

    amps_ref = np.array(ref["ghz3_amps"])
    amps_ours = np.array(ours["ghz3_amps"])
    diff = np.max(np.abs(amps_ref - amps_ours))
    checks.append({"check": "ghz3_amplitudes", "max_diff": float(diff),
                   "tolerance": 1e-6, "passed": bool(diff <= 1e-6)})

    for r, o in zip(ref["bell_sweep"], ours["bell_sweep"]):
        # 4-sigma band on the difference of two Monte-Carlo means.
        se = math.sqrt(r["std"]**2 / trials + o["std"]**2 / trials)
        tol = max(4 * se, 0.01)
        diff = abs(r["mean"] - o["mean"])
        checks.append({"check": f"bell_sweep_p{r['p']}",
                       "ref_mean": r["mean"], "our_mean": o["mean"],
                       "tolerance": tol, "passed": bool(diff <= tol)})

    for r, o in zip(ref["qec_points"], ours["qec_points"]):
        se = math.sqrt(2 * 0.25 / trials)  # Bernoulli worst case
        tol = max(4 * se, 0.02)
        diff = abs(r["logical"] - o["logical"])
        checks.append({"check": f"qec_bitflip_p{r['p']}",
                       "ref_logical": r["logical"],
                       "our_logical": o["logical"],
                       "tolerance": tol, "passed": bool(diff <= tol)})

    diff = np.max(np.abs(np.array(ref["readout"])
                         - np.array(ours["readout"])))
    checks.append({"check": "readout_transform", "max_diff": float(diff),
                   "tolerance": 1e-9, "passed": bool(diff <= 1e-9)})

    keys = set(ref["bell_counts"]) | set(ours["bell_counts"])
    tvd = 0.5 * sum(abs(ref["bell_counts"].get(k, 0)
                        - ours["bell_counts"].get(k, 0)) for k in keys) \
        / 10000
    checks.append({"check": "bell_counts_tvd", "tvd": tvd,
                   "tolerance": 0.02, "passed": bool(tvd <= 0.02)})
    return checks


def print_checks(checks: list[dict]) -> bool:
    """One line per check; True iff all passed."""
    for c in checks:
        status = "PASS" if c["passed"] else "FAIL"
        print(f"  [{status}] {c['check']}: "
              + ", ".join(f"{k}={v}" for k, v in c.items()
                          if k not in ("check", "passed")))
    return all(c["passed"] for c in checks)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Physics parity vs the reference engine")
    parser.add_argument("--trials", type=int, default=200)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--reference", default=None, metavar="PATH",
                        help="checkout of the reference engine (the "
                        "directory holding quantum_sim); no default")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "parity_check")
    if device is None:
        return 1

    print(f"Running our engine ({args.trials} trials per point, "
          f"device={device})...")
    ours = run_ours(args.trials, device)
    print("Running the reference engine (subprocess)...")
    ref = run_reference(args.trials, args.reference)
    if ref is None:
        print(f"Reference not available at {args.reference} (pass "
              f"--reference PATH); aborting.")
        return 2

    checks = compare(ref, ours, args.trials)
    report = {"experiment": "parity_check", "trials": args.trials,
              "checks": checks, "all_passed": print_checks(checks)}
    print(f"\nParity: {'ALL PASSED' if report['all_passed'] else 'FAILED'}")

    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
        print(f"Report saved to {args.output}")
    return 0 if report["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
