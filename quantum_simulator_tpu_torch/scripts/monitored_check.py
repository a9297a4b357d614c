"""Monitored-trajectory acceptance on the device, in the two regimes the
reference cannot represent (mid-circuit collapse; n past 16).

The port's twin of ``scripts/monitored_check.py``, with its arguments and
result keys:

1. **n = 24 group path** (collapse as spliced projectors,
   ``ops/monomial_traj``): GHZ-24 with mid-circuit measurements on q0 and
   q1, whose outcomes must agree in every trajectory, with the final state
   the collapsed product state; then a noisy (depolarizing) monitored
   brickwork-24 for trajectories/s.
2. **n = 30 huge path** (``ops/bigtraj.huge_monitored_sample_fn``):
   GHZ-30 with the same mid-circuit measures and ``final_shots`` Z samples,
   every sample equal to the recorded collapse branch (``--skip-huge``
   leaves it out).

The result goes to ``--output`` or, without one, to stdout; nothing is
written anywhere else.

Usage: python -m quantum_simulator_tpu_torch.scripts.monitored_check
           [--skip-huge] [--trajectories 16] [--output FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..circuit import GateInstance, QuantumCircuit
from ..noise import DepolarizingNoise, NoiseModel
from ..simulator import Simulator
from ..utils.cli import (add_device_argument, device_name, emit,
                         open_device, release)


def ghz(n: int, measure_at: int) -> QuantumCircuit:
    c = QuantumCircuit(n)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(n - 1):
        c.add_gate(GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    c.add_gate(GateInstance("Measure", [0], [], column=measure_at))
    c.add_gate(GateInstance("Measure", [1], [], column=measure_at))
    return c


def brickwork_measured(n: int, depth: int, seed: int) -> QuantumCircuit:
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q], [float(rng.uniform(0, 3))],
                                    column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
        if layer == depth // 2:
            # mid-circuit monitor row: every 6th qubit
            for q in range(0, n, 6):
                c.add_gate(GateInstance("Measure", [q], [], column=col))
            col += 1
    return c


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"monitored_check: {what}")


def ghz_group_case(n: int, device, n_trajectories: int = 8,
                   seed: int = 3) -> tuple[dict, np.ndarray, list]:
    """GHZ-n with q0 and q1 measured after the chain: outcomes equal in
    every trajectory, each final state the collapsed basis state. Returns
    (record, outcomes, final states)."""
    t0 = time.perf_counter()
    outs, _, states = Simulator(device=device).monitored_trajectories(
        ghz(n, measure_at=n), n_trajectories=n_trajectories, seed=seed)
    dt = time.perf_counter() - t0
    _require(outs.shape == (n_trajectories, 2), f"outcomes {outs.shape}")
    _require(bool((outs[:, 0] == outs[:, 1]).all()),
             f"GHZ-{n} collapse uncorrelated")
    for t in range(n_trajectories):
        idx = (2 ** n - 1) if int(outs[t, 0]) else 0
        p = float(states[t].device_data[idx].abs().square())
        _require(p > 0.999, f"trajectory {t}: |amp|^2 {p} at {idx}")
    return {
        "trajectories": n_trajectories, "seconds_cold": round(dt, 2),
        "outcomes_correlated": True, "collapsed_state_exact": True,
        "branch_counts": [int((outs[:, 0] == 0).sum()),
                          int((outs[:, 0] == 1).sum())],
    }, outs, states


def noisy_brickwork_case(n: int, device, n_trajectories: int) -> dict:
    """Depolarizing 0.01 on a monitored brickwork, depth 4: a cold batch
    (seed 7), then a warm one (seed 8) for trajectories/s."""
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.01))
    c = brickwork_measured(n, 4, seed=5)
    sim = Simulator(noise_model=nm, device=device)
    T = n_trajectories
    t0 = time.perf_counter()
    outs, _, states = sim.monitored_trajectories(c, n_trajectories=T, seed=7)
    cold = time.perf_counter() - t0
    del outs, states
    release(device)
    t0 = time.perf_counter()
    outs, _, states = sim.monitored_trajectories(c, n_trajectories=T, seed=8)
    warm = time.perf_counter() - t0
    del states
    release(device)
    _require(bool(np.isin(outs, (0, 1)).all()), "outcomes outside {0, 1}")
    return {
        "trajectories": T, "monitor_sites": int(outs.shape[1]),
        "seconds_cold": round(cold, 2), "seconds_warm": round(warm, 2),
        "traj_per_sec_warm": round(T / warm, 2),
        "outcome_freqs": outs.mean(axis=0).round(3).tolist(),
    }


def ghz_huge_case(n: int, device, n_trajectories: int = 3,
                  final_shots: int = 256) -> dict:
    """GHZ-n on the huge monitored path (n >= ``bigstate.
    HUGE_MIN_QUBITS``): every final sample equals the collapse branch."""
    def run(seed):
        t0 = time.perf_counter()
        outs, _, counts = Simulator(device=device).monitored_trajectories(
            ghz(n, measure_at=n), n_trajectories=n_trajectories, seed=seed,
            final_shots=final_shots)
        dt = time.perf_counter() - t0
        _require(outs.shape == (n_trajectories, 2), f"outcomes {outs.shape}")
        _require(bool((outs[:, 0] == outs[:, 1]).all()),
                 f"GHZ-{n} collapse uncorrelated")
        for t in range(n_trajectories):
            want = format((2 ** n - 1) if int(outs[t, 0]) else 0, f"0{n}b")
            _require(counts[t] == {want: final_shots},
                     f"trajectory {t}: {counts[t]}")
        return outs, dt

    outs, cold = run(11)
    outs2, warm = run(12)
    return {
        "trajectories": n_trajectories, "final_shots": final_shots,
        "seconds_cold": round(cold, 2), "seconds_warm": round(warm, 2),
        "seconds_per_traj_warm": round(warm / n_trajectories, 2),
        "samples_match_collapse_exactly": True,
        "branches": [int(b) for b in outs[:, 0]]
        + [int(b) for b in outs2[:, 0]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-huge", action="store_true")
    ap.add_argument("--trajectories", type=int, default=16)
    ap.add_argument("--output", type=str, default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "monitored_check")
    if device is None:
        return 1

    out: dict = {"platform": f"{device.type} ({device_name(device)})"}
    n = 24
    rec, _, states = ghz_group_case(n, device)
    del states
    release(device)
    out["ghz24_group_path"] = rec
    print(f"[monitored] GHZ-24 group path OK ({rec['seconds_cold']:.1f} s "
          f"cold, branches {rec['branch_counts']})", file=sys.stderr,
          flush=True)

    rec = noisy_brickwork_case(24, device, args.trajectories)
    out["noisy_brickwork24"] = rec
    print(f"[monitored] noisy brickwork-24 ({rec['monitor_sites']} monitor "
          f"sites): {rec['traj_per_sec_warm']:.2f} traj/s warm "
          f"({rec['seconds_warm']:.2f} s; cold {rec['seconds_cold']:.1f} s)",
          file=sys.stderr, flush=True)

    if not args.skip_huge:
        rec = ghz_huge_case(30, device)
        out["ghz30_huge_path"] = rec
        print(f"[monitored] GHZ-30 huge path OK: "
              f"{rec['seconds_per_traj_warm']:.2f} s/traj warm (cold "
              f"{rec['seconds_cold']:.1f} s), 256 samples/traj all equal "
              f"to the collapse branch", file=sys.stderr, flush=True)
    emit(out, args.output, note="wrote")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
