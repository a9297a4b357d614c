"""Readings of a thermal-relaxation cell's check, for setting its limits; not
part of a run.

    python3 qsbench/control_thermal.py --workload esu2_30_thermal.noisy \
        --seeds 11 12 --as <who> [<who> ...]

``control.py``'s readings for the cells whose entry is
``run_with_noise_huge``, whose reference (``reference/kraus.py``) replays
and samples general Kraus trajectories. For each seed it takes the
requests a run of that seed checks, lets each ``who`` answer them, and
prints the numbers the cell's check compares, one JSON line per seed and
``who`` (one reference walk a circuit serves every ``who``'s draws):

* ``program``: the port, no window: the lower readings;
* ``control``: the plain reference in TF32 in the program's place: its own
  stochastic trajectories (``kraus.sample``) give the counts, and the one
  with the most jumps, replayed in TF32 from its branches, the kept state:
  the upper readings;
* ``fault-noiseless``, ``fault-swapjumps``, ``fault-skipsite``,
  ``fault-doublerate``, ``fault-halfrate``: the port with a fault planted
  (``planted``): every Kraus operator of the relaxation replaced by the
  identity (the noise left out, the route kept); the two jump operators
  swapped; the Kraus operator of one CX site (the second qubit's, in the
  first window that holds a CX's two sites) replaced by the identity, its
  draw kept; each site's jump branches drawn with twice or half their
  weight against the no-jump branch, the operators applied as drawn (a
  wrong law with states true to their draws).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAULTS = ("fault-noiseless", "fault-swapjumps", "fault-skipsite",
          "fault-doublerate", "fault-halfrate")
WHO = ("program", "control") + FAULTS


def _skip_cx_site(draws):
    import torch

    def skipped(spec, window, *args, **kwargs):
        overrides, branches, updates = draws(spec, window, *args, **kwargs)
        # the Ry channel's stack is made first (the first Ry layer's sites
        # come before any CX's), the CX channel's second
        cx = 1
        first = next(w for w in spec.windows
                     if sum(s.stack_id == cx for s in w) == 2)
        if window is first:
            site = [s for s in window if s.stack_id == cx][1]
            j = overrides.pool_map[site.seg_pos]
            rows = overrides.pool_rows.clone()
            scale = rows[:, j].abs().amax((-1, -2))
            rows[:, j] = (torch.eye(2, dtype=rows.dtype, device=rows.device)
                          * scale[:, None, None])
            overrides = overrides._replace(pool_rows=rows)
        return overrides, branches, updates
    return skipped


def _scaled_rate(draws, factor: float):
    from quantum_simulator_tpu_torch.ops import monomial_traj

    def scaled(*args, **kwargs):
        categorical = monomial_traj.categorical

        def weighted(weights, *a, **k):
            weights = weights.clone()
            weights[:, 1:] *= factor
            return categorical(weights, *a, **k)

        monomial_traj.categorical = weighted
        try:
            return draws(*args, **kwargs)
        finally:
            monomial_traj.categorical = categorical
    return scaled


@contextlib.contextmanager
def planted(fault: str):
    """The port with ``fault`` planted for the length of the block."""
    import numpy as np

    from quantum_simulator_tpu_torch import ThermalRelaxationNoise
    from quantum_simulator_tpu_torch.ops import monomial_traj

    rates = {"fault-doublerate": 2.0, "fault-halfrate": 0.5}
    if fault == "fault-skipsite" or fault in rates:
        owner, name = monomial_traj, "_window_draws"
        orig = monomial_traj._window_draws
        new = (_skip_cx_site(orig) if fault == "fault-skipsite"
               else _scaled_rate(orig, rates[fault]))
    else:
        owner, name = ThermalRelaxationNoise, "get_kraus_operators"
        orig = ThermalRelaxationNoise.get_kraus_operators
        if fault == "fault-noiseless":
            def new(self):
                return ([np.eye(2, dtype=np.complex128)]
                        + [np.zeros((2, 2), np.complex128)] * 2)
        elif fault == "fault-swapjumps":
            def new(self):
                k0, k1, k2 = orig(self)
                return [k0, k2, k1]
        else:
            raise ValueError(f"no fault {fault!r}")
    cache = monomial_traj._SPEC_CACHE
    monomial_traj._SPEC_CACHE = {}       # specs keyed by the channel's name
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, orig)
        monomial_traj._SPEC_CACHE = cache


def control_answer(circuit: dict, traffic: dict, device, gen) -> dict:
    """The TF32 reference's answer in the form the entry gives: one row a
    trajectory, its branches in one window, the most jumped one's state."""
    import torch

    from qsbench.reference import kraus

    shots, T = int(traffic["shots"]), int(traffic["trajectories"])
    noise = circuit["noise"]
    idx, branches = kraus.sample(circuit, noise, T, shots // T, gen, device,
                                 precision="tf32", with_branches=True)
    sites = branches.shape[1]
    best = int((branches != 0).sum(1).argmax())
    re, im = kraus.replay(circuit, noise, branches[best:best + 1], device,
                          precision="tf32")
    rows = [{"route": "monomial", "indices": idx[t],
             "slots": [list(range(sites))],
             "draws": [(None, branches[t:t + 1])],
             "state": (torch.stack([re[0], im[0]]), True) if t == best
             else None} for t in range(T)]
    n = circuit["num_qubits"]
    vals, cnt = torch.unique(idx.reshape(-1), return_counts=True)
    counts = {format(int(v), f"0{n}b"): int(k)
              for v, k in zip(vals.tolist(), cnt.tolist())}
    return {"counts": counts, "rows": rows}


def answers_of(who, port, entry, traffic, requests, device, seed):
    """(circuit, answer) pairs of ``who`` for the checked requests."""
    import torch

    from qsbench import control

    if who == "program" or who in FAULTS:
        with planted(who) if who in FAULTS else contextlib.nullcontext():
            return control.answers_of("program", port, entry, traffic,
                                      requests, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [(c, control_answer(c, traffic, device, gen))
            for c, _ in requests]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--as", dest="who", choices=WHO, nargs="+",
                    default=["control"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import quantum_simulator_tpu_torch as port
    from qsbench import control
    from qsbench.cell import Manifest
    from qsbench.reference import kraus

    manifest = Manifest(ROOT)
    traffic_name = manifest.workload(args.workload)["traffic"]
    entry = manifest.module("entries",
                            manifest.traffic(traffic_name)["entry"])
    for seed in args.seeds:
        traffic, requests, check_seed = control.checked_requests(
            manifest, args.workload, seed)
        # each who's answers and kept state first, then one reference walk
        # a circuit for every who's draws
        checks, rows, seconds = {}, {}, {}
        for who in args.who:
            t0 = time.monotonic()
            answers = answers_of(who, port, entry, traffic, requests,
                                 args.device, check_seed + 1)
            checks[who] = entry.Check(traffic, args.device)
            rows[who] = [checks[who].add(c, a, draws=False)
                         for c, a in answers]
            seconds[who] = time.monotonic() - t0
            del answers
        t1 = time.monotonic()
        for i, (circuit, _) in enumerate(requests):
            path = kraus.no_jump_path(circuit, circuit["noise"], args.device)
            for who in args.who:
                if rows[who][i]:
                    checks[who].add_draws(circuit, rows[who][i], path)
            del path
        walk = time.monotonic() - t1
        if args.device != "cpu":
            torch.cuda.empty_cache()
        for who in args.who:
            law = checks[who].law
            sd = max(law.whole_var, 1e-300) ** 0.5
            print(json.dumps({"workload": args.workload, "as": who,
                              "seed": seed, "answers": len(requests),
                              "seconds": seconds[who], "walk_seconds": walk,
                              **checks[who].numbers(),
                              "jumped": law.jumps, "hazard_sum": law.mean,
                              # law_absz had no kept trajectory jumped, and
                              # had one jumped at its last site
                              "no_jump_absz": law.whole_mean / sd,
                              "one_late_jump_absz":
                                  (law.whole_mean - 1.0) / sd}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
