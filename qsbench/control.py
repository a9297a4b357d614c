"""Readings of a cell's check, for setting its limits; not part of a run.

    python3 qsbench/control.py --workload <cell> --seeds 11 12 13 --as <who>

For each seed it takes the requests that a run of that seed checks (the
same circuits, drawn from the same streams as ``harness.run_cell``),
lets ``who`` answer them, and prints the numbers the cell's check
compares, one JSON line per seed:

* ``program``: the port (``Simulator``), no window: the lower readings;
* ``control``: the plain reference in TF32 put in the program's place,
  its counts drawn from its own state (noisy cells: its trajectories, and
  as many kept trajectory states as a run keeps, with its own branch
  rows): the upper readings;
* ``fault-bitflip``: the control in float32 with the last qubit's bit of
  every outcome flipped, an answer altered where it is produced;
* ``fault-noiseless``: noisy cells only: trajectories without their noise;
* ``fault-halfbatch``: half of the shots' trajectories left out.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WHO = ("program", "control", "fault-bitflip", "fault-noiseless",
       "fault-halfbatch")


def checked_requests(manifest, workload: str, seed: int):
    """The traffic, the (circuit, program seed) of each request a run of
    ``seed`` checks, and the check's seed."""
    from qsbench.harness import _streams, checked_indices

    w = manifest.workload(workload)
    cfg = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    family = manifest.module("families", cfg["family"])
    req_rng, _, pick_rng, check_rng = _streams(seed)
    # the request that closes a window depends on its timing: the first
    # request stands in for it
    chosen = checked_indices(traffic["check"], pick_rng) or {0}
    out = []
    for i in range(max(chosen) + 1):
        circuit = family.circuit(cfg, req_rng)
        program_seed = int(req_rng.integers(2**31))
        if i in chosen:
            out.append((circuit, program_seed))
    return traffic, out, int(check_rng.integers(2**63))


def sample_planes(re, im, shots: int, gen) -> dict[str, int]:
    """A plain inverse-CDF sample of ``|re + i im|^2``."""
    import torch

    p = re.double().square() + im.double().square()
    cdf = p.cumsum_(0)
    u = torch.rand(shots, dtype=torch.float64, device=re.device,
                   generator=gen) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
    del cdf, p
    n = re.numel().bit_length() - 1
    vals, cnt = torch.unique(idx, return_counts=True)
    return {format(int(v), f"0{n}b"): int(c)
            for v, c in zip(vals.tolist(), cnt.tolist())}


def flip_last_bit(counts: dict[str, int]) -> dict[str, int]:
    return {k[:-1] + ("1" if k[-1] == "0" else "0"): v
            for k, v in counts.items()}


def answers_of(who, port, entry, traffic, requests, device, seed):
    """(circuit, answer) pairs of ``who`` for the checked requests."""
    import torch

    from qsbench.reference import statevector as ref
    from qsbench.reference import trajectories as ref_traj

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shots = int(traffic["shots"])
    noisy = traffic["entry"] == "run_with_noise"
    if who == "program":
        serve = entry.serve_fn(port, traffic, device)
        return [(c, entry.answer(serve(c, s, keep=True)))
                for c, s in requests]
    prec = "tf32" if who == "control" else "float32"
    out = []
    for c, _ in requests:
        if noisy:
            noise = [] if who == "fault-noiseless" else traffic["noise"]
            take = shots // 2 if who == "fault-halfbatch" else shots
            idx = ref_traj.sample(c, noise, take, gen, device, prec)
            n = c["num_qubits"]
            vals, cnt = torch.unique(idx, return_counts=True)
            counts = {format(int(v), f"0{n}b"): int(k)
                      for v, k in zip(vals.tolist(), cnt.tolist())}
            if who == "fault-bitflip":
                counts = flip_last_bit(counts)
            branch = ref_traj.draw(c, noise, 3 * traffic["check"][
                "trajectories"], gen, device)
            re, im = ref_traj.replay(c, noise, branch, device, prec)
            rows = [("unitary", torch.complex(re, im), branch)]
            out.append((c, {"counts": counts, "rows": rows}))
            continue
        re, im = ref.simulate(c, device, prec)
        take = shots // 2 if who == "fault-halfbatch" else shots
        counts = sample_planes(re, im, take, gen)
        if who == "fault-bitflip":
            counts = flip_last_bit(counts)
        out.append((c, {"state": (re, im), "counts": counts}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--as", dest="who", choices=WHO, default="control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import quantum_simulator_tpu_torch as port
    from qsbench.cell import Manifest

    manifest = Manifest(ROOT)
    traffic_name = manifest.workload(args.workload)["traffic"]
    entry = manifest.module("entries",
                            manifest.traffic(traffic_name)["entry"])
    for seed in args.seeds:
        t0 = time.monotonic()
        traffic, requests, check_seed = checked_requests(
            manifest, args.workload, seed)
        answers = answers_of(args.who, port, entry, traffic, requests,
                             args.device, check_seed + 1)
        numbers = entry.check_answers(answers, traffic, args.device,
                                      seed=check_seed)
        if args.device != "cpu":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "as": args.who,
                          "seed": seed, "answers": len(requests),
                          "seconds": time.monotonic() - t0, **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
