"""Readings of a QFT cell's check, for setting its limits; not part of a run.

    python3 qsbench/control_qft.py --workload qft_30.sweep --seeds 11 12 --as <who>

``control.py``'s readings for the cells whose entry is ``run_qft``, whose
reference (``reference/qft.py``) knows ``H``, ``CPhase`` and ``SWAP``.
For each seed it takes the requests a run of that seed checks (the first
request stands for the one that closes the window), lets ``who`` answer
them, and prints the numbers the cell's check compares, one JSON line per
seed:

* ``program``: the port (``Simulator``), no window: the lower readings;
* ``control``: the QFT reference in TF32 in the program's place, its counts
  drawn from its own state: the upper readings;
* ``fault-bitflip``: the reference in float32 with the last qubit's bit of
  every outcome flipped;
* ``fault-noswap``, ``fault-negphase``, ``fault-nodiag``: the port with a
  fault planted (``planted``): its first bit-pair step (one SWAP) left
  out, its first CPhase's angle negated, its first pair-diagonal step
  skipped.
"""

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAULTS = ("fault-noswap", "fault-negphase", "fault-nodiag")
WHO = ("program", "control", "fault-bitflip") + FAULTS


def negate_first_cphase(circuit: dict) -> dict:
    out = copy.deepcopy(circuit)
    gate = next(g for g in out["gates"] if g["name"] == "CPhase")
    gate["params"] = [-float(gate["params"][0])]
    return out


def _skip_first(fn):
    def skipped(x, plan, step, *args, **kwargs):
        return x if step.index == 0 else fn(x, plan, step, *args, **kwargs)
    return skipped


@contextlib.contextmanager
def planted(fault: str):
    """The port with ``fault`` planted for the length of the block."""
    from quantum_simulator_tpu_torch import QuantumCircuit
    from quantum_simulator_tpu_torch.ops import plan

    if fault == "fault-negphase":
        owner, name = QuantumCircuit, "from_dict"
        orig = vars(QuantumCircuit)["from_dict"]
        fn = orig.__func__
        new = classmethod(lambda cls, d: fn(cls, negate_first_cphase(d)))
    else:
        owner = plan
        name = {"fault-noswap": "apply_bitpair_step",
                "fault-nodiag": "apply_diag_pair_step"}[fault]
        orig = getattr(plan, name)
        new = _skip_first(orig)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def answers_of(who, port, entry, traffic, requests, device, seed):
    """(circuit, answer) pairs of ``who`` for the checked requests."""
    import torch

    from qsbench import control
    from qsbench.reference import qft as ref

    if who == "program" or who in FAULTS:
        with planted(who) if who in FAULTS else contextlib.nullcontext():
            return control.answers_of("program", port, entry, traffic,
                                      requests, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prec = "tf32" if who == "control" else "float32"
    out = []
    for c, _ in requests:
        re, im = ref.simulate(c, device, prec)
        counts = control.sample_planes(re, im, int(traffic["shots"]), gen)
        if who == "fault-bitflip":
            counts = control.flip_last_bit(counts)
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
    from qsbench import control
    from qsbench.cell import Manifest

    manifest = Manifest(ROOT)
    traffic_name = manifest.workload(args.workload)["traffic"]
    entry = manifest.module("entries",
                            manifest.traffic(traffic_name)["entry"])
    for seed in args.seeds:
        t0 = time.monotonic()
        traffic, requests, check_seed = control.checked_requests(
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
