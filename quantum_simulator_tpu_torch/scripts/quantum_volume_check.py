"""Quantum volume at scale: the heavy-output protocol to width 20.

The port's twin of ``scripts/quantum_volume_check.py``, with its
arguments, defaults and result keys: per width m the trials run as the
rows of parameter batches on the device
(``analysis.BenchmarkAnalysis.quantum_volume_at_scale``: the group
executor and its kernels for the ideal lane, the batched trajectory body
for the noisy one). The result holds per-width heavy-output probabilities
(mean, stderr, ideal control), the 2/3 verdict per width and QV = 2^m,
with ``platform`` the device's type and card name and ``on_device``
whether it ran on CUDA. It goes to ``--output`` (after every width, so a
cut run keeps the finished widths) or, without one, to stdout.

Usage:
  python -m quantum_simulator_tpu_torch.scripts.quantum_volume_check \
      [--widths 4,8,12,16,20] [--trials 50] [--noise-p 0.002] [--chunk 10]
      [--output FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..analysis import BenchmarkAnalysis
from ..noise import DepolarizingNoise, NoiseModel
from ..utils.cli import add_device_argument, device_name, emit, open_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="4,8,12,16,20",
                    help="comma-separated circuit widths")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--noise-p", type=float, default=0.002,
                    help="global depolarizing probability per gate")
    ap.add_argument("--chunk", type=int, default=10,
                    help="trial rows per batch (memory bound)")
    ap.add_argument("--trajectories", type=int, default=1,
                    help="noisy trajectories averaged per trial")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output", "--out", dest="output", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "quantum_volume_check")
    if device is None:
        return 1

    widths = tuple(int(w) for w in args.widths.split(","))
    nm = None
    if args.noise_p > 0:
        nm = NoiseModel()
        nm.add_global_noise(DepolarizingNoise(args.noise_p))

    partial: list[dict] = []

    def _flush_width(row: dict) -> None:
        partial.append(row)
        print(f"[qv] width {row['width']:>2}: heavy-output "
              f"{row['heavy_output_mean']:.4f} +- "
              f"{row['heavy_output_stderr']:.4f} "
              f"(ideal {row['heavy_output_ideal_mean']:.4f}) "
              f"{'PASS' if row['passed'] else 'fail'} "
              f"[{row['seconds']:.1f} s]", file=sys.stderr, flush=True)
        if args.output:
            with open(args.output, "w") as f:
                json.dump({"partial": True, "results_per_width": partial},
                          f, indent=1)

    t0 = time.perf_counter()
    res = BenchmarkAnalysis.quantum_volume_at_scale(
        widths=widths, num_trials=args.trials, noise_model=nm,
        seed=args.seed, chunk=args.chunk,
        trajectories_per_trial=args.trajectories, on_width=_flush_width,
        device=device)
    res["platform"] = f"{device.type} ({device_name(device)})"
    res["on_device"] = device.type == "cuda"
    res["noise"] = ({"channel": "depolarizing", "p": args.noise_p}
                    if nm else None)
    res["total_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"[qv] quantum volume 2^{res['log2_qv']} = "
          f"{res['quantum_volume']}", file=sys.stderr)
    if args.output:
        print(json.dumps({"quantum_volume": res["quantum_volume"],
                          "log2_qv": res["log2_qv"]}))
    emit(res, args.output, note="wrote")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
