"""Run one cell of the benchmark of ``quantum_simulator_tpu_torch``.

    python3 qsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``checks``: each number the
correctness check compared with its limit, which also end standard error.
Exits non-zero with no result where there is no CUDA device or fewer than
the cell asks for, where a listed metric finds nothing to read, or where
JAX or the JAX package was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at fixed paths: the
# port's nvcc build lands in build/torch_kernels/ by itself.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from qsbench.cell import Manifest
    from qsbench.harness import MissingMetric, banned_modules, run_cell

    manifest = Manifest(ROOT)
    chips = int(manifest.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(manifest, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START)
    except MissingMetric as exc:
        print(exc, file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"answers checked {out.pop('answers_checked')}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
