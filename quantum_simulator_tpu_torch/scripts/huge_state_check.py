"""Huge-state acceptance drive on one card (n = 30-31).

The port's twin of ``scripts/huge_state_check.py``: it runs the public
``Simulator.run`` through every large-state regime
(``ops/bigstate``: the result is a ``PlanarStateVector``, the executor's
grouped float32 tensor, never a complex copy) and checks the physics:

  1. all-real brickwork n=30  (4 GiB real state; the result stays real)
  2. complex (T-column) n=30  (8 GiB planar state)
  3. QFT-30                   (pair diagonals and swaps; marginals 0.5)
  4. all-real brickwork n=31  (8 GiB real state)
  5. Grover-30, 3 iterations  (wide-MCZ phase passes; the marked
                               amplitude must equal sin(7 asin(2^-15)) up
                               to the global -1 of the H-X-MCZ-X-H
                               diffusion)

Each result is released before the next case runs. It refuses to put
these states on the host: with ``--device cpu`` it exits with code 2.

    python -m quantum_simulator_tpu_torch.scripts.huge_state_check
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

from ..algorithms import AlgorithmTemplate
from ..circuit import GateInstance, QuantumCircuit
from ..ops.bigstate import PlanarStateVector
from ..simulator import Simulator
from ..utils.cli import add_device_argument, open_device, release

QUBITS = 30
GROVER_MARKED = 123456789


def brickwork(n: int, depth: int, seed: int,
              t_col: bool = False) -> QuantumCircuit:
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for d in range(depth):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q],
                                    [float(rng.uniform(0, 2 * np.pi))],
                                    column=col))
        col += 1
        for q in range(d % 2, n - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    if t_col:
        for q in range(n):
            c.add_gate(GateInstance("T", [q], [], column=col))
    return c


def _timed_run(sim: Simulator, label: str, circuit: QuantumCircuit,
               shots: int, seed: int):
    t0 = time.perf_counter()
    res = sim.run(circuit, shots=shots, seed=seed)
    print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    return res


def _is_real_state(state) -> bool:
    """The port's representation of an all-real large state: a
    ``PlanarStateVector`` holding a real grouped tensor."""
    return isinstance(state, PlanarStateVector) and not state.is_planar


def _is_planar_state(state) -> bool:
    return isinstance(state, PlanarStateVector) and state.is_planar


def case_real(sim: Simulator, n: int):
    res = _timed_run(sim, f"n={n} all-real brickwork", brickwork(n, 4, 7),
                     10_000, 11)
    fs = res.final_state
    return res, [(f"n={n} norm", abs(fs.norm_sq() - 1.0) < 1e-4, ""),
                 (f"n={n} shots",
                  sum(res.measurement_counts.values()) == 10_000, ""),
                 (f"n={n} real state", _is_real_state(fs), "")]


def case_complex(sim: Simulator, n: int):
    res = _timed_run(sim, f"n={n} complex (T column)",
                     brickwork(n, 2, 7, True), 5_000, 13)
    fs = res.final_state
    return res, [(f"n={n}c norm", abs(fs.norm_sq() - 1.0) < 1e-4, ""),
                 (f"n={n}c planar", _is_planar_state(fs), "")]


def _expected_distinct(n: int, shots: int) -> float:
    """Mean number of distinct outcomes of ``shots`` uniform draws over
    2^n (1998.1 of 2000 at n = 30)."""
    size = float(2 ** n)
    return size * -math.expm1(shots * math.log1p(-1.0 / size))


def case_qft(sim: Simulator, n: int):
    res = _timed_run(sim, f"QFT-{n}",
                     AlgorithmTemplate.quantum_fourier_transform(n),
                     2_000, 5)
    qp = res.final_state.qubit_probabilities()
    # 1900 of 2000 at n = 30, as the JAX check; the same margin below.
    spread = min(1900.0, 0.9 * _expected_distinct(n, 2_000))
    return res, [(f"QFT-{n} marginals = 0.5",
                  bool(np.allclose(qp, 0.5, atol=1e-4)), ""),
                 (f"QFT-{n} spread", len(res.measurement_counts) > spread,
                  f"{len(res.measurement_counts)} distinct")]


def case_wide(sim: Simulator, n: int):
    res = _timed_run(sim, f"n={n + 1} all-real brickwork",
                     brickwork(n + 1, 4, 9), 10_000, 21)
    fs = res.final_state
    return res, [(f"n={n + 1} norm", abs(fs.norm_sq() - 1.0) < 1e-4, ""),
                 (f"n={n + 1} shots",
                  sum(res.measurement_counts.values()) == 10_000, "")]


def grover_amplitude(n: int, iterations: int = 3) -> float:
    """|amplitude| of the marked state after ``iterations`` rounds."""
    return math.sin((2 * iterations + 1) * math.asin(2 ** (-n / 2)))


def case_grover(sim: Simulator, n: int):
    marked = GROVER_MARKED % (1 << n)
    g = AlgorithmTemplate.grover_search(n, marked_state=marked,
                                        num_iterations=3)
    res = _timed_run(sim, f"Grover-{n} x3", g, 0, 1)
    amp = res.final_state.amplitude(marked).real
    expect = grover_amplitude(n)
    rel = abs(abs(amp) - expect) / expect
    return res, [(f"Grover-{n} amplitude", rel < 1e-3,
                  f"|amp|={abs(amp):.6e} vs {expect:.6e} (rel {rel:.1e})")]


CASES = (case_real, case_complex, case_qft, case_wide, case_grover)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "huge_state_check")
    if device is None:
        return 1
    if device.type == "cpu":
        print("huge-state check needs the card; refusing to run 8 GiB "
              "states on the host CPU", file=sys.stderr)
        return 2

    print("device:", device, flush=True)
    sim = Simulator(device=device)
    ok = True
    for case in CASES:
        res, checks = case(sim, QUBITS)
        for name, cond, detail in checks:
            print(f"  [{'PASS' if cond else 'FAIL'}] {name} {detail}",
                  flush=True)
            ok = ok and cond
        del res
        release(device)
    print("HUGE-STATE CHECK:", "ALL PASS" if ok else "FAILURES", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
