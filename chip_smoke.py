#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on failure (exit code != 0):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``quantum_simulator_tpu_torch/csrc`` and print what
   ``ptxas -v`` says of each (registers, spills);
2. hold each kernel against its plain PyTorch twin on the card, at the
   layouts of the main path (n = 16, 28 and 30): ``dense_axis`` in its
   three variants on every axis, ``cross_bit_axis`` on every geometry the
   brickwork plans emit plus a sliced bit inside the last axis, real and
   complex; tolerances 2e-4 dense and 2e-3 cross (those of
   ``tests/test_pallas_exec.py``: the sums run in another order). Each
   case is timed against its twin;
3. the main path through ``Simulator(device="cuda").run``: brickwork
   n=16 depth-40 (Ry+CNOT, all-real, and the Ry/Rz mix, planar complex)
   and n=28 depth-8 Ry/Rz, each matched against the plain-twin executor
   on the card (max |diff| <= 1e-5) with the launch counters equal to the
   plan's dense and cross step counts; n=28 sampled through the device
   sampler; GHZ-28 counts; QFT-20 from |0..0> flat to 1e-9;
4. timing: executor alone (CUDA events, best of 3 after a warm-up, plain
   and kernel executors in turns) and the whole ``Simulator.run`` wall
   time, for brickwork n=16 depth-40 and n=28 depth-8, and the peak
   device memory.

The line before the last is the JSON kernel summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits with an
error and prints no result. ``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from quantum_simulator_tpu_torch import QuantumCircuit, Simulator
from quantum_simulator_tpu_torch.ops import _build, cuda_exec
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog

DENSE_TOL = 2e-4
CROSS_TOL = 2e-3
STATE_TOL = 1e-5
SEED = 42

# Layouts of n = 16, 28 and 30 qubits (GroupLayout.for_qubits).
LAYOUTS = {16: (4, 128, 128), 28: (128,) * 4, 30: (4,) + (128,) * 4}
# (n, slice_axis, slice_pos, op_axis): every cross geometry the brickwork
# plans emit, plus a sliced bit inside the last axis.
CROSS_CASES = [(16, 1, 0, 0), (16, 1, 6, 2),
               (28, 0, 6, 1), (28, 1, 6, 2), (28, 2, 6, 3),
               (30, 1, 0, 0), (30, 1, 6, 2), (30, 2, 6, 3), (30, 3, 6, 4),
               (16, 2, 3, 0), (28, 3, 0, 1)]
# Kernel-summary shapes: the n=28 Ry/Rz brickwork's complex steps.
SUMMARY = {"dense_axis": ("dense", 28, 3, True, False),
           "cross_bit_axis": ("cross", 28, (2, 6, 3), True, False)}
KERNEL_INFO = {
    "dense_axis": ("quantum_simulator_tpu_torch/csrc/dense_axis.cu",
                   "quantum_simulator_tpu/ops/pallas_exec.py:178"),
    "cross_bit_axis": ("quantum_simulator_tpu_torch/csrc/cross_bit_axis.cu",
                       "quantum_simulator_tpu/ops/pallas_exec.py:229"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def brickwork(n: int, depth: int, seed: int, mix_rz: bool) -> QuantumCircuit:
    """The bench.py circuit dict (``bench.py:42-61``) as a port circuit."""
    rng = np.random.default_rng(seed)
    gates = []
    for col in range(depth):
        if col % 2 == 0:
            for q in range(n):
                name = "Rz" if mix_rz and (q + col) % 2 else "Ry"
                gates.append({"name": name, "targets": [q],
                              "params": [float(rng.uniform(0, 2 * np.pi))],
                              "column": col})
        else:
            for q in range((col // 2) % 2, n - 1, 2):
                gates.append({"name": "CNOT", "targets": [q, q + 1],
                              "params": [], "column": col})
    return QuantumCircuit.from_dict({"version": "1.0", "num_qubits": n,
                                     "gates": gates})


def ghz(n: int) -> QuantumCircuit:
    c = QuantumCircuit(n)
    c.add("H", [0], [], 0)
    for q in range(n - 1):
        c.add("CNOT", [q, q + 1], [], q + 1)
    return c


def qft(n: int) -> QuantumCircuit:
    """H + controlled-phase ladder + bit-reversal SWAPs."""
    c = QuantumCircuit(n)
    col = 0
    for i in range(n):
        c.add("H", [i], [], col)
        col += 1
        for j in range(i + 1, n):
            c.add("CPhase", [j, i], [np.pi / 2 ** (j - i)], col)
            col += 1
    for i in range(n // 2):
        c.add("SWAP", [i, n - 1 - i], [], col)
        col += 1
    return c


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int = 3) -> float:
    """Best-of-``reps`` device milliseconds of ``fn()`` (CUDA events)."""
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def in_turns(plain_fn, kernel_fn, reps: int = 3) -> tuple[float, float]:
    """Warm both, then time plain, kernel, kernel, plain; best of each."""
    plain_fn()
    kernel_fn()
    torch.cuda.synchronize()
    p1 = event_ms(plain_fn, reps)
    k1 = event_ms(kernel_fn, reps)
    k2 = event_ms(kernel_fn, reps)
    p2 = event_ms(plain_fn, reps)
    return min(k1, k2), min(p1, p2)


# ---------------------------------------------------------------------------
# Phase 2: kernels vs twins
# ---------------------------------------------------------------------------

def random_state(shape, planar: bool, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    full = ((2,) if planar else ()) + tuple(shape)
    return torch.randn(full, generator=gen, device="cuda")


def random_op(shape, real: bool, rng) -> torch.Tensor:
    """N(0, 1/K) entries, K the contraction depth: outputs stay O(1) like a
    unitary's, so the tolerance measures rounding and not magnitude."""
    k = shape[-1] * (2 if len(shape) == 4 else 1)
    full = tuple(shape) if real else (2,) + tuple(shape)
    a = (rng.standard_normal(full) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(a).cuda()


def kernel_cases(rng):
    """(kernel, label, run_kernel, run_plain, tol) for every case."""
    cases = []
    for n, shape in LAYOUTS.items():
        for planar, real in ((False, True), (True, True), (True, False)):
            for axis in range(len(shape)):
                S = shape[axis]
                op = random_op((S, S), real, rng)
                label = (f"dense n={n} axis={axis} "
                         f"{'planar' if planar else 'real'}-state "
                         f"{'real' if real else 'complex'}-op")
                cases.append(("dense_axis", label, (n, axis, planar, real),
                              shape, planar, op,
                              lambda x, op=op, a=axis, p=planar:
                              cuda_exec.dense_axis(x, op, a, p),
                              lambda x, op=op, a=axis, p=planar:
                              cuda_exec.dense_axis_plain(x, op, a, p),
                              DENSE_TOL))
    for n, s, pos, o in CROSS_CASES:
        shape = LAYOUTS[n]
        for planar, real in ((False, True), (True, False)):
            S = shape[o]
            cop = random_op((2, S, 2, S), real, rng)
            label = (f"cross n={n} geom=({s},{pos},{o}) "
                     f"{'planar' if planar else 'real'}-state "
                     f"{'real' if real else 'complex'}-op")
            cases.append(("cross_bit_axis", label,
                          (n, (s, pos, o), planar, real), shape, planar, cop,
                          lambda x, c=cop, g=(s, pos, o), p=planar:
                          cuda_exec.cross_bit_axis(x, c, *g, p),
                          lambda x, c=cop, g=(s, pos, o), p=planar:
                          cuda_exec.cross_bit_axis_plain(x, c, *g, p),
                          CROSS_TOL))
    return cases


def phase_kernels(report: dict) -> dict:
    rng = np.random.default_rng(SEED)
    rows = []
    max_err = {"dense_axis": 0.0, "cross_bit_axis": 0.0}
    summary = {}
    states: dict = {}
    for (name, label, key, shape, planar, _op, kfn, pfn,
         tol) in kernel_cases(rng):
        skey = (shape, planar)
        if skey not in states:
            states.clear()
            torch.cuda.empty_cache()
            states[skey] = random_state(shape, planar, seed=len(rows))
        x = states[skey]
        got = kfn(x)
        torch.cuda.synchronize()
        want = pfn(x)
        err = float((got - want).abs().max())
        del got, want
        check(err <= tol, f"{label}: max |kernel - plain| = {err} > {tol}")
        k_ms, p_ms = in_turns(lambda: pfn(x), lambda: kfn(x))
        max_err[name] = max(max_err[name], err)
        row = {"kernel": name, "case": label, "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms}
        rows.append(row)
        print(f"kernel {label}: err {err:.3e} kernel {k_ms:.4f} ms "
              f"plain {p_ms:.4f} ms", flush=True)
        kind, sn, geom, sp, sr = SUMMARY[name]
        want_key = (sn, geom, sp, sr)
        if key == want_key:
            summary[name] = row
    states.clear()
    torch.cuda.empty_cache()
    report["kernel_cases"] = rows
    return {"max_err": max_err, "summary": summary}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def step_counts(program) -> tuple[int, int]:
    plan = tplan.build_group_plan(program)
    return (sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps),
            sum(isinstance(s, tplan.CrossStep) for s in plan.steps))


def run_and_match(sim: Simulator, circuit: QuantumCircuit, label: str,
                  shots: int, report: dict):
    """Simulator.run, its launch counts against the plan, and its final
    state against the plain-twin executor on the card."""
    program = tprog.compile_circuit(circuit)
    n_dense, n_cross = step_counts(program)
    d0 = cuda_exec.dense_axis.launches
    c0 = cuda_exec.cross_bit_axis.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sim.run(circuit, shots=shots, seed=SEED)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dl = cuda_exec.dense_axis.launches - d0
    cl = cuda_exec.cross_bit_axis.launches - c0
    check(dl == n_dense and cl == n_cross,
          f"{label}: launches dense {dl} cross {cl}, plan has "
          f"{n_dense} dense and {n_cross} cross steps")
    got = res.final_state.device_data
    want = tplan.group_forward_body(program, program.initial_params, "cuda",
                                    plain=True)
    err = float((got - want).abs().max())
    del want
    check(err <= STATE_TOL, f"{label}: max |kernel - plain state| = {err}")
    norm = float(got.abs().square().sum())
    check(abs(norm - 1.0) <= 1e-4, f"{label}: |psi|^2 = {norm}")
    print(f"main {label}: dense {dl} cross {cl} launches, state err "
          f"{err:.3e}, |psi|^2 {norm:.7f}, run {wall:.3f} s (cold), peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    report.setdefault("main", []).append(
        {"circuit": label, "dense_launches": dl, "cross_launches": cl,
         "state_err": err, "norm": norm, "cold_run_s": wall,
         "peak_bytes": peak})
    return res


def phase_main(report: dict) -> dict:
    sim = Simulator(device="cuda")
    cuda_exec.reset_launch_counts()
    run_and_match(sim, brickwork(16, 40, SEED, False),
                  "brickwork n=16 depth-40 Ry+CNOT", 1024, report)
    run_and_match(sim, brickwork(16, 40, SEED, True),
                  "brickwork n=16 depth-40 Ry/Rz", 1024, report)
    res = run_and_match(sim, brickwork(28, 8, SEED, True),
                        "brickwork n=28 depth-8 Ry/Rz", 4096, report)
    shots = sum(res.measurement_counts.values())
    check(shots == 4096, f"n=28 sampler returned {shots} shots")
    del res
    torch.cuda.empty_cache()

    res = sim.run(ghz(28), shots=4096, seed=SEED)
    counts = res.measurement_counts
    zeros, ones = counts.get("0" * 28, 0), counts.get("1" * 28, 0)
    check(zeros + ones == 4096 and 0.4 <= zeros / 4096 <= 0.6,
          f"GHZ-28 counts {dict(list(counts.items())[:4])}")
    print(f"main GHZ-28: {zeros} x 0..0, {ones} x 1..1 of 4096", flush=True)
    del res
    torch.cuda.empty_cache()

    res = sim.run(qft(20), shots=0)
    p = res.final_state.device_data.abs().square()
    dev = float((p - 2.0 ** -20).abs().max())
    check(dev <= 1e-9, f"QFT-20 max ||amp|^2 - 2^-20| = {dev}")
    print(f"main QFT-20: max ||amp|^2 - 2^-20| = {dev:.3e}", flush=True)
    del res, p
    launches = {k.__name__: k.launches for k in cuda_exec.KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    report["launches"] = launches
    return launches


# ---------------------------------------------------------------------------
# Phase 4: timing
# ---------------------------------------------------------------------------

def phase_timing(card: str, report: dict) -> None:
    sim = Simulator(device="cuda")
    for n, depth in ((16, 40), (28, 8)):
        for mix in (False, True):
            circuit = brickwork(n, depth, SEED, mix)
            label = (f"brickwork n={n} depth-{depth} "
                     f"{'Ry/Rz' if mix else 'Ry+CNOT'}")
            program = tprog.compile_circuit(circuit)
            plan = tplan.build_group_plan(program)
            params = program.initial_params
            build_s = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                host_ops = tplan.build_group_operands(program, plan, params)
                build_s = min(build_s, time.perf_counter() - t0)
            ops = tplan.operands_to(host_ops, "cuda")
            planar = not plan.all_real
            x0 = tplan.basis_state(plan, program.initial_index, "cuda",
                                   planar)

            def executor(plain):
                return lambda: tplan.execute_group_plan(
                    plan, ops, program, params, x0, planar, plain)

            k_ms, p_ms = in_turns(executor(True), executor(False))
            torch.cuda.empty_cache()
            walls = []
            for _ in range(4):  # first is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sim.run(circuit, shots=1024, seed=SEED)
                walls.append(time.perf_counter() - t0)
                del res
            wall_ms = min(walls[1:]) * 1e3
            torch.cuda.reset_peak_memory_stats()
            sim.run(circuit, shots=0)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
            row = {"circuit": label, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "kernel_layers_per_s": depth / (k_ms / 1e3),
                   "plain_layers_per_s": depth / (p_ms / 1e3),
                   "run_wall_ms": wall_ms, "host_operand_build_ms":
                   build_s * 1e3, "run_peak_bytes": peak,
                   "steps": len(plan.steps),
                   "passes": tplan.count_state_passes(plan), "card": card}
            report.setdefault("timing", []).append(row)
            print(f"time {label} [{card}]: executor kernel {k_ms:.3f} ms "
                  f"({row['kernel_layers_per_s']:.1f} layers/s), plain "
                  f"{p_ms:.3f} ms ({row['plain_layers_per_s']:.1f} "
                  f"layers/s); Simulator.run {wall_ms:.3f} ms "
                  f"(host operand build {build_s * 1e3:.3f} ms); peak "
                  f"{peak / 2**30:.3f} GiB", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")

    card = card_line()
    print(card, flush=True)
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("ptxas:", line.split(":", 1)[-1].strip())
    lib = _build.library()
    print("dynamic shared memory per block, bytes (K: real, complex):",
          ", ".join(f"{k}: {lib.qs_smem_bytes(k, 0)}, {lib.qs_smem_bytes(k, 1)}"
                    for k in (2, 4, 8, 16, 32, 64, 128, 256)))

    kernels = phase_kernels(report)
    launches = phase_main(report)
    phase_timing(card, report)
    print(f"max_memory_allocated over the run: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")

    summary = {"kernels": []}
    for name, (source, replaces) in KERNEL_INFO.items():
        row = kernels["summary"][name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": kernels["max_err"][name],
            "ms": row["ms"], "plain_ms": row["plain_ms"]})
    report["summary"] = summary
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
