"""Mesh stretch check: n = 32 on a shard mesh, functionally.

The port's twin of ``scripts/mesh_stretch_check.py``, with its arguments,
defaults and result keys. It runs the two stretch configurations end to
end over ``--devices`` shards (``parallel.make_mesh``: every shard of the
one rank stacked on ``--device``): ``QFT-32`` and an n = 32 random
brickwork of depth 40. Every check is shard-local; the 2^32 amplitudes
(32 GiB) are never gathered.

Checks:
  * QFT-32 on a random basis state |b>: fidelity > 0.999 against the
    analytic DFT row ``2^(-16) exp(2 pi i b k / 2^32)``, an overlap
    computed shard by shard on the device (b k mod 2^n exactly in int64,
    the sums in float64); per-qubit <Z> ~ 0; shard-local sampling; and the
    diagonal-free schedule: the exchanges stay within the H-gate bound
    while every cross-shard CPhase schedules none.
  * Brickwork-32 depth 40: norm, shard-local sampling (counts sum, seeded
    determinism) and finite per-qubit <Z> probes. ``--segment-cols``
    runs it in column segments (``DistributedSimulator.run_segmented``),
    ``--checkpoint-dir`` with per-shard checkpoints after each segment.

The JAX ``--virtual-cpu`` flag is ``--device cpu`` here.

Usage:
    python -m quantum_simulator_tpu_torch.scripts.mesh_stretch_check \
        [--config qft|brickwork|all] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..algorithms import AlgorithmTemplate
from ..circuit import QuantumCircuit
from ..ops import plan as gplan
from ..ops import program as prog
from ..parallel import DistributedSimulator, make_mesh
from ..parallel.distributed import (ShardMesh, _build_schedule,
                                    _is_noswap_1q_diag, _is_noswap_diag)
from ..utils.cli import add_device_argument, open_device, release


def brickwork_dict(n: int, depth: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    gates = []
    for col in range(depth):
        if col % 2 == 0:
            for q in range(n):
                gates.append({"name": "Ry", "targets": [q],
                              "params": [float(rng.uniform(0, 2 * np.pi))],
                              "column": col})
        else:
            offset = (col // 2) % 2
            for q in range(offset, n - 1, 2):
                gates.append({"name": "CNOT", "targets": [q, q + 1],
                              "params": [], "column": col})
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def swap_count(circuit: QuantumCircuit, g: int) -> dict[str, int]:
    """Items of the mesh schedule by kind, for ``2^g`` shards."""
    p = prog.compile_circuit(circuit)
    noswap = {oi for oi, op in enumerate(p.ops)
              if _is_noswap_diag(op) or _is_noswap_1q_diag(op)}
    kinds: dict[str, int] = {}
    for it in _build_schedule(p, g, noswap):
        kinds[it[0]] = kinds.get(it[0], 0) + 1
    return kinds


def dft_overlap(stack: torch.Tensor, mesh: ShardMesh, b: int,
                n: int) -> complex:
    """<DFT row b | psi> of this rank's ``(L, 2, N)`` shard stack, summed
    over the ranks. The analytic amplitudes 2^(-n/2) exp(2 pi i b k / 2^n)
    are built chunk by chunk on the stack's device; b k mod 2^n is exact
    in int64 (k split into 16-bit halves, each product below 2^49)."""
    L, _, N = stack.shape
    mask = (1 << n) - 1
    acc = torch.zeros(2, dtype=torch.float64, device=stack.device)
    for l, shard in enumerate(mesh.shard_ids()):
        for s in range(0, N, gplan.CHUNK_ELEMS):
            e = min(N, s + gplan.CHUNK_ELEMS)
            k = torch.arange(shard * N + s, shard * N + e,
                             device=stack.device, dtype=torch.int64)
            m = (b * (k & 0xFFFF) + (((b * (k >> 16)) & mask) << 16)) & mask
            phase = m.double() * (2 * math.pi / 2.0 ** n)
            a_re, a_im = torch.cos(phase), torch.sin(phase)
            x_re = stack[l, 0, s:e].double()
            x_im = stack[l, 1, s:e].double()
            acc[0] += (a_re * x_re + a_im * x_im).sum()
            acc[1] += (a_re * x_im - a_im * x_re).sum()
    re, im = (float(v) * 2.0 ** (-n / 2) for v in mesh.all_reduce(acc))
    return complex(re, im)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"mesh_stretch_check: {what}")


def qft_check(sim: DistributedSimulator, n: int, g: int, shots: int,
              seed: int) -> tuple[dict, dict]:
    rng = np.random.default_rng(seed)
    b = int(rng.integers(0, 1 << n))
    circuit = AlgorithmTemplate.quantum_fourier_transform(n)
    circuit.initial_states = [(b >> (n - 1 - q)) & 1 for q in range(n)]

    kinds = swap_count(circuit, g)
    n_h = sum(1 for gate in circuit.gates if gate.gate_name == "H")
    # Every cross-shard CPhase is swap-free; the exchanges serve H gates
    # (<= 2 per H that meets a shard position, plus the restore).
    _require(kinds.get("cphase", 0) > 0, f"no cross-shard CPhase: {kinds}")
    _require(kinds.get("swap", 0) <= 4 * g,
             f"QFT schedule swaps {kinds.get('swap')} exceed the H-gate "
             f"bound 4g={4 * g}; a diagonal started scheduling exchanges")
    schedule = {"items": kinds, "h_gates": n_h, "swap_bound": 4 * g}
    print(f"[qft{n}] schedule: {kinds} (H gates: {n_h}) - diagonal-free "
          "confirmed", flush=True)

    t0 = time.time()
    state = sim.run(circuit)
    norm = state.norm()
    t_run = time.time() - t0
    print(f"[qft{n}] forward done in {t_run:.0f}s, norm={norm:.6f}",
          flush=True)

    ov = dft_overlap(state.device_data, sim.mesh, b, n)
    fid = abs(ov) ** 2 / max(norm, 1e-30) ** 2
    print(f"[qft{n}] fidelity vs analytic DFT row: {fid:.6f}", flush=True)
    _require(fid > 0.999, f"QFT-{n} fidelity {fid}")

    zs = [sim.expectation_z(state, q) for q in (0, n // 4, n // 2, n - 1)]
    print(f"[qft{n}] <Z> probes (expect ~0): {[round(z, 4) for z in zs]}",
          flush=True)
    _require(all(abs(z) < 0.01 for z in zs), f"<Z> probes {zs}")

    counts = sim.sample(state, shots, np.random.default_rng(seed))
    total = sum(counts.values())
    _require(total == shots, f"sampled {total} of {shots} shots")
    print(f"[qft{n}] sampled {total} shots, {len(counts)} unique",
          flush=True)
    return schedule, {"fidelity_vs_analytic": fid, "norm": norm,
                      "z_probes": zs, "sample_total": total,
                      "wall_s": t_run, "b": b}


def brickwork_check(sim: DistributedSimulator, n: int, depth: int, g: int,
                    shots: int, seed: int, segment_cols: int = 0,
                    checkpoint_dir: str | None = None) -> dict:
    circuit = QuantumCircuit.from_dict(brickwork_dict(n, depth, seed))
    kinds = swap_count(circuit, g)
    print(f"[brickwork{n}] schedule: {kinds}", flush=True)
    t0 = time.time()
    if segment_cols:
        def _progress(si, n_seg, wall):
            print(f"[brickwork{n}] segment {si + 1}/{n_seg} done in "
                  f"{wall:.0f}s ({time.time() - t0:.0f}s total)",
                  flush=True)
        state = sim.run_segmented(circuit, segment_cols, progress=_progress,
                                  checkpoint_dir=checkpoint_dir)
    else:
        state = sim.run(circuit)
    norm = state.norm()
    t_run = time.time() - t0
    print(f"[brickwork{n}] depth-{depth} forward done in {t_run:.0f}s, "
          f"norm={norm:.6f}", flush=True)
    _require(abs(norm - 1.0) < 1e-3, f"brickwork norm {norm}")

    zs = [sim.expectation_z(state, q) for q in (0, n // 2, n - 1)]
    print(f"[brickwork{n}] <Z> probes: {[round(z, 4) for z in zs]}",
          flush=True)
    _require(all(np.isfinite(z) and -1.0001 <= z <= 1.0001 for z in zs),
             f"<Z> probes {zs}")

    c1 = sim.sample(state, shots, np.random.default_rng(7))
    c2 = sim.sample(state, shots, np.random.default_rng(7))
    _require(c1 == c2, "seeded shard-local sampling must be deterministic")
    _require(sum(c1.values()) == shots, "sampled shots do not add up")
    print(f"[brickwork{n}] sampled {shots} shots ({len(c1)} unique), "
          "deterministic under seed", flush=True)
    return {"norm": norm, "z_probes": zs, "schedule": kinds,
            "sample_total": sum(c1.values()), "wall_s": t_run,
            "depth": depth}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=["qft", "brickwork", "all"],
                        default="all")
    parser.add_argument("--qubits", type=int, default=32)
    parser.add_argument("--depth", type=int, default=40)
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--shots", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--segment-cols", type=int, default=0,
                        help="run the brickwork forward in column "
                        "segments of this size (0 = one run), with "
                        "per-segment progress")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="with --segment-cols: save the sharded state "
                        "after every segment and resume from the newest "
                        "checkpoint on rerun (per-shard files; ~2x the "
                        "state's bytes on disk)")
    parser.add_argument("--output", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = open_device(args.device, "mesh_stretch_check")
    if device is None:
        return 1

    n = args.qubits
    sim = DistributedSimulator(make_mesh(args.devices, device=device))
    g = int(math.log2(args.devices))
    results: dict = {"qubits": n, "devices": args.devices, "checks": {}}
    if args.config in ("qft", "all"):
        _require(n <= 32, "the analytic check needs n <= 32")
        schedule, qft = qft_check(sim, n, g, args.shots, args.seed)
        results["checks"]["qft_schedule"] = schedule
        results["checks"]["qft"] = qft
        release(device)
    if args.config in ("brickwork", "all"):
        results["checks"]["brickwork"] = brickwork_check(
            sim, n, args.depth, g, args.shots, args.seed,
            args.segment_cols, args.checkpoint_dir)
    results["ok"] = True
    out = json.dumps(results, indent=2, default=float)
    print(out, flush=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
