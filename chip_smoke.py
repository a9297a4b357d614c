#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on failure (exit code != 0):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``quantum_simulator_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel), print what ``ptxas -v`` says of each (registers,
   spills) and check the kernels' tile sizes against the wrapper's;
2. hold each kernel against its plain PyTorch twin on the card, at the
   layouts of the main path (n = 16, 28 and 30): ``dense_axis`` in its
   three variants on every axis, ``cross_bit_axis`` on every geometry the
   brickwork plans emit plus a sliced bit inside the last axis, real and
   complex; tolerances 2e-4 dense and 2e-3 cross (those of
   ``tests/test_pallas_exec.py``: the sums run in another order). The
   kernels write in place, so the twin (and, at n = 16 and 28, a float64
   reference) runs on a copy taken before the kernel; each wrapper must
   return its input tensor, and at n = 16 and 28 the kernel's max error
   against float64 must be at most 2x the twin's. Each case is timed
   against its twin, with achieved TB/s and TFLOP/s;
3. the main path through ``Simulator(device="cuda").run``: brickwork
   n=16 depth-40 (Ry+CNOT, all-real, and the Ry/Rz mix, planar complex)
   and n=28 depth-8 Ry/Rz, each matched against the plain-twin executor
   on the card (max |diff| <= 1e-5) with the launch counters equal to the
   plan's dense and cross step counts; n=28 sampled through the device
   sampler; GHZ-28 counts; QFT-20 from |0..0> flat to 1e-9;
4. timing: executor alone (CUDA events, best of 3 after a warm-up, plain
   and kernel executors in turns, each call on a fresh copy of the basis
   state made outside the timed region) and the whole ``Simulator.run``
   wall time, for brickwork n=16 depth-40 and n=28 depth-8, and the peak
   device memory of the executor and of ``Simulator.run(shots=0)``
   (n=28 Ry/Rz: only dense and cross steps, peak <= 6.1 GiB).

The noisy-trajectory slice adds:

2b. the batched kernels (a leading batch of B trajectories, one operator
    per trajectory or one shared with stride 0) against their batched
    twins at the layouts of n = 10, 16, 20 and 24, B in {16, 256} capped
    so a planar batch stays within 8 GiB, a real operator on a real state
    and a complex one on a planar state, every dense axis and every cross
    geometry the noisy brickwork plans emit; the checks and tolerances of
    phase 2, with ms, TB/s, TFLOP/s and the bound of each case;
3b. the noisy path: ``Simulator(noise_model=..., device="cuda")
    .trajectory_states`` on the five ``bench.py:221-226`` cases
    (brickwork seed 42 with ``DepolarizingNoise(0.05)`` at (n, depth, T) =
    (10, 10, 1024), (20, 8, 256), (24, 8, 16), ``AmplitudeDampingNoise
    (0.05)`` at (20, 8, 256), (24, 8, 16)): the batched launch counts
    equal the plans' dense and cross steps times the batches, every norm
    is 1 +- 1e-4, and the kernel executor matches the plain-twin executor
    within 1e-5 on the same draws; ``run_with_noise`` at n=16 depth-40
    Ry+CNOT with readout error returns its 1024 shots; and 2000-trajectory
    ensembles at n=4 reach a NumPy density-matrix reference (Kraus sums
    gate by gate) within 0.05 for depolarizing, amplitude damping and
    two-qubit depolarizing noise;
4b. timing of the five cases: trajectories/s with the kernels and with
    the twins in turns, the device split into operand build, draws and
    executor (CUDA events), the ``run_with_noise`` wall time at n=16 with
    1024 shots, and peak memory.

The variational slice adds:

5. the variational path (``optimizer``, ``models``): the parameter-shift
   gradient of ``hardware_efficient_ansatz(20, 4)`` (Ry + CNOT, P = 100,
   real kernels) on the Heisenberg chain and of ``qaoa_maxcut_ansatz(16,
   3)`` on the 16-ring (P = 96, planar kernels), 2P parameter rows through
   the batched executor: launches equal the plans' dense and cross steps
   times the batches, the gradient matches the twins' within 1e-4 and
   autodiff (the per-gate body) within 1e-3, and the twins' gradient
   launches no kernel; ``CircuitOptimizer.run`` (3 iterations, parameter
   shift) never rises above its first cost and ``multi_start`` (8 starts,
   20 iterations) ends at or below the mean of its first costs. Timed: ms
   and rows/s per gradient (kernels and twins in turns), autodiff ms, the
   device split of one gradient batch into operand build, executor and
   cost (CUDA events), the executor with one operator per row against
   one shared by all rows (same plan and B), and peak memory.

The large-state and monitored slice adds:

2c. both kernels against their twins at the layouts of n = 31 and 32,
    real and planar, every dense axis and every cross geometry the
    brickwork plans emit there, within the tolerances of phase 2; the
    twin runs slice by slice along an axis the step does not touch, so
    the check holds two states and one slice's temporaries;
6.  the n >= 30 ideal path through ``Simulator(device="cuda").run``:
    brickwork Ry/Rz (planar) at n = 30 and 32 and Ry+CNOT (real) at
    n = 31, depth 8 (depth 4 at n = 32), 4096 shots in the Z basis, and
    the X basis at
    n = 30: a ``PlanarStateVector`` of norm 1 +- 1e-4, launch counts equal
    to the plans' dense and cross steps, the shots adding up, the kernel
    executor within 1e-5 of the twin executor at n = 30 and 31, the peak
    of ``run(shots=4096)`` under 1.75x the state at n = 32; GHZ-32 gives
    only 0..0 and 1..1; Z and Pauli strings on GHZ-30 take their known
    values; ``run_step_by_step`` at n = 30 yields marginal summaries, the
    last one equal to the final state's qubit probabilities within 1e-5;
    QFT-30 from |0..0> (pair diagonals and swaps, chunk by chunk in
    place) is flat to 1e-3 of 2^-30, its peak under 1.75x the state;
7.  the n >= 30 noisy and the monitored paths: at n = 30, depth 4, one
    ``Simulator.run`` trajectory with depolarizing noise (unitary splice),
    amplitude damping (monomial splice) and amplitude damping in the X
    basis (fold executor), each of norm 1 +- 1e-4 with its shots adding
    up and the kernels within 1e-5 of the twins on the same draws;
    ``run_with_noise`` with 256 shots over 4 trajectories; the ensemble
    single-qubit density matrices over 2 trajectories, traces 1 +- 1e-4;
    ``monitored_trajectories`` at n = 20 (T = 64, one batch) and n = 30
    (T = 2, ``final_shots=256``) on a brickwork with a ``Measure`` on
    every fourth qubit after each second layer and one measurement
    repeated at once: outcomes in {0, 1}, the repeat equal, and at n = 4
    the outcome frequencies over 4000 trajectories within 0.05 of the
    exact ones; the fold body at n = 20, T = 64 launches one kernel per
    gate for the whole batch. Timed: ms per ``Simulator.run`` at n = 30,
    31 and 32 with the executor's share and the sampler's ms for 4096
    shots, s per noisy trajectory at n = 30 by route, monitored
    trajectories/s at n = 20, and every peak.

The open-system slice adds:

8.  the exact open-system path. 8a: ``DensityMatrixSimulator(device=
    "cuda").run(method="superop")`` on brickwork depth 8 (seed 42) with
    depolarizing 0.05 after every gate and amplitude damping 0.05 after
    each CNOT, Ry+CNOT (a real vec(rho)) and Ry/Rz (planar), and Ry/Rz
    with no noise, at n = 12 and n = 14 (2n = 28, the widest vec(rho)
    below the large-state regime): launches equal to the vec(rho) plan's
    dense and cross steps, the kernel executor within 1e-5 of the twin
    executor, the trace 1 +- 1e-4, the purity below 1 with noise and 1 +-
    1e-4 without, at n = 12 rho within 2e-5 of the dense route's, and at
    n = 8 the diagonal within 1e-5 of a NumPy complex128 density matrix;
    8b: n = 15 (2n = 30, a ``SuperopDensityResult`` over the grouped
    state): noise-free probabilities within 1e-5 of ``Simulator.run``'s,
    noisy ``<Z_q>`` within 0.05 of the mean over 2000 trajectories, the
    sample adding up, ``.rho`` raising ``MemoryError``, the peak under
    1.75x the state; 8c: ``LindbladSimulator``: one qubit's decay among
    10 against exp(-gamma t) within 1e-3, an Ising chain with dephasing
    at n = 10 and 13 keeping trace 1 +- 1e-4, and at n = 4 the final rho
    within 1e-4 of ``expm(dense_liouvillian() t)``; 8d: the second-order
    ``trotter_circuit`` of ``heisenberg_chain(16)`` from the Neel state
    through ``Simulator.run``: kernels within 1e-5 of the twins, launches
    equal to the plan's steps, the energy kept within ``Lambda dt^2`` and
    the drift at least halved at half the step. Timed: per 8a case the
    executor (kernels and twins in turns) beside the dense route, the
    n = 15 runs, ms per RK4 step at n = 10 and 13 with the peak.

The analysis slice adds:

9.  the analysis layer. 9a: ``CircuitDebugger(device="cuda")`` on the
    brickwork (seed 42, Ry + CNOT) at n = 16 depth 40 with 50 trials and
    at n = 20 depth 8 with 256 trials (18 GiB as one stack, so cut into
    batches), depolarizing 0.01 on every gate: ``run_full_debug`` ideal
    (snapshots within 1e-5 of ``run_step_by_step`` and the final one of
    ``Simulator.run``) and noisy, ``compute_noise_attribution`` (the
    contributions telescope to gap_C - gap_0 within 1e-6, the peak within
    one batch's reckoning plus 1 GiB, two batches or more at n = 20), and
    8 trials' column stacks through the kernels and the twins on the same
    draws within 1e-5; 9b: ``quantum_volume_at_scale`` at widths 4-20,
    50 trials, depolarizing 0.002 (``scripts/quantum_volume_check.py``'s
    defaults): the ideal heavy mean in [0.83, 0.89] from width 8 on, and
    one width-20 chunk (parameter rows with splice draws) through the
    kernels and the twins on the same draws within 1e-5; 9c:
    ``collect_shadows`` of GHZ-16 (4096 snapshots, chunk 512: <Z0 Z1>
    within 0.2 of 1) and of an n = 20 Ry/Rz brickwork (1024 snapshots),
    its first chunk's rotated states through the kernels and the twins
    within 1e-5; 9d: ZNE (scales 1, 3, 5) of <Z0> after a TFIM step with
    depolarizing 0.02, on 256 trajectories per scale at n = 16 (errors
    printed only) and on the superoperator density matrix at n = 8 (the
    ZNE error below a fifth of the raw one). Timed: ms per debugger call
    and its peak, seconds per QV width, snapshots/s, ZNE seconds.

The bit-engine slice adds:

10. the bit engines. 10a: ``CliffordSimulator(device="cuda")`` on GHZ-100
    with 256 shots (``bench.py:438-453``, shots/s): only 0^100 and 1^100,
    each 40-60 %, the tableau equal to the CPU's and 32 shots equal to
    the CPU's from the same coin flips, half-chain entropy 1 bit; a
    random Clifford brickwork at n = 12 depth 10 (4096 samples inside the
    statevector's support; with H on 3 qubits TVD <= 0.05 against
    ``Simulator``); noisy GHZ-6 against the density matrix (TVD <= 0.05,
    16384 shots); ``monitored_trajectories`` at n = 128, T = 64 and
    ``run_with_noise`` at n = 64 with depolarizing 0.01 and 1024 shots
    (trajectories/s, shots/s). 10b: the repetition d = 25
    ``throughput_sweep`` at 2^20 trials (``bench.py:424-434``, trials/s);
    the four codes' ``QECSimulator`` (bit-flip and phase-flip encode
    through ``Simulator``, the main path's ``dense_axis`` launches on one
    K = 32 axis: each encode circuit's launches held to its plan and its
    state to the plain twin's at 1e-5, the encoded states the cycles use
    equal to those) against ``FrameQECSimulator.from_code`` on 1000 trials
    and one seed, per-trial flags identical; surface d = 5 (LUT) and
    d = 7 (union-find, which must decode in C) sweeps at 10^5 trials, the
    C and Python decoders equal;
    ML memory (repetition d = 9, R = 9, 4096 trials; surface d = 3) not
    above its single-shot baseline; matching memory d = 7, R = 7. 10c:
    ``circuit_level_memory`` on the surface code at d = 5, R = 5 and d = 7,
    R = 7, p = 0.003, 20,000 trials (``scripts/circuit_threshold.py``'s
    defaults; linear engine, DEM decoder): one cold call end to end, then
    DEM extraction, signature probe, sampling and host decode apart (the
    sampling+decode rate leaves the set-up out), logical failure < 0.02;
    the three engines' detection events identical at d = 3, R = 3 on 256
    rows; the port's native module built (before any timed region) and
    used.

The MPS slice adds:

11. the MPS family (no kernel of its own; every factorisation is a
    ``torch.linalg`` call, timed apart by ``LinalgClock``). 11a:
    ``MPSSimulator(device="cuda")`` on a Ry/Rz brickwork at n = 12, depth
    8, chi = 64 (``to_statevector`` within 2e-5 of ``Simulator.run``,
    truncation 0), the ``bench.py:461-483`` cell (Rx + CNOT, n = 48,
    depth 4, chi = 16, 64 shots: ms/run, gates/s, every <Z_q> within 1e-4
    of the CPU's) and the same brickwork at n = 128, depth 8, chi = 64,
    1024 shots in the Z and X bases. 11b: one batched SVD of 1024
    matrices at chi 16, 32 and 64 per driver (time, error against
    float64), ``run_with_noise`` on the bench brickwork (1024 shots,
    depolarizing and amplitude damping 0.01, chi 16 and 64) and on a deep
    n = 16 brickwork whose bonds reach 64 (32 shots), the law at n = 4
    (TVD < 0.06 against ``DensityMatrixSimulator``), and
    ``monitored_trajectories`` at n = 48, T = 64 (8 trajectories equal to
    the CPU's on the same draws). 11c: a 300-row parameter-shift
    gradient of ``hardware_efficient_ansatz(50, 2)`` on ``tfim_chain(50)``
    at chi = 16, and at n = 10, chi = 32 within 1e-4 of the statevector
    gradient. 11d: ``collect_shadows(GHZ-40, 4096, engine="mps", chi=32,
    chunk=512)``: every pair of neighbours read in Z agrees, the mean
    nearest-neighbour <ZZ> within 0.1 of 1 and each within 5 standard
    errors. 11e: ``bench.py:485-509``'s DMRG (TFIM n = 64, chi = 16, 5
    sweeps, K = 10, warm; relative error < 1e-4 against free fermions)
    and ``dmrg_excited_states`` at n = 8 within 5e-4 of ``eigvalsh``.
    11f: the README's MPS Lindblad run (n = 40, chi = 16, 40 steps, 16
    trajectories) and n = 3 against the dense ``LindbladSimulator``
    (4 standard errors + 0.025). 11g: a TFIM quench correlator at n = 40,
    chi = 32, 40 steps, and at n = 8 against ``expm`` within 5e-4.

The parallel slice adds:

12. the shard mesh (``quantum_simulator_tpu_torch.parallel``), 8 shards
    stacked on the card (one rank). 12a: n = 30 Ry/Rz brickwork, depth
    8, and ``hardware_efficient_ansatz(30, 4)`` (27 local qubits: mini
    plans, each dense and cross step one launch for all shards), each
    within 2e-5 of ``Simulator.run`` and within 1e-5 of the same run
    through the twins, exchanges equal to the schedule's, launches equal
    to the mini plans' steps, dense and cross launches both > 0 (the
    brickwork's plans hold no cross step, the ansatz's do), peak <= 1.75x
    the 8 GiB state. 12b: QFT-32 on a basis input (32 GiB): fidelity against the
    analytic DFT row > 1 - 1e-4 (shard by shard, on the card), no CPhase
    schedules an exchange, every <Z_q> within 1e-4 of 0, 1000 shard-local
    shots, peak <= 1.75x. 12c: ``scripts/mesh_stretch_check.py``'s n = 32
    Ry+CNOT brickwork, depth 40, through ``run_segmented(4)``: norm
    within 1e-4, finite <Z> probes, seeded counts repeat; wall time and
    the exchanges' share (each exchange between synchronizes). 12d:
    ``run_with_noise`` at n = 24 (depolarizing 0.05, 16 trajectories,
    1024 shots; trajectories/s) and at n = 10 the card's trajectories
    equal the CPU's on the same Gumbel rows (1e-5, draws clear of ties).
    12e: ``sharded_vqe_step`` (traj 2 x amp 4) on
    ``hardware_efficient_ansatz(20, 4)`` at random angles with a ZZ-chain
    cost: cost and gradient within 1e-4 of the one-device parameter-shift
    rows, then 3 Adam steps timed. 12f: a checkpointed ``run_segmented``
    at n = 26 stopped from its progress callback and resumed equals an
    uninterrupted one. 12g: the ``mesh=`` engines (Steane ``sweep_raw``,
    surface d = 5, R = 5 circuit-level memory, MPS Lindblad with 16
    trajectories) identical to ``mesh=None`` (on one rank only the
    Lindblad case takes another path; the gloo test splits the trials).

The front-end slice adds:

13. the front ends. 13a: ``BridgeServer(BridgeCommandHandler(device=
    "cuda"), port=0)`` and a ``SimulatorClient`` over a localhost socket:
    ping; the headline n = 16 depth-40 Ry+CNOT brickwork, ``run`` with
    4096 shots twice (dense and cross launches equal to the plan's steps
    each time), the full ``get_state`` within 1e-5 of the plain-twin
    executor, ``get_analysis`` (fidelity, entropy, purity, every qubit's
    Paulis) within 1e-5 of direct ``StateAnalysis`` calls; n = 28 depth-8
    Ry/Rz ``run`` with 1024 shots (launches = the plan's, peak <= 6.1
    GiB) and three windows of 2^16 amplitudes (offsets 0, 2^27 and
    2^28 - 2^16) within 1e-5 of the twin state; depolarizing 0.05 +
    readout through ``set_noise``, then ``run_with_noise`` at n = 16 with
    1024 shots (launches = the trajectory plans' steps x batches);
    ``sweep_parameter`` (depolarizing 0, 0.01, 0.05, 256 trials) on the
    n = 20 depth-8 brickwork of ``bench.py:221-226``: launches = the
    plans' steps x batches, fidelity in (0, 1] and falling with p, purity
    within 1e-5 of tr(rho^2) of the same trajectory states in float64
    (and below 1 - 1e-3 at p = 0.05); the MPS engine at the
    ``bench.py:457-483`` cell (n = 48, chi = 16, 64 shots: counts add up,
    finite truncation weight, no kernel launch); an unknown action comes
    back as an error reply and the server answers on. 13b:
    ``SimulationController(device="cuda")`` (``on_error`` recorded and
    checked): ``run_simulation`` at n = 28 within 1e-5 of a direct
    ``Simulator.run``, ``run_step_by_step`` at n = 16 depth 8 (9 steps,
    the last within 1e-5 of ``run``); ``FidelitySweepModel.sweep`` at
    n = 16 (64 trials); ``DensityMatrixModel(device="cuda")`` at n = 8:
    ``exact`` within 2e-5 of a NumPy Kraus-sum rho, ``ensemble`` (1000
    trials) within 0.05 of it. Printed: each bridge request's round trip
    and each controller / view-model wall time, with the card.

The entry-point slice adds:

14. the command-line twins. ``quantum_simulator_tpu_torch.entry.entry
    ("cuda")``'s forward (|psi|^2 of the 16-qubit flagship brickwork,
    both kernels) within 1e-5 of the same forward through the twins,
    then ``main`` of ``entry`` and of every script and example twin
    (``quantum_simulator_tpu_torch/scripts``, ``.../examples``) at its
    default arguments, except the two cuts named at ``ENTRY_TWINS``:
    each must return 0, its own checks deciding (the QFT-32 fidelity
    against the DFT row, the Grover-30 amplitude, norms, shot counts, GHZ
    correlations). Printed per twin: seconds, peak memory and launches.

The GUI slice adds:

15. the GUI (``quantum_simulator_tpu_torch.gui``) at its full width
    (``AppConfig.max_qubits = 16``): ``MainWindow(AppConfig(),
    device="cuda")`` over display stand-ins for the toolkits the machine
    lacks (the functional PyQt6 stand-ins of ``tests/qt_stub.py``, else
    real Qt on the offscreen platform; a recording matplotlib stand-in,
    ``tests/torch_gui_stubs.py``), named on an output line and undone at
    the end. 15a: one Run click (``_run_with_shots(4096)``) on the n = 16
    depth-40 Ry+CNOT brickwork: launches twice the plan's steps (the
    ideal pass, then the shots run), the final and the stored reference
    state within 1e-5 of the plain-twin executor, 4096 shots, the panels
    fed. 15b: depolarizing 0.01 + readout built through
    ``NoiseConfigDialog``, a noisy Run click (launches = the ideal plan +
    the trajectory batches' plans, the reference still within 1e-5), step
    mode over all 41 states. 15c: the debugger panel (noisy, its 50
    trials; the last ideal snapshot within 1e-5), the comparison panel
    (the fidelity within 1e-5 of the twins' overlap), the optimizer (3
    parameter-shift iterations) and the QEC sweep on real worker threads,
    joined, each entering ``device_scope`` with the window's pinned
    device, the QEC cycle, the benchmark suite (every benchmark passes).
    15d: the bridge toggled on (an ephemeral port), one client run
    (launches = the plan's), toggled off. A critical message box (the run
    pipeline catches every error into one) or an exception on a worker
    thread fails the phase. Printed per action: wall s, peak GiB from a
    fresh counter, launches from zero.

The acceptance slice adds:

16. the acceptance programs' twins on the card. 16a: the harness
    (``quantum_simulator_tpu_torch.validation.run_groups("cuda")``, every
    line printed) gives 33/33, its four ``[perf]`` bounds included, with
    at least 2 + 3 dense launches (the plans of groups 8 and 9); its Bell
    state, its group-8 Ry layers (the (8, 128) plan) and its 20-qubit H
    layer on the card within 1e-5 of the same circuits on the CPU. 16b:
    the parity twin's ``run_ours(200)`` on the card and on the CPU, held
    together through its ``compare`` (every check passes); only where
    ``--reference PATH`` names the reference engine's checkout does the
    real comparison (``parity_check.main``) run, and then it must pass
    too. 16c: the latency twin's ``main`` at its defaults (n = 16, depth
    8, the second process included) must return 0 (every edit < 2 s, the
    child found the kernel library built); its JSON is printed with the
    second process's time beside its 10 s target, and its launches in
    this process equal 4 x (10 dense + 8 cross) for the ideal runs plus
    the two noisy trajectories' plans. The warm 1-gate edit is then split
    (outside the count): its host operand build on the host clock and its
    executor's 18 launches in CUDA events, best of 3.

``--phases 2c,6`` runs only the named phases (and then prints no summary
and no result line): for bringing up one phase on the card.

Launch counts in the summary are those of the main paths: phase 3 is
driven with the counters set to 0 just before it and read just after; in
phases 3b, 5, 6, 7, 8, 9 and 10 each run, trajectory, gradient, optimizer,
debugger, quantum-volume, shadows, ZNE and QEC encode is, in phase 11
the two statevector references (11a, 11c), in phase 12 the mesh runs
of 12a-12c, the VQE steps of 12e and the segmented runs of 12f, in
phase 13 every bridge request and controller or view-model run, in
phase 14 ``entry()``'s forward and each twin's ``main``, in phase 15
every GUI action, and in phase 16 the harness, the parity twin's card
half and the latency twin's ``main`` (its child process uncounted). The
comparison runs against the twins launch nothing (phases 5, 12 and 14 check
it); phase 16 reruns two circuits on the card, outside its count, to hold
them against the CPU.

The line before the last is the JSON kernel summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits with an
error and prints no result. ``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                         DensityMatrixSimulator,
                                         DepolarizingNoise,
                                         LindbladSimulator,
                                         MarginalStateSummary,
                                         MeasurementBasis, NoiseChannel,
                                         NoiseModel, PlanarStateVector,
                                         QuantumCircuit, ReadoutError,
                                         Simulator, StateAnalysis,
                                         StateVector,
                                         TwoQubitDepolarizingNoise)
from quantum_simulator_tpu_torch import clifford as tclif
from quantum_simulator_tpu_torch import correlators as tcorr
from quantum_simulator_tpu_torch import density as tdens
from quantum_simulator_tpu_torch import dmrg as tdmrg
from quantum_simulator_tpu_torch import entry as tentry
from quantum_simulator_tpu_torch import native as tnative
from quantum_simulator_tpu_torch import qec as tqec
from quantum_simulator_tpu_torch import qec_circuit as tqc
from quantum_simulator_tpu_torch import qec_dem as tqd
from quantum_simulator_tpu_torch import qec_frame as tqf
from quantum_simulator_tpu_torch import qec_matching as tqm
from quantum_simulator_tpu_torch import lindblad as tlind
from quantum_simulator_tpu_torch import lindblad_mps as tlmps
from quantum_simulator_tpu_torch import models
from quantum_simulator_tpu_torch import mps as tmps
from quantum_simulator_tpu_torch import optimizer as topt
from quantum_simulator_tpu_torch import parallel as tpar
from quantum_simulator_tpu_torch import simulator as tsim
from quantum_simulator_tpu_torch.density import SuperopDensityResult
from quantum_simulator_tpu_torch.ops import (_build, bigstate, bigtraj,
                                             cuda_exec)
from quantum_simulator_tpu_torch.ops import apply as tapply
from quantum_simulator_tpu_torch.ops import monomial_traj as tmono
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.ops import unitary_traj as tunit
from quantum_simulator_tpu_torch.parallel import distributed as tdist
from quantum_simulator_tpu_torch import validation
from quantum_simulator_tpu_torch.scripts import (interactive_latency_check,
                                                 mesh_stretch_check,
                                                 parity_check)

DENSE_TOL = 2e-4
CROSS_TOL = 2e-3
STATE_TOL = 1e-5
# A kernel's max error against float64 may be at most this times the
# plain twin's (n = 16 and 28).
F64_RATIO = 2.0
F64_SIZES = (16, 28)
# Simulator.run(shots=0) peak for n=28 depth-8 Ry/Rz: one planar state
# (2 GiB) in place plus the complex result, with room to spare.
RUN_PEAK_LIMIT = 6.1 * 2**30
SEED = 42
PHASES = ("2", "2b", "2c", "3", "3b", "4", "4b", "5", "6", "7", "8", "9",
          "10", "11", "12", "13", "14", "15", "16")

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


def event_ms(fn, prep=None, reps: int = 3) -> float:
    """Best-of-``reps`` device milliseconds of ``fn(prep())`` (CUDA
    events; ``prep`` runs before the timed region)."""
    best = float("inf")
    for _ in range(reps):
        arg = prep() if prep else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg) if prep else fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
        del arg
    return best


def in_turns(plain_fn, kernel_fn, prep=None,
             reps: int = 3) -> tuple[float, float]:
    """Warm both, then time plain, kernel, kernel, plain; best of each."""
    for fn in (plain_fn, kernel_fn):
        fn(prep()) if prep else fn()
    torch.cuda.synchronize()
    p1 = event_ms(plain_fn, prep, reps)
    k1 = event_ms(kernel_fn, prep, reps)
    k2 = event_ms(kernel_fn, prep, reps)
    p2 = event_ms(plain_fn, prep, reps)
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
    """(kernel, label, key, shape, planar, op, run_kernel, run_plain, tol)
    for every case; ``run_plain(x, op)`` takes the operator so it can also
    run in float64."""
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
                              lambda x, op, a=axis, p=planar:
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
                          lambda x, c, g=(s, pos, o), p=planar:
                          cuda_exec.cross_bit_axis_plain(x, c, *g, p),
                          CROSS_TOL))
    return cases


def library_call(name: str, x: torch.Tensor, op: torch.Tensor, geom,
                 planar: bool):
    """One ``torch.einsum`` (cuBLAS fp32, TF32 off) computing the kernel's
    function on the same inputs, its operator blocked beforehand: the
    library yardstick. The plain twin is this call plus the blocking."""
    real = op.ndim == (2 if name == "dense_axis" else 4)
    blk = op if real else cuda_exec._blocked(op)
    shape = cuda_exec._layout_shape(x, planar)
    lead = (2,) if planar else ()
    if name == "dense_axis":
        spec = cuda_exec._dense_spec(len(shape), geom, real, planar)
        return lambda: torch.einsum(spec, blk, x)
    s, pos, o = geom
    new_shape, bit_axis = cuda_exec._split_axis_bit(shape, s, pos)
    spec = cuda_exec._cross_spec(len(new_shape), bit_axis,
                                 o + (2 if o > s else 0), real, planar)
    xr = x.reshape(lead + new_shape)
    return lambda: torch.einsum(spec, blk, xr)


def rates(shape, planar: bool, real: bool, K: int, ms: float):
    """(TB/s, TFLOP/s, unit): bytes read and written once; TF32 FLOPs of
    the 3-pass split for K >= MMA_MIN_K, fp32 FLOPs below."""
    numel = (2 if planar else 1) * int(np.prod(shape))
    flops = 2 * K * numel * (1 if real else 2)
    tf32 = K >= cuda_exec.MMA_MIN_K
    return (2 * 4 * numel / (ms * 1e9), (3 if tf32 else 1) * flops /
            (ms * 1e9), "TF32" if tf32 else "fp32")


def phase_kernels(report: dict, card: str) -> dict:
    rng = np.random.default_rng(SEED)
    rows = []
    max_err = {"dense_axis": 0.0, "cross_bit_axis": 0.0}
    summary = {}
    for (name, label, key, shape, planar, op, kfn, pfn,
         tol) in kernel_cases(rng):
        n, real = key[0], key[3]
        torch.cuda.empty_cache()
        x = random_state(shape, planar, seed=len(rows))
        x0 = x.clone()
        got = kfn(x)
        torch.cuda.synchronize()
        check(got is x, f"{label}: the wrapper did not return its input")
        want = pfn(x0, op)
        err = float((got - want).abs().max())
        check(err <= tol, f"{label}: max |kernel - plain| = {err} > {tol}")
        f64 = {}
        if n in F64_SIZES:
            ref = pfn(x0.double(), op.double())
            f64 = {"kernel_f64_err": float((got.double() - ref).abs().max()),
                   "plain_f64_err": float((want.double() - ref).abs().max())}
            del ref
            check(f64["kernel_f64_err"] <= F64_RATIO * f64["plain_f64_err"],
                  f"{label}: max error against float64 "
                  f"{f64['kernel_f64_err']:.3e} > {F64_RATIO} x the "
                  f"twin's {f64['plain_f64_err']:.3e}")
        del got, want
        # timed in place on x (the kernel) and out of place on x0 (twin)
        k_ms, p_ms = in_turns(lambda: pfn(x0, op), lambda: kfn(x))
        del x, x0
        K = shape[key[1]] if name == "dense_axis" else 2 * shape[key[1][2]]
        tbs, tfl, unit = rates(shape, planar, real, K, k_ms)
        max_err[name] = max(max_err[name], err)
        row = {"kernel": name, "case": label, "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms, "TB_per_s": tbs,
               f"{unit}_TFLOP_per_s": tfl, **f64}
        rows.append(row)
        f64_txt = (f" f64 err kernel {f64['kernel_f64_err']:.3e} twin "
                   f"{f64['plain_f64_err']:.3e}" if f64 else "")
        print(f"kernel {label} [{card}]: err {err:.3e}{f64_txt} kernel "
              f"{k_ms:.4f} ms plain {p_ms:.4f} ms; {tbs:.3f} TB/s "
              f"{tfl:.1f} {unit} TFLOP/s", flush=True)
        kind, sn, geom, sp, sr = SUMMARY[name]
        want_key = (sn, geom, sp, sr)
        if key == want_key:
            x0 = random_state(shape, planar, seed=len(rows))
            row["library_ms"] = event_ms(library_call(name, x0, op, geom,
                                                      planar))
            row["bound_ms"], row["bound_by"] = bound(shape, planar, sr, K)
            del x0
            summary[name] = row
    torch.cuda.empty_cache()
    report["kernel_cases"] = rows
    return {"max_err": max_err, "summary": summary}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def step_counts(program) -> tuple[int, int, int]:
    """(dense, cross, other) steps of the program's group plan."""
    plan = tplan.build_group_plan(program)
    n_dense = sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps)
    n_cross = sum(isinstance(s, tplan.CrossStep) for s in plan.steps)
    return n_dense, n_cross, len(plan.steps) - n_dense - n_cross


def run_and_match(sim: Simulator, circuit: QuantumCircuit, label: str,
                  shots: int, report: dict):
    """Simulator.run, its launch counts against the plan, and its final
    state against the plain-twin executor on the card."""
    program = tprog.compile_circuit(circuit)
    n_dense, n_cross, _ = step_counts(program)
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

            def fresh():
                return tplan.basis_state(plan, program.initial_index,
                                         "cuda", planar)

            def executor(plain):
                # the executor owns (and the kernels overwrite) its state
                return lambda x: tplan.execute_group_plan(
                    plan, ops, program, params, x, planar, plain)

            k_ms, p_ms = in_turns(executor(True), executor(False), fresh)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            executor(False)(fresh())
            torch.cuda.synchronize()
            exec_peak = torch.cuda.max_memory_allocated() - base
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
            if n == 28 and mix:
                check(step_counts(program)[2] == 0,
                      f"{label}: plan has steps other than dense and cross")
                check(peak <= RUN_PEAK_LIMIT,
                      f"{label}: Simulator.run(shots=0) peak "
                      f"{peak / 2**30:.3f} GiB > "
                      f"{RUN_PEAK_LIMIT / 2**30} GiB")
            row = {"circuit": label, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "kernel_layers_per_s": depth / (k_ms / 1e3),
                   "plain_layers_per_s": depth / (p_ms / 1e3),
                   "run_wall_ms": wall_ms, "host_operand_build_ms":
                   build_s * 1e3, "run_peak_bytes": peak,
                   "executor_peak_bytes": exec_peak,
                   "steps": len(plan.steps),
                   "passes": tplan.count_state_passes(plan), "card": card}
            report.setdefault("timing", []).append(row)
            print(f"time {label} [{card}]: executor kernel {k_ms:.3f} ms "
                  f"({row['kernel_layers_per_s']:.1f} layers/s), plain "
                  f"{p_ms:.3f} ms ({row['plain_layers_per_s']:.1f} "
                  f"layers/s); Simulator.run {wall_ms:.3f} ms "
                  f"(host operand build {build_s * 1e3:.3f} ms); peak "
                  f"executor {exec_peak / 2**30:.3f} GiB, Simulator.run "
                  f"(shots=0) {peak / 2**30:.3f} GiB", flush=True)


# ---------------------------------------------------------------------------
# Bounds (the H100 SXM's published peaks, NVIDIA's data sheet)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12


def bound(shape, planar: bool, real: bool, K: int, batch: int = 1,
          op_copies: int = 1) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one launch: each state
    element read and written once plus each distinct operator read once,
    at 3.35 TB/s; against its products, 2K FLOPs per real output element
    (x2 complex), as the 3xTF32 split's three TF32 passes at 495 TFLOP/s
    for K >= MMA_MIN_K and as fp32 at 67 TFLOP/s below."""
    numel = batch * (2 if planar else 1) * int(np.prod(shape))
    op_bytes = op_copies * 4 * K * K * (1 if real else 2)
    t_bytes = (8 * numel + op_bytes) / HBM_BYTES_PER_S
    flops = 2 * K * numel * (1 if real else 2)
    t_ops = (3 * flops / TF32_FLOP_PER_S if K >= cuda_exec.MMA_MIN_K
             else flops / FP32_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Phase 2b: batched kernels vs batched twins
# ---------------------------------------------------------------------------

# Layouts of n = 10, 16, 20 and 24 qubits and the bench depths of the
# noisy cases there (bench.py:221-226; n = 16 is the headline depth-40).
BATCH_LAYOUTS = {10: ((8, 128), 10), 16: ((4, 128, 128), 40),
                 20: ((64, 128, 128), 8), 24: ((8, 128, 128, 128), 8)}
BATCH_SIZES = (16, 256)
BATCH_STATE_CAP = 8 * 2**30   # bytes of a planar batch


def noise_model(label: str, p: float = 0.05) -> NoiseModel:
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(p) if label == "depol"
                        else AmplitudeDampingNoise(p))
    return nm


def noisy_plans(program, nm) -> list:
    """The group plans one batch of trajectories runs: the spliced program
    (mixed-unitary noise) or every window's segment (monomial noise)."""
    route = tprog.trajectory_route(program, nm)
    if route == "unitary":
        return [tplan.get_group_plan(
            tunit.unitary_insert_spec(program, nm).aug)]
    if route == "monomial":
        return [tplan.get_group_plan(s)
                for s in tmono.monomial_spec(program, nm).segments]
    raise RuntimeError(f"route {route} has no plan list")


def noisy_cross_geometries(n: int, depth: int) -> list:
    program = tprog.compile_circuit(brickwork(n, depth, SEED, False))
    geoms = set()
    for label in ("depol", "amp-damp"):
        for plan in noisy_plans(program, noise_model(label)):
            geoms |= {(s.slice_axis, s.slice_pos, s.op_axis)
                      for s in plan.steps if isinstance(s, tplan.CrossStep)}
    return sorted(geoms)


def batch_op(B: int, shape, real: bool, shared: bool,
             gen: torch.Generator) -> torch.Tensor:
    """N(0, 1/K) entries (as ``random_op``); shared = one operator repeated
    with stride 0."""
    k = shape[-1] * (2 if len(shape) == 4 else 1)
    full = tuple(shape) if real else (2,) + tuple(shape)
    lead = 1 if shared else B
    a = torch.randn((lead,) + full, generator=gen, device="cuda")
    a /= float(np.sqrt(k))
    return a.expand((B,) + full)


def phase_batched_kernels(report: dict, card: str) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    rows = []
    max_err = {"dense_axis": 0.0, "cross_bit_axis": 0.0}
    for n, (shape, depth) in BATCH_LAYOUTS.items():
        geoms = noisy_cross_geometries(n, depth)
        per_traj = 8 * int(np.prod(shape))
        sizes = sorted({min(b, BATCH_STATE_CAP // per_traj)
                        for b in BATCH_SIZES})
        cases = [("dense_axis", (a,), shape[a]) for a in range(len(shape))]
        cases += [("cross_bit_axis", g, 2 * shape[g[2]]) for g in geoms]
        for B in sizes:
            for planar, real in ((False, True), (True, False)):
                for shared in (True, False):
                    for name, geom, K in cases:
                        torch.cuda.empty_cache()
                        op_shape = ((K, K) if name == "dense_axis"
                                    else (2, K // 2, 2, K // 2))
                        op = batch_op(B, op_shape, real, shared, gen)
                        kfn = getattr(cuda_exec, name)
                        pfn = getattr(cuda_exec, name + "_plain")
                        x = torch.randn((B,) + ((2,) if planar else ())
                                        + shape, generator=gen,
                                        device="cuda")
                        x0 = x.clone()
                        got = kfn(x, op, *geom, planar, True)
                        torch.cuda.synchronize()
                        label = (f"batched {name} n={n} B={B} geom={geom} "
                                 f"{'planar' if planar else 'real'}-state "
                                 f"{'real' if real else 'complex'}-op "
                                 f"{'shared' if shared else 'per-trajectory'}")
                        check(got is x, f"{label}: the wrapper did not "
                              "return its input")
                        want = pfn(x0, op, *geom, planar, True)
                        tol = DENSE_TOL if name == "dense_axis" else CROSS_TOL
                        err = float((got - want).abs().max())
                        check(err <= tol, f"{label}: max |kernel - plain| = "
                              f"{err} > {tol}")
                        f64 = {}
                        if n <= 16:
                            ref = pfn(x0.double(), op.double(), *geom,
                                      planar, True)
                            f64 = {"kernel_f64_err": float(
                                       (got.double() - ref).abs().max()),
                                   "plain_f64_err": float(
                                       (want.double() - ref).abs().max())}
                            del ref
                            check(f64["kernel_f64_err"] <= F64_RATIO
                                  * f64["plain_f64_err"],
                                  f"{label}: error against float64 "
                                  f"{f64['kernel_f64_err']:.3e} > "
                                  f"{F64_RATIO} x the twin's "
                                  f"{f64['plain_f64_err']:.3e}")
                        del got, want
                        k_ms, p_ms = in_turns(
                            lambda: pfn(x0, op, *geom, planar, True),
                            lambda: kfn(x, op, *geom, planar, True), reps=2)
                        del x, x0
                        tbs, tfl, unit = rates((B,) + shape, planar, real, K,
                                               k_ms)
                        b_ms, b_by = bound(shape, planar, real, K, B,
                                           1 if shared else B)
                        max_err[name] = max(max_err[name], err)
                        rows.append({"kernel": name, "case": label,
                                     "n": n, "B": B, "shared": shared,
                                     "max_abs_err": err, "ms": k_ms,
                                     "plain_ms": p_ms, "TB_per_s": tbs,
                                     f"{unit}_TFLOP_per_s": tfl,
                                     "bound_ms": b_ms, "bound_by": b_by,
                                     **f64})
                        print(f"{label} [{card}]: err {err:.3e} kernel "
                              f"{k_ms:.4f} ms plain {p_ms:.4f} ms; "
                              f"{tbs:.3f} TB/s {tfl:.1f} {unit} TFLOP/s; "
                              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    report["batched_kernel_cases"] = rows
    slower = sum(r["ms"] > r["plain_ms"] for r in rows)
    print(f"batched kernels: {len(rows)} cases, {slower} slower than the "
          f"twin [{card}]", flush=True)
    return max_err


# ---------------------------------------------------------------------------
# Phase 3b: the noisy path
# ---------------------------------------------------------------------------

# (label, n, depth, trajectories): bench.py:221-226
NOISY_CASES = [("depol", 10, 10, 1024), ("depol", 20, 8, 256),
               ("depol", 24, 8, 16), ("amp-damp", 20, 8, 256),
               ("amp-damp", 24, 8, 16)]
LAW_TRAJ = 2000
LAW_TOL = 0.05


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in cuda_exec.KERNELS}


def add_launches(total: dict, before: dict) -> dict:
    now = launch_counts()
    delta = {k: now[k] - before[k] for k in now}
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    return delta


def _kraus_sum(rho, kraus, targets, n: int):
    """sum_K K rho K^+ with K on ``targets`` of a (2,)*2n density tensor."""
    k = len(targets)
    rows = list(targets)
    cols = [n + q for q in targets]
    out = np.zeros_like(rho)
    for K in kraus:
        g = np.asarray(K, np.complex128).reshape((2,) * (2 * k))
        t = np.tensordot(g, rho, axes=(list(range(k, 2 * k)), rows))
        t = np.moveaxis(t, list(range(k)), rows)
        t = np.tensordot(t, g.conj(), axes=(cols, list(range(k, 2 * k))))
        out += np.moveaxis(t, list(range(2 * n - k, 2 * n)), cols)
    return out


def density_rho_reference(program, nm) -> np.ndarray:
    """rho of the noisy circuit, evolved gate by gate in NumPy
    complex128, each gate's channels applied after it as Kraus sums
    (one-qubit stacks on each target, two-qubit stacks on the gate's
    pair)."""
    n = program.num_qubits
    rho = np.zeros((1 << n, 1 << n), np.complex128)
    rho[program.initial_index, program.initial_index] = 1.0
    rho = rho.reshape((2,) * (2 * n))
    params = program.initial_params
    for op in program.ops:
        rho = _kraus_sum(rho, [program.op_matrix(op, params, np.complex128)],
                         op.targets, n)
        for stack in nm.kraus_stacks_for_gate(op.gate_name):
            if stack.shape[1] == 2:
                for q in op.targets:
                    rho = _kraus_sum(rho, stack, (q,), n)
            else:
                rho = _kraus_sum(rho, stack, op.targets, n)
    return rho.reshape(1 << n, 1 << n)


def density_reference(program, nm) -> np.ndarray:
    """Exact probabilities of the noisy circuit (the diagonal of
    ``density_rho_reference``)."""
    return np.real(np.diagonal(density_rho_reference(program, nm)))


def phase_noisy(report: dict, card: str) -> dict:
    """Every sub-run of the noisy main path reads its launches from zero;
    the comparison runs against the twins are not counted."""
    path = {}
    for label, n, depth, T in NOISY_CASES:
        circuit = brickwork(n, depth, SEED, False)
        nm = noise_model(label)
        program = tprog.compile_circuit(circuit)
        plans = noisy_plans(program, nm)
        n_dense = sum(isinstance(s, tplan.AxisMatmulStep)
                      for p in plans for s in p.steps)
        n_cross = sum(isinstance(s, tplan.CrossStep)
                      for p in plans for s in p.steps)
        chunk = tsim._chunk_size(program, nm, T)
        n_chunks = -(-T // chunk)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        t0 = time.perf_counter()
        states = Simulator(noise_model=nm, device="cuda").trajectory_states(
            circuit, T, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = add_launches(path, {k: 0 for k in launch_counts()})
        peak = torch.cuda.max_memory_allocated()
        case = f"{label} n={n} depth-{depth} T={T}"
        check(tuple(states.shape) == (T, 1 << n),
              f"{case}: states of shape {tuple(states.shape)}")
        check(delta["dense_axis"] == n_dense * n_chunks
              and delta["cross_bit_axis"] == n_cross * n_chunks,
              f"{case}: launches {delta}, plans have {n_dense} dense and "
              f"{n_cross} cross steps x {n_chunks} batches")
        norms = states.abs().square().sum(-1)
        norm_err = float((norms - 1).abs().max())
        check(norm_err <= 1e-4, f"{case}: max |norm - 1| = {norm_err}")
        del states, norms
        # the same draws through the kernel and the plain-twin executors
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        got, draws = tprog.batched_trajectories(
            program, nm, program.initial_params, T, "cuda", gen)
        want, _ = tprog.batched_trajectories(
            program, nm, program.initial_params, T, "cuda", draws=draws,
            plain=True)
        err = float((got - want).abs().max())
        check(err <= STATE_TOL, f"{case}: max |kernel - plain| = {err} on "
              "the same draws")
        del got, want, draws
        print(f"noisy {case} [{card}]: route "
              f"{tprog.trajectory_route(program, nm)}, {n_chunks} batch(es) "
              f"of <= {chunk}, launches dense {delta['dense_axis']} cross "
              f"{delta['cross_bit_axis']} (plans {n_dense} + {n_cross}), "
              f"max |norm - 1| {norm_err:.2e}, kernel vs plain {err:.2e}, "
              f"trajectory_states {wall:.3f} s (cold), peak "
              f"{peak / 2**30:.3f} GiB", flush=True)
        report.setdefault("noisy", []).append(
            {"case": case, "batches": n_chunks, "chunk": chunk,
             "launches": delta, "plan_dense": n_dense,
             "plan_cross": n_cross, "norm_err": norm_err,
             "kernel_vs_plain": err, "cold_s": wall, "peak_bytes": peak})

    nm = noise_model("depol")
    nm.set_readout_error(ReadoutError(0.01, 0.02))
    cuda_exec.reset_launch_counts()
    res = Simulator(noise_model=nm, device="cuda").run_with_noise(
        brickwork(16, 40, SEED, False), shots=1024, seed=SEED)
    add_launches(path, {k: 0 for k in launch_counts()})
    shots = sum(res.measurement_counts.values())
    check(shots == 1024, f"run_with_noise returned {shots} shots")
    print(f"noisy run_with_noise n=16 depth-40 Ry+CNOT, depolarizing 0.05 "
          f"+ readout [{card}]: {shots} shots, "
          f"{len(res.measurement_counts)} distinct strings", flush=True)

    law = {"depol": DepolarizingNoise(0.1),
           "amp-damp": AmplitudeDampingNoise(0.2),
           "2q-depol": TwoQubitDepolarizingNoise(0.3)}
    circuit = brickwork(4, 6, SEED, True)
    program = tprog.compile_circuit(circuit)
    for name, ch in law.items():
        nm = NoiseModel()
        if name == "2q-depol":
            nm.add_gate_noise("CNOT", ch)
        else:
            nm.add_global_noise(ch)
        want = density_reference(program, nm)
        cuda_exec.reset_launch_counts()
        states = Simulator(noise_model=nm, device="cuda").trajectory_states(
            circuit, LAW_TRAJ, seed=SEED)
        add_launches(path, {k: 0 for k in launch_counts()})
        got = states.abs().square().mean(0).double().cpu().numpy()
        dev = float(np.abs(got - want).max())
        check(dev <= LAW_TOL, f"law {name}: max |ensemble - rho| = {dev}")
        print(f"noisy law n=4 {name} [{card}]: {LAW_TRAJ} trajectories, "
              f"max |p - p_rho| = {dev:.4f} (<= {LAW_TOL})", flush=True)
        report.setdefault("law", []).append({"channel": name,
                                             "max_dev": dev})
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the noisy path: {path}")
    report["noisy_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 4b: noisy timing
# ---------------------------------------------------------------------------

class Spans:
    """CUDA-event spans summed by name (read after a synchronize)."""

    def __init__(self):
        self.pairs: dict[str, list] = {}

    def span(self, name: str):
        spans = self

        class _Ctx:
            def __enter__(self):
                self.a = torch.cuda.Event(enable_timing=True)
                self.b = torch.cuda.Event(enable_timing=True)
                self.a.record()

            def __exit__(self, *exc):
                self.b.record()
                spans.pairs.setdefault(name, []).append((self.a, self.b))
        return _Ctx()

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.pairs.items()}


def traced_batch(program, nm, T: int, gen) -> dict:
    """One batch of the splice bodies with its device time split into
    draws, operand build and executor (the bodies' own steps, each
    bracketed by CUDA events)."""
    sp = Spans()
    params = program.initial_params
    if tprog.trajectory_route(program, nm) == "unitary":
        spec = tunit.unitary_insert_spec(program, nm)
        plan = tplan.get_group_plan(spec.aug)
        with sp.span("draws"):
            branch = tunit.draw_branches(spec, T, "cuda", gen)
        with sp.span("operand_build"):
            ops = tplan.build_group_operands_batched(
                spec.aug, plan, params, T, "cuda",
                tunit.branch_overrides(spec, branch))
        planar = not plan.all_real
        x = tplan.basis_state(plan, spec.aug.initial_index, "cuda", planar, T)
        with sp.span("executor"):
            x = tplan.execute_group_plan(plan, ops, spec.aug, params, x,
                                         planar, batched=True)
            tunit.finalize(x, planar)
        return sp.ms()
    spec = tmono.monomial_spec(program, nm)
    layout = tplan.GroupLayout.for_qubits(program.num_qubits)
    plans = [tplan.get_group_plan(s) for s in spec.segments]
    planar = not (spec.real and all(p.all_real for p in plans))
    x = tplan.layout_basis_state(layout, program.initial_index, "cuda",
                                 planar, T)
    overrides = None
    for w, seg in enumerate(spec.segments):
        with sp.span("operand_build"):
            ops = tplan.build_group_operands_batched(seg, plans[w], params,
                                                     T, "cuda", overrides)
        with sp.span("executor"):
            x = tplan.execute_group_plan(plans[w], ops, seg, params, x,
                                         planar, batched=True)
        del ops
        if w == len(spec.windows):
            break
        with sp.span("draws"):
            idxs, nsq = tmono._sample_axes(x, planar, layout, gen)
            overrides, _, _ = tmono._window_draws(
                spec, spec.windows[w], idxs, nsq, layout, gen)
    with sp.span("executor"):
        tunit.finalize(x, planar)
    return sp.ms()


def phase_noisy_timing(card: str, report: dict) -> None:
    for label, n, depth, T in NOISY_CASES:
        program = tprog.compile_circuit(brickwork(n, depth, SEED, False))
        nm = noise_model(label)
        params = program.initial_params

        def body(plain):
            def run():
                gen = torch.Generator(device="cuda")
                gen.manual_seed(SEED)
                return tprog.batched_trajectories(program, nm, params, T,
                                                  "cuda", gen, plain=plain)
            return run

        torch.cuda.empty_cache()
        k_ms, p_ms = in_turns(body(True), body(False), reps=2)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        traced_batch(program, nm, T, gen)          # warm
        split = traced_batch(program, nm, T, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        body(False)()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        case = f"{label} n={n} depth-{depth} T={T}"
        row = {"case": case, "kernel_ms": k_ms, "plain_ms": p_ms,
               "kernel_traj_per_s": T / (k_ms / 1e3),
               "plain_traj_per_s": T / (p_ms / 1e3),
               "split_ms": split, "batch_peak_bytes": peak, "card": card}
        report.setdefault("noisy_timing", []).append(row)
        print(f"time noisy {case} [{card}]: one batch kernel {k_ms:.3f} ms "
              f"({row['kernel_traj_per_s']:.1f} traj/s), plain "
              f"{p_ms:.3f} ms ({row['plain_traj_per_s']:.1f} traj/s); "
              f"device split " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in split.items())
              + f"; peak {peak / 2**30:.3f} GiB", flush=True)

    nm = noise_model("depol")
    nm.set_readout_error(ReadoutError(0.01, 0.02))
    sim = Simulator(noise_model=nm, device="cuda")
    circuit = brickwork(16, 40, SEED, False)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):  # first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_with_noise(circuit, shots=1024, seed=SEED)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    chunk = tsim._chunk_size(tprog.compile_circuit(circuit), nm, 1024)
    row = {"run_with_noise_n16_1024_wall_ms": min(walls[1:]) * 1e3,
           "cold_ms": walls[0] * 1e3, "peak_bytes": peak, "chunk": chunk,
           "card": card}
    report["run_with_noise_timing"] = row
    print(f"time run_with_noise n=16 depth-40 Ry+CNOT depolarizing 1024 "
          f"shots [{card}]: {row['run_with_noise_n16_1024_wall_ms']:.1f} ms "
          f"(best of 3 warm; cold {row['cold_ms']:.1f} ms), batches of "
          f"<= {chunk}, peak {peak / 2**30:.3f} GiB", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: the variational path
# ---------------------------------------------------------------------------

# VQE: hardware_efficient_ansatz(20, 4), Ry + CNOT (P = 100, all-real), on
# the 20-site Heisenberg chain (57 terms). QAOA: qaoa_maxcut_ansatz(16, 3)
# on the 16-ring, Rz + Rx (P = 96, planar complex).
VQE_SIZE = (20, 4)
QAOA_SIZE = (16, 3)
GRAD_TOL = 1e-4        # parameter shift through the kernels vs the twins
AUTODIFF_TOL = 1e-3    # autodiff vs parameter shift (both exact rules)
COST_TOL = 1e-4        # the per-gate body's cost vs the batched executor's
OPT_ITERATIONS = 3
MULTI_STARTS, MULTI_ITERATIONS = 8, 20


def variational_cases() -> list:
    """(label, circuit, cost, what the phase runs after the gradient)."""
    n, layers = VQE_SIZE
    vqe = (f"VQE hardware-efficient n={n} L={layers} Heisenberg",
           models.hardware_efficient_ansatz(n, layers),
           topt.CostFunction.vqe_hamiltonian(models.heisenberg_chain(n)),
           "optimizer")
    n, p = QAOA_SIZE
    edges = models.maxcut_edges_ring(n)
    qaoa = (f"QAOA MaxCut ring n={n} p={p}",
            models.qaoa_maxcut_ansatz(n, p, edges),
            topt.CostFunction.qaoa_maxcut(edges), "multi_start")
    return [vqe, qaoa]


def cost_launches(program, n_rows: int) -> tuple[dict, int]:
    """Launches of one batched cost evaluation of ``n_rows`` parameter rows
    (the plan's dense and cross steps once per batch), and the batches."""
    n_dense, n_cross, _ = step_counts(program)
    batches = -(-n_rows // tsim.param_rows_per_batch(program, n_rows))
    return ({"dense_axis": n_dense * batches,
             "cross_bit_axis": n_cross * batches}, batches)


def twin_gradient(program, cost, offsets, values: np.ndarray) -> np.ndarray:
    """``GradientEstimator.parameter_shift`` at ``values`` with the kernels'
    plain twins: its 2P shifted rows through ``optimizer._device_costs``
    with ``plain=True``."""
    P = len(values)
    costs = topt._device_costs(program, cost, offsets,
                               topt._shift_matrix(values, np.pi / 2), "cuda",
                               plain=True)
    return (costs[:P] - costs[P:]) / (2.0 * np.sin(np.pi / 2))


def per_row_vs_shared(program, offsets, values: np.ndarray, label: str
                      ) -> tuple[float, float]:
    """Executor ms of one gradient batch (B = 2P rows, a fresh basis state
    per call made outside the timed region) with its per-row operators,
    and with the operators of the batch's first row shared by every row
    (stride 0): the same plan, B and launches, so the difference is what
    one operator per row costs the kernels (a block restages its operator
    at each row change; at K = 256 each row's slabs are re-read from L2).
    Row 0, which both batches share, must come out the same."""
    batch = torch.as_tensor(
        topt._shift_matrix(values, np.pi / 2).astype(np.float32),
        device="cuda")
    params = topt._param_rows(program, offsets, batch)
    row0 = params[0].double().cpu().numpy()
    plan = tplan.get_group_plan(program)
    B = params.shape[0]
    planar = not plan.all_real
    per_row = tplan.build_group_operands_batched(program, plan, params, B,
                                                 "cuda")
    shared = tplan.build_group_operands_batched(program, plan, row0, B,
                                                "cuda")

    def fresh():
        return tplan.basis_state(plan, program.initial_index, "cuda", planar,
                                 B)

    def executor(ops, p):
        return lambda x: tplan.execute_group_plan(plan, ops, program, p, x,
                                                  planar, batched=True)

    a = executor(per_row, params)(fresh())[:1].clone()
    b = executor(shared, row0)(fresh())[:1].clone()
    err = float((a - b).abs().max())
    check(err <= STATE_TOL, f"{label}: row 0 per-row vs shared operators "
          f"differ by {err}")
    shared_ms, row_ms = in_turns(executor(per_row, params),
                                 executor(shared, row0), fresh)
    return row_ms, shared_ms


def traced_gradient(program, cost, offsets, values: np.ndarray) -> dict:
    """One parameter-shift batch (``optimizer._device_costs`` on a single
    batch) with its device time split into operand build, executor and
    cost (CUDA events)."""
    sp = Spans()
    batch = torch.as_tensor(
        topt._shift_matrix(values, np.pi / 2).astype(np.float32),
        device="cuda")
    params = topt._param_rows(program, offsets, batch)
    plan = tplan.get_group_plan(program)
    B = params.shape[0]
    planar = not plan.all_real
    with sp.span("operand_build"):
        ops = tplan.build_group_operands_batched(program, plan, params, B,
                                                 "cuda")
    with sp.span("executor"):
        x = tplan.basis_state(plan, program.initial_index, "cuda", planar, B)
        x = tplan.execute_group_plan(plan, ops, program, params, x, planar,
                                     batched=True)
        psi = (tplan._combine(x) if planar
               else x.reshape(B, -1).to(torch.complex64))
    del ops, x
    with sp.span("cost"):
        cost.device_fn(psi, program.num_qubits)
    return sp.ms()


def phase_variational(report: dict, card: str) -> dict:
    """Each gradient batch, optimizer run and multi-start reads its
    launches from zero; the comparison runs against the twins and the
    timing repeats are not counted."""
    path: dict = {}
    rng = np.random.default_rng(SEED)
    for label, circuit, cost, then in variational_cases():
        cfg = topt.ParameterizedCircuitConfig.auto_detect(circuit)
        program, offsets = cfg.compiled()
        P = cfg.num_params
        values = rng.uniform(-np.pi, np.pi, P)
        want, batches = cost_launches(program, 2 * P)
        plan = tplan.get_group_plan(program)

        def gradient(plain: bool):
            if plain:
                return lambda: twin_gradient(program, cost, offsets, values)
            return lambda: topt.GradientEstimator.parameter_shift(
                cfg, cost, values, device="cuda")

        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        t0 = time.perf_counter()
        grad = gradient(False)()
        cold_s = time.perf_counter() - t0
        delta = add_launches(path, {k: 0 for k in launch_counts()})
        peak = torch.cuda.max_memory_allocated()
        check(delta == want, f"{label}: gradient launches {delta}, plan "
              f"steps x {batches} batch(es) give {want}")
        check(bool(np.isfinite(grad).all()) and grad.shape == (P,),
              f"{label}: gradient of shape {grad.shape}, finite "
              f"{bool(np.isfinite(grad).all())}")
        before = launch_counts()
        plain = gradient(True)()
        check(launch_counts() == before, f"{label}: the twins' gradient "
              f"launched a kernel: {before} -> {launch_counts()}")
        err = float(np.abs(grad - plain).max())
        check(err <= GRAD_TOL, f"{label}: max |grad kernels - grad twins| "
              f"= {err} > {GRAD_TOL}")
        ad_cost, ad_grad = topt.GradientEstimator.autodiff(cfg, cost, values,
                                                           device="cuda")
        ad_err = float(np.abs(ad_grad - grad).max())
        check(ad_err <= AUTODIFF_TOL, f"{label}: max |autodiff - parameter "
              f"shift| = {ad_err} > {AUTODIFF_TOL}")
        batched_cost = float(topt.GradientEstimator._batched_costs(
            cfg, cost, values[None], device="cuda")[0])
        cost_err = abs(ad_cost - batched_cost)
        check(cost_err <= COST_TOL, f"{label}: cost per-gate {ad_cost} vs "
              f"batched {batched_cost}")

        k_ms, p_ms = in_turns(gradient(True), gradient(False), reps=1)
        ad_ms = event_ms(lambda: topt.GradientEstimator.autodiff(
            cfg, cost, values, device="cuda"), reps=2)
        traced_gradient(program, cost, offsets, values)          # warm
        split = traced_gradient(program, cost, offsets, values)
        total = sum(split.values())
        row_ms, shared_ms = per_row_vs_shared(program, offsets, values,
                                              label)
        row = {"case": label, "params": P, "rows": 2 * P,
               "batches": batches, "plan_dense": want["dense_axis"] // batches,
               "plan_cross": want["cross_bit_axis"] // batches,
               "planar": not plan.all_real, "launches": delta,
               "grad_err_vs_twins": err, "autodiff_err": ad_err,
               "cost_err": cost_err, "kernel_ms": k_ms, "plain_ms": p_ms,
               "kernel_rows_per_s": 2 * P / (k_ms / 1e3),
               "plain_rows_per_s": 2 * P / (p_ms / 1e3),
               "autodiff_ms": ad_ms, "cold_s": cold_s, "split_ms": split,
               "executor_per_row_ms": row_ms,
               "executor_shared_ms": shared_ms,
               "peak_bytes": peak, "card": card}
        print(f"variational {label} [{card}]: {2 * P} rows in {batches} "
              f"batch(es), launches dense {delta['dense_axis']} cross "
              f"{delta['cross_bit_axis']}, |grad kernels - twins| "
              f"{err:.2e}, |autodiff - shift| {ad_err:.2e}; gradient kernel "
              f"{k_ms:.3f} ms ({row['kernel_rows_per_s']:.1f} rows/s), "
              f"twins {p_ms:.3f} ms ({row['plain_rows_per_s']:.1f} rows/s), "
              f"autodiff {ad_ms:.3f} ms; device split " + ", ".join(
                  f"{k} {v:.3f} ms ({100 * v / total:.1f} %)"
                  for k, v in split.items())
              + f"; executor per-row operators {row_ms:.3f} ms, one shared "
              f"{shared_ms:.3f} ms; peak {peak / 2**30:.3f} GiB", flush=True)

        if then == "optimizer":     # CircuitOptimizer.run from the point
            start = topt.ParameterizedCircuitConfig.auto_detect(
                cfg.bind_values(values))
            opt = topt.CircuitOptimizer(start, cost,
                                        max_iterations=OPT_ITERATIONS,
                                        gradient_method="parameter_shift",
                                        device="cuda")
            one, _ = cost_launches(program, 1)
            cuda_exec.reset_launch_counts()
            t0 = time.perf_counter()
            res = opt.run(seed=SEED)
            row["optimizer_s"] = time.perf_counter() - t0
            delta = add_launches(path, {k: 0 for k in launch_counts()})
            costs = [c for _, c in res.history]
            row["optimizer_costs"] = costs
            check(res.iterations == OPT_ITERATIONS,
                  f"{label}: optimizer ran {res.iterations} iterations")
            check(delta == {k: OPT_ITERATIONS * (want[k] + one[k])
                            for k in want},
                  f"{label}: optimizer launches {delta}")
            check(all(c <= costs[0] for c in costs),
                  f"{label}: optimizer costs {costs} rise above the first")
            print(f"variational {label} CircuitOptimizer.run "
                  f"{OPT_ITERATIONS} iterations [{card}]: costs "
                  + ", ".join(f"{c:.6f}" for c in costs)
                  + f" in {row['optimizer_s']:.3f} s", flush=True)
        else:                       # multi_start (the per-gate body)
            t0 = time.perf_counter()
            ms = topt.CircuitOptimizer.multi_start(
                cfg, cost, n_starts=MULTI_STARTS,
                max_iterations=MULTI_ITERATIONS, seed=SEED, device="cuda")
            row["multi_start_ms"] = (time.perf_counter() - t0) * 1e3
            first = float(ms.cost_histories[:, 0].mean())
            row["multi_start_best"] = ms.optimal_cost
            row["multi_start_first_mean"] = first
            check(ms.cost_histories.shape == (MULTI_STARTS, MULTI_ITERATIONS)
                  and ms.optimal_cost <= first,
                  f"{label}: multi_start best {ms.optimal_cost} > the "
                  f"starts' mean first cost {first}")
            print(f"variational {label} multi_start S={MULTI_STARTS} "
                  f"{MULTI_ITERATIONS} iterations [{card}]: best "
                  f"{ms.optimal_cost:.6f} (starts' first costs mean "
                  f"{first:.6f}) in {row['multi_start_ms']:.1f} ms",
                  flush=True)
        report.setdefault("variational", []).append(row)
        torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the variational path: {path}")
    report["variational_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 2c: the kernels at the layouts of n = 31 and 32
# ---------------------------------------------------------------------------

HUGE_LAYOUTS = {31: (8,) + (128,) * 4, 32: (16,) + (128,) * 4}
HUGE_DEPTH = 8
# The widest state's run of phase 6 takes half the depth: the script
# grew by the open-system phase and keeps its time.
HUGE_DEPTH_WIDEST = 4
# Elements of one slice of a twin that runs slice by slice (1 GiB).
SLICE_ELEMS = 1 << 28


def brickwork_cross_geometries(n: int, depth: int) -> list:
    """Every cross geometry of the Ry+CNOT and Ry/Rz brickwork plans."""
    geoms = set()
    for mix in (False, True):
        plan = tplan.get_group_plan(tprog.compile_circuit(
            brickwork(n, depth, SEED, mix)))
        geoms |= {(s.slice_axis, s.slice_pos, s.op_axis)
                  for s in plan.steps if isinstance(s, tplan.CrossStep)}
    return sorted(geoms)


def sliced_max_err(got: torch.Tensor, x0: torch.Tensor, plain_fn,
                   planar: bool, involved: set) -> float:
    """max |got - plain_fn(x0)| with the twin run slice by slice along the
    largest data axis the step does not touch."""
    lead = int(planar)
    shape = tuple(x0.shape[lead:])
    ax = max((a for a in range(len(shape)) if a not in involved),
             key=lambda a: shape[a])
    width = min(shape[ax], max(1, shape[ax] * SLICE_ELEMS // x0.numel()))
    err = torch.zeros((), device=x0.device)
    for start in range(0, shape[ax], width):
        want = plain_fn(x0.narrow(lead + ax, start, width))
        err = torch.maximum(
            err, (got.narrow(lead + ax, start, width) - want).abs().max())
        del want
    return float(err)


def phase_huge_kernels(report: dict, card: str) -> dict:
    rng = np.random.default_rng(SEED + 2)
    rows = []
    max_err = {"dense_axis": 0.0, "cross_bit_axis": 0.0}
    for n, shape in HUGE_LAYOUTS.items():
        cases = []
        for planar, real in ((False, True), (True, True), (True, False)):
            for axis in range(len(shape)):
                cases.append(("dense_axis", (axis,), {axis}, planar, real,
                              shape[axis], DENSE_TOL))
        for g in brickwork_cross_geometries(n, HUGE_DEPTH):
            for planar, real in ((False, True), (True, False)):
                cases.append(("cross_bit_axis", g, {g[0], g[2]}, planar,
                              real, 2 * shape[g[2]], CROSS_TOL))
        for name, geom, involved, planar, real, K, tol in cases:
            torch.cuda.empty_cache()
            op = random_op((K, K) if name == "dense_axis"
                           else (2, K // 2, 2, K // 2), real, rng)
            kfn = getattr(cuda_exec, name)
            pfn = getattr(cuda_exec, name + "_plain")
            x = random_state(shape, planar, seed=len(rows))
            x0 = x.clone()
            got = kfn(x, op, *geom, planar)
            torch.cuda.synchronize()
            label = (f"{name} n={n} geom={geom} "
                     f"{'planar' if planar else 'real'}-state "
                     f"{'real' if real else 'complex'}-op")
            check(got is x, f"{label}: the wrapper did not return its input")
            err = sliced_max_err(got, x0,
                                 lambda v: pfn(v, op, *geom, planar),
                                 planar, involved)
            check(err <= tol, f"{label}: max |kernel - plain| = {err} > {tol}")
            del x0, got
            ms = event_ms(lambda: kfn(x, op, *geom, planar), reps=2)
            del x
            tbs, tfl, unit = rates(shape, planar, real, K, ms)
            b_ms, b_by = bound(shape, planar, real, K)
            max_err[name] = max(max_err[name], err)
            rows.append({"kernel": name, "case": label, "n": n,
                         "max_abs_err": err, "ms": ms, "TB_per_s": tbs,
                         f"{unit}_TFLOP_per_s": tfl, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"kernel {label} [{card}]: err {err:.3e} kernel "
                  f"{ms:.3f} ms; {tbs:.3f} TB/s {tfl:.1f} {unit} TFLOP/s; "
                  f"bound {b_ms:.3f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    report["huge_kernel_cases"] = rows
    return max_err


# ---------------------------------------------------------------------------
# Phase 6: the n >= 30 ideal path
# ---------------------------------------------------------------------------

HUGE_SHOTS = 4096
# Qubit counts of the phase: planar Ry/Rz at the first and the last, real
# Ry+CNOT at the middle one; GHZ at the last (counts) and first (strings).
HUGE_SIZES = (30, 31, 32)
# Simulator.run(shots=4096) may hold at most this many states at its peak.
HUGE_PEAK_RATIO = 1.75
MARGINAL_TOL = 1e-5
NO_LAUNCHES = {"dense_axis": 0, "cross_bit_axis": 0}


def state_bytes(n: int, planar: bool) -> int:
    return (8 if planar else 4) << n


def grouped_max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| of two grouped states, chunk by chunk."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    err = torch.zeros((), device=a.device)
    for s in range(0, fa.numel(), tplan.CHUNK_ELEMS):
        e = s + tplan.CHUNK_ELEMS
        err = torch.maximum(err, (fa[s:e] - fb[s:e]).abs().max())
    return float(err)


def plan_launches(programs) -> dict:
    """Dense and cross steps of the programs' group plans."""
    counts = [step_counts(p) for p in programs]
    return {"dense_axis": sum(c[0] for c in counts),
            "cross_bit_axis": sum(c[1] for c in counts)}


def x_rotated(circuit: QuantumCircuit) -> QuantumCircuit:
    """The circuit ``Simulator.run`` samples for the X basis at n >= 30."""
    rotated = circuit.copy()
    col = rotated.get_column_count()
    for q in range(circuit.num_qubits):
        rotated.add("H", [q], [], col)
    return rotated


def huge_run(sim: Simulator, circuit: QuantumCircuit, label: str,
             basis: MeasurementBasis, compare: bool, timed: bool, path: dict,
             report: dict, card: str) -> np.ndarray:
    """One ``Simulator.run`` at n >= 30 with its checks; returns the final
    state's per-qubit probabilities."""
    n = circuit.num_qubits
    program = tprog.compile_circuit(circuit)
    programs = [program]
    if basis == MeasurementBasis.X:
        programs.append(tprog.compile_circuit(x_rotated(circuit)))
    want_launches = plan_launches(programs)
    plan = tplan.get_group_plan(program)
    planar = not plan.all_real
    size = state_bytes(n, planar)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run(circuit, shots=HUGE_SHOTS, seed=SEED,
                  measurement_basis=basis)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    delta = add_launches(path, NO_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    fs = res.final_state
    check(isinstance(fs, PlanarStateVector) and fs.is_planar == planar,
          f"{label}: final state {fs!r}")
    check(delta == want_launches, f"{label}: launches {delta}, the plans "
          f"have {want_launches}")
    norm = fs.norm_sq()
    check(abs(norm - 1.0) <= 1e-4, f"{label}: |psi|^2 = {norm}")
    counts = res.measurement_counts
    check(sum(counts.values()) == HUGE_SHOTS
          and all(len(b) == n for b in counts),
          f"{label}: {sum(counts.values())} shots")
    check(peak <= HUGE_PEAK_RATIO * size, f"{label}: peak "
          f"{peak / 2**30:.3f} GiB > {HUGE_PEAK_RATIO} x the state's "
          f"{size / 2**30:.0f} GiB")
    qp = fs.qubit_probabilities()
    row = {"circuit": label, "n": n, "planar": planar, "state_bytes": size,
           "peak_bytes": peak, "launches": delta, "norm": norm,
           "cold_run_s": cold_s, "distinct_strings": len(counts),
           "card": card}
    text = ""
    if compare:
        want, _ = tplan.group_forward_state_body(
            program, program.initial_params, "cuda", plain=True)
        err = grouped_max_diff(fs.state_data, want)
        del want
        check(err <= STATE_TOL, f"{label}: max |kernel - plain state| = "
              f"{err}")
        row["state_err"] = err
        text += f", kernel vs plain executor {err:.3e}"
    del res, fs
    if timed:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(circuit, shots=HUGE_SHOTS, seed=SEED)
        torch.cuda.synchronize()
        row["run_ms"] = (time.perf_counter() - t0) * 1e3
        x = res.final_state.state_data
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        row["sampler_ms"] = event_ms(
            lambda: bigstate.sample_state_indices(x, HUGE_SHOTS, planar,
                                                  gen), reps=2)
        row["marginals_ms"] = event_ms(
            lambda: bigstate.state_axis_marginals(x, planar), reps=2)
        del res, x
        torch.cuda.empty_cache()
        params = program.initial_params
        ops = tplan.operands_to(
            tplan.build_group_operands(program, plan, params), "cuda")
        row["executor_ms"] = event_ms(
            lambda x: tplan.execute_group_plan(plan, ops, program, params,
                                               x, planar),
            lambda: tplan.basis_state(plan, program.initial_index, "cuda",
                                      planar), reps=2)
        text += (f"; Simulator.run {row['run_ms']:.1f} ms (executor "
                 f"{row['executor_ms']:.1f} ms = "
                 f"{100 * row['executor_ms'] / row['run_ms']:.1f} %, "
                 f"sampler {row['sampler_ms']:.2f} ms for {HUGE_SHOTS} "
                 f"shots, marginals {row['marginals_ms']:.1f} ms)")
    report.setdefault("huge", []).append(row)
    print(f"huge {label} [{card}]: {'planar' if planar else 'real'} state "
          f"{size / 2**30:.0f} GiB, peak {peak / 2**30:.3f} GiB "
          f"({peak / size:.3f} x), launches dense {delta['dense_axis']} "
          f"cross {delta['cross_bit_axis']}, |psi|^2 {norm:.7f}, "
          f"{len(counts)} distinct strings of {HUGE_SHOTS} shots, cold "
          f"{cold_s:.3f} s{text}", flush=True)
    return qp


def phase_huge(report: dict, card: str) -> dict:
    path: dict = {}
    sim = Simulator(device="cuda")
    Z, X = MeasurementBasis.Z, MeasurementBasis.X
    n0, n1, n2 = HUGE_SIZES
    c30 = brickwork(n0, HUGE_DEPTH, SEED, True)
    qp30 = huge_run(sim, c30, f"brickwork n={n0} depth-8 Ry/Rz Z basis", Z,
                    True, True, path, report, card)
    huge_run(sim, c30, f"brickwork n={n0} depth-8 Ry/Rz X basis", X, False,
             False, path, report, card)
    huge_run(sim, brickwork(n1, HUGE_DEPTH, SEED, False),
             f"brickwork n={n1} depth-8 Ry+CNOT Z basis", Z, True, True,
             path, report, card)
    huge_run(sim, brickwork(n2, HUGE_DEPTH_WIDEST, SEED, True),
             f"brickwork n={n2} depth-{HUGE_DEPTH_WIDEST} Ry/Rz Z basis", Z,
             False, True, path, report, card)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    res = sim.run(ghz(n2), shots=HUGE_SHOTS, seed=SEED)
    add_launches(path, NO_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    counts = res.measurement_counts
    zeros, ones = counts.get("0" * n2, 0), counts.get("1" * n2, 0)
    check(zeros + ones == HUGE_SHOTS and 0.4 <= zeros / HUGE_SHOTS <= 0.6,
          f"GHZ-{n2} counts {dict(list(counts.items())[:4])}")
    print(f"huge GHZ-{n2} [{card}]: {zeros} x 0..0, {ones} x 1..1 of "
          f"{HUGE_SHOTS}, peak {peak / 2**30:.3f} GiB", flush=True)
    report["ghz_counts"] = {"zeros": zeros, "ones": ones, "peak_bytes": peak}
    del res
    torch.cuda.empty_cache()

    cuda_exec.reset_launch_counts()
    fs = sim.run(ghz(n0), shots=0).final_state
    add_launches(path, NO_LAUNCHES)
    every, last = list(range(n0)), n0 - 1
    strings = {
        "<Z0>": (fs.expectation_z(0), 0.0),
        "<Z3 Z4> (one group)": (fs.expectation_z_string([3, 4]), 1.0),
        "<Z0 Z_last>": (fs.expectation_z_string([0, last]), 1.0),
        "<Z0 Z5 Z_last>": (fs.expectation_z_string([0, 5, last]), 0.0),
        "<X0 X1>": (fs.expectation_pauli_string([0, 1], "XX"), 0.0),
        "<X^n>": (fs.expectation_pauli_string(every, "X" * n0), 1.0),
        "<Y0 Y1 X^(n-2)>": (fs.expectation_pauli_string(
            every, "YY" + "X" * (n0 - 2)), -1.0),
    }
    for name, (got, want) in strings.items():
        check(abs(got - want) <= 1e-5,
              f"GHZ-{n0} {name} = {got}, not {want}")
    print(f"huge GHZ-{n0} strings [{card}]: " + ", ".join(
        f"{k} = {v[0]:+.6f}" for k, v in strings.items()), flush=True)
    report["ghz_strings"] = {k: v[0] for k, v in strings.items()}
    del fs
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    t0 = time.perf_counter()
    steps = list(sim.run_step_by_step(c30))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    delta = add_launches(path, NO_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(len(steps) == HUGE_DEPTH + 1
          and [c for _, c in steps] == list(range(-1, HUGE_DEPTH))
          and all(isinstance(s, MarginalStateSummary) for s, _ in steps),
          f"run_step_by_step n={n0}: {len(steps)} snapshots")
    dev = float(np.abs(steps[-1][0].qubit_probabilities() - qp30).max())
    check(dev <= MARGINAL_TOL, f"run_step_by_step n={n0}: last snapshot's "
          f"qubit probabilities differ from the final state's by {dev}")
    print(f"huge run_step_by_step n={n0} depth-8 Ry/Rz [{card}]: "
          f"{len(steps)} marginal summaries in {step_s:.3f} s, last vs "
          f"final state {dev:.2e}, launches dense {delta['dense_axis']} "
          f"cross {delta['cross_bit_axis']}, peak {peak / 2**30:.3f} GiB",
          flush=True)
    report["step_by_step"] = {"seconds": step_s, "dev": dev,
                              "peak_bytes": peak, "launches": delta}
    del steps
    torch.cuda.empty_cache()

    # QFT-30: the steps that are no kernel (pair diagonals, swaps) run
    # chunk by chunk in place
    program = tprog.compile_circuit(qft(n0))
    want_launches = plan_launches([program])
    other = step_counts(program)[2]
    size = state_bytes(n0, True)
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run(qft(n0), shots=HUGE_SHOTS, seed=SEED)
    torch.cuda.synchronize()
    qft_s = time.perf_counter() - t0
    delta = add_launches(path, NO_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(delta == want_launches, f"QFT-{n0}: launches {delta}, the plan "
          f"has {want_launches}")
    check(peak <= HUGE_PEAK_RATIO * size, f"QFT-{n0}: peak "
          f"{peak / 2**30:.3f} GiB > {HUGE_PEAK_RATIO} x the state")
    p = res.final_state.probabilities_device
    dev = float((p * float(2 ** n0) - 1.0).abs().max())
    del p
    check(dev <= 1e-3, f"QFT-{n0}: max |2^n |amp|^2 - 1| = {dev}")
    check(sum(res.measurement_counts.values()) == HUGE_SHOTS,
          f"QFT-{n0}: {sum(res.measurement_counts.values())} shots")
    print(f"huge QFT-{n0} [{card}]: {other} steps beside "
          f"{delta['dense_axis']} dense and {delta['cross_bit_axis']} cross, "
          f"max |2^n |amp|^2 - 1| = {dev:.3e}, {qft_s:.3f} s, peak "
          f"{peak / 2**30:.3f} GiB "
          f"({peak / size:.3f} x the state)", flush=True)
    report["qft"] = {"seconds": qft_s, "dev": dev, "peak_bytes": peak,
                     "other_steps": other, "launches": delta}
    del res
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the n >= 30 path: {path}")
    report["huge_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 7: the n >= 30 noisy paths and monitored trajectories
# ---------------------------------------------------------------------------

HUGE_NOISY_DEPTH = 4
MONITOR_BATCH_N = 20
MONITOR_LAW_TRAJ = 4000
MONITOR_LAW_TOL = 0.05


class XBasisDamping(NoiseChannel):
    """Amplitude damping conjugated by H: trace preserving, neither
    mixed-unitary nor monomial, so it takes the fold executor."""

    def __init__(self, gamma: float):
        self._gamma = gamma

    @property
    def probability(self) -> float:
        return self._gamma

    def get_kraus_operators(self) -> list:
        h = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
        return [h @ np.asarray(k) @ h for k in
                AmplitudeDampingNoise(self._gamma).get_kraus_operators()]


def global_noise(channel) -> NoiseModel:
    nm = NoiseModel()
    nm.add_global_noise(channel)
    return nm


def evolve_launches(program, nm) -> dict:
    """Launches of one trajectory of the n >= 30 evolution: the spliced
    plans' dense and cross steps, or one per gate on the fold route."""
    route = bigtraj.trajectory_evolve_route(program, nm)
    if route == "fold":
        return {"total": len(program.ops)}
    plans = noisy_plans(program, nm)
    return {"dense_axis": sum(isinstance(s, tplan.AxisMatmulStep)
                              for p in plans for s in p.steps),
            "cross_bit_axis": sum(isinstance(s, tplan.CrossStep)
                                  for p in plans for s in p.steps)}


def launches_match(delta: dict, want: dict, times: int = 1) -> bool:
    if "total" in want:
        return sum(delta.values()) == times * want["total"]
    return delta == {k: times * v for k, v in want.items()}


def monitored_brickwork(n: int, depth: int, seed: int) -> QuantumCircuit:
    """Ry+CNOT brickwork with a ``Measure`` on every fourth qubit after
    each second layer; the first measurement of qubit 0 is repeated at
    once, with no gate between."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        if layer % 2 == 0:
            for q in range(n):
                c.add("Ry", [q], [float(rng.uniform(0, 2 * np.pi))], col)
        else:
            for q in range((layer // 2) % 2, n - 1, 2):
                c.add("CNOT", [q, q + 1], [], col)
            col += 1
            for q in range(0, n, 4):
                c.add("Measure", [q], [], col)
            if layer == 1:
                col += 1
                c.add("Measure", [0], [], col)
        col += 1
    return c


def monitored_events(circuit: QuantumCircuit) -> tuple:
    """``(op_position, qubit)`` of every ``Measure``, as
    ``Simulator.monitored_trajectories`` derives them."""
    events, pos = [], 0
    for column in circuit.get_ordered_gates():
        for g in column:
            if g.gate_name == "Measure":
                events.append((pos, g.target_qubits[0]))
            else:
                pos += 1
    return tuple(events)


def monitored_launches(circuit: QuantumCircuit) -> dict:
    program = tprog.compile_circuit(circuit)
    spec = tmono.monomial_spec(program, tprog._NoNoise,
                               monitored_events(circuit))
    return plan_launches(spec.segments)


def phase_huge_noisy(report: dict, card: str) -> dict:
    path: dict = {}
    n = HUGE_SIZES[0]
    circuit = brickwork(n, HUGE_NOISY_DEPTH, SEED, False)
    program = tprog.compile_circuit(circuit)
    params = program.initial_params
    models_by_route = [("unitary", "depolarizing 0.05",
                        global_noise(DepolarizingNoise(0.05))),
                       ("monomial", "amplitude damping 0.05",
                        global_noise(AmplitudeDampingNoise(0.05))),
                       ("fold", "X-basis amplitude damping 0.05",
                        global_noise(XBasisDamping(0.05)))]
    for route, name, nm in models_by_route:
        label = f"noisy n={n} depth-{HUGE_NOISY_DEPTH} Ry+CNOT {name}"
        got_route = bigtraj.trajectory_evolve_route(program, nm)
        check(got_route == route, f"{label}: route {got_route}, expected "
              f"{route}")
        want_launches = evolve_launches(program, nm)
        planar = not bigtraj.trajectory_is_real(program, nm)
        size = state_bytes(n, planar)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        t0 = time.perf_counter()
        res = Simulator(noise_model=nm, device="cuda").run(
            circuit, shots=1024, seed=SEED)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        delta = add_launches(path, NO_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        fs = res.final_state
        check(isinstance(fs, PlanarStateVector) and fs.is_planar == planar,
              f"{label}: final state {fs!r}")
        check(launches_match(delta, want_launches), f"{label}: launches "
              f"{delta}, expected {want_launches}")
        norm = fs.norm_sq()
        check(abs(norm - 1.0) <= 1e-4, f"{label}: |psi|^2 = {norm}")
        shots = sum(res.measurement_counts.values())
        check(shots == 1024, f"{label}: {shots} shots")
        del res, fs
        torch.cuda.empty_cache()
        # the same draws through the kernels and through the twins
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _, draws = bigtraj.huge_trajectory_state_body(
            program, nm, params, 1, "cuda", gen)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _, _ = bigtraj.huge_trajectory_state_body(
            program, nm, params, 1, "cuda", None, draws, plain=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = grouped_max_diff(x, want)
        check(err <= STATE_TOL, f"{label}: max |kernel - plain| = {err} on "
              "the same draws")
        del x, want, draws
        print(f"huge {label} [{card}]: route {route}, "
              f"{'planar' if planar else 'real'} state "
              f"{size / 2**30:.0f} GiB, launches dense "
              f"{delta['dense_axis']} cross {delta['cross_bit_axis']}, "
              f"|psi|^2 {norm:.7f}, {shots} shots, Simulator.run "
              f"{run_s:.3f} s, one trajectory kernels {kernel_s:.3f} s twins "
              f"{plain_s:.3f} s, kernel vs plain {err:.2e}, peak "
              f"{peak / 2**30:.3f} GiB", flush=True)
        report.setdefault("huge_noisy", []).append(
            {"case": label, "route": route, "launches": delta, "norm": norm,
             "run_s": run_s, "trajectory_kernel_s": kernel_s,
             "trajectory_plain_s": plain_s, "kernel_vs_plain": err,
             "peak_bytes": peak, "state_bytes": size, "card": card})

    nm = global_noise(DepolarizingNoise(0.05))
    sim = Simulator(noise_model=nm, device="cuda")
    want_launches = evolve_launches(program, nm)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run_with_noise(circuit, shots=256, seed=SEED, trajectories=4)
    noise_s = time.perf_counter() - t0
    delta = add_launches(path, NO_LAUNCHES)
    shots = sum(res.measurement_counts.values())
    check(res.final_state is None and shots == 256,
          f"run_with_noise n={n}: {shots} shots, final state "
          f"{res.final_state!r}")
    check(launches_match(delta, want_launches, 4),
          f"run_with_noise n={n}: launches {delta}, 4 x {want_launches}")
    print(f"huge run_with_noise n={n} depth-{HUGE_NOISY_DEPTH} depolarizing "
          f"[{card}]: {shots} shots over 4 trajectories in {noise_s:.3f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    report["run_with_noise_huge"] = {"seconds": noise_s, "launches": delta}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    t0 = time.perf_counter()
    rhos = sim.ensemble_qubit_density_matrices(circuit, n_trials=2,
                                               seed=SEED)
    rho_s = time.perf_counter() - t0
    delta = add_launches(path, NO_LAUNCHES)
    traces = np.trace(rhos, axis1=1, axis2=2)
    check(rhos.shape == (n, 2, 2)
          and float(np.abs(traces - 1.0).max()) <= 1e-4
          and float(np.abs(rhos - rhos.conj().transpose(0, 2, 1)).max())
          <= 1e-6, f"ensemble_qubit_density_matrices n={n}: traces {traces}")
    check(launches_match(delta, want_launches, 2),
          f"ensemble n={n}: launches {delta}, 2 x {want_launches}")
    print(f"huge ensemble_qubit_density_matrices n={n} [{card}]: 2 "
          f"trajectories in {rho_s:.3f} s, max |tr - 1| "
          f"{float(np.abs(traces - 1.0).max()):.2e}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    report["ensemble_rho_huge"] = {"seconds": rho_s, "launches": delta}

    # monitored trajectories
    ideal = Simulator(device="cuda")
    for n_m, T, final_shots in ((MONITOR_BATCH_N, 64, None), (n, 2, 256)):
        mc = monitored_brickwork(n_m, HUGE_NOISY_DEPTH, SEED)
        want_launches = monitored_launches(mc)
        n_events = len(monitored_events(mc))
        repeat = len(range(0, n_m, 4))    # slot of the repeated measurement
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        t0 = time.perf_counter()
        outcomes, sites, third = ideal.monitored_trajectories(
            mc, T, seed=SEED, final_shots=final_shots)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        delta = add_launches(path, NO_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        label = f"monitored n={n_m} depth-{HUGE_NOISY_DEPTH} T={T}"
        batches = 1 if final_shots is None else T
        check(outcomes.shape == (T, n_events) and len(sites) == n_events
              and set(np.unique(outcomes)) <= {0, 1},
              f"{label}: outcomes of shape {outcomes.shape}")
        check(sites[0][1] == 0 and sites[repeat][1] == 0
              and bool((outcomes[:, 0] == outcomes[:, repeat]).all()),
              f"{label}: the repeated measurement of qubit 0 changed")
        check(launches_match(delta, want_launches, batches),
              f"{label}: launches {delta}, {batches} x {want_launches}")
        if final_shots is None:
            check(len(third) == T, f"{label}: {len(third)} states")
            norms = [float(s.device_data.abs().square().sum())
                     for s in third[:4]]
            check(all(abs(v - 1.0) <= 1e-4 for v in norms),
                  f"{label}: norms {norms}")
            del third
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ideal.monitored_trajectories(mc, T, seed=SEED + 1)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            extra = f", warm {T / warm_s:.1f} trajectories/s"
            report["monitored_batch_traj_per_s"] = T / warm_s
        else:
            check(len(third) == T and all(
                sum(d.values()) == final_shots for d in third),
                f"{label}: final counts {[sum(d.values()) for d in third]}")
            extra = f", {final_shots} final shots each"
        print(f"{label} [{card}]: {n_events} measurements, launches dense "
              f"{delta['dense_axis']} cross {delta['cross_bit_axis']}, "
              f"mean outcome {float(outcomes.mean()):.3f}, cold "
              f"{cold_s:.3f} s{extra}, peak {peak / 2**30:.3f} GiB",
              flush=True)
        report.setdefault("monitored", []).append(
            {"case": label, "launches": delta, "cold_s": cold_s,
             "peak_bytes": peak, "card": card})

    # law at n = 4: Ry on every qubit, measure 0, CNOT(0, 1), measure 1
    theta = [0.9, 2.1, 0.4, 1.3]
    lc = QuantumCircuit(4)
    for q, t in enumerate(theta):
        lc.add("Ry", [q], [t], 0)
    lc.add("Measure", [0], [], 1)
    lc.add("CNOT", [0, 1], [], 2)
    lc.add("Measure", [1], [], 3)
    a, b = np.sin(theta[0] / 2) ** 2, np.sin(theta[1] / 2) ** 2
    want = np.array([a, a * (1 - b) + (1 - a) * b])
    cuda_exec.reset_launch_counts()
    outcomes, _, _ = ideal.monitored_trajectories(lc, MONITOR_LAW_TRAJ,
                                                  seed=SEED)
    add_launches(path, NO_LAUNCHES)
    freq = outcomes.mean(axis=0)
    dev = float(np.abs(freq - want).max())
    check(dev <= MONITOR_LAW_TOL, f"monitored law n=4: frequencies {freq}, "
          f"exact {want}")
    print(f"monitored law n=4 [{card}]: {MONITOR_LAW_TRAJ} trajectories, "
          f"P(1) {freq[0]:.4f}, {freq[1]:.4f} against {want[0]:.4f}, "
          f"{want[1]:.4f}", flush=True)
    report["monitored_law_dev"] = dev

    # the fold body on a batch: one launch per gate for all trajectories
    n_f, T = MONITOR_BATCH_N, 64
    fc = brickwork(n_f, HUGE_DEPTH, SEED, False)
    fp = tprog.compile_circuit(fc)
    nm = global_noise(XBasisDamping(0.05))
    check(tprog.trajectory_route(fp, nm) == "fold",
          f"fold batch: route {tprog.trajectory_route(fp, nm)}")
    torch.cuda.empty_cache()
    cuda_exec.reset_launch_counts()
    states = Simulator(noise_model=nm, device="cuda").trajectory_states(
        fc, T, seed=SEED)
    delta = add_launches(path, NO_LAUNCHES)
    check(sum(delta.values()) == len(fp.ops), f"fold batch n={n_f} T={T}: "
          f"launches {delta} for {len(fp.ops)} gates")
    norm_err = float((states.abs().square().sum(-1) - 1).abs().max())
    check(norm_err <= 1e-4, f"fold batch: max |norm - 1| = {norm_err}")
    del states
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, draws = bigtraj.fold_trajectory_body(fp, nm, fp.initial_params, T,
                                              "cuda", gen)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    want_states, _ = bigtraj.fold_trajectory_body(
        fp, nm, fp.initial_params, T, "cuda", None, draws, plain=True)
    err = float((got - want_states).abs().max())
    check(err <= STATE_TOL, f"fold batch: max |kernel - plain| = {err}")
    del got, want_states
    print(f"fold batch n={n_f} depth-8 T={T} X-basis damping [{card}]: "
          f"{len(fp.ops)} gates, launches dense {delta['dense_axis']} cross "
          f"{delta['cross_bit_axis']}, max |norm - 1| {norm_err:.2e}, "
          f"kernel vs plain {err:.2e}, {T / fold_s:.1f} trajectories/s",
          flush=True)
    report["fold_batch"] = {"launches": delta, "gates": len(fp.ops),
                            "traj_per_s": T / fold_s,
                            "kernel_vs_plain": err}
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the huge noisy path: {path}")
    report["huge_noisy_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 8: the exact open-system path (density matrices, Lindblad, Trotter)
# ---------------------------------------------------------------------------

# Qubit counts of 8a: the reference check, the dense-route check and the
# widest vec(rho) below the large-state regime (2n = 28).
SUPEROP_SIZES = (8, 12, 14)
SUPEROP_HUGE_N = 15          # 2n = 30: a SuperopDensityResult
SUPEROP_DEPTH = 8
RHO_TOL = 2e-5               # superop rho vs dense-route rho
TRACE_TOL = 1e-4
LINDBLAD_SMALL_N = 4         # final rho vs expm(dense_liouvillian * t)
LINDBLAD_N = 10
LINDBLAD_MAX_N = 13
LINDBLAD_STEPS = 8
TROTTER_N = 16
TROTTER_TIME = 1.0
TROTTER_STEPS = 4


def open_noise() -> NoiseModel:
    """Depolarizing 0.05 after every gate and amplitude damping 0.05
    after each CNOT (the mix of ``tests/test_density.py:153-163``)."""
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nm.add_gate_noise("CNOT", AmplitudeDampingNoise(0.05))
    return nm


def superop_case(n: int, mix_rz: bool, noisy: bool, path: dict,
                 report: dict, card: str, time_dense: bool = True) -> None:
    """One circuit through ``DensityMatrixSimulator.run(method="superop")``
    below the large-state regime, with its checks and times
    (``time_dense``: the dense route's beside the executor's)."""
    circuit = brickwork(n, SUPEROP_DEPTH, SEED, mix_rz)
    nm = open_noise() if noisy else None
    label = (f"superop n={n} (2n={2 * n}) depth-{SUPEROP_DEPTH} "
             f"{'Ry/Rz' if mix_rz else 'Ry+CNOT'} "
             f"{'depol+amp-damp' if noisy else 'noise-free'}")
    program = tprog.compile_circuit(circuit)
    program2 = tdens.superop_program(program, nm)
    params = program2.initial_params
    plan = tplan.get_group_plan(program2)
    planar = not plan.all_real
    n_dense, n_cross, n_other = step_counts(program2)
    check(planar == mix_rz, f"{label}: plan.all_real is {plan.all_real}")
    sim = DensityMatrixSimulator(noise_model=nm, device="cuda")

    torch.cuda.empty_cache()
    cuda_exec.reset_launch_counts()
    res = sim.run(circuit, method="superop")
    delta = add_launches(path, NO_LAUNCHES)
    check(delta == {"dense_axis": n_dense, "cross_bit_axis": n_cross},
          f"{label}: launches {delta}, the plan has {n_dense} dense and "
          f"{n_cross} cross steps")
    trace, purity = res.trace(), res.purity()
    check(abs(trace - 1.0) <= TRACE_TOL, f"{label}: tr(rho) = {trace}")
    if noisy:
        check(purity < 1.0 - 1e-3, f"{label}: purity {purity} with noise")
    else:
        check(abs(purity - 1.0) <= TRACE_TOL, f"{label}: purity {purity}")
    want = tplan.group_forward_body(program2, params, "cuda", plain=True)
    err = float((res.device_rho.reshape(-1) - want).abs().max())
    del want
    check(err <= STATE_TOL, f"{label}: max |kernel - plain vec(rho)| = {err}")
    row = {"case": label, "n": n, "planar": planar, "noisy": noisy,
           "dense_steps": n_dense, "cross_steps": n_cross,
           "other_steps": n_other, "launches": delta, "trace": trace,
           "purity": purity, "kernel_vs_plain": err, "card": card}
    text = ""
    if n == SUPEROP_SIZES[0] and nm is not None:
        ref = density_reference(program, nm)
        dev = float(np.abs(res.probabilities - ref).max())
        check(dev <= STATE_TOL, f"{label}: diagonal vs the NumPy "
              f"complex128 density matrix {dev}")
        row["reference_err"] = dev
        text += f", diagonal vs NumPy reference {dev:.2e}"

    def dense_route():
        return sim.run(circuit, method="dense")

    if n <= SUPEROP_SIZES[1]:
        dense = dense_route()
        dev = float((res.device_rho - dense.device_rho).abs().max())
        del dense
        check(dev <= RHO_TOL, f"{label}: superop rho vs dense route {dev}")
        row["dense_route_err"] = dev
        text += f", rho vs dense route {dev:.2e}"
    del res
    torch.cuda.empty_cache()

    if n > SUPEROP_SIZES[0]:
        ops = tplan.operands_to(
            tplan.build_group_operands(program2, plan, params), "cuda")

        def fresh():
            return tplan.basis_state(plan, program2.initial_index, "cuda",
                                     planar)

        def executor(plain):
            return lambda x: tplan.execute_group_plan(
                plan, ops, program2, params, x, planar, plain)

        k_ms, p_ms = in_turns(executor(True), executor(False), fresh,
                              reps=2 if n == SUPEROP_SIZES[2] else 3)
        del ops
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(circuit, method="superop")
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        del out
        row.update(kernel_ms=k_ms, plain_ms=p_ms, superop_run_ms=run_ms)
        text += (f"; executor kernel {k_ms:.3f} ms, twins {p_ms:.3f} ms, "
                 f"superop run {run_ms:.1f} ms")
        if time_dense:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = dense_route()
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            dense_peak = torch.cuda.max_memory_allocated()
            del out
            row.update(dense_route_ms=dense_ms,
                       dense_route_peak_bytes=dense_peak)
            text += (f", dense route {dense_ms:.1f} ms (peak "
                     f"{dense_peak / 2**30:.3f} GiB)")
    report.setdefault("superop", []).append(row)
    print(f"open {label} [{card}]: {'planar' if planar else 'real'} "
          f"vec(rho), steps dense {n_dense} cross {n_cross} other "
          f"{n_other}, launches dense {delta['dense_axis']} cross "
          f"{delta['cross_bit_axis']}, tr {trace:.6f}, purity "
          f"{purity:.6f}, kernel vs plain {err:.2e}{text}", flush=True)


def superop_huge_case(mix_rz: bool, noisy: bool, path: dict, report: dict,
                      card: str) -> None:
    """n = 15: vec(rho) is a 30-qubit grouped state that is never copied."""
    n = SUPEROP_HUGE_N
    circuit = brickwork(n, SUPEROP_DEPTH, SEED, mix_rz)
    nm = open_noise() if noisy else None
    label = (f"superop n={n} (2n={2 * n}) depth-{SUPEROP_DEPTH} "
             f"{'Ry/Rz' if mix_rz else 'Ry+CNOT'} "
             f"{'depol+amp-damp' if noisy else 'noise-free'}")
    program2 = tdens.superop_program(tprog.compile_circuit(circuit), nm)
    plan = tplan.get_group_plan(program2)
    planar = not plan.all_real
    size = state_bytes(2 * n, planar)
    want_launches = plan_launches([program2])
    sim = DensityMatrixSimulator(noise_model=nm, device="cuda")
    walls = []
    for attempt in range(2):        # cold, then warm
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run(circuit)      # auto: superop at n = 15
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        delta = add_launches(path, NO_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if attempt == 0:
            del res
    check(isinstance(res, SuperopDensityResult)
          and res.is_planar == planar,
          f"{label}: result is a {type(res).__name__}")
    check(delta == want_launches,
          f"{label}: launches {delta}, the plan has {want_launches}")
    check(peak <= HUGE_PEAK_RATIO * size, f"{label}: peak "
          f"{peak / 2**30:.3f} GiB > {HUGE_PEAK_RATIO} x the state's "
          f"{size / 2**30:.0f} GiB")
    try:
        res.rho
    except MemoryError:
        pass
    else:
        check(False, f"{label}: .rho did not raise MemoryError")
    trace, purity = res.trace(), res.purity()
    check(abs(trace - 1.0) <= TRACE_TOL, f"{label}: tr(rho) = {trace}")
    row = {"case": label, "n": n, "planar": planar, "noisy": noisy,
           "state_bytes": size, "peak_bytes": peak, "launches": delta,
           "trace": trace, "purity": purity, "cold_run_s": walls[0],
           "run_ms": walls[1] * 1e3, "card": card}
    text = ""
    if noisy:
        check(purity < 1.0 - 1e-3, f"{label}: purity {purity} with noise")
        counts = sim.sample(res, HUGE_SHOTS, rng=np.random.default_rng(SEED))
        check(sum(counts.values()) == HUGE_SHOTS
              and all(len(b) == n for b in counts),
              f"{label}: sample returned {sum(counts.values())} shots")
        exact_z = np.array([res.expectation_z(q) for q in range(n)])
        del res
        torch.cuda.empty_cache()
        states = Simulator(noise_model=nm, device="cuda").trajectory_states(
            circuit, LAW_TRAJ, seed=SEED)
        p = states.abs().square().double().mean(0).cpu().numpy()
        del states
        idx = np.arange(1 << n)
        mean_z = np.array([np.sum(p * (1.0 - 2.0 * ((idx >> (n - 1 - q))
                                                    & 1)))
                           for q in range(n)])
        dev = float(np.abs(exact_z - mean_z).max())
        check(dev <= LAW_TOL, f"{label}: <Z_q> vs the mean over "
              f"{LAW_TRAJ} trajectories differs by {dev}")
        row["ensemble_z_dev"] = dev
        text = (f", {len(counts)} distinct strings of {HUGE_SHOTS} shots, "
                f"max |<Z_q> - trajectory mean| {dev:.4f}")
    else:
        check(abs(purity - 1.0) <= TRACE_TOL, f"{label}: purity {purity}")
        probs = res.probabilities
        del res
        torch.cuda.empty_cache()
        psi = Simulator(device="cuda").run(circuit, shots=0).final_state
        dev = float(np.abs(probs - psi.probabilities).max())
        check(dev <= STATE_TOL, f"{label}: probabilities vs "
              f"Simulator.run differ by {dev}")
        row["statevector_err"] = dev
        text = f", probabilities vs Simulator.run {dev:.2e}"
    report.setdefault("superop", []).append(row)
    print(f"open {label} [{card}]: {'planar' if planar else 'real'} "
          f"vec(rho) {size / 2**30:.0f} GiB, peak {peak / 2**30:.3f} GiB "
          f"({peak / size:.3f} x), launches dense {delta['dense_axis']} "
          f"cross {delta['cross_bit_axis']}, tr {trace:.6f}, purity "
          f"{purity:.6f}, run {walls[1] * 1e3:.1f} ms (cold "
          f"{walls[0]:.3f} s){text}", flush=True)


def dephased_ising(n: int, device: str = "cuda") -> LindbladSimulator:
    """Transverse-field Ising chain with dephasing 0.1 on every qubit and
    decay 0.05 on qubit 0."""
    jumps = [(0.1, "z", q) for q in range(n)] + [(0.05, "sigma_minus", 0)]
    return LindbladSimulator(n, models.tfim_chain(n), jumps, device=device)


def phase_lindblad(report: dict, card: str) -> None:
    from scipy.linalg import expm

    rows = report.setdefault("lindblad", {})
    # one qubit's decay among LINDBLAD_N: <Z_0>(t) = 1 - 2 exp(-gamma t)
    n, gamma, t_final = LINDBLAD_N, 0.5, 1.0
    sim = LindbladSimulator(n, [], [(gamma, "sigma_minus", 0)],
                            device="cuda")
    psi = np.zeros(1 << n, np.complex128)
    psi[1 << (n - 1)] = 1.0                      # qubit 0 (the MSB) in |1>
    out = sim.evolve(t_final, 40, initial=psi, observables=[("Z", [0])],
                     record_every=10)
    want = 1.0 - 2.0 * np.exp(-gamma * out.times)
    dev = float(np.abs(out.expectations[0] - want).max())
    check(dev <= 1e-3, f"Lindblad decay n={n}: <Z_0>(t) off exp(-gamma t) "
          f"by {dev}")
    rows["decay_dev"] = dev

    sim = dephased_ising(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.evolve(0.5, 10, observables=[("Z", [0]), ("XX", [0, 1])])
    torch.cuda.synchronize()
    ising_ms = (time.perf_counter() - t0) * 1e3 / 10
    trace = out.final.trace()
    check(abs(trace - 1.0) <= TRACE_TOL,
          f"Lindblad Ising n={n}: tr(rho) = {trace}")
    check(out.expectations.shape == (2, 11)
          and np.all(np.isfinite(out.expectations)),
          f"Lindblad Ising n={n}: expectations {out.expectations.shape}")
    rows.update(ising_n=n, ising_trace=trace, ising_ms_per_step=ising_ms)

    m = LINDBLAD_SMALL_N
    small = dephased_ising(m)
    rng = np.random.default_rng(SEED)
    psi = rng.standard_normal(1 << m) + 1j * rng.standard_normal(1 << m)
    psi /= np.linalg.norm(psi)
    got = small.evolve(0.8, 80, initial=psi).final.rho
    vec = expm(small.dense_liouvillian() * 0.8) @ np.outer(
        psi, psi.conj()).reshape(-1)
    exp_dev = float(np.abs(got.reshape(-1) - vec).max())
    check(exp_dev <= 1e-4, f"Lindblad n={m}: final rho vs "
          f"expm(dense_liouvillian t) {exp_dev}")
    rows["expm_dev"] = exp_dev
    print(f"open Lindblad [{card}]: decay n={n} max |<Z_0> - (1 - 2 "
          f"exp(-gamma t))| {dev:.2e}; Ising+dephasing n={n} tr "
          f"{trace:.6f}, {ising_ms:.1f} ms per RK4 step; n={m} final rho "
          f"vs expm(L t) {exp_dev:.2e}", flush=True)

    n = LINDBLAD_MAX_N
    sim = dephased_ising(n)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sim.evolve(0.2, LINDBLAD_STEPS, observables=[("Z", [0])],
                     record_every=LINDBLAD_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LINDBLAD_STEPS
    peak = torch.cuda.max_memory_allocated()
    trace = out.final.trace()
    check(abs(trace - 1.0) <= TRACE_TOL,
          f"Lindblad Ising n={n}: tr(rho) = {trace}")
    rho_bytes = 8 << (2 * n)
    rows.update(max_n=n, max_n_ms_per_step=step_ms, max_n_peak_bytes=peak,
                max_n_trace=trace, card=card)
    print(f"open Lindblad n={n} [{card}]: Ising+dephasing "
          f"({2 * n - 1} terms, {n + 1} jumps), {LINDBLAD_STEPS} RK4 steps, "
          f"{step_ms:.1f} ms per step, peak {peak / 2**30:.3f} GiB "
          f"({peak / rho_bytes:.2f} x the {rho_bytes / 2**20:.0f} MiB rho), "
          f"tr {trace:.6f}", flush=True)
    del out
    torch.cuda.empty_cache()


def pauli_energy(state: torch.Tensor, terms, n: int) -> float:
    """<psi| sum_k c_k P_k |psi> of a flat complex state on its device."""
    total = 0.0
    for coeff, pstr, qubits in terms:
        mat = tlind._pauli_term_matrix(pstr)
        hpsi = tapply.apply_gate(state, mat, tuple(qubits), n)
        total += coeff * float(torch.vdot(state, hpsi).real)
    return total


def phase_trotter(path: dict, report: dict, card: str) -> None:
    """Second-order Trotter evolution of the Neel state under the
    Heisenberg chain through ``Simulator.run``."""
    n = TROTTER_N
    terms = models.heisenberg_chain(n)
    sim = Simulator(device="cuda")
    drifts = []
    for steps in (TROTTER_STEPS, 2 * TROTTER_STEPS):
        circuit = models.trotter_circuit(n, terms, TROTTER_TIME, steps,
                                         order=2)
        circuit.initial_states = [q % 2 for q in range(n)]
        label = (f"Trotter order-2 heisenberg_chain({n}) t={TROTTER_TIME} "
                 f"steps={steps}")
        before = launch_counts()
        res = run_and_match(sim, circuit, label, 0, report)
        add_launches(path, before)
        energy = pauli_energy(res.final_state.device_data, terms, n)
        drifts.append(abs(energy - float(n - 1)))
        del res
    # the Neel state's energy is -sum jz = n - 1; the exact evolution
    # keeps it, a second-order formula drifts by O(dt^2): at most
    # Lambda dt^2 with Lambda = sum |c_k|, and four times less at half dt
    lam = sum(abs(c) for c, _, _ in terms)
    bound = lam * (TROTTER_TIME / TROTTER_STEPS) ** 2
    check(drifts[0] <= bound, f"Trotter n={n}: energy drift {drifts[0]} > "
          f"Lambda dt^2 = {bound}")
    check(drifts[1] <= 0.5 * drifts[0], f"Trotter n={n}: drift "
          f"{drifts[1]} at half the step, {drifts[0]} at the full one")
    report["trotter"] = {"n": n, "drifts": drifts, "bound": bound,
                         "card": card}
    print(f"open Trotter n={n} [{card}]: energy drift {drifts[0]:.3e} at "
          f"{TROTTER_STEPS} steps (bound {bound:.3e}), {drifts[1]:.3e} at "
          f"{2 * TROTTER_STEPS}", flush=True)


def phase_open_system(report: dict, card: str) -> dict:
    """8a-8d; every main-path run reads its launches from zero."""
    path: dict = {}
    small, mid, wide = SUPEROP_SIZES
    superop_case(small, False, True, path, report, card)
    for n in (mid, wide):
        # at the widest size the dense route (20 s a run) is timed once
        superop_case(n, False, True, path, report, card)
        superop_case(n, True, True, path, report, card, n == mid)
        superop_case(n, True, False, path, report, card, n == mid)
    superop_huge_case(False, False, path, report, card)
    superop_huge_case(False, True, path, report, card)
    superop_huge_case(True, True, path, report, card)
    phase_lindblad(report, card)
    phase_trotter(path, report, card)
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the open-system path: {path}")
    report["open_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 9: the analysis layer
# ---------------------------------------------------------------------------

# (n, depth, trials) of the debugger: bench.py's n = 16 depth-40
# brickwork, and n = 20 depth 8 whose 256 trials are 18 GiB as one stack.
DEBUG_CASES = [(16, 40, 50), (20, 8, 256)]
DEBUG_P = 0.01
DEBUG_TWIN_TRIALS = 8       # trials held kernel vs twin on the same draws
PEAK_SLACK = 2**30
# scripts/quantum_volume_check.py's defaults (QV_r05.json's configuration)
QV_WIDTHS = (4, 8, 12, 16, 20)
QV_TRIALS = 50
QV_NOISE = 0.002
QV_CHUNK = 10
# Porter-Thomas gives (1 + ln 2) / 2 = 0.847 for the ideal heavy mass
QV_IDEAL_RANGE = (0.83, 0.89)
SHADOW_GHZ = (16, 4096, 512)        # (n, snapshots, chunk), bench.py:400
SHADOW_WIDE = (20, 1024, 512)
SHADOW_ZZ_TOL = 0.2                 # 4.5 standard errors of sqrt(8/4096)
ZNE_N, ZNE_T, ZNE_SCALES, ZNE_P = 16, 256, (1, 3, 5), 0.02
ZNE_DM_N = 8


def tfim_step(n: int, dt: float = 0.35) -> QuantumCircuit:
    """bench.py:359-366: one Trotterized transverse-field Ising step."""
    c = QuantumCircuit(n)
    for q in range(n):
        c.add("Rx", [q], [2 * dt])
    for q in range(n - 1):
        c.add("CNOT", [q, q + 1])
        c.add("Rz", [q + 1], [2 * dt])
        c.add("CNOT", [q, q + 1])
    return c


def timed(fn):
    """(result, host seconds ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def debugger_case(n: int, depth: int, trials: int, path: dict,
                  report: dict, card: str) -> None:
    """9a: run_full_debug ideal and noisy, then the noise attribution over
    ``trials`` trials, batch by batch."""
    from quantum_simulator_tpu_torch.debugger import CircuitDebugger

    circuit = brickwork(n, depth, SEED, False)
    program = tprog.compile_circuit(circuit)
    nm = noise_model("depol", DEBUG_P)
    dbg = CircuitDebugger(device="cuda")
    case = f"debugger n={n} depth-{depth}"
    row: dict = {"case": case, "trials": trials}

    cuda_exec.reset_launch_counts()
    snaps, row["ideal_s"] = timed(lambda: dbg.run_full_debug(circuit))
    add_launches(path, {k: 0 for k in launch_counts()})
    check(len(snaps) == program.num_columns + 1,
          f"{case}: {len(snaps)} snapshots for {program.num_columns} columns")
    steps = Simulator(device="cuda").run_step_by_step(circuit)
    err = max(float((s.state.device_data - t.device_data).abs().max())
              for s, (t, _) in zip(snaps, steps))
    final = Simulator(device="cuda").run(circuit, shots=0).final_state
    err = max(err, float((snaps[-1].state.device_data
                          - final.device_data).abs().max()))
    check(err <= STATE_TOL, f"{case}: ideal snapshots vs run_step_by_step "
          f"and run: {err}")
    row["ideal_vs_steps"] = err
    del snaps, final

    cuda_exec.reset_launch_counts()
    snaps, row["noisy_s"] = timed(
        lambda: dbg.run_full_debug(circuit, nm, seed=SEED))
    add_launches(path, {k: 0 for k in launch_counts()})
    fids = [s.fidelity for s in snaps]
    norm_err = max(abs(float(s.state.device_data.abs().square().sum()) - 1)
                   for s in snaps)
    check(all(-1e-6 <= f <= 1 + 1e-5 for f in fids) and norm_err <= 1e-4,
          f"{case}: noisy snapshot fidelities {min(fids)}..{max(fids)}, "
          f"max |norm - 1| {norm_err}")
    del snaps

    captured = {}
    reduce = dbg._trial_reductions

    def capturing(*args, **kwargs):
        captured["r"] = reduce(*args, **kwargs)
        return captured["r"]

    dbg._trial_reductions = capturing
    chunk = tsim.record_rows_per_batch(program, trials)
    per = (program.num_columns + 5) * (8 << n)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    attr, row["attribution_s"] = timed(lambda: dbg.compute_noise_attribution(
        circuit, nm, n_trials=trials, seed=SEED))
    delta = add_launches(path, {k: 0 for k in launch_counts()})
    peak = torch.cuda.max_memory_allocated() - base
    batches = -(-trials // chunk)
    fid, _ = captured["r"]
    gaps = 1.0 - fid
    tele = abs(attr.total_fidelity_loss
               - (gaps[:, -1].mean() - gaps[:, 0].mean()))
    check(tele <= 1e-6, f"{case}: contributions sum to "
          f"{attr.total_fidelity_loss}, gap_C - gap_0 differs by {tele}")
    check(peak <= chunk * per + PEAK_SLACK,
          f"{case}: attribution peak {peak} > one batch {chunk * per} + 1 GiB")
    check(n < 20 or batches >= 2, f"{case}: {trials} trials in {batches} "
          "batch(es); the stack must be cut")
    check(delta["dense_axis"] > 0 and delta["cross_bit_axis"] > 0,
          f"{case}: attribution launches {delta}")

    # the same draws through the kernels and through the twins
    u = tplan.draw_uniforms(program, nm, DEBUG_TWIN_TRIALS, "cuda",
                            torch.Generator(device="cuda").manual_seed(SEED))
    got, draws = tplan.group_trajectory_body(
        program, nm, program.initial_params, DEBUG_TWIN_TRIALS, "cuda",
        record_columns=True, uniforms=u)
    want, _ = tplan.group_trajectory_body(
        program, nm, program.initial_params, DEBUG_TWIN_TRIALS, "cuda",
        draws=draws, record_columns=True, plain=True)
    err = float((got - want).abs().max())
    check(err <= STATE_TOL, f"{case}: max |kernel - plain| over every "
          f"snapshot = {err}")
    del got, want
    row.update(kernel_vs_plain=err, batches=batches, batch_trials=chunk,
               peak_bytes=peak, batch_bytes=chunk * per,
               telescoping_err=tele, launches=delta,
               total_fidelity_loss=attr.total_fidelity_loss)
    report.setdefault("debugger", []).append(row)
    print(f"analysis {case} [{card}]: run_full_debug ideal "
          f"{row['ideal_s'] * 1e3:.1f} ms, noisy {row['noisy_s'] * 1e3:.1f} "
          f"ms; compute_noise_attribution({trials} trials) "
          f"{row['attribution_s'] * 1e3:.1f} ms in {batches} batch(es) of "
          f"<= {chunk}, peak {peak / 2**30:.3f} GiB (batch reckoning "
          f"{chunk * per / 2**30:.3f} GiB), launches {delta}, total loss "
          f"{attr.total_fidelity_loss:.4f}, telescoping {tele:.1e}, kernel "
          f"vs plain {err:.2e}", flush=True)


def phase_qv(path: dict, report: dict, card: str) -> None:
    """9b: quantum volume at scale, with the kernels-vs-twins check on one
    chunk of the widest width."""
    from quantum_simulator_tpu_torch.analysis import (BenchmarkAnalysis,
                                                      heavy_output_chunk,
                                                      qv_model_circuit)

    nm = noise_model("depol", QV_NOISE)
    rows_out = []
    cuda_exec.reset_launch_counts()
    res, wall = timed(lambda: BenchmarkAnalysis.quantum_volume_at_scale(
        widths=QV_WIDTHS, num_trials=QV_TRIALS, noise_model=nm, seed=SEED,
        chunk=QV_CHUNK, on_width=rows_out.append, device="cuda"))
    delta = add_launches(path, {k: 0 for k in launch_counts()})
    lo, hi = QV_IDEAL_RANGE
    for r in res["results_per_width"]:
        if r["width"] >= 8:
            check(lo <= r["heavy_output_ideal_mean"] <= hi,
                  f"QV width {r['width']}: ideal heavy mean "
                  f"{r['heavy_output_ideal_mean']} outside [{lo}, {hi}]")
        print(f"analysis QV width {r['width']} [{card}]: heavy "
              f"{r['heavy_output_mean']:.4f} +- "
              f"{r['heavy_output_stderr']:.4f} (ideal "
              f"{r['heavy_output_ideal_mean']:.4f}) "
              f"{'pass' if r['passed'] else 'fail'}, {r['seconds']:.3f} s",
              flush=True)
    m = QV_WIDTHS[-1]
    program = tprog.compile_circuit(qv_model_circuit(m))
    rows = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0, 2 * np.pi, (QV_CHUNK, program.num_params)).astype(
            np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h_i, h_n, draws = heavy_output_chunk(program, nm, rows, "cuda", 1, gen)
    p_i, p_n, _ = heavy_output_chunk(program, nm, rows, "cuda", 1,
                                     draws=draws, plain=True)
    err = max(float((h_n - p_n).abs().max()), float((h_i - p_i).abs().max()))
    check(err <= STATE_TOL, f"QV width {m} chunk: heavy outputs kernel vs "
          f"plain differ by {err}")
    report["qv"] = {"result": res, "wall_s": wall, "launches": delta,
                    "kernel_vs_plain": err}
    print(f"analysis QV {QV_WIDTHS} x {QV_TRIALS} trials, depolarizing "
          f"{QV_NOISE} [{card}]: QV {res['quantum_volume']}, {wall:.2f} s, "
          f"launches {delta}, width-{m} chunk kernel vs plain {err:.2e}",
          flush=True)


def phase_shadows(path: dict, report: dict, card: str) -> None:
    """9c: classical shadows of GHZ-16, and the n = 20 basis layer's
    kernels against its twins."""
    from quantum_simulator_tpu_torch import shadows as tsh

    n, S, chunk = SHADOW_GHZ
    circuit = ghz(n)
    tsh.collect_shadows(circuit, chunk, seed=3, chunk=chunk, device="cuda")
    cuda_exec.reset_launch_counts()
    data, wall = timed(lambda: tsh.collect_shadows(circuit, S, seed=4,
                                                   chunk=chunk,
                                                   device="cuda"))
    delta = add_launches(path, {k: 0 for k in launch_counts()})
    zz = data.estimate_pauli("ZZ", [0, 1])
    check(abs(zz - 1.0) <= SHADOW_ZZ_TOL, f"shadows GHZ-{n}: <Z0 Z1> = {zz}")
    check(delta["dense_axis"] > 0, f"shadows launches {delta}")
    print(f"analysis shadows GHZ-{n} [{card}]: {S / wall:.0f} snapshots/s "
          f"({S} in {wall:.3f} s, chunk {chunk}), <Z0 Z1> {zz:+.3f}, "
          f"launches {delta}", flush=True)

    n2, S2, chunk2 = SHADOW_WIDE
    wide = brickwork(n2, 8, SEED, True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda_exec.reset_launch_counts()
    data2, wall2 = timed(lambda: tsh.collect_shadows(wide, S2, seed=5,
                                                     chunk=chunk2,
                                                     device="cuda"))
    delta2 = add_launches(path, {k: 0 for k in launch_counts()})
    peak = torch.cuda.max_memory_allocated() - base
    check(data2.outcomes.shape == (S2, n2), f"shadows n={n2}: outcomes of "
          f"shape {data2.outcomes.shape}")
    psi = Simulator(device="cuda").run(wide, shots=0).final_state.device_data
    bases = data2.bases[:chunk2]
    want = tsh.rotate_snapshots(psi, n2, bases, plain=True)
    got = tsh.rotate_snapshots(psi, n2, bases)
    err = float((got - want).abs().max())
    check(err <= STATE_TOL, f"shadows n={n2}: rotated states kernel vs "
          f"plain {err}")
    del got, want
    report["shadows"] = {"ghz_snapshots_per_s": S / wall, "zz": zz,
                         "launches": delta, "wide_s": wall2,
                         "wide_launches": delta2, "wide_peak_bytes": peak,
                         "kernel_vs_plain": err}
    print(f"analysis shadows n={n2} brickwork Ry/Rz depth 8 [{card}]: "
          f"{S2 / wall2:.0f} snapshots/s ({S2} in {wall2:.3f} s), peak "
          f"{peak / 2**30:.3f} GiB, launches {delta2}, rotated states "
          f"kernel vs plain {err:.2e}", flush=True)


def phase_mitigation(path: dict, report: dict, card: str) -> None:
    """9d: ZNE of <Z0> after a TFIM step, on trajectory ensembles at n = 16
    and on the superoperator density matrix at n = 8."""
    from quantum_simulator_tpu_torch.mitigation import zne_expectation

    nm = noise_model("depol", ZNE_P)
    c = tfim_step(ZNE_N)
    probs = Simulator(device="cuda").run(c, shots=0).final_state.probabilities
    half = 1 << (ZNE_N - 1)
    ideal = float(probs[:half].sum() - probs[half:].sum())
    sim = Simulator(noise_model=nm, device="cuda")

    def expect_z0(circ):
        states = sim.trajectory_states(circ, ZNE_T, seed=7)
        pr = states.abs().square().reshape(ZNE_T, 2, -1).sum(-1)
        return float((pr[:, 0] - pr[:, 1]).mean())

    cuda_exec.reset_launch_counts()
    res, wall = timed(lambda: zne_expectation(expect_z0, c, ZNE_SCALES))
    delta = add_launches(path, {k: 0 for k in launch_counts()})
    raw_err = abs(res.raw_values[0] - ideal)
    zne_err = abs(res.value - ideal)
    print(f"analysis ZNE n={ZNE_N} TFIM <Z0>, depolarizing {ZNE_P}, "
          f"{ZNE_T} trajectories per scale {ZNE_SCALES} [{card}]: raw err "
          f"{raw_err:.4f}, ZNE err {zne_err:.4f} (within sampling noise at "
          f"this T), {wall:.3f} s, launches {delta}", flush=True)

    c8 = tfim_step(ZNE_DM_N)
    ideal8 = tdens.DensityMatrixSimulator(device="cuda").run(
        c8).expectation_z(0)
    dm = tdens.DensityMatrixSimulator(noise_model=nm, device="cuda")
    cuda_exec.reset_launch_counts()
    res8, wall8 = timed(lambda: zne_expectation(
        lambda circ: float(dm.run(circ, method="superop").expectation_z(0)),
        c8, ZNE_SCALES))
    delta8 = add_launches(path, {k: 0 for k in launch_counts()})
    raw8 = abs(res8.raw_values[0] - ideal8)
    zne8 = abs(res8.value - ideal8)
    check(zne8 < raw8 / 5, f"ZNE n={ZNE_DM_N} density matrix: ZNE err "
          f"{zne8} not below a fifth of the raw {raw8}")
    check(delta8["dense_axis"] > 0 and delta8["cross_bit_axis"] > 0,
          f"ZNE n={ZNE_DM_N} superop launches {delta8}")
    report["zne"] = {"n16": {"raw_err": raw_err, "zne_err": zne_err,
                             "s": wall, "launches": delta},
                     "n8_dm": {"raw_err": raw8, "zne_err": zne8, "s": wall8,
                               "launches": delta8}}
    print(f"analysis ZNE n={ZNE_DM_N} TFIM <Z0>, superop density matrix "
          f"[{card}]: raw err {raw8:.5f}, ZNE err {zne8:.6f} ({wall8:.3f} "
          f"s, launches {delta8})", flush=True)


def phase_analysis(report: dict, card: str) -> dict:
    """9a-9d; every main-path run reads its launches from zero."""
    path: dict = {}
    for n, depth, trials in DEBUG_CASES:
        debugger_case(n, depth, trials, path, report, card)
    phase_qv(path, report, card)
    phase_shadows(path, report, card)
    phase_mitigation(path, report, card)
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched on the analysis path: {path}")
    report["analysis_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 10: the bit engines
# ---------------------------------------------------------------------------

GHZ_CLIFF = (100, 256)               # (n, shots), bench.py:438-453
CLIFF_LAW = (12, 10, 4096)           # brickwork (n, depth, shots)
CLIFF_TVD = 0.05
CLIFF_NOISY_LAW = (6, 0.05, 16384)   # GHZ (n, depolarizing p, shots)
CLIFF_MONITORED = (128, 8, 64)       # (n, depth, trajectories)
CLIFF_NOISY = (64, 8, 0.01, 1024)    # (n, depth, depolarizing p, shots)
FRAME_CELL = (25, 1 << 20, 0.05)     # repetition d, trials, p (bench.py:424)
ENGINE_TRIALS = 1000
UF_TRIALS = 100_000
ML_CELL = (9, 9, 4096, 0.05)         # repetition d, R, trials, p = q
MATCHING_CELL = (7, 7, 10_000, 0.02)
CIRCUIT_CASES = ((5, 5), (7, 7))     # scripts/circuit_threshold.py:39-44
CIRCUIT_P = 0.003
CIRCUIT_TRIALS = 20_000
ENGINE_ROWS = (3, 3, 256)            # d, R, uniform rows


def clifford_brickwork(n: int, depth: int, seed: int,
                       measure: bool = False,
                       h_qubits: tuple | None = None) -> QuantumCircuit:
    """Random one-qubit Cliffords on every qubit, then a CNOT / CZ brick,
    per layer; with ``measure``, a ``Measure`` on every fourth qubit
    after each second layer. With ``h_qubits``, H acts only on those
    qubits of the first layer, so the outcomes span at most
    2^len(h_qubits) bit strings (a law that 4096 shots resolve)."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    one_q = ["H", "S", "S_DAG", "X", "Y", "Z", "I"]
    for layer in range(depth):
        for q in range(n):
            names = one_q if h_qubits is None else one_q[1:]
            name = str(rng.choice(names))
            if h_qubits is not None and layer == 0 and q in h_qubits:
                name = "H"
            c.add(name, [q], [], col)
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add("CNOT" if rng.random() < 0.7 else "CZ", [q, q + 1], [],
                  col)
        col += 1
        if measure and layer % 2:
            for q in range(layer % 4, n, 4):
                c.add("Measure", [q], [], col)
            col += 1
    return c


def tvd_counts(counts: dict, probs: np.ndarray, n: int) -> float:
    shots = sum(counts.values())
    emp = np.zeros(1 << n)
    for k, v in counts.items():
        emp[int(k, 2)] = v / shots
    return 0.5 * float(np.abs(emp - probs).sum())


def phase_clifford(report: dict, card: str) -> None:
    """10a: the tableau engine."""
    sim = tclif.CliffordSimulator(device="cuda")
    n, shots = GHZ_CLIFF
    c = ghz(n)
    sim.run(c, shots=shots, seed=0)
    (counts, tab), s = timed(lambda: sim.run(c, shots=shots, seed=1))
    zeros, ones = "0" * n, "1" * n
    check(set(counts) <= {zeros, ones}, f"GHZ-{n} outcomes {set(counts)}")
    check(all(0.4 <= counts.get(k, 0) / shots <= 0.6 for k in (zeros, ones)),
          f"GHZ-{n} split {counts}")
    cpu_tab = tclif.CliffordSimulator(device="cpu")._final_tableau(c)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(tab, cpu_tab)),
          f"GHZ-{n} tableau differs between the card and the CPU")
    gen = torch.Generator().manual_seed(SEED)
    rb = torch.randint(0, 2, (32, n), generator=gen, dtype=torch.int8)
    bits_card = tclif.sample_bits(tab, rb.cuda()).cpu()
    check(torch.equal(bits_card, tclif.sample_bits(cpu_tab, rb)),
          f"GHZ-{n} samples differ between the card and the CPU")
    ent = tclif.CliffordSimulator.entanglement_entropy(tab,
                                                       list(range(n // 2)))
    check(ent == 1.0, f"GHZ-{n} half-chain entropy {ent} bits, not 1")
    report["clifford"] = {"ghz_shots_per_s": shots / s, "ghz_s": s}
    print(f"bit engines: Clifford GHZ-{n} {shots} shots {s * 1e3:.1f} ms, "
          f"{shots / s:.1f} shots/s; tableau and 32 samples equal to the "
          f"CPU's; half-chain entropy {ent} bit [{card}]", flush=True)

    ln, depth, lshots = CLIFF_LAW
    cl = clifford_brickwork(ln, depth, SEED)
    counts, _ = sim.run(cl, shots=lshots, seed=2)
    probs = Simulator(device="cuda").run(cl, shots=0).final_state \
        .probabilities
    support = int((probs > 1e-9).sum())
    check(all(probs[int(k, 2)] > 1e-9 for k in counts),
          f"Clifford brickwork n={ln}: a sample outside the support")
    cl = clifford_brickwork(ln, depth, SEED, h_qubits=(0, 5, 9))
    counts, _ = sim.run(cl, shots=lshots, seed=2)
    probs = Simulator(device="cuda").run(cl, shots=0).final_state \
        .probabilities
    tvd = tvd_counts(counts, probs, ln)
    check(tvd <= CLIFF_TVD, f"Clifford brickwork n={ln} TVD {tvd}")
    gn, gp, gshots = CLIFF_NOISY_LAW
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(gp))
    counts = sim.run_with_noise(ghz(gn), nm, shots=gshots, seed=3)
    rho = DensityMatrixSimulator(noise_model=nm, device="cuda").run(
        ghz(gn), method="dense")
    exact = np.clip(rho.probabilities, 0, None)
    ntvd = tvd_counts(counts, exact / exact.sum(), gn)
    check(ntvd <= CLIFF_TVD, f"noisy Clifford GHZ-{gn} TVD {ntvd}")
    print(f"bit engines: Clifford brickwork n={ln} depth {depth}: "
          f"{lshots} samples inside the statevector's support of "
          f"{support}; with H on 3 qubits TVD {tvd:.4f} vs the "
          f"statevector; noisy GHZ-{gn} p={gp} TVD {ntvd:.4f} vs the "
          f"density matrix ({gshots} shots)", flush=True)

    mn, mdepth, T = CLIFF_MONITORED
    cm = clifford_brickwork(mn, mdepth, SEED + 1, measure=True)
    sim.monitored_trajectories(cm, 2, seed=4)
    (outs, sites, tabs), ms = timed(
        lambda: sim.monitored_trajectories(cm, T, seed=5))
    check(outs.shape == (T, len(sites)) and set(np.unique(outs)) <= {0, 1},
          f"monitored n={mn} outcomes {outs.shape}")
    nn, ndepth, np_, nshots = CLIFF_NOISY
    nmn = NoiseModel()
    nmn.add_global_noise(DepolarizingNoise(np_))
    cn = clifford_brickwork(nn, ndepth, SEED + 2)
    sim.run_with_noise(cn, nmn, shots=8, seed=6)
    ncounts, ns = timed(lambda: sim.run_with_noise(cn, nmn, shots=nshots,
                                                   seed=7))
    check(sum(ncounts.values()) == nshots, "noisy Clifford shots")
    report["clifford"].update({"monitored_traj_per_s": T / ms,
                               "noisy_shots_per_s": nshots / ns,
                               "law_tvd": tvd, "noisy_law_tvd": ntvd})
    print(f"bit engines: Clifford monitored n={mn} depth {mdepth} "
          f"({len(sites)} measurements) T={T} {ms * 1e3:.1f} ms, "
          f"{T / ms:.1f} trajectories/s; run_with_noise n={nn} depth "
          f"{ndepth} p={np_} {nshots} shots {ns * 1e3:.1f} ms, "
          f"{nshots / ns:.1f} shots/s [{card}]", flush=True)


def phase_frame_qec(path: dict, report: dict, card: str) -> None:
    """10b: the frame and statevector QEC engines and the matchers."""
    d, T, p = FRAME_CELL
    fr = tqf.FrameQECSimulator(tqf.repetition_frame_spec(d), device="cuda")
    fr.throughput_sweep(p, T, seed=0)
    (rate, succ), s = timed(lambda: fr.throughput_sweep(p, T, seed=1))
    check(rate < 1e-3 and succ > 0, f"repetition d={d} rate {rate}")
    report["frame"] = {"rep25_trials_per_s": T / s, "rep25_s": s}
    print(f"bit engines: frame-QEC repetition d={d} {T} trials "
          f"{s * 1e3:.1f} ms, {T / s:.4g} trials/s, logical rate {rate} "
          f"[{card}]", flush=True)

    signs = np.where(np.arange(ENGINE_TRIALS) % 2 == 0, 1.0, -1.0)
    for code in (tqec.BitFlipCode(), tqec.PhaseFlipCode(),
                 tqec.SteaneCode(), tqec.RotatedSurfaceCode()):
        cuda_exec.reset_launch_counts()
        sv = tqec.QECSimulator(code, device="cuda")
        encoded = {}
        if hasattr(code, "_encoding_circuit"):
            for b in (0, 1):
                encoded[b] = run_and_match(
                    Simulator(device="cuda"), code._encoding_circuit(b),
                    f"{code.name} encode |{b}>_L", 0, report
                ).final_state.device_data
        ideals = sv._ideals(ENGINE_TRIALS)
        delta = add_launches(path, {k: 0 for k in launch_counts()})
        check(all(torch.equal(sv._encoded(b).device_data, v)
                  for b, v in encoded.items()),
              f"{code.name}: the cycles' encoded states differ from the "
              f"checked encodes")
        frs = tqf.FrameQECSimulator.from_code(code, device="cuda")
        u = tqec.trial_uniforms(np.random.default_rng(SEED), ENGINE_TRIALS,
                                code.data_qubits, "cuda")
        (fb, fa, z_exp, *_), cs = timed(
            lambda: sv.cycles("depolarizing", 0.05, ideals, u))
        ok_b, ok_a, flip = frs.sweep_raw(0.05, ENGINE_TRIALS, "depolarizing",
                                         uniforms=u)
        z = z_exp.cpu().numpy()
        same = (torch.equal((fb > 0.5).int(), ok_b)
                and torch.equal((fa > 0.5).int(), ok_a)
                and np.array_equal((z * signs < 0).astype(np.int32),
                                   flip.cpu().numpy()))
        check(same, f"{code.name}: statevector and frame flags differ")
        a = sv.threshold_sweep([0.05], ENGINE_TRIALS, "depolarizing", SEED)
        b = frs.threshold_sweep([0.05], ENGINE_TRIALS, "depolarizing", SEED)
        check(a[0].success_rate == b[0].success_rate
              and a[0].decoder_success_rate == b[0].decoder_success_rate,
              f"{code.name}: sweeps differ under one seed")
        print(f"bit engines: {code.name} statevector vs frame, "
              f"{ENGINE_TRIALS} trials: per-trial flags identical; "
              f"statevector cycles {cs * 1e3:.1f} ms; encode launches "
              f"{delta}", flush=True)

    calls = dict(tqm.DECODE_CALLS)
    sweeps = {}
    for dist in (5, 7):
        frs = tqf.FrameQECSimulator(tqf.surface_code_frame_spec(dist),
                                    device="cuda")
        pts, ss = timed(lambda: frs.threshold_sweep(
            [0.01, 0.03], UF_TRIALS, "depolarizing", seed=SEED))
        sweeps[dist] = {"s": ss, "logical": [q.logical_rate for q in pts]}
        print(f"bit engines: surface d={dist} "
              f"({'exact LUT' if dist == 5 else 'union-find'}) "
              f"{UF_TRIALS} trials x 2 p: {ss:.3f} s, logical rates "
              f"{[round(q.logical_rate, 5) for q in pts]} [{card}]",
              flush=True)
    check(tqm.DECODE_CALLS["native"] > calls["native"]
          and tqm.DECODE_CALLS["python"] == calls["python"],
          f"the d=7 union-find sweep did not decode in C: "
          f"{tqm.DECODE_CALLS} (before {calls})")
    spec7 = tqf.surface_code_frame_spec(7)
    g = tqm.MatchingGraph.from_checks(spec7.comp_checks)
    syn = np.random.default_rng(SEED).integers(
        0, 2, (2000, g.n_checks)).astype(np.uint8)
    check(np.array_equal(tqm.decode_batch(g, syn),
                         tqm.decode_batch(g, syn, force_python=True)),
          "C and Python union-find decoders differ")

    dm, rm, tm, pm = ML_CELL
    (ml, mls) = timed(lambda: tqf.FrameQECSimulator.ml_memory_experiment(
        dm, pm, rm, tm, pm, seed=SEED, device="cuda"))
    mlsurf, mlss = timed(
        lambda: tqf.FrameQECSimulator.ml_surface_memory_experiment(
            pm, 3, tm, pm, seed=SEED, device="cuda"))
    check(ml["ml_failure_probability"]
          <= ml["final_syndrome_failure_probability"]
          and mlsurf["ml_failure_probability"]
          <= mlsurf["final_syndrome_failure_probability"],
          f"ML memory above its single-shot baseline: {ml}, {mlsurf}")
    dmt, rmt, tmt, pmt = MATCHING_CELL
    mt, mts = timed(lambda: tqf.FrameQECSimulator.matching_memory_experiment(
        pmt, rmt, tmt, pmt, dmt, seed=SEED, device="cuda"))
    check(mt["matching_failure_probability"] < 0.5, f"matching {mt}")
    report["frame"].update({"surface_sweeps": sweeps, "ml": ml,
                            "ml_s": mls, "ml_surface": mlsurf,
                            "ml_surface_s": mlss, "matching": mt,
                            "matching_s": mts})
    print(f"bit engines: ML repetition d={dm} R={rm} {tm} trials "
          f"{mls:.3f} s (ML {ml['ml_failure_probability']:.4f} vs "
          f"single-shot {ml['final_syndrome_failure_probability']:.4f}); "
          f"ML surface d=3 R=3 {mlss:.3f} s "
          f"({mlsurf['ml_failure_probability']:.4f} vs "
          f"{mlsurf['final_syndrome_failure_probability']:.4f}); matching "
          f"d={dmt} R={rmt} {tmt} trials {mts:.3f} s "
          f"({mt['matching_failure_probability']:.4f}) [{card}]",
          flush=True)


def phase_circuit_qec(report: dict, card: str) -> None:
    """10c: circuit-level memory, its detector error model and decode."""
    calls = dict(tqm.DECODE_CALLS)
    out = {}
    for d, R in CIRCUIT_CASES:
        clear_circuit_caches()
        cold, cold_s = timed(lambda: tqc.circuit_level_memory(
            d, R, CIRCUIT_P, CIRCUIT_TRIALS, seed=SEED, device="cuda"))
        check(cold["logical_failure_probability"] < 0.02,
              f"cold circuit_level_memory d={d}: {cold}")
        clear_circuit_caches()
        dem, dem_s = timed(lambda: tqd.extract_dem(d, R, "z", device="cuda"))
        (run, lay), probe_s = timed(lambda: tqc._trajectory_fn(
            d, R, CIRCUIT_P, "z", "linear", device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        u = torch.rand((CIRCUIT_TRIALS, run.schedule_length), generator=gen,
                       device="cuda")
        run(u[:64])
        outs, sample_s = timed(lambda: run(u).cpu().numpy().astype(np.uint8))
        t0 = time.perf_counter()
        det = tqc.detection_events(lay, outs)
        raw = ((lay.data_outcomes(outs) @ lay.sector_support) % 2
               ).astype(np.int32)
        pred = dem.decode(det.reshape(CIRCUIT_TRIALS, -1), CIRCUIT_P)
        decode_s = time.perf_counter() - t0
        p_fail = float((raw ^ pred).mean())
        res, warm_s = timed(lambda: tqc.circuit_level_memory(
            d, R, CIRCUIT_P, CIRCUIT_TRIALS, device="cuda", uniforms=u))
        check(res["logical_failure_probability"] == p_fail,
              f"circuit_level_memory d={d} differs from its pieces")
        check(p_fail < 0.02, f"circuit-level d={d} R={R} p={CIRCUIT_P}: "
              f"logical failure {p_fail}")
        rate = CIRCUIT_TRIALS / (sample_s + decode_s)
        out[f"d{d}"] = {"cold_s": cold_s,
                        "cold_trials_per_s": CIRCUIT_TRIALS / cold_s,
                        "warm_s": warm_s,
                        "warm_trials_per_s": CIRCUIT_TRIALS / warm_s,
                        "dem_s": dem_s, "probe_s": probe_s,
                        "sample_s": sample_s, "decode_s": decode_s,
                        "sample_decode_trials_per_s": rate, "p_fail": p_fail,
                        "dem_edges": int(dem.edges.shape[0]),
                        "n_faults": dem.n_faults}
        print(f"bit engines: circuit-level surface d={d} R={R} "
              f"p={CIRCUIT_P} {CIRCUIT_TRIALS} trials (linear, dem): one "
              f"cold circuit_level_memory call end to end {cold_s:.3f} s, "
              f"{CIRCUIT_TRIALS / cold_s:.1f} end-to-end trials/s; DEM "
              f"extraction {dem_s:.3f} s ({dem.n_faults} faults, "
              f"{dem.edges.shape[0]} edges), signature probe "
              f"{probe_s:.3f} s, sampling {sample_s * 1e3:.1f} ms, host "
              f"decode {decode_s * 1e3:.1f} ms, {rate:.1f} sampling+decode "
              f"trials/s; warm call (DEM and signatures cached) "
              f"{warm_s:.3f} s, {CIRCUIT_TRIALS / warm_s:.1f} trials/s; "
              f"logical failure {p_fail:.5f} [{card}]", flush=True)
    check(tqm.DECODE_CALLS["native"] > calls["native"]
          and tqm.DECODE_CALLS["python"] == calls["python"],
          f"circuit-level decoding did not run in C: {tqm.DECODE_CALLS}")

    d, R, rows = ENGINE_ROWS
    records = {}
    for engine in ("linear", "frame", "clifford"):
        run, lay = tqc._trajectory_fn(d, R, 0.01, "z", engine,
                                      device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        u = torch.rand((rows, run.schedule_length), generator=gen,
                       device="cuda")
        records[engine] = tqc.detection_events(
            lay, run(u).cpu().numpy().astype(np.uint8))
    check(all(np.array_equal(records["linear"], v)
              for v in records.values()),
          f"d={d} R={R}: the three engines' detection events differ")
    report["circuit"] = out
    print(f"bit engines: d={d} R={R} linear / frame / clifford detection "
          f"events identical on {rows} rows; native module "
          f"{tnative.build_dir()} decoded {tqm.DECODE_CALLS['native']} "
          f"batches in C [{card}]", flush=True)


def clear_circuit_caches() -> None:
    """Forget cached DEMs, samplers and signatures: the next
    ``circuit_level_memory`` call pays its whole set-up."""
    tqd._dem_cache.clear()
    tqc._traj_cache.clear()
    tqc._sig_cache.clear()


def phase_bit_engines(report: dict, card: str) -> dict:
    """10a-10c; the main path's launches are the QEC encodes'. The native
    module is built first, outside every timed region (and the phase
    fails if it does not build)."""
    t0 = time.perf_counter()
    tnative.native_module(required=True)
    report["native_build_s"] = time.perf_counter() - t0
    print(f"bit engines: native module {tnative.build_dir()} ready in "
          f"{report['native_build_s']:.3f} s", flush=True)
    path = {k: 0 for k in launch_counts()}
    phase_clifford(report, card)
    phase_frame_qec(path, report, card)
    phase_circuit_qec(report, card)
    check(path["dense_axis"] > 0, f"no kernel launched by the QEC encodes: "
          f"{path}")
    report["bit_engine_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 11: the MPS family
# ---------------------------------------------------------------------------

MPS_EXACT = (12, 8, 64)              # Ry/Rz brickwork (n, depth, chi)
MPS_SV_TOL = 2e-5                    # tests/test_mps.py:12
MPS_BENCH = (48, 4, 16, 64)          # bench.py:461-483 (n, depth, chi, shots)
MPS_Z_TOL = 1e-4                     # <Z_q>, card vs CPU
MPS_WIDE = (128, 8, 64, 1024)        # (n, depth, chi, shots)
MPS_NOISY = (48, 4, (16, 64), 1024, 0.01)   # (n, depth, chis, shots, p)
MPS_DEEP = (16, 12, (16, 64), 32, 0.01)     # bonds that reach chi = 64
MPS_LAW = (4, 8, 4000, 0.06)         # (n, chi, shots, TVD bound), test_mps:217
MPS_MONITORED = (48, 4, 16, 64)      # (n, depth, chi, T)
MPS_SVD_BATCH = (1024, (16, 32, 64))  # one batched split per chi
VQE_MPS = (50, 2, 16)                # hardware_efficient_ansatz(50, 2), chi
VQE_MPS_EXACT = (10, 2, 32)          # exact: held to the statevector grad
MPS_GRAD_TOL = 1e-4
SHADOW_MPS = (40, 4096, 32, 512)     # GHZ (n, snapshots, chi, chunk)
SHADOW_MEAN_TOL = 0.1
DMRG_BENCH = (64, -1.0, -0.8, 16, 5, 10)   # bench.py:485-509
DMRG_REL_TOL = 1e-4                  # tests/test_dmrg.py:66
DMRG_EXCITED = (8, 3, 8, 5, 5e-4)    # (n, states, chi, sweeps, tol)
LINDBLAD_MPS = (40, 16, 40, 16)      # README.md:297-305 (n, chi, steps, T)
CORR_WIDE = (40, 32, 2.0, 40)        # TFIM quench (n, chi, t, steps)
CORR_DENSE = (8, 16, 1.0, 200, 5e-4)  # (n, chi, t, steps, tol)


class LinalgClock:
    """Host seconds and calls of ``torch.linalg.svd`` / ``qr`` / ``eigh``
    / ``svdvals`` inside the ``with`` block. Each wrapped call is
    bracketed by synchronizes (the queue before it is drained outside the
    count); these calls wait for the device anyway, so what is counted is
    the factorisation and its round trip."""

    NAMES = ("svd", "qr", "eigh", "svdvals")

    def __init__(self):
        self.seconds = {k: 0.0 for k in self.NAMES}
        self.calls = {k: 0 for k in self.NAMES}
        self._real = {}

    def __enter__(self):
        for name in self.NAMES:
            real = getattr(torch.linalg, name)
            self._real[name] = real

            def wrapped(*a, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                return out

            setattr(torch.linalg, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(torch.linalg, name, real)

    def share(self, wall: float) -> str:
        parts = [f"{k} {self.calls[k]} calls {self.seconds[k]:.3f} s "
                 f"({100 * self.seconds[k] / wall:.1f} %)"
                 for k in self.NAMES if self.calls[k]]
        return ", ".join(parts)


def clocked(fn):
    """(output and wall of a plain run, LinalgClock of a second,
    instrumented run)."""
    out, wall = timed(fn)
    with LinalgClock() as clock:
        _, wall_i = timed(fn)
    clock.wall = wall_i
    return out, wall, clock


def rx_brickwork(n: int, depth: int) -> QuantumCircuit:
    """bench.py:461-473: Rx(0.3 + 0.01 q) on every qubit, then a CNOT
    brick, per layer."""
    c = QuantumCircuit(n)
    col = 0
    for d in range(depth):
        for q in range(n):
            c.add("Rx", [q], [0.3 + 0.01 * q], col)
        col += 1
        for q in range(d % 2, n - 1, 2):
            c.add("CNOT", [q, q + 1], [], col)
        col += 1
    return c


def with_measures(c: QuantumCircuit) -> QuantumCircuit:
    """A ``Measure`` on every fourth qubit after every second CNOT
    layer (phase 7's monitored pattern), shifting later columns."""
    out = QuantumCircuit(c.num_qubits)
    shift, layer = 0, 0
    for col in range(c.get_column_count()):
        gates = c.get_gates_at_column(col)
        for g in gates:
            out.add(g.gate_name, list(g.target_qubits), list(g.params),
                    col + shift)
        if gates and len(gates[0].target_qubits) == 2:
            if layer % 2:
                shift += 1
                for q in range(layer % 4, c.num_qubits, 4):
                    out.add("Measure", [q], [], col + shift)
            layer += 1
    return out


def dense_ham(n: int, terms) -> np.ndarray:
    h = np.zeros((1 << n, 1 << n), complex)
    for coeff, pstr, qubits in terms:
        full = ["I"] * n
        for p, q in zip(pstr, qubits):
            full[q] = p
        h += coeff * tlind._pauli_term_matrix("".join(full))
    return h


def tfim_exact_open(n: int, j: float, h: float) -> float:
    """Open TFIM ground energy by Jordan-Wigner free fermions."""
    m = np.diag(np.full(n, -h)) + np.diag(np.full(n - 1, -j), 1)
    return -float(np.sum(np.linalg.svd(m, compute_uv=False)))


def z_profile(state) -> np.ndarray:
    return np.array([tmps.expectation_pauli_string(state, {q: "Z"})
                     for q in range(state.num_qubits)])


def phase_mps_ideal(path: dict, report: dict, card: str) -> None:
    """11a: exactness against Simulator, the bench cell, the width case."""
    n, depth, chi = MPS_EXACT
    c = brickwork(n, depth, SEED, True)
    _, st = tmps.MPSSimulator(chi, device="cuda").run(c, shots=0)
    before = launch_counts()
    psi = Simulator(device="cuda").run(c, shots=0).final_state.device_data
    add_launches(path, before)
    err = float(np.abs(tmps.to_statevector(st) - psi.cpu().numpy()).max())
    check(err <= MPS_SV_TOL and st.truncation_weight == 0.0,
          f"MPS n={n} chi={chi}: state vs Simulator {err}, truncation "
          f"{st.truncation_weight}")
    print(f"mps exact n={n} depth {depth} chi={chi} [{card}]: state vs "
          f"Simulator {err:.2e}, truncation {st.truncation_weight}",
          flush=True)

    n, depth, chi, shots = MPS_BENCH
    c = rx_brickwork(n, depth)
    sim = tmps.MPSSimulator(chi, device="cuda")
    sim.run(c, shots=shots, seed=0)
    (counts, st), wall, clock = clocked(lambda: sim.run(c, shots=shots,
                                                       seed=1))
    _, st_cpu = tmps.MPSSimulator(chi, device="cpu").run(c, shots=0)
    zerr = float(np.abs(z_profile(st) - z_profile(st_cpu)).max())
    check(zerr <= MPS_Z_TOL and sum(counts.values()) == shots,
          f"MPS bench cell: <Z_q> card vs CPU {zerr}, shots {counts}")
    gates = len(c.gates)
    report["mps_bench"] = {"ms": 1e3 * wall, "gates_per_s": gates / wall,
                           "truncation": st.truncation_weight,
                           "z_err": zerr, "linalg": clock.seconds,
                           "linalg_calls": clock.calls}
    print(f"mps bench n={n} depth-{depth} chi={chi} {shots} shots "
          f"[{card}]: {1e3 * wall:.1f} ms/run, {gates / wall:.0f} gates/s, "
          f"truncation {st.truncation_weight:.3e}, <Z_q> card vs CPU "
          f"{zerr:.2e}; instrumented {clock.wall:.3f} s: "
          f"{clock.share(clock.wall)}", flush=True)

    n, depth, chi, shots = MPS_WIDE
    c = rx_brickwork(n, depth)
    sim = tmps.MPSSimulator(chi, device="cuda")
    for basis in ("Z", "X"):
        sim.run(c, shots=shots, seed=0, basis=basis)
        (counts, st), wall, clock = clocked(lambda: sim.run(
            c, shots=shots, seed=1, basis=basis))
        check(sum(counts.values()) == shots
              and all(len(k) == n for k in counts),
              f"MPS n={n} basis {basis}: counts")
        report[f"mps_wide_{basis}"] = {"ms": 1e3 * wall,
                                       "truncation": st.truncation_weight,
                                       "linalg": clock.seconds}
        print(f"mps width n={n} depth-{depth} chi={chi} {shots} shots "
              f"{basis} basis [{card}]: {1e3 * wall:.1f} ms/run, "
              f"{len(c.gates) / wall:.0f} gates/s, truncation "
              f"{st.truncation_weight:.3e}, max bond "
              f"{max(t.shape[2] for t in st.tensors)}; instrumented "
              f"{clock.wall:.3f} s: {clock.share(clock.wall)}", flush=True)


def phase_mps_noisy(report: dict, card: str) -> None:
    """11b: noisy shots/s at chi 16 and 64, the law, monitored."""
    B, chis = MPS_SVD_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for chi in chis:
        m = torch.randn((B, 2 * chi, 2 * chi), dtype=torch.complex64,
                        device="cuda", generator=gen)
        ref = torch.linalg.svdvals(m[:8].cpu().to(torch.complex128))
        row = {}
        for driver in (None, "gesvdj", "gesvda"):
            f = lambda: torch.linalg.svd(m, full_matrices=False,
                                         driver=driver)
            f()
            (u, s, vh), t = timed(f)
            recon = (u[:8] * s[:8, None, :].to(u.dtype)) @ vh[:8]
            err_s = float((s[:8].cpu().double() - ref).abs().max())
            err_r = float((recon - m[:8]).abs().max())
            row[str(driver)] = {"ms": 1e3 * t, "s_err": err_s,
                                "recon_err": err_r}
            print(f"mps batched SVD {B} x ({2 * chi}, {2 * chi}) complex64 "
                  f"driver {driver} [{card}]: {1e3 * t:.2f} ms, singular "
                  f"values vs float64 {err_s:.2e}, reconstruction "
                  f"{err_r:.2e}", flush=True)
            del u, s, vh, recon
        report[f"svd_batch_{chi}"] = row
        del m

    for label, (n, depth, chis, shots, p) in (("bench", MPS_NOISY),
                                              ("deep", MPS_DEEP)):
        c = (rx_brickwork(n, depth) if label == "bench"
             else brickwork(n, 2 * depth, SEED, True))
        channels = [DepolarizingNoise(p)]
        if label == "bench":
            channels.append(AmplitudeDampingNoise(p))
        for ch in channels:
            nm = NoiseModel()
            nm.add_global_noise(ch)
            for chi in chis:
                sim = tmps.MPSSimulator(chi, device="cuda")
                sim.run_with_noise(c, nm, shots=min(shots, 64), seed=0)
                (counts, disc), wall, clock = clocked(
                    lambda: sim.run_with_noise(c, nm, shots=shots, seed=1))
                check(sum(counts.values()) == shots and np.isfinite(disc),
                      f"MPS noisy {label} {type(ch).__name__} chi={chi}")
                key = f"mps_noisy_{label}_{type(ch).__name__}_{chi}"
                report[key] = {"shots_per_s": shots / wall,
                               "truncation": disc,
                               "linalg": clock.seconds}
                print(f"mps run_with_noise {label} n={n} depth-{depth} "
                      f"{type(ch).__name__}({p}) chi={chi} {shots} shots "
                      f"[{card}]: {shots / wall:.1f} shots/s ({wall:.3f} "
                      f"s), mean truncation {disc:.3e}; instrumented "
                      f"{clock.wall:.3f} s: {clock.share(clock.wall)}",
                      flush=True)

    n, chi, shots, bound = MPS_LAW
    c = QuantumCircuit(n)
    for q in range(n):
        c.add("H", [q], [], 0)
    c.add("CNOT", [0, 2], [], 1)
    c.add("Rx", [1], [0.8], 2)
    c.add("CZ", [2, 3], [], 3)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.08))
    nm.add_global_noise(AmplitudeDampingNoise(0.1))
    counts, disc = tmps.MPSSimulator(chi, device="cuda").run_with_noise(
        c, nm, shots=shots, seed=9)
    probs = DensityMatrixSimulator(nm, device="cuda").run(
        c, method="dense").probabilities
    tvd = tvd_counts(counts, probs, n)
    check(tvd < bound and disc < 1e-6, f"MPS noisy law n={n}: TVD {tvd}, "
          f"truncation {disc}")
    print(f"mps noisy law n={n} [{card}]: TVD {tvd:.4f} against the "
          f"density matrix ({shots} shots)", flush=True)

    n, depth, chi, T = MPS_MONITORED
    c = with_measures(rx_brickwork(n, depth))
    sim = tmps.MPSSimulator(chi, device="cuda")
    sim.monitored_trajectories(c, 4, seed=0)
    (outs, sites, states), wall = timed(
        lambda: sim.monitored_trajectories(c, T, seed=1))
    check(outs.shape == (T, len(sites)) and set(np.unique(outs)) <= {0, 1},
          f"MPS monitored n={n}: outcomes {outs.shape}")
    branches = tmps.draw_branches(c, None, True)
    g = tmps.draw_gumbels(8, branches, torch.Generator().manual_seed(SEED),
                          "cpu")
    o_card, _, _ = sim.monitored_trajectories(c, 8, gumbels=g)
    o_cpu, _, _ = tmps.MPSSimulator(chi, device="cpu").monitored_trajectories(
        c, 8, gumbels=g)
    check(np.array_equal(o_card, o_cpu), "MPS monitored: card and CPU "
          "outcomes differ on the same draws")
    report["mps_monitored"] = {"traj_per_s": T / wall, "measures":
                               len(sites)}
    print(f"mps monitored n={n} depth-{depth} chi={chi} T={T} "
          f"({len(sites)} measurements) [{card}]: {T / wall:.1f} "
          f"trajectories/s ({wall:.3f} s); 8 trajectories card == CPU on "
          f"the same draws", flush=True)


def phase_mps_variational(path: dict, report: dict, card: str) -> None:
    """11c: a 2P-row gradient at n = 50, and the exact n = 10 gradient
    against the statevector one."""
    n, layers, chi = VQE_MPS
    cfg = topt.MPSParameterizedConfig.auto_detect(
        models.hardware_efficient_ansatz(n, layers), chi=chi)
    cost = topt.CostFunction.vqe_hamiltonian(models.tfim_chain(n))
    v = np.random.default_rng(SEED).uniform(-np.pi, np.pi, cfg.num_params)
    topt.GradientEstimator.parameter_shift(cfg, cost, v, device="cuda")
    g, wall, clock = clocked(lambda: topt.GradientEstimator.parameter_shift(
        cfg, cost, v, device="cuda"))
    check(np.isfinite(g).all(), "MPS gradient n=50 not finite")
    rows = 2 * cfg.num_params
    report["mps_gradient"] = {"ms": 1e3 * wall, "rows_per_s": rows / wall,
                              "linalg": clock.seconds}
    print(f"mps gradient hardware_efficient_ansatz({n}, {layers}) on "
          f"tfim_chain({n}) chi={chi}, {rows} rows [{card}]: "
          f"{1e3 * wall:.1f} ms, {rows / wall:.0f} rows/s; instrumented "
          f"{clock.wall:.3f} s: {clock.share(clock.wall)}", flush=True)

    n, layers, chi = VQE_MPS_EXACT
    c = models.hardware_efficient_ansatz(n, layers)
    cost = topt.CostFunction.vqe_hamiltonian(models.tfim_chain(n))
    mcfg = topt.MPSParameterizedConfig.auto_detect(c, chi=chi)
    scfg = topt.ParameterizedCircuitConfig.auto_detect(c)
    v = np.random.default_rng(SEED + 1).uniform(-np.pi, np.pi,
                                                mcfg.num_params)
    g_mps = topt.GradientEstimator.parameter_shift(mcfg, cost, v,
                                                   device="cuda")
    before = launch_counts()
    g_sv = topt.GradientEstimator.parameter_shift(scfg, cost, v,
                                                  device="cuda")
    add_launches(path, before)
    err = float(np.abs(g_mps - g_sv).max())
    check(err <= MPS_GRAD_TOL, f"MPS gradient n={n}: vs statevector {err}")
    print(f"mps gradient n={n} chi={chi} (exact) [{card}]: vs the "
          f"statevector gradient {err:.2e}", flush=True)


def phase_mps_shadows(report: dict, card: str) -> None:
    """11d: GHZ-40 shadows on the MPS engine."""
    from quantum_simulator_tpu_torch import shadows as tsh

    n, S, chi, chunk = SHADOW_MPS
    c = ghz(n)
    tsh.collect_shadows(c, chunk, seed=3, engine="mps", chi=chi,
                        chunk=chunk, device="cuda")
    data, wall = timed(lambda: tsh.collect_shadows(
        c, S, seed=4, engine="mps", chi=chi, chunk=chunk, device="cuda"))
    zz = np.array([data.estimate_pauli("ZZ", [q, q + 1])
                   for q in range(n - 1)])
    # GHZ: wherever two neighbours were both read in Z they agree.
    both_z = (data.bases[:, :-1] == 2) & (data.bases[:, 1:] == 2)
    agree = data.outcomes[:, :-1] == data.outcomes[:, 1:]
    check(bool(agree[both_z].all()), "MPS shadows: GHZ Z outcomes differ")
    se = np.sqrt(8.0 / S)        # one ZZ estimate's standard error
    check(abs(zz.mean() - 1.0) <= SHADOW_MEAN_TOL
          and np.abs(zz - 1.0).max() <= 5 * se,
          f"MPS shadows GHZ-{n}: ZZ estimates {zz}")
    report["mps_shadows"] = {"snapshots_per_s": S / wall,
                             "zz_mean": float(zz.mean()),
                             "zz_max_dev": float(np.abs(zz - 1).max())}
    print(f"mps shadows GHZ-{n} chi={chi} {S} snapshots chunk {chunk} "
          f"[{card}]: {S / wall:.0f} snapshots/s ({wall:.3f} s); NN ZZ "
          f"mean {zz.mean():.4f}, max |ZZ - 1| {np.abs(zz - 1).max():.4f} "
          f"(5 standard errors {5 * se:.3f}); {int(both_z.sum())} Z-Z "
          f"neighbour reads all agree", flush=True)


def phase_dmrg(report: dict, card: str) -> None:
    """11e: the bench DMRG cell, and excited states against eigvalsh."""
    n, j, h, chi, sweeps, k = DMRG_BENCH
    terms = models.tfim_chain(n, j=j, h=h)
    run = lambda: tdmrg.dmrg_ground_state(terms, n, chi=chi, sweeps=sweeps,
                                          lanczos_k=k, device="cuda")
    run()
    res, wall, clock = clocked(run)
    exact = tfim_exact_open(n, j, h)
    rel = abs(res.energy - exact) / abs(exact)
    check(rel < DMRG_REL_TOL, f"DMRG n={n}: rel err {rel}")
    report["dmrg_bench"] = {"s": wall, "rel_err": rel,
                            "linalg": clock.seconds,
                            "linalg_calls": clock.calls}
    print(f"dmrg TFIM n={n} chi={chi} {sweeps} sweeps k={k} [{card}]: "
          f"{wall:.3f} s warm, E {res.energy:.6f} vs free fermions "
          f"{exact:.6f} (rel err {rel:.2e}), truncation "
          f"{res.truncation_weight:.2e}; instrumented {clock.wall:.3f} s: "
          f"{clock.share(clock.wall)}", flush=True)

    n, states, chi, sweeps, tol = DMRG_EXCITED
    terms = models.tfim_chain(n, j=-1.0, h=-0.9)
    (res, wall) = timed(lambda: tdmrg.dmrg_excited_states(
        terms, n, n_states=states, chi=chi, sweeps=sweeps, device="cuda"))
    want = np.linalg.eigvalsh(dense_ham(n, terms))[:states]
    err = float(np.abs(np.array([r.energy for r in res]) - want).max())
    check(err <= tol, f"DMRG excited n={n}: {err}")
    print(f"dmrg excited n={n} {states} states chi={chi} [{card}]: "
          f"{wall:.3f} s, max |E - eigvalsh| {err:.2e}", flush=True)


def phase_mps_dynamics(report: dict, card: str) -> None:
    """11f: MPS Lindblad trajectories; 11g: correlators."""
    n, chi, steps, T = LINDBLAD_MPS
    H = ([(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
         + [(0.5, "X", [i]) for i in range(n)])
    jumps = [(0.1, "sigma_minus", q) for q in range(n)]
    sim = tlmps.MPSLindbladSimulator(n, H, jumps, chi=chi, device="cuda")
    sim.evolve(1.0, 4, n_trajectories=2, observables=[("Z", [n // 2])])
    res, wall = timed(lambda: sim.evolve(
        1.0, steps, n_trajectories=T, observables=[("Z", [n // 2])]))
    check(np.isfinite(res.expectations).all()
          and np.abs(res.expectations).max() <= 1 + 1e-5,
          f"MPS Lindblad n={n}: {res.expectations}")
    report["lindblad_mps"] = {"s": wall, "traj_per_s": T / wall}
    print(f"mps lindblad n={n} chi={chi} {steps} steps T={T} [{card}]: "
          f"{wall:.3f} s, {T / wall:.2f} trajectories/s, <Z_{n // 2}>(t=1) "
          f"{res.expectations[0, -1]:+.4f} +- {res.stderr[0, -1]:.4f}, "
          f"truncation {res.truncation_weight:.2e}", flush=True)

    H3 = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2]),
          (0.7, "X", [0]), (0.7, "X", [1]), (0.7, "X", [2])]
    J3 = [(0.3, "sigma_minus", 0), (0.2, "z", 2)]
    obs = [("Z", [0]), ("X", [1]), ("ZZ", [0, 1])]
    dense = LindbladSimulator(3, H3, J3, device="cuda").evolve(
        1.0, 100, observables=obs, record_every=25)
    traj = tlmps.MPSLindbladSimulator(3, H3, J3, chi=8, device="cuda"
                                      ).evolve(1.0, 100, n_trajectories=300,
                                               initial=[0, 0, 0],
                                               observables=obs,
                                               record_every=25, seed=2)
    dev = np.abs(dense.expectations - traj.expectations)
    lim = 4.0 * np.maximum(traj.stderr, 1e-6) + 0.025
    check(bool((dev <= lim).all()), f"MPS Lindblad n=3 vs dense: {dev}")
    print(f"mps lindblad n=3 vs dense RK4 [{card}]: max dev "
          f"{dev.max():.4f} (bound 4 stderr + 0.025)", flush=True)

    n, chi, t, steps = CORR_WIDE
    terms = models.tfim_chain(n, j=-1.0, h=-1.0)
    run = lambda: tcorr.mps_two_point_correlator(
        n, terms, t, steps, n // 2, n // 2, chi=chi, record_every=steps // 4,
        device="cuda")
    run()
    (times, C), wall = timed(run)
    check(np.isfinite(C).all() and np.abs(C).max() <= 1 + 1e-4,
          f"correlator n={n}: {C}")
    report["correlator"] = {"s": wall}
    print(f"mps correlator TFIM quench n={n} chi={chi} t={t} {steps} "
          f"steps [{card}]: {wall:.3f} s, |C(t)| "
          f"{np.round(np.abs(C), 4).tolist()}", flush=True)

    n, chi, t, steps, tol = CORR_DENSE
    terms = ([(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
             + [(0.7, "X", [i]) for i in range(n)])
    times, C = tcorr.mps_two_point_correlator(
        n, terms, t, steps, 1, 2, pauli_i="Z", pauli_j="Y", chi=chi,
        record_every=steps // 4, device="cuda")
    w, v = np.linalg.eigh(dense_ham(n, terms))
    psi0 = np.zeros(1 << n, complex)
    psi0[0] = 1.0
    Pi = dense_ham(n, [(1.0, "Z", [1])])
    Pj = dense_ham(n, [(1.0, "Y", [2])])
    err = 0.0
    for k_, tk in enumerate(times):
        U = (v * np.exp(-1j * w * tk)) @ v.conj().T
        exact = (U @ psi0).conj() @ Pi @ (U @ (Pj @ psi0))
        err = max(err, abs(C[k_] - exact))
    check(err <= tol, f"correlator n={n} vs dense: {err}")
    print(f"mps correlator n={n} vs dense expm [{card}]: max err "
          f"{err:.2e} (bound {tol})", flush=True)


def phase_mps(report: dict, card: str) -> dict:
    """11a-11g. The MPS family launches no kernel of its own; its launch
    counts are those of the statevector references (11a, 11c)."""
    path = {k: 0 for k in launch_counts()}
    phase_mps_ideal(path, report, card)
    phase_mps_noisy(report, card)
    phase_mps_variational(path, report, card)
    phase_mps_shadows(report, card)
    phase_dmrg(report, card)
    phase_mps_dynamics(report, card)
    report["mps_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 12: the parallel layer (a shard mesh on the card)
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
MESH_BRICK = (30, 8)                  # 12a: Ry/Rz brickwork (n, depth)
MESH_ANSATZ = 4                       # 12a: hardware_efficient_ansatz layers
MESH_GROUPED_TOL = 2e-5               # tests/test_multihost.py:78
MESH_PEAK_RATIO = 1.75
MESH_QFT_N = 32                       # scripts/mesh_stretch_check.py
MESH_SHOTS = 1000                     # scripts/mesh_stretch_check.py:51
MESH_QFT_Z_TOL = 1e-4
MESH_STRETCH = (32, 40, 4)            # 12c: Ry+CNOT (n, depth, segment cols)
MESH_NOISY = (24, 8, 0.05, 16, 1024)  # 12d: (n, depth, p, trajectories, shots)
MESH_NOISY_SMALL = 10
MESH_NOISY_MARGIN = 1e-4              # draws nearer a tie may part
MESH_VQE = (20, 4)                    # 12e: hardware_efficient_ansatz
MESH_VQE_STEPS = 3
MESH_VQE_TOL = 1e-4
MESH_CKPT = (26, 8, 2, 1)             # 12f: (n, depth, segment cols, stop)
MESH_CIRCUIT = (5, 5)                 # 12g: surface (d, R), bench cell
MESH_LINDBLAD = (8, 16, 10, 16)       # 12g: (n, chi, steps, trajectories)


class ExchangeClock:
    """Counts the mesh exchanges (``distributed._swap_global_local``)
    while in use and, with ``timed``, times each between synchronizes."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.calls = 0
        self.s = 0.0

    def __enter__(self):
        self._orig = tdist._swap_global_local

        def wrapped(*args):
            if self.timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._orig(*args)
            if self.timed:
                torch.cuda.synchronize()
                self.s += time.perf_counter() - t0
            self.calls += 1

        tdist._swap_global_local = wrapped
        return self

    def __exit__(self, *exc):
        tdist._swap_global_local = self._orig


def mesh_vs_single(stack: torch.Tensor, single: torch.Tensor,
                   planar: bool) -> float:
    """max |mesh - single| of an ``(L, 2, N)`` shard stack and the
    one-device planar ``(2, *axes)`` or real ``(*axes,)`` state (an
    all-real evolution: the mesh's imaginary plane must be 0), shard by
    shard."""
    L = stack.shape[0]
    if planar:
        flat = single.reshape(2, L, -1)
        return max(grouped_max_diff(stack[l], flat[:, l]) for l in range(L))
    flat = single.reshape(L, -1)
    return max(max(grouped_max_diff(stack[l, 0], flat[l]),
                   float(stack[l, 1].abs().max())) for l in range(L))


def mesh_run(label: str, fn, size: int, path: dict, clock: ExchangeClock):
    """``fn()`` on a fresh peak counter, launch counts from zero; returns
    (result, wall s, launches, peak bytes above what was allocated)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    with clock:
        out, wall = timed(fn)
    delta = add_launches(path, NO_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= MESH_PEAK_RATIO * size, f"{label}: peak "
          f"{peak / 2**30:.3f} GiB > {MESH_PEAK_RATIO} x the state's "
          f"{size / 2**30:.0f} GiB")
    return out, wall, delta, peak


def mesh_plan_launches(body) -> dict:
    """Dense and cross steps of a shard body's mini plans: one launch
    each for all the shards."""
    counts = [step_counts(seg[1]) for seg in body.segments
              if seg[0] == "run"]
    return {"dense_axis": sum(c[0] for c in counts),
            "cross_bit_axis": sum(c[1] for c in counts)}


def random_ansatz(n: int, layers: int) -> QuantumCircuit:
    """``hardware_efficient_ansatz(n, layers)`` at seeded random angles."""
    d = models.hardware_efficient_ansatz(n, layers).to_dict()
    rng = np.random.default_rng(SEED)
    for gd in d["gates"]:
        gd["params"] = [float(rng.uniform(-np.pi, np.pi))
                        for _ in gd.get("params", [])]
    return QuantumCircuit.from_dict(d)


def mesh_against_single(c: QuantumCircuit, label: str, path: dict) -> dict:
    """One grouped mesh run of ``c`` over 8 shards against one device
    and against the same body through the twins; its exchanges equal the
    schedule's and its launches the mini plans' dense and cross steps."""
    n = c.num_qubits
    mesh = tpar.make_mesh(MESH_SHARDS, device="cuda")
    sim = tpar.DistributedSimulator(mesh)
    program = tprog.compile_circuit(c)
    body = tdist._ShardBody(program, mesh)
    check(body.grouped, f"{label}: not the grouped route")
    size = state_bytes(n, True)
    torch.cuda.empty_cache()
    fs = Simulator(device="cuda").run(c, shots=0).final_state
    planar = not isinstance(fs, PlanarStateVector) or fs.is_planar
    single = (fs.state_data if isinstance(fs, PlanarStateVector) else
              torch.stack([fs.device_data.real, fs.device_data.imag]))
    del fs
    clock = ExchangeClock()
    st, wall, delta, peak = mesh_run(label, lambda: sim.run(c), size, path,
                                     clock)
    err = mesh_vs_single(st.device_data, single, planar)
    del single
    check(err <= MESH_GROUPED_TOL, f"{label} vs Simulator.run: {err}")
    check(clock.calls == body.swaps, f"{label}: {clock.calls} exchanges, "
          f"the schedule has {body.swaps}")
    want = mesh_plan_launches(body)
    check(delta == want, f"{label}: launches {delta}, the mini plans have "
          f"{want}")
    torch.cuda.empty_cache()
    before = launch_counts()
    twin = body.forward(program.initial_params, plain=True)
    check(launch_counts() == before, "mesh twins launched a kernel")
    twin_err = max(grouped_max_diff(st.device_data[l], twin[l])
                   for l in range(MESH_SHARDS))
    del twin, st
    check(twin_err <= STATE_TOL, f"{label} kernels vs twins: {twin_err}")
    return {"n": n, "shards": MESH_SHARDS, "run_s": wall, "launches": delta,
            "exchanges": clock.calls, "peak_bytes": peak,
            "state_bytes": size, "err_vs_single": err,
            "err_vs_twins": twin_err}


def phase_mesh_brickwork(path: dict, report: dict, card: str) -> None:
    """12a: n = 30 over 8 shards (27 local qubits: mini plans, one launch
    per step for all shards) against one device and the twins: the Ry/Rz
    brickwork, whose plans have only dense steps (the exchange before a
    cross-axis CNOT closes the run, so the planner emits a K = 4 bit
    pair), and ``hardware_efficient_ansatz(30, 4)``, whose CNOT chains
    fold into cross steps. Both kernels must launch."""
    n, depth = MESH_BRICK
    cases = [("brickwork", f"Ry/Rz brickwork depth {depth}",
              brickwork(n, depth, SEED, mix_rz=True)),
             ("ansatz", f"hardware_efficient_ansatz({n}, {MESH_ANSATZ})",
              random_ansatz(n, MESH_ANSATZ))]
    rec = {}
    for key, name, c in cases:
        r = mesh_against_single(c, f"mesh n={n} {key}", path)
        rec[key] = r
        print(f"mesh 12a {name} n={n} over {MESH_SHARDS} shards [{card}]: "
              f"run {r['run_s']:.3f} s, launches dense "
              f"{r['launches']['dense_axis']} cross "
              f"{r['launches']['cross_bit_axis']}, {r['exchanges']} "
              f"exchanges (= schedule), peak {r['peak_bytes'] / 2**30:.3f} "
              f"GiB ({r['peak_bytes'] / r['state_bytes']:.3f} x), vs "
              f"Simulator.run {r['err_vs_single']:.2e}, vs twins "
              f"{r['err_vs_twins']:.2e}", flush=True)
    for k in ("dense_axis", "cross_bit_axis"):
        total = sum(r["launches"][k] for r in rec.values())
        check(total > 0, f"mesh 12a: no {k} launch")
    report["mesh_brickwork"] = {"depth": depth, **rec["brickwork"]}
    report["mesh_ansatz"] = {"layers": MESH_ANSATZ, **rec["ansatz"]}


def phase_mesh_qft(path: dict, report: dict, card: str) -> None:
    """12b: QFT-32 on a basis input over 8 shards (a 32 GiB state)."""
    n = MESH_QFT_N
    b = int(np.random.default_rng(SEED).integers(0, 1 << n))
    c = qft(n)
    c.initial_states = [(b >> (n - 1 - q)) & 1 for q in range(n)]
    no_cphase = QuantumCircuit.from_dict({**c.to_dict(), "gates": [
        gd for gd in c.to_dict()["gates"] if gd["name"] != "CPhase"]})
    mesh = tpar.make_mesh(MESH_SHARDS, device="cuda")
    sim = tpar.DistributedSimulator(mesh)
    g = MESH_SHARDS.bit_length() - 1
    kinds: dict = {}
    body = tdist._ShardBody(tprog.compile_circuit(c), mesh)
    for it in body.schedule:
        kinds[it[0]] = kinds.get(it[0], 0) + 1
    bare = tdist._ShardBody(tprog.compile_circuit(no_cphase), mesh).swaps
    check(kinds.get("cphase", 0) > 0 and kinds.get("swap", 0) == bare
          and bare <= 4 * g, f"QFT-{n} schedule {kinds}: CPhases must "
          f"schedule no exchange ({bare} without them, bound {4 * g})")
    size = state_bytes(n, True)
    clock = ExchangeClock()
    st, wall, delta, peak = mesh_run(f"QFT-{n}", lambda: sim.run(c), size,
                                     path, clock)
    want = mesh_plan_launches(body)
    check(delta == want, f"QFT-{n}: launches {delta}, plans {want}")
    ov = mesh_stretch_check.dft_overlap(st.device_data, mesh, b, n)
    norm = st.norm()
    fid = abs(ov) ** 2 / max(norm, 1e-30)
    check(fid > 1 - 1e-4, f"QFT-{n} fidelity vs the DFT row: {fid}")
    rho = sim.qubit_density_matrices(st)
    zs = (rho[:, 0, 0] - rho[:, 1, 1]).real
    check(float(np.abs(zs).max()) <= MESH_QFT_Z_TOL,
          f"QFT-{n} <Z>: {zs}")
    counts = sim.sample(st, MESH_SHOTS, np.random.default_rng(SEED))
    check(sum(counts.values()) == MESH_SHOTS
          and all(len(k) == n for k in counts), f"QFT-{n} shots")
    del st
    report["mesh_qft"] = {"n": n, "b": b, "run_s": wall, "fidelity": fid,
                          "max_abs_z": float(np.abs(zs).max()),
                          "schedule": kinds, "launches": delta,
                          "exchanges": clock.calls, "peak_bytes": peak,
                          "state_bytes": size}
    print(f"mesh 12b QFT-{n} over {MESH_SHARDS} shards [{card}]: run "
          f"{wall:.3f} s, fidelity vs the DFT row {fid:.7f}, max |<Z>| "
          f"{np.abs(zs).max():.2e}, schedule {kinds}, launches dense "
          f"{delta['dense_axis']} cross {delta['cross_bit_axis']}, peak "
          f"{peak / 2**30:.3f} GiB ({peak / size:.3f} x), "
          f"{len(counts)} strings of {MESH_SHOTS} shots", flush=True)


def phase_mesh_stretch(path: dict, report: dict, card: str) -> None:
    """12c: n = 32 Ry+CNOT brickwork depth 40 through ``run_segmented``
    (the JAX package's mesh stretch configuration)."""
    n, depth, cols = MESH_STRETCH
    c = brickwork(n, depth, SEED, mix_rz=False)
    sim = tpar.DistributedSimulator(
        tpar.make_mesh(MESH_SHARDS, device="cuda"))
    size = state_bytes(n, True)
    segs: list = []
    clock = ExchangeClock(timed=True)
    st, wall, delta, peak = mesh_run(
        f"stretch n={n}", lambda: sim.run_segmented(
            c, cols, progress=lambda i, ns, w: segs.append(w)), size, path,
        clock)
    norm = st.norm()
    check(abs(norm - 1.0) <= 1e-4, f"stretch n={n}: |psi|^2 = {norm}")
    zs = [sim.expectation_z(st, q) for q in (0, n // 2, n - 1)]
    check(all(np.isfinite(z) and abs(z) <= 1 + 1e-4 for z in zs),
          f"stretch n={n} <Z> probes {zs}")
    c1 = sim.sample(st, MESH_SHOTS, np.random.default_rng(7))
    c2 = sim.sample(st, MESH_SHOTS, np.random.default_rng(7))
    check(c1 == c2 and sum(c1.values()) == MESH_SHOTS,
          f"stretch n={n}: seeded sampling")
    del st
    share = clock.s / wall
    report["mesh_stretch"] = {
        "n": n, "depth": depth, "segment_columns": cols, "wall_s": wall,
        "segments": len(segs), "segment_s": segs, "exchanges": clock.calls,
        "exchange_s": clock.s, "exchange_share": share, "launches": delta,
        "peak_bytes": peak, "state_bytes": size, "norm": norm,
        "z_probes": zs}
    print(f"mesh 12c brickwork n={n} depth {depth} Ry+CNOT, "
          f"run_segmented({cols}) over {MESH_SHARDS} shards [{card}]: "
          f"{wall:.3f} s ({len(segs)} segments), {clock.calls} exchanges "
          f"{clock.s:.3f} s = {100 * share:.1f} % (synchronized), launches "
          f"dense {delta['dense_axis']} cross {delta['cross_bit_axis']}, "
          f"peak {peak / 2**30:.3f} GiB ({peak / size:.3f} x), |psi|^2 "
          f"{norm:.6f}, <Z> probes {np.round(zs, 4).tolist()}", flush=True)


def phase_mesh_noisy(report: dict, card: str) -> None:
    """12d: ``run_with_noise`` over 8 shards at n = 24 (trajectories/s),
    and at n = 10 the card's trajectories equal the CPU's on the same
    Gumbel rows."""
    n, depth, p, T, shots = MESH_NOISY
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(p))
    sim = tpar.DistributedSimulator(
        tpar.make_mesh(MESH_SHARDS, device="cuda"))
    c = brickwork(n, depth, SEED, mix_rz=False)
    sim.run_with_noise(brickwork(MESH_NOISY_SMALL, 2, SEED, False), nm, 8,
                       trajectories=2, seed=SEED)
    counts, wall = timed(lambda: sim.run_with_noise(
        c, nm, shots, trajectories=T, seed=SEED))
    check(sum(counts.values()) == shots, f"mesh noisy n={n}: shots")
    small = brickwork(MESH_NOISY_SMALL, depth, SEED, mix_rz=True)
    prog_s = tprog.compile_circuit(small)
    draws, width = tdist.noisy_draw_shape(prog_s, nm)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    g = tdist.draw_gumbels((T, draws, width), gen, "cpu")
    rec: list = []
    want = tdist.sharded_trajectory_fn(
        prog_s, nm, tpar.make_mesh(MESH_SHARDS, device="cpu"))(
            prog_s.initial_params, g, rec)
    got = tdist.sharded_trajectory_fn(
        prog_s, nm, tpar.make_mesh(MESH_SHARDS, device="cuda"))(
            prog_s.initial_params, g.cuda()).cpu()
    margins = torch.stack([m for _, m in rec], 1).min(1).values
    clear = margins > MESH_NOISY_MARGIN
    err = float((got - want).abs().amax((1, 2, 3))[clear].max())
    check(int(clear.sum()) >= T // 2 and err <= STATE_TOL,
          f"mesh noisy n={MESH_NOISY_SMALL}: card vs CPU {err} over "
          f"{int(clear.sum())} trajectories")
    report["mesh_noisy"] = {"n": n, "depth": depth, "p": p,
                            "trajectories": T, "shots": shots, "s": wall,
                            "traj_per_s": T / wall, "small_err": err,
                            "small_compared": int(clear.sum())}
    print(f"mesh 12d run_with_noise n={n} depth {depth} depol {p} over "
          f"{MESH_SHARDS} shards, T={T}, {shots} shots [{card}]: "
          f"{wall:.3f} s, {T / wall:.2f} trajectories/s; n="
          f"{MESH_NOISY_SMALL} card vs CPU on the same draws {err:.2e} "
          f"({int(clear.sum())} of {T} clear of ties)", flush=True)


def phase_mesh_vqe(path: dict, report: dict, card: str) -> None:
    """12e: the sharded VQE step (traj 2 x amp 4) on
    ``hardware_efficient_ansatz(20, 4)`` with a ZZ chain: cost and
    gradient against the one-device parameter-shift rows."""
    n, layers = MESH_VQE
    c = random_ansatz(n, layers)
    ham = [(1.0, [i, i + 1]) for i in range(n - 1)]
    mesh = tpar.make_vqe_mesh(MESH_SHARDS, device="cuda")
    check(mesh.shape["traj"] == 2 and mesh.shape["amp"] == 4,
          f"vqe mesh {mesh.shape}")
    step = tpar.sharded_vqe_step(c, mesh, observable=ham)
    before = launch_counts()
    (state, cost), first_s = timed(lambda: step.step(step.init))
    add_launches(path, before)
    grad = (state.m / 0.1).cpu().numpy()           # Adam's m after step 1
    program = tprog.compile_circuit(c)
    P = program.num_params
    v = torch.as_tensor(program.initial_params, dtype=torch.float32,
                        device="cuda")
    eye = torch.eye(P, device="cuda") * (np.pi / 2)
    rows = torch.cat([v[None], v[None] + eye, v[None] - eye])
    psi = tplan.group_batched_forward(program, rows, "cuda")
    probs = psi.real.square() + psi.imag.square()
    idx = torch.arange(1 << n, device="cuda")
    costs = torch.zeros(rows.shape[0], dtype=torch.float64, device="cuda")
    for coeff, qs in ham:
        sign = torch.ones(1 << n, device="cuda")
        for q in qs:
            sign = sign * (1 - 2 * ((idx >> (n - 1 - q)) & 1)).float()
        costs += coeff * (probs * sign).sum(1, dtype=torch.float64)
    del psi, probs
    want_grad = ((costs[1:1 + P] - costs[1 + P:]) / 2).cpu().numpy()
    cost_err = abs(float(cost) - float(costs[0]))
    grad_err = float(np.abs(grad - want_grad).max())
    check(cost_err <= MESH_VQE_TOL and grad_err <= MESH_VQE_TOL,
          f"mesh VQE: cost {cost_err}, gradient {grad_err}")
    before = launch_counts()
    st, costs_run, ms = state, [], []
    for _ in range(MESH_VQE_STEPS):
        (st, cst), s = timed(lambda st=st: step.step(st))
        costs_run.append(float(cst))
        ms.append(s * 1e3)
    add_launches(path, before)
    check(all(np.isfinite(costs_run)), f"mesh VQE costs {costs_run}")
    report["mesh_vqe"] = {"n": n, "layers": layers, "params": P,
                          "rows": 1 + 2 * P, "first_step_s": first_s,
                          "step_ms": ms, "costs": costs_run,
                          "cost_err": cost_err, "grad_err": grad_err}
    print(f"mesh 12e sharded VQE hardware_efficient_ansatz({n}, {layers}) "
          f"ZZ chain, traj 2 x amp 4 [{card}]: {1 + 2 * P} rows, cost "
          f"{float(cost):+.6f} (one-device {cost_err:.1e}), gradient "
          f"{grad_err:.1e}; {MESH_VQE_STEPS} Adam steps "
          f"{np.round(ms, 1).tolist()} ms", flush=True)


def phase_mesh_checkpoint(path: dict, report: dict, card: str) -> None:
    """12f: stop a checkpointed ``run_segmented`` after segment k from the
    progress callback, resume, and match an uninterrupted run."""
    import shutil
    from pathlib import Path

    n, depth, cols, stop = MESH_CKPT
    c = brickwork(n, depth, SEED, mix_rz=True)
    sim = tpar.DistributedSimulator(
        tpar.make_mesh(MESH_SHARDS, device="cuda"))
    root = Path(__file__).resolve().parent / "build" / "mesh_checkpoint"
    shutil.rmtree(root, ignore_errors=True)

    class Stop(Exception):
        pass

    def stopper(i, ns, w):
        if i == stop:
            raise Stop()

    before = launch_counts()
    whole = sim.run_segmented(c, cols)
    try:
        sim.run_segmented(c, cols, progress=stopper, checkpoint_dir=str(root))
        check(False, "checkpointed run did not stop")
    except Stop:
        pass
    done: list = []
    (res, wall) = timed(lambda: sim.run_segmented(
        c, cols, progress=lambda i, ns, w: done.append(i),
        checkpoint_dir=str(root)))
    add_launches(path, before)
    shutil.rmtree(root, ignore_errors=True)
    n_seg = -(-depth // cols)
    # the progress call of segment `stop` comes before its checkpoint
    # (as in the JAX package), so the resume reruns that segment
    check(done == list(range(stop, n_seg)),
          f"resume ran segments {done}, expected from {stop}")
    err = max(grouped_max_diff(whole.device_data[l], res.device_data[l])
              for l in range(MESH_SHARDS))
    check(err <= 1e-6, f"resumed vs uninterrupted: {err}")
    report["mesh_checkpoint"] = {"n": n, "segments": n_seg, "stopped_after":
                                 stop, "resumed": done, "resume_s": wall,
                                 "err": err}
    print(f"mesh 12f checkpoint n={n}, {n_seg} segments, stopped after "
          f"segment {stop} [{card}]: resumed segments {done} in {wall:.3f} "
          f"s, vs uninterrupted {err:.1e}", flush=True)


def phase_mesh_engines(report: dict, card: str) -> None:
    """12g: the ``mesh=`` engines identical to ``mesh=None`` on the same
    draws. On one rank ``ShardMesh.map_trials`` is the call itself, so
    the Steane sweep and the circuit-level memory check only that the
    mesh route reaches the same engine and repeats; the MPS Lindblad case
    alone takes another path (its Gumbel rows drawn up front). Splits
    over ranks are held by ``tests/test_torch_two_process.py``."""
    mesh = tpar.make_mesh(MESH_SHARDS, device="cuda")
    fr = tqf.FrameQECSimulator.from_code(tqec.SteaneCode(), "cuda")
    a = fr.sweep_raw(0.05, 4096, "depolarizing", seed=SEED)
    b = fr.sweep_raw(0.05, 4096, "depolarizing", seed=SEED, mesh=mesh)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "Steane sweep_raw with mesh=")
    d, rounds = MESH_CIRCUIT
    kw = dict(n_trials=CIRCUIT_TRIALS, seed=SEED, device="cuda")
    m0 = tqc.circuit_level_memory(d, rounds, CIRCUIT_P, **kw)
    m1 = tqc.circuit_level_memory(d, rounds, CIRCUIT_P, mesh=mesh, **kw)
    check(m0 == m1, f"circuit-level memory with mesh=: {m0} vs {m1}")
    n, chi, steps, T = MESH_LINDBLAD
    lsim = tlmps.MPSLindbladSimulator(
        n, [(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
        + [(0.7, "X", [i]) for i in range(n)],
        [(0.1, "sigma_minus", q) for q in range(n)], chi=chi, device="cuda")
    kw = dict(n_trajectories=T, observables=[("Z", [0]), ("Z", [n // 2])],
              seed=SEED)
    r0 = lsim.evolve(1.0, steps, **kw)
    r1 = lsim.evolve(1.0, steps, mesh=mesh, **kw)
    check(np.array_equal(r0.expectations, r1.expectations)
          and r0.truncation_weight == r1.truncation_weight,
          "lindblad_mps with mesh=")
    report["mesh_engines"] = {"steane_trials": 4096,
                              "circuit_memory": m1["logical_failure_probability"],
                              "lindblad_T": T}
    print(f"mesh 12g mesh= engines [{card}]: Steane sweep (4096 trials), "
          f"surface d={d} R={rounds} circuit-level memory ({CIRCUIT_TRIALS} "
          f"trials, "
          f"P_L {m1['logical_failure_probability']:.4f}), MPS Lindblad "
          f"n={n} T={T}: identical to mesh=None", flush=True)


def phase_mesh(report: dict, card: str) -> dict:
    """12a-12g. Launch counts: the mesh runs of 12a-12c, the VQE steps
    of 12e and the segmented runs of 12f, each read from zero."""
    path = {k: 0 for k in launch_counts()}
    phase_mesh_brickwork(path, report, card)
    phase_mesh_qft(path, report, card)
    phase_mesh_stretch(path, report, card)
    phase_mesh_noisy(report, card)
    phase_mesh_vqe(path, report, card)
    phase_mesh_checkpoint(path, report, card)
    phase_mesh_engines(report, card)
    torch.cuda.empty_cache()
    report["mesh_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 13: the front ends (bridge, controllers, view models)
# ---------------------------------------------------------------------------

FRONT_HEADLINE = (16, 40)            # Ry+CNOT brickwork, the headline
FRONT_HEADLINE_SHOTS = 4096
FRONT_WIDE = (28, 8)                 # Ry/Rz brickwork
FRONT_WIDE_SHOTS = 1024
FRONT_WINDOW = 1 << 16
FRONT_NOISY_SHOTS = 1024
FRONT_SWEEP = (20, 8, (0.0, 0.01, 0.05), 256)   # bench.py:221-226
FRONT_PURITY_MAX = 1 - 1e-3          # the sweep's purity at p = 0.05
FRONT_STEPS = (16, 8)                # run_step_by_step (n, depth)
FRONT_SWEEP_MODEL = (16, 8, (0.0, 0.01, 0.05), 64)
FRONT_DM = (8, 8, 1000)              # (n, depth, ensemble trials)
FRONT_DM_TOL = 2e-5                  # exact rho vs NumPy Kraus sums
FRONT_TIMEOUT = 600.0                # client socket timeout, s
FRONT_JOIN = 120.0


def bridge_amps(payload: dict) -> np.ndarray:
    return np.array([a["re"] + 1j * a["im"] for a in payload["amplitudes"]])


def batch_launches(program, nm, T: int) -> dict:
    """Dense and cross launches of T trajectories: the plans of one batch
    times the batches ``simulator._chunk_size`` cuts."""
    plans = noisy_plans(program, nm)
    batches = -(-T // tsim._chunk_size(program, nm, T))
    return {"dense_axis": batches * sum(isinstance(s, tplan.AxisMatmulStep)
                                        for p in plans for s in p.steps),
            "cross_bit_axis": batches * sum(isinstance(s, tplan.CrossStep)
                                            for p in plans for s in p.steps)}


class RoundTrips:
    """Host milliseconds of each bridge request, from the client's send to
    its parsed reply: the server copies its results to the host before it
    replies, so the device work is inside."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def __call__(self, label: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.ms[label] = (time.perf_counter() - t0) * 1e3
        return out


def front_headline(c, path: dict, trips: RoundTrips, report: dict) -> None:
    """13a, n = 16 run (launches = the plan's steps), the full state
    against the plain-twin executor, the analysis against direct calls."""
    n, depth = FRONT_HEADLINE
    circuit = brickwork(n, depth, SEED, False)
    program = tprog.compile_circuit(circuit)
    steps = plan_launches([program])
    info = c.set_circuit(circuit.to_dict())
    check(info == {"num_qubits": n, "gate_count": circuit.gate_count()},
          f"set_circuit n={n}: {info}")
    for label in (f"run n={n} (first)", f"run n={n}"):
        before = launch_counts()
        run = trips(label, lambda: c.run(shots=FRONT_HEADLINE_SHOTS,
                                         seed=SEED))
        delta = add_launches(path, before)
        check(delta == steps, f"bridge {label}: launches {delta}, plan "
              f"{steps}")
        check(sum(run["measurement_counts"].values()) == FRONT_HEADLINE_SHOTS
              and run["num_shots"] == FRONT_HEADLINE_SHOTS
              and run["seed"] == SEED, f"bridge {label}: {run['num_shots']}")
    state = trips(f"get_state n={n}", c.get_state)
    want = tplan.group_forward_body(program, program.initial_params, "cuda",
                                    plain=True)
    want_np = want.cpu().numpy().astype(np.complex128)
    err = float(np.abs(bridge_amps(state) - want_np).max())
    perr = float(np.abs(np.asarray(state["probabilities"])
                        - np.abs(want_np) ** 2).max())
    check(err <= STATE_TOL and perr <= STATE_TOL,
          f"bridge get_state n={n}: |amp - plain| {err}, |p - plain| {perr}")
    metrics = ["fidelity", "entropy", "purity", "pauli"]
    got = trips(f"get_analysis n={n}", lambda: c.get_analysis(metrics))
    sv = StateVector.from_tensor(want, n)
    direct = {"fidelity": StateAnalysis.process_fidelity(sv, sv),
              "entropy": StateAnalysis.von_neumann_entropy(sv),
              "purity": StateAnalysis.purity(sv),
              "pauli": {f"q{q}": {p: StateAnalysis.pauli_expectation(sv, p, q)
                                  for p in "XYZ"} for q in range(n)}}
    aerr = max([abs(got[k] - direct[k]) for k in ("fidelity", "entropy",
                                                  "purity")]
               + [abs(got["pauli"][q][p] - v)
                  for q, row in direct["pauli"].items()
                  for p, v in row.items()])
    check(set(got) == set(direct) and aerr <= STATE_TOL,
          f"bridge get_analysis n={n}: max |bridge - direct| {aerr}")
    report["front_headline"] = {"launches": steps, "state_err": err,
                                "analysis_err": aerr}
    print(f"front 13a n={n} depth-{depth}: launches {steps} per run, state "
          f"err {err:.2e}, analysis err {aerr:.2e}", flush=True)
    del want, sv


def front_wide(c, path: dict, trips: RoundTrips, report: dict) -> tuple:
    """13a, n = 28 run with its peak, three windows of 2^16 amplitudes
    against the plain-twin state."""
    n, depth = FRONT_WIDE
    circuit = brickwork(n, depth, SEED, True)
    program = tprog.compile_circuit(circuit)
    steps = plan_launches([program])
    c.set_circuit(circuit.to_dict())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    run = trips(f"run n={n}", lambda: c.run(shots=FRONT_WIDE_SHOTS,
                                            seed=SEED))
    delta = add_launches(path, before)
    peak = torch.cuda.max_memory_allocated()
    check(delta == steps, f"bridge run n={n}: launches {delta}, plan "
          f"{steps}")
    check(sum(run["measurement_counts"].values()) == FRONT_WIDE_SHOTS,
          f"bridge run n={n}: shots")
    check(peak <= RUN_PEAK_LIMIT, f"bridge run n={n}: peak "
          f"{peak / 2**30:.3f} GiB > {RUN_PEAK_LIMIT / 2**30:.1f}")
    want = tplan.group_forward_body(program, program.initial_params, "cuda",
                                    plain=True)
    errs = []
    for offset in (0, 1 << (n - 1), (1 << n) - FRONT_WINDOW):
        label = f"window {FRONT_WINDOW} at n={n}" + ("" if offset
                                                       else " (first)")
        win = trips(label, lambda: c.get_state(offset=offset,
                                               length=FRONT_WINDOW))
        ref = want[offset:offset + FRONT_WINDOW].cpu().numpy()
        check(win["offset"] == offset and win["total"] == 1 << n
              and len(win["amplitudes"]) == FRONT_WINDOW,
              f"window at {offset}: {win['offset']}, {win['total']}")
        errs.append(float(np.abs(bridge_amps(win) - ref).max()))
    check(max(errs) <= STATE_TOL, f"bridge windows n={n}: {errs}")
    report["front_wide"] = {"launches": steps, "peak_bytes": peak,
                            "window_errs": errs}
    print(f"front 13a n={n} depth-{depth}: launches {steps}, run peak "
          f"{peak / 2**30:.3f} GiB, window errs "
          f"{', '.join(f'{e:.2e}' for e in errs)}", flush=True)
    del want
    torch.cuda.empty_cache()
    return peak, errs


def front_noisy_run(c, path: dict, trips: RoundTrips) -> int:
    """13a, depolarizing 0.05 + readout, run_with_noise at n = 16."""
    n, depth = FRONT_HEADLINE
    circuit = brickwork(n, depth, SEED, False)
    nm = noise_model("depol")
    nm.set_readout_error(ReadoutError(0.01, 0.02))
    program = tprog.compile_circuit(circuit)
    want = batch_launches(program, nm, FRONT_NOISY_SHOTS)
    c.set_circuit(circuit.to_dict())
    check(c.set_noise(nm.to_dict()) == {}, "set_noise")
    before = launch_counts()
    run = trips(f"run n={n} noisy", lambda: c.run(shots=FRONT_NOISY_SHOTS,
                                                  seed=SEED))
    delta = add_launches(path, before)
    check(delta == want, f"bridge noisy run: launches {delta}, plans x "
          f"batches {want}")
    shots = sum(run["measurement_counts"].values())
    check(shots == FRONT_NOISY_SHOTS, f"bridge noisy run: {shots} shots")
    check(c.clear_noise() == {}, "clear_noise")
    print(f"front 13a noisy n={n}: {shots} shots, launches {delta}",
          flush=True)
    return shots


def front_sweep(c, path: dict, trips: RoundTrips, report: dict) -> dict:
    """13a, sweep_parameter at n = 20: launches, fidelity falling, the
    purity against tr(rho^2) of the same states in float64."""
    n, depth, values, trials = FRONT_SWEEP
    circuit = brickwork(n, depth, SEED, False)
    program = tprog.compile_circuit(circuit)
    want = plan_launches([program])
    for p in values:
        if p:
            for k, v in batch_launches(
                    program, global_noise(DepolarizingNoise(p)),
                    trials).items():
                want[k] += v
    c.set_circuit(circuit.to_dict())
    before = launch_counts()
    sweep = trips(f"sweep_parameter n={n}", lambda: c.sweep_parameter(
        "noise_p", list(values), trials=trials, seed=SEED))["sweep"]
    delta = add_launches(path, before)
    check(delta == want, f"bridge sweep: launches {delta}, plans {want}")
    fids = [pt["fidelity"] for pt in sweep]
    check(all(0 < f <= 1 for f in fids)
          and all(a > b for a, b in zip(fids, fids[1:])),
          f"bridge sweep fidelities {fids}")
    # the same trajectory states from the sweep's seed stream, in float64
    rng = np.random.default_rng(SEED)
    ideal = Simulator(device="cuda").run(
        circuit, shots=0, rng=np.random.default_rng(rng.integers(0, 2**63))
    ).final_state.device_data.to(torch.complex128)
    rows = []
    for pt, p in zip(sweep, values):
        if not p:
            check(pt == {"value": 0.0, "fidelity": 1.0, "purity": 1.0},
                  f"sweep at p = 0: {pt}")
            continue
        states = Simulator(noise_model=global_noise(DepolarizingNoise(p)),
                           device="cuda").trajectory_states(
            circuit, trials, seed=int(rng.integers(0, 2**63))
        ).to(torch.complex128)
        purity = float((states.conj() @ states.T).abs().square().mean())
        fid = float((states @ ideal.conj()).abs().square().mean())
        del states
        rows.append((p, pt["fidelity"], fid, pt["purity"], purity))
        check(abs(pt["purity"] - purity) <= STATE_TOL
              and abs(pt["fidelity"] - fid) <= STATE_TOL,
              f"sweep p={p}: purity {pt['purity']} vs {purity}, fidelity "
              f"{pt['fidelity']} vs {fid}")
    check(rows[-1][3] < FRONT_PURITY_MAX,
          f"sweep purity at p = {values[-1]}: {rows[-1][3]}")
    report["front_sweep"] = {"launches": delta, "rows": rows}
    del ideal
    torch.cuda.empty_cache()
    return {"launches": delta, "rows": rows}


def front_mps(c, trips: RoundTrips) -> dict:
    """13a, the MPS engine at the bench.py:457-483 cell."""
    n, depth, chi, shots = MPS_BENCH
    c.set_circuit(rx_brickwork(n, depth).to_dict())
    before = launch_counts()
    run = trips(f"run MPS n={n} chi={chi}", lambda: c.run(
        shots=shots, seed=SEED, engine="mps", chi=chi))
    check(launch_counts() == before, "the MPS engine launched a kernel")
    total = sum(run["measurement_counts"].values())
    check(total == shots and run["engine"] == "mps"
          and np.isfinite(run["truncation_weight"]),
          f"bridge MPS run: {total} shots, truncation "
          f"{run['truncation_weight']}")
    return run


def phase_front_bridge(path: dict, report: dict, card: str) -> None:
    """13a: the bridge over a socket, its handler on the card."""
    from quantum_simulator_tpu_torch.bridge import (BridgeCommandHandler,
                                                    BridgeServer,
                                                    SimulatorClient)
    from quantum_simulator_tpu_torch.bridge.client import BridgeError

    srv = BridgeServer(BridgeCommandHandler(device="cuda"), port=0)
    srv.start()
    trips = RoundTrips()
    try:
        with SimulatorClient(port=srv.port, timeout=FRONT_TIMEOUT) as c:
            check(trips("ping", c.ping), "ping")
            front_headline(c, path, trips, report)
            peak, errs = front_wide(c, path, trips, report)
            shots = front_noisy_run(c, path, trips)
            sweep = front_sweep(c, path, trips, report)
            mps_run = front_mps(c, trips)
            try:
                c._send_request("no_such_action")
            except BridgeError as e:
                check("Unknown action" in str(e), f"bad request: {e}")
            else:
                raise RuntimeError("an unknown action came back ok")
            check(c.ping(), "ping after a bad request")
    finally:
        srv.stop()
    report["front_round_trip_ms"] = trips.ms
    print(f"front 13a bridge [{card}]: n={FRONT_HEADLINE[0]} launches = "
          f"plan, state and analysis within {STATE_TOL}; n={FRONT_WIDE[0]} "
          f"peak {peak / 2**30:.3f} GiB, windows max err {max(errs):.2e}; "
          f"noisy run {shots} shots; sweep n={FRONT_SWEEP[0]} launches "
          f"{sweep['launches']}; MPS truncation "
          f"{mps_run['truncation_weight']:.3e}; the bad request answered "
          f"an error", flush=True)
    for (p, fb, f64, pb, p64) in sweep["rows"]:
        print(f"front 13a sweep n={FRONT_SWEEP[0]} p={p} [{card}]: fidelity "
              f"{fb:.6f} "
              f"(float64 {f64:.6f}), purity {pb:.6f} (float64 tr(rho^2) "
              f"{p64:.6f})", flush=True)
    for label, ms in trips.ms.items():
        print(f"front bridge round trip {label} [{card}]: {ms:.3f} ms",
              flush=True)


def phase_front_controllers(path: dict, report: dict, card: str) -> None:
    """13b: SimulationController, FidelitySweepModel and
    DensityMatrixModel on the card."""
    from quantum_simulator_tpu_torch.controller import SimulationController
    from quantum_simulator_tpu_torch.viewmodels import (DensityMatrixModel,
                                                        FidelitySweepModel)

    walls = {}
    errors: list[str] = []
    finished, steps = [], []
    ctl = SimulationController(device="cuda")
    ctl.on_error = errors.append
    ctl.on_finished = finished.append
    ctl.on_step_updated = lambda s, col: steps.append((col, s))

    n, depth = FRONT_WIDE
    circuit = brickwork(n, depth, SEED, True)
    before = launch_counts()
    t0 = time.perf_counter()
    ctl.run_simulation(circuit, shots=FRONT_WIDE_SHOTS, seed=SEED)
    ctl.join(timeout=FRONT_JOIN)
    walls[f"run_simulation n={n}"] = time.perf_counter() - t0
    add_launches(path, before)
    check(not errors and not ctl.is_running and len(finished) == 1,
          f"controller run n={n}: errors {errors}, running {ctl.is_running}"
          f", {len(finished)} results")
    direct = Simulator(device="cuda").run(circuit, shots=0).final_state
    err = float((finished[0].final_state.device_data
                 - direct.device_data).abs().max())
    check(err <= STATE_TOL, f"controller n={n} vs Simulator.run: {err}")
    del direct
    finished.clear()
    torch.cuda.empty_cache()

    n_s, depth_s = FRONT_STEPS
    circuit = brickwork(n_s, depth_s, SEED, True)
    before = launch_counts()
    t0 = time.perf_counter()
    ctl.run_step_by_step(circuit, shots=0)
    ctl.join(timeout=FRONT_JOIN)
    walls[f"run_step_by_step n={n_s}"] = time.perf_counter() - t0
    add_launches(path, before)
    check(not errors and len(finished) == 1
          and [col for col, _ in steps] == list(range(-1, depth_s)),
          f"step-by-step: errors {errors}, columns "
          f"{[col for col, _ in steps]}")
    ref = Simulator(device="cuda").run(circuit, shots=0).final_state
    serr = float((steps[-1][1].device_data - ref.device_data).abs().max())
    check(serr <= STATE_TOL, f"last step vs run: {serr}")
    del ref
    steps.clear()

    n_f, depth_f, probs, trials = FRONT_SWEEP_MODEL
    before = launch_counts()
    t0 = time.perf_counter()
    points = FidelitySweepModel.sweep(brickwork(n_f, depth_f, SEED, False),
                                      list(probs), trials=trials, seed=SEED,
                                      device="cuda")
    walls[f"FidelitySweepModel.sweep n={n_f}"] = time.perf_counter() - t0
    add_launches(path, before)
    fids = [pt.fidelity for pt in points]
    check(all(0 < f <= 1 for f in fids)
          and all(a > b for a, b in zip(fids, fids[1:]))
          and 0 < points[-1].purity < FRONT_PURITY_MAX,
          f"sweep model: {points}")

    n_d, depth_d, dm_trials = FRONT_DM
    circuit = brickwork(n_d, depth_d, SEED, True)
    nm = noise_model("depol")
    model = DensityMatrixModel(device="cuda")
    t0 = time.perf_counter()
    exact = model.exact(circuit, nm)
    walls[f"DensityMatrixModel.exact n={n_d}"] = time.perf_counter() - t0
    rho = density_rho_reference(tprog.compile_circuit(circuit), nm)
    derr = float(np.abs(exact.real + 1j * exact.imag - rho).max())
    check(derr <= FRONT_DM_TOL, f"exact rho vs NumPy: {derr}")
    before = launch_counts()
    t0 = time.perf_counter()
    ens = model.ensemble(circuit, nm, n_trials=dm_trials, seed=SEED)
    walls[f"DensityMatrixModel.ensemble n={n_d}"] = time.perf_counter() - t0
    add_launches(path, before)
    eerr = float(np.abs(ens.real + 1j * ens.imag - rho).max())
    check(eerr <= LAW_TOL, f"ensemble rho vs NumPy: {eerr}")
    report["front_controllers"] = {
        "controller_err": err, "step_err": serr, "sweep": [
            (pt.noise_prob, pt.fidelity, pt.purity) for pt in points],
        "exact_rho_err": derr, "ensemble_rho_err": eerr, "wall_s": walls}
    print(f"front 13b controllers [{card}]: run n={n} vs Simulator.run "
          f"{err:.2e}, {depth_s + 1} steps (last vs run {serr:.2e}), sweep "
          f"model n={n_f} fidelities {[round(f, 6) for f in fids]} purity "
          f"at p={probs[-1]} {points[-1].purity:.6f}, exact rho n={n_d} vs "
          f"NumPy {derr:.2e}, ensemble ({dm_trials} trials) {eerr:.4f}",
          flush=True)
    for label, s in walls.items():
        print(f"front controller wall {label} [{card}]: {s * 1e3:.3f} ms",
              flush=True)


def phase_front_ends(report: dict, card: str) -> dict:
    """13a-13b. Launch counts: every bridge request and controller or
    view-model run, each read from zero; the reference runs (plain twins,
    direct ``Simulator`` runs, the sweep's float64 re-run) not counted."""
    path = {k: 0 for k in launch_counts()}
    phase_front_bridge(path, report, card)
    phase_front_controllers(path, report, card)
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched in the front ends: {path}")
    report["front_launches"] = path
    return path


# Phase 14: every command-line twin at its default arguments (the full
# width of its path), each from released cached blocks. (module under
# quantum_simulator_tpu_torch, argv); ``quickstart`` skips its PNG
# (matplotlib). Two cuts keep the phase near 200 s (their full-default
# runs are timed in PERF.md): ``mesh_stretch_check`` runs QFT-32 alone
# (its brickwork-32 repeats 12c), and ``error_mitigation`` runs n = 2, one
# Trotter step (PEC by exact enumeration of 256 circuits, where the
# defaults draw 2000 samples of n = 4 density matrices, about 265 s).
ENTRY_TWINS = (
    ("scripts.noise_sweep", []),
    ("scripts.vqe_benchmark", []),
    ("scripts.qec_threshold", []),
    ("scripts.dmrg_solve", []),
    ("scripts.circuit_threshold", []),
    ("scripts.quantum_volume_check", []),
    ("scripts.monitored_check", []),
    ("scripts.huge_state_check", []),
    ("scripts.sharded_run", []),
    ("scripts.mesh_stretch_check", ["--config", "qft"]),
    ("examples.quickstart", ["--no-export"]),
    ("examples.error_mitigation", ["--n", "2", "--steps", "1"]),
    ("examples.monitored_circuit", []),
    ("examples.open_system", []),
    ("examples.qec_memory", []),
    ("examples.quench_dynamics", []),
    ("examples.quench_spectroscopy", []),
    ("examples.vqe_at_scale", []),
)


def run_entry_point(label: str, fn, path: dict, card: str) -> dict:
    """``fn()`` (a twin's ``main``, which must return 0) from a fresh
    peak counter with its stdout kept; launches counted from zero."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = add_launches(path, before)
    peak = torch.cuda.max_memory_allocated()
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.strip(" \t{}[],")] or [""]
    check(rc == 0, f"{label} exited {rc}: {lines[-1][:300]}")
    print(f"entry point {label} [{card}]: {wall:.3f} s, peak "
          f"{peak / 2**30:.3f} GiB, launches dense {delta['dense_axis']} "
          f"cross {delta['cross_bit_axis']} | {lines[-1][:160]}",
          flush=True)
    return {"wall_s": wall, "peak_bytes": peak, "launches": delta,
            "stdout": buf.getvalue()}


def phase_entry_points(report: dict, card: str) -> dict:
    """14. ``entry()``'s forward on the card against the plain twins',
    then every script and example twin at its default arguments. Launch
    counts: ``entry()``'s forward and each twin's ``main``, each from
    zero; the plain forward launches nothing."""
    path = {k: 0 for k in launch_counts()}
    fn, args = tentry.entry("cuda")
    plain_fn, _ = tentry.entry("cuda", plain=True)
    before = launch_counts()
    want = plain_fn(*args)
    check(launch_counts() == before, "entry(plain=True) launched a kernel")
    rec = {"entry": run_entry_point("entry", lambda: tentry.main([]), path,
                                    card)}
    before = launch_counts()
    got = fn(*args)
    delta = add_launches(path, before)
    err = float((got - want).abs().max())
    check(err <= STATE_TOL and all(v > 0 for v in delta.values()),
          f"entry() forward vs the twins: {err}, launches {delta}")
    print(f"entry() forward [{card}]: |psi|^2 of {got.numel()} amplitudes, "
          f"max |kernels - twins| {err:.2e}, launches dense "
          f"{delta['dense_axis']} cross {delta['cross_bit_axis']}",
          flush=True)
    del got, want
    for label, argv in ENTRY_TWINS:
        module = importlib.import_module(f"quantum_simulator_tpu_torch."
                                         f"{label}")
        rec[label] = run_entry_point(
            label, lambda m=module, a=argv: m.main(a), path, card)
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched in the entry points: {path}")
    report["entry_points"] = {"entry_err": err, "runs": rec,
                              "launches": path}
    return path


# ---------------------------------------------------------------------------
# Phase 15: the GUI on the card
# ---------------------------------------------------------------------------

GUI_RUN = (16, 40)            # AppConfig.max_qubits: the GUI's full width
GUI_SHOTS = 4096
GUI_NOISE = (0.01, 0.01, 0.02)   # depolarizing p, readout P(1|0), P(0|1)
GUI_OPT = (3, "zz_chain", "parameter_shift")   # iterations, cost, gradient
GUI_QEC_P = 0.05
GUI_COMPARE_SHOTS = 1024
GUI_BRIDGE_SHOTS = 1024
GUI_JOIN = 600.0


class GuiToolkits:
    """Display stand-ins for the toolkits this machine lacks, each named
    on an output line: the functional PyQt6 stand-ins of
    ``tests/qt_stub.py`` (else real Qt on the offscreen platform) and the
    recording matplotlib stand-in of ``tests/torch_gui_stubs.py``. Every
    engine call behind the widgets still runs on the card. Message boxes
    are recorded (``qt_stub.QMessageBox.shown``), never shown."""

    def __init__(self, mp):
        from tests import qt_stub, torch_gui_stubs

        self.boxes = qt_stub.QMessageBox.shown
        self.used = []
        self.app = None
        if torch_gui_stubs.install_qt(mp):
            self.used.append("PyQt6 absent: tests/qt_stub.py stand-ins")
        else:
            mp.setenv("QT_QPA_PLATFORM", "offscreen")
            from PyQt6.QtWidgets import QApplication

            self.app = (QApplication.instance()
                        or QApplication(sys.argv[:1]))
            self.used.append("PyQt6: real, offscreen platform")
        if torch_gui_stubs.install_matplotlib(mp):
            self.used.append("matplotlib absent: recording stand-in")
        else:
            self.used.append("matplotlib: real")
        self.boxes.clear()
        self._qt_stub = qt_stub

    def patch_boxes(self, mp, module) -> None:
        """Route ``module``'s message boxes to the recorder (real Qt's
        would block on a modal dialog)."""
        if self.app is not None:
            mp.setattr(module, "QMessageBox", self._qt_stub.QMessageBox)

    def pump(self) -> None:
        """Deliver queued cross-thread signals (real Qt only; the
        stand-ins call their slots at once)."""
        if self.app is not None:
            self.app.processEvents()

    @staticmethod
    def status(win) -> str:
        bar = win.statusBar()
        return (bar.messages[-1] if hasattr(bar, "messages")
                else bar.currentMessage())


class GuiRun:
    """Runs one GUI action: wall seconds ending in a synchronize, peak GiB
    from a fresh counter and launches from zero, printed with the card;
    any critical message box or worker-thread exception fails the phase
    (the run pipeline catches every error into a box and returns)."""

    def __init__(self, path: dict, card: str, toolkits: GuiToolkits,
                 thread_errors: list):
        self.path = path
        self.card = card
        self.toolkits = toolkits
        self.thread_errors = thread_errors
        self.rows: dict[str, dict] = {}

    def __call__(self, label: str, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.toolkits.pump()
        delta = add_launches(self.path, before)
        peak = torch.cuda.max_memory_allocated()
        critical = [b for b in self.toolkits.boxes if b[0] == "critical"]
        check(not critical, f"gui {label}: critical message box {critical}")
        check(not self.thread_errors,
              f"gui {label}: a worker thread raised {self.thread_errors}")
        self.rows[label] = {"wall_s": wall, "peak_bytes": peak,
                            "launches": delta}
        print(f"gui {label} [{self.card}]: {wall:.3f} s, peak "
              f"{peak / 2**30:.3f} GiB, launches dense {delta['dense_axis']}"
              f" cross {delta['cross_bit_axis']}", flush=True)
        return out, delta


def gui_workers(mp) -> tuple[list, list, list]:
    """Record every thread started (to join the panels' workers), every
    exception on one, and every ``device_scope`` the advanced panels
    enter, with the thread that entered it."""
    import threading

    from quantum_simulator_tpu_torch.gui import advanced_panels as ap

    started, errors, scopes = [], [], []

    class RecordedThread(threading.Thread):
        def start(self):
            started.append(self)
            super().start()

    real_scope = ap.device_scope

    def recorded_scope(device):
        scopes.append((threading.current_thread(), device))
        return real_scope(device)

    mp.setattr(threading, "Thread", RecordedThread)
    mp.setattr(threading, "excepthook",
               lambda a: errors.append(f"{a.exc_type.__name__}: "
                                       f"{a.exc_value}"))
    mp.setattr(ap, "device_scope", recorded_scope)
    return started, errors, scopes


def join_all(started: list) -> None:
    for t in list(started):
        t.join(GUI_JOIN)
        check(not t.is_alive(), f"gui worker {t.name} still running after "
              f"{GUI_JOIN} s")


def gui_run(win, run: GuiRun, report: dict) -> tuple:
    """15a: one Run click at n = 16 depth 40 (the ideal pass, then the
    shots run): launches twice the plan's steps, the final and the
    reference state within 1e-5 of the plain-twin executor."""
    n, depth = GUI_RUN
    circuit = brickwork(n, depth, SEED, False)
    program = tprog.compile_circuit(circuit)
    steps = plan_launches([program])
    win.circuit_controller.circuit = circuit
    _, delta = run("15a run", lambda: win._run_with_shots(GUI_SHOTS))
    check(delta == {k: 2 * v for k, v in steps.items()},
          f"gui run: launches {delta}, plan {steps} twice")
    res = win.last_result
    ref = win.reference_manager.reference
    check(res is not None and ref is not None
          and sum(res.measurement_counts.values()) == GUI_SHOTS
          and ref.circuit_hash == circuit.circuit_hash(),
          "gui run: no result, no reference or shots missing")
    want = tplan.group_forward_body(program, program.initial_params, "cuda",
                                    plain=True)
    err = max(float((res.final_state.device_data - want).abs().max()),
              float((ref.state.device_data - want).abs().max()))
    check(err <= STATE_TOL, f"gui run: final / reference state vs the "
          f"plain twins {err}")
    check(win.histogram_panel._last_counts == res.measurement_counts
          and win.statevector_panel._last_state is not None
          and GuiToolkits.status(win).startswith("Run complete"),
          "gui run: panels not fed")
    report["gui_run"] = {"launches": delta, "plan": steps, "state_err": err}
    print(f"gui 15a n={n} depth-{depth}: launches {delta} (plan {steps} "
          f"twice), final and reference state vs the twins {err:.2e}, "
          f"{GUI_SHOTS} shots", flush=True)
    return circuit, program, want, steps


def gui_noisy(win, run: GuiRun, mp, circuit, program, want, steps) -> dict:
    """15b: the noise model through ``NoiseConfigDialog``, a noisy Run
    click (launches = the ideal plan + the trajectory batches' plans),
    then step mode over every column."""
    from quantum_simulator_tpu_torch.gui import main_window as mw
    from quantum_simulator_tpu_torch.gui.dialogs import NoiseConfigDialog

    p, p01, p10 = GUI_NOISE
    dialog = NoiseConfigDialog()
    dialog._rows[2][0].setChecked(True)          # Depolarizing
    dialog._rows[2][1].setValue(p)
    dialog.readout_check.setChecked(True)
    dialog.p01_spin.setValue(p01)
    dialog.p10_spin.setValue(p10)
    dialog.exec = lambda: 1
    mp.setattr(mw, "NoiseConfigDialog", lambda current, parent: dialog)
    win._configure_noise()
    nm = win.noise_model
    check([type(c) for c in nm.global_channels] == [DepolarizingNoise]
          and nm.readout_error is not None
          and "Depolarizing" in win.noise_indicator.text(),
          f"gui noise dialog: {nm.global_channels}")
    traj = batch_launches(program, nm, GUI_SHOTS)
    want_delta = {k: steps[k] + traj[k] for k in steps}
    _, delta = run("15b noisy run", lambda: win._run_with_shots(GUI_SHOTS))
    check(delta == want_delta, f"gui noisy run: launches {delta}, "
          f"ideal plan + trajectory batches {want_delta}")
    err = float((win.reference_manager.reference.state.device_data
                 - want).abs().max())
    check(sum(win.last_result.measurement_counts.values()) == GUI_SHOTS
          and err <= STATE_TOL,
          f"gui noisy run: shots, ideal reference vs twins {err}")

    def step_mode():
        win._on_step_mode()
        for _ in range(program.num_columns + 2):   # the columns, then stop
            win._advance_step()

    _, sdelta = run("15b step mode", step_mode)
    check(GuiToolkits.status(win) == "Step mode complete"
          and len(win.entropy_panel.model.steps) == program.num_columns + 1
          and sum(sdelta.values()) > 0,
          f"gui step mode: {GuiToolkits.status(win)}, "
          f"{len(win.entropy_panel.model.steps)} steps, launches {sdelta}")
    print(f"gui 15b: noisy run launches {delta} (= ideal plan + "
          f"trajectory batches), reference err {err:.2e}; step mode "
          f"{program.num_columns + 1} states", flush=True)
    return nm


def gui_panels(win, run: GuiRun, nm, circuit, want, workers,
               report: dict) -> None:
    """15c: the debugger (noisy, the panel's trials), the comparison, the
    optimizer and the QEC sweep on real worker threads, joined, and the
    benchmark suite."""
    started, _, scopes = workers
    dp = win.debugger_panel
    dp.breakpoints = set(win.editor_model.breakpoints)
    trials = dp.trials_spin.value()
    run(f"15c debugger ({trials} trials)",
        lambda: dp.run_debug(circuit, nm, seed=SEED, block=True))
    snaps = dp.debugger.snapshots
    fids = [s.fidelity for s in snaps]
    ideal_err = float((snaps[-1].ideal_state.device_data - want).abs().max())
    check(len(snaps) == circuit.get_column_count() + 1
          and dp._attribution is not None and len(dp._impacts) > 0
          and all(-1e-6 <= f <= 1 + 1e-5 for f in fids)
          and ideal_err <= STATE_TOL,
          f"gui debugger: {len(snaps)} snapshots, fidelities "
          f"{min(fids)}..{max(fids)}, ideal vs twins {ideal_err}")

    n, depth = GUI_RUN
    circuit_b = brickwork(n, depth, SEED, True)
    program_b = tprog.compile_circuit(circuit_b)
    cp = win.comparison_panel
    run("15c comparison", lambda: cp.compare(
        circuit, circuit_b, shots=GUI_COMPARE_SHOTS, seed=SEED))
    want_b = tplan.group_forward_body(program_b, program_b.initial_params,
                                      "cuda", plain=True)
    fid = float((want.conj() * want_b).sum().abs().square())
    ferr = abs(cp._last.output_fidelity - fid)
    check(ferr <= STATE_TOL and cp.table.rowCount() == 9,
          f"gui comparison: fidelity {cp._last.output_fidelity} vs twins "
          f"{fid}")
    del want_b

    iters, cost, grad = GUI_OPT
    op = win.optimizer_panel
    op.iters_spin.setValue(iters)
    op.cost_combo.setCurrentText(cost)
    op.grad_combo.setCurrentText(grad)
    first = len(started)
    _, odelta = run("15c optimizer (worker thread)",
                    lambda: (op._on_run_clicked(), join_all(started)))
    worker_scopes = [(t, d) for t, d in scopes if t in started[first:]]
    check(not op._busy and len(op._history) >= 1
          and "optimal cost" in str(op.figure.gca().get_title())
          and worker_scopes
          and all(d == win.device for _, d in worker_scopes)
          and odelta["dense_axis"] > 0,
          f"gui optimizer: busy {op._busy}, {len(op._history)} costs, "
          f"worker scopes {worker_scopes}, launches {odelta}")

    qp = win.qec_panel
    qp.p_spin.setValue(GUI_QEC_P)
    run("15c QEC cycle", qp.run_cycle)
    check("F=" in qp.status.text(), f"gui QEC cycle: {qp.status.text()}")
    first = len(started)
    run("15c QEC sweep (worker thread)",
        lambda: (qp.run_sweep(), join_all(started)))
    check(qp.figure.gca().get_xlabel() == "Physical error rate"
          and any(t in started[first:] for t, _ in scopes),
          "gui QEC sweep: no plot or no worker")

    win.noise_model = None
    win._refresh_noise_indicator()
    run("15c benchmarks", win._run_benchmarks)
    info = [b for b in run.toolkits.boxes
            if b[:2] == ("information", "Benchmarks")]
    lines = info[-1][2].splitlines() if info else []
    check(lines and all(ln.startswith("✔") for ln in lines),
          f"gui benchmarks: {lines}")
    report["gui_panels"] = {"debugger_ideal_err": ideal_err,
                            "comparison_fidelity_err": ferr,
                            "optimizer_costs": list(op._history),
                            "benchmarks": lines}
    print(f"gui 15c: debugger {len(snaps)} snapshots (ideal vs twins "
          f"{ideal_err:.2e}), comparison fidelity {fid:.6f} (err "
          f"{ferr:.2e}), optimizer costs {[round(c, 6) for c in op._history]}"
          f" on worker threads pinned to {win.device}, {len(lines)} "
          f"benchmarks passed", flush=True)


def gui_bridge(win, run: GuiRun, mp, steps: dict) -> None:
    """15d: the bridge toggled on (an ephemeral port), one client run
    (launches = the plan's steps), toggled off."""
    import functools

    from quantum_simulator_tpu_torch.bridge import SimulatorClient
    from quantum_simulator_tpu_torch.gui import main_window as mw

    mp.setattr(mw, "BridgeServer", functools.partial(mw.BridgeServer,
                                                     port=0))
    run("15d bridge start", win._toggle_bridge)
    srv = win.bridge_server
    try:
        check(srv.is_running and srv.port > 0, "gui bridge did not start")
        with SimulatorClient(port=srv.port, timeout=FRONT_TIMEOUT) as c:
            reply, delta = run("15d bridge run", lambda: c.run(
                shots=GUI_BRIDGE_SHOTS, seed=SEED))
        check(delta == steps
              and sum(reply["measurement_counts"].values())
              == GUI_BRIDGE_SHOTS,
              f"gui bridge run: launches {delta}, plan {steps}")
        run("15d bridge stop", win._toggle_bridge)
        check(not srv.is_running, "gui bridge did not stop")
    finally:
        srv.stop()


def phase_gui(report: dict, card: str) -> dict:
    """15a-15d. ``MainWindow(device="cuda")`` at the GUI's full width, the
    display toolkits stood in where the machine lacks them and undone at
    the end. Launch counts: every GUI action, each from zero; the
    plain-twin references launch nothing."""
    import pytest

    from tests import torch_gui_stubs

    path = {k: 0 for k in launch_counts()}
    mp = pytest.MonkeyPatch()
    try:
        toolkits = GuiToolkits(mp)
        print("gui toolkits: " + "; ".join(toolkits.used), flush=True)
        from quantum_simulator_tpu_torch.gui import main_window as mw
        from quantum_simulator_tpu_torch.utils.appconfig import AppConfig

        toolkits.patch_boxes(mp, mw)
        workers = gui_workers(mp)
        run = GuiRun(path, card, toolkits, workers[1])
        win, _ = run("15 window", lambda: mw.MainWindow(AppConfig(),
                                                        device="cuda"))
        check(win.device == torch.device("cuda", torch.cuda.current_device()),
              f"gui window device {win.device}")
        circuit, program, want, steps = gui_run(win, run, report)
        nm = gui_noisy(win, run, mp, circuit, program, want, steps)
        gui_panels(win, run, nm, circuit, want, workers, report)
        gui_bridge(win, run, mp, steps)
        report["gui"] = {"toolkits": toolkits.used, "steps": run.rows}
        del win, want
    finally:
        mp.undo()
        torch_gui_stubs.purge(torch_gui_stubs.PORT_RENDER)
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched in the GUI: {path}")
    report["gui_launches"] = path
    return path


# ---------------------------------------------------------------------------
# Phase 16: the acceptance programs on the card
# ---------------------------------------------------------------------------

# Dense launches the harness makes at least: the plans of group 8 (the
# 10-qubit Ry layers, 2 steps) and group 9 (the 20-qubit H layer, 3).
HARNESS_MIN_DENSE = 2 + 3
PARITY_TRIALS = 200


def acceptance_harness(path: dict, report: dict, card: str) -> None:
    """16a. The 33 assertions on the card, then two of its circuits held
    against the CPU (those reruns launch outside the count)."""
    before = launch_counts()
    t0 = time.perf_counter()
    records = validation.run_groups("cuda")
    wall = time.perf_counter() - t0
    delta = add_launches(path, before)
    passed = sum(r.ok for r in records)
    print(f"16a harness [{card}]: {passed}/{len(records)} assertions in "
          f"{wall:.2f} s, launches dense {delta['dense_axis']} cross "
          f"{delta['cross_bit_axis']}", flush=True)
    check(passed == len(records) == validation.N_ASSERTIONS,
          "harness: " + "; ".join(r.line().strip() for r in records
                                  if not r.ok))
    check(delta["dense_axis"] >= HARNESS_MIN_DENSE,
          f"harness launched {delta}, want >= {HARNESS_MIN_DENSE} dense")
    errs = {}
    for label, circuit in (("Bell", validation.bell_circuit()),
                           ("Ry layers n=10 depth-20",
                            validation.ry_layers()),
                           ("H-layer n=20", validation.h_layer())):
        got = Simulator(device="cuda").run(
            circuit, shots=0, seed=42).final_state.device_data.cpu()
        want = Simulator(device="cpu").run(
            circuit, shots=0, seed=42).final_state.device_data
        errs[label] = float((got - want).abs().max())
        check(errs[label] <= STATE_TOL,
              f"harness {label}: card vs CPU {errs[label]}")
    print("16a card vs CPU: " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in errs.items()),
          flush=True)
    report["acceptance"]["harness"] = {
        "wall_s": wall, "launches": delta, "card_vs_cpu": errs,
        "perf": {r.name: r.values["seconds"] for r in records
                 if "seconds" in r.values},
        "lines": [r.line() for r in records]}


def acceptance_parity(path: dict, report: dict, card: str,
                      reference: str | None) -> None:
    """16b. The parity twin's engine half, card against CPU, through the
    script's own ``compare``; the reference comparison only where
    ``reference`` names its checkout."""
    before = launch_counts()
    t0 = time.perf_counter()
    on_card = parity_check.run_ours(PARITY_TRIALS, "cuda")
    wall = time.perf_counter() - t0
    delta = add_launches(path, before)
    on_cpu = parity_check.run_ours(PARITY_TRIALS, "cpu")
    checks = parity_check.compare(on_cpu, on_card, PARITY_TRIALS)
    ok = parity_check.print_checks(checks)
    print(f"16b parity [{card}]: card half {wall:.2f} s, launches dense "
          f"{delta['dense_axis']} cross {delta['cross_bit_axis']}; "
          f"{sum(c['passed'] for c in checks)}/{len(checks)} checks, "
          f"card against CPU", flush=True)
    check(ok and len(checks) == 8, "parity card vs CPU failed")
    check(delta["dense_axis"] > 0, f"parity launched {delta}")
    if reference is None:
        print("16b reference comparison: not run (no --reference)",
              flush=True)
    else:
        check(parity_check.has_reference(reference),
              f"--reference {reference} holds no quantum_sim package")
    rec = {"card_s": wall, "launches": delta, "checks": checks,
           "reference": reference}
    if reference is not None:
        rc = parity_check.main(["--device", "cuda", "--trials",
                                str(PARITY_TRIALS), "--reference",
                                reference])
        check(rc == 0, f"parity against the reference exited {rc}")
        rec["reference_rc"] = rc
    report["acceptance"]["parity"] = rec


def latency_launches(n: int, depth: int) -> dict:
    """The in-process launches of the latency twin: four ideal runs and
    one noisy trajectory each of the unedited and the 1-gate circuits."""
    want = {"dense_axis": 0, "cross_bit_axis": 0}
    for edit in (0, 0, 1, 2):
        d, c, _ = step_counts(tprog.compile_circuit(
            interactive_latency_check.build(n, depth, 3, edit)))
        want["dense_axis"] += d
        want["cross_bit_axis"] += c
    nm = noise_model("depol")
    for edit in (0, 1):
        for k, v in batch_launches(tprog.compile_circuit(
                interactive_latency_check.build(n, depth, 3, edit)),
                nm, 1).items():
            want[k] += v
    return want


def acceptance_latency(path: dict, report: dict, card: str) -> None:
    """16c. The latency twin's ``main`` at its defaults."""
    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "latency.json")
        before = launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = interactive_latency_check.main(["--output", out_path])
        delta = add_launches(path, before)
        with open(out_path) as f:
            out = json.load(f)
    print(json.dumps(out), flush=True)
    check(rc == 0, f"latency twin exited {rc}: {out}")
    want = latency_launches(out["n"], out["depth"])
    print(f"16c latency [{card}]: edits 1-gate {out['warm_1gate_edit_s']} "
          f"s, realness flip {out['warm_realness_flip_edit_s']} s, noisy "
          f"{out['noisy_warm_1gate_edit_s']} s (target < "
          f"{interactive_latency_check.EDIT_TARGET_S} s); second process "
          f"cold {out['second_process_cold_s']} s (target <= "
          f"{interactive_latency_check.SECOND_PROCESS_TARGET_S} s, "
          f"met: {out['second_process_cold_under_10s']}); launches dense "
          f"{delta['dense_axis']} cross {delta['cross_bit_axis']} (plans "
          f"{want['dense_axis']} / {want['cross_bit_axis']})", flush=True)
    check(delta == want, f"latency launches {delta}, plans {want}")
    split = edit_split(out["n"], out["depth"])
    print(f"16c warm 1-gate edit [{card}]: executor "
          f"{split['executor_ms']:.4f} ms device (CUDA events, "
          f"{split['launches']} launches), host operand build "
          f"{split['host_build_ms']:.4f} ms, of the "
          f"{out['warm_1gate_edit_s'] * 1e3:.3f} ms edit rerun", flush=True)
    report["acceptance"]["latency"] = {"result": out, "launches": delta,
                                       "edit_split": split}


def edit_split(n: int, depth: int) -> dict:
    """The latency twin's warm 1-gate edit, split: the host operand build
    (best of 3, host clock) and the executor on operands already on the
    card (best of 3, CUDA events). Launched outside the path's count."""
    program = tprog.compile_circuit(
        interactive_latency_check.build(n, depth, 3, 1))
    plan = tplan.build_group_plan(program)
    params = program.initial_params
    build_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        host_ops = tplan.build_group_operands(program, plan, params)
        build_s = min(build_s, time.perf_counter() - t0)
    ops = tplan.operands_to(host_ops, "cuda")
    planar = not plan.all_real

    def fresh():
        return tplan.basis_state(plan, program.initial_index, "cuda",
                                 planar)

    def executor(x):
        return tplan.execute_group_plan(plan, ops, program, params, x,
                                        planar, False)

    executor(fresh())   # warm
    d, c, _ = step_counts(program)
    return {"executor_ms": event_ms(executor, fresh),
            "host_build_ms": build_s * 1e3, "launches": d + c}


def phase_acceptance(report: dict, card: str,
                     reference: str | None) -> dict:
    """16a-16c. Launch counts: the harness, the parity twin's card half
    and the latency twin's in-process runs, each from zero."""
    path = {k: 0 for k in launch_counts()}
    report["acceptance"] = {}
    acceptance_harness(path, report, card)
    acceptance_parity(path, report, card, reference)
    acceptance_latency(path, report, card)
    torch.cuda.empty_cache()
    check(all(v > 0 for v in path.values()),
          f"a kernel never launched in the acceptance programs: {path}")
    report["acceptance_launches"] = path
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement as JSON")
    ap.add_argument("--reference", metavar="PATH", help="checkout of the "
                    "reference NumPy engine: 16b then also runs the parity "
                    "check against it")
    ap.add_argument("--phases", help="comma-separated phases to run, of "
                    + ",".join(PHASES) + " (then no summary is printed)")
    args = ap.parse_args()
    chosen = set(args.phases.split(",")) if args.phases else set(PHASES)
    if not chosen <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases "
                         f"{sorted(chosen - set(PHASES))}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")

    t_start = time.perf_counter()
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
    depths = (2, 4, 8, 16, 32, 64, 128, 256)
    print("dynamic shared memory per block, bytes (K: real, complex; "
          "fiber-major / row-major tile):",
          ", ".join(f"{k}: {lib.qs_smem_bytes(k, 0, 0)}/"
                    f"{lib.qs_smem_bytes(k, 0, 1)}, "
                    f"{lib.qs_smem_bytes(k, 1, 0)}/{lib.qs_smem_bytes(k, 1, 1)}"
                    for k in depths))
    for k in depths:
        for real in (True, False):
            got = lib.qs_tile_fibers(k, int(not real))
            check(got == cuda_exec.tile_fibers(k, real),
                  f"tile fibers at K={k} real={real}: kernel {got}, "
                  f"wrapper {cuda_exec.tile_fibers(k, real)}")

    phases = {"2": lambda: phase_kernels(report, card),
              "2b": lambda: phase_batched_kernels(report, card),
              "2c": lambda: phase_huge_kernels(report, card),
              "3": lambda: phase_main(report),
              "3b": lambda: phase_noisy(report, card),
              "4": lambda: phase_timing(card, report),
              "4b": lambda: phase_noisy_timing(card, report),
              "5": lambda: phase_variational(report, card),
              "6": lambda: phase_huge(report, card),
              "7": lambda: phase_huge_noisy(report, card),
              "8": lambda: phase_open_system(report, card),
              "9": lambda: phase_analysis(report, card),
              "10": lambda: phase_bit_engines(report, card),
              "11": lambda: phase_mps(report, card),
              "12": lambda: phase_mesh(report, card),
              "13": lambda: phase_front_ends(report, card),
              "14": lambda: phase_entry_points(report, card),
              "15": lambda: phase_gui(report, card),
              "16": lambda: phase_acceptance(report, card, args.reference)}
    out = {}
    for name in PHASES:
        if name in chosen:
            t0 = time.perf_counter()
            out[name] = phases[name]()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(f"max_memory_allocated over the run: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    report["wall_s"] = time.perf_counter() - t_start
    print(f"chip_smoke wall time {report['wall_s']:.1f} s [{card}]",
          flush=True)

    if chosen != set(PHASES):
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        print(f"partial run (phases {sorted(chosen)}): no summary")
        return 0
    summary = {"kernels": []}
    for name, (source, replaces) in KERNEL_INFO.items():
        row = out["2"]["summary"][name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(out[p][name] for p in ("3", "3b", "5", "6",
                                                   "7", "8", "9", "10",
                                                   "11", "12", "13",
                                                   "14", "15",
                                                   "16")),
            "max_abs_err": max(out["2"]["max_err"][name], out["2b"][name],
                               out["2c"][name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
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
