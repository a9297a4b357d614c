"""Acceptance harness of the port: 9 groups, 33 assertions, exit code 0/1.

The port's twin of the repository's ``test_validation.py`` (the
reference's acceptance semantics: Bell physics, norm preservation,
measurement sanity, readout-mode consistency, QEC basics, reference
invalidation, CPTP limits, performance bounds, scaling proofs), with the
same assertion names, order and bounds, run against the PyTorch port on
one device: the card by default, the host with ``--device cpu``.

    python -m quantum_simulator_tpu_torch.validation [--device cpu]

Every simulator, QEC engine and state lives on that device, and so do the
16-qubit readout transform (a float64 tensor) and the 20-qubit norm; the
two 2-qubit kron checks at 1e-12 stay float64 NumPy on the host. Each
timed window ends in a ``torch.cuda.synchronize`` on the card, and the
warm-up before it also covers the first kernel launch of the process
(loading, and where needed building, the kernel library).
``run_groups(device)`` prints each line as the JAX harness does and
returns the assertions as records; ``main`` adds the total and returns 0
iff every one passed.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .analysis import StateAnalysis
from .circuit import GateInstance, QuantumCircuit
from .measurement import MeasurementBasis, MeasurementEngine
from .noise import (AmplitudeDampingNoise, DepolarizingNoise, NoiseModel,
                    ReadoutError)
from .ops.apply import probabilities
from .qec import BitFlipCode, QECSimulator
from .reference import ReferenceManager
from .registry import GateRegistry
from .simulator import Simulator
from .state import StateVector
from .utils.cli import add_device_argument, open_device

N_ASSERTIONS = 33


@dataclass
class Assertion:
    """One assertion's outcome; ``values`` holds the numbers it judged."""
    group: int
    name: str
    ok: bool
    detail: str = ""
    values: dict = field(default_factory=dict)

    def line(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (f"  [{status}] {self.name}"
                + (f"  ({self.detail})" if self.detail else ""))


class _Report:
    """Collects a group's assertions and prints each line as it comes."""

    def __init__(self, records: list[Assertion]):
        self.records = records
        self.group = 0

    def start(self, group: int, title: str) -> None:
        self.group = group
        print(f"Group {group}: {title}")

    def __call__(self, name: str, ok, detail: str = "", **values) -> None:
        rec = Assertion(self.group, name, bool(ok), detail, values)
        self.records.append(rec)
        print(rec.line())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bell_circuit() -> QuantumCircuit:
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], column=0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
    return c


def ghz4() -> QuantumCircuit:
    c = QuantumCircuit(4)
    c.add_gate(GateInstance("H", [0], [], column=0))
    for i in range(1, 4):
        c.add_gate(GateInstance("CNOT", [0, i], [], column=i))
    return c


def ry_layers(n: int = 10, depth: int = 20, seed: int = 42
              ) -> QuantumCircuit:
    """Group 8's circuit: ``depth`` columns of Ry on every qubit."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    for col in range(depth):
        for q in range(n):
            c.add_gate(GateInstance("Ry", [q],
                                    [float(rng.uniform(0, np.pi))],
                                    column=col))
    return c


def h_layer(n: int = 20) -> QuantumCircuit:
    """Group 9's beyond-reference circuit: one column of H."""
    c = QuantumCircuit(n)
    for q in range(n):
        c.add_gate(GateInstance("H", [q], [], column=0))
    return c


def _noise(channel, seed: int) -> NoiseModel:
    nm = NoiseModel()
    nm.add_global_noise(channel)
    nm.set_seed(seed)
    return nm


# --- Group 1: Bell-state physics (4 assertions) ----------------------------

def group_bell_physics(report: _Report, dev: torch.device) -> None:
    report.start(1, "Bell-state physics")
    state = Simulator(device=dev).run(bell_circuit(), shots=0,
                                      seed=42).final_state
    amps = state.data
    inv = 1 / np.sqrt(2)
    report("amplitudes 1/sqrt(2) at |00>,|11>",
           abs(amps[0] - inv) < 1e-5 and abs(amps[3] - inv) < 1e-5,
           amps=amps)
    report("zero amplitudes at |01>,|10>",
           abs(amps[1]) < 1e-6 and abs(amps[2]) < 1e-6)
    mi = StateAnalysis.mutual_information(state, 0, 1)
    report("I(0:1) = 2 bits", abs(mi - 2.0) < 1e-4, f"mi={mi:.6f}", mi=mi)
    s0 = StateAnalysis.entanglement_entropy(state, [0])
    report("S(q0) = 1 bit", abs(s0 - 1.0) < 1e-4, f"S={s0:.6f}", S=s0)


# --- Group 2: Norm preservation (3 assertions) ------------------------------

def group_norm_preservation(report: _Report, dev: torch.device) -> None:
    report.start(2, "Norm preservation")
    rng = np.random.default_rng(42)
    sv = StateVector(4, device=dev)
    reg = GateRegistry.instance()
    for name in ["H", "X", "Y", "Z", "S", "T"]:
        sv.apply_gate(reg.get(name).matrix_func(), [int(rng.integers(4))])
    norm = sv.probabilities.sum()
    report("norm = 1 after unitary gates", abs(norm - 1.0) < 1e-5)

    state = Simulator(noise_model=_noise(DepolarizingNoise(0.2), 42),
                      device=dev).run(bell_circuit(), shots=0,
                                      seed=42).final_state
    report("norm = 1 after stochastic depolarizing noise",
           abs(state.probabilities.sum() - 1.0) < 1e-5)

    state = Simulator(noise_model=_noise(AmplitudeDampingNoise(0.4), 7),
                      device=dev).run(bell_circuit(), shots=0,
                                      seed=7).final_state
    report("norm = 1 after amplitude damping",
           abs(state.probabilities.sum() - 1.0) < 1e-5)


# --- Group 3: Measurement sanity (4 assertions) ------------------------------

def group_measurement(report: _Report, dev: torch.device) -> None:
    report.start(3, "Measurement sanity")
    state = Simulator(device=dev).run(bell_circuit(), shots=0,
                                      seed=42).final_state
    rng = np.random.default_rng(42)
    for basis in (MeasurementBasis.Z, MeasurementBasis.X,
                  MeasurementBasis.Y):
        counts = MeasurementEngine.sample_with_basis(
            state, 10_000, basis=basis, rng=rng)
        report(f"{basis.value}-basis: 10,000 shots sum correctly",
               sum(counts.values()) == 10_000)
    report("probabilities sum to 1",
           abs(state.probabilities.sum() - 1.0) < 1e-6)


# --- Group 4: Readout-error mode consistency (3 assertions) ------------------

def group_readout(report: _Report, dev: torch.device) -> None:
    report.start(4, "Readout-error mode consistency")
    ro = ReadoutError(p01=0.05, p10=0.05)
    c = ro.confusion_matrix
    report("confusion-matrix columns sum to 1",
           np.allclose(c.sum(axis=0), 1.0))

    state = Simulator(device=dev).run(bell_circuit(), shots=0,
                                      seed=42).final_state
    shots = 100_000
    c_shot = MeasurementEngine.sample_with_basis(
        state, shots, readout_error=ro, readout_mode="shot",
        rng=np.random.default_rng(1))
    c_dist = MeasurementEngine.sample_with_basis(
        state, shots, readout_error=ro, readout_mode="distribution",
        rng=np.random.default_rng(2))
    keys = set(c_shot) | set(c_dist)
    max_diff = max(abs(c_shot.get(k, 0) - c_dist.get(k, 0)) / shots
                   for k in keys)
    report("shot vs distribution modes agree (< 0.02 @ 100k shots)",
           max_diff < 0.02, f"max_diff={max_diff:.4f}")

    probs = np.array([0.4, 0.3, 0.2, 0.1])
    got = ro.apply_to_distribution(probs, 2)
    full = np.kron(c, c) @ probs
    full /= full.sum()
    report("2q distribution transform matches kron to 1e-12",
           np.max(np.abs(got - full)) < 1e-12, transform=got)


# --- Group 5: QEC basics (3 assertions) --------------------------------------

def group_qec(report: _Report, dev: torch.device) -> None:
    report.start(5, "QEC")
    sim = QECSimulator(BitFlipCode(), device=dev)
    r = sim.run_cycle(0, "bit_flip", 0.0, seed=1)
    report("bit-flip code noiseless fidelity = 1.0",
           abs(r.fidelity_after - 1.0) < 1e-4)
    report("<Z_L> = +1 for |0>_L",
           abs(r.logical_z_expectation - 1.0) < 1e-4)
    r1 = sim.run_cycle(1, "bit_flip", 0.0, seed=1)
    report("<Z_L> = -1 for |1>_L",
           abs(r1.logical_z_expectation + 1.0) < 1e-4)


# --- Group 6: Reference invalidation + layer API (4 assertions) ---------------

def group_reference(report: _Report, dev: torch.device) -> None:
    report.start(6, "Reference invalidation & layer API")
    mgr = ReferenceManager()
    circuit = bell_circuit()
    state = Simulator(device=dev).run(circuit, shots=0).final_state
    mgr.store(state, circuit_hash=circuit.circuit_hash())
    report("reference stored", mgr.has_reference)
    report("same hash keeps reference",
           mgr.check_invalidation(circuit.circuit_hash()) is False)
    circuit.add_gate(GateInstance("X", [1], [], column=2))
    report("changed hash invalidates reference",
           mgr.check_invalidation(circuit.circuit_hash()) is True
           and not mgr.has_reference)

    layers = circuit.compute_layers()
    g2l = circuit.gate_to_layer_map()
    report("compute_layers / gate_to_layer_map consistent",
           all(gi in layers[g2l[gi]] for gi in range(len(circuit.gates))))


# --- Group 7: Noise CPTP limits (4 assertions) --------------------------------

def group_cptp(report: _Report, dev: torch.device) -> None:
    report.start(7, "Noise CPTP limits")
    c = QuantumCircuit(1, initial_states=[1])
    c.add_gate(GateInstance("I", [0], [], column=0))

    def final(channel, seed, circuit=c):
        return Simulator(noise_model=_noise(channel, seed), device=dev).run(
            circuit, shots=0).final_state.probabilities

    report("amp-damp gamma=0 is identity",
           abs(final(AmplitudeDampingNoise(0.0), 1)[1] - 1.0) < 1e-5)
    report("amp-damp gamma=1 decays |1> to |0>",
           abs(final(AmplitudeDampingNoise(1.0), 1)[0] - 1.0) < 1e-5)
    report("amp-damp gamma=0.3 preserves norm",
           abs(final(AmplitudeDampingNoise(0.3), 3).sum() - 1.0) < 1e-5)
    report("depolarizing p=1 preserves norm",
           abs(final(DepolarizingNoise(1.0), 5, bell_circuit()).sum()
               - 1.0) < 1e-5)


# --- Group 8: Performance regression (4 assertions) ----------------------------

def group_performance(report: _Report, dev: torch.device) -> None:
    report.start(8, "Performance regression")
    c = ry_layers()
    sim = Simulator(device=dev)
    sim.run(c, shots=0)   # warm: the first launch loads the kernel library
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        sim.run(c, shots=0)
    _sync(dev)
    per_run = (time.perf_counter() - t0) / 10
    report("[perf] 10q depth-20 ideal run < 2 s (avg of 10)",
           per_run < 2.0, f"{per_run*1000:.1f} ms/run", seconds=per_run)

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nsim = Simulator(noise_model=nm, device=dev)
    # warm with the same circuit and trial count as the timed call
    nsim.ensemble_density_matrix(ghz4(), n_trials=50, seed=0)
    _sync(dev)
    t0 = time.perf_counter()
    rho = nsim.ensemble_density_matrix(ghz4(), n_trials=50, seed=42)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    report("[perf] 4q ensemble rho, 50 trials < 5 s", elapsed < 5.0,
           f"{elapsed:.2f} s", seconds=elapsed)
    purity = float(np.real(np.trace(rho @ rho)))
    report("ensemble purity < 1 under noise", purity < 0.9999,
           f"purity={purity:.4f}", purity=purity)
    trace = float(np.trace(rho).real)
    report("ensemble trace = 1", abs(trace - 1.0) < 1e-3, trace=trace)


# --- Group 9: Scaling proof (4 assertions) --------------------------------------

def group_scaling(report: _Report, dev: torch.device) -> None:
    report.start(9, "Scaling proof")
    rng = np.random.default_rng(0)
    probs = rng.random(2**16)
    probs /= probs.sum()
    probs = torch.from_numpy(probs).to(dev)          # float64 on the device
    ro = ReadoutError(p01=0.02, p10=0.02)
    ro.apply_to_distribution(probs, 16)   # warm, outside the bound
    _sync(dev)
    t0 = time.perf_counter()
    out = ro.apply_to_distribution(probs, 16)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    report("[perf] 16q distribution-transform readout < 1 s",
           elapsed < 1.0, f"{elapsed*1000:.1f} ms", seconds=elapsed)
    report("16q transform normalized", abs(float(out.sum()) - 1.0) < 1e-9)

    probs2 = np.array([0.5, 0.25, 0.15, 0.1])
    got = ro.apply_to_distribution(probs2, 2)
    brute = np.kron(ro.confusion_matrix, ro.confusion_matrix) @ probs2
    brute /= brute.sum()
    report("2q transform matches brute-force kron < 1e-12",
           np.max(np.abs(got - brute)) < 1e-12, transform=got)

    # Beyond-reference scaling: a 20-qubit circuit runs (the reference
    # caps at 16 qubits).
    state = Simulator(device=dev).run(h_layer(), shots=0).final_state
    norm = float(probabilities(state.device_data).sum())
    report("20-qubit circuit runs with norm 1 (beyond reference cap)",
           abs(norm - 1.0) < 1e-4, norm=norm)


GROUPS = (group_bell_physics, group_norm_preservation, group_measurement,
          group_readout, group_qec, group_reference, group_cptp,
          group_performance, group_scaling)


def run_groups(device) -> list[Assertion]:
    """Every group on ``device``, in order, printing each line as it comes."""
    dev = torch.device(device)
    records: list[Assertion] = []
    report = _Report(records)
    for group in GROUPS:
        group(report, dev)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Acceptance harness: 9 groups, 33 assertions")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    dev = open_device(args.device, "validation")
    if dev is None:
        return 1
    t0 = time.perf_counter()
    records = run_groups(dev)
    elapsed = time.perf_counter() - t0
    passed = sum(r.ok for r in records)
    print(f"\n{passed}/{len(records)} assertions passed in {elapsed:.1f} s")
    return 0 if passed == len(records) == N_ASSERTIONS else 1


if __name__ == "__main__":
    sys.exit(main())
