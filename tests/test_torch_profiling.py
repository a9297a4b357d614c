"""The port's recorder (``utils/profiling.py``): off, a span is one check
and nothing else; on, spans nest under one request per root span, land in
a ``torch.profiler`` trace as ranges in the order they were entered, and
the launch records and the trajectory batches' gauge hold what their
sites saw. No span call site synchronizes the device."""

import ast
import contextlib
import itertools
import json
import tracemalloc
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import simulator
from quantum_simulator_tpu_torch.ops import _build, cuda_exec
from quantum_simulator_tpu_torch.ops import plan as gplan
from quantum_simulator_tpu_torch.ops import program as prog
from quantum_simulator_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PORT = Path(tq.__file__).resolve().parent


def circuit_dict(n=9, layers=2, seed=0):
    """Ry / Rz layers and a CNOT chain: dense steps on every axis and, at
    n > 7, cross steps between them."""
    rng = np.random.default_rng(seed)
    gates, col = [], 0
    for _ in range(layers):
        for name in ("Ry", "Rz"):
            gates += [{"name": name, "targets": [q], "column": col,
                       "params": [float(rng.uniform(0, 6.3))]}
                      for q in range(n)]
            col += 1
        for q in range(n - 1):
            gates.append({"name": "CNOT", "targets": [q, q + 1],
                          "column": col})
            col += 1
    return {"num_qubits": n, "gates": gates}


def noise_model(p=0.05):
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(p))
    return nm


def run_both(d):
    """An ideal run and a noisy one, each from the circuit dict."""
    tq.Simulator(device="cpu").run(tq.QuantumCircuit.from_dict(d),
                                   shots=64, seed=1)
    tq.Simulator(noise_model=noise_model(), device="cpu").run_with_noise(
        tq.QuantumCircuit.from_dict(d), shots=32, seed=2)


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span did more than check the flag")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_On", refuse)
    monkeypatch.setattr(profiling, "Gauge", refuse)
    monkeypatch.setattr(profiling, "Launch", refuse)
    assert profiling._recording is None
    run_both(circuit_dict(n=5, layers=1))
    assert profiling.span("plan.execute") is profiling._OFF
    profiling.gauge("traj.batch_bytes_reckoned", 1.0)
    # off, entering and leaving a span keeps no memory
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, 20000):
            with profiling.span("step.dense"):
                pass
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert abs(now - base) < 512 and peak - base < 512


def test_spans_nest_with_parent_request_and_self_time(monkeypatch):
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    with profiling.recording() as rec:
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                profiling.gauge("g", 3)
                with profiling.span("d"):
                    pass
        with profiling.recording() as inner:      # the open one
            assert inner is rec
            with profiling.span("e"):
                pass
    assert profiling._recording is None
    assert [s.name for s in rec.spans] == list("abcde")
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2, -1]
    assert [s.request for s in rec.spans] == [0, 0, 0, 0, 1]
    assert rec.gauges == [profiling.Gauge("g", 3.0)]
    dur = [s.end_ns - s.start_ns for s in rec.spans]
    assert all(d > 0 for d in dur)
    assert rec.self_ns() == [dur[0] - dur[1] - dur[2], dur[1],
                             dur[2] - dur[3], dur[3], dur[4]]


def test_program_ranges_in_the_exported_trace(tmp_path):
    """A run and a noisy run under ``trace(logdir)``: the trace's program
    ranges are the recording's spans, in number and order."""
    d = circuit_dict()
    with profiling.recording() as rec:
        with profiling.trace(str(tmp_path)):
            run_both(d)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    names = [s.name for s in rec.spans]
    assert [e["name"] for e in ranges] == names
    assert {"circuit.from_dict", "simulator.run", "program.compile",
            "plan.lookup", "plan.operands", "operands.gates",
            "operands.dense", "operands.cross", "operands.rest",
            "plan.operands_to", "plan.execute", "step.dense", "step.cross",
            "measure.sample", "simulator.run_with_noise", "traj.draws",
            "traj.overrides", "plan.operands_batched",
            "traj.sample"} <= set(names)
    roots = [s for s in rec.spans if s.parent < 0]
    assert [s.name for s in roots] == ["circuit.from_dict", "simulator.run",
                                       "circuit.from_dict",
                                       "simulator.run_with_noise"]
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.request == p.request
    steps = [s for s in rec.spans if s.name.startswith("step.")]
    assert all(rec.spans[s.parent].name == "plan.execute" for s in steps)
    ops = [s for s in rec.spans if s.name.startswith("operands.")]
    assert len(ops) == 4 * names.count("plan.operands")
    assert sum(rec.self_ns()) == sum(s.end_ns - s.start_ns for s in roots)


def test_chunk_size_records_the_reckoned_batch(monkeypatch):
    from quantum_simulator_tpu_torch.ops.unitary_traj import \
        unitary_insert_spec

    monkeypatch.setattr(simulator, "TRAJECTORY_MEMORY_BYTES", 1 << 22)
    program = prog.compile_circuit(tq.QuantumCircuit.from_dict(
        circuit_dict(n=10, layers=1)))
    nm = noise_model()
    with profiling.recording() as rec:
        chunk = simulator._chunk_size(program, nm, 1000)
    ops = simulator._plan_operand_bytes(gplan.get_group_plan(
        unitary_insert_spec(program, nm).aug))
    per = 3 * (8 << 10) + 4 * ops
    assert 1 <= chunk < 1000
    [g] = [g for g in rec.gauges if g.name == "traj.batch_bytes_reckoned"]
    assert g.value == chunk * per <= 1 << 22


@pytest.mark.parametrize("batched,shared,real", [(False, False, True),
                                                 (True, True, False),
                                                 (True, False, False)])
def test_launch_record_at_the_launch(monkeypatch, batched, shared, real):
    """``cuda_exec._launch`` records what it was handed, the fields a
    roofline reads; here with a stand-in library on the CPU."""
    launched = []
    lib = types.SimpleNamespace(qs_dense_axis=lambda *a: launched.append(a)
                                or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    B, S = 3, 16
    shape = (4, S)
    x = torch.zeros(((B,) if batched else ()) + (2,) + shape)
    block = (S, S) if real else (2, S, S)
    if not batched:
        op = torch.zeros(block)
    elif shared:
        op = torch.zeros(block).expand((B,) + block)
    else:
        op = torch.zeros((B,) + block)
    view = cuda_exec._view("dense", shape, 1, True, real, 4)
    with profiling.recording() as rec:
        with profiling.span("step.dense"):
            cuda_exec._launch("qs_dense_axis", x, op, S, real, view,
                              batched)
    assert len(launched) == 1
    op_elems = (S * S if real else 2 * S * S) * (B if batched and not shared
                                                 else 1)
    assert rec.launches == [profiling.Launch(
        "dense_axis", x.numel(), op_elems, S, not real, "float32", 0)]


def _calls(node, attr):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and isinstance(n.func, (ast.Attribute, ast.Name))
            and getattr(n.func, "attr", getattr(n.func, "id", None)) == attr]


def test_no_span_site_synchronizes():
    """Every function of the port that opens a span, records a launch or
    a gauge, and the recorder itself, has no ``synchronize()`` call.
    ``profiling.time_compiled``, a timing helper outside the recorder,
    waits for its own events."""
    sites = 0
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if path.name == "profiling.py" and fn.name != "time_compiled":
                recorder = True
            else:
                recorder = any(_calls(fn, a) for a in ("span", "gauge",
                                                       "launch"))
            if recorder:
                sites += 1
                assert not _calls(fn, "synchronize"), f"{path}:{fn.name}"
    assert sites >= 20
