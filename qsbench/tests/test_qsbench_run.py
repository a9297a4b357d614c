"""Whole runs on the CPU at a few qubits (the harness's look for a card
skipped): the result line's schema, ``correct`` on sound runs, and
``correct`` false under each fault a cell can have."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from qsbench import harness, run
from qsbench.harness import run_cell

CELLS = ["esu2_30.sweep", "esu2_16.edit", "esu2_16.noisy"]


def _schema(out, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] == 0
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(tiny, cell, trace):
    out = run_cell(tiny, cell, 2**31 + 17, 0.3, trace, "cpu", 0.0)
    _schema(out, trace)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in tiny.metrics(cell, trace)}
    assert set(out["metrics"]) == want


def test_same_seed_same_work(tiny):
    a = run_cell(tiny, "esu2_16.edit", 5, 0.2, False, "cpu", 0.0)
    b = run_cell(tiny, "esu2_16.edit", 5, 0.2, False, "cpu", 0.0)
    assert a["checks"] == b["checks"]


def _flip_last_bit(counts):
    return {k[:-1] + ("1" if k[-1] == "0" else "0"): v
            for k, v in counts.items()}


def test_step_returning_its_state_unchanged(tiny, monkeypatch):
    from quantum_simulator_tpu_torch.ops import cuda_exec

    monkeypatch.setattr(cuda_exec, "dense_axis",
                        lambda x, op, axis, planar, batched=False: x)
    for cell, number in (("esu2_16.edit", "state_gap"),
                         ("esu2_30.sweep", "state_gap"),
                         ("esu2_16.noisy", "traj_gap")):
        out = run_cell(tiny, cell, 3, 0.2, False, "cpu", 0.0)
        assert not out["correct"]
        assert out["checks"][number]["value"] > 0.1


def test_answer_altered_where_it_is_produced(tiny, monkeypatch):
    from quantum_simulator_tpu_torch import simulator
    from quantum_simulator_tpu_torch.ops import bigstate

    engine = simulator.MeasurementEngine
    orig = engine.sample_with_basis
    monkeypatch.setattr(engine, "sample_with_basis", staticmethod(
        lambda *a, **k: _flip_last_bit(orig(*a, **k))))
    out = run_cell(tiny, "esu2_16.edit", 4, 0.2, False, "cpu", 0.0)
    assert not out["correct"] and out["checks"]["state_gap"]["value"] < 1e-4
    assert out["checks"]["counts_absz"]["value"] > 5

    to_counts = bigstate.indices_to_counts
    monkeypatch.setattr(simulator, "indices_to_counts",
                        lambda idx, n: _flip_last_bit(to_counts(idx, n)))
    out = run_cell(tiny, "esu2_30.sweep", 4, 0.2, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["counts_absz"]["value"] > 5


def test_half_of_each_batch_left_out(tiny, monkeypatch):
    from quantum_simulator_tpu_torch.simulator import Simulator

    orig = Simulator._trajectory_batches

    def half(self, *a, **k):
        for states in orig(self, *a, **k):
            yield states[: max(1, states.shape[0] // 2)]

    monkeypatch.setattr(Simulator, "_trajectory_batches", half)
    out = run_cell(tiny, "esu2_16.noisy", 6, 0.2, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["shots_missing"]["value"] > 0


def test_noise_left_out(tiny, monkeypatch):
    from quantum_simulator_tpu_torch.simulator import Simulator

    monkeypatch.setattr(Simulator, "_noisy", lambda self: False)
    out = run_cell(tiny, "esu2_16.noisy", 7, 0.2, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["law_absz"]["value"] > 5


def test_failed_request_is_not_correct(tiny, monkeypatch):
    from quantum_simulator_tpu_torch.simulator import Simulator

    orig, calls = Simulator.run, []

    def boom(self, *a, **k):      # the warm request passes, then none
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("lost")
        return orig(self, *a, **k)

    monkeypatch.setattr(Simulator, "run", boom)
    out = run_cell(tiny, "esu2_16.edit", 8, 0.1, False, "cpu", 0.0)
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_missing_span_fails_loudly(tiny, monkeypatch):
    """A per-layer metric whose span never fires stops the traced run."""
    from quantum_simulator_tpu_torch.ops import bigstate

    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 30)
    with pytest.raises(harness.MissingMetric):
        run_cell(tiny, "esu2_30.sweep", 9, 0.1, True, "cpu", 0.0)


def test_instruments_put_everything_back(tiny):
    from quantum_simulator_tpu_torch.measurement import MeasurementEngine
    from quantum_simulator_tpu_torch.ops import cuda_exec, plan, program
    from quantum_simulator_tpu_torch.ops import unitary_traj

    before = (plan.execute_group_plan, unitary_traj.execute_group_plan,
              program.compile_circuit, cuda_exec._launch,
              MeasurementEngine.__dict__["sample_with_basis"])
    run_cell(tiny, "esu2_16.noisy", 10, 0.1, True, "cpu", 0.0)
    run_cell(tiny, "esu2_16.edit", 10, 0.1, True, "cpu", 0.0)
    after = (plan.execute_group_plan, unitary_traj.execute_group_plan,
             program.compile_circuit, cuda_exec._launch,
             MeasurementEngine.__dict__["sample_with_basis"])
    assert after == before


def test_banned_modules_compared_by_whole_name(monkeypatch):
    assert "quantum_simulator_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "quantum_simulator_tpu_torch_x",
                        types.ModuleType("x"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "quantum_simulator_tpu.ops",
                        types.ModuleType("x"))
    assert harness.banned_modules() == ["jax", "quantum_simulator_tpu"]


def test_cli_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc = run.main(["--workload", "esu2_16.edit", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("who,passes", [("program", True), ("control", False),
                                        ("fault-bitflip", False),
                                        ("fault-halfbatch", False)])
@pytest.mark.parametrize("cell", ["esu2_16.edit", "esu2_16.noisy"])
def test_control_readings(tiny, cell, who, passes):
    """``control.py``'s answers for the requests a run checks: the port's
    pass, the TF32 control's and the planted faults' do not."""
    import quantum_simulator_tpu_torch as port

    from qsbench import control
    from qsbench.check import judge

    traffic, requests, seed = control.checked_requests(tiny, cell, 21)
    entry = tiny.module("entries", traffic["entry"])
    answers = control.answers_of(who, port, entry, traffic, requests, "cpu",
                                 seed + 1)
    numbers = entry.check_answers(answers, traffic, "cpu", seed=seed)
    assert judge(numbers, tiny.limits(cell)) == passes, numbers
    if cell == "esu2_16.noisy" and who == "control":
        assert numbers["traj_gap"] > tiny.limits(cell)["traj_gap"]
