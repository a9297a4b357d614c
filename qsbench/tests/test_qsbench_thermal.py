"""The thermal-relaxation cell (``esu2_30_thermal.noisy``) found by name and
run end to end on the CPU at a few qubits, its n >= 30 path forced at the
cut width (the ``tiny`` fixture), traced and untraced."""

import json

import pytest

import conftest
from qsbench.cell import Manifest
from qsbench.harness import run_cell

CELL = "esu2_30_thermal.noisy"
# the cut width of the thermal configuration in the ``tiny`` copies; at or
# above the width at which the fixture forces the n >= 30 path
conftest.TINY_WIDTHS.setdefault("esu2_30_thermal", 8)

LAYER = {"traj_exec_ms.thermal", "window_sample_ms.thermal",
         "window_sample_roofline", "window_prep_ms.thermal",
         "windows_per_traj.thermal", "device_idle.thermal"}


def test_the_cell_finds_its_files():
    m = Manifest()
    w = m.workload(CELL)
    cfg = m.config(w["config"])
    assert cfg["num_qubits"] == 30 and cfg["reduced"] == []
    assert [ch["gates"] for ch in cfg["noise"]] == [["Ry"], ["CNOT"]]
    traffic = m.traffic(w["traffic"])
    entry = m.module("entries", traffic["entry"])
    assert entry.trajectories(traffic) == 2
    assert set(m.limits(CELL)) == {"traj_gap", "law_absz", "shots_absz",
                                   "shots_missing"}
    assert {x["name"] for x in m.metrics(CELL, False)} == {
        "trajectories_per_s", "setup_s"}
    assert {x["name"] for x in m.metrics(CELL, True)} == LAYER
    for x in m.metrics(CELL, True):
        assert callable(m.module("metrics", x["name"]).read)
    assert m.module("metrics", "device_idle.thermal") is m.module(
        "metrics", "device_idle")


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(tiny, trace):
    out = run_cell(tiny, CELL, 2**31 + 29, 0.3, trace, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    want = {x["name"] for x in tiny.metrics(CELL, trace)}
    assert set(out["metrics"]) == want
    if trace:
        m = out["metrics"]
        assert m["windows_per_traj.thermal"]["value"] == 1 + 3 * 6 + 3 * 2
        assert m["window_sample_roofline"]["value"] > 0
    json.dumps(out, allow_nan=False)


def test_noise_left_out(tiny):
    """The relaxation's Kraus operators replaced by the identity: the port
    runs the ideal circuit through the same route."""
    from qsbench.control_thermal import planted

    with planted("fault-noiseless"):
        out = run_cell(tiny, CELL, 7, 0.2, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["traj_gap"]["value"] > 1e-4
