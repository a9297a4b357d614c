"""Cells, configurations, traffic mixes, limits and metrics are found by
name, and a new one is new files and a manifest entry."""

import hashlib
import json

import pytest

from conftest import copy_checkout
from qsbench.cell import Manifest
from qsbench.harness import run_cell


def test_every_cell_finds_its_files():
    m = Manifest()
    for w in m.data["workloads"]:
        cfg = m.config(w["config"])
        traffic = m.traffic(w["traffic"])
        m.module("families", cfg["family"])
        m.module("entries", traffic["entry"])
        assert m.limits(w["name"])
        for trace in (False, True):
            for metric in m.metrics(w["name"], trace):
                assert callable(m.module("metrics", metric["name"]).read)
    assert {c["name"] for c in m.data["configs"]} == {
        w["config"] for w in m.data["workloads"]}


def test_metrics_follow_their_workloads():
    m = Manifest()
    names = {x["name"] for x in m.metrics("esu2_16.edit", False)}
    assert names == {"edit_ms", "setup_s"}
    layer = {x["name"] for x in m.metrics("esu2_30.sweep", True)}
    assert "dense_axis_roofline" in layer and "host_prep_ms.edit" not in layer


def test_config_files_match_the_manifest():
    m = Manifest()
    for c in m.data["configs"]:
        cfg = m.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_unknown_names_raise():
    m = Manifest()
    with pytest.raises(KeyError):
        m.workload("nope")
    with pytest.raises(FileNotFoundError):
        m.module("metrics", "nope")


def test_a_split_metric_falls_back_to_its_quantity(tmp_path):
    root = copy_checkout(tmp_path)
    m = Manifest(root)
    shared = m.module("metrics", "device_idle")
    assert m.module("metrics", "device_idle.sweep") is shared
    assert m.module("metrics", "device_idle.anything") is shared
    own = root / "qsbench" / "metrics" / "device_idle.own.py"
    own.write_text("def read(ctx):\n    return 1.0\n")
    assert m.module("metrics", "device_idle.own") is not shared
    with pytest.raises(FileNotFoundError):
        m.module("metrics", "nope.sweep")


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "qsbench").rglob("*")) if p.is_file()}


def test_a_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell, its limits and a per-layer
    metric added as new files plus manifest entries, with no existing
    file of the benchmark changed, run end to end."""
    root = copy_checkout(tmp_path)
    before = _digest(root)
    bench = root / "qsbench"
    cfg = json.loads((bench / "configs" / "esu2_16.json").read_text())
    cfg.update(name="esu2_4", num_qubits=4, reps=1)
    (bench / "configs" / "esu2_4.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "quick.json").write_text(json.dumps(
        {"entry": "run", "shots": 256,
         "check": {"requests": 2, "among_first": 3}}))
    (bench / "limits" / "esu2_4.quick.json").write_text(json.dumps(
        {"state_gap": 1e-4, "counts_absz": 5.0, "shots_missing": 0}))
    (bench / "metrics" / "compile_ms.quick.py").write_text(
        "from qsbench.reduce import PROGRAM, spans_ms\n"
        "SPANS = {f'{PROGRAM}:compile_circuit': 'host'}\n"
        "def read(ctx):\n    return spans_ms(ctx, SPANS)\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "esu2_4", "source": cfg["source"],
                           "file": "qsbench/configs/esu2_4.json",
                           "reduced": ["reps"], "why": "a test"})
    man["workloads"].append({"name": "esu2_4.quick", "config": "esu2_4",
                             "traffic": "quick", "chips": 1, "why": "t"})
    run_s = next(e for e in man["end_to_end"] if e["name"] == "run_s")
    run_s["workloads"].append("esu2_4.quick")
    man["per_layer"].append({"name": "compile_ms.quick", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "host prep (ops.program, ops.plan)",
                             "moves": "run_s",
                             "workloads": ["esu2_4.quick"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before

    m = Manifest(root)
    plain = run_cell(m, "esu2_4.quick", 11, 0.2, False, "cpu", 0.0)
    assert plain["correct"] and set(plain["metrics"]) == {"run_s",
                                                          "setup_s"}
    traced = run_cell(m, "esu2_4.quick", 12, 0.2, True, "cpu", 0.0)
    assert traced["correct"]
    assert traced["metrics"]["compile_ms.quick"]["value"] > 0
