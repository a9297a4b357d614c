"""Fixtures of qsbench's tests: a copy of the benchmark cut to a few
qubits, in a temporary checkout, so a whole run fits a CPU test."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# widths of the cut copies: the n >= 30 path is forced at TINY_HUGE
TINY_WIDTHS = {"esu2_30": 6, "esu2_16": 5}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def copy_checkout(dst: Path) -> Path:
    shutil.copytree(REPO / "qsbench", dst / "qsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A checkout whose configurations are cut to a few qubits and whose
    checks take the first two answers (or the closing one), with the n >= 30 path of the port
    forced at the cut width of ``esu2_30``."""
    from qsbench.cell import Manifest
    from quantum_simulator_tpu_torch.ops import bigstate

    root = copy_checkout(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["num_qubits"] = TINY_WIDTHS[c["name"]]
        path.write_text(json.dumps(cfg))
    for path in (root / "qsbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if "requests" in traffic["check"]:
            traffic["check"].update(requests=2, among_first=2)
        traffic["shots"] = min(traffic["shots"], 2048)
        path.write_text(json.dumps(traffic))
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS",
                        TINY_WIDTHS["esu2_30"])
    m = Manifest(root)
    # no device trace on the CPU: its readers have nothing to read here
    m.data["per_layer"] = [p for p in m.data["per_layer"]
                           if p["source"] != "device_trace"]
    return m
