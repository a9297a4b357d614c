"""The QFT configuration: its cell runs sound at a few qubits on the plain
twins, the faults planted in the port and the TF32 control fail its
check, a port without the timed step functions stops before its first
request, and the pass roofline's state size comes from the configuration."""

import numpy as np
import pytest

import quantum_simulator_tpu_torch as port
from qsbench import control, control_qft, passes
from qsbench.cell import Manifest
from qsbench.check import judge
from qsbench.harness import run_cell

CELL = "qft_30.sweep"


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(tiny, trace):
    out = run_cell(tiny, CELL, 2**31 + 23, 0.3, trace, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"]
                                   for m in tiny.metrics(CELL, trace)}
    if trace:
        for name in ("executor_ms.qft", "diag_pair_roofline",
                     "swap_roofline"):
            assert out["metrics"][name]["value"] > 0


@pytest.mark.parametrize("fault", control_qft.FAULTS)
def test_planted_fault_is_not_correct(tiny, fault):
    with control_qft.planted(fault):
        out = run_cell(tiny, CELL, 31, 0.2, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["state_gap"]["value"] > 0.1


@pytest.mark.parametrize("who,passes_check", [
    ("program", True), ("control", False), ("fault-bitflip", False),
    ("fault-noswap", False), ("fault-negphase", False),
    ("fault-nodiag", False)])
def test_control_readings(tiny, who, passes_check):
    """``control_qft.py``'s answers for the requests a run checks: the
    port's pass; the TF32 control's fail ``state_gap``."""
    traffic, requests, seed = control.checked_requests(tiny, CELL, 21)
    entry = tiny.module("entries", traffic["entry"])
    answers = control_qft.answers_of(who, port, entry, traffic, requests,
                                     "cpu", seed + 1)
    numbers = entry.check_answers(answers, traffic, "cpu", seed=seed)
    assert judge(numbers, tiny.limits(CELL)) == passes_check, numbers
    if who == "control":
        assert numbers["state_gap"] > tiny.limits(CELL)["state_gap"]


def test_faults_are_taken_back_out():
    from quantum_simulator_tpu_torch.ops import plan

    before = (plan.apply_bitpair_step, plan.apply_diag_pair_step,
              vars(port.QuantumCircuit)["from_dict"])
    for fault in control_qft.FAULTS:
        with control_qft.planted(fault):
            pass
    assert before == (plan.apply_bitpair_step, plan.apply_diag_pair_step,
                      vars(port.QuantumCircuit)["from_dict"])


def test_a_port_without_the_step_functions_stops_at_once(tiny,
                                                         monkeypatch):
    from quantum_simulator_tpu_torch.ops import plan

    monkeypatch.delattr(plan, "apply_diag_pair_step")
    entry = tiny.module("entries", "run_qft")
    with pytest.raises(RuntimeError, match="apply_diag_pair_step"):
        entry.serve_fn(port, tiny.traffic("qft_sweep"), "cpu")


def test_negated_cphase_is_the_first_and_only_one():
    fam = Manifest().module("families", "qft")
    cfg = {"num_qubits": 5, "approximation_degree": 0, "do_swaps": True}
    c = fam.circuit(cfg, np.random.default_rng(0))
    d = control_qft.negate_first_cphase(c)
    diff = [(a, b) for a, b in zip(c["gates"], d["gates"]) if a != b]
    assert len(diff) == 1
    a, b = diff[0]
    assert a["name"] == "CPhase" and b["params"] == [-a["params"][0]]
    assert a["params"] == [np.pi / 2]


def test_pass_bytes_follow_the_configuration(tiny):
    cfg = passes.listed_config(Manifest().root, "diag_pair_roofline")
    assert cfg["name"] == "qft_30"
    assert passes.state_bytes(cfg) == 8 << 30
    assert passes.least_pass_s(cfg) == pytest.approx(5.128e-3, rel=1e-3)
    cut = passes.listed_config(tiny.root, "swap_roofline")
    assert passes.state_bytes(cut) == 2 * 4 * (1 << cut["num_qubits"])
    assert cut["num_qubits"] < 30


def _dense(n, gate):
    """The gate as a 2^n x 2^n matrix, qubit 0 the most significant."""
    name, tg = gate["name"], gate["targets"]
    u = np.zeros((1 << n, 1 << n), complex)
    for i in range(1 << n):
        bits = [(i >> (n - 1 - q)) & 1 for q in range(n)]
        if name == "H":
            q = tg[0]
            for b in (0, 1):
                j = i ^ ((bits[q] ^ b) << (n - 1 - q))
                u[j, i] = (-1 if bits[q] and b else 1) / np.sqrt(2)
        elif name == "CPhase":
            u[i, i] = np.exp(1j * gate["params"][0]) if all(
                bits[q] for q in tg) else 1
        else:   # SWAP
            p, q = tg
            j = i
            if bits[p] != bits[q]:
                j = i ^ (1 << (n - 1 - p)) ^ (1 << (n - 1 - q))
            u[j, i] = 1
    return u


@pytest.mark.parametrize("n", [2, 3, 5])
def test_reference_gates_match_dense_products(n):
    from qsbench.reference import qft as ref

    rng = np.random.default_rng(n)
    gates = [{"name": "Ry", "targets": [q], "params": [float(a)],
              "column": 0}
             for q, a in enumerate(rng.uniform(0, 7, n))]
    for col in range(1, 30):
        kind = ["H", "CPhase", "SWAP"][rng.integers(3)]
        if kind == "H" or n == 1:
            gates.append({"name": "H", "targets": [int(rng.integers(n))],
                          "params": [], "column": col})
            continue
        p, q = (int(v) for v in rng.choice(n, 2, replace=False))
        gates.append({"name": kind, "targets": [p, q], "column": col,
                      "params": [float(rng.uniform(-4, 4))]
                      if kind == "CPhase" else []})
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for g in gates:
        psi = (_dense(n, g) if g["name"] != "Ry" else np.kron(np.kron(
            np.eye(1 << g["targets"][0]),
            [[np.cos(g["params"][0] / 2), -np.sin(g["params"][0] / 2)],
             [np.sin(g["params"][0] / 2), np.cos(g["params"][0] / 2)]]),
            np.eye(1 << (n - 1 - g["targets"][0])))) @ psi
    circ = {"num_qubits": n, "gates": gates}
    re, im = ref.simulate(circ, "cpu")
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), psi,
                               atol=1e-12)
    for prec, tol in (("float32", 1e-5), ("tf32", 2e-2)):
        re, im = ref.simulate(circ, "cpu", prec)
        got = re.double().numpy() + 1j * im.double().numpy()
        assert np.linalg.norm(got - psi) < tol
