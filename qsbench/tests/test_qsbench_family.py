"""The EfficientSU2 builder: deterministic by seed, gate-exact to Qiskit's
layout, and accepted by the port's circuit format."""

import numpy as np
import pytest

from qsbench.cell import Manifest

CFG = {"num_qubits": 4, "reps": 3, "su2_gates": ["ry", "rz"],
       "entanglement": "linear"}


def family():
    return Manifest().module("families", "efficient_su2")


def qiskit_layout(n, reps):
    """EfficientSU2(n, ['ry', 'rz'], 'linear', reps) written out from
    Qiskit's definition: per layer RY(θ) on 0..n-1, RZ(θ) on 0..n-1, then
    (but after the last) CX(i, i+1) for i = 0..n-2."""
    out, k = [], 0
    for layer in range(reps + 1):
        for name in ("Ry", "Rz"):
            for q in range(n):
                out.append((name, [q], k))
                k += 1
        if layer < reps:
            out += [("CNOT", [q, q + 1], -1) for q in range(n - 1)]
    return out, k


@pytest.mark.parametrize("n,reps", [(4, 3), (5, 1), (30, 3), (16, 3)])
def test_layout_matches_qiskit(n, reps):
    cfg = dict(CFG, num_qubits=n, reps=reps)
    d = family().circuit(cfg, np.random.default_rng(0))
    want, k = qiskit_layout(n, reps)
    assert k == family().num_params(cfg) == 2 * n * (reps + 1)
    assert [(g["name"], g["targets"]) for g in d["gates"]] == \
        [(a, b) for a, b, _ in want]
    angles = np.random.default_rng(0).uniform(0, 2 * np.pi, k)
    got = [g["params"][0] for g in d["gates"] if g["params"]]
    assert got == [float(angles[i]) for _, _, i in want if i >= 0]
    cols = [g["column"] for g in d["gates"]]
    assert cols == sorted(cols)
    for c in set(cols):   # no qubit twice in a column
        qs = [q for g in d["gates"] if g["column"] == c for q in g["targets"]]
        assert len(qs) == len(set(qs))


def test_paper_sizes():
    m = Manifest()
    assert family().num_params(m.config("esu2_30")) == 240
    assert family().num_params(m.config("esu2_16")) == 128
    gates16 = family().layout(m.config("esu2_16"))
    assert len(gates16) == 173


def test_deterministic_by_seed_and_fresh_per_draw():
    f = family()
    a = f.circuit(CFG, np.random.default_rng(2**31 + 5))
    b = f.circuit(CFG, np.random.default_rng(2**31 + 5))
    assert a == b
    rng = np.random.default_rng(1)
    assert f.circuit(CFG, rng) != f.circuit(CFG, rng)


def test_port_reads_the_dict():
    from quantum_simulator_tpu_torch import QuantumCircuit

    d = family().circuit(CFG, np.random.default_rng(3))
    c = QuantumCircuit.from_dict(d)
    assert c.num_qubits == 4 and len(c.gates) == len(d["gates"])


def test_only_linear_is_built():
    with pytest.raises(ValueError):
        family().layout(dict(CFG, entanglement="full"))
