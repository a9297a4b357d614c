"""The plain references against dense NumPy products, the TF32 rounding,
and the imports that keep them independent of the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from qsbench.reference import precision
from qsbench.reference import statevector as ref
from qsbench.reference import trajectories as ref_traj

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "quantum_simulator_tpu",
             "quantum_simulator_tpu_torch"}


def dense(name, params):
    if name == "Ry":
        c, s = np.cos(params[0] / 2), np.sin(params[0] / 2)
        return np.array([[c, -s], [s, c]])
    if name == "Rz":
        return np.diag([np.exp(-0.5j * params[0]), np.exp(0.5j * params[0])])
    raise KeyError(name)


def full_unitary(n, gate):
    """The gate as a 2^n x 2^n matrix, qubit 0 the most significant."""
    tg = gate["targets"]
    if gate["name"] == "CNOT":
        c, t = tg
        u = np.zeros((1 << n, 1 << n))
        for i in range(1 << n):
            j = i ^ (1 << (n - 1 - t)) if (i >> (n - 1 - c)) & 1 else i
            u[j, i] = 1
        return u
    m = dense(gate["name"], gate.get("params", []))
    q = tg[0]
    return np.kron(np.kron(np.eye(1 << q), m), np.eye(1 << (n - q - 1)))


def random_circuit(n, depth, rng):
    gates = []
    for col in range(depth):
        kind = rng.integers(4)
        if kind == 3 and n > 1:
            c, t = rng.choice(n, 2, replace=False)
            gates.append({"name": "CNOT", "targets": [int(c), int(t)],
                          "params": [], "column": col})
        else:
            name = ["Ry", "Rz"][kind % 2]
            gates.append({"name": name, "targets": [int(rng.integers(n))],
                          "params": [float(rng.uniform(0, 7))],
                          "column": col})
    return {"num_qubits": n, "gates": gates}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_statevector_matches_dense_product(n):
    rng = np.random.default_rng(n)
    circ = random_circuit(n, 40, rng)
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for g in circ["gates"]:
        psi = full_unitary(n, g) @ psi
    re, im = ref.simulate(circ, "cpu")
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), psi,
                               atol=1e-12)


def test_unknown_gate_refused():
    with pytest.raises(ValueError):
        ref.simulate({"num_qubits": 1, "gates": [{"name": "T",
                                                 "targets": [0]}]}, "cpu")


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-11 + 2**-20), 3.0e-5], dtype=torch.float32)
    r = precision.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                      # tie to even
    assert r[3] == 1.0 + 2**-9              # tie to even, upward
    assert r[4] == -(1.0 + 2**-10)          # above the tie: away
    mant = r.view(torch.int32) & 0x1FFF
    assert int(mant.abs().sum()) == 0
    rel = ((r[5] - x[5]) / x[5]).abs()
    assert float(rel) <= 2**-11


def test_tf32_control_is_coarser_than_float32():
    circ = random_circuit(6, 60, np.random.default_rng(3))
    r64 = ref.simulate(circ, "cpu")
    gaps = {}
    for p in ("float32", "tf32"):
        re, im = ref.simulate(circ, "cpu", precision=p)
        gaps[p] = float(((re.double() - r64[0]).square()
                         + (im.double() - r64[1]).square()).sum().sqrt())
    assert gaps["float32"] < 1e-6 < 1e-4 < gaps["tf32"] < 1e-1


def test_noiseless_trajectories_sample_the_ideal_law():
    n = 3
    circ = random_circuit(n, 15, np.random.default_rng(5))
    re, im = ref.simulate(circ, "cpu")
    p = (re.square() + im.square()).numpy()
    gen = torch.Generator().manual_seed(1)
    idx = ref_traj.sample(circ, [], 20000, gen, "cpu", block=4096)
    freq = np.bincount(idx.numpy(), minlength=1 << n) / 20000
    assert np.abs(freq - p).max() < 0.02


def test_depolarizing_trajectories_match_the_density_matrix():
    """The trajectory law against rho evolved exactly: U rho U^H per gate,
    then (1 - p) rho + p/3 (X rho X + Y rho Y + Z rho Z) per target."""
    n, pdep = 2, 0.2
    circ = random_circuit(n, 8, np.random.default_rng(9))
    rho = np.zeros((1 << n, 1 << n), complex)
    rho[0, 0] = 1
    paulis = [np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]),
              np.diag([1, -1])]
    for g in circ["gates"]:
        u = full_unitary(n, g)
        rho = u @ rho @ u.conj().T
        for q in g["targets"]:
            emb = [np.kron(np.kron(np.eye(1 << q), s), np.eye(1 << (n - q - 1)))
                   for s in paulis]
            rho = (1 - pdep) * rho + pdep / 3 * sum(e @ rho @ e.conj().T
                                                    for e in emb)
    gen = torch.Generator().manual_seed(2)
    shots = 40000
    idx = ref_traj.sample(circ, [{"channel": "DepolarizingNoise",
                                  "p": pdep}], shots, gen, "cpu",
                          block=8192)
    freq = np.bincount(idx.numpy(), minlength=1 << n) / shots
    assert np.abs(freq - np.real(np.diag(rho))).max() < 0.015


PAULIS = [np.eye(2), np.array([[0, 1], [1, 0]]),
          np.array([[0, -1j], [1j, 0]]), np.diag([1, -1])]


def test_replay_matches_dense_products_with_their_paulis():
    """Each branch row's trajectory against the dense product, the Pauli
    of each site (Y with its phase) after its gate, sites in gate, channel,
    target order."""
    n = 3
    circ = random_circuit(n, 12, np.random.default_rng(4))
    noise = [{"channel": "DepolarizingNoise", "p": 0.3}] * 2
    sites = ref_traj.site_tables(circ, noise)
    branch = torch.from_numpy(np.random.default_rng(6).integers(
        4, size=(5, len(sites))))
    re, im = ref_traj.replay(circ, noise, branch, "cpu")
    for row in range(5):
        psi = np.zeros(1 << n, complex)
        psi[0] = 1
        k = 0
        for g in circ["gates"]:
            psi = full_unitary(n, g) @ psi
            for _ in noise:
                for q in g["targets"]:
                    p = PAULIS[int(branch[row, k])]
                    psi = np.kron(np.kron(np.eye(1 << q), p),
                                  np.eye(1 << (n - q - 1))) @ psi
                    k += 1
        np.testing.assert_allclose(re[row].numpy() + 1j * im[row].numpy(),
                                   psi, atol=1e-12)
    with pytest.raises(ValueError):
        ref_traj.replay(circ, noise, branch[:, 1:], "cpu")


def test_draws_follow_the_channel():
    circ = random_circuit(2, 10, np.random.default_rng(8))
    noise = [{"channel": "DepolarizingNoise", "p": 0.3}]
    branch = ref_traj.draw(circ, noise, 20000, torch.Generator()
                           .manual_seed(3), "cpu")
    freq = np.bincount(branch.reshape(-1).numpy(), minlength=4) \
        / branch.numel()
    np.testing.assert_allclose(freq, [0.7, 0.1, 0.1, 0.1], atol=0.01)


def test_unknown_channel_refused():
    with pytest.raises(ValueError):
        ref_traj.pauli_tables([{"channel": "BitFlipNoise",
                                "p": 0.1}])


def _top_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_either_package(path):
    assert not _top_imports(path) & FORBIDDEN


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_imports(path) & (FORBIDDEN
                                         - {"quantum_simulator_tpu_torch"}), \
            path
