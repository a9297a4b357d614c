"""The port's eight example twins (``quantum_simulator_tpu_torch/
examples``) on the CPU at small arguments, their printed numbers held
against the JAX examples or against exact values.

Each twin runs once through its ``main(argv)`` with ``--device cpu`` from
an empty working directory, recording every file opened for writing:
only ``quickstart`` writes (its diagram, into a new temporary directory),
and nothing lands in the working directory or the repository. Where the
JAX example is cheap at the same arguments (``monitored_circuit``,
``vqe_at_scale``, ``qec_memory``) it runs in-process; elsewhere the
reference is exact:

* ``quickstart``: GHZ counts and entropies, exact rho trace 1 within
  1e-6, the VQE minimum -3, Steane fidelity 1, GHZ-128 and twisted GHZ-100
  values (<X^100> = cos 0.7 to the printed 4 decimals), TFIM-24 DMRG
  energy against free fermions (rel 1e-4) and its gap (1e-2: chi 8, 3
  sweeps);
* ``error_mitigation``: the ideal <Z0> of the JAX ``Simulator`` state
  within 1e-5, ZNE within 1e-3 and exact-enumeration PEC within 1e-5 of
  it;
* ``monitored_circuit``: the half-cut entropies equal JAX's (the entropy
  of a stabilizer state does not depend on the measurement outcomes);
* ``open_system``: the dense curves within 1e-3 of the JAX
  ``LindbladSimulator`` (the printed 3 decimals), the MPS curves within 4
  printed standard errors + 0.025 of the dense ones;
* ``qec_memory``: logical rates within 5 standard errors of JAX's;
* ``quench_dynamics``: the final energy and <Z> profile of the JAX
  ``Simulator`` state of the same Trotter circuit (chi 8 is exact at
  n = 12) within the printed precision;
* ``quench_spectroscopy``: E0 and the gap against ``eigvalsh`` of the
  dense Hamiltonian within 1e-5 / 1e-4;
* ``vqe_at_scale``: the cost trajectory of the JAX example within 1e-4.
"""

import builtins
import contextlib
import io
import math
import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from quantum_simulator_tpu import QuantumCircuit as JCircuit
from quantum_simulator_tpu import Simulator as JSimulator
from quantum_simulator_tpu.lindblad import LindbladSimulator as JLindblad
from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
from quantum_simulator_tpu_torch.examples import (error_mitigation,
                                                  monitored_circuit,
                                                  open_system, qec_memory,
                                                  quench_dynamics,
                                                  quench_spectroscopy,
                                                  quickstart, vqe_at_scale)
from quantum_simulator_tpu_torch.models.hamiltonians import tfim_chain
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
NUM = r"[-+]?\d+\.\d*(?:e[-+]\d+)?"


def run_port(module, argv, cwd: Path) -> tuple[str, list[str]]:
    """The twin's stdout and the files it opened for writing, run from
    ``cwd`` (which must stay empty)."""
    written = []
    real_open = builtins.open

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    buf = io.StringIO()
    old = os.getcwd()
    builtins.open = recording_open
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main(argv + ["--device", "cpu"])
    finally:
        os.chdir(old)
        builtins.open = real_open
    assert rc == 0
    assert list(cwd.iterdir()) == []
    assert not any(Path(p).resolve().is_relative_to(REPO) for p in written)
    return buf.getvalue(), written


def run_jax(example: str, argv) -> str:
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [example] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(REPO / "examples" / example),
                           run_name="__main__")
    except SystemExit as e:
        assert not e.code
    finally:
        sys.argv = saved
    return buf.getvalue()


def nums(line: str) -> list[float]:
    return [float(x) for x in re.findall(NUM, line)]


def line_with(text: str, key: str) -> str:
    return next(ln for ln in text.splitlines() if key in ln)


def jax_state(circuit) -> np.ndarray:
    jc = JCircuit.from_dict(circuit.to_dict())
    return np.asarray(JSimulator().run(jc, shots=0).final_state.data)


def z_expectations(psi: np.ndarray, n: int) -> np.ndarray:
    p = np.abs(psi.reshape((2,) * n)) ** 2
    return np.array([p.sum(axis=tuple(a for a in range(n) if a != q))
                     @ [1.0, -1.0] for q in range(n)])


@pytest.fixture
def cwd(tmp_path):
    d = tmp_path / "cwd"
    d.mkdir()
    return d


def test_quickstart(cwd):
    out, written = run_port(quickstart, [], cwd)
    assert len(written) == 1 and written[0].endswith("ghz4.png")
    assert Path(written[0]).stat().st_size > 0
    counts = eval(line_with(out, "GHZ-4 counts:").split(":", 1)[1])
    assert set(counts) == {"0000", "1111"} and sum(counts.values()) == 1000
    assert nums(line_with(out, "bipartite entropy")) == [1.0, 1.0]
    noisy = eval(line_with(out, "noisy top counts:").split(":", 1)[1])
    assert max(noisy, key=noisy.get) in ("0000", "1111")
    assert 0 <= int(line_with(out, "noisiest column").split()[2]) <= 3
    assert nums(line_with(out, "VQE energy"))[0] == -3.0
    assert line_with(out, "Steane cycle").endswith("-> 1.000")
    trace, purity = nums(line_with(out, "exact noisy rho"))
    assert trace == pytest.approx(1.0, abs=1e-6) and 0.5 < purity < 1.0
    sharded = eval(line_with(out, "sharded GHZ counts:").split(":", 1)[1])
    assert set(sharded) <= {"0000", "1111"} and sum(sharded.values()) == 200
    first, last = nums(line_with(out, "sharded VQE"))
    assert last < first
    assert "['0000...', '1111...'] | half-cut entropy: 1.0 bit" in out
    twist = line_with(out, "twisted GHZ-100")
    assert "truncated weight: 0.0 " in twist
    assert nums(twist)[-1] == pytest.approx(round(math.cos(0.7), 4),
                                            abs=1e-4)
    e0, gap, ortho = nums(line_with(out, "TFIM-24 via DMRG"))
    m = np.diag(np.full(24, 1.3)) + np.diag(np.ones(23), 1)
    eps = np.linalg.svd(m, compute_uv=False)
    assert e0 == pytest.approx(-eps.sum(), rel=1e-4)
    assert gap == pytest.approx(2 * eps.min(), abs=1e-2)
    assert ortho < 1e-4
    ml, single = nums(line_with(out, "d=9 memory"))[-2:]
    assert ml <= single


def test_error_mitigation_against_exact(cwd):
    out, _ = run_port(error_mitigation, ["--n", "2", "--steps", "1"], cwd)
    psi = jax_state(error_mitigation.tfim_trotter_circuit(2, 1))
    ideal = float(z_expectations(psi, 2)[0])
    assert nums(line_with(out, "ideal <Z0>"))[0] == pytest.approx(
        ideal, abs=1e-5)
    assert nums(line_with(out, "ZNE"))[-2] == pytest.approx(ideal,
                                                             abs=1e-3)
    pec = line_with(out, "PEC")
    assert "exact enum" in pec
    assert nums(pec)[-2] == pytest.approx(ideal, abs=1e-5)


def test_monitored_circuit_entropies_equal_jax(cwd):
    argv = ["--qubits", "12", "--depth", "8", "--trajectories", "4",
            "--rates", "0.0,0.05,0.3"]
    out, _ = run_port(monitored_circuit, argv, cwd)
    want = run_jax("monitored_circuit.py", argv)

    def entropies(text):
        return [nums(ln)[1:3] for ln in text.splitlines()
                if "S(half-cut)" in ln]

    assert len(entropies(out)) == 3
    assert entropies(out) == entropies(want)


def test_open_system_against_dense_jax(cwd):
    out, _ = run_port(open_system, ["--n", "6", "--chi", "8", "--traj",
                                    "8", "--steps", "8"], cwd)
    H = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2])] + \
        [(0.6, "X", [q]) for q in range(3)]
    J = [(0.3, "sigma_minus", 0), (0.2, "z", 2)]
    dense = JLindblad(3, H, J).evolve(1.0, 100,
                                      observables=[("Z", [0]), ("X", [1])],
                                      record_every=25)
    lines = out.splitlines()
    for k, label in enumerate(("Z@[0]", "X@[1]")):
        i = next(i for i, ln in enumerate(lines) if ln.strip()
                 .startswith(label))
        got = np.array(nums(lines[i]))
        np.testing.assert_allclose(got, np.asarray(dense.expectations[k]),
                                   atol=1e-3)
        row = re.findall(r"\[([^\]]*)\]", lines[i + 1])
        mps, err = (np.array(r.split(), dtype=float) for r in row[:2])
        assert (np.abs(mps - got) <= 4 * err + 0.025).all()
    wide = [nums(ln) for ln in lines if ln.strip().startswith(("Z@[3]",
                                                               "ZZ@[3"))]
    assert len(wide) == 2 and all(abs(v) <= 1.0 for r in wide for v in r)


def test_qec_memory_matches_jax_in_law(cwd):
    argv = ["--trials", "512", "--rounds", "3", "--distances", "3,5",
            "--p", "0.05"]
    out, _ = run_port(qec_memory, argv + ["--surface", "--circuit"], cwd)
    want = run_jax("qec_memory.py", argv)
    T = 512

    def rates(text, key):
        return [nums(ln)[0] for ln in text.splitlines()
                if key in ln and "d=" in ln]

    for key in ("logical=", "ML "):
        for a, b in zip(rates(want, key), rates(out, key)):
            assert abs(a - b) <= 5 * math.sqrt(
                (a * (1 - a) + b * (1 - b)) / T) + 1e-12, (key, a, b)
    for ln in out.splitlines():
        if "matching" in ln and "d=" in ln or "uncorrected" in ln:
            assert all(0.0 <= v <= 1.0 for v in nums(ln)[:2])


def test_quench_dynamics_against_exact_state(cwd):
    n = 12
    out, _ = run_port(quench_dynamics, ["--qubits", str(n), "--chi", "8",
                                        "--frames", "2",
                                        "--steps-per-frame", "2"], cwd)
    psi = jax_state(AlgorithmTemplate.tfim_quench(n, time=2.0, steps=4,
                                                  j=-1.0, h=-0.6))
    zs = z_expectations(psi, n)
    profile = "".join("#" if z > 0.5 else ("." if z < -0.5 else "~")
                      for z in zs)
    assert line_with(out, "t= 2.0").split()[2] == profile
    probs = np.abs(psi) ** 2
    energy = 0.0
    for c, p, qs in tfim_chain(n, j=-1.0, h=-0.6):
        if p == "ZZ":
            energy += c * float(probs @ _zz_signs(n, *qs))
        else:
            energy += c * _x_expectation(psi, n, qs[0])
    assert nums(line_with(out, "final <H>"))[0] == pytest.approx(
        energy, abs=1e-4)


def _zz_signs(n: int, a: int, b: int) -> np.ndarray:
    idx = np.arange(1 << n)
    za = 1 - 2 * ((idx >> (n - 1 - a)) & 1)
    zb = 1 - 2 * ((idx >> (n - 1 - b)) & 1)
    return (za * zb).astype(float)


def _x_expectation(psi: np.ndarray, n: int, q: int) -> float:
    flipped = psi.reshape(-1)[np.arange(1 << n) ^ (1 << (n - 1 - q))]
    return float(np.real(np.vdot(psi, flipped)))


def test_quench_spectroscopy_against_eigvalsh(cwd):
    n, g = 6, 1.5
    out, _ = run_port(quench_spectroscopy, ["--n", str(n), "--chi", "8",
                                            "--t", "6", "--steps", "60"],
                      cwd)
    terms = [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)] \
        + [(-g, "X", [i]) for i in range(n)]
    from quantum_simulator_tpu_torch.lindblad import _pauli_term_matrix
    H = 0
    for c, p, qs in terms:
        full = ["I"] * n
        for ch, q in zip(p, qs):
            full[q] = ch
        H = H + c * _pauli_term_matrix("".join(full))
    w = np.linalg.eigvalsh(H)
    assert nums(line_with(out, "DMRG ground state"))[0] == pytest.approx(
        w[0], abs=1e-5)
    assert nums(line_with(out, "DMRG first gap"))[0] == pytest.approx(
        w[1] - w[0], abs=1e-4)
    assert line_with(out, "FFT peak vs").endswith("True)")


def test_vqe_at_scale_matches_jax(cwd):
    argv = ["--qubits", "4", "--iters", "4"]
    out, _ = run_port(vqe_at_scale, argv, cwd)
    want = run_jax("vqe_at_scale.py", argv)

    def costs(text):
        return [nums(ln)[0] for ln in text.splitlines() if "cost =" in ln]

    assert len(costs(out)) == 4
    np.testing.assert_allclose(costs(out), costs(want), atol=1e-4)
    mps_out, _ = run_port(vqe_at_scale, ["--qubits", "6", "--engine",
                                         "mps", "--chi", "8", "--iters",
                                         "2"], cwd)
    vqe, target = (nums(line_with(mps_out, key))[0]
                   for key in ("optimal cost", "DMRG ground-state target"))
    assert target <= vqe + 1e-6
