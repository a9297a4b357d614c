"""The complex128 verification mode on the large-state path (n >= 30 and
vec(rho) at 2n >= 30), on the CPU.

The n >= 30 code paths depend on the size only through their chunk
counts, so the route is forced at n = 9-10 (vec(rho) at n = 5): the
``huge`` fixture lowers ``bigstate.HUGE_MIN_QUBITS`` to 8, counts every
state as big (``plan.INPLACE_MIN_BYTES = 0``) and cuts a chunk to 128
elements, so every chunked step and every chunked reduction runs over
several pieces (as ``tests/test_torch_bigstate.py`` forces them). Every
case runs under ``config.enable_complex128()`` and checks that what it
returns is float64 / complex128. Held:

* against the JAX package's complex128 mode, 1e-12 (its references from
  one subprocess, JAX's x64 switch being process-wide): the final planes
  of a planar Ry/Rz and a real Ry+CNOT brickwork, their axis marginals
  and qubit probabilities, Z and Pauli strings on them and on GHZ,
  ``run_step_by_step``'s marginal snapshots against JAX's step states,
  vec(rho) through ``SuperopDensityResult`` (diagonal, purity, trace)
  against JAX's superoperator route, and the optimizer's row-by-row
  cost against ``<H>`` of JAX's states; the two-level sampler's Z / X / Y
  laws against JAX's probabilities, total variation distance < 0.08 at
  40000 shots over 1024 outcomes (the bound of
  ``tests/test_torch_bigstate.py``);
* against a NumPy complex128 replay of the same branches, 1e-12 after
  aligning each trajectory's global phase: the three n >= 30 trajectory
  routes (unitary splice, monomial splice, fold), ``Simulator.run`` and
  ``run_with_noise`` with noise (their generators reproduced, the shots
  drawn again from the replayed state), the monitored sampler and the
  Gram reduction of ``ensemble_qubit_density_matrices``.

1e-12: float64 sums of at most a few thousand terms, taken in another
order than JAX's einsums or the replay's tensordots.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import build_circuit_dict
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import config, models
from quantum_simulator_tpu_torch import optimizer as topt
from quantum_simulator_tpu_torch.density import SuperopDensityResult
from quantum_simulator_tpu_torch.ops import bigstate, bigtraj
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.utils.seeding import generator_from_rng
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
TVD = 0.08
SHOTS = 40000

# (n, depth, seed, mix_rz) of the brickworks held against JAX
BRICKS = {"planar": (10, 8, 3, True), "real": (9, 8, 5, False)}
GHZ_N = 9
SUPEROP = {"planar": (5, 4, 2, True), "real": (5, 4, 4, False)}
OPT = (9, 1, 3)       # hardware_efficient_ansatz(n, layers), rows


def _ghz(n):
    c = tq.QuantumCircuit(n)
    c.add("H", [0], [], 0)
    for q in range(n - 1):
        c.add("CNOT", [q, q + 1], [], q + 1)
    return c


def _circuit(name):
    if name == "ghz":
        return _ghz(GHZ_N)
    return tq.QuantumCircuit.from_dict(build_circuit_dict(*BRICKS[name]))


def _noise_model():
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(0.05))
    nm.add_gate_noise("CNOT", tq.AmplitudeDampingNoise(0.1))
    return nm


def _optimizer_case():
    """(config, rows of bound values (R, K), full parameter rows, H)."""
    n, layers, n_rows = OPT
    circuit = models.hardware_efficient_ansatz(n, layers)
    cfg = tq.ParameterizedCircuitConfig.auto_detect(circuit)
    program, offsets = cfg.compiled()
    values = np.random.default_rng(8).uniform(-np.pi, np.pi,
                                              (n_rows, len(offsets)))
    rows = np.tile(program.initial_params, (n_rows, 1))
    rows[:, offsets] = values
    H = np.zeros((1 << n, 1 << n), complex)
    for coeff, pstr, qubits in models.heisenberg_chain(n):
        H += coeff * _pauli_matrix(n, qubits, pstr)
    return cfg, values, rows, H


_PAULI = {"X": np.array([[0, 1], [1, 0]], complex),
          "Y": np.array([[0, -1j], [1j, 0]]),
          "Z": np.diag([1.0 + 0j, -1.0])}


def _pauli_matrix(n, qubits, paulis):
    ops = [np.eye(2)] * n
    for p, q in zip(paulis, qubits):
        ops[q] = _PAULI[p] @ ops[q]
    out = ops[0]
    for o in ops[1:]:
        out = np.kron(out, o)
    return out


_JAX_SCRIPT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from quantum_simulator_tpu.config import enable_complex128
enable_complex128()
import numpy as np
import jax.numpy as jnp
from quantum_simulator_tpu import (DensityMatrixSimulator, NoiseModel,
                                   QuantumCircuit)
from quantum_simulator_tpu.ops import program as prog

spec = json.load(open(sys.argv[1]))
out = {}
for name, d in spec["states"].items():
    p = prog.compile_circuit(QuantumCircuit.from_dict(d))
    out[name] = np.asarray(prog.forward_fn(p)(jnp.asarray(p.initial_params)))
p = prog.compile_circuit(QuantumCircuit.from_dict(spec["states"]["planar"]))
out["steps"] = np.asarray(jax.jit(lambda q: prog._steps_body(
    p, q, jnp.complex128))(jnp.asarray(p.initial_params)))
nm = NoiseModel.from_dict(spec["noise"])
for name, d in spec["superop"].items():
    out["superop-" + name] = np.asarray(DensityMatrixSimulator(nm).run(
        QuantumCircuit.from_dict(d), method="superop").rho)
p = prog.compile_circuit(QuantumCircuit.from_dict(spec["optimizer"]))
out["optimizer"] = np.asarray(prog.batched_forward_fn(p)(
    jnp.asarray(spec["optimizer_rows"])))
assert all(v.dtype == np.complex128 for v in out.values())
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("c128huge")
    spec = {"states": {name: _circuit(name).to_dict()
                       for name in ("planar", "real", "ghz")},
            "noise": _noise_model().to_dict(),
            "superop": {name: build_circuit_dict(*v)
                        for name, v in SUPEROP.items()},
            "optimizer": _optimizer_case()[0].circuit.to_dict(),
            "optimizer_rows": _optimizer_case()[2].tolist()}
    (d / "spec.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "spec.json"),
         str(d / "refs.npz")], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(d / "refs.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True)
def huge(monkeypatch):
    """Complex128 mode, the large-state route from n = 8 and every pass
    chunked over pieces of 128 elements."""
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 8)
    monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
    monkeypatch.setattr(tplan, "CHUNK_ELEMS", 128)
    config.enable_complex128()
    try:
        yield
    finally:
        config.enable_complex64()


def _flat(x: torch.Tensor, planar: bool) -> np.ndarray:
    """(2^n,) complex128 of a grouped (planar or real) state."""
    if planar:
        return x[0].reshape(-1).numpy() + 1j * x[1].reshape(-1).numpy()
    return x.reshape(-1).numpy().astype(np.complex128)


def _grouped(psi: np.ndarray, layout, planar: bool) -> torch.Tensor:
    """The grouped tensor of a (2^n,) complex state; real: its real part
    (the caller aligned the global phase)."""
    shape = tuple(layout.axis_sizes)
    if planar:
        return torch.from_numpy(np.stack([psi.real, psi.imag])).reshape(
            (2,) + shape)
    assert np.abs(psi.imag).max() < TOL
    return torch.from_numpy(psi.real.copy()).reshape(shape)


def _axis_marginals(psi: np.ndarray, layout) -> list[np.ndarray]:
    p = (np.abs(psi) ** 2).reshape(layout.axis_sizes)
    return [p.sum(axis=tuple(a for a in range(p.ndim) if a != ax))
            for ax in range(p.ndim)]


def _qubit_probs(psi: np.ndarray, n: int) -> np.ndarray:
    p = np.abs(psi) ** 2
    idx = np.arange(1 << n)
    return np.array([p[(idx >> (n - 1 - q)) & 1 == 1].sum()
                     for q in range(n)])


def _apply_np(psi, u, targets, n):
    """``u`` on ``targets`` (first = MSB of u's index) of (2^n,) ``psi``."""
    k = len(targets)
    t = np.tensordot(u.reshape((2,) * (2 * k)), psi.reshape((2,) * n),
                     axes=(list(range(k, 2 * k)), list(targets)))
    return np.moveaxis(t, list(range(k)), list(targets)).reshape(-1)


def _expect(psi, qubits, paulis, n) -> float:
    phi = psi
    for p, q in zip(paulis, qubits):
        phi = _apply_np(phi, _PAULI[p], (q,), n)
    return float(np.real(np.vdot(psi, phi)))


def _huge_state(result, n, planar):
    fs = result.final_state
    assert isinstance(fs, tq.PlanarStateVector)
    assert fs.is_planar == planar and fs.num_qubits == n
    assert fs.state_data.dtype == torch.float64
    return fs


# ---------------------------------------------------------------------------
# Against JAX's complex128 mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BRICKS))
def test_final_planes_and_marginals_match_jax(jax_refs, name):
    n = BRICKS[name][0]
    planar = name == "planar"
    fs = _huge_state(tq.Simulator(device="cpu").run(_circuit(name),
                                                    shots=0), n, planar)
    want = jax_refs[name]
    assert np.abs(_flat(fs.state_data, planar) - want).max() < TOL
    layout = tplan.GroupLayout.for_qubits(n)
    got = bigstate.state_axis_marginals(fs.state_data, planar)
    assert all(m.dtype == torch.float64 for m in got)
    for g, w in zip(got, _axis_marginals(want, layout)):
        assert np.abs(g.numpy() - w).max() < TOL
    qp = fs.qubit_probabilities()
    assert qp.dtype == np.float64
    assert np.abs(qp - _qubit_probs(want, n)).max() < TOL
    assert abs(fs.norm_sq() - 1.0) < TOL
    probs = fs.probabilities_device
    assert probs.dtype == torch.float64
    assert np.abs(probs.numpy() - np.abs(want) ** 2).max() < TOL
    j = int(np.argmax(np.abs(want)))
    assert abs(fs.amplitude(j) - want[j]) < TOL


STRINGS = [([0], "Z"), ([7, 8], "ZZ"), ([0, 8], "ZZ"), ([0, 5, 8], "ZZZ"),
           ([0, 1], "XX"), ([1, 8], "XY"), ([0, 4, 8], "YZX"),
           (list(range(GHZ_N)), "X" * GHZ_N),
           (list(range(GHZ_N)), "YY" + "X" * (GHZ_N - 2))]


@pytest.mark.parametrize("name", ["ghz", "planar", "real"])
def test_strings_match_jax(jax_refs, name):
    circuit = _circuit(name)
    n = circuit.num_qubits
    fs = tq.Simulator(device="cpu").run(circuit, shots=0).final_state
    assert fs.state_data.dtype == torch.float64
    want = jax_refs[name]
    for qubits, paulis in STRINGS:
        qubits = [q for q in qubits if q < n]
        paulis = paulis[:len(qubits)]
        ref = _expect(want, qubits, paulis, n)
        if set(paulis) == {"Z"}:
            got = (fs.expectation_z(qubits[0]) if len(qubits) == 1
                   else fs.expectation_z_string(qubits))
        else:
            got = fs.expectation_pauli_string(qubits, paulis)
        assert abs(got - ref) < TOL, (qubits, paulis, got, ref)
    if name == "ghz":   # the known values
        assert abs(fs.expectation_pauli_string(
            list(range(n)), "X" * n) - 1.0) < TOL
        assert abs(fs.expectation_z_string([0, n - 1]) - 1.0) < TOL


def test_step_marginals_match_jax(jax_refs):
    circuit = _circuit("planar")
    n = circuit.num_qubits
    layout = tplan.GroupLayout.for_qubits(n)
    steps = list(tq.Simulator(device="cpu").run_step_by_step(circuit))
    want = jax_refs["steps"]
    assert [c for _, c in steps] == list(range(-1, want.shape[0] - 1))
    for (snap, _), psi in zip(steps, want):
        assert isinstance(snap, bigstate.MarginalStateSummary)
        assert all(m.dtype == torch.float64 for m in snap.axis_marginals)
        for g, w in zip(snap.axis_marginals, _axis_marginals(psi, layout)):
            assert np.abs(g.numpy() - w).max() < TOL
        assert np.abs(snap.qubit_probabilities()
                      - _qubit_probs(psi, n)).max() < TOL


@pytest.mark.parametrize("name", sorted(SUPEROP))
def test_superop_result_matches_jax(jax_refs, name, monkeypatch):
    """vec(rho) at 2n = 10 with the large-state route lowered to 10: a
    ``SuperopDensityResult`` over a float64 grouped state."""
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    n = SUPEROP[name][0]
    res = tq.DensityMatrixSimulator(_noise_model(), device="cpu").run(
        tq.QuantumCircuit.from_dict(build_circuit_dict(*SUPEROP[name])),
        method="superop")
    assert isinstance(res, SuperopDensityResult)
    assert res.is_planar == (name == "planar")
    assert res.state_data.dtype == torch.float64
    rho = jax_refs["superop-" + name]
    probs = res.probabilities
    assert probs.dtype == np.float64
    assert np.abs(probs - np.real(np.diag(rho))).max() < TOL
    assert abs(res.trace() - np.real(np.trace(rho))) < TOL
    assert abs(res.purity() - np.real(np.trace(rho @ rho))) < TOL
    z = np.diag(rho).real @ (1.0 - 2.0 * ((np.arange(1 << n) >> (n - 1))
                                          & 1))
    assert abs(res.expectation_z(0) - z / np.trace(rho).real) < TOL


def test_optimizer_cost_matches_jax(jax_refs, monkeypatch):
    """From ``HUGE_QUBITS`` on a cost is one ``Simulator.run`` per row,
    read through the ``PlanarStateVector``'s Pauli strings."""
    monkeypatch.setattr(topt, "HUGE_QUBITS", 8)
    cfg, values, _, H = _optimizer_case()
    cost = tq.CostFunction.vqe_hamiltonian(models.heisenberg_chain(OPT[0]))
    got = topt.GradientEstimator._batched_costs(cfg, cost, values,
                                                device="cpu")
    states = jax_refs["optimizer"]
    want = np.real(np.einsum("bi,ij,bj->b", states.conj(), H, states))
    assert got.dtype == np.float64
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("basis", ["Z", "X", "Y"])
def test_sampler_law_matches_jax(jax_refs, basis):
    circuit = _circuit("planar")
    n = circuit.num_qubits
    psi = jax_refs["planar"]
    rot = {"Z": np.eye(2), "X": np.array([[1, 1], [1, -1]]) / np.sqrt(2),
           "Y": np.array([[1, -1j], [1, 1j]]) / np.sqrt(2)}[basis]
    for q in range(n):
        psi = _apply_np(psi, rot, (q,), n)
    res = tq.Simulator(device="cpu").run(
        circuit, shots=SHOTS, seed=11,
        measurement_basis=tq.MeasurementBasis[basis])
    _huge_state(res, n, True)
    emp = np.zeros(1 << n)
    for bits, count in res.measurement_counts.items():
        emp[int(bits, 2)] = count
    assert emp.sum() == SHOTS
    assert 0.5 * np.abs(emp / SHOTS - np.abs(psi) ** 2).sum() < TVD


# ---------------------------------------------------------------------------
# Against a NumPy complex128 replay of the same branches
# ---------------------------------------------------------------------------

class _XBasisDamping(tq.NoiseChannel):
    """Amplitude damping conjugated by H: neither mixed-unitary nor
    monomial, so it takes the fold executor."""

    def __init__(self, g):
        self._g = g

    @property
    def probability(self):
        return self._g

    def get_kraus_operators(self):
        h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
        return [h @ k @ h for k in
                tq.AmplitudeDampingNoise(self._g).get_kraus_operators()]


ROUTE_CHANNELS = {
    "unitary": lambda: tq.DepolarizingNoise(0.2),
    "monomial": lambda: tq.AmplitudeDampingNoise(0.3),
    "fold": lambda: _XBasisDamping(0.3),
}


def _route_model(route):
    nm = tq.NoiseModel()
    nm.add_global_noise(ROUTE_CHANNELS[route]())
    return nm


def _replay(program, noise_model, table: np.ndarray) -> np.ndarray:
    """(T, 2^n) complex128 states: every gate, then after it every
    channel's drawn Kraus operator on each target in the per-gate body's
    order (column d of ``table``), normalized once."""
    n = program.num_qubits
    out = []
    for row in table:
        psi = np.zeros(1 << n, complex)
        psi[program.initial_index] = 1.0
        d = 0
        for op in program.ops:
            psi = _apply_np(psi, program.op_matrix(op, program.initial_params,
                                                   np.complex128),
                            op.targets, n)
            for st in noise_model.kraus_stacks_for_gate(op.gate_name):
                for q in op.targets:
                    psi = _apply_np(psi, np.asarray(st, complex)[row[d]],
                                    (q,), n)
                    d += 1
        out.append(psi / np.linalg.norm(psi))
    return np.stack(out)


def _natural_table(program, nm, draws) -> np.ndarray:
    """The branch indices of a route's ``draws`` in the per-gate order."""
    if isinstance(draws, torch.Tensor):
        return draws.numpy()
    spec = tmt.monomial_spec(program, nm)
    table = np.zeros((draws[0][1].shape[0], spec.n_site_keys), np.int64)
    for window, (_, branches) in zip(spec.windows, draws):
        for si, site in enumerate(window):
            table[:, site.key_index] = branches[:, si].numpy()
    return table


def _aligned(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``want`` (T, 2^n) rotated by the global phase that best matches
    ``got`` row by row."""
    phase = np.sum(np.conj(want) * got, axis=1)
    return want * (phase / np.abs(phase))[:, None]


def _replayed(program, nm, generator, n_traj=1):
    """``(x, planar, replay aligned to x)``: one evolution of the
    n >= 30 trajectory body with ``generator``, and its draws replayed in
    NumPy."""
    x, planar, draws = bigtraj.huge_trajectory_state_body(
        program, nm, program.initial_params, n_traj, "cpu", generator)
    assert x.dtype == torch.float64
    got = np.stack([_flat(x[t], planar) for t in range(n_traj)])
    want = _aligned(got, _replay(program, nm,
                                 _natural_table(program, nm, draws)))
    assert np.abs(got - want).max() < TOL
    return x, planar, want


@pytest.mark.parametrize("mix_rz", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("route", sorted(ROUTE_CHANNELS))
def test_huge_route_matches_numpy_replay(route, mix_rz):
    nm = _route_model(route)
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        build_circuit_dict(9, 4, 11, mix_rz)))
    assert bigtraj.trajectory_evolve_route(program, nm) == route
    _, planar, _ = _replayed(program, nm, torch.Generator().manual_seed(5),
                             n_traj=3)
    assert planar == mix_rz


def _shots(indices_fn, counts: dict) -> None:
    """``counts`` equal the ``{bitstring: count}`` of ``indices_fn()``."""
    idx = indices_fn()
    assert idx.dtype == torch.int64
    assert counts == bigstate.indices_to_counts(idx, len(next(iter(counts))))


@pytest.mark.parametrize("basis", ["Z", "Y"])
def test_noisy_run_matches_numpy_replay(basis):
    """``Simulator.run`` with amplitude damping on a real brickwork: its
    trajectory generator reproduced, the final state against the replay
    (Z) and the shots drawn again from the replayed state (Y: rotated
    after a zero imaginary plane is stacked)."""
    nm = _route_model("monomial")
    circuit = tq.QuantumCircuit.from_dict(build_circuit_dict(9, 4, 7, False))
    program = tprog.compile_circuit(circuit)
    res = tq.Simulator(nm, device="cpu").run(
        circuit, shots=500, seed=13,
        measurement_basis=tq.MeasurementBasis[basis])
    rng = np.random.default_rng(13)
    _, planar, want = _replayed(program, nm, generator_from_rng(rng, "cpu"))
    assert not planar
    layout = tplan.GroupLayout.for_qubits(9)
    fs = _huge_state(res, 9, False)
    if basis == "Z":
        got = _flat(fs.state_data, False)
        assert np.abs(got - _aligned(got[None], want)[0]).max() < TOL
        assert all(m.dtype == torch.float64 for m in fs._axis_marginals)
    psi = want[0]
    if basis == "Y":
        rot = np.array([[1, -1j], [1, 1j]]) / np.sqrt(2)
        for q in range(9):
            psi = _apply_np(psi, rot, (q,), 9)
    sample_gen = generator_from_rng(rng, "cpu")
    _shots(lambda: bigstate.sample_state_indices(
        _grouped(psi, layout, basis == "Y"), 500, basis == "Y",
        sample_gen), res.measurement_counts)


def test_run_with_noise_matches_numpy_replay():
    """Three trajectories, 7 shots over them: each drawn again from its
    replayed state with the entry point's generators."""
    nm = _route_model("unitary")
    circuit = tq.QuantumCircuit.from_dict(build_circuit_dict(9, 4, 9, True))
    program = tprog.compile_circuit(circuit)
    res = tq.Simulator(nm, device="cpu").run_with_noise(
        circuit, shots=7, seed=17, trajectories=3)
    assert res.final_state is None
    rng = np.random.default_rng(17)
    layout = tplan.GroupLayout.for_qubits(9)
    idx = []
    for take in (3, 2, 2):
        _, planar, want = _replayed(program, nm,
                                    generator_from_rng(rng, "cpu"))
        idx.append(bigstate.sample_state_indices(
            _grouped(want[0], layout, planar), take, planar,
            generator_from_rng(rng, "cpu")))
    _shots(lambda: torch.cat(idx), res.measurement_counts)


def _monitored_circuit():
    """A depth-6 Ry/Rz brickwork with qubit 3 measured after its third
    layer and qubit 8 at the end."""
    d = build_circuit_dict(9, 6, 2, True)
    for g in d["gates"]:
        g["column"] += int(g["column"] >= 3)
    c = tq.QuantumCircuit.from_dict(d)
    c.add("Measure", [3], [], 3)
    c.add("Measure", [8], [], 7)
    return c


def test_monitored_sampler_matches_numpy_replay():
    """``monitored_trajectories`` at n >= 30: each trajectory's outcomes,
    its collapsed state against the projector replay, and its final shots
    drawn again from the replayed state."""
    circuit = _monitored_circuit()
    outs, sites, counts = tq.Simulator(device="cpu").monitored_trajectories(
        circuit, 3, seed=19, final_shots=50)
    assert [q for _, q in sites] == [3, 8] and len(counts) == 3
    program = tprog.compile_circuit(circuit)
    events = tuple(_events(circuit))
    n, layout = 9, tplan.GroupLayout.for_qubits(9)
    planar = not tmt.monomial_spec(program, tprog._NoNoise, events).real
    rng = np.random.default_rng(19)
    for t in range(3):
        x = tplan.layout_basis_state(layout, program.initial_index, "cpu",
                                     planar, 1)
        x, got_outs, _ = tmt.monomial_monitored_evolve(
            program, tprog._NoNoise, events, program.initial_params, x,
            generator_from_rng(rng, "cpu"))
        assert x.dtype == torch.float64
        assert got_outs[0].tolist() == outs[t].tolist()
        psi = np.zeros(1 << n, complex)
        psi[program.initial_index] = 1.0
        for pos in range(len(program.ops) + 1):
            for ei, (at, q) in enumerate(events):
                if at == pos:
                    proj = np.diag([1.0, 0.0] if outs[t, ei] == 0
                                   else [0.0, 1.0])
                    psi = _apply_np(psi, proj, (q,), n)
            if pos < len(program.ops):
                op = program.ops[pos]
                psi = _apply_np(psi, program.op_matrix(
                    op, program.initial_params, np.complex128),
                    op.targets, n)
        got = _flat(x[0], planar)
        want = _aligned(got[None], (psi / np.linalg.norm(psi))[None])[0]
        assert np.abs(got - want).max() < TOL
        sample_gen = generator_from_rng(rng, "cpu")
        _shots(lambda: bigstate.sample_state_indices(
            _grouped(want, layout, planar), 50, planar, sample_gen),
            counts[t])


def _events(circuit):
    events, pos = [], 0
    for column in circuit.get_ordered_gates():
        for g in column:
            if g.gate_name == "Measure":
                events.append((pos, g.target_qubits[0]))
            else:
                pos += 1
    return events


@pytest.mark.parametrize("route", ["monomial", "fold"])
def test_gram_reduction_matches_numpy_replay(route):
    """``ensemble_qubit_density_matrices`` at n >= 30 (one trajectory at a
    time through the per-axis Grams) against the mean of the replayed
    trajectories' single-qubit reduced density matrices."""
    nm = _route_model(route)
    circuit = tq.QuantumCircuit.from_dict(build_circuit_dict(9, 4, 3, True))
    program = tprog.compile_circuit(circuit)
    got = tq.Simulator(nm, device="cpu").ensemble_qubit_density_matrices(
        circuit, n_trials=2, seed=23)
    assert got.dtype == np.complex128 and got.shape == (9, 2, 2)
    rng = np.random.default_rng(23)
    want = np.zeros((9, 2, 2), complex)
    for _ in range(2):
        _, _, psi = _replayed(program, nm, generator_from_rng(rng, "cpu"))
        for q in range(9):
            s = psi[0].reshape(1 << q, 2, -1)
            want[q] += np.einsum("apb,aqb->pq", s, s.conj()) / 2
    assert np.abs(got - want).max() < TOL
