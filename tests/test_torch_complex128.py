"""The port's complex128 verification mode on the CPU.

``config.enable_complex128()`` makes the statevector family compute in
float64 planes (complex128 amplitudes) up to n = 31 (the n >= 30 path and
vec(rho) at 2n >= 30: ``tests/test_torch_complex128_huge.py``). Held here,
every case restoring ``enable_complex64()``:

* against the JAX package's own complex128 mode, 1e-12: the 3-qubit
  circuit of ``tests/test_edge_cases.py`` (also against its analytic
  state), depth-20 Ry/Rz/CNOT brickworks at n = 10 and n = 20 through the
  forward, step recording at n = 8 and four parameter rows at n = 10. JAX's
  x64 switch is process-wide, so its references come from one subprocess
  (as in ``test_edge_cases.py``);
* each trajectory route (unitary splice, monomial splice, fold, per-gate)
  fed a fixed branch table, against a NumPy complex128 replay of the same
  branches, 1e-12 after aligning each trajectory's global phase (the real
  trajectories use phase-real Kraus forms); the per-gate body also fed
  JAX's own draws (its complex128 ``_trajectory_body``), 1e-12;
* the other families JAX's mode reaches: ``DensityMatrixSimulator`` (both
  routes), ``LindbladSimulator``, the debugger and the optimizer's cost
  and gradients (against ``<H>`` of JAX's complex128 states), 1e-12 (the
  mesh and the MPS family: ``tests/test_torch_complex128_mesh_mps.py``);
* the routes: an n = 32 call raises under the mode (its float64 planar
  state is 64 GiB), a float64 state with a float32 operator raises, and
  with the mode off the operands and states (the mesh's and the MPS
  engine's too) are float32 / complex64 and the same bit for bit as
  before a complex128 round trip.

1e-12: float64 sums of at most a few hundred terms, taken in another
order than JAX's einsums; the complex64 engine is 1e-8 - 1e-7 off.
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
from quantum_simulator_tpu_torch.ops import bigstate, cuda_exec
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.ops import unitary_traj as tut
from quantum_simulator_tpu_torch.ops.bigtraj import fold_trajectory_body
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12

# (name, n, depth, seed) of each Ry/Rz/CNOT brickwork held against JAX
FORWARD_CASES = [("fwd10", 10, 20, 3), ("fwd20", 20, 20, 3)]
STEPS_CASE = (8, 12, 5)
BATCH_CASE = (10, 12, 7)
BATCH_ROWS = np.random.default_rng(1).uniform(-np.pi, np.pi, (4, 60))

_JAX_SCRIPT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from quantum_simulator_tpu.config import enable_complex128
enable_complex128()
import numpy as np
import jax.numpy as jnp
from quantum_simulator_tpu import GateInstance, QuantumCircuit, Simulator
from quantum_simulator_tpu.ops import program as prog

spec = json.load(open(sys.argv[1]))
out = {}
c = QuantumCircuit(3)
c.add_gate(GateInstance("H", [0], [], column=0))
c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
c.add_gate(GateInstance("Rz", [2], [0.7], column=1))
out["three"] = Simulator().run(c, shots=0).final_state.data
for name, d in spec["forward"].items():
    p = prog.compile_circuit(QuantumCircuit.from_dict(d))
    out[name] = np.asarray(prog.forward_fn(p)(jnp.asarray(p.initial_params)))
p = prog.compile_circuit(QuantumCircuit.from_dict(spec["steps"]))
out["steps"] = np.asarray(jax.jit(lambda q: prog._steps_body(
    p, q, jnp.complex128))(jnp.asarray(p.initial_params)))
p = prog.compile_circuit(QuantumCircuit.from_dict(spec["batch"]))
rows = np.asarray(spec["rows"])[:, :p.num_params]
out["batch"] = np.asarray(prog.batched_forward_fn(p)(jnp.asarray(rows)))
a = spec["audit"]
from quantum_simulator_tpu import (DensityMatrixSimulator, LindbladSimulator,
                                   NoiseModel)
from quantum_simulator_tpu.debugger import CircuitDebugger
out["density"] = np.asarray(DensityMatrixSimulator(NoiseModel.from_dict(
    a["noise"])).run(QuantumCircuit.from_dict(a["density"])).rho)
lind = LindbladSimulator(3, [tuple(t) for t in a["lindblad"]["terms"]],
                         [tuple(j) for j in a["lindblad"]["jumps"]])
psi = np.asarray(a["lindblad"]["psi"][0]) + 1j * np.asarray(
    a["lindblad"]["psi"][1])
out["lindblad"] = np.asarray(lind.evolve(
    a["lindblad"]["t"], a["lindblad"]["steps"], initial=psi).final.rho)
out["debugger"] = np.stack([s.state.data for s in CircuitDebugger()
                            .run_full_debug(QuantumCircuit.from_dict(
                                a["debugger"]))])
p = prog.compile_circuit(QuantumCircuit.from_dict(a["optimizer"]))
out["optimizer"] = np.asarray(prog.batched_forward_fn(p)(
    jnp.asarray(a["optimizer_rows"])))
# JAX's per-gate trajectory body (its route off the TPU), every
# categorical draw returned beside the state
recorded = []
categorical = jax.random.categorical


def recording(key, logits, *args, **kwargs):
    recorded.append(categorical(key, logits, *args, **kwargs))
    return recorded[-1]


def traj(key):
    recorded.clear()
    state = prog._trajectory_body(p, nm.kraus_stacks_for_gate,
                                  jnp.asarray(p.initial_params), key,
                                  jnp.complex128, False)
    return state, jnp.stack(recorded)


jax.random.categorical = recording
nm = NoiseModel.from_dict(a["noise"])
p = prog.compile_circuit(QuantumCircuit.from_dict(a["trajectory"]))
states, draws = jax.jit(jax.vmap(traj))(jax.random.split(
    jax.random.PRNGKey(5), 4))
jax.random.categorical = categorical
out["trajectory"] = np.asarray(states)
assert all(v.dtype == np.complex128 for v in out.values())
out["trajectory_draws"] = np.asarray(draws)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True)
def complex128_mode():
    config.enable_complex128()
    try:
        yield
    finally:
        config.enable_complex64()


def _circuit(n, depth, seed):
    return build_circuit_dict(n, depth, seed, mix_rz=True)


# ---------------------------------------------------------------------------
# The audit's inputs: the other families held to JAX's complex128 mode
# ---------------------------------------------------------------------------

LINDBLAD = {"terms": [(0.8, "ZZ", [0, 1]), (0.6, "XY", [1, 2]),
                      (0.5, "X", [0])],
            "jumps": [(0.2, "sigma_minus", 2), (0.1, "sigma_plus", 0)],
            "t": 0.8, "steps": 20}
LINDBLAD_PSI = np.random.default_rng(3).normal(size=(2, 8))


def _noise_model():
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(0.05))
    nm.add_global_noise(tq.AmplitudeDampingNoise(0.1))
    return nm


def _optimizer_case():
    """(circuit, config, values, rows, H): Ry ansatz rows at ``values``
    and at each +-pi/2 shift of every bound parameter, H dense."""
    circuit = models.hardware_efficient_ansatz(6, 2)
    cfg = tq.ParameterizedCircuitConfig.auto_detect(circuit)
    program, offsets = cfg.compiled()
    values = np.random.default_rng(8).uniform(-np.pi, np.pi, len(offsets))
    shifts = [np.zeros_like(values)]
    for i in range(len(values)):
        for sign in (1, -1):
            d = np.zeros_like(values)
            d[i] = sign * np.pi / 2
            shifts.append(d)
    rows = np.tile(program.initial_params, (len(shifts), 1))
    rows[:, offsets] = values + np.stack(shifts)
    paulis = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
              "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1, -1])}
    H = np.zeros((64, 64), complex)
    for coeff, pstr, qubits in models.heisenberg_chain(6):
        ops = [paulis["I"]] * 6
        for ch, q in zip(pstr, qubits):
            ops[q] = paulis[ch] @ ops[q]
        term = ops[0]
        for o in ops[1:]:
            term = np.kron(term, o)
        H += coeff * term
    return circuit, cfg, values, rows, H


def _audit_spec():
    return {"noise": _noise_model().to_dict(),
            "density": build_circuit_dict(4, 6, 9, True),
            "lindblad": {**LINDBLAD, "psi": (LINDBLAD_PSI / np.linalg.norm(
                LINDBLAD_PSI[0] + 1j * LINDBLAD_PSI[1])).tolist()},
            "debugger": build_circuit_dict(6, 8, 4, True),
            "trajectory": build_circuit_dict(5, 2, 6, True),
            "optimizer": _optimizer_case()[0].to_dict(),
            "optimizer_rows": _optimizer_case()[3].tolist()}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("c128")
    spec = {"forward": {name: _circuit(n, depth, seed)
                        for name, n, depth, seed in FORWARD_CASES},
            "steps": _circuit(*STEPS_CASE), "batch": _circuit(*BATCH_CASE),
            "rows": BATCH_ROWS.tolist(), "audit": _audit_spec()}
    (d / "spec.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "spec.json"),
         str(d / "refs.npz")], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(d / "refs.npz") as z:
        return {k: z[k] for k in z.files}


def _three_qubit():
    c = tq.QuantumCircuit(3)
    c.add_gate(tq.GateInstance("H", [0], [], column=0))
    c.add_gate(tq.GateInstance("CNOT", [0, 1], [], column=1))
    c.add_gate(tq.GateInstance("Rz", [2], [0.7], column=1))
    return c


def test_three_qubit_circuit_matches_analytic_and_jax(jax_refs):
    state = tq.Simulator(device="cpu").run(_three_qubit(), shots=0) \
        .final_state
    assert state.device_data.dtype == torch.complex128
    want = np.zeros(8, complex)
    want[0] = want[6] = np.exp(-0.35j) / np.sqrt(2)
    assert np.abs(state.data - want).max() < TOL
    assert np.abs(jax_refs["three"] - want).max() < TOL
    assert np.abs(state.data - jax_refs["three"]).max() < TOL


@pytest.mark.parametrize("name,n,depth,seed", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_brickwork_forward_matches_jax(jax_refs, name, n, depth, seed):
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        _circuit(n, depth, seed)))
    got = tprog.forward_fn(program, "cpu")(program.initial_params)
    assert got.dtype == torch.complex128   # before StateVector casts
    assert np.abs(got.numpy() - jax_refs[name]).max() < TOL
    if n <= 10:   # the per-gate body too (autodiff, multi_start)
        body = tprog.forward_body(program, program.initial_params, "cpu")
        assert body.dtype == torch.complex128
        assert np.abs(body.numpy() - jax_refs[name]).max() < TOL


def test_step_recording_matches_jax(jax_refs):
    circuit = tq.QuantumCircuit.from_dict(_circuit(*STEPS_CASE))
    res = tq.Simulator(device="cpu").run(circuit, shots=0,
                                         record_steps=True)
    want = jax_refs["steps"]
    got = np.stack([s.data for s in res.step_states])
    assert res.step_states[0].device_data.dtype == torch.complex128
    assert np.abs(got - want[1:]).max() < TOL
    program = tprog.compile_circuit(circuit)
    steps = tprog.steps_fn(program, "cpu")(program.initial_params)
    assert steps.dtype == torch.complex128
    assert np.abs(steps.numpy() - want).max() < TOL


def test_parameter_rows_match_jax(jax_refs):
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        _circuit(*BATCH_CASE)))
    rows = BATCH_ROWS[:, :program.num_params]
    got = tprog.batched_forward_fn(program, "cpu")(rows)
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy() - jax_refs["batch"]).max() < TOL


# ---------------------------------------------------------------------------
# Trajectory routes against a NumPy complex128 replay
# ---------------------------------------------------------------------------

class _XBasisDamping(tq.NoiseChannel):
    """Amplitude damping conjugated by H: neither mixed-unitary nor
    monomial, so it takes the fold body."""

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
    "per-gate": lambda: _XBasisDamping(0.3),
}


def _apply_np(psi, u, targets, n):
    """``u`` on ``targets`` (first = MSB of u's index) of (2^n,) ``psi``."""
    k = len(targets)
    t = np.tensordot(u.reshape((2,) * (2 * k)), psi.reshape((2,) * n),
                     axes=(list(range(k, 2 * k)), list(targets)))
    return np.moveaxis(t, list(range(k)), list(targets)).reshape(-1)


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


def _natural_table(route, program, nm, draws) -> np.ndarray:
    """The branch indices of a body's ``draws`` in the per-gate order."""
    if route != "monomial":
        return draws.numpy()
    spec = tmt.monomial_spec(program, nm)
    table = np.zeros((draws[0][1].shape[0], spec.n_site_keys), np.int64)
    for window, (_, branches) in zip(spec.windows, draws):
        for si, site in enumerate(window):
            table[:, site.key_index] = branches[:, si].numpy()
    return table


def _body(route):
    """``body(program, nm, params, T, device, generator=, draws=)``."""
    if route == "unitary":
        return lambda *a, generator=None, draws=None: \
            tut.unitary_insert_trajectory_body(*a, generator=generator,
                                               branch=draws)
    return {"monomial": tmt.monomial_trajectory_body,
            "fold": fold_trajectory_body,
            "per-gate": tplan.group_trajectory_body}[route]


@pytest.mark.parametrize("mix_rz", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("route", sorted(ROUTE_CHANNELS))
def test_trajectory_route_matches_numpy_replay(route, mix_rz):
    nm = tq.NoiseModel()
    nm.add_global_noise(ROUTE_CHANNELS[route]())
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        build_circuit_dict(9, 6, 11, mix_rz)))
    if route != "per-gate":
        assert tprog.trajectory_route(program, nm) == route
    body = _body(route)
    params = program.initial_params
    _, draws = body(program, nm, params, 6, "cpu",
                    generator=torch.Generator().manual_seed(5))
    states, _ = body(program, nm, params, 6, "cpu", draws=draws)
    assert states.dtype == torch.complex128
    got = states.numpy()
    want = _replay(program, nm, _natural_table(route, program, nm, draws))
    phase = np.sum(np.conj(want) * got, axis=1)
    phase /= np.abs(phase)
    assert np.abs(got - phase[:, None] * want).max() < TOL


def test_monitored_collapse_matches_numpy_replay():
    """The monomial monitored body: the sampled outcomes' projectors
    replayed in NumPy."""
    circuit = tq.QuantumCircuit.from_dict(build_circuit_dict(8, 6, 2, True))
    program = tprog.compile_circuit(circuit)
    events = ((len(program.ops) // 2, 3), (len(program.ops), 5))
    states, outs, _ = tmt.monomial_monitored_body(
        program, tprog._NoNoise, events, program.initial_params, 5, "cpu",
        torch.Generator().manual_seed(3))
    assert states.dtype == torch.complex128
    n = program.num_qubits
    for t in range(5):
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
                    op, program.initial_params, np.complex128), op.targets, n)
        psi /= np.linalg.norm(psi)
        got = states[t].numpy()
        phase = np.vdot(psi, got) / abs(np.vdot(psi, got))
        assert np.abs(got - phase * psi).max() < TOL


# ---------------------------------------------------------------------------
# The audit: the other families under the mode
# ---------------------------------------------------------------------------

def _family_error(family, refs) -> float:
    """max |port - JAX complex128| of one family that serves the mode."""
    if family.startswith("density"):
        rho = tq.DensityMatrixSimulator(_noise_model(), device="cpu").run(
            tq.QuantumCircuit.from_dict(build_circuit_dict(4, 6, 9, True)),
            method=family.split("-")[1])
        assert rho.device_rho.dtype == torch.complex128
        return np.abs(rho.rho - refs["density"]).max()
    if family == "lindblad":
        sim = tq.LindbladSimulator(3, LINDBLAD["terms"], LINDBLAD["jumps"],
                                   device="cpu")
        psi = LINDBLAD_PSI[0] + 1j * LINDBLAD_PSI[1]
        res = sim.evolve(LINDBLAD["t"], LINDBLAD["steps"],
                         initial=psi / np.linalg.norm(psi),
                         observables=[("XY", [1, 2])])
        assert res.final.device_rho.dtype == torch.complex128
        assert res.expectations.dtype == np.float64
        xy = np.kron(np.eye(2), np.kron([[0, 1], [1, 0]],
                                        [[0, -1j], [1j, 0]]))
        want = np.real(np.trace(xy @ refs["lindblad"]))
        return max(np.abs(res.final.rho - refs["lindblad"]).max(),
                   abs(res.expectations[0, -1] - want))
    if family == "debugger":
        from quantum_simulator_tpu_torch.debugger import CircuitDebugger

        snaps = CircuitDebugger(device="cpu").run_full_debug(
            tq.QuantumCircuit.from_dict(build_circuit_dict(6, 8, 4, True)))
        assert snaps[-1].state.device_data.dtype == torch.complex128
        return np.abs(np.stack([s.state.data for s in snaps])
                      - refs["debugger"]).max()
    # optimizer: cost, parameter-shift and reverse-mode gradients against
    # <H> of JAX's complex128 states at the base and the shifted rows
    _, cfg, values, _, H = _optimizer_case()
    e = np.real(np.einsum("bi,ij,bj->b", refs["optimizer"].conj(), H,
                          refs["optimizer"]))
    want_g = (e[1::2] - e[2::2]) / 2
    cost = tq.CostFunction.vqe_hamiltonian(models.heisenberg_chain(6))
    shift = tq.GradientEstimator.parameter_shift(cfg, cost, values,
                                                 device="cpu")
    c, grad = tq.GradientEstimator.autodiff(cfg, cost, values, device="cpu")
    return max(abs(c - e[0]), np.abs(shift - want_g).max(),
               np.abs(grad - want_g).max())


@pytest.mark.parametrize("family", ["density-dense", "density-superop",
                                    "lindblad", "debugger", "optimizer"])
def test_family_matches_jax_complex128(jax_refs, family):
    assert _family_error(family, jax_refs) < TOL


def test_per_gate_trajectories_draw_exact_against_jax(jax_refs):
    """JAX's per-gate trajectory body in its complex128 mode, its draws
    fed to the port's: the same states within 1e-12."""
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        build_circuit_dict(5, 2, 6, True)))
    draws = torch.from_numpy(jax_refs["trajectory_draws"].astype(np.int64))
    states, _ = tplan.group_trajectory_body(
        program, _noise_model(), program.initial_params, draws.shape[0],
        "cpu", draws=draws)
    assert states.dtype == torch.complex128
    assert np.abs(states.numpy() - jax_refs["trajectory"]).max() < TOL


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def test_n32_raises_under_the_mode(monkeypatch):
    sim = tq.Simulator(device="cpu")
    for mix_rz in (False, True):     # a real and a planar state
        with pytest.raises(ValueError, match="64 GiB.*enable_complex128"):
            sim.run(tq.QuantumCircuit.from_dict(
                build_circuit_dict(32, 2, 0, mix_rz)), shots=0)
    # the guard follows COMPLEX128_MAX_QUBITS, whatever its value
    monkeypatch.setattr(config, "COMPLEX128_MAX_QUBITS", 9)
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    c10 = tq.QuantumCircuit.from_dict(build_circuit_dict(10, 2, 0))
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(0.1))
    for call in (lambda: sim.run(c10, shots=16),
                 lambda: list(sim.run_step_by_step(c10)),
                 lambda: sim.monitored_trajectories(c10, 2, final_shots=4),
                 lambda: tq.Simulator(nm, device="cpu").run_with_noise(
                     c10, shots=4),
                 lambda: sim.ensemble_qubit_density_matrices(c10, 2)):
        with pytest.raises(ValueError, match="enable_complex128"):
            call()
    monkeypatch.setattr(config, "COMPLEX128_MAX_QUBITS", 31)
    assert sim.run(c10, shots=0).final_state.state_data.dtype \
        == torch.float64
    # with the mode off n >= 30 returns the float32 large-state result
    config.enable_complex64()
    state = sim.run(c10, shots=0).final_state
    assert isinstance(state, bigstate.PlanarStateVector)
    assert state.state_data.dtype == torch.float32


@pytest.mark.parametrize("kernel", ["dense", "cross"])
def test_float64_state_with_float32_operator_raises(kernel):
    """A float64 state goes to the float64 kernel, which takes a float64
    operator only (checked before the device, so this runs on ``meta``
    tensors here and on the card in ``test_torch_gpu.py``)."""
    x = torch.empty((2, 4, 16, 128), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="float64"):
        if kernel == "dense":
            cuda_exec.dense_axis(x, torch.empty((128, 128), device="meta"),
                                 2, True)
        else:
            cuda_exec.cross_bit_axis(
                x, torch.empty((2, 16, 2, 16), device="meta"), 0, 1, 1, True)


def _operands(program):
    plan = tplan.get_group_plan(program)
    host = tplan.build_group_operands(program, plan, program.initial_params)
    batched = tplan.build_group_operands_batched(
        program, plan, program.initial_params, 2, "cpu")
    return [a for group in (host, batched) for part in group[:3]
            for a in part]


def _mesh_and_mps_states(circuit):
    """The 8-shard mesh's planar stack and the MPS engine's site tensors
    of ``circuit`` in the current precision."""
    mesh = __import__("quantum_simulator_tpu_torch.parallel",
                      fromlist=["x"]).DistributedSimulator(n_devices=8,
                                                           device="cpu")
    _, st = tq.MPSSimulator(chi=8, device="cpu").run(circuit, shots=0)
    return mesh.run(circuit).device_data, st.tensors


def test_mode_off_is_bit_for_bit_unchanged():
    """Operands, states and parameter tensors after a complex128 round
    trip are the complex64 engine's, bit for bit, and float32 again (the
    mesh's planar stack and the MPS site tensors too)."""
    program = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        build_circuit_dict(12, 6, 4, True)))
    small = tq.QuantumCircuit.from_dict(build_circuit_dict(8, 4, 2, True))
    config.enable_complex64()
    before = _operands(program)
    state0 = tprog.forward_fn(program, "cpu")(program.initial_params)
    mesh0, mps0 = _mesh_and_mps_states(small)
    config.enable_complex128()
    mesh_w, mps_w = _mesh_and_mps_states(small)
    assert mesh_w.dtype == torch.float64 and mps_w[0].dtype == \
        torch.complex128
    wide = _operands(program)
    assert all(np.asarray(a).dtype == np.float64 for a in wide)
    assert tprog.forward_fn(program, "cpu")(
        program.initial_params).dtype == torch.complex128
    config.enable_complex64()
    after = _operands(program)
    for a, b in zip(before, after):
        assert np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    state1 = tprog.forward_fn(program, "cpu")(program.initial_params)
    assert state1.dtype == torch.complex64
    assert torch.equal(state0, state1)
    mesh1, mps1 = _mesh_and_mps_states(small)
    assert mesh1.dtype == torch.float32 and torch.equal(mesh0, mesh1)
    assert all(a.dtype == torch.complex64 and torch.equal(a, b)
               for a, b in zip(mps0, mps1))
    assert tprog.param_tensor([0.5], "cpu").dtype == torch.float32
