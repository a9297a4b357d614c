"""The complex128 verification mode through the shard mesh and the MPS
family, on the CPU.

Under ``config.enable_complex128()`` the seven entry points that refused
the mode before (``DistributedSimulator``, ``sharded_vqe_step``,
``MPSSimulator``, the MPS cost function, ``dmrg_ground_state``,
``MPSLindbladSimulator``, ``mps_two_point_correlator``) compute in
float64 / complex128. Held here, every case restoring
``enable_complex64()``:

* the mesh (8 shards on one process) against the JAX package's own
  complex128 ``DistributedSimulator`` (8 virtual CPU devices), 1e-12: a
  depth-12 Ry/Rz/CNOT brickwork and QFT-10 on a basis input through the
  per-gate route (n = 10, 7 local qubits), ``expectation_z``,
  ``qubit_density_matrices`` and a Pauli string, and one noisy trajectory
  with both packages' draws read from one Gumbel table;
* the grouped route, forced at n = 10 by lowering
  ``_GROUPED_SHARD_MIN_QUBITS``, against the port's single-device
  complex128 ``Simulator`` (itself held to JAX at 1e-12 in
  ``tests/test_torch_complex128.py``), 1e-12: JAX's grouped body keeps
  float32 planes in its mode, so it is no complex128 reference;
* ``run_segmented`` within 1e-12 of one run (1e-6 in complex64, where
  the rounding of a gate applied at another local position set it); a
  float64 checkpoint round trip bit for bit, written as ``"complex128"``;
  a complex64 checkpoint refused on resume under the mode;
* one ``sharded_vqe_step``: its cost against the single-device
  complex128 ``<H>`` at 1e-12, against JAX's (float32 in its mode) at
  1e-6; the shard sampler against a float64 inverse CDF; n = 32 raises;
* the MPS family against JAX's complex128 MPS state and the port's
  complex128 ``Simulator`` (1e-12), the X / Y readout rotation against a
  NumPy complex128 one (1e-12), the MPS cost against the statevector's
  ``<H>`` (1e-12) and JAX's float32 energy (1e-6), DMRG on
  ``tfim_chain(8)`` against ``numpy.linalg.eigvalsh`` (relative 1e-10)
  and JAX (1e-5), the MPS Lindblad trajectories against JAX's complex128
  ones on the same draws (1e-10), the correlator against a dense product
  of ``scipy.linalg.expm`` Trotter factors (1e-10);
* with the mode off every family gives the same bits before and after a
  complex128 round trip, in float32 / complex64.

1e-12: float64 sums of a few hundred terms in another order than JAX's;
the complex64 engine is 1e-7 - 1e-6 off on the same cases. JAX's x64
switch is process-wide, so its references come from one subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

from bench import build_circuit_dict
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import config, models
from quantum_simulator_tpu_torch import correlators as tc
from quantum_simulator_tpu_torch import lindblad_mps as tl
from quantum_simulator_tpu_torch import mps as tm
from quantum_simulator_tpu_torch import optimizer as topt
from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
from quantum_simulator_tpu_torch.lindblad import _pauli_term_matrix
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                  make_mesh, make_vqe_mesh,
                                                  sharded_vqe_step)
from quantum_simulator_tpu_torch.parallel import checkpoint as tckpt
from quantum_simulator_tpu_torch.parallel import distributed as tdist
from tests import torch_jax_draws as D
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
TOL = 1e-12
SHARDS = 8
N_MESH = 10
BRICK = (N_MESH, 12, 3)                  # (n, depth, seed), Ry/Rz + CNOT
QFT_INPUT = [1, 0, 1, 1, 0, 0, 1, 0, 1, 1]
PAULI = ([1, 4, 8], "XYZ")
Z_QUBITS = [0, 2, 5, 9]                  # two shard bits, two local ones
NOISY = (6, 3, 11, 0.08)                 # (n, depth, seed, depolarizing p)
VQE = (8, 2)                             # hardware_efficient_ansatz
VQE_OBS = [(0.5, [0, 1]), (-0.8, [3]), (0.3, [2, 5, 7])]
MPS_CASES = ((8, 16), (10, 32))          # (n, chi >= the exact bond)
MPS_COST = (6, 2, 8)                     # ansatz (n, layers), chi
DMRG = (8, 16, 6)                        # tfim_chain n, chi, sweeps
LIND_H = [(1.0, "ZZ", [0, 1]), (1.0, "ZZ", [1, 2]), (0.7, "X", [0]),
          (0.7, "X", [1]), (0.7, "X", [2]), (0.4, "XY", [0, 2])]
LIND_J = [(0.6, "sigma_minus", 0), (0.5, "z", 2), (0.3, "sigma_plus", 1)]
LIND_OBS = [("Z", [0]), ("X", [1]), ("ZZ", [0, 1]), ("YX", [2, 0])]
LIND = (4, 4, 2, 7, 4)                   # (T, steps, every, seed, chi)
CORR = (6, 0.8, 16, 2, 4, "X", "Z", 16)  # n, t, steps, i, j, P_i, P_j, chi


def _brickwork(n=BRICK[0], depth=BRICK[1], seed=BRICK[2], mix_rz=True):
    return tq.QuantumCircuit.from_dict(build_circuit_dict(n, depth, seed,
                                                          mix_rz))


def _qft():
    c = AlgorithmTemplate.quantum_fourier_transform(N_MESH)
    c.initial_states = list(QFT_INPUT)
    return c


def _noise():
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(NOISY[3]))
    return nm


def _noisy_table():
    """One trajectory's Gumbel rows (the JAX key schedule of seed 5)."""
    program = tprog.compile_circuit(_brickwork(*NOISY[:3]))
    draws, width = tdist.noisy_draw_shape(program, _noise())
    return D.mesh_trajectory_gumbels([5], draws, width)[0]


def _vqe_circuit(n=VQE[0], layers=VQE[1]):
    d = models.hardware_efficient_ansatz(n, layers).to_dict()
    rng = np.random.default_rng(4)
    for gd in d["gates"]:
        gd["params"] = [float(rng.uniform(-np.pi, np.pi))
                        for _ in gd.get("params", [])]
    return tq.QuantumCircuit.from_dict(d)


def _mps_circuit(n: int):
    return _brickwork(n, n - 4, n - 2)


def _mps_cost_case():
    n, layers, chi = MPS_COST
    circuit = models.hardware_efficient_ansatz(n, layers)
    cfg = topt.MPSParameterizedConfig.auto_detect(circuit, chi=chi)
    rows = np.random.default_rng(2).uniform(-np.pi, np.pi,
                                            (3, cfg.num_params))
    return circuit, cfg, rows


def _lindblad_gumbels():
    T, steps, _, seed, _ = LIND
    return D.lindblad_mps_gumbels(seed, T, steps, len(LIND_J))


_JAX_SCRIPT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from quantum_simulator_tpu.config import enable_complex128
enable_complex128()
import numpy as np
import jax.numpy as jnp
from quantum_simulator_tpu import QuantumCircuit, NoiseModel
from quantum_simulator_tpu import dmrg as jd
from quantum_simulator_tpu import lindblad_mps as jl
from quantum_simulator_tpu import mps as jm
from quantum_simulator_tpu.ops import program as prog
from quantum_simulator_tpu.parallel import (DistributedSimulator,
                                            make_vqe_mesh, sharded_vqe_step)
from quantum_simulator_tpu.parallel import distributed as jdist
sys.path.insert(0, ".")
from tests import torch_jax_draws as D

spec = json.load(open(sys.argv[1]))
C = {k: QuantumCircuit.from_dict(v) for k, v in spec["circuits"].items()}
out = {}
sim = DistributedSimulator(n_devices=8)
out["qft"] = sim.run(C["qft"]).data
st = sim.run(C["brick"])
out["brick"] = st.data
out["z"] = np.array([sim.expectation_z(st, q) for q in spec["z_qubits"]])
out["rho"] = np.asarray(sim.qubit_density_matrices(st))
out["pauli"] = np.array(sim.expectation_pauli_string(st, *spec["pauli"]))
nm = NoiseModel.from_dict(spec["noise"])
p = prog.compile_circuit(C["noisy"])
fn = jdist.sharded_trajectory_fn(p, nm, sim.mesh)
with D.jax_keyed_table(jnp.asarray(np.asarray(spec["gumbels"]))):
    out["noisy"] = np.asarray(fn(jnp.asarray(p.initial_params),
                                 jax.random.PRNGKey(0)))
step = sharded_vqe_step(C["vqe"], make_vqe_mesh(8),
                        observable=[tuple(t) for t in spec["vqe_obs"]])
out["vqe_cost"] = np.array(float(step.step(step.init)[1]))
for key, (chi, cname) in spec["mps"].items():
    st = jm.MPSSimulator(chi=chi)._final_state(C[cname], chi)
    out[key] = np.asarray(jm.to_statevector(st))
cm = spec["mps_cost"]
binds = [type("B", (), {"gate_index": gi, "param_index": pi})()
         for gi, pi in cm["bindings"]]
fn = jm.build_batched_cost_fn(C["mps_cost"], binds,
                              [tuple(t) for t in cm["terms"]], cm["chi"])
out["mps_cost"] = np.asarray(fn(jnp.asarray(cm["rows"])), np.float64)
# JAX's DMRG does not run in its complex128 mode (its sweep carries a
# float32 discarded weight that the float64 SVD makes float64): its
# complex64 run is the reference, at complex64's tolerance.
from quantum_simulator_tpu.config import enable_complex64
enable_complex64()
dm = spec["dmrg"]
out["dmrg"] = np.array(jd.dmrg_ground_state(
    [tuple(t) for t in dm["terms"]], dm["n"], chi=dm["chi"],
    sweeps=dm["sweeps"]).energy)
enable_complex128()
li = spec["lindblad"]


# JAX's lindblad_mps._expectation_pstr without its float32 cast of the
# record: the complex128 trajectory read in float64.
def expectation_wide(tensors, ops):
    env = jnp.ones((1, 1), tensors[0].dtype)
    for i, t in enumerate(tensors):
        op = ops.get(i)
        tt = t if op is None else jnp.einsum("qp,lpr->lqr",
                                             op.astype(t.dtype), t)
        env = jnp.einsum("ab,apx,bpy->xy", env, jnp.conj(t), tt)
    return jnp.real(env[0, 0])


jl._expectation_pstr = expectation_wide
jsim = jl.MPSLindbladSimulator(3, [tuple(t) for t in li["H"]],
                               [tuple(j) for j in li["J"]], chi=li["chi"])
one = jsim._build(li["steps"], li["every"],
                  tuple((pp, tuple(q)) for pp, q in li["obs"]),
                  li["t"] / li["steps"], li["bits"],
                  jnp.complex128).__wrapped__.__wrapped__
g = np.asarray(li["gumbels"])


def traj(table):
    with D.jax_keyed_table(table):
        return one(jnp.zeros(2, jnp.uint32))


recs, disc = jax.jit(jax.vmap(traj))(jnp.asarray(
    g.reshape(g.shape[0], -1, 2)))
out["lindblad"] = np.asarray(recs)
assert out["brick"].dtype == np.complex128
assert out["lindblad"].dtype == np.float64, out["lindblad"].dtype
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_process(tmp_path_factory):
    """The JAX references' subprocess, started with the module's first
    test so that the tests without a JAX reference (first in the file)
    run while it computes."""
    d = tmp_path_factory.mktemp("c128mesh")
    circuit, cfg, rows = _mps_cost_case()
    spec = {
        "circuits": {"brick": _brickwork().to_dict(), "qft": _qft().to_dict(),
                     "noisy": _brickwork(*NOISY[:3]).to_dict(),
                     "vqe": _vqe_circuit().to_dict(),
                     "mps8": _mps_circuit(MPS_CASES[0][0]).to_dict(),
                     "mps10": _mps_circuit(MPS_CASES[1][0]).to_dict(),
                     "mps_cost": circuit.to_dict()},
        "pauli": PAULI, "z_qubits": Z_QUBITS, "noise": _noise().to_dict(),
        "gumbels": _noisy_table().tolist(), "vqe_obs": VQE_OBS,
        "mps": {f"mps{n}": (chi, f"mps{n}") for n, chi in MPS_CASES},
        "mps_cost": {"bindings": [(b.gate_index, b.param_index)
                                  for b in cfg.bindings],
                     "terms": models.heisenberg_chain(MPS_COST[0]),
                     "chi": MPS_COST[2], "rows": rows.tolist()},
        "dmrg": {"terms": models.tfim_chain(DMRG[0]), "n": DMRG[0],
                 "chi": DMRG[1], "sweeps": DMRG[2]},
        "lindblad": {"H": LIND_H, "J": LIND_J, "obs": LIND_OBS,
                     "steps": LIND[1], "every": LIND[2], "chi": LIND[4],
                     "t": 0.9, "bits": [0, 1, 0],
                     "gumbels": _lindblad_gumbels().tolist()},
    }
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "spec.json"),
         str(d / "refs.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        yield proc, d / "refs.npz"
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_refs(jax_process):
    proc, path = jax_process
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def c128():
    config.enable_complex128()
    try:
        yield
    finally:
        config.enable_complex64()


@pytest.fixture
def grouped(monkeypatch):
    """The grouped route at 7 local qubits (JAX's threshold is 14)."""
    monkeypatch.setattr(tdist, "_GROUPED_SHARD_MIN_QUBITS", 7)


def _sim(n_devices: int = SHARDS) -> DistributedSimulator:
    return DistributedSimulator(n_devices=n_devices, device=CPU)


def _single(circuit) -> np.ndarray:
    state = tq.Simulator(device=CPU).run(circuit, shots=0).final_state
    assert state.device_data.dtype == torch.complex128
    return state.data


def _planes(st) -> torch.Tensor:
    x = st.device_data
    assert x.dtype == torch.float64
    return x


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

MESH_CIRCUITS = {"brickwork": _brickwork, "qft": _qft}
MESH_REF = {"brickwork": "brick", "qft": "qft"}


GROUPED_CIRCUITS = {
    "brickwork": _brickwork,
    "ansatz": lambda: _vqe_circuit(N_MESH),   # CNOT chains: cross steps
    "qft": _qft,                          # shard CPhases, 1q diagonals
}


@pytest.mark.parametrize("name", sorted(GROUPED_CIRCUITS))
def test_mesh_grouped_route_matches_single_device(c128, grouped, name):
    circuit = GROUPED_CIRCUITS[name]()
    sim = _sim()
    body = tdist._ShardBody(tprog.compile_circuit(circuit), sim.mesh)
    assert body.grouped
    st = sim.run(circuit)
    _planes(st)
    assert np.abs(st.data - _single(circuit)).max() < TOL


@pytest.mark.parametrize("route", ["per-gate", "grouped"])
def test_run_segmented_matches_one_run(c128, monkeypatch, route):
    if route == "grouped":
        monkeypatch.setattr(tdist, "_GROUPED_SHARD_MIN_QUBITS", 7)
    circuit = _brickwork()
    sim = _sim()
    whole = sim.run(circuit)
    seg = sim.run_segmented(circuit, 5)
    assert _planes(seg).shape == whole.device_data.shape
    assert np.abs(seg.data - whole.data).max() < TOL


def test_float64_checkpoint_round_trip(c128, tmp_path):
    sim = _sim()
    st = sim.run(_brickwork())
    tckpt.save_sharded_state(st.device_data, str(tmp_path), sim.mesh)
    assert tckpt.load_manifest(str(tmp_path))["dtype"] == "complex128"
    back = tckpt.load_sharded_state(str(tmp_path), sim.mesh)
    assert back.dtype == torch.float64
    assert torch.equal(back, st.device_data)
    # a resumed float64 run equals one uninterrupted run bit for bit
    circuit = _brickwork()
    ck = tmp_path / "ck"

    class Stop(Exception):
        pass

    def stop(i, ns, w):
        if i == 1:
            raise Stop()

    with pytest.raises(Stop):
        sim.run_segmented(circuit, 4, progress=stop, checkpoint_dir=str(ck))
    resumed = sim.run_segmented(circuit, 4, checkpoint_dir=str(ck))
    assert torch.equal(resumed.device_data,
                       sim.run_segmented(circuit, 4).device_data)


def test_complex64_checkpoint_refused_under_the_mode(tmp_path):
    circuit = _brickwork()
    sim = _sim()

    class Stop(Exception):
        pass

    def stop(i, ns, w):
        if i == 1:
            raise Stop()

    with pytest.raises(Stop):
        sim.run_segmented(circuit, 4, progress=stop,
                          checkpoint_dir=str(tmp_path))
    latest = tckpt.read_latest(str(tmp_path))
    assert tckpt.load_manifest(latest)["dtype"] == "complex64"
    config.enable_complex128()
    try:
        with pytest.raises(ValueError, match="complex64 state"):
            sim.run_segmented(circuit, 4, checkpoint_dir=str(tmp_path))
        # a fresh run over the same directory is not a resume
        st = sim.run_segmented(circuit, 4, checkpoint_dir=str(tmp_path),
                               resume=False)
        assert _planes(st).dtype == torch.float64
    finally:
        config.enable_complex64()


def _single_vqe_cost(circuit, params: np.ndarray) -> float:
    """sum_i c_i <Z...> of the single-device complex128 state."""
    c = tq.QuantumCircuit.from_dict(circuit.to_dict())
    program = tprog.compile_circuit(c)
    psi = tprog.forward_fn(program, CPU)(params).numpy()
    n = c.num_qubits
    probs = np.abs(psi) ** 2
    idx = np.arange(1 << n)
    total = 0.0
    for coeff, qs in VQE_OBS:
        sign = np.ones(1 << n)
        for q in qs:
            sign = sign * (1 - 2 * ((idx >> (n - 1 - q)) & 1))
        total += coeff * float(probs @ sign)
    return total


def test_mesh_sampler_in_float64(c128):
    """The shard sampler scales the float32 uniforms in float64 and
    resolves them against the float64 CDF: the counts of a NumPy inverse
    CDF on the gathered probabilities, from the same uniforms (a shot
    within 1e-12 of a boundary may land on either side)."""
    sim = _sim()
    st = sim.run(_brickwork())
    shots = 4000
    counts = sim.sample(st, shots, np.random.default_rng(9))
    u = np.random.default_rng(9).random(shots).astype(np.float32)
    cdf = np.cumsum(st.probabilities)
    t = u.astype(np.float64) * cdf[-1]
    idx = np.minimum(np.searchsorted(cdf, t, side="right"), len(cdf) - 1)
    near = np.abs(cdf[np.clip(idx - 1, 0, None)] - t).min() < 1e-12
    want: dict = {}
    for i in idx:
        key = format(int(i), f"0{N_MESH}b")
        want[key] = want.get(key, 0) + 1
    assert near or counts == want


def test_mesh_n32_raises_under_the_mode():
    sim = DistributedSimulator(n_devices=SHARDS, device=CPU)
    c = tq.QuantumCircuit.from_dict(build_circuit_dict(32, 1, 0, True))
    config.enable_complex128()
    try:
        for call in (lambda: sim.run(c), lambda: sim.run_segmented(c, 1)):
            with pytest.raises(ValueError, match="64 GiB.*enable_complex128"):
                call()
        with pytest.raises(ValueError, match="enable_complex128"):
            sharded_vqe_step(models.hardware_efficient_ansatz(32, 1),
                             make_vqe_mesh(SHARDS, device=CPU))
    finally:
        config.enable_complex64()


def test_mesh_cap_adds_log2_ranks():
    """Two ranks hold an n = 32 float64 state at 32 GiB a card."""
    config.enable_complex128()
    try:
        config.require_width(32, "mesh", 2)
        config.require_width(33, "mesh", 4)
        with pytest.raises(ValueError, match="128 GiB \\(64 GiB a card on "
                           "2 ranks\\)"):
            config.require_width(33, "mesh", 2)
    finally:
        config.enable_complex64()


# ---------------------------------------------------------------------------
# The MPS family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("basis", ["X", "Y"])
def test_mps_readout_rotation_in_complex128(c128, basis):
    """The X / Y readout rotates every site by H (H S-dagger) in the
    state's precision: the rotated MPS is the NumPy complex128 rotation
    of the statevector."""
    circuit = _brickwork(6, 4, 2)
    _, st = tq.MPSSimulator(chi=8, device=CPU).run(circuit, shots=0)
    rotated = tm.basis_rotated(list(st.tensors), basis)
    assert rotated[0].dtype == torch.complex128
    got = tm.to_statevector(tm.MPSState(tuple(rotated), 6, 8, 0.0))
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    r = h if basis == "X" else h @ np.diag([1, -1j])
    full = r
    for _ in range(5):
        full = np.kron(full, r)
    assert np.abs(got - full @ _single(circuit)).max() < TOL


def test_mps_noisy_entry_points_in_float64(c128):
    """run_with_noise and monitored trajectories run in complex128; their
    discarded weights are float64, their branch weights compared with
    the float32 Gumbel rows in float64."""
    circuit = _brickwork(6, 3, 1, mix_rz=False)
    sim = tq.MPSSimulator(chi=8, device=CPU)
    log: list = []
    with D.port_draws(log):
        counts, disc = sim.run_with_noise(circuit, _noise(), shots=32,
                                          seed=3)
    assert sum(counts.values()) == 32 and disc == 0.0
    assert log and all(m.dtype == np.float64 for _, m in log)
    outs, sites, states = sim.monitored_trajectories(
        circuit, 4, seed=2, noise_model=_noise())
    assert all(t.dtype == torch.complex128 for s in states
               for t in s.tensors)


def _dense_term(pstr: str, qubits, n: int) -> np.ndarray:
    """The 2^n matrix of a Pauli term (qubit 0 the most significant)."""
    full = np.ones((1, 1))
    ops = dict(zip(qubits, pstr))
    for q in range(n):
        full = np.kron(full, _pauli_term_matrix(ops.get(q, "I")))
    return full


def test_correlator_matches_expm_trotter_product(c128):
    """C(t) of the second-order Trotter circuit against the dense product
    of its factors, each ``scipy.linalg.expm(-i c dt/2 P)``."""
    n, t, steps, si, sj, pi, pj, chi = CORR
    terms = models.tfim_chain(n)
    times, got = tc.mps_two_point_correlator(
        n, terms, t, steps, si, sj, pi, pj, chi=chi, device=CPU)
    assert got.dtype == np.complex128
    dt = t / steps
    half = [scipy.linalg.expm(-0.5j * c * dt * _dense_term(p, q, n))
            for c, p, q in terms]
    u = np.eye(1 << n)
    for f in half + half[::-1]:
        u = f @ u
    psi = np.zeros(1 << n, complex)
    psi[0] = 1.0
    phi = _dense_term(pj, [sj], n) @ psi
    op = _dense_term(pi, [si], n)
    want = []
    for _ in range(steps + 1):
        want.append(np.conj(psi) @ op @ phi)
        psi, phi = u @ psi, u @ phi
    assert np.abs(got - np.array(want)).max() < 1e-10


# ---------------------------------------------------------------------------
# With the mode off: the complex64 engine, bit for bit
# ---------------------------------------------------------------------------

def _off_mesh():
    return _sim().run(_brickwork()).device_data


def _off_grouped():
    old = tdist._GROUPED_SHARD_MIN_QUBITS
    tdist._GROUPED_SHARD_MIN_QUBITS = 7
    try:
        return _sim().run(_brickwork()).device_data
    finally:
        tdist._GROUPED_SHARD_MIN_QUBITS = old


def _off_vqe():
    step = sharded_vqe_step(_vqe_circuit(), make_vqe_mesh(SHARDS, device=CPU),
                            observable=VQE_OBS)
    state, cost = step.step(step.init)
    return torch.cat([state.params, state.m, state.v, cost[None]])


def _off_mps():
    st = tq.MPSSimulator(chi=4, device=CPU).run(_brickwork(6, 6, 1),
                                                shots=0)[1]
    return torch.cat([t.reshape(-1) for t in st.tensors])


def _off_mps_cost():
    circuit, cfg, rows = _mps_cost_case()
    return tm.build_batched_cost_fn(circuit, cfg.bindings,
                                    models.heisenberg_chain(MPS_COST[0]), 4,
                                    device=CPU)(rows)


def _off_dmrg():
    res = tq.dmrg_ground_state(models.tfim_chain(6), 6, chi=4, sweeps=2,
                               device=CPU)
    return torch.tensor([res.energy] + res.sweep_energies
                        + [res.truncation_weight])


def _off_lindblad():
    T, steps, every, _, _ = LIND
    out = tl.MPSLindbladSimulator(3, LIND_H, LIND_J, chi=2,
                                  device=CPU).evolve(
        0.9, steps, n_trajectories=T, initial=[0, 1, 0],
        observables=LIND_OBS, record_every=every,
        gumbels=_lindblad_gumbels())
    return torch.from_numpy(np.concatenate([out.expectations.ravel(),
                                            out.stderr.ravel()]))


def _off_correlator():
    return torch.from_numpy(tc.mps_two_point_correlator(
        6, models.tfim_chain(6), 0.5, 6, 2, 3, chi=4, device=CPU)[1])


MODE_OFF = {"mesh": (_off_mesh, torch.float32),
            "grouped": (_off_grouped, torch.float32),
            "vqe": (_off_vqe, torch.float32),
            "mps": (_off_mps, torch.complex64),
            "mps-cost": (_off_mps_cost, torch.float32),
            "dmrg": (_off_dmrg, None),
            "lindblad": (_off_lindblad, None),
            "correlator": (_off_correlator, None)}


@pytest.mark.parametrize("family", sorted(MODE_OFF))
def test_mode_off_is_bit_for_bit_unchanged(family):
    fn, dtype = MODE_OFF[family]
    before = fn()
    config.enable_complex128()
    try:
        wide = fn()
    finally:
        config.enable_complex64()
    after = fn()
    if dtype is not None:
        assert before.dtype == dtype
        assert wide.dtype == {torch.float32: torch.float64,
                              torch.complex64: torch.complex128}[dtype]
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# Against the JAX package's references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESH_CIRCUITS))
def test_mesh_per_gate_matches_jax(jax_refs, c128, name):
    st = _sim().run(MESH_CIRCUITS[name]())
    _planes(st)
    assert np.abs(st.data - jax_refs[MESH_REF[name]]).max() < TOL


@pytest.mark.parametrize("what", ["z", "rho", "pauli"])
def test_mesh_reductions_match_jax(jax_refs, c128, what):
    """On the brickwork: <Z_q> of shard and local qubits and a
    three-qubit Pauli string spanning both against JAX's; the one-qubit
    density matrices against the partial traces of JAX's complex128 state
    (JAX's own come out float32 in its mode: 1e-6 of them)."""
    sim = _sim()
    st = sim.run(_brickwork())
    if what == "z":
        z = [sim.expectation_z(st, q) for q in Z_QUBITS]
        assert np.abs(np.array(z) - jax_refs["z"]).max() < TOL
    elif what == "pauli":
        assert abs(sim.expectation_pauli_string(st, *PAULI)
                   - float(jax_refs["pauli"])) < TOL
    else:
        rho = sim.qubit_density_matrices(st)
        psi = jax_refs["brick"].reshape((2,) * N_MESH)
        want = np.stack([np.tensordot(np.moveaxis(psi, q, 0),
                                      np.moveaxis(psi, q, 0).conj(),
                                      axes=(range(1, N_MESH),) * 2)
                         for q in range(N_MESH)])
        assert np.abs(rho - want).max() < TOL
        assert np.abs(rho - jax_refs["rho"]).max() < 1e-6


def test_mesh_noisy_trajectory_matches_jax(jax_refs, c128):
    """Both packages draw from one Gumbel table: every draw whose margin
    is above 1e-9 is the same branch, and then so is the state."""
    circuit = _brickwork(*NOISY[:3])
    program = tprog.compile_circuit(circuit)
    record: list = []
    out = tdist.sharded_trajectory_fn(program, _noise(), make_mesh(
        SHARDS, device=CPU))(program.initial_params,
                             _noisy_table()[None], record)
    assert out.dtype == torch.float64
    margins = np.array([float(m[0]) for _, m in record])
    assert margins.min() > 1e-9, margins.min()
    got = torch.complex(out[0, :, 0], out[0, :, 1]).reshape(-1).numpy()
    assert np.abs(got - jax_refs["noisy"]).max() < TOL


@pytest.mark.parametrize("route", ["per-gate", "grouped"])
def test_sharded_vqe_step_cost(jax_refs, c128, monkeypatch, route):
    if route == "grouped":
        monkeypatch.setattr(tdist, "_GROUPED_SHARD_MIN_QUBITS", 5)
    circuit = _vqe_circuit()
    step = sharded_vqe_step(circuit, make_vqe_mesh(SHARDS, device=CPU),
                            observable=VQE_OBS)
    assert step.init.params.dtype == torch.float64
    state, cost = step.step(step.init)
    assert cost.dtype == torch.float64
    assert state.m.dtype == state.v.dtype == torch.float64
    params = tprog.compile_circuit(circuit).initial_params
    assert abs(float(cost) - _single_vqe_cost(circuit, params)) < TOL
    assert abs(float(cost) - float(jax_refs["vqe_cost"])) < 1e-6


@pytest.mark.parametrize("n,chi", MPS_CASES)
def test_mps_state_matches_jax_and_statevector(jax_refs, c128, n, chi):
    circuit = _mps_circuit(n)
    counts, st = tq.MPSSimulator(chi=chi, device=CPU).run(circuit, shots=64,
                                                          seed=1)
    assert all(t.dtype == torch.complex128 for t in st.tensors)
    assert st.truncation_weight == 0.0
    psi = tm.to_statevector(st)
    assert np.abs(psi - jax_refs[f"mps{n}"]).max() < TOL
    assert np.abs(psi - _single(circuit)).max() < TOL
    assert sum(counts.values()) == 64


def test_mps_cost_matches_statevector_and_jax(jax_refs, c128):
    circuit, cfg, rows = _mps_cost_case()
    terms = models.heisenberg_chain(MPS_COST[0])
    fn = tm.build_batched_cost_fn(circuit, cfg.bindings, terms, MPS_COST[2],
                                  device=CPU)
    got = fn(rows)
    assert got.dtype == torch.float64
    H = sum(c * _dense_term(p, q, MPS_COST[0]) for c, p, q in terms)
    want = []
    for row in rows:
        psi = _single(cfg.bind_values(row))
        want.append(np.real(np.conj(psi) @ H @ psi))
    assert np.abs(got.numpy() - np.array(want)).max() < TOL
    assert np.abs(got.numpy() - jax_refs["mps_cost"]).max() < 1e-6


def test_dmrg_matches_eigvalsh_and_jax(jax_refs, c128):
    n, chi, sweeps = DMRG
    terms = models.tfim_chain(n)
    res = tq.dmrg_ground_state(terms, n, chi=chi, sweeps=sweeps, device=CPU)
    assert all(t.dtype == torch.complex128 for t in res.state.tensors)
    exact = np.linalg.eigvalsh(sum(c * _dense_term(p, q, n)
                                   for c, p, q in terms))[0]
    assert abs(res.energy - exact) <= 1e-10 * abs(exact)
    assert abs(res.sweep_energies[-1] - exact) <= 1e-10 * abs(exact)
    assert abs(res.energy - float(jax_refs["dmrg"])) < 1e-5


def test_mps_lindblad_matches_jax(jax_refs, c128):
    T, steps, every, _, chi = LIND
    got = tl.MPSLindbladSimulator(3, LIND_H, LIND_J, chi=chi,
                                  device=CPU).evolve(
        0.9, steps, n_trajectories=T, initial=[0, 1, 0],
        observables=LIND_OBS, record_every=every,
        gumbels=_lindblad_gumbels())
    recs = jax_refs["lindblad"]                        # (T, R, K)
    assert np.abs(got.expectations - recs.mean(0).T).max() < 1e-10
    assert np.abs(got.stderr - recs.std(0, ddof=1).T / np.sqrt(T)
                  ).max() < 1e-10
