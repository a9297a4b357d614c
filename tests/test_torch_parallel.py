"""The port's sharded VQE step, checkpoints, multi-process seam and the
``mesh=`` engines against the JAX package's, on the CPU.

Tolerances and why:

* VQE costs and parameters over 3 Adam steps: 1e-5 (float32 costs and
  updates on both sides, sums in another order);
* checkpoints: a JAX-written checkpoint resumes in the port and a port-
  written one in JAX (the same files), each to the uninterrupted run's
  state within 1e-6;
* ``MultiHostSpec``, ``amp_axis_split``: equal (host logic);
* ``mesh=`` engines: identical to ``mesh=None`` on the same draws.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from quantum_simulator_tpu import GateInstance as JG
from quantum_simulator_tpu import QuantumCircuit as JC
from quantum_simulator_tpu.models import brickwork_circuit as jbrickwork
from quantum_simulator_tpu.parallel import DistributedSimulator as JD
from quantum_simulator_tpu.parallel import make_vqe_mesh as jmake_vqe_mesh
from quantum_simulator_tpu.parallel import sharded_vqe_step as jvqe
from quantum_simulator_tpu_torch import QuantumCircuit, lindblad_mps, qec
from quantum_simulator_tpu_torch import qec_circuit, qec_frame
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                  MultiHostSpec,
                                                  amp_axis_split,
                                                  checkpoint,
                                                  initialize_multihost,
                                                  make_mesh,
                                                  make_multihost_mesh,
                                                  make_vqe_mesh,
                                                  sharded_vqe_step)
from quantum_simulator_tpu_torch.parallel.vqe import shard_local_z_sign

CPU = "cpu"


def _ansatz(n_q=4, layers=2) -> JC:
    c = JC(n_q)
    col = 0
    for layer in range(layers):
        for q in range(n_q):
            c.add_gate(JG("Ry", [q], [0.3 + 0.1 * q + 0.2 * layer],
                          column=col))
        col += 1
        for q in range(n_q - 1):
            c.add_gate(JG("CNOT", [q, q + 1], [], column=col))
            col += 1
    return c


def port(c: JC) -> QuantumCircuit:
    return QuantumCircuit.from_dict(c.to_dict())


# ---------------------------------------------------------------------------
# Sharded VQE
# ---------------------------------------------------------------------------

def test_make_vqe_mesh_shapes():
    mesh = make_vqe_mesh(8, device=CPU)
    assert mesh.shape["amp"] == 4 and mesh.shape["traj"] == 2
    assert mesh.axis_names == ("traj", "amp") and mesh.local == 8
    mesh2 = make_vqe_mesh(2, device=CPU)
    assert mesh2.shape["amp"] == 2 and mesh2.shape["traj"] == 1
    assert make_vqe_mesh(16, max_amp=2, device=CPU).shape["traj"] == 8
    with pytest.raises(ValueError):
        make_vqe_mesh(10 ** 6, device=CPU)


def test_shard_local_z_sign_paths():
    """A shard-bit qubit gives one sign per shard, a local qubit a sign
    per local amplitude; neither builds a 2^n vector."""
    n, g = 4, 2
    ids = torch.arange(4)
    dev = shard_local_z_sign(0, n, g, ids)
    assert dev.shape == (4, 1)
    assert dev[:, 0].tolist() == [1.0, 1.0, -1.0, -1.0]
    loc = shard_local_z_sign(3, n, g, ids)
    assert loc.tolist() == [1.0, -1.0, 1.0, -1.0]
    assert shard_local_z_sign(1, n, g, ids)[:, 0].tolist() == [
        1.0, -1.0, 1.0, -1.0]


HAMILTONIANS = {
    "zz_chain": [(-1.0, [i, i + 1]) for i in range(4)] + [(0.5, [0])],
    "z_fields": [(0.3 * (q + 1), [q]) for q in range(5)],
}


@pytest.mark.parametrize("observable", sorted(HAMILTONIANS))
def test_vqe_steps_equal_jax(observable):
    """3 Adam steps of the (traj 2 x amp 4) step: the same costs and
    parameters as the JAX package's. (Every parameter of these costs has
    a gradient well away from 0: Adam divides a gradient by its own
    magnitude, so a parameter whose gradient is float noise, as most
    are under <Z_0> here, moves by +-lr at random in either package.)"""
    c = _ansatz(5, 2)
    ham = HAMILTONIANS[observable]
    jstep = jvqe(c, jmake_vqe_mesh(8), observable=ham, learning_rate=0.2)
    tstep = sharded_vqe_step(port(c), make_vqe_mesh(8, device=CPU),
                             observable=ham, learning_rate=0.2)
    js, jc = jstep.run(3)
    ts, tc = tstep.run(3)
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               atol=1e-5)
    assert tc[-1] < tc[0]


def test_vqe_cost_matches_single_device_and_validates():
    c = port(_ansatz(4, 2))
    step = sharded_vqe_step(c, make_vqe_mesh(4, device=CPU))
    _, cost = step.step(step.init)
    p = tprog.compile_circuit(c)
    psi = tprog.forward_body(p, p.initial_params, CPU).numpy()
    sign = 1 - 2 * ((np.arange(16) >> 3) & 1)
    assert float(cost) == pytest.approx(float((np.abs(psi) ** 2 @ sign)),
                                        abs=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        sharded_vqe_step(c, make_vqe_mesh(4, device=CPU),
                         observable=[(1.0, [99])])
    with pytest.raises(ValueError, match="no trainable"):
        sharded_vqe_step(QuantumCircuit(4), make_vqe_mesh(4, device=CPU))


def test_vqe_grouped_route_matches_per_gate_rows():
    """14 local qubits per amp shard: the cost rows go through the mini
    plans with one operator per row; the same costs as the one-device
    parameter-shift rows."""
    from quantum_simulator_tpu_torch import models

    c = models.hardware_efficient_ansatz(16, 1)
    step = sharded_vqe_step(c, make_vqe_mesh(4, max_amp=4, device=CPU))
    state, cost = step.step(step.init)
    p = tprog.compile_circuit(c)
    psi = tprog.forward_body(p, p.initial_params, CPU).numpy()
    sign = 1 - 2 * ((np.arange(1 << 16) >> 15) & 1)
    assert float(cost) == pytest.approx(float(np.abs(psi) ** 2 @ sign),
                                        abs=1e-5)
    assert torch.isfinite(state.params).all()


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

class _Boom(Exception):
    pass


def _killer(at):
    def progress(i, ns, w):
        if i == at:
            raise _Boom()
    return progress


def test_jax_checkpoint_resumes_in_port(tmp_path):
    c = jbrickwork(9, 12, seed=3)
    with pytest.raises(_Boom):
        JD(n_devices=8).run_segmented(c, 4, progress=_killer(1),
                                      checkpoint_dir=str(tmp_path))
    done = []
    sim = DistributedSimulator(n_devices=8, device=CPU)
    out = sim.run_segmented(port(c), 4,
                            progress=lambda i, ns, w: done.append(i),
                            checkpoint_dir=str(tmp_path))
    assert done == [1, 2]          # segment 0 came from JAX's checkpoint
    np.testing.assert_allclose(out.data, sim.run(port(c)).data, atol=1e-6)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    c = jbrickwork(9, 12, seed=4)
    sim = DistributedSimulator(n_devices=8, device=CPU)
    with pytest.raises(_Boom):
        sim.run_segmented(port(c), 4, progress=_killer(2),
                          checkpoint_dir=str(tmp_path))
    done = []
    out = JD(n_devices=8).run_segmented(
        c, 4, progress=lambda i, ns, w: done.append(i),
        checkpoint_dir=str(tmp_path))
    assert done == [2]
    np.testing.assert_allclose(out.data, sim.run(port(c)).data, atol=1e-6)


def _brickwork(n, depth, seed):
    return port(jbrickwork(n, depth, seed=seed))


_RESUME = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from quantum_simulator_tpu_torch.models import brickwork_circuit
from quantum_simulator_tpu_torch.parallel import DistributedSimulator
done = []
st = DistributedSimulator(n_devices=8, device="cpu").run_segmented(
    brickwork_circuit(9, 12, seed=6), 4, checkpoint_dir=sys.argv[2],
    progress=lambda i, ns, w: done.append(i))
print(json.dumps({"done": done, "amps": st.data.real.tolist(),
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.") or
                                m.startswith("quantum_simulator_tpu."))}))
"""


def test_port_checkpoint_resumes_in_a_new_process(tmp_path):
    """The purpose of a checkpoint is to outlive its process: a new
    process (another string-hash seed, so another ``circuit_hash``)
    resumes through the circuit digest. The JAX package's identity alone
    would restart it from scratch (``ROADMAP.md`` Queue 3). That process
    imports the port's parallel layer and must load no module of JAX or
    of the JAX package."""
    import json
    import os

    from quantum_simulator_tpu_torch.models import brickwork_circuit

    c = brickwork_circuit(9, 12, seed=6)
    sim = DistributedSimulator(n_devices=8, device=CPU)
    with pytest.raises(_Boom):
        sim.run_segmented(c, 4, progress=_killer(1),
                          checkpoint_dir=str(tmp_path))
    env = dict(os.environ, PYTHONHASHSEED="12345")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _RESUME, repo,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=180, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["done"] == [1, 2]
    assert got["jax"] == []
    np.testing.assert_allclose(got["amps"], sim.run(c).data.real,
                               atol=1e-6)


def test_crash_resume_skips_completed_segments(tmp_path):
    sim = DistributedSimulator(n_devices=8, device=CPU)
    c = _brickwork(9, 12, 3)
    with pytest.raises(_Boom):
        sim.run_segmented(c, 4, progress=_killer(1),
                          checkpoint_dir=str(tmp_path))
    done = []
    out = sim.run_segmented(c, 4, progress=lambda i, ns, w: done.append(i),
                            checkpoint_dir=str(tmp_path))
    assert done == [1, 2]
    np.testing.assert_allclose(out.data, sim.run(c).data, atol=1e-6)
    # a changed circuit (same structure, new angles) restarts from scratch
    c2 = _brickwork(9, 12, 99)
    done = []
    out = sim.run_segmented(c2, 4, progress=lambda i, ns, w: done.append(i),
                            checkpoint_dir=str(tmp_path))
    assert done == [0, 1, 2]
    np.testing.assert_allclose(out.data, sim.run(c2).data, atol=1e-6)


def test_old_checkpoints_pruned_and_roundtrip(tmp_path):
    import os

    sim = DistributedSimulator(n_devices=8, device=CPU)
    sim.run_segmented(_brickwork(8, 12, 5), 4, checkpoint_dir=str(tmp_path))
    assert [d for d in os.listdir(tmp_path) if d.startswith("seg_")] == [
        "seg_2"]
    st = sim.run(_brickwork(8, 4, 1))
    checkpoint.save_sharded_state(st.device_data, str(tmp_path / "s"),
                                  sim.mesh, meta={"tag": 7})
    loaded = checkpoint.load_sharded_state(str(tmp_path / "s"), sim.mesh)
    assert torch.equal(loaded, st.device_data)
    assert checkpoint.load_manifest(str(tmp_path / "s"))["meta"]["tag"] == 7


def test_mesh_size_mismatch_raises(tmp_path):
    sim = DistributedSimulator(n_devices=8, device=CPU)
    st = sim.run(_brickwork(8, 2, 1))
    checkpoint.save_sharded_state(st.device_data, str(tmp_path / "s"),
                                  sim.mesh)
    with pytest.raises(ValueError, match="reshard"):
        checkpoint.load_sharded_state(str(tmp_path / "s"),
                                      make_mesh(4, device=CPU))


# ---------------------------------------------------------------------------
# The multi-process seam
# ---------------------------------------------------------------------------

def test_spec_resolution(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    spec = MultiHostSpec.from_env()
    assert (spec.coordinator, spec.num_processes, spec.process_id) == (
        "localhost:8476", 1, 0)
    assert initialize_multihost().num_processes == 1
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    spec = MultiHostSpec.from_env()
    assert spec.coordinator == "10.0.0.1:1234"
    assert spec.num_processes == 4 and spec.process_id == 2
    with pytest.raises(ValueError):
        MultiHostSpec.from_env(num_processes=2, process_id=5)


def test_amp_axis_split_and_rank_major_mesh():
    assert amp_axis_split(16, 2) == (2, 8)
    assert amp_axis_split(16, 4, 4) == (4, 4)
    for bad in ((16, 3), (12, 2)):
        with pytest.raises(ValueError):
            amp_axis_split(*bad)
    mesh = make_multihost_mesh(n_devices=8, device=CPU)
    assert (mesh.world, mesh.local, mesh.shape["amp"]) == (1, 8, 8)
    with pytest.raises(ValueError):
        make_multihost_mesh(n_devices=6, device=CPU)
    # rank-major: shard bit k crosses ranks iff k < log2(ranks)
    dcn, ici = amp_axis_split(8, 2)
    for k in range(3):
        mask = 1 << (2 - k)
        crosses = {d // ici != (d ^ mask) // ici for d in range(8)}
        assert crosses == ({True} if k < 1 else {False})


# ---------------------------------------------------------------------------
# mesh= on the trial-sharded engines
# ---------------------------------------------------------------------------

def test_frame_sweeps_on_a_mesh_equal_one_device():
    mesh = make_mesh(4, device=CPU)
    fr = qec_frame.FrameQECSimulator.from_code(qec.SteaneCode(), CPU)
    a = fr.sweep_raw(0.05, 256, "depolarizing", seed=11)
    b = fr.sweep_raw(0.05, 256, "depolarizing", seed=11, mesh=mesh)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fr.threshold_sweep([0.05, 0.1], 128, seed=3) == \
        fr.threshold_sweep([0.05, 0.1], 128, seed=3, mesh=mesh)
    assert fr.memory_experiment(0.05, 3, 200, meas_error_prob=0.02) == \
        fr.memory_experiment(0.05, 3, 200, meas_error_prob=0.02, mesh=mesh)
    assert qec_frame.FrameQECSimulator.ml_memory_experiment(
        5, 0.05, 3, 300, 0.05, device=CPU) == \
        qec_frame.FrameQECSimulator.ml_memory_experiment(
            5, 0.05, 3, 300, 0.05, device=CPU, mesh=mesh)
    # a host decoder runs the same sweep on a mesh: the same flags
    uf = qec_frame.FrameQECSimulator(qec_frame.surface_code_frame_spec(
        5, "union_find"), CPU)
    a = uf.sweep_raw(0.03, 256, seed=2)
    b = uf.sweep_raw(0.03, 256, seed=2, mesh=mesh)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert uf.memory_experiment(0.05, 2, 10, seed=4) == \
        uf.memory_experiment(0.05, 2, 10, seed=4, mesh=mesh)


def test_circuit_level_memory_on_a_mesh_equals_one_device():
    kw = dict(n_trials=2000, seed=5, device=CPU)
    assert qec_circuit.circuit_level_memory(3, 3, 0.01, **kw) == \
        qec_circuit.circuit_level_memory(3, 3, 0.01,
                                         mesh=make_mesh(8, device=CPU), **kw)


def test_lindblad_mps_on_a_mesh_equals_one_device():
    sim = lindblad_mps.MPSLindbladSimulator(
        4, [(1.0, "ZZ", [0, 1]), (0.7, "X", [2])],
        [(0.2, "sigma_minus", 1), (0.1, "z", 3)], chi=8, device=CPU)
    kw = dict(n_trajectories=16, observables=[("Z", [1]), ("X", [2])],
              seed=4)
    a = sim.evolve(0.5, 5, **kw)
    b = sim.evolve(0.5, 5, mesh=make_mesh(2, device=CPU), **kw)
    np.testing.assert_array_equal(a.expectations, b.expectations)
    np.testing.assert_array_equal(a.stderr, b.stderr)
    assert a.truncation_weight == b.truncation_weight


def test_torch_dryrun_multichip_on_a_cpu_mesh(capsys):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip``: its
    four checks on a 4-shard CPU mesh."""
    import torch_dryrun_multichip

    torch_dryrun_multichip.dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    for what in ("dryrun_multichip OK", "noisy OK", "qec OK",
                 "qft exchange OK"):
        assert what in out
