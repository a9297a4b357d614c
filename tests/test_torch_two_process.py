"""A real two-process ``torch.distributed`` run of the port's mesh.

Two local CPU processes join a gloo group through ``initialize_multihost``
over a localhost coordinator and build the rank-major 8-shard mesh (2
ranks x 4 shards) with ``make_multihost_mesh``. GHZ-12 puts its H on
qubit 0, the rank bit, so the forward path's exchanges cross the process
boundary (``batch_isend_irecv``), and so do the sampler's all_gather,
the reductions' all_reduce, the one-qubit rho and Pauli strings of
shard-bit qubits, the VQE step's cost gather, the trial gathers of the
frame sweeps (one with a host decoder) and the circuit-level memory, a
noisy trajectory's global
branch weights, and a checkpointed segmented run (every rank writes its
shards, rank 0 the manifest) stopped and resumed; under
``config.enable_complex128`` a per-gate and a grouped run move float64
planes across the ranks, with a reduction, a sample and a VQE step on
them. Every result must equal the one-process 8-shard mesh's: states
within 1e-6 (float64 ones within 1e-12), the reductions within 1e-6, the
VQE cost and parameters within 1e-6, the flags and the memory report
exactly; the counts as in ``tests/test_two_process.py``.

Each process has a hard time limit (``communicate(timeout=...)``) and
the group one for its init and collectives, so the test can neither hang
nor run past the suite's limit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

_WORKER = r"""
import json, sys
port, pid, out, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import torch
torch.set_num_threads(1)
from tests.test_torch_two_process import mesh_results
from quantum_simulator_tpu_torch.parallel import (
    MultiHostSpec, initialize_multihost, make_multihost_mesh, make_vqe_mesh)

initialize_multihost(MultiHostSpec(f"localhost:{port}", 2, pid),
                     device="cpu", timeout_s=120)
mesh = make_multihost_mesh(n_devices=8, device="cpu")
assert (mesh.world, mesh.local, mesh.rank) == (2, 4, pid), mesh
res = mesh_results(mesh, make_vqe_mesh(8, device="cpu"), sys.argv[5])
if pid == 0:
    json.dump(res, open(out, "w"))
torch.distributed.destroy_process_group()
"""


def mesh_results(mesh, vqe_mesh, workdir: str) -> dict:
    """Everything the test compares, on ``mesh`` (2 x 4 or 1 x 8);
    ``workdir`` holds the checkpoints."""
    from quantum_simulator_tpu_torch import (DepolarizingNoise, NoiseModel,
                                             QuantumCircuit, config, qec,
                                             qec_circuit, qec_frame)
    from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
    from quantum_simulator_tpu_torch.models import (brickwork_circuit,
                                                    hardware_efficient_ansatz)
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      sharded_vqe_step)

    sim = DistributedSimulator(mesh)
    st = sim.run(AlgorithmTemplate.ghz_state(12))
    wide = sim.run(brickwork_circuit(17, 4, seed=2))     # grouped route
    rho = sim.qubit_density_matrices(wide)
    ansatz = hardware_efficient_ansatz(6, 2).to_dict()
    angles = np.random.default_rng(4)
    for gd in ansatz["gates"]:
        gd["params"] = [float(angles.uniform(-3, 3)) for _ in gd["params"]]
    step = sharded_vqe_step(QuantumCircuit.from_dict(ansatz), vqe_mesh,
                            observable=[(1.0, [0, 5]), (0.5, [2])])
    vstate, cost = step.step(step.init)
    fr = qec_frame.FrameQECSimulator.from_code(qec.SteaneCode(), "cpu")
    flags = fr.sweep_raw(0.08, 100, "depolarizing", seed=11, mesh=mesh)
    uf = qec_frame.FrameQECSimulator(qec_frame.surface_code_frame_spec(
        3, "union_find"), "cpu")                       # a host decoder
    uf_flags = uf.sweep_raw(0.05, 64, seed=2, mesh=mesh)
    memory = qec_circuit.circuit_level_memory(3, 3, 0.01, 300, seed=2,
                                              device="cpu", mesh=mesh)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.1))
    noisy = sim.run_noisy_trajectory(brickwork_circuit(12, 4, seed=3), nm,
                                     seed=9)

    class Stop(Exception):
        pass

    def stop(i, ns, w):
        if i == 1:
            raise Stop()

    deep = brickwork_circuit(12, 8, seed=4)
    ck = f"{workdir}/ck_{mesh.world}"
    try:
        sim.run_segmented(deep, 2, progress=stop, checkpoint_dir=ck)
    except Stop:
        pass
    resumed_at = []
    resumed = sim.run_segmented(deep, 2, checkpoint_dir=ck,
                                progress=lambda i, ns, w: resumed_at.append(i))
    config.enable_complex128()
    try:
        per_gate = sim.run(brickwork_circuit(12, 4, seed=5))
        grouped = sim.run(brickwork_circuit(17, 2, seed=6))
        step64 = sharded_vqe_step(QuantumCircuit.from_dict(ansatz), vqe_mesh,
                                  observable=[(1.0, [0, 5]), (0.5, [2])])
        f64 = {"dtypes": [str(per_gate.device_data.dtype),
                          str(grouped.device_data.dtype)],
               "per_gate": [per_gate.data.real.tolist(),
                            per_gate.data.imag.tolist()],
               "grouped_head": [grouped.data[:256].real.tolist(),
                                grouped.data[:256].imag.tolist()],
               "z": sim.expectation_z(grouped, 0),
               "counts": sim.sample(per_gate, 500,
                                    np.random.default_rng(5)),
               "vqe": float(step64.step(step64.init)[1])}
    finally:
        config.enable_complex64()
    return {
        "f64": f64,
        "ghz": [st.data.real.tolist(), st.data.imag.tolist()],
        "z": [sim.expectation_z(st, 0), sim.expectation_z(st, 11)],
        "counts": sim.sample(st, 2000, np.random.default_rng(3)),
        "wide_norm": wide.norm(),
        "wide_head": np.abs(wide.data[:64]).tolist(),
        "rho": [rho.real.tolist(), rho.imag.tolist()],
        "pauli": [sim.expectation_pauli_string(wide, [0, 5], "XY"),
                  sim.expectation_pauli_string(wide, [1, 16], "YX")],
        "vqe": [float(cost), vstate.params.tolist()],
        "flags": [f.tolist() for f in flags],
        "uf_flags": [f.tolist() for f in uf_flags],
        "memory": memory,
        "noisy": np.abs(noisy.data).tolist(),
        "resumed_at": resumed_at,
        "resumed": np.abs(resumed.data).tolist(),
    }


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_matches_one_process(tmp_path):
    from quantum_simulator_tpu_torch.parallel import make_mesh, make_vqe_mesh

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result.json"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(pid), str(out), REPO,
         str(tmp_path)],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=TIMEOUT_S)
            logs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    got = json.loads(out.read_text())
    want = json.loads(json.dumps(mesh_results(
        make_mesh(8, device="cpu"), make_vqe_mesh(8, device="cpu"),
        str(tmp_path))))

    np.testing.assert_allclose(got["ghz"], want["ghz"], atol=1e-6)
    ghz = np.asarray(got["ghz"][0])
    assert abs(ghz[0] - 2 ** -0.5) < 1e-6 and abs(ghz[-1] - 2 ** -0.5) < 1e-6
    np.testing.assert_allclose(got["z"], [0.0, 0.0], atol=1e-5)
    counts = got["counts"]
    assert set(counts) == {"0" * 12, "1" * 12}
    assert sum(counts.values()) == 2000
    assert 0.42 < counts["0" * 12] / 2000 < 0.58
    assert got["wide_norm"] == pytest.approx(1.0, abs=1e-5)
    for key in ("wide_head", "rho", "pauli"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    assert got["vqe"][0] == pytest.approx(want["vqe"][0], abs=1e-6)
    np.testing.assert_allclose(got["vqe"][1], want["vqe"][1], atol=1e-6)
    assert got["flags"] == want["flags"]
    assert got["uf_flags"] == want["uf_flags"]
    assert got["memory"] == want["memory"]
    np.testing.assert_allclose(got["noisy"], want["noisy"], atol=1e-6)
    assert got["resumed_at"] == want["resumed_at"] == [1, 2, 3]
    np.testing.assert_allclose(got["resumed"], want["resumed"], atol=1e-6)
    f64, want64 = got["f64"], want["f64"]
    assert f64["dtypes"] == want64["dtypes"] == ["torch.float64"] * 2
    for key in ("per_gate", "grouped_head", "z", "vqe"):
        np.testing.assert_allclose(f64[key], want64[key], rtol=0,
                                   atol=1e-12)
    assert f64["counts"] == want64["counts"]
    assert torch.distributed.is_available()
