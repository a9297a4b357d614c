"""The port's command-line twins (``quantum_simulator_tpu_torch/scripts``
and ``entry``) against the JAX scripts and ``__graft_entry__.entry``, on
the CPU at small arguments.

Each JAX script runs in-process as ``tests/test_scripts_and_compat.py``
runs it (once per module, shared by the tests), each twin through its
``main(argv)`` with ``--device cpu``, and the two JSON outputs must have
the same keys, key for key. Tolerances and laws:

* deterministic values: DMRG energies and gaps rel 1e-5; the VQE cost
  trajectory (autodiff, parameter shift, multi-start, MPS) 1e-4; the
  ``sharded_run`` norm 1e-5; ``entry()``'s |psi|^2 1e-5; the schedule
  kinds of ``mesh_stretch_check`` equal and its QFT fidelity > 0.999 on
  both sides;
* stochastic values agree in law: noise-sweep fidelities, QEC logical
  rates and heavy-output means within 5 standard errors of their
  difference (binomial / [0, 1]-bounded variances, or the stderr each
  side reports); the p = 0 noise-sweep point is 1 within 1e-5;
* where the JAX script cannot run on the CPU (``huge_state_check``; the
  hard-coded n = 24 / 30 of ``monitored_check``), the twin's case
  functions run at n = 10-11 (the large-state route forced by
  ``bigstate.HUGE_MIN_QUBITS``) against the JAX ``Simulator`` on the same
  circuits within 1e-5.

Every twin and ``entry()`` fails at once without a card when no device is
named, and no twin writes a file by default.
"""

import builtins
import json
import math
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from quantum_simulator_tpu import Simulator as JSimulator
from quantum_simulator_tpu import QuantumCircuit as JCircuit
from quantum_simulator_tpu_torch import entry as tentry
from quantum_simulator_tpu_torch.examples import (error_mitigation,
                                                  monitored_circuit,
                                                  open_system, qec_memory,
                                                  quench_dynamics,
                                                  quench_spectroscopy,
                                                  quickstart, vqe_at_scale)
from quantum_simulator_tpu_torch.ops import bigstate
from quantum_simulator_tpu_torch.scripts import (circuit_threshold,
                                                 dmrg_solve,
                                                 huge_state_check,
                                                 mesh_stretch_check,
                                                 monitored_check,
                                                 noise_sweep,
                                                 qec_threshold,
                                                 quantum_volume_check,
                                                 sharded_run, vqe_benchmark)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def run_jax(script: str, argv: list[str], tmp: Path) -> dict:
    """A JAX script in-process with ``--output`` (``--out`` for QV)."""
    out = tmp / f"jax_{script}.json"
    flag = "--out" if script == "quantum_volume_check.py" else "--output"
    saved = sys.argv
    sys.argv = [script] + argv + [flag, str(out)]
    try:
        runpy.run_path(str(REPO / "scripts" / script), run_name="__main__")
    except SystemExit as e:
        assert not e.code, f"{script} exited {e.code}"
    finally:
        sys.argv = saved
    return json.loads(out.read_text())


def run_twin(module, argv: list[str], tmp: Path) -> dict:
    out = tmp / f"torch_{module.__name__.rsplit('.', 1)[-1]}.json"
    assert module.main(argv + CPU + ["--output", str(out)]) == 0
    return json.loads(out.read_text())


def same_keys(a, b, path="") -> None:
    """The two outputs have the same keys at every level."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{path}: {sorted(a)} != {sorted(b) if isinstance(b, dict) else b}"
        for k in a:
            same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and a and isinstance(a[0], dict):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_keys(x, y, f"{path}[{i}]")


def in_law(a: float, b: float, var_a: float, var_b: float) -> bool:
    """|a - b| within 5 standard errors of the difference."""
    return abs(a - b) <= 5 * math.sqrt(var_a + var_b) + 1e-12


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("scripts")


# ---------------------------------------------------------------------------
# noise_sweep
# ---------------------------------------------------------------------------

SWEEP = ["--circuit", "ghz3", "--steps", "3", "--trials", "400",
         "--seed", "42"]


@pytest.fixture(scope="module")
def sweeps(tmp):
    return (run_jax("noise_sweep.py", SWEEP, tmp),
            run_twin(noise_sweep, SWEEP, tmp))


def test_noise_sweep_matches_jax_in_law(sweeps):
    jax_out, out = sweeps
    same_keys(jax_out, out)
    T = out["n_trials"]
    for jr, r in zip(jax_out["results"], out["results"]):
        assert r["noise_prob"] == jr["noise_prob"]
        fa, fb = jr["mean_fidelity"], r["mean_fidelity"]
        # per-trajectory fidelities lie in [0, 1]: var <= mu (1 - mu)
        assert in_law(fa, fb, fa * (1 - fa) / T, fb * (1 - fb) / T), (jr, r)
        assert r["mean_purity"] == pytest.approx(1.0, abs=1e-5)
        assert r["mean_entropy"] == 0.0
    assert out["results"][0]["mean_fidelity"] == pytest.approx(1.0,
                                                               abs=1e-5)
    assert out["results"][-1]["mean_fidelity"] < 0.95


# ---------------------------------------------------------------------------
# vqe_benchmark
# ---------------------------------------------------------------------------

VQE_CASES = {
    "autodiff": ["--qubits", "3", "--layers", "2", "--hamiltonian", "zz",
                 "--iters", "12", "--seed", "7"],
    "parameter_shift": ["--qubits", "3", "--layers", "1", "--hamiltonian",
                        "heisenberg", "--iters", "6", "--seed", "3",
                        "--grad", "parameter_shift"],
    "multi_start": ["--qubits", "3", "--layers", "1", "--hamiltonian",
                    "zz", "--iters", "8", "--seed", "5", "--starts", "3"],
    "mps": ["--qubits", "4", "--layers", "1", "--hamiltonian", "zz",
            "--iters", "4", "--seed", "11", "--engine", "mps", "--chi",
            "8"],
}


@pytest.mark.parametrize("case", sorted(VQE_CASES))
def test_vqe_benchmark_cost_trace_matches_jax(tmp, case):
    argv = VQE_CASES[case]
    jax_out = run_jax("vqe_benchmark.py", argv, tmp)
    out = run_twin(vqe_benchmark, argv, tmp)
    same_keys(jax_out, out)
    jr, r = jax_out["result"], out["result"]
    assert r["n_params"] == jr["n_params"]
    assert r["actual_iterations"] == jr["actual_iterations"]
    np.testing.assert_allclose(r["cost_trace"], jr["cost_trace"],
                               atol=1e-4, rtol=0)
    assert r["optimal_cost"] == pytest.approx(jr["optimal_cost"], abs=1e-4)
    if case == "multi_start":
        np.testing.assert_allclose(r["start_costs"], jr["start_costs"],
                                   atol=1e-4, rtol=0)
        assert r["best_start"] == jr["best_start"]


def test_vqe_benchmark_finite_difference_descends(tmp):
    """Finite differences of float32 costs: the descent, not the digits
    (a 1e-4 difference quotient moves ~5e-4 with the cost's rounding)."""
    argv = ["--qubits", "2", "--layers", "1", "--iters", "15", "--seed",
            "42", "--grad", "finite_difference"]
    jax_out = run_jax("vqe_benchmark.py", argv, tmp)
    out = run_twin(vqe_benchmark, argv, tmp)
    same_keys(jax_out, out)
    r = out["result"]
    assert r["gradient_method"] == "finite_difference"
    assert r["initial_cost"] == pytest.approx(
        jax_out["result"]["initial_cost"], abs=1e-2)
    assert r["optimal_cost"] < r["initial_cost"] - 0.1


# ---------------------------------------------------------------------------
# qec_threshold and circuit_threshold
# ---------------------------------------------------------------------------

QEC_CASES = {
    "statevector": ["--codes", "bit_flip,steane", "--trials", "200",
                    "--seed", "42", "--noise", "depolarizing"],
    "frame": ["--codes", "repetition:5,surface:3", "--trials", "400",
              "--seed", "9", "--engine", "frame"],
}


@pytest.mark.parametrize("case", sorted(QEC_CASES))
def test_qec_threshold_matches_jax_in_law(tmp, case):
    argv = QEC_CASES[case]
    jax_out = run_jax("qec_threshold.py", argv, tmp)
    out = run_twin(qec_threshold, argv, tmp)
    same_keys(jax_out, out)
    for jc, c in zip(jax_out["codes"], out["codes"]):
        for k in ("code", "data_qubits", "total_qubits", "code_distance"):
            assert c[k] == jc[k]
        T = c["n_trials"]
        for jp, p in zip(jc["sweep"], c["sweep"]):
            assert p["physical_rate"] == jp["physical_rate"]
            a, b = jp["logical_rate"], p["logical_rate"]
            assert in_law(a, b, a * (1 - a) / T, b * (1 - b) / T), (jp, p)


def test_circuit_threshold_matches_jax_in_law(tmp):
    argv = ["--distances", "3", "--probs", "0.006,0.012", "--rounds",
            "2", "--trials", "3000", "--seed", "4"]
    jax_out = run_jax("circuit_threshold.py", argv, tmp)
    out = run_twin(circuit_threshold, argv, tmp)
    same_keys(jax_out, out)
    for jr, r in zip(jax_out["rows"], out["rows"]):
        assert (r["distance"], r["noise_prob"]) == (jr["distance"],
                                                     jr["noise_prob"])
        a = jr["logical_failure_probability"]
        b = r["logical_failure_probability"]
        T = out["trials"]
        assert in_law(a, b, a * (1 - a) / T, b * (1 - b) / T), (jr, r)


# ---------------------------------------------------------------------------
# dmrg_solve
# ---------------------------------------------------------------------------

def test_dmrg_solve_matches_jax(tmp):
    argv = ["--qubits", "10", "--hamiltonian", "tfim", "--j", "-1.0",
            "--h", "-1.3", "--chi", "8", "--sweeps", "3", "--states", "2"]
    jax_out = run_jax("dmrg_solve.py", argv, tmp)
    out = run_twin(dmrg_solve, argv, tmp)
    same_keys(jax_out, out)
    np.testing.assert_allclose(out["energies"], jax_out["energies"],
                               rtol=1e-5)
    np.testing.assert_allclose(out["gaps"], jax_out["gaps"], rtol=1e-5)
    assert out["overlaps"][0]["abs_overlap"] < 1e-4


# ---------------------------------------------------------------------------
# quantum_volume_check
# ---------------------------------------------------------------------------

def test_quantum_volume_matches_jax_in_law(tmp):
    argv = ["--widths", "4", "--trials", "20", "--chunk", "10",
            "--noise-p", "0.01", "--seed", "3"]
    jax_out = run_jax("quantum_volume_check.py", argv, tmp)
    out = run_twin(quantum_volume_check, argv, tmp)
    same_keys(jax_out, out)
    assert out["on_device"] is False and out["platform"].startswith("cpu")
    for jw, w in zip(jax_out["results_per_width"],
                     out["results_per_width"]):
        assert w["width"] == jw["width"]
        for mean, err in (("heavy_output_mean", "heavy_output_stderr"),
                          ("heavy_output_ideal_mean",
                           "heavy_output_ideal_stderr")):
            if err in w:
                assert in_law(jw[mean], w[mean], jw[err] ** 2,
                              w[err] ** 2), (jw, w)


# ---------------------------------------------------------------------------
# sharded_run and mesh_stretch_check
# ---------------------------------------------------------------------------

def test_sharded_run_matches_jax(tmp):
    argv = ["--template", "brickwork", "--qubits", "10", "--depth", "6",
            "--devices", "4", "--shots", "500", "--noise-p", "0.02"]
    jax_out = run_jax("sharded_run.py", argv, tmp)
    out = run_twin(sharded_run, argv, tmp)
    same_keys(jax_out, out)
    assert out["mesh_devices"] == jax_out["mesh_devices"] == 4
    assert out["norm"] == pytest.approx(jax_out["norm"], abs=1e-5)
    assert 0.0 <= out["noisy_trajectory_fidelity"] <= 1.0 + 1e-6
    assert all(len(k) == 10 for k in out["top_counts"])


def test_mesh_stretch_check_matches_jax(tmp):
    argv = ["--qubits", "12", "--devices", "4", "--depth", "8",
            "--shots", "300"]
    jax_out = run_jax("mesh_stretch_check.py", argv, tmp)
    out = run_twin(mesh_stretch_check, argv + ["--segment-cols", "4",
                                               "--checkpoint-dir",
                                               str(tmp / "ck")], tmp)
    same_keys(jax_out, out)
    jq, q = jax_out["checks"], out["checks"]
    assert q["qft_schedule"] == jq["qft_schedule"]
    assert q["brickwork"]["schedule"] == jq["brickwork"]["schedule"]
    assert jq["qft"]["fidelity_vs_analytic"] > 0.999
    assert q["qft"]["fidelity_vs_analytic"] > 0.999
    assert q["qft"]["b"] == jq["qft"]["b"]
    np.testing.assert_allclose(q["brickwork"]["z_probes"],
                               jq["brickwork"]["z_probes"], atol=1e-5)


def test_dft_overlap_is_exact_at_32_bits():
    """b k mod 2^32 in int64 halves: the analytic row itself has overlap
    sum |a_k|^2 (4 shards of 2^15 amplitudes, so k crosses 2^16)."""
    n, b = 32, 0xDEADBEEF
    mesh = mesh_stretch_check.make_mesh(4, device="cpu")
    N = 1 << 15
    k = np.arange(4 * N, dtype=np.int64).reshape(4, N)
    ph = 2 * np.pi * ((b * k) % (1 << n)) / 2.0 ** n
    stack = torch.from_numpy(np.stack([np.cos(ph), np.sin(ph)], 1)
                             * 2.0 ** (-n / 2)).float()
    ov = mesh_stretch_check.dft_overlap(stack, mesh, b, n)
    want = 4 * N * 2.0 ** -n
    assert ov.real == pytest.approx(want, rel=1e-6)
    assert abs(ov.imag) < 1e-5 * want


# ---------------------------------------------------------------------------
# monitored_check and huge_state_check (case functions at small n)
# ---------------------------------------------------------------------------

def _jax_state(circuit) -> np.ndarray:
    jc = JCircuit.from_dict(circuit.to_dict())
    return np.asarray(JSimulator().run(jc, shots=0).final_state.data)


def test_monitored_ghz_group_case_collapses_jax_state():
    n = 10
    rec, outs, states = monitored_check.ghz_group_case(n, "cpu")
    assert set(rec) == {"trajectories", "seconds_cold",
                        "outcomes_correlated", "collapsed_state_exact",
                        "branch_counts"}
    psi = _jax_state(_drop_measures(monitored_check.ghz(n, n)))
    for t, st in enumerate(states):
        idx = (2 ** n - 1) if outs[t, 0] else 0
        want = np.zeros_like(psi)
        want[idx] = psi[idx] / abs(psi[idx])
        np.testing.assert_allclose(st.data, want, atol=1e-5)


def _drop_measures(c):
    d = c.to_dict()
    d["gates"] = [g for g in d["gates"] if g["name"] != "Measure"]
    return type(c).from_dict(d)


def test_monitored_noisy_brickwork_case():
    rec = monitored_check.noisy_brickwork_case(12, "cpu", 8)
    assert set(rec) == {"trajectories", "monitor_sites", "seconds_cold",
                        "seconds_warm", "traj_per_sec_warm",
                        "outcome_freqs"}
    assert rec["monitor_sites"] == 2
    assert all(0.0 <= f <= 1.0 for f in rec["outcome_freqs"])


def test_monitored_huge_case_at_small_n(monkeypatch):
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    rec = monitored_check.ghz_huge_case(10, "cpu", final_shots=64)
    assert rec["samples_match_collapse_exactly"]
    assert set(rec["branches"]) <= {0, 1} and len(rec["branches"]) == 6


@pytest.mark.parametrize("case", huge_state_check.CASES,
                         ids=lambda f: f.__name__)
def test_huge_state_case_at_small_n(monkeypatch, case):
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    n = 10
    res, checks = case(huge_state_check.Simulator(device="cpu"), n)
    assert all(ok for _, ok, _ in checks), checks
    fs = res.final_state
    assert isinstance(fs, bigstate.PlanarStateVector)
    width = fs.num_qubits
    circuit = {
        "case_real": lambda: huge_state_check.brickwork(n, 4, 7),
        "case_complex": lambda: huge_state_check.brickwork(n, 2, 7, True),
        "case_qft": lambda: huge_state_check.AlgorithmTemplate
        .quantum_fourier_transform(n),
        "case_wide": lambda: huge_state_check.brickwork(n + 1, 4, 9),
        "case_grover": lambda: huge_state_check.AlgorithmTemplate
        .grover_search(n, marked_state=huge_state_check.GROVER_MARKED
                       % (1 << n), num_iterations=3),
    }[case.__name__]()
    assert circuit.num_qubits == width
    x = fs.state_data
    got = torch.complex(x[0], x[1]) if fs.is_planar else x
    np.testing.assert_allclose(got.reshape(-1).numpy(), _jax_state(circuit),
                               atol=1e-5)


def test_huge_state_check_refuses_the_host():
    assert huge_state_check.main(CPU) == 2


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------

def test_entry_matches_jax_entry():
    fn, args = tentry.entry("cpu")
    got = fn(*args)
    assert got.shape == (1 << 16,) and args[0].device.type == "cpu"
    jfn, jargs = jentry.entry()
    np.testing.assert_allclose(args[0].numpy(), np.asarray(jargs[0]),
                               atol=1e-7)
    want = np.asarray(jfn(*jargs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    twin_fn, _ = tentry.entry("cpu", plain=True)
    np.testing.assert_allclose(twin_fn(*args).numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# every twin: no card and no --device fails at once; no file by default
# ---------------------------------------------------------------------------

TWINS = {
    "circuit_threshold": circuit_threshold, "dmrg_solve": dmrg_solve,
    "huge_state_check": huge_state_check,
    "mesh_stretch_check": mesh_stretch_check,
    "monitored_check": monitored_check, "noise_sweep": noise_sweep,
    "qec_threshold": qec_threshold,
    "quantum_volume_check": quantum_volume_check,
    "sharded_run": sharded_run, "vqe_benchmark": vqe_benchmark,
    "error_mitigation": error_mitigation,
    "monitored_circuit": monitored_circuit, "open_system": open_system,
    "qec_memory": qec_memory, "quench_dynamics": quench_dynamics,
    "quench_spectroscopy": quench_spectroscopy, "quickstart": quickstart,
    "vqe_at_scale": vqe_at_scale, "entry": tentry,
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_no_card_and_no_device_fails_at_once(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # nothing may simulate: any engine construction fails the test
    from quantum_simulator_tpu_torch import simulator
    monkeypatch.setattr(simulator.Simulator, "__init__",
                        lambda *a, **k: pytest.fail("simulated"))
    assert TWINS[name].main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    if name == "entry":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tentry.entry()


# Small arguments of each twin's run with its default outputs.
SMALL = {
    "circuit_threshold": ["--distances", "3", "--probs", "0.01",
                          "--trials", "200"],
    "dmrg_solve": ["--qubits", "6", "--chi", "4", "--sweeps", "2"],
    "huge_state_check": [],
    "mesh_stretch_check": ["--qubits", "10", "--devices", "4", "--depth",
                           "4", "--shots", "50"],
    "monitored_check": ["--trajectories", "4"],
    "noise_sweep": ["--steps", "2", "--trials", "8"],
    "qec_threshold": ["--codes", "bit_flip", "--trials", "20"],
    "quantum_volume_check": ["--widths", "4", "--trials", "4", "--chunk",
                             "4"],
    "sharded_run": ["--qubits", "6", "--devices", "2", "--shots", "50"],
    "vqe_benchmark": ["--iters", "2"],
    "entry": [],
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_default_run_writes_no_file(monkeypatch, tmp_path, name):
    """Run with its default outputs from an empty working directory:
    nothing is opened for writing (examples: ``tests/
    test_torch_examples.py``)."""
    if name == "monitored_check":      # n = 24 / 30 are for the card
        real = {k: getattr(monitored_check, k) for k in (
            "ghz_group_case", "noisy_brickwork_case", "ghz_huge_case")}
        monkeypatch.setattr(monitored_check, "ghz_group_case",
                            lambda n, dev: real["ghz_group_case"](8, dev))
        monkeypatch.setattr(
            monitored_check, "noisy_brickwork_case",
            lambda n, dev, T: real["noisy_brickwork_case"](8, dev, T))
        monkeypatch.setattr(
            monitored_check, "ghz_huge_case",
            lambda n, dev: real["ghz_huge_case"](9, dev, final_shots=16))
        monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 9)
    written = []
    real_open = builtins.open

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    monkeypatch.setattr(builtins, "open", recording_open)
    monkeypatch.chdir(tmp_path)
    rc = TWINS[name].main(SMALL[name] + CPU)
    assert rc == (2 if name == "huge_state_check" else 0)
    assert written == [] and list(tmp_path.iterdir()) == []
