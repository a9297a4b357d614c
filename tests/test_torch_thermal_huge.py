"""The thermal-relaxation configuration of the benchmark
(``qsbench/configs/esu2_30_thermal.json``) on the CPU: the n >= 30
trajectory entry (``Simulator.run_with_noise`` -> ``_run_with_noise_huge``
-> the monomial splice) forced at a few qubits by lowering
``bigstate.HUGE_MIN_QUBITS``, held to the plain Kraus reference
(``qsbench/reference/kraus.py``) through the cell's own entry and check.

Tolerances and why:

* a port trajectory against the float64 replay of its own branches: 1e-5
  relative in the 2-norm, the executor tolerance (complex64 products and
  sums in another order over a few hundred gates and sites: about 1e-7
  here);
* the reference's thermal Kraus operators against the port's: 1e-12
  (float64 rounding of the same closed forms).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import quantum_simulator_tpu_torch as tq
from qsbench.cell import Manifest
from qsbench.check import judge
from qsbench.control_thermal import planted
from qsbench.reference import kraus
from qsbench.reference import statevector as sv
from quantum_simulator_tpu_torch.ops import bigstate, monomial_traj
from quantum_simulator_tpu_torch.ops import program as prog
from quantum_simulator_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MANIFEST = Manifest()
CELL = "esu2_30_thermal.noisy"
CONFIG = MANIFEST.config("esu2_30_thermal")
FAMILY = MANIFEST.module("families", CONFIG["family"])
TRAFFIC = MANIFEST.traffic(MANIFEST.workload(CELL)["traffic"])
ENTRY = MANIFEST.module("entries", TRAFFIC["entry"])
LIMITS = MANIFEST.limits(CELL)


def circuit(n, seed, stronger=1.0):
    """The configuration's circuit dict at ``n`` qubits; ``stronger``
    multiplies every gate time, so that a kept trajectory surely jumps."""
    c = FAMILY.circuit(dict(CONFIG, num_qubits=n),
                       np.random.default_rng(seed))
    for ch in c["noise"]:
        ch["time"] *= stronger
    return c


def program_of(c):
    return prog.compile_circuit(tq.QuantumCircuit.from_dict(
        {k: v for k, v in c.items() if k != "noise"}))


@pytest.fixture
def huge(monkeypatch):
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 8)
    # a planted fault changes Kraus operators under the same spec key
    monkeypatch.setattr(monomial_traj, "_SPEC_CACHE", {})


def served(circuits, traffic=TRAFFIC):
    """The cell's answers for ``circuits``, every request kept."""
    serve = ENTRY.serve_fn(tq, traffic, "cpu")
    return [(c, ENTRY.answer(serve(c, 100 + i, keep=True)))
            for i, c in enumerate(circuits)]


def numbers(answers, seed=5):
    return ENTRY.check_answers(answers, TRAFFIC, "cpu", seed=seed)


def test_the_30_qubit_plan_built_on_the_host():
    """91 windows: one after the first Ry layer, 28 in each CX chain (every
    CX touches the qubit of the last one's pending sites) and 2 at each
    later rotation layer; 294 sites (120 Ry, 174 CX)."""
    c = circuit(30, 0)
    nm = ENTRY.noise_model(tq, c["noise"])
    spec = monomial_traj.monomial_spec(program_of(c), nm)
    assert len(spec.windows) == 1 + 3 * 28 + 3 * 2 == 91
    assert len(spec.segments) == 92
    assert spec.n_site_keys == len(kraus.site_channels(c, c["noise"])) \
        == 120 + 174
    assert not spec.real
    from quantum_simulator_tpu_torch.ops import bigtraj
    assert bigtraj.trajectory_evolve_route(program_of(c), nm) == "monomial"


def test_reference_kraus_operators_are_the_ports():
    for ch in CONFIG["noise"]:
        mine = np.array(kraus.channel_kraus(ch), dtype=np.complex128)
        port = np.stack(tq.ThermalRelaxationNoise(
            ch["t1"], ch["t2"], ch["time"]).get_kraus_operators())
        np.testing.assert_allclose(mine, port, atol=1e-12)
        total = sum(k.conj().T @ k for k in mine)
        np.testing.assert_allclose(total, np.eye(2), atol=1e-12)


@pytest.mark.parametrize("n", [8, 10])
def test_trajectories_follow_the_replay_of_their_draws(huge, n):
    answers = served([circuit(n, n, stronger=20.0)])
    rows = answers[0][1]["rows"]
    assert len(rows) == TRAFFIC["trajectories"]
    assert all(r["route"] == "monomial" for r in rows)
    kept = [r for r in rows if r["state"] is not None]
    assert len(kept) == 1
    assert ENTRY._jumps("monomial", kept[0]["draws"]) > 0
    gap = ENTRY.state_gap(answers[0][0], kept[0], "cpu")
    assert gap < 1e-5
    for row in rows:
        assert row["indices"].shape == (TRAFFIC["shots"]
                                         // TRAFFIC["trajectories"],)


def test_the_cells_check_passes_the_port(huge):
    answers = served([circuit(9, s) for s in (1, 2)])
    got = numbers(answers)
    assert got["shots_missing"] == 0
    assert got["traj_gap"] < 1e-5
    assert judge(got, LIMITS), got


def test_noise_left_out_fails_the_check(huge):
    """Every Kraus operator of the relaxation replaced by the identity:
    the port runs the ideal circuit through the same route."""
    with planted("fault-noiseless"):
        got = numbers(served([circuit(9, s) for s in (1, 2)]))
    assert not judge(got, LIMITS), got
    assert got["traj_gap"] > LIMITS["traj_gap"]


# stronger relaxation and many trajectories a request, so that the law of
# the first jump has the power to see a rate off by two
LAW_TRAFFIC = dict(TRAFFIC, trajectories=60, shots=60 * 16)


def law_numbers(fault):
    circuits = [circuit(8, s, stronger=6.0) for s in (11, 12)]
    with planted(fault) if fault else contextlib.nullcontext():
        answers = served(circuits, LAW_TRAFFIC)
    return ENTRY.check_answers(answers, LAW_TRAFFIC, "cpu")


@pytest.mark.parametrize("fault", [None, "fault-noiseless",
                                   "fault-doublerate", "fault-halfrate"])
def test_the_law_counts_no_jump_trajectories(huge, fault):
    """The port's first jumps against the reference's probabilities along
    the no-jump row: within the limit of their law, and past it with the
    noise left out or with the jump branches drawn at twice or half their
    weight (their states true to their draws)."""
    got = law_numbers(fault)
    assert got["shots_missing"] == 0
    if fault is None:
        assert judge(got, LIMITS), got
        return
    assert got["law_absz"] > LIMITS["law_absz"], got
    if fault != "fault-noiseless":
        assert got["traj_gap"] < LIMITS["traj_gap"], got


def test_the_law_z_of_reference_draws():
    """``kraus.sample``'s own draws, read as a program's, pass the law."""
    c = circuit(8, 13, stronger=6.0)
    gen = torch.Generator().manual_seed(17)
    _, rows = kraus.sample(c, c["noise"], 120, 1, gen, "cpu",
                           with_branches=True)
    hazard, _, _ = kraus.no_jump_path(c, c["noise"], "cpu")
    law = ENTRY.FirstJumpLaw()
    for t in range(len(rows)):
        law.add(rows[t:t + 1], hazard)
    assert law.jumps > 40
    assert law.absz() <= LIMITS["law_absz"]


def test_counts_follow_kraus_sample(huge):
    """One shot a trajectory, so that shots are independent: the port's
    trajectories against as many independent ``kraus.sample`` ones, by two
    two-sample z's: the jumps a trajectory and the shot's count of ones
    (relaxation moves amplitude to 0)."""
    c = circuit(8, 14, stronger=6.0)
    T = 120
    traffic = dict(TRAFFIC, trajectories=T, shots=T)
    rows = served([c], traffic)[0][1]["rows"]
    port_jumps = torch.tensor([float(ENTRY.branch_row(r).count_nonzero())
                               for r in rows])
    port_ones = torch.cat([r["indices"] for r in rows])
    gen = torch.Generator().manual_seed(19)
    idx, branches = kraus.sample(c, c["noise"], T, 1, gen, "cpu",
                                 with_branches=True)
    ref_jumps = (branches != 0).sum(1).double()

    def ones(idx):
        return torch.tensor([bin(int(i)).count("1") for i in idx.view(-1)],
                            dtype=torch.float64)

    for a, b in ((port_jumps.double(), ref_jumps),
                 (ones(port_ones), ones(idx))):
        z = (a.mean() - b.mean()) / (a.var() / len(a)
                                     + b.var() / len(b)).sqrt()
        assert abs(float(z)) <= 4.0, (a.mean(), b.mean())
    assert float(ref_jumps.mean()) > 0.5


def test_swapped_jump_operators_fail_the_check(huge):
    with planted("fault-swapjumps"):
        got = numbers(served([circuit(9, s, stronger=20.0) for s in (1, 2)]))
    assert not judge(got, LIMITS), got
    assert got["traj_gap"] > 1e-2


def test_a_skipped_cx_site_fails_the_check(huge):
    """The Kraus operator of one CX site (its second qubit's, in the first
    window that holds one) replaced by the identity, its draw kept."""
    with planted("fault-skipsite"):
        got = numbers(served([circuit(9, s) for s in (1, 2)]))
    assert not judge(got, LIMITS), got
    assert got["traj_gap"] > LIMITS["traj_gap"]


def test_the_tf32_control_fails_the_replay(huge):
    """The reference in TF32 in the program's place: its replay of a
    trajectory's branches lies past the limit from the float64 one."""
    c = circuit(10, 3, stronger=20.0)
    branch = ENTRY.branch_row(served([c])[0][1]["rows"][0])
    r = kraus.replay(c, c["noise"], branch, "cpu")
    t = kraus.replay(c, c["noise"], branch, "cpu", precision="tf32")
    gap = float(((t[0].double() - r[0]).square()
                 + (t[1].double() - r[1]).square()).sum().sqrt())
    assert gap > LIMITS["traj_gap"]


def test_recording_sees_one_sample_a_window(huge):
    c = circuit(9, 4)
    nm = ENTRY.noise_model(tq, c["noise"])
    spec = monomial_traj.monomial_spec(program_of(c), nm)
    windows = monomial_traj._run_windows.windows
    sites = monomial_traj._run_windows.sites
    sim = tq.Simulator(noise_model=nm, device="cpu")
    qc = tq.QuantumCircuit.from_dict(
        {k: v for k, v in c.items() if k != "noise"})
    T = 3
    with profiling.recording() as rec:
        sim.run_with_noise(qc, shots=64, seed=1, trajectories=T)
    names = [s.name for s in rec.spans]
    assert names.count("traj.huge") == T
    assert names.count("mono.sample") == T * len(spec.windows)
    assert names.count("mono.draws") == T * len(spec.windows)
    assert names.count("mono.window") == T * len(spec.segments)
    samples = [p for p in rec.passes if p.kind == "sample"]
    assert len(samples) == T * len(spec.windows)
    assert all(p.state_bytes == 2 * 4 * 2 ** 9 for p in samples)
    assert monomial_traj._run_windows.windows - windows \
        == T * len(spec.windows)
    assert monomial_traj._run_windows.sites - sites \
        == T * spec.n_site_keys
    # a second request with fresh angles builds no plan: every segment's
    # key is the structure's, the same in every request
    from quantum_simulator_tpu_torch.ops import plan as tplan
    plans = set(tplan._PLANS)
    again = circuit(9, 5)
    sim.run_with_noise(tq.QuantumCircuit.from_dict(
        {k: v for k, v in again.items() if k != "noise"}), shots=64, seed=2,
        trajectories=T)
    assert set(tplan._PLANS) == plans
    assert len(spec.segments) <= 128


def test_no_record_while_off(huge):
    c = circuit(8, 6)
    sim = tq.Simulator(noise_model=ENTRY.noise_model(tq, c["noise"]),
                       device="cpu")
    qc = tq.QuantumCircuit.from_dict(
        {k: v for k, v in c.items() if k != "noise"})
    assert profiling._recording is None
    sim.run_with_noise(qc, shots=16, seed=2, trajectories=2)
    assert profiling._recording is None


def _exact_diagonal(c):
    """The noisy law over basis states by summing every branch row."""
    noise = c["noise"]
    sites = len(kraus.site_channels(c, noise))
    rows = torch.cartesian_prod(*[torch.arange(3)] * sites) \
        if sites > 1 else torch.arange(3).view(-1, 1)
    # the unnormalized branch states: replay normalizes, so weigh by the
    # branch probability, the norm of the unnormalized state
    n = c["num_qubits"]
    total = torch.zeros(1 << n, dtype=torch.float64)
    ar = kraus.Arith("float64")
    stacks = kraus._stacks(noise, "cpu", torch.float64)
    for row in rows.view(-1, sites):
        re, im = sv.basis_state(n, 1, "cpu", "float64")
        s = 0
        for g in sv.ordered_gates(c):
            sv.apply_gate(re, im, n, g, ar)
            for ci, ch in enumerate(noise):
                if g["name"] not in ch["gates"]:
                    continue
                k_re, k_im = stacks[ci]
                for q in g["targets"]:
                    m = row[s:s + 1]
                    kraus._apply_kraus(re, im, n, q, k_re[m], k_im[m], ar)
                    s += 1
        total += sv.probabilities(re, im)[0]
    return total


def test_sampled_trajectories_follow_the_channel():
    """At two qubits with strong relaxation the sequential sampler's
    shots follow the exact noisy law (the sum over all branch rows)."""
    c = {"num_qubits": 2, "gates": [
        {"name": "Ry", "targets": [0], "params": [1.1], "column": 0},
        {"name": "Ry", "targets": [1], "params": [2.0], "column": 0},
        {"name": "CNOT", "targets": [0, 1], "params": [], "column": 1}],
        "noise": [{"channel": "ThermalRelaxationNoise", "gates": ["Ry"],
                   "t1": 1.0, "t2": 1.2, "time": 0.3},
                  {"channel": "ThermalRelaxationNoise", "gates": ["CNOT"],
                   "t1": 1.0, "t2": 1.2, "time": 0.5}]}
    p = _exact_diagonal(c)
    assert abs(float(p.sum()) - 1.0) < 1e-12
    gen = torch.Generator().manual_seed(3)
    idx = kraus.sample(c, c["noise"], 4000, 1, gen, "cpu").view(-1)
    freq = torch.bincount(idx, minlength=4).double() / idx.numel()
    # four outcomes, 4000 independent trajectories: 5 standard errors
    se = (p * (1 - p) / idx.numel()).sqrt()
    assert bool(((freq - p).abs() <= 5 * se + 1e-12).all()), (freq, p)


def test_replay_without_noise_is_the_statevector():
    c = circuit(6, 8)
    c["noise"] = []
    re, im = kraus.replay(c, [], torch.zeros((1, 0), dtype=torch.long),
                          "cpu")
    r_re, r_im = sv.simulate(c, "cpu")
    assert math.isclose(float((re[0] - r_re).abs().max()), 0.0,
                        abs_tol=1e-12)
    assert math.isclose(float((im[0] - r_im).abs().max()), 0.0,
                        abs_tol=1e-12)
