"""Monitored trajectories (mid-circuit ``Measure`` that collapses) in the
port vs the JAX package, on the CPU at n = 3-10.

* the collapse primitives against the JAX ones on each row of a batch:
  1e-6;
* the monomial splice spec with measurement events: identical host
  bookkeeping (segments, windows, event slots);
* outcomes draw-exact: the JAX splice body's basis samples and site draws
  (recorded from its eager run) fed to the port give the same outcomes,
  and the same state to fidelity 1 - 1e-5;
* laws: outcome frequencies of the per-gate body, of the splice body and
  of the JAX per-gate body over 3000 trajectories within 0.05 of each
  other (a frequency's standard error is at most 0.5 / sqrt(3000) =
  0.009); ``Simulator.monitored_trajectories`` of both packages within
  0.08 over 600 trajectories (standard error 0.02 each);
* the n >= 30 method ``_monitored_huge`` driven directly at n = 6-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.ops import apply as japply
from quantum_simulator_tpu.ops import monomial_traj as jmt
from quantum_simulator_tpu.ops import program as jprog
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch.ops import apply as tapply
from quantum_simulator_tpu_torch.ops import bigtraj as tbt
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from tests.test_torch_bigtraj import (fidelity, monomial_draws, programs,
                                      recorded)  # noqa: F401  (a fixture)
from tests.test_torch_traj import (_ops, _x_damping_models, both, brickwork,
                                   model)


# ---------------------------------------------------------------------------
# Collapse primitives
# ---------------------------------------------------------------------------

def random_states(T, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((T, 1 << n)) + 1j * rng.standard_normal(
        (T, 1 << n))
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
        np.complex64)


@pytest.mark.parametrize("qubit", [0, 2, 4])
def test_collapse_primitives_match_jax_on_a_batch(qubit):
    n, T = 5, 6
    states = random_states(T, n, seed=qubit)
    t = torch.from_numpy(states)
    p0 = tapply.prob_qubit_zero(t, qubit, n)
    outcome = torch.tensor([0, 1, 1, 0, 1, 0])
    got = tapply.collapse_qubit(t, qubit, outcome, n)
    assert p0.shape == (T,) and got.shape == (T, 1 << n)
    for row in range(T):
        js = jnp.asarray(states[row])
        np.testing.assert_allclose(
            float(p0[row]), float(japply.prob_qubit_zero(js, qubit, n)),
            atol=1e-6)
        want = japply.collapse_qubit(js, qubit,
                                     jnp.asarray(int(outcome[row])), n)
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want),
                                   atol=1e-6)
    # a single state and an int outcome, as the JAX signature
    one = tapply.collapse_qubit(t[0], qubit, 1, n)
    np.testing.assert_allclose(
        one.numpy(), np.asarray(japply.collapse_qubit(
            jnp.asarray(states[0]), qubit, jnp.asarray(1), n)), atol=1e-6)
    np.testing.assert_allclose(
        tapply.normalize(3.0 * t).numpy(), states, atol=1e-6)
    zero = torch.zeros(4, dtype=torch.complex64)
    assert torch.equal(tapply.normalize(zero), zero)


def test_collapse_of_an_impossible_outcome_stays_zero():
    state = torch.zeros(8, dtype=torch.complex64)
    state[0] = 1.0                      # |000>: qubit 1 is never 1
    out = tapply.collapse_qubit(state, 1, 1, 3)
    assert float(out.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# The splice spec with measurement events
# ---------------------------------------------------------------------------

def n_ops(jc) -> int:
    return len(jprog.compile_circuit(jc).ops)


MONITORED_CASES = {
    # (circuit, JAX noise model or None, events)
    "ideal-mid-and-end": lambda: (
        brickwork(4, 2), None, ((3, 1), (6, 0), (n_ops(brickwork(4, 2)), 2))),
    "ideal-repeated-site": lambda: (
        brickwork(3, 2), None, ((2, 0), (2, 0), (4, 0))),
    "amplitude-damping": lambda: (
        brickwork(3, 2), model(jq.AmplitudeDampingNoise(0.3)),
        tuple((n_ops(brickwork(3, 2)), q) for q in range(3))),
    "depol-and-damping-planar": lambda: (
        brickwork(4, 2, rz=True),
        model(jq.DepolarizingNoise(0.1), jq.AmplitudeDampingNoise(0.2)),
        ((0, 3), (5, 1), (5, 2))),
    "two-axis-layout": lambda: (
        brickwork(9, 3), model(jq.AmplitudeDampingNoise(0.1)),
        ((10, 0), (n_ops(brickwork(9, 3)), 4))),
}


def case(name):
    jc, jnm, events = MONITORED_CASES[name]()
    jp, tp = programs(jc)
    if jnm is None:
        return jp, jprog._NoNoise, tp, tprog._NoNoise, events
    return jp, jnm, tp, tq.NoiseModel.from_dict(jnm.to_dict()), events


@pytest.mark.parametrize("name", sorted(MONITORED_CASES))
def test_monitored_spec_matches_jax(name):
    jp, jnm, tp, tnm, events = case(name)
    want = jmt.monomial_spec(jp, jnm, events)
    got = tmt.monomial_spec(tp, tnm, events)
    assert [_ops(s) for s in got.segments] == [_ops(s) for s in want.segments]
    assert [[tuple(s) for s in w] for w in got.windows] == \
        [[tuple(s) for s in w] for w in want.windows]
    assert (got.n_site_keys, got.real, got.n_events) == \
        (want.n_site_keys, want.real, want.n_events)
    assert got.n_events == len(events)
    slots = sorted(s.event_index for w in got.windows for s in w
                   if s.event_index >= 0)
    assert slots == list(range(len(events)))
    assert tmt.monomial_insert_supported(tp, tnm, events)
    assert tmt.monomial_monitored_evolve_ok(tp, tnm, events) == \
        jmt.monomial_monitored_evolve_ok(jp, jnm, events)


def test_non_monomial_noise_has_no_monitored_spec():
    jnm, tnm = _x_damping_models(0.2)
    jp, tp = programs(brickwork(4, 1))
    assert jmt.monomial_spec(jp, jnm, ((0, 0),)) is None
    assert tmt.monomial_spec(tp, tnm, ((0, 0),)) is None
    with pytest.raises(ValueError, match="non-monomial"):
        tmt.monomial_monitored_body(tp, tnm, ((0, 0),), tp.initial_params,
                                    2, "cpu")
    with pytest.raises(ValueError, match="non-monomial"):
        jmt.monomial_monitored_body(jp, jnm, ((0, 0),),
                                    jnp.asarray(jp.initial_params),
                                    jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# Draw-exact outcomes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(MONITORED_CASES))
def test_monitored_outcomes_draw_exact_against_jax(name, seed, recorded):
    jp, jnm, tp, tnm, events = case(name)
    ref_state, ref_outs = jmt.monomial_monitored_body(
        jp, jnm, events, jnp.asarray(jp.initial_params),
        jax.random.PRNGKey(seed), jnp.complex64)
    rank = len(tplan.GroupLayout.for_qubits(tp.num_qubits).axis_sizes)
    draws = monomial_draws(tmt.monomial_spec(tp, tnm, events), recorded,
                           rank)
    states, outs, _ = tmt.monomial_monitored_body(
        tp, tnm, events, tp.initial_params, 1, "cpu", draws=draws)
    assert outs.dtype == torch.int64 and outs.shape == (1, len(events))
    np.testing.assert_array_equal(outs[0].numpy(), np.asarray(ref_outs))
    got = states[0].numpy()
    assert fidelity(np.asarray(ref_state), got) > 1 - 1e-5
    np.testing.assert_allclose(np.vdot(got, got).real, 1.0, atol=1e-5)
    # the n >= 30 form evolves a provided state to the same trajectory
    planar = not tmt.monomial_spec(tp, tnm, events).real
    x0 = tplan.layout_basis_state(
        tplan.GroupLayout.for_qubits(tp.num_qubits), tp.initial_index,
        "cpu", planar, 1)
    x, outs2, _ = tmt.monomial_monitored_evolve(
        tp, tnm, events, tp.initial_params, x0, draws=draws, plain=True)
    assert torch.equal(outs2, outs)
    flat = (x[0, 0] + 1j * x[0, 1] if planar else x[0]).reshape(-1).numpy()
    assert fidelity(flat.astype(complex), got) > 1 - 1e-5
    np.testing.assert_allclose(np.vdot(flat, flat).real, 1.0, atol=1e-5)


def test_repeated_measurement_repeats_and_state_agrees():
    """A qubit measured twice with no gate between gives one outcome, and
    the final state has that qubit in the last outcome."""
    jp, _, tp, tnm, _ = case("ideal-repeated-site")
    events = ((2, 0), (2, 0), (len(tp.ops), 0))
    gen = torch.Generator().manual_seed(0)
    states, outs, _ = tmt.monomial_monitored_body(
        tp, tnm, events, tp.initial_params, 200, "cpu", gen)
    assert bool((outs[:, 0] == outs[:, 1]).all())
    assert 0 < int(outs[:, 0].sum()) < 200
    p1 = 1.0 - tapply.prob_qubit_zero(states, 0, 3)
    np.testing.assert_allclose(p1.numpy(), outs[:, 2].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Laws
# ---------------------------------------------------------------------------

def joint(outs: np.ndarray) -> np.ndarray:
    """Distribution of the outcome rows read as binary numbers."""
    m = outs.shape[1]
    codes = (outs * (1 << np.arange(m)[::-1])).sum(1)
    return np.bincount(codes, minlength=1 << m) / outs.shape[0]


@pytest.mark.parametrize("noise", ["ideal", "amplitude-damping"])
def test_per_gate_monitored_body_law_against_splice_and_jax(noise):
    jc = brickwork(3, 2)
    jp, tp = programs(jc)
    events = ((2, 1), (len(tp.ops), 0), (len(tp.ops), 2))
    if noise == "ideal":
        jnm, tnm = jprog._NoNoise, tprog._NoNoise
    else:
        jnm = model(jq.AmplitudeDampingNoise(0.3))
        tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    T = 3000
    gen = torch.Generator().manual_seed(5)
    s1, per_gate = tprog.monitored_body(tp, tnm, events, tp.initial_params,
                                        T, "cpu", gen)
    s2, splice, _ = tmt.monomial_monitored_body(
        tp, tnm, events, tp.initial_params, T, "cpu", gen)
    for s in (s1, s2):
        np.testing.assert_allclose(s.abs().square().sum(-1).numpy(), 1.0,
                                   atol=1e-4)
    ref_fn = jax.jit(jax.vmap(
        lambda pa, k: jprog._monitored_body(
            jp, jnm.kraus_stacks_for_gate, events, pa, k, jnp.complex64),
        in_axes=(None, 0)))
    _, ref = ref_fn(jnp.asarray(jp.initial_params),
                    jax.random.split(jax.random.PRNGKey(9), T))
    a, b, c = joint(per_gate.numpy()), joint(splice.numpy()), \
        joint(np.asarray(ref))
    assert np.abs(a - b).max() < 0.05
    assert np.abs(a - c).max() < 0.05
    assert np.abs(b - c).max() < 0.05


def test_per_gate_body_serves_non_monomial_noise():
    """What the splice cannot take goes gate by gate below n = 19; from
    n = 19 on both packages refuse it with the same message."""
    jnm, tnm = _x_damping_models(0.3)
    _, tp = programs(brickwork(3, 2))
    events = ((0, 0), (len(tp.ops), 0))
    gen = torch.Generator().manual_seed(1)
    states, outs = tprog.monitored_trajectories(
        tp, tnm, events, tp.initial_params, 500, "cpu", gen)
    assert states.shape == (500, 8) and outs.shape == (500, 2)
    assert int(outs[:, 0].sum()) == 0           # |000> measured first
    np.testing.assert_allclose(states.abs().square().sum(-1).numpy(), 1.0,
                               atol=1e-4)
    c = tq.QuantumCircuit(19)
    c.add("H", [0], [], 0)
    c.add("Measure", [0], [], 1)
    with pytest.raises(ValueError, match="monomial Kraus channels"):
        tq.Simulator(noise_model=tnm, device="cpu").monitored_trajectories(
            c, 2, seed=0)


# ---------------------------------------------------------------------------
# Simulator.monitored_trajectories
# ---------------------------------------------------------------------------

def monitored_circuit(cls, gate):
    c = cls(4)
    for q, t in enumerate((0.9, 2.1, 0.4, 1.3)):
        c.add_gate(gate("Ry", [q], [t], column=0))
    c.add_gate(gate("Measure", [0], [], column=1))
    c.add_gate(gate("CNOT", [0, 1], [], column=2))
    c.add_gate(gate("Barrier", [0, 1], [], column=3))
    c.add_gate(gate("Measure", [1], [], column=4))
    c.add_gate(gate("Measure", [1], [], column=5))
    c.add_gate(gate("Ry", [2], [0.3], column=6))
    return c


@pytest.mark.parametrize("noise", ["ideal", "amplitude-damping"])
def test_simulator_monitored_trajectories_match_jax(noise):
    jc = monitored_circuit(jq.QuantumCircuit, jq.GateInstance)
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    jnm = tnm = None
    if noise != "ideal":
        jnm = model(jq.AmplitudeDampingNoise(0.2))
        tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    T = 600
    jouts, jsites, jstates = jq.Simulator(
        noise_model=jnm).monitored_trajectories(jc, T, seed=4)
    outs, sites, states = tq.Simulator(
        noise_model=tnm, device="cpu").monitored_trajectories(tc, T, seed=4)
    assert sites == jsites == [(1, 0), (4, 1), (5, 1)]
    assert outs.shape == jouts.shape == (T, 3)
    assert len(states) == len(jstates) == T
    assert isinstance(states[0], tq.StateVector)
    assert set(np.unique(outs)) <= {0, 1}
    if noise == "ideal":
        assert (outs[:, 1] == outs[:, 2]).all()
        a, b = np.sin(0.45) ** 2, np.sin(1.05) ** 2
        np.testing.assert_allclose(outs.mean(0)[:2],
                                   [a, a * (1 - b) + (1 - a) * b], atol=0.06)
    np.testing.assert_allclose(outs.mean(0), np.asarray(jouts).mean(0),
                               atol=0.08)
    for sv in states[:5]:
        np.testing.assert_allclose(
            float(sv.device_data.abs().square().sum()), 1.0, atol=1e-4)


def test_monitored_trajectories_are_cut_into_batches(monkeypatch):
    from quantum_simulator_tpu_torch import simulator as tsim

    monkeypatch.setattr(tsim, "_chunk_size", lambda *a: 7)
    tc = monitored_circuit(tq.QuantumCircuit, tq.GateInstance)
    outs, sites, states = tq.Simulator(device="cpu").monitored_trajectories(
        tc, 20, seed=1)
    assert outs.shape == (20, 3) and len(states) == 20
    assert (outs[:, 1] == outs[:, 2]).all()
    none, sites0, states0 = tq.Simulator(
        device="cpu").monitored_trajectories(tq.QuantumCircuit(2), 3, seed=1)
    assert none.shape == (3, 0) and sites0 == [] and len(states0) == 3


def test_final_shots_rejected_below_the_huge_threshold():
    jc = jq.QuantumCircuit(3)
    jc.add_gate(jq.GateInstance("H", [0], [], column=0))
    jc.add_gate(jq.GateInstance("Measure", [0], [], column=1))
    with pytest.raises(ValueError, match="final_shots"):
        jq.Simulator().monitored_trajectories(jc, n_trajectories=2,
                                              final_shots=8)
    with pytest.raises(ValueError, match="final_shots"):
        tq.Simulator(device="cpu").monitored_trajectories(
            tq.QuantumCircuit.from_dict(jc.to_dict()), n_trajectories=2,
            final_shots=8)


# ---------------------------------------------------------------------------
# The n >= 30 monitored path, driven directly
# ---------------------------------------------------------------------------

def ghz_j(n):
    c = jq.QuantumCircuit(n)
    c.add_gate(jq.GateInstance("H", [0], [], column=0))
    for i in range(n - 1):
        c.add_gate(jq.GateInstance("CNOT", [i, i + 1], [], column=i + 1))
    return c


def test_huge_monitored_sample_fn_on_ghz():
    """``TestHugeMonitored.test_shots_and_counts_ghz``: the collapsed GHZ
    state is |b..b>, so every final shot equals the outcome."""
    n = 8
    _, tp = programs(ghz_j(n))
    events = ((len(tp.ops), 0), (len(tp.ops), 1))
    fn, planar = tbt.huge_monitored_sample_fn(tp, tprog._NoNoise, events, 64,
                                              "cpu")
    assert not planar
    seen = set()
    for s in range(12):
        outs, idx = fn(tp.initial_params,
                       torch.Generator().manual_seed(2 * s),
                       torch.Generator().manual_seed(2 * s + 1))
        assert int(outs[0]) == int(outs[1])
        want = 0 if int(outs[0]) == 0 else (1 << n) - 1
        assert bool((idx == want).all()) and idx.shape == (64,)
        seen.add(int(outs[0]))
    assert seen == {0, 1}
    fn0, _ = tbt.huge_monitored_sample_fn(tp, tprog._NoNoise, events, 0,
                                          "cpu")
    outs, idx = fn0(tp.initial_params, torch.Generator().manual_seed(0))
    assert idx is None and outs.shape == (2,)
    _, xnm = _x_damping_models(0.2)
    with pytest.raises(ValueError, match="monomial"):
        tbt.huge_monitored_sample_fn(tp, xnm, events, 0, "cpu")


def test_monitored_huge_matches_jax():
    """``Simulator._monitored_huge`` of both packages
    (``test_simulator_monitored_huge_helper``): after H, CNOT and both
    measurements the state is |b b 0000>, so every final shot is that
    string in both."""
    n = 6
    jc = jq.QuantumCircuit(n)
    jc.add_gate(jq.GateInstance("H", [0], [], column=0))
    jc.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=1))
    jc.add_gate(jq.GateInstance("Measure", [0], [], column=2))
    jc.add_gate(jq.GateInstance("Measure", [1], [], column=2))
    jp, tp = programs(jc)
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    sites, events = [(2, 0), (2, 1)], ((2, 0), (2, 1))
    jouts, jsites, jcounts = jq.Simulator()._monitored_huge(
        jc, jp, None, events, sites, 10, 7, 32)
    outs, got_sites, counts = tq.Simulator(device="cpu")._monitored_huge(
        tc, tp, None, events, sites, 10, 7, 32)
    for o, s, cs in ((np.asarray(jouts), jsites, jcounts),
                     (outs, got_sites, counts)):
        assert o.shape == (10, 2) and (o[:, 0] == o[:, 1]).all()
        assert s == sites and len(cs) == 10
        for t, cnt in enumerate(cs):
            b = int(o[t, 0])
            assert cnt == {format(b * 3 << (n - 2), f"0{n}b"): 32}, (t, cnt)
    none = tq.Simulator(device="cpu")._monitored_huge(
        tc, tp, None, events, sites, 3, 7, 0)
    assert none[0].shape == (3, 2) and none[2] == []


def test_monitored_huge_with_noise_and_its_refusal():
    jnm = model(jq.AmplitudeDampingNoise(0.2))
    jc = brickwork(9, 2)
    jp, _, tp, tnm, tc = both(jc, jnm)
    events = ((4, 0), (len(tp.ops), 8))
    sites = [(1, 0), (9, 8)]
    outs, _, counts = tq.Simulator(noise_model=tnm, device="cpu")\
        ._monitored_huge(tc, tp, tnm, events, sites, 6, 2, 50)
    assert outs.shape == (6, 2) and len(counts) == 6
    for t, cnt in enumerate(counts):
        assert sum(cnt.values()) == 50
        # qubit 8 was measured last: every final shot carries its outcome
        assert {b[8] for b in cnt} == {str(int(outs[t, 1]))}
    _, xnm = _x_damping_models(0.2)
    with pytest.raises(ValueError, match="monomial"):
        tq.Simulator(noise_model=xnm, device="cpu")._monitored_huge(
            tc, tp, xnm, events, sites, 2, 0, 0)
