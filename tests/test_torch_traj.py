"""The port's noisy trajectories vs the JAX package's, on the CPU.

The same circuits (carried over as dicts) and noise models (as
``NoiseModel.to_dict``) go through both packages. Tolerances and why:

* Splice specs (augmented program, draw schedule, windows, segments) are
  host bookkeeping: identical.
* Batched operands built on the device (torch complex64) against the JAX
  NumPy build with the same draws, trajectory by trajectory: 1e-6, the
  tolerance of the port's ideal operand build (``test_torch_plan.py``);
  both round every product to float32, in a different order.
* Draw-exact trajectories (the JAX branch indices fed to the port):
  fidelity > 1 - 1e-5 and norm 1 +- 1e-5, the bounds of
  ``tests/test_unitary_traj.py``.
* Laws (ensembles against the exact density matrix of
  ``DensityMatrixSimulator``, the JAX package's and the port's own): 0.05 per probability over 600-700
  trajectories, the bound of the JAX package's own ensemble tests; one
  trajectory's probability lies in [0, 1], so the ensemble mean's standard
  error is at most 0.5 / sqrt(600) = 0.02.
* Counts of ``run_with_noise`` against JAX's: two independent samples of
  4000 shots over 16 outcomes differ by a total variation distance of
  about 0.5 * sum_k sqrt(4 p_k / (pi N)) <= 0.036; the bound is 0.06.
* Step recording on ideal circuits: 1e-5, the executor tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.density import DensityMatrixSimulator
from quantum_simulator_tpu.noise import NoiseChannel as JNoiseChannel
from quantum_simulator_tpu.ops import monomial_traj as jmt
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu.ops import unitary_traj as jut
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch.interop import operands_from_numpy
from quantum_simulator_tpu_torch.ops import cuda_exec
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.ops import unitary_traj as tut
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def brickwork(n, layers, rz=False):
    """``tests/test_unitary_traj.py``'s circuit, built with the JAX
    package."""
    c = jq.QuantumCircuit(n)
    col = 0
    for layer in range(layers):
        for q in range(n):
            c.add_gate(jq.GateInstance("Ry", [q], [0.1 * (q + layer + 1)],
                                       column=col))
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add_gate(jq.GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    if rz:
        c.add_gate(jq.GateInstance("Rz", [n // 3], [0.7], column=col))
    return c


def grover9():
    from quantum_simulator_tpu.algorithms import AlgorithmTemplate

    full = AlgorithmTemplate.grover_search(9, marked_state=3,
                                           num_iterations=2)
    c = jq.QuantumCircuit(9)
    for g in full.gates:
        if g.gate_name != "Measure":
            c.add_gate(g)
    return c


def model(*channels, gate=None):
    """JAX NoiseModel: global channels, plus ``gate = (name, channel)``."""
    nm = jq.NoiseModel()
    for ch in channels:
        nm.add_global_noise(ch)
    if gate is not None:
        nm.add_gate_noise(*gate)
    return nm


def both(jc, jnm):
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    return (jprog.compile_circuit(jc), jnm, tprog.compile_circuit(tc), tnm,
            tc)


def jax_branch(spec, key) -> np.ndarray:
    """The JAX package's branch index of every draw for ``key``: the
    categorical of ``unitary_traj._draw_overrides_host``."""
    pad = -(-max(1, spec.total_draws) // 64) * 64
    keys = jax.random.split(key, pad)
    out = np.zeros(spec.total_draws, np.int64)
    for sid, st in enumerate(spec.stacks):
        ds = [d for d in spec.draws if d.stack_id == sid]
        if ds:
            sel = np.asarray(jut._CAT_BATCH(
                keys, jnp.asarray(np.log(st.probs), jnp.float32)))
            for d in ds:
                out[d.draw_index] = sel[d.draw_index]
    return out


UNITARY_CASES = {
    "real-depolarizing": lambda: (brickwork(10, 3),
                                  model(jq.DepolarizingNoise(0.1))),
    "planar-depolarizing": lambda: (brickwork(9, 2, rz=True),
                                    model(jq.DepolarizingNoise(0.15))),
    "bit-and-phase-flip": lambda: (brickwork(8, 2), model(
        jq.BitFlipNoise(0.1), gate=("CNOT", jq.PhaseFlipNoise(0.2)))),
    "grover-prod-steps": lambda: (grover9(),
                                  model(jq.DepolarizingNoise(0.05))),
    "two-qubit-depolarizing": lambda: (brickwork(9, 2), model(
        gate=("CNOT", jq.TwoQubitDepolarizingNoise(0.3)))),
}

MONOMIAL_CASES = {
    "amplitude-damping": lambda: (brickwork(4, 2),
                                  model(jq.AmplitudeDampingNoise(0.25))),
    "thermal-planar": lambda: (brickwork(4, 2, rz=True), model(
        jq.ThermalRelaxationNoise(30.0, 40.0, 8.0))),
    "depol-plus-damping-chain": lambda: (brickwork(3, 2), model(
        jq.DepolarizingNoise(0.15), jq.AmplitudeDampingNoise(0.2))),
    "deep-cross-window": lambda: (brickwork(3, 6),
                                  model(jq.AmplitudeDampingNoise(0.3))),
    "correlated-2q-with-damping": lambda: (brickwork(4, 2), model(
        jq.AmplitudeDampingNoise(0.1),
        gate=("CNOT", jq.TwoQubitDepolarizingNoise(0.3)))),
}


def _ops(prog_):
    return [(o.gate_name, o.targets, o.column_index, o.param_offset,
             None if o.static_matrix is None else o.static_matrix.tobytes())
            for o in prog_.ops]


@pytest.mark.parametrize("name", sorted(UNITARY_CASES))
def test_unitary_spec_matches_jax(name):
    jp, jnm, tp, tnm, _ = both(*UNITARY_CASES[name]())
    want = jut.unitary_insert_spec(jp, jnm)
    got = tut.unitary_insert_spec(tp, tnm)
    assert _ops(got.aug) == _ops(want.aug)
    assert got.aug.compile_key == want.aug.compile_key
    assert [tuple(d) for d in got.draws] == [tuple(d) for d in want.draws]
    assert (got.total_draws, got.real) == (want.total_draws, want.real)
    for a, b in zip(got.stacks, want.stacks):
        np.testing.assert_array_equal(a.probs, b.probs)
        np.testing.assert_array_equal(a.units, b.units)
    assert tprog.trajectory_route(tp, tnm) == "unitary"


@pytest.mark.parametrize("name", sorted(MONOMIAL_CASES))
def test_monomial_spec_matches_jax(name):
    jp, jnm, tp, tnm, _ = both(*MONOMIAL_CASES[name]())
    want = jmt.monomial_spec(jp, jnm)
    got = tmt.monomial_spec(tp, tnm)
    assert [_ops(s) for s in got.segments] == [_ops(s) for s in want.segments]
    assert [s.compile_key for s in got.segments] == \
        [s.compile_key for s in want.segments]
    assert [[tuple(s) for s in w] for w in got.windows] == \
        [[tuple(s) for s in w] for w in want.windows]
    assert (got.n_site_keys, got.real) == (want.n_site_keys, want.real)
    for a, b in zip(got.stacks, want.stacks):
        # float64 here, cast to the engine's precision where it is used
        np.testing.assert_array_equal(a.w2.astype(np.float32), b.w2)
        np.testing.assert_array_equal(a.fmap, b.fmap)
    assert tprog.trajectory_route(tp, tnm) == "monomial"


def test_routes_for_every_family():
    tp = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        brickwork(5, 1).to_dict()))
    cases = {
        "unitary": tq.DepolarizingNoise(0.1),
        "monomial": tq.AmplitudeDampingNoise(0.1),
        "fold": _TXDamp(0.3),
    }
    for route, ch in cases.items():
        tnm = tq.NoiseModel()
        tnm.add_global_noise(ch)
        assert tprog.trajectory_route(tp, tnm) == route
    # rule 4: an op without a fold applier (four targets over three
    # groups, not of controlled-phase form) leaves the per-gate body
    shift = np.roll(np.eye(16, dtype=np.complex128), 1, axis=0)
    wide = tprog.ProgramOp("Wide4", (0, 3, 9, 15), 0, 0, 0, shift, None, -1)
    wp = tprog.CircuitProgram(16, 0, (wide,), 1, 0, np.zeros(0), ("wide4",))
    assert tprog.trajectory_route(wp, tnm) == "per-gate"


KEYS = [jax.random.PRNGKey(s) for s in range(3)]


@pytest.mark.parametrize("name", ["real-depolarizing", "planar-depolarizing",
                                  "grover-prod-steps",
                                  "two-qubit-depolarizing"])
def test_batched_operands_match_jax_build(name):
    """``build_group_operands_batched`` against ``build_group_operands(aug,
    plan, params, complex64, overrides=_draw_overrides_host(spec, key),
    xp=np)``, trajectory by trajectory."""
    jp, jnm, tp, tnm, _ = both(*UNITARY_CASES[name]())
    jspec = jut.unitary_insert_spec(jp, jnm)
    tspec = tut.unitary_insert_spec(tp, tnm)
    branch = torch.from_numpy(np.stack([jax_branch(jspec, k) for k in KEYS]))
    plan = tplan.get_group_plan(tspec.aug)
    got = tplan.build_group_operands_batched(
        tspec.aug, plan, tp.initial_params, len(KEYS), "cpu",
        tut.branch_overrides(tspec, branch))
    jpl = jplan.get_group_plan(jspec.aug)
    for t, key in enumerate(KEYS):
        want = operands_from_numpy(jplan.build_group_operands(
            jspec.aug, jpl, np.asarray(jp.initial_params), np.complex64,
            overrides=jut._draw_overrides_host(jspec, key), xp=np))
        for ax, stack in enumerate(want[0]):
            for i in range(len(plan.dense_real[ax])):
                np.testing.assert_allclose(got[0][ax][i][t].numpy(),
                                           stack[i], atol=1e-6)
        for g, w in zip(got[1] + got[2], want[1] + want[2]):
            np.testing.assert_allclose(g[t].numpy(), w, atol=1e-6)
        for g, w in zip(got[4], want[4]):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g[t].numpy(), w, atol=1e-6)
        for (gf, gr, gi), (wf, wr, wi) in zip(got[3], want[3]):
            assert (gr, gi) == pytest.approx((wr, wi), abs=1e-6)
            for a, b in zip(gf, wf):
                np.testing.assert_array_equal(a.numpy(), b)


def test_untouched_operands_are_shared_with_stride_zero():
    jc = jq.QuantumCircuit(9)           # axes (4, 128)
    jc.add_gate(jq.GateInstance("H", [0], [], column=0))
    for q in range(2, 9):
        jc.add_gate(jq.GateInstance("Ry", [q], [0.3 * q], column=0))
    jp, jnm, tp, tnm, _ = both(jc, model(gate=("H", jq.PhaseFlipNoise(0.2))))
    spec = tut.unitary_insert_spec(tp, tnm)
    plan = tplan.get_group_plan(spec.aug)
    branch = tut.draw_branches(spec, 4, "cpu",
                               torch.Generator().manual_seed(0))
    ops = tplan.build_group_operands_batched(
        spec.aug, plan, tp.initial_params, 4, "cpu",
        tut.branch_overrides(spec, branch))
    strides = [o.stride(0) for ax in ops[0] for o in ax]
    assert strides == [2 * 4 * 4, 0]    # axis 0 holds the draws


@pytest.mark.parametrize("name", ["real-depolarizing", "planar-depolarizing",
                                  "bit-and-phase-flip", "grover-prod-steps"])
def test_draw_exact_against_jax(name):
    """The JAX draws fed to the port give the JAX trajectories
    (``tests/test_unitary_traj.py:93-120``)."""
    jp, jnm, tp, tnm, _ = both(*UNITARY_CASES[name]())
    jspec = jut.unitary_insert_spec(jp, jnm)
    branch = torch.from_numpy(np.stack([jax_branch(jspec, k) for k in KEYS]))
    got, used = tut.unitary_insert_trajectory_body(
        tp, tnm, tp.initial_params, len(KEYS), "cpu", branch=branch)
    assert used is branch
    body = jax.jit(lambda k: jut.unitary_insert_trajectory_body(
        jp, jnm, jnp.asarray(jp.initial_params), k))
    for t, key in enumerate(KEYS):
        ref = np.asarray(body(key))
        g = got[t].numpy()
        fid = abs(np.vdot(ref, g)) ** 2 / (np.vdot(ref, ref).real
                                          * np.vdot(g, g).real)
        assert fid > 1 - 1e-5, (t, fid)
        np.testing.assert_allclose(np.vdot(g, g).real, 1.0, atol=1e-5)


def _ensemble(tp, tnm, n_traj=700, seed=0, body=None):
    gen = torch.Generator().manual_seed(seed)
    if body is None:
        states, _ = tprog.batched_trajectories(tp, tnm, tp.initial_params,
                                               n_traj, "cpu", gen)
    else:
        states, _ = body(tp, tnm, tp.initial_params, n_traj, "cpu", gen)
    probs = states.abs().square()
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-4)
    return probs.mean(0).numpy()


LAW_CASES = {
    "unitary-2q-depolarizing": lambda: (brickwork(4, 2), model(
        gate=("CNOT", jq.TwoQubitDepolarizingNoise(0.3)))),
    "unitary-depolarizing-planar": lambda: (
        brickwork(4, 2, rz=True), model(jq.DepolarizingNoise(0.1))),
    **{f"monomial-{k}": v for k, v in MONOMIAL_CASES.items()},
}


@pytest.mark.parametrize("name", sorted(LAW_CASES))
def test_law_against_exact_density_matrix(name):
    jc, jnm = LAW_CASES[name]()
    _, _, tp, tnm, _ = both(jc, jnm)
    dm = DensityMatrixSimulator(noise_model=jnm).run(jc)
    np.testing.assert_allclose(_ensemble(tp, tnm), dm.probabilities,
                               atol=0.05)


@pytest.mark.parametrize("name", sorted(LAW_CASES))
def test_law_against_the_ports_exact_density_matrix(name):
    """The same ensembles against the port's ``DensityMatrixSimulator``
    (dense route), which itself agrees with the JAX one to 2e-5."""
    jc, jnm = LAW_CASES[name]()
    _, _, tp, tnm, tc = both(jc, jnm)
    dm = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(tc)
    want = DensityMatrixSimulator(noise_model=jnm).run(jc)
    np.testing.assert_allclose(dm.probabilities, want.probabilities,
                               atol=2e-5)
    np.testing.assert_allclose(_ensemble(tp, tnm), dm.probabilities,
                               atol=0.05)


class _XBasisDamping:
    """Amplitude damping conjugated by H: CPTP, neither mixed-unitary nor
    monomial, so it takes the per-gate body."""

    def __init__(self, g):
        self._g = g

    @property
    def probability(self):
        return self._g

    def get_kraus_operators(self):
        h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
        return [h @ k @ h for k in
                jq.AmplitudeDampingNoise(self._g).get_kraus_operators()]


class _JXDamp(_XBasisDamping, JNoiseChannel):
    pass


class _TXDamp(_XBasisDamping, tq.NoiseChannel):
    pass


def _x_damping_models(g=0.3):
    """(JAX model, port model) with the custom channel on every gate."""
    tnm = tq.NoiseModel()
    tnm.add_global_noise(_TXDamp(g))
    return model(_JXDamp(g)), tnm


@pytest.mark.parametrize("channel", ["amplitude-damping", "x-basis-damping"])
def test_per_gate_body_law(channel):
    jc = brickwork(4, 2)
    if channel == "amplitude-damping":
        jnm = model(jq.AmplitudeDampingNoise(0.25))
        tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    else:
        jnm, tnm = _x_damping_models()
    tp = tprog.compile_circuit(tq.QuantumCircuit.from_dict(jc.to_dict()))
    dm = DensityMatrixSimulator(noise_model=jnm).run(jc)
    probs = _ensemble(tp, tnm, 600, seed=3,
                      body=tplan.group_trajectory_body)
    np.testing.assert_allclose(probs, dm.probabilities, atol=0.05)


@pytest.mark.parametrize("channel", ["amplitude-damping", "x-basis-damping"])
@pytest.mark.parametrize("method", ["dense", "superop"])
def test_per_gate_body_law_against_the_ports_density_matrix(channel, method):
    """The per-gate body's ensemble against the port's exact rho, by
    either route (a custom channel's Kraus stack enters both)."""
    jc = brickwork(4, 2)
    if channel == "amplitude-damping":
        tnm = tq.NoiseModel.from_dict(
            model(jq.AmplitudeDampingNoise(0.25)).to_dict())
    else:
        _, tnm = _x_damping_models()
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    tp = tprog.compile_circuit(tc)
    dm = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(
        tc, method=method)
    probs = _ensemble(tp, tnm, 600, seed=3,
                      body=tplan.group_trajectory_body)
    np.testing.assert_allclose(probs, dm.probabilities, atol=0.05)


# (channel family, the port's route, the JAX group-path body of that
# route: the body the port's route is held against, draw for draw or by
# its law). Below n = 19 the JAX package itself runs none of them by
# default: it takes its per-gate einsum body ``_trajectory_body``, which
# consumes the draws in another order, so below n = 19 the port is held
# against a body that JAX reaches only through its group path.
ROUTE_TABLE = [
    ("depolarizing", "unitary", (jut, "unitary_insert_trajectory_body")),
    ("bit-flip", "unitary", (jut, "unitary_insert_trajectory_body")),
    ("phase-flip", "unitary", (jut, "unitary_insert_trajectory_body")),
    ("2q-depolarizing-on-cnot", "unitary",
     (jut, "unitary_insert_trajectory_body")),
    ("amplitude-damping", "monomial", (jmt, "monomial_trajectory_body")),
    ("thermal-relaxation", "monomial", (jmt, "monomial_trajectory_body")),
    ("depolarizing+damping", "monomial", (jmt, "monomial_trajectory_body")),
    ("x-basis-damping", "fold", ("bigtraj", "fold_trajectory_body")),
]


def _route_models(family):
    """(JAX model, port model) of a channel family."""
    if family == "x-basis-damping":
        return _x_damping_models()
    jnm = {
        "depolarizing": lambda: model(jq.DepolarizingNoise(0.1)),
        "bit-flip": lambda: model(jq.BitFlipNoise(0.1)),
        "phase-flip": lambda: model(jq.PhaseFlipNoise(0.1)),
        "2q-depolarizing-on-cnot": lambda: model(
            gate=("CNOT", jq.TwoQubitDepolarizingNoise(0.1))),
        "amplitude-damping": lambda: model(jq.AmplitudeDampingNoise(0.1)),
        "thermal-relaxation": lambda: model(
            jq.ThermalRelaxationNoise(30.0, 40.0, 8.0)),
        "depolarizing+damping": lambda: model(
            jq.DepolarizingNoise(0.1), jq.AmplitudeDampingNoise(0.1)),
    }[family]()
    return jnm, tq.NoiseModel.from_dict(jnm.to_dict())


@pytest.mark.parametrize("n", [4, 12, 18, 19, 24])
@pytest.mark.parametrize("family,route,held_against", ROUTE_TABLE,
                         ids=[r[0] for r in ROUTE_TABLE])
def test_route_names_the_jax_body_it_is_held_against(family, route,
                                                     held_against, n):
    """Per channel family and n: the port's route, the JAX body of the
    same name that the JAX group path would pick (by the JAX package's
    own predicates, in its own order), and what JAX runs by default."""
    from quantum_simulator_tpu.ops import bigtraj as jbig

    jnm, tnm = _route_models(family)
    jc = brickwork(n, 1)
    jp = jprog.compile_circuit(jc)
    tp = tprog.compile_circuit(tq.QuantumCircuit.from_dict(jc.to_dict()))
    assert tprog.trajectory_route(tp, tnm) == route
    # the selection of program._group_traj_body, with JAX's predicates
    if jut.unitary_insert_supported(jp, jnm):
        jax_route = "unitary"
    elif jmt.monomial_insert_supported(jp, jnm):
        jax_route = "monomial"
    elif jbig.fold_supported(jp):
        jax_route = "fold"
    else:
        jax_route = "per-gate"
    assert jax_route == route
    module, name = held_against
    assert callable(getattr(jbig if module == "bigtraj" else module, name))
    # what the JAX package runs by default: its per-gate einsum body
    # below 19 qubits on every backend, the group path from 19 on only
    # on a TPU (never in these CPU tests)
    assert jprog._PLAN_EXECUTOR_MIN_QUBITS == 19
    assert not jprog._use_group_path(jp)
    assert (n >= jprog._PLAN_EXECUTOR_MIN_QUBITS) == (n in (19, 24))


def test_replayed_draws_reproduce_the_batch():
    """A body's returned draws replay its trajectories exactly, for the
    three bodies (the seam ``tests/test_torch_gpu.py`` uses to hold the
    kernel executor against the plain one)."""
    tp = tprog.compile_circuit(tq.QuantumCircuit.from_dict(
        brickwork(5, 2, rz=True).to_dict()))
    for ch in (tq.DepolarizingNoise(0.2), tq.AmplitudeDampingNoise(0.3),
               _TXDamp(0.3)):
        tnm = tq.NoiseModel()
        tnm.add_global_noise(ch)
        gen = torch.Generator().manual_seed(4)
        a, draws = tprog.batched_trajectories(tp, tnm, tp.initial_params, 5,
                                              "cpu", gen)
        b, _ = tprog.batched_trajectories(tp, tnm, tp.initial_params, 5,
                                          "cpu", draws=draws, plain=True)
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Simulator entry points
# ---------------------------------------------------------------------------

def _sim_case(channel):
    jc = brickwork(4, 2, rz=True)
    jnm = model(channel)
    return jc, jnm, tq.QuantumCircuit.from_dict(jc.to_dict()), \
        tq.NoiseModel.from_dict(jnm.to_dict())


def tvd(a: dict, b: dict, shots: int) -> float:
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0) - b.get(k, 0)) for k in keys) / shots


@pytest.mark.parametrize("trajectories", [None, 200])
def test_run_with_noise_counts_match_jax(trajectories):
    jc, jnm, tc, tnm = _sim_case(jq.AmplitudeDampingNoise(0.2))
    shots = 4000
    want = jq.Simulator(noise_model=jnm).run_with_noise(
        jc, shots=shots, seed=1, trajectories=trajectories)
    got = tq.Simulator(noise_model=tnm, device="cpu").run_with_noise(
        tc, shots=shots, seed=1, trajectories=trajectories)
    assert sum(got.measurement_counts.values()) == shots
    assert tvd(got.measurement_counts, want.measurement_counts, shots) \
        <= 0.06
    np.testing.assert_allclose(got.final_state.data,
                               want.final_state.data, atol=0)


def test_run_with_noise_applies_readout():
    jc, jnm, tc, tnm = _sim_case(jq.DepolarizingNoise(0.05))
    tnm.set_readout_error(tq.ReadoutError(0.2, 0.2))
    dm = DensityMatrixSimulator(noise_model=jnm).run(jc)
    p = tq.ReadoutError(0.2, 0.2).apply_to_distribution(dm.probabilities, 4)
    got = tq.Simulator(noise_model=tnm, device="cpu").run_with_noise(
        tc, shots=4000, seed=2).measurement_counts
    exact = {format(i, "04b"): 4000 * v for i, v in enumerate(p)}
    assert tvd(got, exact, 4000) <= 0.05
    noiseless = {format(i, "04b"): 4000 * v
                 for i, v in enumerate(dm.probabilities)}
    assert tvd(got, noiseless, 4000) > 0.1


def test_noisy_run_is_one_trajectory_with_readout():
    jc, jnm, tc, tnm = _sim_case(jq.DepolarizingNoise(0.3))
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    finals = [sim.run(tc, shots=0, seed=s).final_state.data
              for s in range(6)]
    for f in finals:
        np.testing.assert_allclose(np.vdot(f, f).real, 1.0, atol=1e-5)
    assert max(np.abs(f - finals[0]).max() for f in finals) > 1e-3
    tnm.set_readout_error(tq.ReadoutError(0.5, 0.5))
    counts = sim.run(tc, shots=2000, seed=0).measurement_counts
    assert len(counts) == 16       # p = 0.5 readout reaches every string
    assert sim.run_with_noise(tc, shots=0, seed=0).measurement_counts == {}


def test_ensemble_density_matrices_match_exact_rho():
    jc, jnm, tc, tnm = _sim_case(jq.DepolarizingNoise(0.1))
    dm = DensityMatrixSimulator(noise_model=jnm).run(jc)
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    rho = sim.ensemble_density_matrix(tc, 600, seed=1)
    assert rho.dtype == np.complex128
    np.testing.assert_allclose(rho, dm.rho, atol=0.05)
    np.testing.assert_allclose(np.trace(rho).real, 1.0, atol=1e-4)
    q = sim.ensemble_qubit_density_matrices(tc, 600, seed=1)
    r8 = dm.rho.reshape((2,) * 8)
    for k in range(4):
        cols = [i if i != k else 8 for i in range(4)]
        want = np.einsum(r8, [0, 1, 2, 3] + cols, [k, 8])  # trace the rest
        np.testing.assert_allclose(q[k], want, atol=0.05)
        # float32 sums over 600 trajectories
        np.testing.assert_allclose(np.trace(q[k]).real, 1.0, atol=1e-4)


def test_ensemble_density_matrices_match_the_ports_exact_rho():
    jc, jnm, tc, tnm = _sim_case(jq.DepolarizingNoise(0.1))
    dm = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(tc)
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    rho = sim.ensemble_density_matrix(tc, 600, seed=1)
    np.testing.assert_allclose(rho, dm.rho, atol=0.05)
    assert dm.purity() == pytest.approx(
        np.real(np.trace(dm.rho @ dm.rho)), abs=1e-5)
    # and readout in distribution mode on the exact diagonal
    tnm.set_readout_error(tq.ReadoutError(0.2, 0.2))
    dsim = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu")
    exact = dsim.sample(dm, 4000, np.random.default_rng(3))
    got = tq.Simulator(noise_model=tnm, device="cpu").run_with_noise(
        tc, shots=4000, seed=2).measurement_counts
    assert tvd(got, exact, 4000) <= 0.06


@pytest.mark.parametrize("name", ["bell-ghz", "brickwork-rz"])
def test_ideal_step_recording_matches_jax(name):
    if name == "bell-ghz":
        jc = jq.QuantumCircuit(3)
        jc.add_gate(jq.GateInstance("H", [0], [], column=0))
        jc.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=1))
        jc.add_gate(jq.GateInstance("Toffoli", [0, 1, 2], [], column=2))
        jc.add_gate(jq.GateInstance("CPhase", [2, 0], [0.4], column=3))
    else:
        jc = brickwork(9, 2, rz=True)
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    want = jq.Simulator().run(jc, shots=16, seed=0, record_steps=True)
    got = tq.Simulator(device="cpu").run(tc, shots=16, seed=0,
                                         record_steps=True)
    assert len(got.step_states) == len(want.step_states)
    for g, w in zip(got.step_states, want.step_states):
        np.testing.assert_allclose(g.data, w.data, atol=1e-5)
    np.testing.assert_allclose(got.final_state.data, want.final_state.data,
                               atol=1e-5)
    jsteps = list(jq.Simulator().run_step_by_step(jc))
    tsteps = list(tq.Simulator(device="cpu").run_step_by_step(tc))
    assert [c for _, c in tsteps] == [c for _, c in jsteps]
    for (g, _), (w, _) in zip(tsteps, jsteps):
        np.testing.assert_allclose(g.data, w.data, atol=1e-5)


def test_noisy_step_recording_final_column_law():
    jc, jnm, tc, tnm = _sim_case(jq.AmplitudeDampingNoise(0.25))
    dm = DensityMatrixSimulator(noise_model=jnm).run(jc)
    tp = tprog.compile_circuit(tc)
    cols, _ = tplan.group_trajectory_body(
        tp, tnm, tp.initial_params, 600, "cpu",
        torch.Generator().manual_seed(7), record_columns=True)
    assert cols.shape == (600, tp.num_columns + 1, 16)
    probs = cols[:, -1].abs().square().mean(0).numpy()
    np.testing.assert_allclose(probs, dm.probabilities, atol=0.05)
    res = tq.Simulator(noise_model=tnm, device="cpu").run(
        tc, shots=8, seed=0, record_steps=True)
    assert len(res.step_states) == tp.num_columns
    np.testing.assert_allclose(res.final_state.data,
                               res.step_states[-1].data, atol=0)
    steps = list(tq.Simulator(noise_model=tnm, device="cpu")
                 .run_step_by_step(tc, rng=np.random.default_rng(0)))
    assert [c for _, c in steps] == list(range(-1, tp.num_columns))


# ---------------------------------------------------------------------------
# Batched twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("planar,real", [(False, True), (True, True),
                                         (True, False)])
def test_batched_twins_equal_a_loop_of_unbatched_twins(shared, planar, real):
    """The unbatched twins are held against Pallas interpret mode in
    ``test_torch_kernels.py``; one batched einsum must equal a loop of
    them, with one shared operator (stride 0) or one per trajectory."""
    rng = np.random.default_rng(5)
    B, shape = 3, (4, 8, 16)
    x = torch.from_numpy(rng.standard_normal(
        (B,) + ((2,) if planar else ()) + shape).astype(np.float32))

    def ops(op_shape):
        full = op_shape if real else (2,) + op_shape
        if shared:
            one = torch.from_numpy(rng.standard_normal(full).astype(
                np.float32))
            return one[None].expand((B,) + full)
        return torch.from_numpy(rng.standard_normal((B,) + full).astype(
            np.float32))

    for axis in range(3):
        S = shape[axis]
        op = ops((S, S))
        got = cuda_exec.dense_axis(x, op, axis, planar, True)
        want = torch.stack([cuda_exec.dense_axis_plain(x[b], op[b], axis,
                                                       planar)
                            for b in range(B)])
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    if planar and real:
        return
    for s, pos, o in ((1, 0, 0), (0, 1, 2), (2, 3, 1), (2, 0, 0)):
        S = shape[o]
        cop = ops((2, S, 2, S))
        got = cuda_exec.cross_bit_axis(x, cop, s, pos, o, planar, True)
        want = torch.stack([cuda_exec.cross_bit_axis_plain(
            x[b], cop[b], s, pos, o, planar) for b in range(B)])
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
