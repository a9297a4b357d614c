"""The port's fold executor and n >= 30 trajectory entry points
(``ops/bigtraj.py``, the ``*_evolve`` forms of the splice modules) vs the
JAX package's, on the CPU at n = 8-15.

The JAX bodies draw with ``jax.random.categorical`` from keys; run
eagerly, every such draw is recorded here and fed to the port as its
``draws``, so both packages follow the same stochastic branches
(draw-exact) and their states can be compared directly. Tolerances:

* draw-exact states: fidelity > 1 - 1e-5 and norm 1 +- 1e-4, the bounds
  of ``tests/test_bigtraj.py`` (the real-state path is free in a global
  sign); planar circuits elementwise to 2e-5;
* reductions (Grams, reduced density matrices, rotations): 1e-5 against
  NumPy on the same state;
* sampled distributions: total variation distance < 0.06 at 30000 shots
  (``test_sample_fn_counts_match_state``), 0.12 between two 64-trajectory
  Monte-Carlo runs (``test_run_with_noise_huge_distribution``), 0.15 per
  entry between two 60-trial ensembles.

``chunked`` forces the in-place threshold and the chunk size down so the
chunked reductions and appliers run over several pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.measurement import MeasurementBasis as JBasis
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import bigtraj as jbt
from quantum_simulator_tpu.ops import monomial_traj as jmt
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu.ops import unitary_traj as jut
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch.ops import bigstate as tbig
from quantum_simulator_tpu_torch.ops import bigtraj as tbt
from quantum_simulator_tpu_torch.ops import monomial_traj as tmt
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.ops import unitary_traj as tut
from tests.test_torch_traj import (_x_damping_models, both, jax_branch,
                                   model)


@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunked(request, monkeypatch):
    if request.param:
        monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
        monkeypatch.setattr(tplan, "CHUNK_ELEMS", 512)
    return request.param


@pytest.fixture
def recorded(monkeypatch):
    """Every ``jax.random.categorical`` result of the eager JAX calls made
    inside the test, in call order."""
    draws: list[int] = []
    original = jax.random.categorical

    def recording(key, logits, *args, **kwargs):
        out = original(key, logits, *args, **kwargs)
        if not isinstance(out, jax.core.Tracer):    # eager calls only
            draws.append(int(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", recording)
    return draws


def monomial_draws(spec, recorded: list[int], rank: int) -> list:
    """The port's replay record from the JAX monomial body's recorded
    draws: per window the basis sample's per-axis indices, then one
    branch per noise site (a measurement site draws nothing)."""
    it = iter(recorded)
    out = []
    for window in spec.windows:
        idxs = [next(it) for _ in range(rank)]
        branches = [0 if site.event_index >= 0 else next(it)
                    for site in window]
        out.append((torch.tensor([idxs]), torch.tensor([branches])))
    assert next(it, None) is None, "unused recorded draws"
    return out


def flat(x, planar: bool) -> np.ndarray:
    a = np.asarray(x)
    if planar:
        return (a[0] + 1j * a[1]).reshape(-1)
    return a.reshape(-1).astype(complex)


def fidelity(a: np.ndarray, b: np.ndarray) -> float:
    return abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real
                                      * np.vdot(b, b).real)


def with_rz(c):
    col = max(g.column for g in c.gates) + 1
    for q in range(c.num_qubits):
        c.add_gate(jq.GateInstance("Rz", [q], [0.3 + 0.1 * q], column=col))
    return c


def cphase_circuit():
    c = jq.QuantumCircuit(13)
    for q in range(13):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    c.add_gate(jq.GateInstance("CZ", [0, 12], [], column=1))
    c.add_gate(jq.GateInstance("CZ", [3, 4], [], column=1))
    c.add_gate(jq.GateInstance("MCZ3", [1, 6, 11], [], column=2))
    for q in range(13):
        c.add_gate(jq.GateInstance("Ry", [q], [0.05 * q + 0.1], column=3))
    return c


def wide_mcz4():
    c = jq.QuantumCircuit(12)
    for q in range(12):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    c.add_gate(jq.GateInstance("MCZ4", [0, 3, 6, 9], [], column=1))
    return c


def toffoli(n, targets):
    """n = 15, (1, 7, 14): two groups with a lone bit in one (a cross
    operator); n = 16, (1, 5, 12): three groups (the 'bits' contraction,
    and a ``GenericStep`` in the group plan)."""
    c = jq.QuantumCircuit(n)
    c.add_gate(jq.GateInstance("H", [targets[0]], [], column=0))
    c.add_gate(jq.GateInstance("H", [targets[1]], [], column=0))
    c.add_gate(jq.GateInstance("Toffoli", list(targets), [], column=1))
    return c


def programs(jc):
    return (jprog.compile_circuit(jc), tprog.compile_circuit(
        tq.QuantumCircuit.from_dict(jc.to_dict())))


def mcz3_three_axes():
    c = jq.QuantumCircuit(15)
    for q in range(15):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    c.add_gate(jq.GateInstance("MCZ3", [0, 7, 14], [], column=1))
    for q in range(15):
        c.add_gate(jq.GateInstance("Ry", [q], [0.07 * q + 0.2], column=2))
    return c


# name -> (circuit, JAX noise model, key seed): tests/test_bigtraj.py
FOLD_CASES = {
    "mixed-channels": lambda: (
        brickwork_circuit(9, 4, seed=5),
        model(jq.BitFlipNoise(0.08), jq.AmplitudeDampingNoise(0.15)), 11),
    "real-depolarizing": lambda: (
        brickwork_circuit(10, 3, seed=3), model(jq.DepolarizingNoise(0.1)),
        7),
    "planar-rz": lambda: (
        with_rz(brickwork_circuit(9, 2, seed=3)),
        model(jq.DepolarizingNoise(0.1)), 11),
    "cphase-ops-fold-densely": lambda: (
        cphase_circuit(), model(jq.DepolarizingNoise(0.12)), 5),
    "wide-mcz4-per-qubit-draws": lambda: (
        wide_mcz4(), model(jq.PhaseFlipNoise(0.15)), 21),
    "toffoli-two-groups": lambda: (
        toffoli(15, (1, 7, 14)), model(jq.BitFlipNoise(0.1)), 5),
    "toffoli-three-groups-bits": lambda: (
        toffoli(16, (1, 5, 12)), model(jq.BitFlipNoise(0.1)), 5),
    "mcz3-three-axes-prod": lambda: (
        mcz3_three_axes(), model(jq.PhaseFlipNoise(0.2)), 7),
    "gate-specific": lambda: (
        brickwork_circuit(9, 4, seed=9),
        model(gate=("CNOT", jq.DepolarizingNoise(0.15))), 13),
}


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_body_draw_exact_against_jax(name, chunked, recorded):
    """``fold_trajectory_body`` fed the branch indices that
    ``plan.group_trajectory_body`` of the JAX package drew
    (``test_mixed_channels_fold_path_draw_exact``, ``_fold_vs_group``)."""
    jc, jnm, seed = FOLD_CASES[name]()
    jp, jnm, tp, tnm, _ = both(jc, jnm)
    ref = np.asarray(jplan.group_trajectory_body(
        jp, jnm, jnp.asarray(jp.initial_params), jax.random.PRNGKey(seed),
        jnp.complex64))
    draws = torch.tensor([recorded])
    got, used = tbt.fold_trajectory_body(tp, tnm, tp.initial_params, 1,
                                         "cpu", draws=draws)
    assert used is draws and got.shape == (1, 1 << jp.num_qubits)
    g = got[0].numpy()
    assert fidelity(ref, g) > 1 - 1e-5
    np.testing.assert_allclose(np.vdot(g, g).real, 1.0, atol=1e-4)
    if name == "planar-rz":     # no phase freedom on the planar path
        np.testing.assert_allclose(g, ref, atol=2e-5)
    # the evolution of a provided state is the same function
    planar = not tbt.trajectory_is_real(tp, tnm)
    assert planar == (not jbt.trajectory_is_real(jp, jnm))
    x0 = tplan.layout_basis_state(
        tplan.GroupLayout.for_qubits(tp.num_qubits), tp.initial_index,
        "cpu", planar, 1)
    x, _ = tbt.huge_trajectory_evolve(tp, tnm, tp.initial_params, x0,
                                      draws=draws, plain=True)
    assert fidelity(flat(x[0], planar), g) > 1 - 1e-6


def test_fold_body_draws_its_own_and_replays():
    jc, jnm, _ = FOLD_CASES["mixed-channels"]()
    _, _, tp, tnm, _ = both(jc, jnm)
    gen = torch.Generator().manual_seed(3)
    a, draws = tbt.fold_trajectory_body(tp, tnm, tp.initial_params, 6, "cpu",
                                        gen)
    assert draws.shape[0] == 6 and draws.dtype == torch.long
    assert len({tuple(r.tolist()) for r in draws}) > 1   # rows differ
    b, _ = tbt.fold_trajectory_body(tp, tnm, tp.initial_params, 6, "cpu",
                                    draws=draws, plain=True)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.abs().square().sum(-1).numpy(), 1.0,
                               atol=1e-5)


def test_fold_supported_routing_matches_jax():
    """``test_fold_supported_routing``'s circuits, and the rule it feeds:
    a channel that is neither mixed-unitary nor monomial takes the fold
    body wherever every op has an applier."""
    brick = brickwork_circuit(10, 2, seed=1)
    mcz5 = jq.QuantumCircuit(12)
    mcz5.add_gate(jq.GateInstance("MCZ5", [0, 2, 4, 6, 8], [], column=0))
    jnm, tnm = _x_damping_models()
    for jc in (brick, mcz5, toffoli(16, (1, 5, 12)), wide_mcz4()):
        jp, tp = programs(jc)
        assert tbt.fold_supported(tp) == jbt.fold_supported(jp) is True
        assert tprog.trajectory_route(tp, tnm) == "fold"
    layout = tplan.GroupLayout.for_qubits(15)
    assert tbt._matrix_kind(layout, (1, 7, 14)) == "cross"
    assert tbt._matrix_kind(layout, (1, 2)) == "axis"
    assert tbt._matrix_kind(layout, (0, 1, 8)) == "bits"
    assert tbt._matrix_kind(layout, (1, 2, 8, 9)) == "bits"


EVOLVE_ROUTES = {
    "unitary": lambda: (brickwork_circuit(9, 3, seed=3),
                        model(jq.DepolarizingNoise(0.1))),
    "monomial": lambda: (brickwork_circuit(9, 3, seed=3),
                         model(jq.AmplitudeDampingNoise(0.2))),
    "monomial-mix": lambda: (
        brickwork_circuit(9, 4, seed=5),
        model(jq.BitFlipNoise(0.08), jq.AmplitudeDampingNoise(0.15))),
    "generic-step-refuses-splice": lambda: (
        toffoli(16, (1, 5, 12)), model(jq.BitFlipNoise(0.1))),
}


@pytest.mark.parametrize("name", sorted(EVOLVE_ROUTES))
def test_evolve_route_matches_jax(name):
    jp, jnm, tp, tnm, _ = both(*EVOLVE_ROUTES[name]())
    want = ("unitary" if jut.unitary_insert_evolve_ok(jp, jnm) else
            "monomial" if jmt.monomial_insert_evolve_ok(jp, jnm) else "fold")
    assert tbt.trajectory_evolve_route(tp, tnm) == want
    assert want == {"generic-step-refuses-splice": "fold",
                    "monomial-mix": "monomial"}.get(name, name)
    assert tut.unitary_insert_evolve_ok(tp, tnm) == \
        jut.unitary_insert_evolve_ok(jp, jnm)
    assert tmt.monomial_insert_evolve_ok(tp, tnm) == \
        jmt.monomial_insert_evolve_ok(jp, jnm)


@pytest.mark.parametrize("route", ["unitary", "monomial", "fold"])
def test_huge_state_body_draw_exact_against_jax(route, chunked, recorded):
    """``huge_trajectory_state_body`` of both packages on the same draws,
    one case per evolution; the JAX one runs with ``n_chunks=2``."""
    if route == "fold":
        jc = brickwork_circuit(9, 3, seed=3)
        jnm, tnm = _x_damping_models(0.2)
        jp, tp = programs(jc)
    else:
        jp, jnm, tp, tnm, _ = both(*EVOLVE_ROUTES[route]())
    key = jax.random.PRNGKey(4)
    jx, jplanar = jbt.huge_trajectory_state_body(
        jp, jnm, jnp.asarray(jp.initial_params), key, jnp.complex64,
        n_chunks=2)
    assert tbt.trajectory_evolve_route(tp, tnm) == route
    if route == "unitary":
        draws = torch.from_numpy(
            jax_branch(jut.unitary_insert_spec(jp, jnm), key))[None]
    elif route == "monomial":
        draws = monomial_draws(tmt.monomial_spec(tp, tnm), recorded, 2)
    else:
        draws = torch.tensor([recorded])
    x, planar, used = tbt.huge_trajectory_state_body(
        tp, tnm, tp.initial_params, 1, "cpu", draws=draws)
    assert planar == jplanar
    assert route == "monomial" or used is draws
    assert tuple(x.shape[1:]) == tuple(np.asarray(jx).shape)
    got, ref = flat(x[0], planar), flat(jx, jplanar)
    assert fidelity(ref, got) > 1 - 1e-5
    np.testing.assert_allclose(np.vdot(got, got).real, 1.0, atol=1e-4)
    # the flat-result body on the same draws is the same trajectory
    states, _ = tprog.batched_trajectories(tp, tnm, tp.initial_params, 1,
                                           "cpu", draws=draws)
    assert fidelity(states[0].numpy(), got) > 1 - 1e-5


def test_monomial_body_draw_exact_against_jax(recorded):
    """The monomial splice body fed the JAX package's basis samples and
    site draws."""
    jp, jnm, tp, tnm, _ = both(*EVOLVE_ROUTES["monomial-mix"]())
    ref = np.asarray(jmt.monomial_trajectory_body(
        jp, jnm, jnp.asarray(jp.initial_params), jax.random.PRNGKey(11),
        jnp.complex64))
    draws = monomial_draws(tmt.monomial_spec(tp, tnm), recorded, 2)
    got, _ = tmt.monomial_trajectory_body(tp, tnm, tp.initial_params, 1,
                                          "cpu", draws=draws)
    assert fidelity(ref, got[0].numpy()) > 1 - 1e-5


def random_batch(T, n, planar, seed):
    layout = tplan.GroupLayout.for_qubits(n)
    rng = np.random.default_rng(seed)
    shape = (T,) + ((2,) if planar else ()) + tuple(layout.axis_sizes)
    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.sqrt((x.reshape(T, -1) ** 2).sum(-1)).reshape(
        (T,) + (1,) * (x.ndim - 1))
    psi = (x[:, 0] + 1j * x[:, 1] if planar else x.astype(complex))
    return torch.from_numpy(x), psi.reshape(T, -1), layout


def dense_rho(psi: np.ndarray, targets, n: int) -> np.ndarray:
    """(T, 2^k, 2^k) reduced density matrices, first target = MSB."""
    T = psi.shape[0]
    t = psi.reshape((T,) + (2,) * n)
    t = np.moveaxis(t, [1 + q for q in targets],
                    list(range(1, 1 + len(targets))))
    m = t.reshape(T, 1 << len(targets), -1)
    return np.einsum("tpa,tqa->tpq", m, m.conj())


@pytest.mark.parametrize("planar", [False, True], ids=["real", "planar"])
def test_reductions_match_numpy(planar, chunked):
    """``_rho_from``, ``axis_grams`` -> ``qubit_rhos_from_grams``,
    ``batched_norm_sq`` and ``normalize_`` on a random batch."""
    n, T = 10, 3
    x, psi, layout = random_batch(T, n, planar, seed=1)
    for targets in ([3], [0, 9], [5, 2], [1, 4, 8], [7, 8, 9]):
        tbits = tuple((layout.axis_of(q), layout.pos_in_axis(q))
                      for q in targets)
        got = tbt._rho_from(x, tbits, planar).numpy()
        np.testing.assert_allclose(got, dense_rho(psi, targets, n),
                                   atol=1e-5, err_msg=str(targets))
    grams = tbt.axis_grams(x, planar)
    assert [tuple(g.shape) for g in grams] == [(T, 8, 8), (T, 128, 128)]
    want = np.stack([dense_rho(psi, [q], n) for q in range(n)], axis=1)
    for t in range(T):
        got = tbt.qubit_rhos_from_grams([g[t] for g in grams], n)
        np.testing.assert_allclose(got, want[t], atol=1e-5)
    np.testing.assert_allclose(
        tbt.gram_to_qubit_rho(grams[0][0].numpy(), 3, 1), want[0, 1],
        atol=1e-5)
    np.testing.assert_allclose(tbt.batched_norm_sq(x).numpy(), 1.0,
                               atol=1e-6)
    scaled = tbt.normalize_(x.clone() * 3.0)
    np.testing.assert_allclose(scaled.numpy(), x.numpy(), atol=1e-6)


@pytest.mark.parametrize("basis", ["X", "Y"])
@pytest.mark.parametrize("planar", [False, True], ids=["real", "planar"])
def test_basis_rotation_matches_dense(basis, planar):
    n, T = 9, 2
    x, psi, layout = random_batch(T, n, planar, seed=2)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    one = h if basis == "X" else h @ np.diag([1, -1j])
    full = np.array([[1.0]])
    for _ in range(n):
        full = np.kron(full, one)
    y, out_planar = tbt.apply_basis_rotation(x, basis, layout, planar)
    assert out_planar == (planar or basis == "Y")
    got = (y[:, 0].numpy() + 1j * y[:, 1].numpy() if out_planar
           else y.numpy()).reshape(T, -1)
    np.testing.assert_allclose(got, psi @ full.T, atol=1e-5)
    same, p = tbt.apply_basis_rotation(x, "Z", layout, planar)
    assert same is x and p == planar


def test_grams_match_the_dense_ensemble():
    """Per-axis Grams of grouped trajectories against the single-qubit
    density matrices of the same trajectories' flat states (the reduction
    of ``ensemble_qubit_density_matrices`` below n = 30), to 1e-5."""
    jp, jnm, tp, tnm, _ = both(*EVOLVE_ROUTES["unitary"]())
    T, n = 5, tp.num_qubits
    gen = torch.Generator().manual_seed(8)
    states, branch = tut.unitary_insert_trajectory_body(
        tp, tnm, tp.initial_params, T, "cpu", gen)
    want = np.zeros((n, 2, 2), np.complex128)
    for q in range(n):
        s4 = states.reshape(T, 1 << q, 2, -1)
        want[q] = torch.einsum("tapb,taqb->pq", s4, s4.conj()).numpy() / T
    x, planar, _ = tbt.huge_trajectory_state_body(
        tp, tnm, tp.initial_params, T, "cpu", draws=branch)
    grams = tbt.axis_grams(x, planar)
    got = tbt.qubit_rhos_from_grams([g.sum(0) / T for g in grams], n)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.trace(got, axis1=1, axis2=2), 1.0,
                               atol=1e-5)


def test_sample_fn_counts_match_state():
    """``TestDonationChain.test_sample_fn_counts_match_state``."""
    _, _, tp, tnm, _ = both(brickwork_circuit(10, 3, seed=9),
                            model(jq.DepolarizingNoise(0.05)))
    shots = 30000
    fn, planar = tbt.huge_trajectory_sample_fn(tp, tnm, shots, "cpu",
                                               keep_state=True)
    out = fn(tp.initial_params, torch.Generator().manual_seed(3),
             torch.Generator().manual_seed(4))
    assert not planar and tuple(out.state.shape) == (8, 128)
    probs = (out.state.numpy() ** 2).reshape(-1)
    emp = np.bincount(out.indices.numpy(), minlength=1 << 10) / shots
    assert 0.5 * np.abs(emp - probs / probs.sum()).sum() < 0.06
    np.testing.assert_allclose(out.marginals[0].numpy(),
                               probs.reshape(8, 128).sum(1), atol=1e-5)
    np.testing.assert_allclose(out.marginals[1].numpy(),
                               probs.reshape(8, 128).sum(0), atol=1e-5)
    # the returned draws replay the trajectory
    again = fn(tp.initial_params, None, None, out.draws)
    torch.testing.assert_close(again.state, out.state, atol=1e-6, rtol=0)


@pytest.mark.parametrize("basis", ["X", "Y"])
def test_sample_fn_rotates_before_sampling(basis):
    _, _, tp, tnm, _ = both(brickwork_circuit(9, 3, seed=2),
                            model(jq.AmplitudeDampingNoise(0.1)))
    shots = 30000
    fn, _ = tbt.huge_trajectory_sample_fn(tp, tnm, shots, "cpu",
                                          basis=basis)
    out = fn(tp.initial_params, torch.Generator().manual_seed(1),
             torch.Generator().manual_seed(2))
    assert out.state is None and out.marginals is None
    keep, planar = tbt.huge_trajectory_sample_fn(tp, tnm, 0, "cpu",
                                                 keep_state=True)
    state = keep(tp.initial_params, None, None, out.draws).state
    psi = flat(state, planar)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    one = h if basis == "X" else h @ np.diag([1, -1j])
    full = np.array([[1.0]])
    for _ in range(9):
        full = np.kron(full, one)
    probs = np.abs(full @ psi) ** 2
    emp = np.bincount(out.indices.numpy(), minlength=1 << 9) / shots
    assert 0.5 * np.abs(emp - probs / probs.sum()).sum() < 0.06


def test_sample_fn_refuses_what_returns_nothing():
    _, _, tp, tnm, _ = both(brickwork_circuit(8, 2, seed=1),
                            model(jq.DepolarizingNoise(0.05)))
    with pytest.raises(ValueError, match="keep_state"):
        tbt.huge_trajectory_sample_fn(tp, tnm, 0, "cpu")
    with pytest.raises(ValueError, match="rotation"):
        tbt.huge_trajectory_sample_fn(tp, tnm, 10, "cpu", keep_state=True,
                                      basis="X")
    jp = jprog.compile_circuit(brickwork_circuit(8, 2, seed=1))
    with pytest.raises(ValueError, match="keep_state"):
        jbt.huge_trajectory_sample_fn(jp, model(jq.DepolarizingNoise(0.05)),
                                      0)


# ---------------------------------------------------------------------------
# Simulator: the n >= 30 noisy methods, driven directly at small n
# ---------------------------------------------------------------------------

def sim_models():
    jx, tx = _x_damping_models(0.1)
    return {"unitary": (model(jq.DepolarizingNoise(0.08)), None),
            "monomial": (model(jq.AmplitudeDampingNoise(0.1)), None),
            "fold": (jx, tx)}


@pytest.mark.parametrize("route", ["unitary", "monomial", "fold"])
def test_run_huge_noisy_matches_jax_in_kind(route):
    """``_run_huge`` with noise in both packages
    (``TestSimulatorHugeNoisy.test_run_huge_single_trajectory``): the same
    kind of result; in the port the X-basis run's final state is the
    Z-basis run's (same seed, so the same draws, replayed unrotated)."""
    jnm, tnm = sim_models()[route]
    jc = brickwork_circuit(10, 3, seed=9)
    jp, tp = programs(jc)
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    tnm = tnm or tq.NoiseModel.from_dict(jnm.to_dict())
    assert tbt.trajectory_evolve_route(tp, tnm) == route
    jres = jq.Simulator(noise_model=jnm)._run_huge(
        jc, jp, 200, False, 3, np.random.default_rng(3), JBasis.Z)
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    states = {}
    for basis in (tq.MeasurementBasis.Z, tq.MeasurementBasis.X):
        res = sim._run_huge(tc, 2000, False, 3, np.random.default_rng(3),
                            basis)
        fs = res.final_state
        assert isinstance(fs, tq.PlanarStateVector)
        assert fs.is_planar == jres.final_state.is_planar is False
        np.testing.assert_allclose(fs.norm_sq(), 1.0, atol=1e-4)
        assert sum(res.measurement_counts.values()) == 2000
        np.testing.assert_allclose(
            fs.qubit_probabilities(),
            tbig.qubit_probs_from_marginals(
                tbig.state_axis_marginals(fs.state_data, False), 10),
            atol=1e-6)
        states[basis.name] = fs.state_data
    torch.testing.assert_close(states["X"], states["Z"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(jres.final_state.norm_sq(), 1.0, atol=1e-4)
    assert sum(jres.measurement_counts.values()) == 200


def dist(counts: dict, n: int) -> np.ndarray:
    v = np.zeros(1 << n)
    for b, k in counts.items():
        v[int(b, 2)] = k
    return v / v.sum()


def test_run_with_noise_huge_distribution_matches_jax():
    """``_run_with_noise_huge`` of both packages and the port's batched
    path below n = 30 sample one distribution."""
    jnm = model(jq.DepolarizingNoise(0.08))
    jc = brickwork_circuit(6, 3, seed=9)
    _, _, _, tnm, tc = both(jc, jnm)
    shots = 20000
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    r_h = sim._run_with_noise_huge(tc, shots, 1, np.random.default_rng(1),
                                   64)
    assert r_h.final_state is None and r_h.num_shots == shots
    assert sum(r_h.measurement_counts.values()) == shots
    r_d = sim.run_with_noise(tc, shots, seed=2)
    r_j = jq.Simulator(noise_model=jnm)._run_with_noise_huge(
        jc, shots, 1, np.random.default_rng(1), 64)
    assert r_j.final_state is None
    got = dist(r_h.measurement_counts, 6)
    assert 0.5 * np.abs(got - dist(r_d.measurement_counts, 6)).sum() < 0.12
    assert 0.5 * np.abs(got - dist(r_j.measurement_counts, 6)).sum() < 0.12


def test_run_with_noise_huge_shot_split_and_readout():
    jnm = model(jq.DepolarizingNoise(0.05))
    _, _, _, tnm, tc = both(brickwork_circuit(8, 2, seed=1), jnm)
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    # default: min(shots, 16) trajectories; 10 shots over 4: 3, 3, 2, 2
    for shots, traj in ((10, 4), (5, None), (40, None), (0, 3)):
        r = sim._run_with_noise_huge(tc, shots, 0, np.random.default_rng(0),
                                     traj)
        assert sum(r.measurement_counts.values()) == shots
    tnm.set_readout_error(tq.ReadoutError(1.0, 1.0))    # every bit flips
    flipped = sim._run_with_noise_huge(tc, 50, 0, np.random.default_rng(0),
                                       2)
    tnm2 = tq.NoiseModel.from_dict(jnm.to_dict())
    plain = tq.Simulator(noise_model=tnm2, device="cpu")\
        ._run_with_noise_huge(tc, 50, 0, np.random.default_rng(0), 2)
    mask = (1 << 8) - 1
    assert {format(int(b, 2) ^ mask, "08b"): k
            for b, k in plain.measurement_counts.items()} == \
        flipped.measurement_counts


def test_ensemble_qubit_rhos_huge_branch(monkeypatch):
    """The Gram-reduction branch of ``ensemble_qubit_density_matrices``
    (entered by lowering the threshold) against the batched branch and
    the JAX package's Gram path
    (``test_ensemble_qubit_rho_huge_path_matches``)."""
    jnm = model(jq.DepolarizingNoise(0.1))
    jc = brickwork_circuit(9, 3, seed=7)
    jp, _, _, tnm, tc = both(jc, jnm)
    sim = tq.Simulator(noise_model=tnm, device="cpu")
    trials = 60
    ref = sim.ensemble_qubit_density_matrices(tc, n_trials=trials, seed=1)
    monkeypatch.setattr(tbig, "HUGE_MIN_QUBITS", 9)
    got = sim.ensemble_qubit_density_matrices(tc, n_trials=trials, seed=5)
    assert got.shape == (9, 2, 2)
    np.testing.assert_allclose(np.trace(got, axis1=1, axis2=2), 1.0,
                               atol=1e-4)
    np.testing.assert_allclose(got, got.conj().transpose(0, 2, 1),
                               atol=1e-6)
    assert np.abs(got - ref).max() < 0.15
    fn, _ = jbt.huge_trajectory_gram_fn(jp, jnm)
    acc = np.zeros((9, 2, 2), np.complex128)
    key = jax.random.PRNGKey(0)
    for t in range(trials):
        acc += jbt.qubit_rhos_from_grams(
            fn(jnp.asarray(jp.initial_params), jax.random.fold_in(key, t)),
            9)
    assert np.abs(got - acc / trials).max() < 0.15
    # without channels: one ideal run, exact
    ideal = tq.Simulator(device="cpu")
    want = tq.Simulator(device="cpu")
    monkeypatch.setattr(tbig, "HUGE_MIN_QUBITS", 30)
    dense = want.ensemble_qubit_density_matrices(tc, n_trials=1, seed=0)
    monkeypatch.setattr(tbig, "HUGE_MIN_QUBITS", 9)
    np.testing.assert_allclose(
        ideal.ensemble_qubit_density_matrices(tc, n_trials=7, seed=0),
        dense, atol=1e-5)
