"""The port's variational path vs the JAX package's, on the CPU.

The same circuits (carried over as dicts), costs and parameter values
(NumPy, from a seed) go through both packages; each JAX reference is
computed once per module. Tolerances and why:

* Costs, host and device: 1e-5. Both evaluate in complex64 (float32
  parts), the JAX package with per-gate einsums, the port with composed
  group-plan operators: the sums run in another order.
* Gradients: 1e-4. Parameter shift and autodiff are exact rules on
  float32 costs; finite differences divide float32 cost differences by
  2 epsilon, so one rounding step of a cost (about 1e-7 at cost ~1) moves
  the gradient by 1e-7 / (2 epsilon): 5e-4 at the default epsilon = 1e-4,
  and 5e-6 at the epsilon = 1e-2 the comparisons here use.
* The batched group executor (the plain twins) against the per-gate body
  on one parameter batch: 1e-5, the executor tolerance of
  ``tests/test_torch_plan.py``.
* Optimizer histories over 5 iterations, ``multi_start`` results over 10:
  1e-4, the gradient tolerance (Adam's first step is lr x sign(g), later
  steps scale with relative gradient errors of about 1e-5).
* Plateau variances: 1e-5 relative, from gradients of parameter shift.
"""

import functools

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import models as jmodels
from quantum_simulator_tpu import optimizer as jopt
from quantum_simulator_tpu.ops import program as jprog
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import optimizer as topt
from quantum_simulator_tpu_torch.gates import PARAM_BUILDERS, TORCH_BUILDERS
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog

CPU = "cpu"
FD_EPS = 1e-2


def port(jc):
    return tq.QuantumCircuit.from_dict(jc.to_dict())


def mixed_circuit(n=4):
    """Ry, Rz, Rx, U3, Phase and CPhase between fixed gates."""
    c = jq.QuantumCircuit(n)
    col = 0
    for q in range(n):
        c.add_gate(jq.GateInstance("Ry", [q], [0.2 + 0.3 * q], column=col))
    col += 1
    for q in range(n - 1):
        c.add_gate(jq.GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    c.add_gate(jq.GateInstance("U3", [1], [0.4, -0.7, 1.1], column=col))
    c.add_gate(jq.GateInstance("Rz", [0], [0.9], column=col))
    col += 1
    c.add_gate(jq.GateInstance("CPhase", [0, n - 1], [0.6], column=col))
    col += 1
    c.add_gate(jq.GateInstance("H", [2], [], column=col))
    c.add_gate(jq.GateInstance("Rx", [n - 1], [-0.5], column=col))
    col += 1
    c.add_gate(jq.GateInstance("Phase", [2], [0.35], column=col))
    return c


CIRCUITS = {
    "hea": lambda: jmodels.hardware_efficient_ansatz(4, 2,
                                                     initial_angle=0.3),
    "qaoa": lambda: jmodels.qaoa_maxcut_ansatz(4, 2),
    "mixed": mixed_circuit,
}


def costs_for(n):
    """(jax cost, port cost) pairs by name, on n qubits."""
    rng = np.random.default_rng(11)
    target = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    target /= np.linalg.norm(target)
    obs = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    obs = obs + obs.conj().T
    edges = jmodels.maxcut_edges_ring(n)
    terms = jmodels.heisenberg_chain(n) + [(0.3, "XZ", [0, 2]),
                                           (-0.2, "IY", [1, 3])]
    pairs = {}
    for name, make in {
        "vqe_hamiltonian": lambda m: m.CostFunction.vqe_hamiltonian(terms),
        "qaoa_maxcut": lambda m: m.CostFunction.qaoa_maxcut(edges),
        "state_fidelity": lambda m: m.CostFunction.state_fidelity(target),
        "expectation_value": lambda m: m.CostFunction.expectation_value(
            obs, [2, 0]),
        "z_expectation": lambda m: m.CostFunction.z_expectation(1),
    }.items():
        pairs[name] = (make(jopt), make(topt))
    return pairs


def configs(name):
    jc = CIRCUITS[name]()
    return (jopt.ParameterizedCircuitConfig.auto_detect(jc),
            topt.ParameterizedCircuitConfig.auto_detect(port(jc)))


def values_for(cfg, seed=5):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi,
                                               cfg.num_params)


# ---------------------------------------------------------------------------
# Gate builders, bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TORCH_BUILDERS))
def test_torch_builders_match_numpy_and_batch(name):
    """A (B,) float32 angle tensor gives (B, d, d) complex64, each row the
    NumPy builder's matrix, and the builder is differentiable."""
    n_args = 3 if name == "U3" else 1
    rng = np.random.default_rng(3)
    args = rng.uniform(-np.pi, np.pi, (n_args, 5))
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in args]
    got = TORCH_BUILDERS[name](*ts)
    d = 4 if name == "CPhase" else 2
    assert got.shape == (5, d, d) and got.dtype == torch.complex64
    for b in range(5):
        want = PARAM_BUILDERS[name](*args[:, b])
        np.testing.assert_allclose(got[b].detach().numpy(), want, atol=1e-6)
    (g,) = torch.autograd.grad(got.real.sum() + got.imag.sum(), ts[0])
    assert torch.isfinite(g).all()
    assert tq.GateRegistry.instance().get(name).torch_matrix_func \
        is TORCH_BUILDERS[name]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_bindings_match_jax(name):
    jcfg, tcfg = configs(name)
    assert [(b.gate_index, b.param_index, b.name) for b in tcfg.bindings] \
        == [(b.gate_index, b.param_index, b.name) for b in jcfg.bindings]
    np.testing.assert_array_equal(tcfg.get_values(), jcfg.get_values())
    vals = values_for(tcfg)
    assert tcfg.bind_values(vals).to_dict() == \
        jcfg.bind_values(vals).to_dict()
    assert tcfg.circuit.gates[0].params == jcfg.circuit.gates[0].params
    jp, joff = jcfg.compiled()
    tp, toff = tcfg.compiled()
    np.testing.assert_array_equal(toff, joff)
    np.testing.assert_array_equal(tp.initial_params, jp.initial_params)
    c = tcfg.circuit
    assert c.compute_layers() == CIRCUITS[name]().compute_layers()
    assert c.gate_to_layer_map() == CIRCUITS[name]().gate_to_layer_map()


def test_compiled_offsets_none_for_baked_gate():
    """A bound gate without a builder is baked into the program: no
    offsets, and costs take one Simulator.run per row (as in JAX)."""
    from quantum_simulator_tpu_torch.gates import GateDefinition, GateType

    reg = tq.GateRegistry.instance()
    reg.register(GateDefinition(
        name="MyRot", display_name="MyRot", gate_type=GateType.SINGLE,
        num_qubits=1, num_params=1, param_names=("t",),
        matrix_func=PARAM_BUILDERS["Ry"], symbol="M", color="#000000"))
    try:
        c = tq.QuantumCircuit(2)
        c.add("MyRot", [0], [0.4], 0)
        c.add("CNOT", [0, 1], [], 1)
        cfg = topt.ParameterizedCircuitConfig.auto_detect(c)
        assert cfg.num_params == 1 and cfg.compiled()[1] is None
        cost = topt.CostFunction.z_expectation(1)
        g = topt.GradientEstimator.parameter_shift(cfg, cost,
                                                   np.array([0.4]),
                                                   device=CPU)
        np.testing.assert_allclose(g, [-np.sin(0.4)], atol=1e-5)
    finally:
        tq.GateRegistry.reset()


def test_runtime_gate_without_torch_builder():
    """A gate with a NumPy parameter builder but no torch one keeps its
    parameter at run time: costs take one Simulator.run per row, and
    reverse mode refuses it."""
    from quantum_simulator_tpu_torch.gates import GateDefinition, GateType

    reg = tq.GateRegistry.instance()
    reg.register(GateDefinition(
        name="MyRy", display_name="MyRy", gate_type=GateType.SINGLE,
        num_qubits=1, num_params=1, param_names=("t",),
        matrix_func=PARAM_BUILDERS["Ry"], symbol="M", color="#000000",
        param_builder=PARAM_BUILDERS["Ry"]))
    try:
        c = tq.QuantumCircuit(2)
        c.add("MyRy", [0], [0.4], 0)
        c.add("CNOT", [0, 1], [], 1)
        cfg = topt.ParameterizedCircuitConfig.auto_detect(c)
        assert cfg.compiled()[1] is not None
        cost = topt.CostFunction.z_expectation(1)
        g = topt.GradientEstimator.parameter_shift(cfg, cost,
                                                   np.array([0.4]),
                                                   device=CPU)
        np.testing.assert_allclose(g, [-np.sin(0.4)], atol=1e-5)
        with pytest.raises(ValueError, match="traceable gates"):
            topt.GradientEstimator.autodiff(cfg, cost, np.array([0.4]),
                                            device=CPU)
    finally:
        tq.GateRegistry.reset()


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch_states():
    """Four seeded normalized 4-qubit states (complex64)."""
    rng = np.random.default_rng(21)
    s = rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
    return (s / np.linalg.norm(s, axis=1, keepdims=True)).astype(
        np.complex64)


@pytest.mark.parametrize("name", ["vqe_hamiltonian", "qaoa_maxcut",
                                  "state_fidelity", "expectation_value",
                                  "z_expectation"])
def test_costs_host_and_device_match_jax(name, batch_states):
    jcost, tcost = costs_for(4)[name]
    for amp in batch_states:
        jsv = jq.StateVector(4)
        jsv.data = amp
        tsv = tq.StateVector.from_numpy(amp, device=CPU)
        want = jcost(jsv)
        assert tcost(tsv) == pytest.approx(want, abs=1e-5)
        assert float(jcost.device_fn(jax.numpy.asarray(amp), 4)) == \
            pytest.approx(want, abs=1e-5)
    got = tcost.device_fn(torch.from_numpy(batch_states), 4)
    assert got.shape == (4,)
    want = [float(jcost.device_fn(jax.numpy.asarray(a), 4))
            for a in batch_states]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert tcost.terms == jcost.terms and tcost.constant == jcost.constant


def test_pauli_terms_by_flip_mask_match_jax():
    """The grouped evaluation against the JAX package's one-qubit-at-a-
    time application, on the cases it treats apart: repeated qubits (X
    then Y, and X then X, on one qubit), an identity term (c |psi|^2),
    Z strings (no flip), strings sharing a flip mask and a support
    (contracted with one marginal), and strings on five qubits and on
    all six (the marginal is then t_m itself)."""
    n = 6
    terms = [(0.5, "XXYZX", [0, 1, 2, 3, 5]), (0.3, "XY", [2, 2]),
             (0.35, "YXZYXZ", [0, 1, 2, 3, 4, 5]),
             (-0.45, "ZYXXZY", [5, 4, 3, 2, 1, 0]),
             (-0.7, "XZX", [1, 4, 1]), (-0.8, "II", [0, 1]),
             (0.2, "ZIX", [4, 0, 5]), (-0.6, "XZ", [5, 4]),
             (1.1, "YYZZ", [3, 1, 0, 2]), (0.4, "ZZ", [0, 5]),
             (-0.9, "XX", [1, 3]), (0.25, "YY", [3, 1])]
    jcost = jopt.CostFunction.vqe_hamiltonian(terms)
    tcost = topt.CostFunction.vqe_hamiltonian(terms)
    rng = np.random.default_rng(17)
    amps = rng.standard_normal((3, 1 << n)) + 1j * rng.standard_normal(
        (3, 1 << n))
    amps = (0.9 * amps / np.linalg.norm(amps, axis=1, keepdims=True)
            ).astype(np.complex64)            # |psi|^2 = 0.81
    got = tcost.device_fn(torch.from_numpy(amps), n)
    want = [float(jcost.device_fn(jax.numpy.asarray(a), n)) for a in amps]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

GRAD_CASES = [("hea", "vqe_hamiltonian"), ("qaoa", "qaoa_maxcut"),
              ("mixed", "expectation_value"), ("mixed", "state_fidelity")]


@pytest.fixture(scope="module")
def jax_gradients():
    """JAX gradients of every method for each (circuit, cost) case."""
    out = {}
    for circ, cost_name in GRAD_CASES:
        jcfg, _ = configs(circ)
        jcost = costs_for(4)[cost_name][0]
        vals = values_for(jcfg)
        out[(circ, cost_name)] = {
            "parameter_shift": jopt.GradientEstimator.parameter_shift(
                jcfg, jcost, vals),
            "finite_difference": jopt.GradientEstimator.finite_difference(
                jcfg, jcost, vals, epsilon=FD_EPS),
            "autodiff": jopt.GradientEstimator.autodiff(jcfg, jcost, vals),
        }
    return out


@pytest.mark.parametrize("method", ["parameter_shift", "finite_difference",
                                    "autodiff"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(c))
def test_gradients_match_jax(case, method, jax_gradients):
    circ, cost_name = case
    _, tcfg = configs(circ)
    tcost = costs_for(4)[cost_name][1]
    vals = values_for(tcfg)
    want = jax_gradients[case][method]
    if method == "autodiff":
        c, g = topt.GradientEstimator.autodiff(tcfg, tcost, vals, device=CPU)
        assert c == pytest.approx(want[0], abs=1e-5)
        np.testing.assert_allclose(g, want[1], atol=1e-4)
    elif method == "finite_difference":
        g = topt.GradientEstimator.finite_difference(
            tcfg, tcost, vals, epsilon=FD_EPS, device=CPU)
        np.testing.assert_allclose(g, want, atol=1e-4)
    else:
        g = topt.GradientEstimator.parameter_shift(tcfg, tcost, vals,
                                                   device=CPU)
        np.testing.assert_allclose(g, want, atol=1e-4)


def test_group_batched_forward_matches_per_gate_body():
    """One parameter batch through the batched group executor (plain
    twins on the CPU) against the per-gate body, on n = 15: three axes
    (1, 7, 7), so Ry, Rz, U3 and CPhase land in dense, cross and diagonal
    steps and a fixed Toffoli on all three axes is a GenericStep."""
    n = 15
    c = tq.QuantumCircuit(n)
    rng = np.random.default_rng(4)
    for q in range(n):
        c.add("Ry", [q], [float(rng.uniform(-3, 3))], 0)
    col = 1
    for q in range(n - 1):
        c.add("CNOT", [q, q + 1], [], col)
        col += 1
    c.add("Rz", [3], [0.3], col)
    c.add("U3", [9], [0.1, 0.2, 0.3], col)
    c.add("CPhase", [2, 12], [0.7], col + 1)
    c.add("CPhase", [8, 10], [0.4], col + 2)
    c.add("Toffoli", [0, 5, 14], [], col + 3)
    c.add("Rx", [14], [0.9], col + 4)
    c.add("CPhase", [0, 1], [1.2], col + 5)
    program = tprog.compile_circuit(c)
    plan = tplan.get_group_plan(program)
    kinds = {type(s).__name__ for s in plan.steps}
    assert {"AxisMatmulStep", "CrossStep", "DiagPairStep",
            "GenericStep"} <= kinds
    params = torch.from_numpy((program.initial_params[None] + rng.normal(
        size=(3, program.num_params))).astype(np.float32))
    want = tprog.forward_body(program, params, CPU)
    got = tplan.group_batched_forward(program, params, CPU, plain=True)
    assert got.shape == (3, 1 << n) and got.dtype == torch.complex64
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        tprog.batched_forward_fn(program, CPU)(params), got, atol=0, rtol=0)
    # one row through the JAX per-gate body
    jprogram = jprog.compile_circuit(jq.QuantumCircuit.from_dict(
        c.to_dict()))
    jwant = np.asarray(jprog.forward_body(
        jprogram, jax.numpy.asarray(params[1].numpy())))
    np.testing.assert_allclose(want[1].numpy(), jwant, atol=1e-5)


@pytest.mark.parametrize("targets", [(1,), (0, 3), (4, 2, 0)])
def test_apply_cphase_on_a_batch(targets):
    """A (3, 2^n) batch equals three flat calls, and each row equals the
    JAX package's ``apply_cphase`` (masked by amplitude, not by row)."""
    from quantum_simulator_tpu.ops.apply import apply_cphase as japply
    from quantum_simulator_tpu_torch.ops.apply import apply_cphase

    n, value = 5, np.exp(0.7j)
    rng = np.random.default_rng(len(targets))
    amps = (rng.standard_normal((3, 1 << n))
            + 1j * rng.standard_normal((3, 1 << n))).astype(np.complex64)
    got = apply_cphase(torch.from_numpy(amps), targets, value, n)
    assert got.shape == (3, 1 << n)
    for b in range(3):
        flat = apply_cphase(torch.from_numpy(amps[b]), targets, value, n)
        torch.testing.assert_close(got[b], flat, atol=0, rtol=0)
        want = np.asarray(japply(jax.numpy.asarray(amps[b]), targets, value,
                                 n))
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-6)
    assert not torch.equal(got, torch.from_numpy(amps))


def test_parameter_batch_operands_are_per_row_and_shared():
    """Parameterized ops enter as per-row overrides; an operand no
    parameter touches stays one shared block with stride 0."""
    c = tq.QuantumCircuit(9)
    c.add("Ry", [8], [0.3], 0)
    c.add("H", [0], [], 0)
    c.add("CNOT", [1, 2], [], 1)
    program = tprog.compile_circuit(c)
    plan = tplan.get_group_plan(program)
    params = torch.tensor([[0.1], [0.2], [0.3]])
    ov = tplan.param_overrides(program, params)
    assert ov.pool_rows.shape == (3, 1, 2, 2) and not ov.per_op
    ops = tplan.build_group_operands_batched(program, plan, params, 3, CPU)
    strides = sorted(a[0].stride(0) for a in ops[0])
    assert strides[0] == 0 and strides[-1] > 0
    with pytest.raises(ValueError, match="parameter batch"):
        tplan.build_group_operands_batched(program, plan, params, 4, CPU)


# ---------------------------------------------------------------------------
# Optimizer, multi-start, plateaus
# ---------------------------------------------------------------------------

RUN_METHODS = ["parameter_shift", "finite_difference", "autodiff"]


def _fd_eps(monkeypatch):
    """Both packages' finite differences at FD_EPS (see the module
    docstring: at 1e-4 float32 rounding alone moves them by 5e-4)."""
    for mod in (jopt, topt):
        orig = mod.GradientEstimator.finite_difference
        monkeypatch.setattr(mod.GradientEstimator, "finite_difference",
                            staticmethod(functools.partial(
                                orig, epsilon=FD_EPS)))


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _fd_eps(mp)
        for method in RUN_METHODS:
            jcfg, _ = configs("hea")
            jcost = costs_for(4)["vqe_hamiltonian"][0]
            out[method] = jopt.CircuitOptimizer(
                jcfg, jcost, learning_rate=0.1, max_iterations=5,
                gradient_method=method).run(seed=3)
    return out


@pytest.mark.parametrize("method", RUN_METHODS)
def test_optimizer_run_histories_match_jax(method, jax_runs, monkeypatch):
    _fd_eps(monkeypatch)
    _, tcfg = configs("hea")
    tcost = costs_for(4)["vqe_hamiltonian"][1]
    res = topt.CircuitOptimizer(tcfg, tcost, learning_rate=0.1,
                                max_iterations=5, gradient_method=method,
                                device=CPU).run(seed=3)
    want = jax_runs[method]
    assert res.iterations == want.iterations == 5
    assert res.converged == want.converged
    for (tv, tc), (jv, jc) in zip(res.history, want.history):
        np.testing.assert_allclose(tv, jv, atol=1e-4)
        assert tc == pytest.approx(jc, abs=1e-4)
    assert res.optimal_cost == pytest.approx(want.optimal_cost, abs=1e-4)


def test_request_stop_and_step():
    _, tcfg = configs("hea")
    tcost = costs_for(4)["z_expectation"][1]
    opt = topt.CircuitOptimizer(tcfg, tcost, max_iterations=50, device=CPU)

    def callback(i, values, cost):
        if i >= 2:
            opt.request_stop()

    res = opt.run(callback=callback)
    assert res.iterations == 3 and len(opt.history) == 3
    assert opt.values.shape == (tcfg.num_params,)


@pytest.fixture(scope="module")
def multi_start_case():
    jcfg, tcfg = configs("qaoa")
    jcost, tcost = costs_for(4)["qaoa_maxcut"]
    init = np.random.default_rng(8).uniform(-np.pi, np.pi,
                                            (3, jcfg.num_params))
    want = jopt.CircuitOptimizer.multi_start(
        jcfg, jcost, n_starts=3, max_iterations=10, learning_rate=0.1,
        init_values=init)
    return tcfg, tcost, init, want


def test_multi_start_matches_jax(multi_start_case):
    tcfg, tcost, init, want = multi_start_case
    got = topt.CircuitOptimizer.multi_start(
        tcfg, tcost, n_starts=3, max_iterations=10, learning_rate=0.1,
        init_values=init, device=CPU)
    assert got.cost_histories.shape == (3, 10)
    np.testing.assert_allclose(got.cost_histories, want.cost_histories,
                               atol=1e-4)
    np.testing.assert_allclose(got.start_costs, want.start_costs, atol=1e-4)
    np.testing.assert_allclose(got.start_values, want.start_values,
                               atol=1e-4)
    assert got.best_start == want.best_start
    assert got.optimal_cost == pytest.approx(want.optimal_cost, abs=1e-4)
    np.testing.assert_allclose(got.optimal_values, want.optimal_values,
                               atol=1e-4)


def test_multi_start_draws_and_rejects_bad_inits(multi_start_case):
    tcfg, tcost, _, _ = multi_start_case
    res = topt.CircuitOptimizer.multi_start(tcfg, tcost, n_starts=2,
                                            max_iterations=2, seed=1,
                                            device=CPU)
    assert res.start_values.shape == (2, tcfg.num_params)
    assert res.optimal_cost <= res.cost_histories[:, 0].min() + 1e-6
    with pytest.raises(ValueError, match="init_values"):
        topt.CircuitOptimizer.multi_start(
            tcfg, tcost, n_starts=2, init_values=np.zeros((3, 1)),
            device=CPU)
    empty = topt.ParameterizedCircuitConfig.auto_detect(tq.QuantumCircuit(2))
    with pytest.raises(ValueError, match="no parameters"):
        topt.CircuitOptimizer.multi_start(empty, tcost, device=CPU)


@pytest.fixture(scope="module")
def jax_plateaus():
    jcfg, _ = configs("hea")
    jcost = costs_for(4)["vqe_hamiltonian"][0]
    opt = jopt.CircuitOptimizer(jcfg, jcost)
    return (opt.detect_barren_plateau(n_samples=4, seed=3),
            opt.detect_barren_plateau_layered(n_samples=4, seed=3))


def test_barren_plateau_matches_jax(jax_plateaus):
    _, tcfg = configs("hea")
    opt = topt.CircuitOptimizer(tcfg, costs_for(4)["vqe_hamiltonian"][1],
                                device=CPU)
    got = opt.detect_barren_plateau(n_samples=4, seed=3)
    want = jax_plateaus[0]
    np.testing.assert_allclose(got["per_param"], want["per_param"],
                               rtol=1e-5, atol=1e-7)
    assert got["mean_variance"] == pytest.approx(want["mean_variance"],
                                                 rel=1e-5)
    assert got["is_barren"] == want["is_barren"]


def test_barren_plateau_layered_matches_jax(jax_plateaus):
    _, tcfg = configs("hea")
    opt = topt.CircuitOptimizer(tcfg, costs_for(4)["vqe_hamiltonian"][1],
                                device=CPU)
    got = opt.detect_barren_plateau_layered(n_samples=4, seed=3)
    want = jax_plateaus[1]
    assert got.param_layer_map == want.param_layer_map
    assert [len(v) for v in got.per_layer_variance] == \
        [len(v) for v in want.per_layer_variance]
    for a, b in zip(got.per_layer_variance, want.per_layer_variance):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.per_qubit_variance,
                               want.per_qubit_variance, rtol=1e-5, atol=1e-7)
    assert got.overall_mean_variance == pytest.approx(
        want.overall_mean_variance, rel=1e-5)
    assert [d[0] for d in got.depth_scaling] == \
        [d[0] for d in want.depth_scaling]
    assert got.overall_is_barren == want.overall_is_barren
    assert got.threshold == want.threshold and got.n_samples == 4


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def test_reverse_mode_rejects_huge_circuits():
    """As in JAX: n >= 30 reverse mode would hold several 8 GiB states;
    the refusal comes before any state is allocated."""
    c = tq.QuantumCircuit(30)
    c.add("Ry", [0], [0.3], 0)
    cfg = topt.ParameterizedCircuitConfig.auto_detect(c)
    cost = topt.CostFunction.z_expectation(0)
    with pytest.raises(ValueError, match="autodiff cannot run"):
        topt.GradientEstimator.autodiff(cfg, cost, np.array([0.3]),
                                        device=CPU)
    with pytest.raises(ValueError, match="multi_start cannot run"):
        topt.CircuitOptimizer.multi_start(cfg, cost, n_starts=2, device=CPU)


def test_reverse_mode_needs_device_cost():
    _, tcfg = configs("hea")
    host_only = topt.DeviceCost(lambda s: 0.0)
    with pytest.raises(ValueError, match="DeviceCost"):
        topt.GradientEstimator.autodiff(tcfg, host_only,
                                        values_for(tcfg), device=CPU)


def test_mps_config_not_ported_yet():
    """The name is from the slice before the MPS engine was ported; the
    config runs now (``tests/test_torch_mps.py`` holds it): it binds the
    circuit's parameters, evaluates Hamiltonian costs on the MPS engine
    and refuses a dense program (reverse mode) with JAX's message."""
    c = tq.QuantumCircuit(2)
    c.add("Ry", [0], [0.3], 0)
    c.add("CNOT", [0, 1], [], 1)
    cfg = topt.MPSParameterizedConfig.auto_detect(c, chi=4)
    assert cfg.engine == "mps" and cfg.chi == 4 and cfg.num_params == 1
    cost = topt.CostFunction.z_expectation(1)
    got = topt.GradientEstimator._batched_costs(cfg, cost, np.array([[0.3]]),
                                                device=CPU)
    assert got[0] == pytest.approx(np.cos(0.3), abs=1e-6)
    with pytest.raises(ValueError, match="parameter_shift"):
        cfg.compiled()


def test_host_cost_takes_the_simulator_path():
    """A cost with no device body runs one Simulator.run per row, as the
    JAX package's fallback does: the same gradient."""
    _, tcfg = configs("hea")
    _, tcost = costs_for(4)["vqe_hamiltonian"]
    host_only = topt.DeviceCost(tcost)
    vals = values_for(tcfg)
    np.testing.assert_allclose(
        topt.GradientEstimator.parameter_shift(tcfg, host_only, vals,
                                               device=CPU),
        topt.GradientEstimator.parameter_shift(tcfg, tcost, vals,
                                               device=CPU), atol=1e-5)
