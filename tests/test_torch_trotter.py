"""The port's Trotter circuits (``models/trotter.py``) and ``ExpP`` gates
against the JAX package's (``quantum_simulator_tpu/models/trotter.py``).

``trotter_circuit`` must give the same gates (names, targets, angles,
columns); an ``ExpP`` gate's NumPy builder, torch builder and the JAX
builder agree within 1e-6; the final state through ``Simulator.run`` on
the CPU matches the JAX run within 1e-5; and the angles are ordinary
parameters: a parameter batch and an autograd gradient go through them.
"""

import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import models as jmodels
from quantum_simulator_tpu.registry import GateRegistry as JRegistry
from quantum_simulator_tpu_torch import models as tmodels
from quantum_simulator_tpu_torch.models import trotter as ttrot
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.registry import GateRegistry

PAULI = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
         "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1.0, -1.0])}

# (n, terms builder name, time, steps, order)
CIRCUITS = [(3, "tfim_chain", 1.0, 2, 1), (4, "tfim_chain", 0.8, 3, 2),
            (4, "heisenberg_chain", 0.5, 2, 2), (3, "tfim_chain", 1.0, 2, 4),
            (8, "heisenberg_chain", 0.4, 1, 2), (5, "mixed", 0.7, 2, 2)]


def terms_for(models, name, n):
    if name == "mixed":
        # identity components, a three-site string, out-of-order qubits
        return [(0.7, "XIZ", [0, 1, 2]), (1.0, "II", [0, 1]),
                (-0.4, "YZX", [4, 2, 3]), (0.9, "y", [1]),
                (0.3, "ZZ", [0, 4])]
    return getattr(models, name)(n)


@pytest.mark.parametrize("n,name,time,steps,order", CIRCUITS)
def test_trotter_circuit_matches_gate_for_gate(n, name, time, steps, order):
    jc = jmodels.trotter_circuit(n, terms_for(jmodels, name, n), time, steps,
                                 order=order)
    tc = tmodels.trotter_circuit(n, terms_for(tmodels, name, n), time, steps,
                                 order=order)
    assert len(tc.gates) == len(jc.gates) > 0
    for jg, tg in zip(jc.gates, tc.gates):
        assert (tg.gate_name, tg.target_qubits, tg.column) == \
            (jg.gate_name, jg.target_qubits, jg.column)
        assert tg.params == pytest.approx(jg.params, abs=1e-15)
    assert tc.to_dict() == jc.to_dict()


@pytest.mark.parametrize("pstr", ["X", "Y", "ZZ", "XY", "YZX", "XIZY"])
def test_expp_builders_agree(pstr):
    """NumPy builder vs torch builder vs the JAX package's, 1e-6; the
    NumPy one against the closed form, 1e-12."""
    name = ttrot.exp_pauli_gate(pstr)
    assert name == jmodels.exp_pauli_gate(pstr) == f"ExpP[{pstr}]"
    gd = GateRegistry.instance().get(name)
    jgd = JRegistry.instance().get(name)
    assert (gd.num_qubits, gd.num_params, gd.gate_type.value) == \
        (jgd.num_qubits, jgd.num_params, jgd.gate_type.value)
    assert gd.param_builder is not None and gd.torch_matrix_func is not None
    p = np.eye(1)
    for ch in pstr:
        p = np.kron(p, PAULI[ch])
    for theta in (0.0, 0.7, -2.1):
        want = np.cos(theta) * np.eye(p.shape[0]) - 1j * np.sin(theta) * p
        np.testing.assert_allclose(gd.matrix_func(theta), want, atol=1e-12)
        np.testing.assert_allclose(gd.param_builder(theta), want, atol=1e-12)
        np.testing.assert_allclose(jgd.matrix_func(theta), want, atol=1e-12)
        got = gd.torch_matrix_func(torch.tensor(theta))
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(jgd.jnp_matrix_func(np.float32(theta))), want,
            atol=1e-6)
    # batched: angles of any leading shape
    thetas = torch.tensor([[0.1, 0.2, 0.3], [1.0, -1.0, 2.0]])
    batch = gd.torch_matrix_func(thetas)
    assert tuple(batch.shape) == (2, 3) + p.shape
    np.testing.assert_allclose(batch[1, 2].numpy(), gd.matrix_func(2.0),
                               atol=1e-6)


def test_validation():
    for bad in ("XQ", "", "X" * 9):
        with pytest.raises(ValueError) as jerr:
            jmodels.exp_pauli_gate(bad)
        with pytest.raises(ValueError) as terr:
            ttrot.exp_pauli_gate(bad)
        assert str(terr.value) == str(jerr.value)
    t3 = tmodels.tfim_chain(3)
    for kw in (dict(steps=0), dict(steps=2, order=3)):
        with pytest.raises(ValueError):
            tmodels.trotter_circuit(3, t3, 1.0, **kw)
    for terms in ([(1.0, "ZZ", [0, 3])], [(1.0, "ZZ", [0])],
                  [(1.0, "ZZ", [1, 1])]):
        with pytest.raises(ValueError) as jerr:
            jmodels.trotter_circuit(3, terms, 1.0, steps=1)
        with pytest.raises(ValueError) as terr:
            tmodels.trotter_circuit(3, terms, 1.0, steps=1)
        assert str(terr.value) == str(jerr.value)
    c2 = tmodels.trotter_circuit(3, t3, 1.0, steps=2, order=2)
    c4 = tmodels.trotter_circuit(3, t3, 1.0, steps=2, order=4)
    assert len(c4.gates) == 5 * len(c2.gates)
    assert ttrot._MAX_SITES == 8


def test_expp_gates_deserialize_in_a_fresh_registry():
    c = tmodels.trotter_circuit(4, tmodels.tfim_chain(4), 0.5, 2)
    d = c.to_dict()
    GateRegistry.reset()  # a fresh process
    try:
        assert "ExpP[ZZ]" not in GateRegistry.instance().gate_names()
        c2 = tq.QuantumCircuit.from_dict(d)
        assert c2.circuit_hash() == c.circuit_hash()
        gd = GateRegistry.instance().get("ExpP[ZZ]")
        assert gd.num_params == 1 and gd.torch_matrix_func is not None
        program = tprog.compile_circuit(c2)
        assert program.num_params == len(c2.gates)
        for bad in ("ExpP[]", "ExpP[QQ]", "ExpP[" + "X" * 9 + "]"):
            with pytest.raises(KeyError):
                GateRegistry.instance().get(bad)
    finally:
        GateRegistry.reset()


@pytest.mark.parametrize("n,name,time,steps,order", CIRCUITS)
def test_final_state_matches_the_jax_run(n, name, time, steps, order):
    init = [q % 2 for q in range(n)]
    jc = jmodels.trotter_circuit(n, terms_for(jmodels, name, n), time, steps,
                                 order=order)
    jc.initial_states = list(init)
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    want = jq.Simulator().run(jc, shots=0).final_state.data
    got = tq.Simulator(device="cpu").run(tc, shots=0).final_state.data
    assert abs(np.linalg.norm(want) - 1.0) < 1e-4
    assert np.abs(want).max() < 0.999    # the state did move
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and against the exact evolution, within the formula's error
    h = np.zeros((1 << n, 1 << n), complex)
    for coeff, pstr, qubits in terms_for(tmodels, name, n):
        ops = [PAULI["I"]] * n
        for ch, q in zip(pstr.upper(), qubits):
            ops[q] = PAULI[ch]
        m = np.eye(1)
        for o in ops:
            m = np.kron(m, o)
        h = h + coeff * m
    w, v = np.linalg.eigh(h)
    psi0 = np.zeros(1 << n, complex)
    psi0[int("".join(map(str, init)), 2)] = 1.0
    exact = v @ (np.exp(-1j * w * time) * (v.conj().T @ psi0))
    overlap = abs(np.vdot(exact, got))
    assert overlap > (0.9 if order == 1 else 0.97)


def test_parameter_batch_runs_through_the_torch_builders():
    """A (B, P) batch of Trotter angles through the batched group
    executor equals one run per row."""
    n = 5
    c = tmodels.trotter_circuit(n, terms_for(tmodels, "mixed", n), 0.7, 2)
    program = tprog.compile_circuit(c)
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 1, (3, program.num_params))
    batch = tplan.group_batched_forward(
        program, torch.tensor(rows, dtype=torch.float32), "cpu")
    for b in range(3):
        one = tplan.group_forward_body(program, rows[b], "cpu")
        np.testing.assert_allclose(batch[b].numpy(), one.numpy(), atol=1e-5)


def test_gradient_through_forward_body_matches_the_shift_rule():
    """``exp(-i theta P)`` has generator eigenvalues +-1, so d<O>/dtheta =
    <O>(theta + pi/4) - <O>(theta - pi/4) for each angle."""
    n = 3
    c = tmodels.trotter_circuit(n, tmodels.tfim_chain(n), 0.9, 2)
    c.initial_states = [1, 0, 1]
    program = tprog.compile_circuit(c)
    idx = torch.arange(1 << n)
    sign = 1.0 - 2.0 * ((idx >> (n - 1)) & 1).double()   # Z on qubit 0

    def cost(params):
        psi = tprog.forward_body(program, params, "cpu")
        return (psi.abs().square().double() * sign).sum()

    p0 = torch.tensor(program.initial_params, dtype=torch.float64,
                      requires_grad=True)
    value = cost(p0.float())
    (grad,) = torch.autograd.grad(value, p0)
    shift = np.pi / 4
    want = np.zeros(program.num_params)
    for k in range(program.num_params):
        up = program.initial_params.copy()
        dn = program.initial_params.copy()
        up[k] += shift
        dn[k] -= shift
        want[k] = float(cost(torch.tensor(up, dtype=torch.float32))
                        - cost(torch.tensor(dn, dtype=torch.float32)))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, atol=1e-5)


def test_optimizer_takes_trotter_angles():
    """``ParameterizedCircuitConfig.auto_detect`` binds every ExpP angle
    and a few optimizer steps lower a Hamiltonian-variational cost."""
    from quantum_simulator_tpu_torch.optimizer import (
        CircuitOptimizer, CostFunction, ParameterizedCircuitConfig)

    n = 3
    terms = tmodels.tfim_chain(n)
    c = tmodels.trotter_circuit(n, terms, 0.6, 2)
    cfg = ParameterizedCircuitConfig.auto_detect(c)
    assert cfg.num_params == len(c.gates)
    cost = CostFunction.vqe_hamiltonian(terms)
    res = CircuitOptimizer(cfg, cost, max_iterations=5,
                           device="cpu").run()
    assert res.optimal_cost <= res.history[0][1] + 1e-9
    assert res.optimal_cost < res.history[0][1] - 1e-3
