"""The port's host planner, NumPy operand build and torch executor vs the
JAX package's (``quantum_simulator_tpu/ops/plan.py``).

The same circuit (built with the JAX package, carried over as its dict)
goes through both sides:

* ``build_group_plan`` must give the same steps and realness flags;
* the port's NumPy operands must equal ``build_group_operands(...,
  xp=np)`` after ``interop.operands_from_numpy``, within 1e-6;
* the same NumPy operands fed to both executors agree within 1e-5;
* the whole forward pass matches the jitted JAX ``group_forward_body``
  within 1e-5 (the tolerance of ``tests/test_group_plan.py``), called
  directly because JAX's CPU ``forward_fn`` takes the per-gate path.

The circuits run all six step kinds. On the CPU the dense and cross steps
go through the kernels' plain twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_circuit_dict

from quantum_simulator_tpu.algorithms import AlgorithmTemplate
from quantum_simulator_tpu.circuit import GateInstance as JGate
from quantum_simulator_tpu.circuit import QuantumCircuit as JCircuit
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu_torch import QuantumCircuit
from quantum_simulator_tpu_torch.interop import (operands_from_numpy,
                                                 params_from_numpy)
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def straddling():
    """Bare straddling SWAP / CNOT (bit pairs), a cross CZ (diag pair)
    and a folded cross."""
    c = JCircuit(10)
    c.add_gate(JGate("H", [1], [], column=0))
    c.add_gate(JGate("SWAP", [1, 8], [], column=1))
    c.add_gate(JGate("CNOT", [2, 9], [], column=2))
    c.add_gate(JGate("CZ", [0, 7], [], column=3))
    c.add_gate(JGate("Ry", [1], [0.3], column=4))
    c.add_gate(JGate("CNOT", [1, 8], [], column=5))
    return c


def generic_three_groups():
    c = JCircuit(16, initial_states=[1] + [0] * 15)
    c.add_gate(JGate("X", [4], [], column=0))
    c.add_gate(JGate("H", [12], [], column=0))
    c.add_gate(JGate("Toffoli", [0, 4, 12], [], column=1))
    c.add_gate(JGate("Rx", [5], [0.7], column=2))
    return c


def mixed_gates():
    """Every parameterized builder plus fixed complex gates."""
    rng = np.random.default_rng(8)
    c = JCircuit(11, initial_states=[0, 1] + [0] * 9)
    col = 0
    for layer in range(3):
        for q in range(11):
            name = ["U3", "Rx", "Phase", "T", "S_DAG", "Y"][(q + layer) % 6]
            n_p = {"U3": 3, "Rx": 1, "Phase": 1}.get(name, 0)
            c.add_gate(JGate(name, [q], list(rng.uniform(0, 6, n_p)),
                             column=col))
        col += 1
        for q in range(layer % 2, 10, 2):
            c.add_gate(JGate("CPhase", [q, q + 1], [0.4 * q], column=col))
        col += 1
        c.add_gate(JGate("Fredkin", [0, 3, 9], [], column=col))
        col += 1
    return c


CIRCUITS = {
    **{f"brickwork-{n}-{'rz' if mix else 'ry'}": (
        lambda n=n, mix=mix: JCircuit.from_dict(
            build_circuit_dict(n, 20 if n <= 12 else 12, 7 + n, mix)))
       for n in (8, 10, 12, 14) for mix in (False, True)},
    "brickwork-ansatz-10": lambda: brickwork_circuit(10, 6, seed=3),
    "qft-9": lambda: AlgorithmTemplate.quantum_fourier_transform(9),
    "qft-12": lambda: AlgorithmTemplate.quantum_fourier_transform(12),
    "grover-9": lambda: AlgorithmTemplate.grover_search(
        9, marked_state=5, num_iterations=2),
    "grover-15-wide-mcz": lambda: AlgorithmTemplate.grover_search(
        15, marked_state=1234, num_iterations=1),
    "straddling": straddling,
    "generic-3-groups": generic_three_groups,
    "mixed-gates": mixed_gates,
}


def both(name):
    jc = CIRCUITS[name]()
    tc = QuantumCircuit.from_dict(jc.to_dict())
    jp = jprog.compile_circuit(jc)
    tp = tprog.compile_circuit(tc)
    return jp, tp


def step_tuple(s):
    return (type(s).__name__, dataclasses.astuple(s))


def test_all_six_step_kinds_are_covered():
    kinds = set()
    for name in CIRCUITS:
        _, tp = both(name)
        kinds |= {type(s).__name__ for s in tplan.build_group_plan(tp).steps}
    assert kinds == {"AxisMatmulStep", "CrossStep", "BitPairStep",
                     "DiagPairStep", "DiagProductStep", "GenericStep"}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_plan_matches(name):
    jp, tp = both(name)
    assert np.array_equal(jp.initial_params, tp.initial_params)
    assert jp.initial_index == tp.initial_index
    jpl = jplan.build_group_plan(jp)
    tpl = tplan.build_group_plan(tp)
    assert [step_tuple(s) for s in jpl.steps] == \
        [step_tuple(s) for s in tpl.steps]
    for field in ("dense_real", "cross_real", "diag_real", "prod_real",
                  "bitpair_real", "all_real"):
        assert getattr(jpl, field) == getattr(tpl, field), field
    assert jpl.layout.axis_sizes == tpl.layout.axis_sizes
    assert jplan.count_state_passes(jpl) == tplan.count_state_passes(tpl)


def _jax_operands(jp, jpl):
    return jplan.build_group_operands(jp, jpl, jp.initial_params,
                                      jnp.complex64, xp=np)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_operands_match(name):
    jp, tp = both(name)
    jpl = jplan.build_group_plan(jp)
    want = operands_from_numpy(_jax_operands(jp, jpl))
    got = tplan.build_group_operands(tp, tplan.build_group_plan(tp),
                                     tp.initial_params)
    for w, g in zip(want[0] + want[1] + want[2], got[0] + got[1] + got[2]):
        assert w.shape == g.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-6)
    for (wf, wr, wi), (gf, gr, gi) in zip(want[3], got[3]):
        assert (wr, wi) == pytest.approx((gr, gi), abs=1e-6)
        for a, b in zip(wf, gf):
            np.testing.assert_array_equal(a, b)
    for w, g in zip(want[4], got[4]):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("name", ["brickwork-12-ry", "brickwork-12-rz",
                                  "qft-9", "straddling", "generic-3-groups",
                                  "grover-15-wide-mcz"])
def test_same_operands_both_executors(name):
    """Identical NumPy operators into the JAX executor and the port's."""
    jp, tp = both(name)
    jpl = jplan.build_group_plan(jp)
    np_ops = _jax_operands(jp, jpl)
    planar = not jpl.all_real
    if planar:
        x0 = jplan._planar_basis_state(jpl.layout, jp.initial_index)
    else:
        x0 = jplan._real_basis_state(jpl.layout, jp.initial_index)
    want = np.asarray(jplan.execute_group_plan(
        jpl, np_ops, jp, jnp.asarray(jp.initial_params), jnp.complex64, x0,
        planar=planar))
    tpl = tplan.build_group_plan(tp)
    ops = tplan.operands_to(operands_from_numpy(np_ops), "cpu")
    got = tplan.execute_group_plan(
        tpl, ops, tp, params_from_numpy(jp.initial_params),
        tplan.basis_state(tpl, tp.initial_index, "cpu", planar), planar)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_forward_matches_group_forward_body(name):
    jp, tp = both(name)
    fwd = jax.jit(lambda p: jplan.group_forward_body(jp, p, jnp.complex64))
    want = np.asarray(fwd(jnp.asarray(jp.initial_params)))
    got = tplan.group_forward_body(tp, tp.initial_params, "cpu")
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_layout_matches():
    for n in (1, 5, 7, 8, 14, 16, 28, 30, 32):
        jl = jplan.GroupLayout.for_qubits(n)
        tl = tplan.GroupLayout.for_qubits(n)
        assert (jl.axis_sizes, jl.axis_bits) == (tl.axis_sizes, tl.axis_bits)
        for q in range(n):
            assert jl.axis_of(q) == tl.axis_of(q)
            assert jl.pos_in_axis(q) == tl.pos_in_axis(q)


def test_bench_headline_plan_shape():
    """The n=16 depth-40 bench circuit: 22 dense + 20 cross steps and the
    pass count ``bench.py`` reports."""
    tp = tprog.compile_circuit(
        QuantumCircuit.from_dict(build_circuit_dict(16, 40, 42)))
    plan = tplan.build_group_plan(tp)
    kinds = [type(s).__name__ for s in plan.steps]
    assert kinds.count("AxisMatmulStep") == 22
    assert kinds.count("CrossStep") == 20
    assert plan.all_real and tplan.count_state_passes(plan) == 42
