"""The port's exact density-matrix simulator (``density.py``) against the
JAX package's (``quantum_simulator_tpu/density.py``).

The same circuit and noise model (built with the JAX package, carried
over as dicts) go through both sides on the CPU:

* the dense route against the JAX dense route, rho within 2e-5 (the
  tolerance of ``tests/test_density.py``'s superop-vs-dense checks);
* ``superop_program`` op for op against the JAX one (static matrices
  1e-12), its group plan step for step and its operands (1e-6) against
  the JAX planner;
* the port's group forward of the vec(rho) program against
  ``quantum_simulator_tpu.ops.plan.group_forward_fn`` (called directly:
  on the CPU the JAX ``_run_superop`` takes the per-gate body), 1e-5;
* ``SuperopDensityResult`` (the 2n >= 30 result, forced at small n by
  lowering ``HUGE_MIN_QUBITS``) against the dense result.

On the CPU the dense and cross steps run the kernels' plain twins.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import density as jdens
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import plan as jplan
from quantum_simulator_tpu.ops import program as jprog
from quantum_simulator_tpu_torch import density as tdens
from quantum_simulator_tpu_torch.interop import (density_result_from_numpy,
                                                 operands_from_numpy)
from quantum_simulator_tpu_torch.ops import bigstate
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RHO_TOL = 2e-5


def carry(jc, jnm=None):
    tc = tq.QuantumCircuit.from_dict(jc.to_dict())
    tnm = None if jnm is None else tq.NoiseModel.from_dict(jnm.to_dict())
    return tc, tnm


def mixed_noise():
    nm = jq.NoiseModel()
    nm.add_global_noise(jq.DepolarizingNoise(0.08))
    nm.add_gate_noise("CNOT", jq.AmplitudeDampingNoise(0.15))
    return nm


def global_noise(channel):
    nm = jq.NoiseModel()
    nm.add_global_noise(channel)
    return nm


def bell():
    c = jq.QuantumCircuit(2)
    c.add_gate(jq.GateInstance("H", [0], [], column=0))
    c.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=1))
    return c


def one_gate(name, params=()):
    c = jq.QuantumCircuit(1)
    c.add_gate(jq.GateInstance(name, [0], list(params), column=0))
    return c


def complex_gates():
    c = jq.QuantumCircuit(5)
    for q in range(5):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    c.add_gate(jq.GateInstance("Rz", [1], [0.7], column=1))
    c.add_gate(jq.GateInstance("T", [2], [], column=1))
    c.add_gate(jq.GateInstance("Rx", [3], [0.3], column=1))
    c.add_gate(jq.GateInstance("U3", [4], [0.4, 1.1, -0.6], column=1))
    c.add_gate(jq.GateInstance("CPhase", [0, 4], [1.1], column=2))
    c.add_gate(jq.GateInstance("CNOT", [1, 2], [], column=2))
    return c


def wide_mcz(n=11):
    c = jq.QuantumCircuit(n)
    for q in range(n):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    c.add_gate(jq.GateInstance(f"MCZ{n}", list(range(n)), [], column=1))
    c.add_gate(jq.GateInstance("CNOT", [0, 1], [], column=2))
    return c


def bell_2q_depol(p=0.09):
    nm = jq.NoiseModel()
    nm.add_gate_noise("CNOT", jq.TwoQubitDepolarizingNoise(p))
    return bell(), nm


def brick_2q_depol():
    """Correlated channels whose pairs lie inside one axis and across
    two (n = 8: vec(rho) has axes of 2 and 7 bits)."""
    nm = jq.NoiseModel()
    nm.add_gate_noise("CNOT", jq.TwoQubitDepolarizingNoise(0.06))
    nm.add_global_noise(jq.BitFlipNoise(0.03))
    return brickwork_circuit(8, 2, seed=5), nm


# name -> (JAX circuit, JAX noise model or None)
CASES = {
    "bell-ideal": lambda: (bell(), None),
    "full-depolarizing": lambda: (one_gate("H"),
                                  global_noise(jq.DepolarizingNoise(1.0))),
    "amp-damp-limit": lambda: (one_gate("X"), global_noise(
        jq.AmplitudeDampingNoise(1.0))),
    "bit-flip": lambda: (one_gate("X"), global_noise(jq.BitFlipNoise(0.17))),
    "ry-param": lambda: (one_gate("Ry", [0.4]), None),
    "brickwork-6-mixed": lambda: (brickwork_circuit(6, 4, seed=3),
                                  mixed_noise()),
    "complex-gates-mixed": lambda: (complex_gates(), mixed_noise()),
    "wide-mcz11": lambda: (wide_mcz(), None),
    "bell-2q-depol": bell_2q_depol,
    "brickwork-8-2q-depol": brick_2q_depol,
    "thermal": lambda: (brickwork_circuit(4, 2, seed=1), global_noise(
        jq.ThermalRelaxationNoise(50.0, 30.0, 5.0))),
}


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX dense-route rho of every case, computed once."""
    out = {}
    for name, make in CASES.items():
        jc, jnm = make()
        out[name] = jq.DensityMatrixSimulator(noise_model=jnm).run(
            jc, method="dense").rho
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_route_matches_jax(name, jax_dense):
    jc, jnm = CASES[name]()
    tc, tnm = carry(jc, jnm)
    res = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(
        tc, method="dense")
    want = jax_dense[name]
    assert res.device_rho.dtype == torch.complex64
    np.testing.assert_allclose(res.rho, want, atol=RHO_TOL)
    np.testing.assert_allclose(res.probabilities, np.real(np.diag(want)),
                               atol=RHO_TOL)
    assert res.trace() == pytest.approx(np.real(np.trace(want)), abs=1e-5)
    assert res.purity() == pytest.approx(
        np.real(np.trace(want @ want)), abs=1e-4)
    for q in range(jc.num_qubits):
        idx = np.arange(1 << jc.num_qubits)
        sign = 1.0 - 2.0 * ((idx >> (jc.num_qubits - 1 - q)) & 1)
        assert res.expectation_z(q) == pytest.approx(
            float(np.sum(np.real(np.diag(want)) * sign)), abs=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_superop_route_matches_jax_dense(name, jax_dense):
    jc, jnm = CASES[name]()
    tc, tnm = carry(jc, jnm)
    res = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(
        tc, method="superop")
    assert isinstance(res, tq.DensityMatrixResult)
    np.testing.assert_allclose(res.rho, jax_dense[name], atol=RHO_TOL)


def test_known_values():
    """The closed forms of ``tests/test_density.py``."""
    def run(jc, jnm, method="dense"):
        tc, tnm = carry(jc, jnm)
        return tq.DensityMatrixSimulator(noise_model=tnm, device="cpu").run(
            tc, method=method)

    res = run(*CASES["full-depolarizing"]())
    np.testing.assert_allclose(res.probabilities, [0.5, 0.5], atol=1e-6)
    assert res.purity() < 1.0
    res = run(*CASES["amp-damp-limit"]())
    np.testing.assert_allclose(res.probabilities, [1.0, 0.0], atol=1e-6)
    res = run(*CASES["bit-flip"]())
    assert res.probabilities[0] == pytest.approx(0.17, abs=1e-6)
    p = 0.09
    b = np.zeros(4, dtype=complex)
    b[0] = b[3] = 1 / np.sqrt(2)
    lam = 1 - 16 * p / 15
    want = lam * np.outer(b, b.conj()) + (1 - lam) * np.eye(4) / 4
    for method in ("dense", "superop"):
        np.testing.assert_allclose(run(*bell_2q_depol(p), method).rho, want,
                                   atol=1e-6)


def test_purity_of_a_complex_pure_state():
    """tr(rho^2) of |+i><+i| is 1: the purity sums |rho_ij|^2, which for
    a Hermitian rho is tr(rho rho)."""
    c = tq.QuantumCircuit(1)
    c.add("H", [0])
    c.add("S", [0])
    for method in ("dense", "superop"):
        res = tq.DensityMatrixSimulator(device="cpu").run(c, method=method)
        assert res.purity() == pytest.approx(1.0, abs=1e-5)
        np.testing.assert_allclose(
            res.rho, [[0.5, -0.5j], [0.5j, 0.5]], atol=1e-6)


def test_two_qubit_channel_rejected_on_a_one_qubit_gate():
    c = tq.QuantumCircuit(1)
    c.add("H", [0])
    nm = tq.NoiseModel()
    nm.add_gate_noise("H", tq.TwoQubitDepolarizingNoise(0.05))
    sim = tq.DensityMatrixSimulator(noise_model=nm, device="cpu")
    for method in ("dense", "superop"):
        with pytest.raises(ValueError, match="two-qubit Kraus"):
            sim.run(c, method=method)


def test_caps_and_error_messages():
    sim = tq.DensityMatrixSimulator(device="cpu")
    assert (tdens.MAX_DM_QUBITS, tdens.MAX_SUPEROP_QUBITS) == \
        (jdens.MAX_DM_QUBITS, jdens.MAX_SUPEROP_QUBITS) == (14, 15)
    jsim = jq.DensityMatrixSimulator()
    for n, method in ((15, "dense"), (16, "auto"), (16, "superop")):
        with pytest.raises(ValueError) as jerr:
            jsim.run(jq.QuantumCircuit(n), method=method)
        with pytest.raises(ValueError) as terr:
            sim.run(tq.QuantumCircuit(n), method=method)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# superop_program, its plan and operands against the JAX planner
# ---------------------------------------------------------------------------

SUPEROP_CASES = ["brickwork-6-mixed", "complex-gates-mixed", "wide-mcz11",
                 "bell-2q-depol", "brickwork-8-2q-depol", "thermal",
                 "ry-param"]


def both_superop(name):
    jc, jnm = CASES[name]()
    tc, tnm = carry(jc, jnm)
    jp2 = jdens.superop_program(jprog.compile_circuit(jc), jnm)
    tp2 = tdens.superop_program(tprog.compile_circuit(tc), tnm)
    return jp2, tp2


@pytest.mark.parametrize("name", SUPEROP_CASES)
def test_superop_program_matches_op_for_op(name):
    jp2, tp2 = both_superop(name)
    assert (tp2.num_qubits, tp2.initial_index, tp2.num_columns,
            tp2.num_params) == (jp2.num_qubits, jp2.initial_index,
                                jp2.num_columns, jp2.num_params)
    np.testing.assert_array_equal(tp2.initial_params,
                                  np.asarray(jp2.initial_params))
    assert len(tp2.ops) == len(jp2.ops)
    params = np.asarray(jp2.initial_params)
    for jo, to in zip(jp2.ops, tp2.ops):
        assert (to.gate_name, to.targets, to.param_offset, to.num_params,
                to.column_index, to.gate_index) == (
            jo.gate_name, jo.targets, jo.param_offset, jo.num_params,
            jo.column_index, jo.gate_index)
        assert (to.cphase_value is None) == (jo.cphase_value is None)
        if jo.cphase_value is not None:
            assert complex(to.cphase_value) == complex(jo.cphase_value)
        assert (to.static_matrix is None) == (jo.static_matrix is None)
        if jo.static_matrix is not None:
            np.testing.assert_allclose(to.static_matrix, jo.static_matrix,
                                       atol=1e-12)
        elif jo.cphase_value is None:
            # the NumPy and the torch builder against the JAX one
            p = [params[jo.param_offset + j] for j in range(jo.num_params)]
            want = np.asarray(jo.jnp_builder(*[jnp.float32(v) for v in p]))
            np.testing.assert_allclose(to.builder(*p), want, atol=1e-6)
            got = to.torch_builder(*[torch.tensor(v, dtype=torch.float32)
                                     for v in p])
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_superop_program_shares_one_conjugated_builder_per_gate_kind():
    """Row ops and column twins of a gate kind differ in their builders,
    and every twin of a kind shares one: the operand pools group by
    ``(gate_name, builder)``."""
    tc, _ = carry(complex_gates())
    tp = tprog.compile_circuit(tc)
    tp2 = tdens.superop_program(tp)
    n = tp.num_qubits
    by_kind: dict = {}
    for op in tp2.ops:
        if op.static_matrix is None and op.num_params:
            side = "col" if op.targets[0] >= n else "row"
            by_kind.setdefault((op.gate_name, side), set()).add(
                (op.builder, op.torch_builder))
    for (name, side), builders in by_kind.items():
        assert len(builders) == 1, (name, side)
    for name in {k[0] for k in by_kind}:
        (rb, rt), = by_kind[(name, "row")]
        (cb, ct), = by_kind[(name, "col")]
        assert rb is not cb and rt is not ct
    brick, _ = carry(brickwork_circuit(6, 4, seed=3))
    p2 = tdens.superop_program(tprog.compile_circuit(brick))
    twins = {op.builder for op in p2.ops
             if op.gate_name == "Ry" and op.targets[0] >= 6}
    assert len(twins) == 1


def step_tuple(s):
    return (type(s).__name__, dataclasses.astuple(s))


@pytest.mark.parametrize("name", SUPEROP_CASES)
def test_superop_plan_and_operands_match(name):
    jp2, tp2 = both_superop(name)
    jpl = jplan.build_group_plan(jp2)
    tpl = tplan.build_group_plan(tp2)
    assert [step_tuple(s) for s in jpl.steps] == \
        [step_tuple(s) for s in tpl.steps]
    for field in ("dense_real", "cross_real", "diag_real", "prod_real",
                  "bitpair_real", "all_real"):
        assert getattr(jpl, field) == getattr(tpl, field), field
    want = operands_from_numpy(jplan.build_group_operands(
        jp2, jpl, jp2.initial_params, jnp.complex64, xp=np))
    got = tplan.build_group_operands(tp2, tpl, tp2.initial_params)
    for w, g in zip(want[0] + want[1] + want[2], got[0] + got[1] + got[2]):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=1e-6)
    for (wf, wr, wi), (gf, gr, gi) in zip(want[3], got[3]):
        assert (wr, wi) == pytest.approx((gr, gi), abs=1e-6)
        for a, b in zip(wf, gf):
            np.testing.assert_array_equal(a, b)
    for w, g in zip(want[4], got[4]):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g, w, atol=1e-6)


def test_real_channels_keep_vec_rho_real():
    """Ry + CNOT under the reference channel family evolves a real
    vec(rho): the real kernels' variant, half the state."""
    _, tp2 = both_superop("brickwork-6-mixed")
    assert tplan.build_group_plan(tp2).all_real
    _, tp2 = both_superop("complex-gates-mixed")
    assert not tplan.build_group_plan(tp2).all_real
    # a correlated channel inside one axis pair is a GenericStep: planar
    _, tp2 = both_superop("brickwork-8-2q-depol")
    plan = tplan.build_group_plan(tp2)
    kinds = {type(s).__name__ for s in plan.steps}
    assert "GenericStep" in kinds and not plan.all_real


@pytest.mark.parametrize("name", SUPEROP_CASES)
def test_superop_forward_matches_group_forward_fn(name):
    jp2, tp2 = both_superop(name)
    want = np.asarray(jplan.group_forward_fn(jp2)(
        jnp.asarray(jp2.initial_params)))
    got = tplan.group_forward_body(tp2, tp2.initial_params, "cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_group_executor_conjugates_parameterized_twins():
    """The regression of ``tests/test_density.py:207-234``: keying the
    pools by gate name alone evolves vec(rho) under U (x) U (0.34 max
    error for H + Rz)."""
    c = tq.QuantumCircuit(2)
    c.add("H", [0], column=0)
    c.add("H", [1], column=0)
    c.add("Rz", [0], [0.7], column=1)
    c.add("Rx", [1], [0.3], column=1)
    p2 = tdens.superop_program(tprog.compile_circuit(c))
    rho_group = tplan.group_forward_body(
        p2, p2.initial_params, "cpu").reshape(4, 4).numpy()
    dense = tq.DensityMatrixSimulator(device="cpu").run(c, method="dense")
    np.testing.assert_allclose(rho_group, dense.rho, atol=RHO_TOL)
    # and through a parameter batch (the torch builders' pool)
    rows = torch.tensor(np.stack([p2.initial_params,
                                  p2.initial_params * 0.5]),
                        dtype=torch.float32)
    batch = tplan.group_batched_forward(p2, rows, "cpu")
    np.testing.assert_allclose(batch[0].reshape(4, 4).numpy(), dense.rho,
                               atol=RHO_TOL)
    c2 = tq.QuantumCircuit.from_dict(c.to_dict())
    for g in c2.gates:
        g.params = [0.5 * v for v in g.params]
    dense2 = tq.DensityMatrixSimulator(device="cpu").run(c2, method="dense")
    np.testing.assert_allclose(batch[1].reshape(4, 4).numpy(), dense2.rho,
                               atol=RHO_TOL)


# ---------------------------------------------------------------------------
# The 2n >= 30 result, forced at small n
# ---------------------------------------------------------------------------

@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunked(request, monkeypatch):
    """``chunked``: every state counts as big and a chunk is 512
    elements."""
    if request.param:
        monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
        monkeypatch.setattr(tplan, "CHUNK_ELEMS", 512)
    return request.param


@pytest.mark.parametrize("name", ["brickwork-6-mixed", "complex-gates-mixed",
                                  "brickwork-8-2q-depol"])
def test_superop_density_result(name, chunked, monkeypatch, jax_dense):
    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    jc, jnm = CASES[name]()
    tc, tnm = carry(jc, jnm)
    n = tc.num_qubits
    sim = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu")
    res = sim.run(tc, method="superop")
    assert isinstance(res, tdens.SuperopDensityResult)
    assert res.is_planar == (name != "brickwork-6-mixed")
    lead = int(res.is_planar)
    assert tuple(res.state_data.shape[lead:]) == \
        tplan.GroupLayout.for_qubits(2 * n).axis_sizes
    want = jax_dense[name]
    diag = np.real(np.diag(want))
    np.testing.assert_allclose(res.probabilities, np.maximum(diag, 0.0),
                               atol=RHO_TOL)
    assert res.trace() == pytest.approx(1.0, abs=1e-4)
    assert res.purity() == pytest.approx(
        np.real(np.trace(want @ want)), abs=1e-4)
    idx = np.arange(1 << n)
    for q in (0, n - 1):
        sign = 1.0 - 2.0 * ((idx >> (n - 1 - q)) & 1)
        assert res.expectation_z(q) == pytest.approx(
            float(np.sum(diag * sign)), abs=1e-4)
    with pytest.raises(MemoryError, match="dense rho"):
        res.rho
    counts = sim.sample(res, 500, rng=np.random.default_rng(1))
    assert sum(counts.values()) == 500


def test_auto_routes_on_the_large_state_predicate(monkeypatch):
    """``auto`` takes the dense route to n = 14 and the superop route at
    15; the kind of result follows ``bigstate.is_huge(2n)``."""
    calls = []
    sim = tq.DensityMatrixSimulator(device="cpu")
    monkeypatch.setattr(
        sim, "_run_superop", lambda c, dtype=None: calls.append(c) or "sup")
    monkeypatch.setattr(tdens, "_dm_body", lambda *a: calls.append("dm")
                        or torch.zeros(1))
    assert sim.run(tq.QuantumCircuit(15)) == "sup"
    assert isinstance(sim.run(tq.QuantumCircuit(14)),
                      tq.DensityMatrixResult)
    assert calls[1] == "dm"


# ---------------------------------------------------------------------------
# Sampling, carrying a rho across
# ---------------------------------------------------------------------------

def test_sample_with_readout_matches_jax():
    """Same rng, same counts: both multinomials draw from NumPy."""
    jnm = mixed_noise()
    jnm.set_readout_error(jq.ReadoutError(p01=0.02, p10=0.05))
    jc = brickwork_circuit(4, 3, seed=2)
    tc, tnm = carry(jc, jnm)
    jsim = jq.DensityMatrixSimulator(noise_model=jnm)
    tsim = tq.DensityMatrixSimulator(noise_model=tnm, device="cpu")
    jres, tres = jsim.run(jc), tsim.run(tc)
    np.testing.assert_allclose(tres.probabilities, jres.probabilities,
                               atol=RHO_TOL)
    counts = tsim.sample(tres, 4000, np.random.default_rng(0))
    assert sum(counts.values()) == 4000
    want = jsim.sample(jres, 4000, np.random.default_rng(0))
    total = sum(abs(counts.get(k, 0) - want.get(k, 0))
                for k in set(counts) | set(want))
    # float32 probabilities differ in the last digits, so a draw near a
    # bin edge may move: at most a handful of 4000
    assert total <= 8
    clean = tsim.sample(tres, 2000, np.random.default_rng(0),
                        readout_error=tq.ReadoutError(0.0, 0.0))
    assert sum(clean.values()) == 2000


def test_density_result_from_numpy():
    jc, jnm = CASES["brickwork-6-mixed"]()
    rho = jq.DensityMatrixSimulator(noise_model=jnm).run(jc).rho
    res = density_result_from_numpy(rho, device="cpu")
    assert isinstance(res, tq.DensityMatrixResult) and res.num_qubits == 6
    assert res.device_rho.dtype == torch.complex64
    np.testing.assert_allclose(res.rho, rho, atol=1e-7)
    assert res.trace() == pytest.approx(1.0, abs=1e-5)
    with pytest.raises(ValueError):
        density_result_from_numpy(np.zeros((3, 3)), device="cpu")
