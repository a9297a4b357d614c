"""The port's large-state module (``ops/bigstate.py``) vs the JAX package's,
on the CPU at n = 10-16.

The n >= 30 code paths have nothing that depends on the size but their
chunk counts, so they are driven here directly (``_run_huge``,
``huge_step_marginals_fn``, ``sample_state_indices``) as the JAX package's
own tests drive them (``tests/test_bigstate.py``), once whole and once
with the chunk size and the in-place threshold forced down
(``chunked``), so every chunked pass runs over several pieces.
Tolerances and why:

* grouped state, marginals, expectations: 1e-5, the executor tolerance
  (float32 sums in another order); Pauli strings 2e-5, the bound of
  ``tests/test_bigstate.py``;
* the two-level sampler against the exact distribution: total variation
  distance < 0.08 at 40000 shots over 1024 outcomes (one sample's
  expected distance is at most 0.5 * sum_k sqrt(2 p_k / (pi N)) = 0.064),
  the bound of ``test_simulator_huge_path``; 0.03 on the six-outcome
  boundary state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.algorithms import AlgorithmTemplate
from quantum_simulator_tpu.measurement import MeasurementBasis as JBasis
from quantum_simulator_tpu.measurement import rotate_to_basis
from quantum_simulator_tpu.models import brickwork_circuit
from quantum_simulator_tpu.ops import bigstate as jbig
from quantum_simulator_tpu.ops import program as jprog
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch.ops import bigstate as tbig
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog


@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunked(request, monkeypatch):
    """``chunked``: every state counts as big and a chunk is 512
    elements."""
    if request.param:
        monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
        monkeypatch.setattr(tplan, "CHUNK_ELEMS", 512)
    return request.param


def with_t(circuit, qubits):
    col = max(g.column for g in circuit.gates) + 1
    for q in qubits:
        circuit.add_gate(jq.GateInstance("T", [q], [], column=col))
    return circuit


def toffoli_three_groups():
    c = jq.QuantumCircuit(16)
    c.add_gate(jq.GateInstance("H", [1], [], column=0))
    c.add_gate(jq.GateInstance("H", [5], [], column=0))
    c.add_gate(jq.GateInstance("Toffoli", [1, 5, 12], [], column=1))
    return c


def mcz_all_axes(add_t):
    c = jq.QuantumCircuit(15)
    for q in range(15):
        c.add_gate(jq.GateInstance("H", [q], [], column=0))
    if add_t:
        c.add_gate(jq.GateInstance("T", [3], [], column=1))
    c.add_gate(jq.GateInstance("MCZ3", [0, 7, 14], [], column=2))
    for q in range(15):
        c.add_gate(jq.GateInstance("Ry", [q], [0.07 * q + 0.2], column=3))
    return c


CIRCUITS = {
    "brickwork-real": lambda: brickwork_circuit(10, 4, seed=9),
    "brickwork-planar": lambda: with_t(brickwork_circuit(10, 4, seed=9),
                                       range(10)),
    "qft-12": lambda: AlgorithmTemplate.quantum_fourier_transform(12),
    "toffoli-three-groups": toffoli_three_groups,
    "mcz-all-axes-real": lambda: mcz_all_axes(False),
    "mcz-all-axes-planar": lambda: mcz_all_axes(True),
}


def port(jc) -> tq.QuantumCircuit:
    return tq.QuantumCircuit.from_dict(jc.to_dict())


def jax_dense(jc) -> np.ndarray:
    p = jprog.compile_circuit(jc)
    return np.asarray(jprog.forward_fn(p)(jnp.asarray(p.initial_params)))


def flat(x, planar) -> np.ndarray:
    a = np.asarray(x)
    return (a[0] + 1j * a[1]).reshape(-1) if planar else a.reshape(-1)


def port_state(jc):
    tp = tprog.compile_circuit(port(jc))
    return tplan.group_forward_state_body(tp, tp.initial_params, "cpu")


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_grouped_state_and_marginals_match_jax(name, chunked):
    """``group_forward_state_body`` and ``state_axis_marginals`` against
    ``huge_forward_fn`` (state and marginals) and the dense forward."""
    jc = CIRCUITS[name]()
    jp = jprog.compile_circuit(jc)
    fn, jplanar = jbig.huge_forward_fn(jp)
    jx, jmarg = fn(jnp.asarray(jp.initial_params))
    x, planar = port_state(jc)
    assert planar == jplanar
    assert tuple(x.shape) == tuple(np.asarray(jx).shape)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(flat(x, planar), jax_dense(jc), atol=1e-5)
    marg = tbig.state_axis_marginals(x, planar)
    assert len(marg) == len(jmarg)
    for got, want in zip(marg, jmarg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_planar_helpers(chunked):
    x, planar = port_state(CIRCUITS["brickwork-planar"]())
    assert planar
    want = np.abs(flat(x, True)) ** 2
    probs = tbig.planar_probabilities(x)
    assert probs.shape == (1 << 10,)
    np.testing.assert_allclose(probs.numpy(), want, atol=1e-7)
    norm = tbig.planar_norm_sq(x)
    assert norm.dtype == torch.float64
    np.testing.assert_allclose(float(norm), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(norm), want.sum(), atol=1e-6)


def dense_pauli(psi: np.ndarray, qubits, paulis: str, n: int) -> float:
    """<psi| prod_i P_i |psi> by index arithmetic on the dense vector."""
    j = np.arange(1 << n)
    phi = psi.astype(np.complex128)
    for q, p in zip(qubits, paulis):
        bit = (j >> (n - 1 - q)) & 1
        if p == "Z":
            phi = phi * (1 - 2 * bit)
        else:
            flipped = phi[j ^ (1 << (n - 1 - q))]
            # X|b> = |1-b>; Y|b> = i (-1)^b |1-b>, so the new amplitude at
            # an index with bit b' = 1 - b carries i (-1)^(1 - b')
            phi = flipped if p == "X" else 1j * (2 * bit - 1) * flipped
    return float(np.real(np.vdot(psi, phi)))


@pytest.mark.parametrize("name", ["brickwork-real", "brickwork-planar"])
def test_state_vector_queries_match_jax_and_dense(name, chunked):
    jc = CIRCUITS[name]()
    jp = jprog.compile_circuit(jc)
    fn, jplanar = jbig.huge_forward_fn(jp)
    jx, jmarg = fn(jnp.asarray(jp.initial_params))
    jsv = jbig.PlanarStateVector(jx, 10, planar=jplanar,
                                 axis_marginals=jmarg)
    x, planar = port_state(jc)
    sv = tq.PlanarStateVector(x, 10, planar=planar,
                              axis_marginals=tbig.state_axis_marginals(
                                  x, planar))
    lazy = tq.PlanarStateVector(x, 10, planar=planar)
    dense = jax_dense(jc)
    probs = np.abs(dense) ** 2
    idx = np.arange(1 << 10)
    want = np.array([probs[((idx >> (9 - q)) & 1) == 1].sum()
                     for q in range(10)])
    assert sv.num_qubits == 10 and sv.is_planar == planar
    assert sv.state_data is x
    for s in (sv, lazy):
        np.testing.assert_allclose(s.qubit_probabilities(), want, atol=1e-5)
        np.testing.assert_allclose(s.qubit_probabilities(),
                                   jsv.qubit_probabilities(), atol=1e-5)
    np.testing.assert_allclose(sv.norm_sq(), 1.0, atol=1e-5)
    np.testing.assert_allclose(sv.expectation_z(3), 1 - 2 * want[3],
                               atol=1e-5)
    # Z strings inside one group ([4, 7]) and across groups
    for qs in ([4, 7], [0, 9], [0, 2, 9]):
        par = np.ones(1 << 10)
        for q in qs:
            par *= 1 - 2 * ((idx >> (9 - q)) & 1)
        got = sv.expectation_z_string(qs)
        np.testing.assert_allclose(got, (probs * par).sum(), atol=1e-5,
                                   err_msg=str(qs))
        np.testing.assert_allclose(got, jsv.expectation_z_string(qs),
                                   atol=1e-5)
    for i in (0, 5, 1023):
        np.testing.assert_allclose(sv.amplitude(i), dense[i], atol=1e-5)
        np.testing.assert_allclose(sv.amplitude(i), jsv.amplitude(i),
                                   atol=1e-5)
    np.testing.assert_allclose(sv.probabilities_device.numpy(), probs,
                               atol=1e-6)
    pl = sv.planar_data
    assert pl.shape[0] == 2
    np.testing.assert_allclose(flat(pl, True), dense, atol=1e-5)
    with pytest.raises(MemoryError):
        sv.data
    with pytest.raises(ValueError):
        sv.expectation_z_string([0, 10])
    assert sv.expectation_z_string([]) == 1.0


PAULI_STRINGS = [
    ([3], "X"), ([4], "Y"), ([0, 9], "XZ"), ([0, 9], "YY"), ([2, 5], "XY"),
    ([0, 4, 9], "XYZ"), ([1, 2, 8], "YYX"), ([0, 3, 6, 9], "XZXY"),
    ([5], "Z"), ([0, 5, 9], "ZZZ"),
    # X or Y bits on every axis: no axis is left to cut the state along
    ([1, 8], "XX"), ([2, 9], "YZ"),
]


@pytest.mark.parametrize("name", ["brickwork-real", "brickwork-planar"])
def test_pauli_strings_match_jax_and_dense(name, chunked):
    jc = CIRCUITS[name]()
    jp = jprog.compile_circuit(jc)
    fn, jplanar = jbig.huge_forward_fn(jp)
    jx, jmarg = fn(jnp.asarray(jp.initial_params))
    jsv = jbig.PlanarStateVector(jx, 10, planar=jplanar,
                                 axis_marginals=jmarg)
    x, planar = port_state(jc)
    sv = tq.PlanarStateVector(x, 10, planar=planar)
    dense = jax_dense(jc)
    for qs, ps in PAULI_STRINGS:
        got = sv.expectation_pauli_string(qs, ps)
        want = dense_pauli(dense, qs, ps, 10)
        if not planar and ps.count("Y") % 2 == 1:
            assert got == 0.0 and abs(want) < 1e-5, (qs, ps, want)
            continue
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   err_msg=f"{qs} {ps}")
        np.testing.assert_allclose(
            got, jsv.expectation_pauli_string(qs, ps), atol=2e-5,
            err_msg=f"{qs} {ps}")


def test_pauli_string_validation():
    x, planar = port_state(CIRCUITS["brickwork-real"]())
    sv = tq.PlanarStateVector(x, 10, planar=planar)
    assert sv.expectation_pauli_string([], "") == 1.0
    assert sv.expectation_pauli_string([0, 9], "ZZ") == pytest.approx(
        sv.expectation_z_string([0, 9]), abs=1e-7)
    # StateAnalysis hands a planar state's strings to the state itself
    assert tq.StateAnalysis.pauli_string_expectation(sv, [0, 4], "XY") == \
        sv.expectation_pauli_string([0, 4], "XY")
    assert tq.StateAnalysis.hamiltonian_expectation(
        sv, [(0.5, [0, 9], "ZZ"), (2.0, [3], "X")]) == pytest.approx(
        0.5 * sv.expectation_z_string([0, 9])
        + 2.0 * sv.expectation_pauli_string([3], "X"), abs=1e-6)
    for qs, ps in (([0, 1], "X"), ([0, 0], "XX"), ([0], "Q"), ([77], "X")):
        with pytest.raises(ValueError):
            sv.expectation_pauli_string(qs, ps)


def tvd_to(idx: np.ndarray, probs: np.ndarray) -> float:
    emp = np.bincount(idx, minlength=probs.size) / idx.size
    return 0.5 * float(np.abs(emp - probs / probs.sum()).sum())


@pytest.mark.parametrize("batch", [2048, 1500])
@pytest.mark.parametrize("name", ["brickwork-real", "brickwork-planar",
                                  "mcz-all-axes-planar"])
def test_two_level_sampler_matches_distribution(name, batch, chunked,
                                                monkeypatch):
    """40000 draws (8000 at n = 15) against the exact distribution; a
    batch of 1500 draws leaves a ragged last batch."""
    monkeypatch.setattr(tbig, "SAMPLE_BATCH", batch)
    x, planar = port_state(CIRCUITS[name]())
    n = int(np.log2(x.numel() // (2 if planar else 1)))
    shots = 40000 if n == 10 else 8000
    gen = torch.Generator().manual_seed(5)
    idx = tbig.sample_state_indices(x, shots, planar, gen)
    assert idx.dtype == torch.int64 and idx.shape == (shots,)
    assert int(idx.min()) >= 0 and int(idx.max()) < 1 << n
    probs = np.abs(flat(x, planar)) ** 2
    if n == 10:
        assert tvd_to(idx.numpy(), probs) < 0.08
    else:   # 2^15 outcomes, 2^14-wide tiles: the leading 6 bits' marginal
        lead = probs.reshape(1 << 6, -1).sum(1)
        assert tvd_to(idx.numpy() >> (n - 6), lead) < 0.08
    if planar:
        gen = torch.Generator().manual_seed(5)
        again = tbig.sample_planar_indices(x, shots, gen)
        assert torch.equal(idx, again)


@pytest.mark.parametrize("shape", [(4, 8), (2, 4, 8), (2, 2, 4, 8)])
@pytest.mark.parametrize("planar", [False, True])
def test_sample_chunking_boundaries(shape, planar, chunked, monkeypatch):
    """All the mass on the first and last index of tiles and chunks
    (``tests/test_bigstate.py`` ``test_sample_chunking_boundaries``): an
    off-by-one in the block offsets or the in-tile search would put draws
    on a neighbour, which has probability zero."""
    if chunked:
        monkeypatch.setattr(tplan, "CHUNK_ELEMS", 16)
    total = int(np.prod(shape))
    tile = shape[-1] if len(shape) < 3 else shape[-1] * shape[-2]
    boundary = sorted({0, tile - 1, tile, 2 * tile - 1, total - tile,
                       total - 1})
    amps = np.zeros(total, np.float32)
    amps[boundary] = 1.0 / np.sqrt(len(boundary))
    x = torch.from_numpy(amps.reshape(shape))
    if planar:      # the weight sits in the imaginary plane
        x = torch.stack([torch.zeros_like(x), x])
    shots = 30000
    idx = tbig.sample_state_indices(x, shots, planar,
                                    torch.Generator().manual_seed(0)).numpy()
    assert set(np.unique(idx)) == set(boundary)
    assert tvd_to(idx, amps ** 2) < 0.03


def test_indices_to_counts():
    idx = torch.tensor([5, 5, 0, 2 ** 33 + 1, 5], dtype=torch.long)
    counts = tbig.indices_to_counts(idx, 34)
    assert counts == {format(0, "034b"): 1, format(5, "034b"): 3,
                      format(2 ** 33 + 1, "034b"): 1}


@pytest.mark.parametrize("add_t", [False, True], ids=["real", "planar"])
def test_step_marginals_match_jax_column_by_column(add_t, chunked):
    jc = brickwork_circuit(10, 4, seed=9)
    if add_t:
        with_t(jc, [2])
    jp = jprog.compile_circuit(jc)
    jparams = jnp.asarray(jp.initial_params)
    jfn, jcols = jbig.huge_step_marginals_fn(jp)
    jouts = jfn(jparams)
    dense = np.asarray(jprog.steps_fn(jp)(jparams))
    tp = tprog.compile_circuit(port(jc))
    fn, ncols = tbig.huge_step_marginals_fn(tp, "cpu")
    outs = fn(tp.initial_params)
    assert ncols == jcols and len(outs) == ncols + 1 == dense.shape[0]
    idx = np.arange(1 << 10)
    for i, (marg, jmarg) in enumerate(zip(outs, jouts)):
        for got, want in zip(marg, jmarg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, err_msg=f"column {i}")
        probs = np.abs(dense[i]) ** 2
        want = [probs[((idx >> (9 - q)) & 1) == 1].sum() for q in range(10)]
        np.testing.assert_allclose(
            tbig.qubit_probs_from_marginals(marg, 10), want, atol=1e-5,
            err_msg=f"column {i}")
    s = tq.MarginalStateSummary(outs[-1], 10)
    assert s.num_qubits == 10 and s.axis_marginals is outs[-1]
    np.testing.assert_allclose(
        s.qubit_probabilities(),
        tbig.qubit_probs_from_marginals(outs[-1], 10))
    np.testing.assert_allclose(s.expectation_z(4),
                               1 - 2 * s.qubit_probabilities()[4])
    with pytest.raises(MemoryError):
        s.data


def test_step_marginals_repeat_over_an_empty_column():
    c = tq.QuantumCircuit(9)
    c.add("H", [0], [], 0)
    c.add("Measure", [0], [], 1)     # a column with no op
    c.add("CNOT", [0, 8], [], 2)
    tp = tprog.compile_circuit(c)
    fn, ncols = tbig.huge_step_marginals_fn(tp, "cpu")
    outs = fn(tp.initial_params)
    assert ncols == 3 and len(outs) == 4
    assert outs[2] is outs[1]
    np.testing.assert_allclose(
        tbig.qubit_probs_from_marginals(outs[3], 9),
        [0.5] + [0.0] * 7 + [0.5], atol=1e-6)


BASES = {"Z": (tq.MeasurementBasis.Z, JBasis.Z, 40000),
         "X": (tq.MeasurementBasis.X, JBasis.X, 40000),
         "Y": (tq.MeasurementBasis.Y, JBasis.Y, 60000)}


@pytest.mark.parametrize("basis", sorted(BASES))
def test_run_huge_matches_jax(basis, chunked):
    """``Simulator._run_huge`` of both packages on one circuit: the same
    kind of result, the same final state, and counts that follow the
    JAX state's distribution in that basis."""
    tbasis, jbasis, shots = BASES[basis]
    jc = brickwork_circuit(10, 4, seed=9)
    jp = jprog.compile_circuit(jc)
    jres = jq.Simulator()._run_huge(jc, jp, 100, False, 3,
                                    np.random.default_rng(3), jbasis)
    res = tq.Simulator(device="cpu")._run_huge(
        port(jc), shots, False, 3, np.random.default_rng(3), tbasis)
    fs, jfs = res.final_state, jres.final_state
    assert isinstance(fs, tq.PlanarStateVector)
    assert isinstance(jfs, jbig.PlanarStateVector)
    assert fs.is_planar == jfs.is_planar is False   # the final state is real
    np.testing.assert_allclose(fs.state_data.numpy(),
                               np.asarray(jfs.state_data), atol=1e-5)
    np.testing.assert_allclose(fs.qubit_probabilities(),
                               jfs.qubit_probabilities(), atol=1e-5)
    assert res.step_states is None and res.num_shots == shots
    assert sum(res.measurement_counts.values()) == shots
    assert sum(jres.measurement_counts.values()) == 100
    ref = jq.Simulator().run(jc, shots=0).final_state
    rot = ref if basis == "Z" else rotate_to_basis(ref, jbasis)
    probs = np.abs(np.asarray(rot.device_data)) ** 2
    emp = np.zeros(1 << 10)
    for b, k in res.measurement_counts.items():
        emp[int(b, 2)] = k / shots
    assert 0.5 * np.abs(emp - probs / probs.sum()).sum() < 0.08


def test_run_huge_planar_circuit_and_readout():
    jc = with_t(brickwork_circuit(10, 3, seed=2), range(10))
    nm = tq.NoiseModel()
    nm.set_readout_error(tq.ReadoutError(0.5, 0.5))
    sim = tq.Simulator(noise_model=nm, device="cpu")
    res = sim._run_huge(port(jc), 2000, False, 1, np.random.default_rng(1),
                        tq.MeasurementBasis.Z)
    assert res.final_state.is_planar
    np.testing.assert_allclose(flat(res.final_state.state_data, True),
                               jax_dense(jc), atol=1e-5)
    assert sum(res.measurement_counts.values()) == 2000
    # a coin flip per bit: the counts spread far beyond the state's support
    zero = tq.Simulator(device="cpu")._run_huge(
        port(jc), 0, False, 1, np.random.default_rng(1),
        tq.MeasurementBasis.Z)
    assert zero.measurement_counts == {}


def test_run_huge_rejects_record_steps():
    jc = brickwork_circuit(10, 2, seed=1)
    with pytest.raises(ValueError, match="record_steps"):
        tq.Simulator(device="cpu")._run_huge(
            port(jc), 10, True, 0, np.random.default_rng(0),
            tq.MeasurementBasis.Z)
    with pytest.raises(ValueError, match="record_steps"):
        jq.Simulator()._run_huge(jc, jprog.compile_circuit(jc), 10, True, 0,
                                 np.random.default_rng(0), JBasis.Z)


@pytest.mark.parametrize("kind", ["vqe-real", "qaoa-planar"])
def test_variational_costs_take_planar_states(kind, monkeypatch):
    """From the huge threshold on a gradient re-simulates row by row and
    its cost reads a ``PlanarStateVector``; lowered to n = 10 it must
    give the batched executor's gradient."""
    from quantum_simulator_tpu_torch import models
    from quantum_simulator_tpu_torch import optimizer as topt

    if kind == "vqe-real":
        circuit = models.hardware_efficient_ansatz(10, 1)
        cost = topt.CostFunction.vqe_hamiltonian(models.heisenberg_chain(10))
    else:
        edges = models.maxcut_edges_ring(10)
        circuit = models.qaoa_maxcut_ansatz(10, 1, edges)
        cost = topt.CostFunction.qaoa_maxcut(edges)
    cfg = topt.ParameterizedCircuitConfig.auto_detect(circuit)
    values = np.random.default_rng(0).uniform(-3, 3, cfg.num_params)
    want = topt.GradientEstimator.parameter_shift(cfg, cost, values,
                                                  device="cpu")
    monkeypatch.setattr(topt, "HUGE_QUBITS", 10)
    monkeypatch.setattr(tbig, "HUGE_MIN_QUBITS", 10)
    state = tq.Simulator(device="cpu").run(cfg.bind_values(values),
                                           shots=0).final_state
    assert isinstance(state, tq.PlanarStateVector)
    got = topt.GradientEstimator.parameter_shift(cfg, cost, values,
                                                 device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
