"""The port's error mitigation (``mitigation.py``) and classical shadows
(``shadows.py``) against the JAX package's, on the CPU.

Every check of ``tests/test_mitigation.py`` and ``tests/test_shadows.py``
that has a counterpart in the port runs here as a case of a parametrised
test, with the port's objects (its ``DensityMatrixSimulator`` as the
evaluator), and the NumPy-only functions are held to the JAX package's
on the same inputs. Tolerances and why:

* circuit transforms, Richardson weights, quasi-inverses, readout
  inversion, PEC and ``ShadowData`` estimates: equal (the same NumPy code
  on the same inputs), or 1e-12 where the source test states it;
* engine values (folded states, density-matrix expectations, mitigated
  estimates): the source test's tolerance (1e-6 for states and exact PEC,
  as in ``tests/test_mitigation.py``);
* the rotated amplitudes of the shadows' basis layer against JAX's
  per-lane ``apply_gate``: 1e-5, the executor tolerance;
* outcome frequencies against the rotated probabilities: 0.05 over 4000
  snapshots per basis pair (standard error at most 0.008).

The MPS collector's checks are in ``tests/test_torch_mps.py``; here the
engine routing runs it (``engine="mps"``, and ``"auto"`` above 20
qubits).
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import mitigation as jmit
from quantum_simulator_tpu import shadows as jsh
from quantum_simulator_tpu.ops.apply import apply_gate as japply
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import mitigation as tmit
from quantum_simulator_tpu_torch import shadows as tsh
from quantum_simulator_tpu_torch.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu_torch.noise import (
    AmplitudeDampingNoise, BitFlipNoise, DepolarizingNoise, NoiseModel,
    PhaseFlipNoise, ReadoutError, TwoQubitDepolarizingNoise)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rich_circuit() -> QuantumCircuit:
    """Covers every inverse rule: fixed, dagger-swap, param-negate, U3,
    MCZ, multi-qubit."""
    c = QuantumCircuit(num_qubits=3)
    c.add("H", [0])
    c.add("T", [1])
    c.add("S_DAG", [2])
    c.add("Rx", [0], [0.7])
    c.add("U3", [1], [0.3, 1.1, -0.4])
    c.add("CPhase", [0, 2], [math.pi / 5])
    c.add("CNOT", [1, 2])
    c.add("MCZ3", [0, 1, 2])
    c.add("SWAP", [0, 1])
    return c


def _jax(c: QuantumCircuit):
    return jq.QuantumCircuit.from_dict(c.to_dict())


def _state(circuit):
    return tq.Simulator(device="cpu").run(circuit, shots=1).final_state.data


def _dm(noise_model=None):
    return tq.DensityMatrixSimulator(noise_model=noise_model, device="cpu")


def _ez(sim, q):
    return lambda circ: float(sim.run(circ).expectation_z(q))


def _gate_model(gate, channel):
    nm = NoiseModel()
    nm.add_gate_noise(gate, channel)
    return nm


# ---------------------------------------------------------------------------
# Folding
# ---------------------------------------------------------------------------

def _inverse_undoes():
    c = _rich_circuit()
    merged = QuantumCircuit(num_qubits=3)
    off = c.get_column_count()
    for g in c.gates:
        merged.add(g.gate_name, g.target_qubits, g.params, g.column)
    for g in tmit.inverse_circuit(c).gates:
        merged.add(g.gate_name, g.target_qubits, g.params, g.column + off)
    expected = np.zeros(8)
    expected[0] = 1.0
    np.testing.assert_allclose(np.abs(_state(merged)), expected, atol=1e-6)


def _fold_preserves(scale):
    c = _rich_circuit()
    np.testing.assert_allclose(_state(tmit.fold_circuit(c, scale)),
                               _state(c), atol=1e-6)


def _fold_gate_count():
    c = _rich_circuit()
    assert tmit.fold_circuit(c, 5).gate_count() == 5 * c.gate_count()


def _fold_rejects():
    c = _rich_circuit()
    with pytest.raises(ValueError, match="odd"):
        tmit.fold_circuit(c, 2)
    c.add("Measure", [0])
    with pytest.raises(ValueError, match="Measure"):
        tmit.fold_circuit(c, 3)


def _inverse_gate_unknown():
    with pytest.raises(ValueError, match="Measure"):
        tmit.inverse_gate(GateInstance("Measure", [0], [], 0))


def _transforms_equal_jax():
    c = _rich_circuit()
    c.initial_states = [1, 0, 1]
    jc = _jax(c)
    assert tmit.inverse_circuit(c).to_dict() == \
        jmit.inverse_circuit(jc).to_dict()
    for scale in (1, 3, 5):
        assert tmit.fold_circuit(c, scale).to_dict() == \
            jmit.fold_circuit(jc, scale).to_dict()


FOLDING = {"inverse-undoes": _inverse_undoes,
           "fold-preserves-1": lambda: _fold_preserves(1),
           "fold-preserves-3": lambda: _fold_preserves(3),
           "fold-preserves-5": lambda: _fold_preserves(5),
           "fold-gate-count": _fold_gate_count,
           "fold-rejects-even-and-measure": _fold_rejects,
           "inverse-gate-unknown-raises": _inverse_gate_unknown,
           "transforms-equal-jax": _transforms_equal_jax}


@pytest.mark.parametrize("case", sorted(FOLDING))
def test_folding(case):
    FOLDING[case]()


# ---------------------------------------------------------------------------
# Richardson and ZNE
# ---------------------------------------------------------------------------

def _richardson_cases():
    f = lambda s: 2 - 0.3 * s + 0.05 * s * s   # noqa: E731
    est = tmit.richardson_extrapolate([1, 3, 5], [f(s) for s in (1, 3, 5)])
    assert est == pytest.approx(2.0, abs=1e-12)
    assert tmit.richardson_extrapolate([1, 3], [0.9, 0.7]) == \
        pytest.approx(1.0)
    for scales, vals in (([1, 3, 5], [0.9, 0.71, 0.6]), ([1, 2], [3., 1.])):
        assert tmit.richardson_extrapolate(scales, vals) == \
            jmit.richardson_extrapolate(scales, vals)
    with pytest.raises(ValueError, match="distinct"):
        tmit.richardson_extrapolate([1, 1], [0.5, 0.5])
    with pytest.raises(ValueError, match="equal-length"):
        tmit.richardson_extrapolate([1, 2], [0.5])


def _zne_mock_evaluator():
    c = QuantumCircuit(num_qubits=1)
    c.add("X", [0])
    seen = []

    def evaluate(circ):
        seen.append(circ.gate_count())
        return 1.0 - 0.1 * circ.gate_count()

    res = tmit.zne_expectation(evaluate, c, scales=(1, 3, 5))
    assert seen == [1, 3, 5]
    assert isinstance(res, tmit.ZNEResult)
    assert res.value == pytest.approx(1.0)
    assert res.to_dict()["scales"] == [1, 3, 5]


def _zne_dagger_warning(symmetric):
    c = QuantumCircuit(num_qubits=1)
    c.add("S", [0])
    nm = NoiseModel()
    nm.add_gate_noise("S", BitFlipNoise(0.1))
    nm.add_gate_noise("S_DAG", BitFlipNoise(0.1) if symmetric
                      else DepolarizingNoise(0.3))
    if symmetric:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tmit.zne_expectation(lambda circ: 1.0, c, scales=(1, 3),
                                 noise_model=nm)
    else:
        with pytest.warns(UserWarning, match="dagger"):
            tmit.zne_expectation(lambda circ: 1.0, c, scales=(1, 3),
                                 noise_model=nm)


def _zne_beats_raw():
    """Depolarizing noise on a Rabi-style circuit: the extrapolated <Z0>
    lands much closer to the ideal value than the raw one."""
    c = QuantumCircuit(num_qubits=2)
    c.add("Rx", [0], [0.9])
    c.add("CNOT", [0, 1])
    c.add("Rx", [0], [0.4])
    ideal = _ez(_dm(), 0)(c)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.02))
    res = tmit.zne_expectation(_ez(_dm(nm), 0), c, scales=(1, 3, 5))
    raw_err = abs(res.raw_values[0] - ideal)
    assert raw_err > 1e-3
    assert abs(res.value - ideal) < raw_err / 5


def _zne_single_bitflip():
    p = 0.01
    c = QuantumCircuit(num_qubits=1)
    c.add("X", [0])
    nm = NoiseModel()
    nm.add_global_noise(BitFlipNoise(p))
    res = tmit.zne_expectation(_ez(_dm(nm), 0), c, scales=(1, 3))
    assert abs(res.value - (-1.0)) < 8 * p * p


ZNE = {"richardson": _richardson_cases,
       "mock-evaluator-sees-folded-scales": _zne_mock_evaluator,
       "dagger-asymmetry-warns": lambda: _zne_dagger_warning(False),
       "dagger-symmetric-does-not-warn": lambda: _zne_dagger_warning(True),
       "beats-raw-on-exact-density-matrix": _zne_beats_raw,
       "single-bitflip-pair": _zne_single_bitflip}


@pytest.mark.parametrize("case", sorted(ZNE))
def test_zne(case):
    ZNE[case]()


# ---------------------------------------------------------------------------
# Readout mitigation
# ---------------------------------------------------------------------------

def _readout_exact_inversion():
    err = ReadoutError(p01=0.03, p10=0.08)
    c = QuantumCircuit(num_qubits=3)
    c.add("H", [0])
    c.add("CNOT", [0, 1])
    c.add("Ry", [2], [0.8])
    true = tq.Simulator(device="cpu").run(
        c, shots=1).final_state.probabilities
    corrupted = np.asarray(err.apply_to_distribution(true, 3))
    mit = tmit.ReadoutMitigator.from_readout_error(err, 3)
    np.testing.assert_allclose(mit.apply_to_probs(corrupted), true,
                               atol=1e-6)
    jm = jmit.ReadoutMitigator.from_readout_error(
        jq.ReadoutError(0.03, 0.08), 3)
    np.testing.assert_array_equal(mit.apply_to_probs(corrupted),
                                  jm.apply_to_probs(corrupted))


def _readout_counts_and_expectation():
    mit = tmit.ReadoutMitigator.from_readout_error(ReadoutError(0.05, 0.05),
                                                   2)
    counts = {"00": 9025, "01": 475, "10": 475, "11": 25}
    np.testing.assert_allclose(mit.apply_to_counts(counts), [1, 0, 0, 0],
                               atol=1e-6)
    assert mit.expectation_z(counts, 0) == pytest.approx(1.0, abs=1e-6)
    assert mit.expectation_z(counts, 1) == pytest.approx(1.0, abs=1e-6)


def _readout_empirical_calibration():
    rng = np.random.default_rng(11)
    err = ReadoutError(p01=0.04, p10=0.09)
    shots = 200_000
    zeros = err.corrupt_counts({"000": shots}, rng)
    ones = err.corrupt_counts({"111": shots}, rng)
    mit = tmit.ReadoutMitigator.from_calibration_counts(zeros, ones)
    np.testing.assert_allclose(
        mit.confusions,
        tmit.ReadoutMitigator.from_readout_error(err, 3).confusions,
        atol=5e-3)
    jm = jmit.ReadoutMitigator.from_calibration_counts(zeros, ones)
    np.testing.assert_array_equal(mit.confusions, jm.confusions)


def _readout_simplex_projection():
    mit = tmit.ReadoutMitigator.from_readout_error(ReadoutError(0.2, 0.2), 1)
    probs = mit.apply_to_probs(np.array([0.05, 0.95]))
    assert np.all(probs >= 0)
    assert probs.sum() == pytest.approx(1.0)


def _readout_validation():
    with pytest.raises(ValueError, match="shape"):
        tmit.ReadoutMitigator(np.zeros((2, 3, 3)))
    with pytest.raises(ValueError, match="column-stochastic"):
        tmit.ReadoutMitigator(np.full((1, 2, 2), 0.3))
    mit = tmit.ReadoutMitigator.from_readout_error(ReadoutError(0.1, 0.1), 2)
    with pytest.raises(ValueError, match="expected shape"):
        mit.apply_to_probs(np.ones(8) / 8)
    with pytest.raises(ValueError, match="not 2 bits"):
        mit.apply_to_counts({"000": 5})


def _readout_pipeline():
    """Noisy run with readout error, mitigated counts: the TVD to the
    ideal distribution drops."""
    err = ReadoutError(p01=0.06, p10=0.06)
    nm = NoiseModel()
    nm.set_readout_error(err)
    c = QuantumCircuit(num_qubits=2)
    c.add("H", [0])
    c.add("CNOT", [0, 1])
    shots = 40_000
    noisy = tq.Simulator(noise_model=nm, device="cpu").run_with_noise(
        c, shots=shots, seed=5).measurement_counts
    ideal = np.array([0.5, 0.0, 0.0, 0.5])
    raw = np.zeros(4)
    for bits, cnt in noisy.items():
        raw[int(bits, 2)] = cnt / shots
    recovered = tmit.ReadoutMitigator.from_readout_error(
        err, 2).apply_to_counts(noisy)
    tvd = lambda p: 0.5 * np.abs(p - ideal).sum()   # noqa: E731
    assert tvd(raw) > 0.03
    assert tvd(recovered) < tvd(raw) / 3


READOUT = {"exact-inversion": _readout_exact_inversion,
           "counts-and-expectation": _readout_counts_and_expectation,
           "empirical-calibration": _readout_empirical_calibration,
           "simplex-projection": _readout_simplex_projection,
           "validation": _readout_validation,
           "end-to-end-noisy-pipeline": _readout_pipeline}


@pytest.mark.parametrize("case", sorted(READOUT))
def test_readout_mitigation(case):
    READOUT[case]()


# ---------------------------------------------------------------------------
# PEC
# ---------------------------------------------------------------------------

def _pec_closed_forms():
    p = 0.1
    paulis, etas = tmit.quasi_inverse_pauli(BitFlipNoise(p))
    assert paulis == ("I", "X", "Y", "Z")
    pp = -p / (1 - 2 * p)
    np.testing.assert_allclose(etas, [1 - pp, pp, 0, 0], atol=1e-12)
    _, etas_z = tmit.quasi_inverse_pauli(PhaseFlipNoise(p))
    np.testing.assert_allclose(etas_z, [1 - pp, 0, 0, pp], atol=1e-12)
    _, etas_d = tmit.quasi_inverse_pauli(DepolarizingNoise(p))
    lam = 1 - 4 * p / 3
    pd = 0.75 * (1 - 1 / lam)
    np.testing.assert_allclose(etas_d, [1 - pd, pd / 3, pd / 3, pd / 3],
                               atol=1e-12)
    labels, etas2 = tmit.quasi_inverse_pauli(TwoQubitDepolarizingNoise(p))
    assert len(labels) == 16 and labels[0] == "II" and labels[5] == "XX"
    assert etas2.sum() == pytest.approx(1.0) and etas2[1] < 0
    for t_ch, j_ch in ((BitFlipNoise(p), jq.BitFlipNoise(p)),
                       (DepolarizingNoise(p), jq.DepolarizingNoise(p)),
                       (TwoQubitDepolarizingNoise(p),
                        jq.TwoQubitDepolarizingNoise(p))):
        got, want = tmit.quasi_inverse_pauli(t_ch), \
            jmit.quasi_inverse_pauli(j_ch)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="not a Pauli channel"):
        tmit.quasi_inverse_pauli(AmplitudeDampingNoise(0.1))


def _pec_exact_depolarizing():
    c = QuantumCircuit(num_qubits=2)
    c.add("Ry", [0], [0.7])
    c.add("CNOT", [0, 1])
    c.add("Rx", [1], [0.3])
    ideal = _ez(_dm(), 0)(c)
    nm = _gate_model("CNOT", DepolarizingNoise(0.06))
    evaluate = _ez(_dm(nm), 0)
    res = tmit.pec_expectation(evaluate, c, nm, samples=None)
    assert abs(evaluate(c) - ideal) > 1e-3
    assert res.value == pytest.approx(ideal, abs=1e-6)
    assert res.gamma > 1.0 and res.n_locations == 2
    # the JAX package's enumeration on the same evaluator values: a
    # function of each recovery circuit's gates, so equal sums mean the
    # same circuits with the same weights
    jnm = jq.NoiseModel.from_dict(nm.to_dict())
    score = lambda d: sum((i + 1) * len(g["name"]) for i, g in  # noqa: E731
                          enumerate(d["gates"]))
    got = tmit.pec_expectation(lambda circ: score(circ.to_dict()), c, nm)
    want = jmit.pec_expectation(lambda circ: score(circ.to_dict()), _jax(c),
                                jnm)
    assert (got.value, got.gamma, got.n_locations) == \
        (want.value, want.gamma, want.n_locations)


def _pec_two_qubit_channel():
    c = QuantumCircuit(num_qubits=2)
    c.add("H", [0])
    c.add("CNOT", [0, 1])
    ideal = _ez(_dm(), 1)(c)
    nm = _gate_model("CNOT", TwoQubitDepolarizingNoise(0.08))
    res = tmit.pec_expectation(_ez(_dm(nm), 1), c, nm, samples=None)
    assert res.n_locations == 1
    assert res.value == pytest.approx(ideal, abs=1e-6)


def _pec_monte_carlo():
    c = QuantumCircuit(num_qubits=2)
    c.add("Ry", [0], [0.7])
    c.add("CNOT", [0, 1])
    ideal = _ez(_dm(), 0)(c)
    nm = _gate_model("CNOT", DepolarizingNoise(0.04))
    seen = []

    def evaluate(circ):
        seen.append(circ.to_dict())
        return _ez(_dm(nm), 0)(circ)

    res = tmit.pec_expectation(evaluate, c, nm, samples=600, seed=9)
    assert abs(res.value - ideal) < 0.15 and res.samples == 600
    # the same seed splices the same recovery circuits as the JAX package
    jseen = []
    jnm = jq.NoiseModel.from_dict(nm.to_dict())
    jmit.pec_expectation(lambda circ: jseen.append(circ.to_dict()) or 0.0,
                         _jax(c), jnm, samples=600, seed=9)
    assert seen == jseen


def _pec_rejections():
    c = QuantumCircuit(num_qubits=1)
    c.add("X", [0])
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.01))
    with pytest.raises(ValueError, match="gate-specific"):
        tmit.pec_expectation(lambda _c: 0.0, c, nm)
    big = QuantumCircuit(num_qubits=1)
    for _ in range(8):
        big.add("H", [0])
    with pytest.raises(ValueError, match="samples=N"):
        tmit.pec_expectation(lambda _c: 0.0, big,
                             _gate_model("H", DepolarizingNoise(0.01)),
                             max_enumeration=100)
    xnm = _gate_model("X", DepolarizingNoise(0.01))
    with pytest.raises(ValueError, match="recovery"):
        tmit.pec_expectation(lambda _c: 0.0, c, xnm)
    h_only = QuantumCircuit(num_qubits=1)
    h_only.add("H", [0])
    assert tmit.pec_expectation(lambda _c: 0.5, h_only, xnm).n_locations == 0


def _pec_initial_states():
    c = QuantumCircuit(num_qubits=2, initial_states=[1, 0])
    c.add("CNOT", [0, 1])
    ideal = _ez(_dm(), 1)(c)
    assert ideal == pytest.approx(-1.0)
    nm = _gate_model("CNOT", DepolarizingNoise(0.05))
    res = tmit.pec_expectation(_ez(_dm(nm), 1), c, nm, samples=None)
    assert res.value == pytest.approx(ideal, abs=1e-6)


def _pec_passthrough():
    c = QuantumCircuit(num_qubits=1)
    c.add("H", [0])
    nm = _gate_model("CNOT", DepolarizingNoise(0.1))
    res = tmit.pec_expectation(lambda _c: 0.42, c, nm)
    assert res.value == pytest.approx(0.42)
    assert res.gamma == 1.0 and res.n_locations == 0
    assert res.to_dict() == {"value": res.value, "gamma": 1.0,
                             "n_locations": 0, "samples": None}


PEC = {"quasi-inverse-closed-forms": _pec_closed_forms,
       "exact-enumeration-cancels-depolarizing": _pec_exact_depolarizing,
       "exact-enumeration-two-qubit-channel": _pec_two_qubit_channel,
       "monte-carlo-converges": _pec_monte_carlo,
       "rejections": _pec_rejections,
       "preserves-initial-states": _pec_initial_states,
       "no-locations-passthrough": _pec_passthrough}


@pytest.mark.parametrize("case", sorted(PEC))
def test_pec(case):
    PEC[case]()


# ---------------------------------------------------------------------------
# Classical shadows
# ---------------------------------------------------------------------------

def _ghz(n):
    c = QuantumCircuit(n)
    c.add("H", [0], [], 0)
    for q in range(1, n):
        c.add("CNOT", [q - 1, q], [], q)
    return c


def _pauli(p):
    return {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
            "Y": np.array([[0, -1j], [1j, 0]]),
            "Z": np.diag([1.0, -1.0])}[p].astype(np.complex128)


def _sv(v):
    sv = tq.StateVector(int(np.log2(len(v))), device="cpu")
    sv.data = np.asarray(v, np.complex128)
    return sv


def _shadow_unbiased():
    """E[est(P)] over all basis draws and outcomes is <P> exactly."""
    rng = np.random.default_rng(3)
    psi = rng.normal(size=4) + 1j * rng.normal(size=4)
    psi /= np.linalg.norm(psi)
    for pstr in ("XI", "IY", "ZZ", "XY", "YZ", "ZX", "YY"):
        exact = np.vdot(psi, np.kron(_pauli(pstr[0]),
                                     _pauli(pstr[1])) @ psi).real
        total = 0.0
        for b0 in range(3):
            for b1 in range(3):
                u = np.kron(tsh._ROTATIONS[b0], tsh._ROTATIONS[b1])
                probs = np.abs(u @ psi) ** 2
                for outcome in range(4):
                    data = tsh.ShadowData(
                        num_qubits=2, bases=np.array([[b0, b1]], np.int8),
                        outcomes=np.array([[(outcome >> 1) & 1,
                                            outcome & 1]], np.int8))
                    total += probs[outcome] * data.estimate_pauli(
                        pstr, [0, 1]) / 9.0
        assert total == pytest.approx(exact, abs=1e-10)
    np.testing.assert_array_equal(tsh._ROTATIONS, jsh._ROTATIONS)


def _shadow_z_eigenstate():
    data = tq.collect_shadows(_sv([0, 1, 0, 0]), 600, seed=0)
    assert np.all(data.outcomes[data.bases[:, 0] == 2, 0] == 0)
    assert np.all(data.outcomes[data.bases[:, 1] == 2, 1] == 1)


def _shadow_x_eigenstate():
    data = tq.collect_shadows(_sv(np.array([1, 1]) / np.sqrt(2)), 600, seed=1)
    xmask = data.bases[:, 0] == 0
    assert xmask.sum() > 100
    assert np.all(data.outcomes[xmask, 0] == 0)


def _shadow_bases_uniform():
    data = tq.collect_shadows(_ghz(3), 3000, seed=2, device="cpu")
    counts = np.bincount(data.bases.reshape(-1), minlength=3)
    assert counts.min() > 0.28 * counts.sum()


def _shadow_bell_correlators():
    data = tq.collect_shadows(_ghz(2), 6000, seed=4, chunk=2048,
                              device="cpu")
    for pstr, qs, want in (("ZZ", [0, 1], 1.0), ("XX", [0, 1], 1.0),
                           ("YY", [0, 1], -1.0), ("Z", [0], 0.0)):
        assert data.estimate_pauli(pstr, qs) == pytest.approx(want, abs=0.15)


def _shadow_hamiltonian():
    terms = [(0.5, "ZZ", [0, 1]), (-0.3, "XX", [0, 1]), (0.2, "Z", [0])]
    data = tq.collect_shadows(_ghz(2), 8000, seed=5, chunk=2048,
                              device="cpu")
    assert data.estimate_hamiltonian(terms) == pytest.approx(0.2, abs=0.12)


def _shadow_median_of_means():
    data = tq.collect_shadows(_ghz(2), 4000, seed=6, chunk=2048,
                              device="cpu")
    assert data.estimate_pauli("ZZ", [0, 1], median_of_means=10) == \
        pytest.approx(1.0, abs=0.3)
    with pytest.raises(ValueError):
        data.estimate_pauli("ZZ", [0, 1], median_of_means=0)


def _shadow_identity_and_validation():
    data = tq.collect_shadows(_ghz(2), 100, seed=7, device="cpu")
    assert data.estimate_pauli("II", [0, 1]) == pytest.approx(1.0)
    for pstr, qs in (("XYZ", [0, 1]), ("XX", [0, 0]), ("Q", [0]),
                     ("X", [5])):
        with pytest.raises(ValueError):
            data.estimate_pauli(pstr, qs)


def _shadow_engine_routing():
    with pytest.raises(ValueError):
        tq.collect_shadows(_ghz(2), 10, engine="nope", device="cpu")
    with pytest.raises(ValueError):
        tq.collect_shadows(_ghz(tsh.MAX_STATEVECTOR_SHADOW_QUBITS + 1), 10,
                           engine="statevector", device="cpu")
    with pytest.raises(ValueError):
        tq.collect_shadows(tq.StateVector(1, device="cpu"), 10, engine="mps")
    with pytest.raises(ValueError, match="n_snapshots"):
        tq.collect_shadows(_ghz(2), 0, device="cpu")
    for kw in ({"engine": "mps"}, {"engine": "auto"}):
        n = 2 if kw["engine"] == "mps" else 21
        data = tq.collect_shadows(_ghz(n), 10, device="cpu", **kw)
        assert data.outcomes.shape == (10, n)


def _shadow_pool_equals_jax():
    """The same seed draws the JAX package's bases, and the same pool
    gives JAX's estimates exactly."""
    c = _ghz(4)
    got = tq.collect_shadows(c, 500, seed=11, chunk=128, device="cpu")
    want = jsh.collect_shadows(_jax(c), 500, seed=11, chunk=128)
    np.testing.assert_array_equal(got.bases, want.bases)
    jdata = jsh.ShadowData(4, got.bases, got.outcomes)
    for pstr, qs in (("ZZ", [0, 3]), ("XXXX", [0, 1, 2, 3]), ("YI", [1, 2]),
                     ("Z", [2])):
        assert got.estimate_pauli(pstr, qs) == jdata.estimate_pauli(pstr, qs)
        assert got.estimate_pauli(pstr, qs, median_of_means=5) == \
            jdata.estimate_pauli(pstr, qs, median_of_means=5)
    terms = [(0.5, "ZZ", [0, 1]), (-0.3, "XX", [2, 3])]
    assert got.estimate_hamiltonian(terms) == \
        jdata.estimate_hamiltonian(terms)


SHADOWS = {"estimator-unbiased-exact-enumeration-n2": _shadow_unbiased,
           "z-eigenstate-bits": _shadow_z_eigenstate,
           "x-eigenstate-bits": _shadow_x_eigenstate,
           "basis-draws-uniform": _shadow_bases_uniform,
           "bell-correlators": _shadow_bell_correlators,
           "hamiltonian-estimate": _shadow_hamiltonian,
           "median-of-means": _shadow_median_of_means,
           "identity-and-validation": _shadow_identity_and_validation,
           "engine-routing": _shadow_engine_routing,
           "pool-equals-jax": _shadow_pool_equals_jax}


@pytest.mark.parametrize("case", sorted(SHADOWS))
def test_shadows(case):
    SHADOWS[case]()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_rotated_amplitudes_match_jax_lanes(n):
    """The basis layer as one batched program against JAX's per-lane loop
    of ``apply_gate`` (``shadows.py:136-140``), on the same bases."""
    rng = np.random.default_rng(n)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    bases = rng.integers(0, 3, size=(6, n)).astype(np.int8)
    x = tsh.rotate_snapshots(torch.from_numpy(psi), n, bases)
    got = torch.complex(x[:, 0], x[:, 1]).reshape(6, -1).numpy()
    for b, row in enumerate(bases):
        want = jnp.asarray(psi)
        for q in range(n):
            want = japply(want, jnp.asarray(jsh._ROTATIONS[row[q]]), (q,), n)
        np.testing.assert_allclose(got[b], np.asarray(want), atol=1e-5)


def test_outcomes_follow_the_rotated_probabilities():
    """Each basis pair's outcome frequencies over 4000 snapshots against
    the probabilities of the state rotated into it."""
    psi = np.array([0.6, 0.3j, -0.5, 0.2 + 0.5j], np.complex128)
    psi /= np.linalg.norm(psi)
    gen = torch.Generator().manual_seed(0)
    for b0 in range(3):
        for b1 in range(3):
            bases = np.tile(np.array([[b0, b1]], np.int8), (4000, 1))
            x = tsh.rotate_snapshots(torch.from_numpy(
                psi.astype(np.complex64)), 2, bases)
            bits = tsh.sample_rotated(x, 2, gen)
            freq = np.bincount(bits[:, 0] * 2 + bits[:, 1], minlength=4) \
                / 4000
            u = np.kron(tsh._ROTATIONS[b0], tsh._ROTATIONS[b1])
            np.testing.assert_allclose(freq, np.abs(u @ psi) ** 2,
                                       atol=0.05)
