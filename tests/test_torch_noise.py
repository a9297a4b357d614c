"""The port's noise module, readout error and sampling vs the JAX package's.

Both run on the CPU in one process. Tolerances and why:

* Kraus stacks are built from the same float64 formulas: equal to 1e-12.
* Shot-mode readout corruption draws from a NumPy generator in both
  packages, with the same calls in the same order: the counts are equal.
* The distribution transform is the same float64 contraction on the host
  (1e-12); the torch path runs in float32 on its device (1e-6).
* Counts sampled after a run: the two packages' probabilities differ in
  the last float32 bits, which can shift NumPy's binomial draws, so counts
  over 4096 shots agree to a total variation distance of 0.04, well above
  sampling noise for 8 outcomes and well below the effect of the readout
  error tested (each p of 0.1-0.2 moves about 0.15-0.35 of the mass).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu.ops import bigtraj as jbigtraj
from quantum_simulator_tpu.ops import program as jprog
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import measurement as tmeas
from quantum_simulator_tpu_torch.ops import bigtraj as tbigtraj
from quantum_simulator_tpu_torch.ops import program as tprog

CHANNELS = {
    "bit-flip": lambda m: m.BitFlipNoise(0.12),
    "phase-flip": lambda m: m.PhaseFlipNoise(0.3),
    "depolarizing": lambda m: m.DepolarizingNoise(0.07),
    "two-qubit-depolarizing": lambda m: m.TwoQubitDepolarizingNoise(0.2),
    "amplitude-damping": lambda m: m.AmplitudeDampingNoise(0.25),
    "thermal-relaxation": lambda m: m.ThermalRelaxationNoise(50.0, 70.0,
                                                             10.0),
}


def tvd(a: dict, b: dict, shots: int) -> float:
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0) - b.get(k, 0)) for k in keys) / shots


def _jax_model():
    nm = jq.NoiseModel()
    nm.add_global_noise(jq.DepolarizingNoise(0.05))
    nm.add_global_noise(jq.ThermalRelaxationNoise(40.0, 60.0, 5.0))
    nm.add_gate_noise("CNOT", jq.TwoQubitDepolarizingNoise(0.1))
    nm.add_gate_noise("H", jq.AmplitudeDampingNoise(0.2))
    nm.add_gate_noise("H", jq.BitFlipNoise(0.01))
    nm.add_gate_noise("Ry", jq.PhaseFlipNoise(0.02))
    nm.set_readout_error(jq.ReadoutError(0.03, 0.07))
    return nm


@pytest.mark.parametrize("name", sorted(CHANNELS))
def test_kraus_stacks_match_jax(name):
    want = CHANNELS[name](jq)
    got = CHANNELS[name](tq)
    np.testing.assert_allclose(got.kraus_stack(), want.kraus_stack(),
                               atol=1e-12)
    assert got.spec_key() == want.spec_key()
    assert got.probability == pytest.approx(want.probability, abs=1e-15)
    st = got.kraus_stack()
    np.testing.assert_allclose(
        np.einsum("mji,mjk->ik", st.conj(), st), np.eye(st.shape[1]),
        atol=1e-12)


def test_noise_model_round_trips_a_jax_model():
    jnm = _jax_model()
    tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    assert tnm.to_dict() == jnm.to_dict()
    assert tnm.spec_key() == jnm.spec_key()
    assert tnm.has_channels() and tnm.has_noise()
    for gate in ("H", "CNOT", "Ry", "X"):
        w = jnm.kraus_stacks_for_gate(gate)
        g = tnm.kraus_stacks_for_gate(gate)
        assert len(w) == len(g)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-12)
    assert tq.NoiseModel.from_dict(tnm.to_dict()).to_dict() == tnm.to_dict()


def test_channel_arguments_are_checked():
    with pytest.raises(ValueError):
        tq.DepolarizingNoise(1.5)
    with pytest.raises(ValueError):
        tq.ThermalRelaxationNoise(10.0, 30.0, 1.0)   # T2 > 2 T1
    with pytest.raises(ValueError):
        tq.ReadoutError(p01=-0.1)


@pytest.mark.parametrize("seed", [0, 7])
def test_corrupt_counts_matches_jax(seed):
    counts = {"000": 300, "101": 150, "111": 40, "010": 10}
    want = jq.ReadoutError(0.1, 0.2).corrupt_counts(
        counts, np.random.default_rng(seed))
    got = tq.ReadoutError(0.1, 0.2).corrupt_counts(
        counts, np.random.default_rng(seed))
    assert got == want
    assert sum(got.values()) == 500
    assert tq.ReadoutError(0.1, 0.2).corrupt_counts(
        {}, np.random.default_rng(seed)) == {}


def test_apply_to_bitstring_matches_jax():
    want = [jq.ReadoutError(0.3, 0.4).apply_to_bitstring(
        "0110100111", np.random.default_rng(s)) for s in range(5)]
    got = [tq.ReadoutError(0.3, 0.4).apply_to_bitstring(
        "0110100111", np.random.default_rng(s)) for s in range(5)]
    assert got == want


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_apply_to_distribution_matches_jax(kind):
    n = 5
    p = np.random.default_rng(3).random(1 << n)
    p /= p.sum()
    want = jq.ReadoutError(0.05, 0.15).apply_to_distribution(p, n)
    err = tq.ReadoutError(0.05, 0.15)
    if kind == "numpy":
        got = err.apply_to_distribution(p, n)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-12)
    else:
        got = err.apply_to_distribution(
            torch.tensor(p, dtype=torch.float32), n)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _ghz3(mod):
    c = mod.QuantumCircuit(3)
    c.add_gate(mod.GateInstance("H", [0], [], column=0))
    c.add_gate(mod.GateInstance("CNOT", [0, 1], [], column=1))
    c.add_gate(mod.GateInstance("CNOT", [1, 2], [], column=2))
    return c


@pytest.mark.parametrize("mode", ["shot", "distribution"])
def test_sample_with_basis_readout_matches_jax(mode):
    jres = jq.Simulator().run(_ghz3(jq), shots=0)
    tres = tq.Simulator(device="cpu").run(_ghz3(tq), shots=0)
    shots = 4096
    want = jq.MeasurementEngine.sample_with_basis(
        jres.final_state, shots, readout_error=jq.ReadoutError(0.1, 0.2),
        readout_mode=mode, rng=np.random.default_rng(5))
    got = tq.MeasurementEngine.sample_with_basis(
        tres.final_state, shots, readout_error=tq.ReadoutError(0.1, 0.2),
        readout_mode=mode, rng=np.random.default_rng(5))
    assert sum(got.values()) == shots
    assert tvd(got, want, shots) <= 0.04
    # the readout error moved mass off the two GHZ outcomes
    assert got.get("000", 0) + got.get("111", 0) < 0.8 * shots


def test_readout_applied_on_run():
    jnm = jq.NoiseModel()
    jnm.set_readout_error(jq.ReadoutError(0.15, 0.1))
    tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    want = jq.Simulator(noise_model=jnm).run(_ghz3(jq), shots=4096,
                                             seed=9).measurement_counts
    got = tq.Simulator(noise_model=tnm, device="cpu").run(
        _ghz3(tq), shots=4096, seed=9).measurement_counts
    ideal = tq.Simulator(device="cpu").run(_ghz3(tq), shots=4096,
                                           seed=9).measurement_counts
    assert set(ideal) == {"000", "111"}
    assert len(got) > 2 and sum(got.values()) == 4096
    assert tvd(got, want, 4096) <= 0.04


def test_from_initial_states_matches_jax():
    init = [1, 0, 1, 1]
    want = jq.StateVector.from_initial_states(init)
    got = tq.StateVector.from_initial_states(init, device="cpu")
    np.testing.assert_allclose(got.data, want.data, atol=0)
    assert got.device_data.dtype == torch.complex64


def test_phase_real_stacks_and_trajectory_realness_match_jax():
    for name, mk in CHANNELS.items():
        if name == "two-qubit-depolarizing":
            continue
        w = jbigtraj.phase_real_stack(mk(jq).kraus_stack())
        g = tbigtraj.phase_real_stack(mk(tq).kraus_stack())
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g, w, atol=0)
    from bench import build_circuit_dict

    for mix in (False, True):
        d = build_circuit_dict(6, 4, 3, mix)
        jp = jprog.compile_circuit(jq.QuantumCircuit.from_dict(d))
        tp = tprog.compile_circuit(tq.QuantumCircuit.from_dict(d))
        for name, mk in CHANNELS.items():
            jnm = jq.NoiseModel()
            jnm.add_global_noise(mk(jq))
            tnm = tq.NoiseModel.from_dict(jnm.to_dict())
            assert (tbigtraj.trajectory_is_real(tp, tnm)
                    == jbigtraj.trajectory_is_real(jp, jnm)), (mix, name)


def test_interactive_apply_matches_jax():
    """``NoiseModel.apply``: every Kraus branch evaluated, one draw from
    the model's NumPy generator; same seed, same branches."""
    amp = np.random.default_rng(4).standard_normal(8).astype(np.complex64)
    amp /= np.linalg.norm(amp)
    jsv = jq.StateVector.from_device_array(jax.numpy.asarray(amp), 3)
    tsv = tq.StateVector.from_numpy(amp, device="cpu")
    jnm, tnm = jq.NoiseModel(), tq.NoiseModel()
    for nm, mod in ((jnm, jq), (tnm, tq)):
        nm.add_global_noise(mod.AmplitudeDampingNoise(0.4))
        nm.add_global_noise(mod.DepolarizingNoise(0.3))
        nm.set_seed(12)
    for targets in ([0], [1, 2], [2]):
        jnm.apply(jsv, jq.GateInstance("H", targets, [], column=0))
        tnm.apply(tsv, tq.GateInstance("H", targets, [], column=0))
    np.testing.assert_allclose(tsv.data, jsv.data, atol=1e-6)


def test_sample_rows_draws_each_row_from_its_distribution():
    probs = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.5, 0.0, 0.0, 0.5]])
    idx = tmeas.sample_rows(probs, 2000, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 2000)
    assert bool((idx[0] == 1).all())
    assert set(idx[1].tolist()) == {0, 3}
    assert abs(float((idx[1] == 0).float().mean()) - 0.5) < 0.05
