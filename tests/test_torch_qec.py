"""The port's statevector and Pauli-frame QEC engines (``qec.py``,
``qec_frame.py``) against the JAX package's, on the CPU.

JAX's draws are computed with its key schedule and fed to the port: per
trial ``uniform(key, (dq,))``; per round r of a memory experiment
``uniform(fold_in(fold_in(k, r), 1), (dq,))`` for the data and
``fold_in(fold_in(k, r), 2)`` (then ``fold_in(., 0 | 1)`` per sector in
``build_memory_fn``) for the readout. Tolerances and why:

* per-trial flags, syndromes, corrections, masks, failures, LUTs, check
  matrices and decode tables: equal (integer algebra on the same bits);
* statevector fidelities, <Z_L> and states: 1e-5 (complex64 sums in
  another order);
* ML posteriors (float32): at the sizes here (d = 5, R = 3; surface d = 3,
  R = 2) the two candidates' masses are within 1e-5 of the larger one
  against a float64 forward pass, and decisions equal JAX's wherever
  ``|a0 - a1| > 1e-5 * max(a0, a1)``. The float32 error grows with d and R
  (against float64, of the larger mass: 1.0e-4 at d = 7, R = 4 and
  3.9e-4 at d = 9, R = 9, p = q = 0.05, in the tail; median ~1e-7), in
  JAX's algorithm as in the port's, so a near-tie may go either way.

Under one seed the port's two engines draw the same rows, so their
per-trial flags are identical (``test_engines_agree_under_one_seed``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulator_tpu import qec as jq
from quantum_simulator_tpu import qec_frame as jf
from quantum_simulator_tpu_torch import qec as tq
from quantum_simulator_tpu_torch import qec_frame as tf
from quantum_simulator_tpu_torch.parallel import make_mesh
from tests import torch_jax_draws as nd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CODES = list(jq.AVAILABLE_CODES)
T = 128


def _keys(seed, n):
    """``split(PRNGKey(seed), n)`` as NumPy (torch_jax_draws)."""
    return nd.split(nd.key(seed), n)


def _trial_draws(keys, dq):
    return nd.uniform(np.asarray(keys), dq)


def _round_draws(keys, R, dq, meas, per_sector=False):
    """JAX's memory draws: (T, R, dq) data and, per readout width in
    ``meas``, (T, R, w) (``per_sector``: ``fold_in(meas_key, i)``)."""
    data, reads = [], [[] for _ in meas]
    for r in range(R):
        rk = nd.fold_in(keys, r)
        data.append(nd.uniform(nd.fold_in(rk, 1), dq))
        mk = nd.fold_in(rk, 2)
        for i, w in enumerate(meas):
            reads[i].append(nd.uniform(nd.fold_in(mk, i) if per_sector
                                       else mk, w))
    return [torch.from_numpy(np.stack(a, axis=1)) for a in [data] + reads]


def _t(a):
    return torch.from_numpy(np.array(a))


# --- statevector engine -----------------------------------------------------

@pytest.mark.parametrize("name", CODES)
def test_encoded_states_and_tables_match_jax(name):
    jcode, tcode = jq.AVAILABLE_CODES[name](), tq.AVAILABLE_CODES[name]()
    for b in (0, 1):
        np.testing.assert_allclose(tcode.encode(b, "cpu").data,
                                   jcode.encode(b).data, atol=1e-6)
    assert tcode.comp_frame_checks() == jcode.comp_frame_checks()
    assert tcode.h_frame_checks() == jcode.h_frame_checks()
    n_syn = len(jcode.comp_frame_checks()) + len(jcode.h_frame_checks())
    syn = np.array([[(s >> i) & 1 for i in range(n_syn)]
                    for s in range(2 ** n_syn)], np.int32)
    for row in syn:
        assert tcode.decode_syndrome(list(row)) == \
            jcode.decode_syndrome(list(row))
    # The batched masks equal the masks of JAX's host decode table (which
    # its traced decode_masks implements).
    nc = len(jcode.comp_frame_checks())
    n = jcode.total_qubits
    want = np.zeros((2, len(syn)), np.int64)
    for i, row in enumerate(syn):
        for gate, q in jcode.decode_syndrome(list(row)):
            want["XZ".index(gate), i] |= 1 << (n - 1 - q)
    tx, tz = tcode.decode_masks(_t(syn[:, :nc]), _t(syn[:, nc:]), n)
    assert np.array_equal(tx.numpy(), want[0])
    assert np.array_equal(tz.numpy(), want[1])


def test_surface_geometry_and_luts_match_jax():
    for d in (3, 5, 7):
        assert tq._rotated_surface_geometry(d) == \
            jq._rotated_surface_geometry(d)
    z, x, _, _ = jq._rotated_surface_geometry(5)
    for checks in (z, x):
        mat = jf._checks_matrix(checks, 25)
        assert np.array_equal(tq._coset_leader_lut(mat),
                              jq._coset_leader_lut(mat))


@pytest.mark.parametrize("name,noise", [
    ("Bit-Flip [3,1,1]", "depolarizing"),
    ("Phase-Flip [3,1,1]", "phase_flip"), ("Steane [[7,1,3]]", "depolarizing"),
    ("Surface [[9,1,3]]", "depolarizing")])
def test_cycles_match_jax_under_jax_draws(name, noise):
    jcode, tcode = jq.AVAILABLE_CODES[name](), tq.AVAILABLE_CODES[name]()
    keys = _keys(1, T)
    u = _trial_draws(keys, jcode.data_qubits)
    i0, i1 = jcode.encode(0).device_data, jcode.encode(1).device_data
    ideals = jnp.where((jnp.arange(T) % 2 == 0)[:, None], i0[None], i1[None])
    want = jq.build_cycle_fn(jcode, noise)(jnp.float32(0.3), ideals,
                                          jnp.asarray(keys))
    sim = tq.QECSimulator(tcode, device="cpu")
    got = sim.cycles(noise, 0.3, sim._ideals(T), _t(u))
    for k, (a, b) in enumerate(zip(want, got)):
        a = np.broadcast_to(np.asarray(a), b.shape)
        if k < 3:
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5)
        else:
            assert np.array_equal(b.numpy(), a.astype(b.numpy().dtype))


def test_run_cycle_sweep_and_projection_match_jax():
    jsim = jq.QECSimulator(jq.PhaseFlipCode())
    tsim = tq.QECSimulator(tq.PhaseFlipCode(), "cpu")
    want = jsim.run_cycle(1, "phase_flip", 0.4, seed=3)
    u = nd.uniform(nd.key_from_seed(
        np.random.default_rng(3).integers(0, 2**63)), 3)
    got = tsim.run_cycle(1, "phase_flip", 0.4, uniforms=_t(u))
    assert got.syndrome == want.syndrome
    assert got.correction_applied == want.correction_applied
    assert got.logical_error_detected == want.logical_error_detected
    for f in ("fidelity_before", "fidelity_after", "logical_z_expectation"):
        assert abs(getattr(got, f) - getattr(want, f)) < 1e-5
    for f in ("encoded_state", "noisy_state", "corrected_state"):
        np.testing.assert_allclose(getattr(got, f).data,
                                   getattr(want, f).data, atol=1e-5)
    probs = [0.05, 0.3]
    want = jsim.threshold_sweep(probs, 100, "phase_flip", seed=4)
    rng = np.random.default_rng(4)
    draws = []
    for _ in probs:
        keys = np.stack([nd.key(s) for s in rng.integers(0, 2**63, 100)])
        draws.append(_t(_trial_draws(keys, 3)))
    got = tsim.threshold_sweep(probs, 100, "phase_flip", uniforms=draws)
    for a, b in zip(want, got):
        for f in ("physical_rate", "logical_rate", "success_rate",
                  "decoder_success_rate"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("avg_fidelity", "logical_z_fidelity",
                  "projection_logical_rate"):
            assert abs(getattr(a, f) - getattr(b, f)) < 1e-5
    want = jsim.projection_logical_error(1, "phase_flip", 0.2, 100, seed=5)
    keys = np.stack([nd.key(s) for s in
                     np.random.default_rng(5).integers(0, 2**63, 100)])
    got = tsim.projection_logical_error(1, "phase_flip", 0.2, 100,
                                        uniforms=_trial_draws(keys, 3))
    assert got["z_sign_error_rate"] == want["z_sign_error_rate"]
    assert abs(got["mean_fidelity"] - want["mean_fidelity"]) < 1e-5


# --- frame engine -----------------------------------------------------------

SPECS = {
    "steane": lambda m: m.frame_spec_from_code(
        (jq if m is jf else tq).SteaneCode()),
    "rep7_phase": lambda m: m.repetition_frame_spec(7, "phase_flip"),
    "surface5": lambda m: m.surface_code_frame_spec(5),
    "surface5_uf": lambda m: m.surface_code_frame_spec(5, "union_find"),
}


@pytest.fixture(scope="module")
def specs():
    return {k: (f(jf), f(tf)) for k, f in SPECS.items()}


def _host_tables(name, js):
    """JAX's decode tables from its host code: the code's
    ``decode_syndrome`` (from_code specs), the coset-leader LUTs, the
    union-find host decoder, the repetition prefix rule."""
    nc, nh = js.comp_checks.shape[0], js.h_checks.shape[0]
    if nc + nh <= 8:        # every syndrome
        syn = ((np.arange(2 ** (nc + nh))[:, None] >> np.arange(nc + nh))
               & 1).astype(np.int32)
    else:
        syn = np.random.default_rng(0).integers(
            0, 2, (256, nc + nh)).astype(np.int32)
    if name == "steane":
        code = jq.SteaneCode()
        cx = np.zeros((len(syn), js.data_qubits), np.int32)
        cz = np.zeros_like(cx)
        for i, row in enumerate(syn):
            for gate, q in code.decode_syndrome(list(row)):
                (cx if gate == "X" else cz)[i, q] = 1
        return syn, cx, cz
    if name == "rep7_phase":
        e0 = np.concatenate([np.zeros((len(syn), 1), np.int32),
                             np.cumsum(syn, 1) & 1], 1)
        ez = np.where(2 * e0.sum(1, keepdims=True) > 7, 1 - e0, e0)
        return syn, np.zeros_like(ez), ez
    if name == "surface5":
        pw_c, pw_h = 1 << np.arange(nc), 1 << np.arange(nh)
        return (syn, jq._coset_leader_lut(js.comp_checks)[syn[:, :nc] @ pw_c],
                jq._coset_leader_lut(js.h_checks)[syn[:, nc:] @ pw_h])
    from quantum_simulator_tpu.qec_matching import union_find_host_decode_fn
    cx, cz = union_find_host_decode_fn(js.comp_checks, js.h_checks)(
        syn[:, :nc], syn[:, nc:])
    return syn, cx, cz


@pytest.mark.parametrize("name", list(SPECS))
def test_frame_specs_and_decoders_match_jax(specs, name):
    js, ts = specs[name]
    assert ts.name == js.name and ts.data_qubits == js.data_qubits
    for f in ("comp_checks", "h_checks", "logical_support"):
        assert np.array_equal(getattr(ts, f), getattr(js, f))
    assert ts.logical_in_h_frame == js.logical_in_h_frame
    syn, cx, cz = _host_tables(name, js)
    nc = js.comp_checks.shape[0]
    gx, gz = ts.decode(_t(syn[:, :nc]), _t(syn[:, nc:]))
    assert np.array_equal(gx.numpy(), cx) and np.array_equal(gz.numpy(), cz)


@pytest.mark.parametrize("name", list(SPECS))
def test_frame_sweeps_match_jax_under_jax_draws(specs, name):
    js, ts = specs[name]
    noise = "phase_flip" if name == "rep7_phase" else "depolarizing"
    keys = _keys(2, T)
    u = _t(_trial_draws(keys, js.data_qubits))
    want = jf.build_frame_sweep_fn(js, noise)(jnp.float32(0.15),
                                              jnp.asarray(keys))
    got = tf.build_frame_sweep_fn(ts, noise, "cpu")(0.15, u)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    if ts.host_decode is not None:
        host = tf.build_frame_sweep_host_fn(ts, noise, "cpu")(0.15, u)
        for a, b in zip(got, host):
            assert np.array_equal(a.numpy(), b)
    sim = tf.FrameQECSimulator(ts, "cpu")
    raw = sim.sweep_raw(0.15, T, noise, uniforms=u)
    assert all(torch.equal(a, b) for a, b in zip(raw, got))


@pytest.mark.parametrize("name", ["surface5_uf"])
def test_memory_experiment_matches_jax(specs, name):
    js, ts = specs[name]
    R, q = 3, 0.05
    keys = _keys(7, T)
    nc, nh = js.comp_checks.shape[0], js.h_checks.shape[0]
    want = jf.build_memory_fn(js, "depolarizing", R, q)(jnp.float32(0.04),
                                                        jnp.asarray(keys))
    u = _round_draws(keys, R, js.data_qubits, (nc, nh), per_sector=True)
    got = tf.build_memory_fn(ts, "depolarizing", R, q, "cpu")(0.04, *u)
    assert np.array_equal(np.asarray(want), got.numpy())
    rep = tf.FrameQECSimulator(ts, "cpu").memory_experiment(
        0.04, R, T, "depolarizing", q, uniforms=u)
    assert rep["logical_failure_probability"] == float(
        np.asarray(want, np.float64).mean())


def _forward64(syndromes, par, pop, p, q, d):
    """Float64 plain version of the WHT forward pass: (T, 2^d)."""
    Tn, R = syndromes.shape[:2]
    alpha = np.zeros((Tn, 2 ** d))
    alpha[:, 0] = 1.0
    had = np.array([[1.0]])
    for _ in range(d):
        had = np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]), had)
    decay = (1 - 2 * p) ** pop
    w = q / (1 - q)
    for r in range(R):
        alpha = (alpha @ had * decay) @ had / 2 ** d
        s = syndromes[:, r].astype(np.float64)
        n_mis = s.sum(1)[:, None] + par.sum(1)[None] - 2 * s @ par.T
        alpha = alpha * w ** n_mis
        alpha /= alpha.sum(1, keepdims=True)
    return alpha


def _check_masses(masses, ref, decisions_port, decisions_jax):
    a0, a1 = (m.numpy().astype(np.float64) for m in masses)
    top = np.maximum(a0, a1)
    assert np.all(np.abs(a0 - ref[0]) <= 1e-5 * top)
    assert np.all(np.abs(a1 - ref[1]) <= 1e-5 * top)
    clear = np.abs(a0 - a1) > 1e-5 * top
    assert clear.mean() > 0.9
    assert np.array_equal(decisions_port[clear], decisions_jax[clear])


def test_ml_repetition_memory_matches_jax():
    d, R, p, q = 5, 3, 0.1, 0.1
    keys = _keys(0, T)
    want = jf.build_ml_memory_fn(d, R, True)(jnp.float32(p), jnp.float32(q),
                                             jnp.asarray(keys))
    u = _round_draws(keys, R, d, (d - 1,))
    got = tf.build_ml_memory_fn(d, R, True, True)(p, q, *u)
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    assert np.array_equal(np.asarray(want[3]), got[3].numpy())
    idx = np.arange(2 ** d)
    bits = (idx[:, None] >> np.arange(d)) & 1
    par = (bits[:, :-1] ^ bits[:, 1:]).astype(np.float64)
    alpha = _forward64(got[2].transpose(0, 1).numpy(), par, bits.sum(1),
                       p, q, d)
    X = got[3].numpy()
    e0 = np.concatenate([np.zeros((T, 1), int),
                         np.cumsum(X[:, :-1] ^ X[:, 1:], 1) & 1], 1)
    pw = 2 ** np.arange(d)
    ref = (alpha[np.arange(T), e0 @ pw], alpha[np.arange(T), (1 - e0) @ pw])
    _check_masses(got[4:], ref, got[0].numpy(), np.asarray(want[0]))
    rep = tf.FrameQECSimulator.ml_memory_experiment(d, p, R, T, q,
                                                    device="cpu", uniforms=u)
    assert rep["final_syndrome_failure_probability"] == float(
        np.asarray(want[1], np.float64).mean())


def test_ml_surface_and_matching_memory_match_jax():
    checks, support = tf._surface_sector(3)
    R, p, q = 2, 0.08, 0.05
    keys = _keys(1, T)
    want = jf.build_ml_css_memory_fn(checks, support, R, True)(
        jnp.float32(p), jnp.float32(q), jnp.asarray(keys))
    u = _round_draws(keys, R, 9, (4,))
    got = tf.build_ml_css_memory_fn(checks, support, R, True, True)(p, q, *u)
    for k in (1, 2, 3):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy())
    # Float64 plain posterior: the forward pass over all 2^dq errors, then
    # each class's mass summed over every error with the final syndrome
    # (no coset-leader table and no null space).
    dq = checks.shape[1]
    idx = np.arange(2 ** dq)
    bits = (idx[:, None] >> np.arange(dq)) & 1
    syn_of = (bits @ checks.T.astype(np.int64)) % 2
    alpha = _forward64(got[2].transpose(0, 1).numpy(),
                       syn_of.astype(np.float64), bits.sum(1), p, q, dq)
    X = got[3].numpy().astype(np.int64)
    same = np.all(((X @ checks.T) % 2)[:, None] == syn_of[None], axis=2)
    cls = (bits @ support.astype(np.int64)) % 2
    ref = ((alpha * same * (cls == 0)).sum(1),
           (alpha * same * (cls == 1)).sum(1))
    _check_masses(got[4:], ref, got[0].numpy(), np.asarray(want[0]))
    jm = jf.build_matching_memory_fn(checks, support, R)(p, q,
                                                         jnp.asarray(keys))
    tm = tf.build_matching_memory_fn(checks, support, R)(p, q, *u)
    for a, b in zip(jm, tm):
        assert np.array_equal(np.asarray(a), b)
    rep = tf.FrameQECSimulator.matching_memory_experiment(
        p, R, T, q, 3, device="cpu", uniforms=u)
    assert rep["matching_failure_probability"] == float(
        np.asarray(jm[0], np.float64).mean())


def test_engines_agree_under_one_seed():
    for code in (tq.SteaneCode(), tq.RotatedSurfaceCode()):
        sv = tq.QECSimulator(code, "cpu")
        fr = tf.FrameQECSimulator.from_code(code, "cpu")
        u = tq.trial_uniforms(np.random.default_rng(9), 200,
                              code.data_qubits, "cpu")
        fb, fa, z, *_ = sv.cycles("depolarizing", 0.1, sv._ideals(200), u)
        ob, oa, flip = fr.sweep_raw(0.1, 200, "depolarizing", seed=9)
        signs = torch.where(torch.arange(200) % 2 == 0, 1.0, -1.0)
        assert torch.equal((fb > 0.5).int(), ob)
        assert torch.equal((fa > 0.5).int(), oa)
        assert torch.equal((z * signs < 0).int(), flip)
        a = sv.threshold_sweep([0.05, 0.1], 200, "depolarizing", seed=9)
        b = fr.threshold_sweep([0.05, 0.1], 200, "depolarizing", seed=9)
        assert [x.success_rate for x in a] == [x.success_rate for x in b]
        assert [x.decoder_success_rate for x in a] == \
            [x.decoder_success_rate for x in b]


def test_throughput_and_mesh():
    fr = tf.FrameQECSimulator(tf.repetition_frame_spec(9), "cpu")
    rate, succ = fr.throughput_sweep(0.02, 5000, seed=1)
    assert rate == 1.0 - succ / 5000 and rate < 0.01
    # mesh= runs the same trials over a shard mesh: the same result
    mesh = make_mesh(4, device="cpu")
    assert fr.throughput_sweep(0.02, 5000, seed=1, mesh=mesh) == (rate,
                                                                   succ)
    with pytest.raises(TypeError, match="ShardMesh"):
        fr.sweep_raw(0.1, 10, mesh=object())
    with pytest.raises(TypeError, match="ShardMesh"):
        tf.FrameQECSimulator.ml_memory_experiment(5, 0.1, 2, 10,
                                                  mesh=object())
