"""The port's MPS engine (``mps.py``), its variational path and the MPS
shadows collector against the JAX package's, on the CPU.

The ideal references are JAX's jitted entry points. The stochastic ones
are the per-shot, per-trajectory and per-row bodies JAX's entry points
``vmap`` (``_evolve``, ``_sample_one_shot``, the snapshot and cost
bodies), jitted and ``vmap``ped here with their draws read from tables
(``tests/torch_jax_draws.py``: ``jax_keyed_table``,
``jax_chained_table``) filled with JAX's own draws, recomputed bit for
bit by its NumPy replica (the replica is held to ``jax.random``
itself); the port is fed the same tables: the cascade's per-site
uniforms and every Kraus / projector draw's Gumbel row. The sizes are
small (n <= 5, chi <= 8) to keep the three MPS-family files within 45 s
in one process. Tolerances:

* states (``to_statevector``, amplitudes): 2e-5, ``tests/test_mps.py``'s
  ATOL; observables, energies and ``|overlap|``: 1e-5; truncation
  weights: 1e-6 (complex64 factorisations in another LAPACK);
* sampled bits, Kraus branches and monitored outcomes: identical under
  JAX's draws, except that a row may part at a draw whose margin (the
  gap of the two largest ``log w + g``, or ``|u - P(0)|``) is under
  1e-5; such draws must be under 1 % of all (``assert_draw_exact``);
* the JAX tests' laws (TVD 0.06, Born statistics, GHZ correlations,
  the statevector gradient 1e-4) on the port alone.

Compare only gauge-invariant quantities: the two packages' QR and SVD may
pick other phases for the same factors. At chi = 2 and 4 the truncated runs
cut at non-degenerate Schmidt values (random angles), so the kept state
is defined and compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
from quantum_simulator_tpu import mps as jm
from quantum_simulator_tpu import optimizer as jopt
from quantum_simulator_tpu import shadows as jsh
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch import mps as tm
from quantum_simulator_tpu_torch import optimizer as topt
from quantum_simulator_tpu_torch import shadows as tsh
from quantum_simulator_tpu_torch.interop import mps_state_from_numpy
from quantum_simulator_tpu_torch.models import hamiltonians as th
from tests import torch_jax_draws as D

CPU = "cpu"
ATOL = 2e-5
OBS_TOL = 1e-5
TRUNC_TOL = 1e-6
N = 5


def _pair(d):
    return jq.QuantumCircuit.from_dict(d), tq.QuantumCircuit.from_dict(d)


def _random_dict(n, depth, seed, any_pair=True, initial=None):
    """tests/test_mps.py's random circuit, plus a Toffoli, a Fredkin, a
    CPhase and an MCZ3 on scattered targets."""
    rng = np.random.default_rng(seed)
    gates, col = [], 0
    oneq = ["H", "T", "S", "X", "Y", "Z", "S_DAG", "T_DAG"]
    for _ in range(depth):
        for q in range(n):
            kind = rng.integers(0, 3)
            if kind == 0:
                gates.append({"name": str(rng.choice(oneq)), "targets": [q],
                              "params": [], "column": col})
            elif kind == 1:
                gates.append({"name": str(rng.choice(["Rx", "Ry", "Rz"])),
                              "targets": [q], "column": col,
                              "params": [float(rng.uniform(0, 2 * np.pi))]})
        col += 1
        perm = rng.permutation(n)
        for i in range(0, n - 1, 2):
            a, b = int(perm[i]), int(perm[i + 1])
            if not any_pair:
                a, b = min(a, b), min(a, b) + 1
                if b >= n:
                    continue
            gates.append({"name": str(rng.choice(["CNOT", "CZ", "SWAP"])),
                          "targets": [a, b], "params": [], "column": col})
            col += 1
    for name, tg, p in (("Toffoli", [4, 0, 2], []), ("Fredkin", [1, 4, 0], []),
                        ("CPhase", [3, 1], [0.9]), ("MCZ3", [0, 3, 2], [])):
        gates.append({"name": name, "targets": tg, "params": p,
                      "column": col})
        col += 1
    d = {"version": "1.0", "num_qubits": n, "gates": gates}
    if initial is not None:
        d["initial_states"] = initial
    return d


def _brick_dict(n, depth, seed, measure=False):
    """Ry/Rz + CNOT brickwork; ``measure`` adds a Measure on every
    fourth qubit after every second layer (and one repeated at once)."""
    rng = np.random.default_rng(seed)
    gates, col = [], 0
    for layer in range(depth):
        for q in range(n):
            gates.append({"name": "Ry" if (q + layer) % 2 else "Rz",
                          "targets": [q], "column": col,
                          "params": [float(rng.uniform(0, 2 * np.pi))]})
        col += 1
        for q in range(layer % 2, n - 1, 2):
            gates.append({"name": "CNOT", "targets": [q, q + 1],
                          "params": [], "column": col})
        col += 1
        if measure and layer % 2:
            for q in range(layer % 4, n, 4):
                gates.append({"name": "Measure", "targets": [q],
                              "params": [], "column": col})
            col += 1
    if measure:
        gates.append({"name": "Measure", "targets": [1], "params": [],
                      "column": col})
        gates.append({"name": "Measure", "targets": [1], "params": [],
                      "column": col + 1})
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def _carry(js):
    return mps_state_from_numpy([np.asarray(t) for t in js.tensors],
                                js.num_qubits, js.chi, js.truncation_weight,
                                device=CPU)


def _fidelity(js, ts):
    """|<jax|port>| over the carried JAX state."""
    return abs(tm.overlap(_carry(js), ts))


# --- the ideal core -----------------------------------------------------------

IDEAL = {"random-chi8": (_random_dict(N, 2, 1, initial=[1, 0, 1, 1, 0]), 8),
         "random-chi2": (_random_dict(N, 3, 2), 2)}
BITS = ("00000", "10110", "11111")
STRINGS = ("XIYZZ", {1: "Y", 3: "X"})
BONDS = (1, 2)


@pytest.fixture(scope="module")
def ideal():
    """JAX's final state and observables per case (its jitted entry
    points), and the port's state."""
    out = {}
    terms = (th.tfim_chain(N, j=-1.0, h=-0.7)
             + th.heisenberg_chain(N, jx=0.5, jy=-0.3, jz=1.1)
             + [(0.25, "I", [0])])
    for name, (d, chi) in IDEAL.items():
        jc, tc = _pair(d)
        _, js = jm.MPSSimulator(chi=chi).run(jc, shots=0)
        ref = {"sv": jm.to_statevector(js)}
        if name == "random-chi8":     # one bond profile: one compile each
            ref.update(amp=[jm.amplitude(js, b) for b in BITS],
                       pauli=[jm.expectation_pauli_string(js, s)
                              for s in STRINGS],
                       ham=jm.expectation_hamiltonian(js, terms),
                       ent=[jm.entanglement_entropy(js, b) for b in BONDS])
        _, ts = tm.MPSSimulator(chi=chi, device=CPU).run(tc, shots=0)
        out[name] = (js, ts, ref, terms)
    return out


def _observables(st, terms):
    return {"sv": tm.to_statevector(st),
            "amp": [tm.amplitude(st, b) for b in BITS],
            "pauli": [tm.expectation_pauli_string(st, s) for s in STRINGS],
            "ham": tm.expectation_hamiltonian(st, terms),
            "ent": [tm.entanglement_entropy(st, b) for b in BONDS]}


@pytest.mark.parametrize("case", list(IDEAL))
@pytest.mark.parametrize("which", ["evolved", "carried"])
def test_state_and_observables_match_jax(ideal, case, which):
    """The port's evolution ("evolved": its own state) and its
    observables on JAX's state ("carried") against JAX's."""
    js, ts, ref, terms = ideal[case]
    st = ts if which == "evolved" else _carry(js)
    got = _observables(st, terms)
    assert st.truncation_weight == pytest.approx(js.truncation_weight,
                                                 abs=TRUNC_TOL)
    np.testing.assert_allclose(got["sv"], ref["sv"], atol=ATOL)
    if "amp" in ref:
        np.testing.assert_allclose(got["amp"], ref["amp"], atol=ATOL)
        np.testing.assert_allclose(got["pauli"], ref["pauli"],
                                   atol=OBS_TOL)
        np.testing.assert_allclose(got["ent"], ref["ent"], atol=OBS_TOL)
        assert got["ham"] == pytest.approx(ref["ham"], abs=OBS_TOL)
    if which == "evolved":
        assert _fidelity(js, ts) == pytest.approx(1.0, abs=OBS_TOL)


def test_truncation_is_reported(ideal):
    assert ideal["random-chi2"][0].truncation_weight > 1e-4
    assert ideal["random-chi8"][1].truncation_weight < 1e-9


def test_overlap_between_two_states_matches_jax(ideal):
    a, b = ideal["random-chi8"], ideal["random-chi2"]
    want = abs(jm.overlap(a[0], b[0]))
    assert abs(tm.overlap(a[1], b[1])) == pytest.approx(want, abs=OBS_TOL)
    assert abs(tm.overlap(_carry(a[0]), _carry(b[0]))) == pytest.approx(
        want, abs=OBS_TOL)


# --- sampling -----------------------------------------------------------------

ZERO_KEY = jnp.zeros(2, jnp.uint32)


def _cascade_body(stack, u):
    """JAX's ``_sample_one_shot`` reading site i's uniform from ``u[i]``."""
    with D.jax_chained_table(u):
        return jm._sample_one_shot(stack, ZERO_KEY)


_JAX_CASCADE = jax.jit(jax.vmap(_cascade_body, in_axes=(None, 0)))


def _jax_sample(js, uniforms, basis="Z"):
    """JAX's ``MPSSimulator.run`` sampling step on the draws ``uniforms``
    (S, n): the padded stack, the basis rotation, the cascade per shot."""
    stack, _ = jm._stack_padded(js.tensors, js.tensors[0].dtype)
    if basis != "Z":
        rot = jm._H_2X2 if basis == "X" else jm._H_2X2 @ jm._SDG_2X2
        stack = jnp.einsum("qp,slpr->slqr", jnp.asarray(rot, stack.dtype),
                           stack, precision=jm._PREC)
    return np.asarray(_JAX_CASCADE(stack, jnp.asarray(uniforms))).astype(
        np.uint8)


SMALL = _brick_dict(4, 2, 5)       # the noisy, sampling and shadow circuit


@pytest.fixture(scope="module")
def small():
    """JAX's and the port's final states of ``SMALL`` at chi = 4."""
    jc, tc = _pair(SMALL)
    _, js = jm.MPSSimulator(chi=4).run(jc, shots=0)
    _, ts = tm.MPSSimulator(chi=4, device=CPU).run(tc, shots=0)
    return jc, tc, js, ts


@pytest.mark.parametrize("basis", ["Z", "X", "Y"])
def test_sampled_bits_and_counts_match_jax(small, basis):
    _, tc, js, ts = small
    seed, shots = 11, 16
    ro = (0.05, 0.1)
    u = D.mps_run_uniforms(seed, shots, tc.num_qubits)
    want_bits = _jax_sample(js, u, basis)
    rng = np.random.default_rng(seed)
    rng.integers(0, 2 ** 63)
    want = jq.ReadoutError(*ro).corrupt_counts(tm._counts(want_bits), rng)
    got, _ = tm.MPSSimulator(chi=4, device=CPU).run(
        tc, shots=shots, seed=seed, basis=basis,
        readout_error=tq.ReadoutError(*ro), uniforms=u)
    rot = {"Z": np.eye(2), "X": tm._H_2X2, "Y": tm._H_2X2 @ tm._SDG_2X2}
    r = torch.from_numpy(rot[basis].astype(np.complex64))
    margins = D.cascade_margins([r @ t for t in ts.tensors], u, want_bits)
    got_bits = tm.sample_cascade([r @ t for t in ts.tensors],
                                 torch.from_numpy(u)).numpy()
    D.assert_draw_exact(got_bits, want_bits, margins)
    if (got_bits == want_bits).all():
        assert got == want


def test_draw_replicas_match_jax():
    """The NumPy gumbel and cascade draws equal jax.random's."""
    k = D.mps_master_key(3)
    keys = D.split(k, 3)
    for i in range(3):
        np.testing.assert_allclose(
            D.gumbel(keys[i], 4),
            np.asarray(jax.random.gumbel(jnp.asarray(keys[i]), (4,))),
            rtol=1e-6)
    kk = jnp.asarray(keys[1])
    chain = []
    for _ in range(3):
        kk, sub = jax.random.split(kk)
        chain.append(float(jax.random.uniform(sub)))
    np.testing.assert_array_equal(D.cascade_uniforms(keys, 3)[1],
                                  np.float32(chain))


# --- noisy and monitored trajectories ---------------------------------------

def _noise_pair(readout=True):
    jnm = jq.NoiseModel()
    jnm.add_global_noise(jq.AmplitudeDampingNoise(0.15))
    jnm.add_gate_noise("CNOT", jq.DepolarizingNoise(0.2))
    if readout:
        jnm.set_readout_error(jq.ReadoutError(0.02, 0.05))
    return jnm, tq.NoiseModel.from_dict(jnm.to_dict())


NOISY_SHOTS = 8


@pytest.fixture(scope="module")
def noisy():
    """JAX's ``run_with_noise`` body (``one``: ``_evolve`` then the
    cascade) under its draws, one row per shot: the Kraus branches, the
    sampled bits, the discarded weight."""
    jc, tc = _pair(SMALL)
    jnm, tnm = _noise_pair()
    seed = 21
    g, u = D.mps_noisy_draws(seed, NOISY_SHOTS, tm.draw_branches(tc, tnm),
                             tc.num_qubits)

    def one(grow, urow):
        rec = []
        with D.jax_keyed_table(grow, rec):
            tensors, dw, _, _ = jm._evolve(jc, 4, jnp.complex64, jnm,
                                           ZERO_KEY)
        stack, _ = jm._stack_padded(tensors, jnp.complex64)
        with D.jax_chained_table(urow):
            bits = jm._sample_one_shot(stack, ZERO_KEY)
        return bits, dw, jnp.stack(rec)

    bits, disc, branches = jax.jit(jax.vmap(one))(jnp.asarray(g),
                                                  jnp.asarray(u))
    return tc, tnm, seed, g, u, np.asarray(bits, np.uint8), \
        np.asarray(disc), np.asarray(branches)


@pytest.mark.parametrize("route", ["qr", "batched-svd"])
def test_noisy_shots_are_jax_draw_for_draw(noisy, route, monkeypatch):
    """Every Kraus branch and bit JAX's. "batched-svd": the centre moves
    the card takes for a batch (``mps._isometry_split``), forced here:
    another gauge, the same draws."""
    if route == "batched-svd":
        monkeypatch.setattr(tm, "_batched_svd_route",
                            lambda m: m.shape[0] > 1)
    tc, tnm, seed, g, u, want_bits, want_disc, want_branches = noisy
    assert len(tm.draw_branches(tc, tnm)) == want_branches.shape[1] == \
        jm._count_noise_sites(jq.QuantumCircuit.from_dict(SMALL),
                              jq.NoiseModel.from_dict(tnm.to_dict()))
    log = []
    with D.port_draws(log):
        mps, _, _ = tm._evolve(tc, 4, NOISY_SHOTS, CPU, noise_model=tnm,
                               gumbels=torch.from_numpy(g))
    got_branches = np.stack([m for m, _ in log], axis=1)
    D.assert_draw_exact(got_branches, want_branches,
                        np.stack([g_ for _, g_ in log], axis=1))
    got_bits = tm.sample_cascade(mps.tensors, torch.from_numpy(u)).numpy()
    D.assert_draw_exact(got_bits, want_bits,
                        D.cascade_margins(mps.tensors, u, want_bits))
    np.testing.assert_allclose(mps.discarded.numpy(), want_disc,
                               atol=TRUNC_TOL)
    # The entry point: the same bits, histogrammed, then readout error
    # from the NumPy stream of the seed.
    counts, mean_disc = tm.MPSSimulator(chi=4, device=CPU).run_with_noise(
        tc, tnm, shots=NOISY_SHOTS, seed=seed, gumbels=g, uniforms=u)
    rng = np.random.default_rng(seed)
    rng.integers(0, 2 ** 63)
    want = tnm.readout_error.corrupt_counts(tm._counts(want_bits), rng)
    if (got_bits == want_bits).all():
        assert counts == want
    assert mean_disc == pytest.approx(want_disc.mean(), abs=TRUNC_TOL)


MONITORED_T = 8


@pytest.fixture(scope="module")
def monitored():
    """JAX's ``monitored_trajectories`` body (``_evolve`` collapsing the
    Measure gates) under its draws, one row per trajectory: projector
    outcomes, every branch drawn, the final states."""
    jc, tc = _pair(_brick_dict(4, 2, 6, measure=True))
    jnm = jq.NoiseModel()
    jnm.add_gate_noise("CNOT", jq.AmplitudeDampingNoise(0.2))
    tnm = tq.NoiseModel.from_dict(jnm.to_dict())
    seed, sites = 5, []
    g = D.mps_monitored_gumbels(seed, MONITORED_T,
                                tm.draw_branches(tc, tnm, True))

    def one(grow):
        rec = []
        with D.jax_keyed_table(grow, rec):
            tensors, dw, o, s = jm._evolve(jc, 4, jnp.complex64, jnm,
                                           ZERO_KEY, collapse_measures=True)
        sites[:] = s
        return tensors, dw, o, jnp.stack(rec)

    tensors, disc, outs, branches = jax.jit(jax.vmap(one))(jnp.asarray(g))
    states = [jm.MPSState(tuple(t[i] for t in tensors), 4, 4,
                          float(disc[i])) for i in range(MONITORED_T)]
    return tc, tnm, g, np.asarray(outs), np.asarray(branches), states, \
        list(sites)


def test_monitored_trajectories_are_jax_draw_for_draw(monitored):
    tc, tnm, g, want_outs, want_branches, jstates, jsites = monitored
    log = []
    with D.port_draws(log):
        outs, sites, states = tm.MPSSimulator(
            chi=4, device=CPU).monitored_trajectories(
                tc, MONITORED_T, noise_model=tnm, gumbels=g)
    got = np.stack([m for m, _ in log], axis=1)
    D.assert_draw_exact(got, want_branches,
                        np.stack([m_ for _, m_ in log], axis=1))
    assert sites == jsites
    if (got == want_branches).all():
        np.testing.assert_array_equal(outs, want_outs)
        for js, ts in zip(jstates, states):
            assert _fidelity(js, ts) == pytest.approx(1.0, abs=OBS_TOL)
            assert ts.truncation_weight == pytest.approx(
                js.truncation_weight, abs=TRUNC_TOL)
    # The repeated measurement returns the same outcome.
    assert (outs[:, -1] == outs[:, -2]).all()


# --- laws and behaviour on the port alone (tests/test_mps.py) ---------------

def _c(n, gates):
    c = tq.QuantumCircuit(n)
    for col, (name, tg, p) in enumerate(gates):
        c.add(name, tg, p, col)
    return c


def _ghz(n):
    return _c(n, [("H", [0], [])] + [("CNOT", [q, q + 1], [])
                                     for q in range(n - 1)])


def _law_noisy_trajectories():
    c = _c(4, [("H", [q], []) for q in range(4)]
           + [("CNOT", [0, 2], []), ("Rx", [1], [0.8]), ("CZ", [2, 3], [])])
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.DepolarizingNoise(0.08))
    nm.add_global_noise(tq.AmplitudeDampingNoise(0.1))
    got, trunc = tm.MPSSimulator(chi=8, device=CPU).run_with_noise(
        c, nm, shots=4000, seed=9)
    probs = tq.DensityMatrixSimulator(nm, device=CPU).run(c).probabilities
    emp = np.zeros(16)
    for k, v in got.items():
        emp[int(k, 2)] = v / 4000
    assert trunc < 1e-6
    assert 0.5 * np.abs(emp - probs).sum() < 0.06


def _law_ghz40_damping():
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.AmplitudeDampingNoise(0.02))
    counts, _ = tm.MPSSimulator(chi=4, device=CPU).run_with_noise(
        _ghz(40), nm, shots=200, seed=2)
    assert sum(counts.values()) == 200 and all(len(k) == 40 for k in counts)
    assert counts.get("0" * 40, 0) > counts.get("1" * 40, 0)


def _law_readout_noisy():
    nm = tq.NoiseModel()
    nm.set_readout_error(tq.ReadoutError(p01=1.0, p10=0.0))
    counts, _ = tm.MPSSimulator(chi=2, device=CPU).run_with_noise(
        tq.QuantumCircuit(3), nm, shots=50, seed=1)
    assert counts == {"111": 50}


def _law_bell():
    c = _c(2, [("H", [0], []), ("CNOT", [0, 1], [])])
    counts, st = tm.MPSSimulator(chi=4, device=CPU).run(c, shots=2000,
                                                        seed=3)
    assert set(counts) == {"00", "11"} and abs(counts["00"] - 1000) < 150
    assert st.truncation_weight == 0.0


def _law_ghz100():
    n = 100
    counts, st = tm.MPSSimulator(chi=2, device=CPU).run(_ghz(n), shots=500,
                                                        seed=11)
    assert set(counts) == {"0" * n, "1" * n}
    assert st.truncation_weight < 1e-6
    assert abs(tm.entanglement_entropy(st, n // 2) - 1.0) < 1e-4
    assert abs(tm.expectation_pauli_string(st, {0: "Z", 50: "Z"})
               - 1.0) < 1e-5
    assert abs(tm.expectation_pauli_string(st, "X" * n) - 1.0) < 1e-4
    got = tm.expectation_hamiltonian(st, th.zz_chain(n, coeff=-1.0))
    assert abs(got + (n - 1)) < 1e-3


def _law_bases():
    n = 50
    plus = _c(n, [("H", [q], []) for q in range(n)])
    assert tm.MPSSimulator(chi=2, device=CPU).run(
        plus, shots=64, seed=0, basis="X")[0] == {"0" * n: 64}
    plus_i = tq.QuantumCircuit(20)
    for q in range(20):
        plus_i.add("H", [q], [], 0)
        plus_i.add("S", [q], [], 1)
    assert tm.MPSSimulator(chi=2, device=CPU).run(
        plus_i, shots=64, seed=1, basis="Y")[0] == {"0" * 20: 64}
    counts, _ = tm.MPSSimulator(chi=4, device=CPU).run(
        _ghz(4), shots=400, seed=2, basis="X")
    assert all(s.count("1") % 2 == 0 for s in counts) and len(counts) == 8
    ro = tq.ReadoutError(p01=1.0, p10=0.0)
    assert tm.MPSSimulator(chi=2, device=CPU).run(
        _c(30, [("H", [q], []) for q in range(30)]), shots=16, seed=3,
        basis="X", readout_error=ro)[0] == {"1" * 30: 16}


def _law_monitored():
    sim = tm.MPSSimulator(chi=4, device=CPU)
    c = _c(2, [("H", [0], []), ("CNOT", [0, 1], []), ("Measure", [0], [])])
    outs, sites, states = sim.monitored_trajectories(c, 24, seed=6)
    assert sites == [(2, 0)] and outs.shape == (24, 1)
    for t in range(24):
        z1 = tm.expectation_pauli_string(states[t], {1: "Z"})
        assert abs(z1 - (1.0 - 2.0 * int(outs[t, 0]))) < 1e-5
    assert 0 < int(outs.sum()) < 24
    outs, _, _ = tm.MPSSimulator(chi=2, device=CPU).monitored_trajectories(
        _c(1, [("Rx", [0], [0.8]), ("Measure", [0], [])]), 400, seed=3)
    assert abs(float(outs.mean()) - np.sin(0.4) ** 2) < 0.07
    ghz8 = _ghz(8)
    ghz8.add("Measure", [4], [], 8)
    _, _, states = sim.monitored_trajectories(ghz8, 3, seed=1)
    for st in states:
        assert abs(tm.entanglement_entropy(st, 3)) < 1e-5


def _law_entropy_and_dense_energy():
    c = _c(3, [("H", [0], [])])
    _, st = tm.MPSSimulator(chi=4, device=CPU).run(c, shots=0)
    assert abs(tm.entanglement_entropy(st, 0)) < 1e-6
    c.add("CNOT", [0, 1], [], 1)
    _, st = tm.MPSSimulator(chi=4, device=CPU).run(c, shots=0)
    assert abs(tm.entanglement_entropy(st, 0) - 1.0) < 1e-5
    assert abs(tm.entanglement_entropy(st, 1)) < 1e-6


LAWS = {"noisy-tvd": _law_noisy_trajectories,
        "ghz40-damping": _law_ghz40_damping,
        "readout-noisy": _law_readout_noisy,
        "bell": _law_bell, "ghz100": _law_ghz100, "bases": _law_bases,
        "monitored": _law_monitored,
        "entropy": _law_entropy_and_dense_energy}


@pytest.mark.parametrize("name", list(LAWS))
def test_laws_on_the_port(name):
    LAWS[name]()


def test_statevector_agreement_when_exact():
    """tests/test_mps.py's exactness against the statevector engine, at
    chi covering every cut, on the port's own Simulator."""
    for d in (_random_dict(6, 4, 7), _brick_dict(6, 4, 8)):
        c = tq.QuantumCircuit.from_dict(d)
        _, st = tm.MPSSimulator(chi=8, device=CPU).run(c, shots=0)
        psi = tq.Simulator(device=CPU).run(c, shots=0).final_state.data
        assert st.truncation_weight < 1e-9
        np.testing.assert_allclose(tm.to_statevector(st), psi, atol=ATOL)


def test_guards():
    c = tq.QuantumCircuit(12)
    c.add("MCZ9", list(range(9)), [], 0)
    with pytest.raises(ValueError, match="dense-gate path"):
        tm.MPSSimulator(chi=4, device=CPU).run(c, shots=0)
    with pytest.raises(ValueError):
        tm.MPSSimulator(chi=0)
    _, st = tm.MPSSimulator(chi=2, device=CPU).run(tq.QuantumCircuit(2),
                                                   shots=0)
    for bad in (lambda: tm.expectation_pauli_string(st, "XQ"),
                lambda: tm.expectation_pauli_string(st, {5: "X"}),
                lambda: tm.entanglement_entropy(st, 3),
                lambda: tm.MPSSimulator(chi=2, device=CPU).run(
                    tq.QuantumCircuit(2), shots=8, basis="W")):
        with pytest.raises(ValueError):
            bad()
    _, st3 = tm.MPSSimulator(chi=2, device=CPU).run(tq.QuantumCircuit(3),
                                                    shots=0)
    for terms in ([(1.0, "ZZ", [0])], [(1.0, "ZZ", [1, 1])],
                  [(1.0, "ZQ", [0, 1])]):
        with pytest.raises(ValueError):
            tm.expectation_hamiltonian(st3, terms)
    nm = tq.NoiseModel()
    nm.add_global_noise(tq.TwoQubitDepolarizingNoise(0.1))
    with pytest.raises(ValueError, match="1-qubit"):
        tm.MPSSimulator(chi=2, device=CPU).run_with_noise(_ghz(2), nm,
                                                          shots=4)


# --- the variational path ---------------------------------------------------

def _ansatz_dict(n, layers, theta):
    gates, col = [], 0
    for _ in range(layers):
        for q in range(n):
            gates.append({"name": "Ry", "targets": [q], "params": [theta],
                          "column": col})
        col += 1
        for q in range(n - 1):
            gates.append({"name": "CNOT", "targets": [q, q + 1],
                          "params": [], "column": col})
            col += 1
    for q in range(n):
        gates.append({"name": "Rz", "targets": [q], "params": [theta],
                      "column": col})
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def test_batched_cost_rows_match_jax():
    """``build_batched_cost_fn`` on a batch of 3 rows against JAX's (its
    jitted, vmapped cost), on ``SMALL`` with every rotation bound, at
    chi = 2 (truncating) and 4."""
    jc, tc = _pair(SMALL)
    terms = th.tfim_chain(4, j=-1.0, h=-0.6) + [(0.5, "ZZ", [0, 3])]
    jcfg = jopt.ParameterizedCircuitConfig.auto_detect(jc)
    rows = np.random.default_rng(0).uniform(-np.pi, np.pi,
                                            (3, jcfg.num_params))
    tcfg = topt.ParameterizedCircuitConfig.auto_detect(tc)
    for chi in (2, 4):
        jfn = jm.build_batched_cost_fn(jc, jcfg.bindings, terms, chi,
                                       constant=1.5)
        want = np.asarray(jfn(jnp.asarray(rows, jnp.float32)))
        got = tm.build_batched_cost_fn(tc, tcfg.bindings, terms, chi,
                                       constant=1.5, device=CPU)(rows)
        np.testing.assert_allclose(got.numpy(), want, atol=OBS_TOL)


def _mps_cfg(c, chi):
    return topt.MPSParameterizedConfig.auto_detect(c, chi=chi)


def _var_cost_trace():
    c = tq.QuantumCircuit.from_dict(_ansatz_dict(4, 2, 0.3))
    terms = ([(-1.0, "ZZ", [q, q + 1]) for q in range(3)]
             + [(-0.6, "X", [q]) for q in range(4)])
    cost = topt.CostFunction.vqe_hamiltonian(terms)
    runs = {}
    for name, cfg in (("dense", topt.ParameterizedCircuitConfig.auto_detect(
            c)), ("mps", _mps_cfg(c, 16))):
        res = topt.CircuitOptimizer(cfg, cost, learning_rate=0.2,
                                    max_iterations=4, tolerance=0.0,
                                    device=CPU).run(seed=11)
        runs[name] = [h[1] for h in res.history]
    np.testing.assert_allclose(runs["mps"], runs["dense"], atol=1e-4)


def _var_wide_descends():
    n = 40
    c = tq.QuantumCircuit.from_dict(_ansatz_dict(n, 1, 0.4))
    cfg = _mps_cfg(c, 8)
    cost = topt.CostFunction.vqe_hamiltonian(th.zz_chain(n, coeff=-1.0))
    opt = topt.CircuitOptimizer(cfg, cost, learning_rate=0.3,
                                max_iterations=2, tolerance=0.0, device=CPU)
    first = opt._evaluate_cost(cfg.get_values())
    res = opt.run(seed=5)
    assert res.optimal_cost < first
    _, st = tm.MPSSimulator(chi=8, device=CPU).run(
        cfg.bind_values(res.optimal_values), shots=0)
    want = tm.expectation_hamiltonian(st, th.zz_chain(n, coeff=-1.0))
    assert res.optimal_cost == pytest.approx(want, abs=1e-4)


def _var_qaoa_constant():
    c = tq.QuantumCircuit.from_dict(_ansatz_dict(3, 1, 0.5))
    cost = topt.CostFunction.qaoa_maxcut([(0, 1), (1, 2)])
    vals = np.array([[0.5, 0.2, 0.9, 0.1, -0.3, 0.7]])
    dense = topt.GradientEstimator._batched_costs(
        topt.ParameterizedCircuitConfig.auto_detect(c), cost, vals,
        device=CPU)
    via_mps = topt.GradientEstimator._batched_costs(_mps_cfg(c, 8), cost,
                                                    vals, device=CPU)
    np.testing.assert_allclose(via_mps, dense, atol=OBS_TOL)


def _var_refusals():
    """JAX's messages for a cost without terms and for reverse mode."""
    cfg = _mps_cfg(tq.QuantumCircuit.from_dict(_ansatz_dict(3, 1, 0.2)), 4)
    with pytest.raises(ValueError, match="Hamiltonian-shaped"):
        topt.CircuitOptimizer(cfg, topt.CostFunction.state_fidelity(
            np.eye(8)[0]), max_iterations=1, device=CPU).step()
    cost = topt.CostFunction.z_expectation(0)
    with pytest.raises(ValueError, match="parameter_shift"):
        topt.CircuitOptimizer(cfg, cost, gradient_method="autodiff",
                              device=CPU).step()
    with pytest.raises(ValueError, match="parameter_shift"):
        topt.CircuitOptimizer.multi_start(cfg, cost, n_starts=2,
                                          max_iterations=2, device=CPU)
    with pytest.raises(ValueError):
        topt.MPSParameterizedConfig(cfg.circuit, cfg.bindings, chi=0)


def _var_barren_plateau():
    cfg = _mps_cfg(tq.QuantumCircuit.from_dict(_ansatz_dict(3, 1, 0.2)), 8)
    opt = topt.CircuitOptimizer(cfg, topt.CostFunction.z_expectation(0),
                                device=CPU)
    out = opt.detect_barren_plateau(n_samples=4, seed=0)
    assert len(out["per_param"]) == cfg.num_params
    assert not out["is_barren"]


VARIATIONAL = {"cost-trace": _var_cost_trace, "wide": _var_wide_descends,
               "qaoa-constant": _var_qaoa_constant,
               "refusals": _var_refusals,
               "barren-plateau": _var_barren_plateau}


@pytest.mark.parametrize("name", list(VARIATIONAL))
def test_mps_variational_path(name):
    """tests/test_optimizer.py's MPS-engine checks on the port."""
    VARIATIONAL[name]()


def test_mps_gradient_matches_statevector_gradient():
    """Parameter shift through the batched MPS cost (2P rows as one
    batch) against the port's statevector gradient, chi exact."""
    c = tq.QuantumCircuit.from_dict(_ansatz_dict(5, 2, 0.1))
    cost = topt.CostFunction.vqe_hamiltonian(th.tfim_chain(5))
    v = np.random.default_rng(1).uniform(-np.pi, np.pi, 15)
    g_mps = topt.GradientEstimator.parameter_shift(_mps_cfg(c, 8), cost, v,
                                                   device=CPU)
    g_sv = topt.GradientEstimator.parameter_shift(
        topt.ParameterizedCircuitConfig.auto_detect(c), cost, v, device=CPU)
    np.testing.assert_allclose(g_mps, g_sv, atol=1e-4)


# --- MPS shadows --------------------------------------------------------------

def test_mps_shadow_outcomes_match_jax(small):
    """The MPS collector's snapshots against JAX's snapshot body under
    its keys: the same bases (the NumPy stream), the same outcomes."""
    jc, tc, js, ts = small
    n, seed, S = 4, 13, 24
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 3, size=(S, n)).astype(np.int8)
    onehots = np.eye(3, dtype=np.float32)[bases]
    u = D.shadow_uniforms(seed, S, n)
    stack, _ = jm._stack_padded(js.tensors, js.tensors[0].dtype)
    one = jsh._mps_snapshot_fn().__wrapped__.__wrapped__

    def snap(oh, urow):
        with D.jax_chained_table(urow):
            return one(stack, oh, ZERO_KEY)

    want = np.asarray(jax.jit(jax.vmap(snap))(jnp.asarray(onehots),
                                              jnp.asarray(u)))
    got = tsh.collect_shadows(tc, S, seed=seed, engine="mps", chi=4,
                              chunk=10, device=CPU, uniforms=u)
    np.testing.assert_array_equal(got.bases, bases)
    rots = torch.from_numpy(tsh._ROTATIONS.astype(np.complex64))[
        torch.from_numpy(bases.astype(np.int64))]
    margins = np.stack([D.cascade_margins(
        [rots[s:s + 1, i] @ t for i, t in enumerate(ts.tensors)],
        u[s:s + 1], want[s:s + 1])[0] for s in range(S)])
    D.assert_draw_exact(got.outcomes, want, margins)


def test_mps_shadow_estimates_and_routing():
    """tests/test_shadows.py's MPS checks on the port: agreement with the
    statevector collector, GHZ correlators at n = 40, engine routing."""
    c = _ghz(5)
    sv = tq.collect_shadows(c, 5000, seed=8, engine="statevector",
                            device=CPU)
    mp = tq.collect_shadows(c, 5000, seed=8, engine="mps", chi=8,
                            device=CPU)
    for pstr, qs in (("ZZ", [0, 4]), ("XXXXX", list(range(5)))):
        assert sv.estimate_pauli(pstr, qs) == pytest.approx(
            mp.estimate_pauli(pstr, qs), abs=0.8 if len(qs) > 2 else 0.2)
    data = tq.collect_shadows(_ghz(40), 4000, seed=9, engine="mps", chi=4,
                              chunk=128, device=CPU)
    assert data.bases.shape == (4000, 40)
    for qs in ([0, 39], [3, 17]):
        assert data.estimate_pauli("ZZ", qs) == pytest.approx(1.0, abs=0.25)
    assert data.estimate_pauli("Z", [12]) == pytest.approx(0.0, abs=0.2)
    auto = tq.collect_shadows(_ghz(21), 16, seed=1, device=CPU)
    assert auto.outcomes.shape == (16, 21)
    with pytest.raises(ValueError):
        tq.collect_shadows(tq.StateVector(1, device=CPU), 10, engine="mps")
