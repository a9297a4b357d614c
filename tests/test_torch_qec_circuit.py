"""The port's circuit-level QEC (``qec_circuit.py``), detector error model
(``qec_dem.py``), union-find matcher (``qec_matching.py``) and host C
(``native``) against the JAX package's, on the CPU.

JAX's draws are computed in NumPy with its key schedule
(``tests/torch_jax_draws.py``) and fed to the port: per trial
``uniform(k_t, (L,))`` over ``split(PRNGKey(seed), T)``, and the frame
engines' reference run's ``uniform(PRNGKey(0), (L_clean,))``. There is no
tolerance anywhere in this file: circuits, layouts, outcomes, detection
events, DEM edges / logical flags / fault weights (float64 sums in the
same order), matching graphs, corrections and reports are all equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulator_tpu import qec_circuit as jqc
from quantum_simulator_tpu import qec_dem as jqd
from quantum_simulator_tpu import qec_matching as jqm
from quantum_simulator_tpu.native import (counts_from_array_native,
                                          histogram_from_indices_native,
                                          pack_bits_native)
from quantum_simulator_tpu.qec_frame import _checks_matrix
from quantum_simulator_tpu_torch import clifford as tclif
from quantum_simulator_tpu_torch import native
from quantum_simulator_tpu_torch import qec_circuit as tqc
from quantum_simulator_tpu_torch import qec_dem as tqd
from quantum_simulator_tpu_torch import qec_matching as tqm
from quantum_simulator_tpu_torch.qec import _rotated_surface_geometry
from quantum_simulator_tpu_torch.qec_frame import surface_code_frame_spec
from tests import torch_jax_draws as nd

# (d, R, basis, two_qubit_depol, code)
CONFIG_Z = (3, 2, "z", False, "surface")
CONFIG_X = (3, 1, "x", True, "surface")
CONFIG_REP = (5, 2, "z", False, "repetition")
P = 0.02
T = 96


def _lengths(cfg, p=P):
    """Schedule lengths (clean, noisy) of a configuration's circuit."""
    nm = tqc._noise_model(p, cfg[3])
    clean = len(tqc._lower(_port_circuit(cfg), collapse_measures=True)[0])
    noisy = len(tqc._lower(_port_circuit(cfg), noise_model=nm,
                           collapse_measures=True)[0])
    return clean, noisy


def _port_circuit(cfg):
    d, R, basis, _, code = cfg
    return tqc._extraction_circuit(code, d, R, basis)[0]


def _draws(cfg, seed=5):
    """JAX's keys and per-trial uniforms, and its reference row."""
    clean, noisy = _lengths(cfg)
    keys = nd.split(nd.key(seed), T)
    return (jnp.asarray(keys), torch.from_numpy(nd.uniform(keys, noisy)),
            torch.from_numpy(nd.uniform(nd.key(0), clean)[None]))


@pytest.mark.parametrize("cfg", [CONFIG_Z, (5, 3, "x", False, "surface"),
                                 CONFIG_REP])
def test_extraction_circuits_and_layouts_match_jax(cfg):
    d, R, basis, _, code = cfg
    jc, jl = jqc._extraction_circuit(code, d, R, basis)
    tc, tl = tqc._extraction_circuit(code, d, R, basis)
    assert tc.to_dict()["gates"] == jc.to_dict()["gates"]
    assert tc.num_qubits == jc.num_qubits
    for f in ("distance", "n_rounds", "n_data", "n_z", "n_x", "basis",
              "sector_diagonals"):
        assert getattr(tl, f) == getattr(jl, f)
    assert np.array_equal(tl.sector_matrix, jl.sector_matrix)
    assert np.array_equal(tl.sector_support, jl.sector_support)
    z, x, _, _ = _rotated_surface_geometry(d)
    for order in ((0, 2, 1, 3), (0, 1, 2, 3)):
        for checks in (z, x):
            assert tqc._check_schedule(checks, d, order) == \
                jqc._check_schedule(checks, d, order)


@pytest.mark.parametrize("engine", ["linear", "frame", "clifford"])
def test_samplers_match_jax_under_jax_draws(engine):
    keys, u, ref = _draws(CONFIG_Z)
    d, R, basis, two, code = CONFIG_Z
    run, _ = jqc._trajectory_fn(d, R, P, basis, engine, two, code)
    want = np.asarray(run(keys))
    got, _ = tqc._trajectory_fn(d, R, P, basis, engine, two, code, "cpu",
                                ref_uniforms=ref)
    assert np.array_equal(got(u).numpy(), want)


@pytest.mark.parametrize("cfg", [CONFIG_Z, CONFIG_X])
def test_dem_matches_jax(cfg, monkeypatch):
    """Also with JAX's row passed in and the faults cut into chunks of 97
    by a smaller byte budget: the model does not depend on the cut."""
    d, R, basis, two, code = cfg
    want = jqd.extract_dem(d, R, basis, two, code)
    clean, _ = _lengths(cfg)
    row = torch.from_numpy(nd.uniform(nd.key(0), clean)[None])
    whole = tqd.extract_dem(d, R, basis, two, code, device="cpu")
    n = _port_circuit(cfg).num_qubits
    monkeypatch.setattr(tclif, "TRAJECTORY_MEMORY_BYTES",
                        97 * (tclif._BYTES_PER_N2 * n * n + 1))
    assert tclif.tableau_rows(n) == 97
    cut = tqd.extract_dem(d, R, basis, two, code, device="cpu", uniforms=row)
    for got in (whole, cut):
        assert np.array_equal(got.edges, want.edges)
        assert np.array_equal(got.logicals, want.logicals)
        assert np.array_equal(got.counts, want.counts)
        assert (got.n_sites, got.n_faults, got.dropped, got.ambiguous) == \
            (want.n_sites, want.n_faults, want.dropped, want.ambiguous)
    for scale in (0.0, 1.0):
        gj, gt = want.graph(P, scale), got.graph(P, scale)
        assert np.array_equal(gt.edges, gj.edges)
        assert (gt.weights is None and gj.weights is None) or \
            np.array_equal(gt.weights, gj.weights)


@pytest.mark.parametrize("decoder", ["dem", "phenomenological"])
def test_circuit_level_memory_matches_jax(decoder):
    d, R, basis, two, code = CONFIG_Z
    keys, u, ref = _draws(CONFIG_Z, seed=11)
    want = jqc.circuit_level_memory(d, R, P, T, seed=11, basis=basis,
                                    decoder=decoder, two_qubit_depol=two,
                                    code=code)
    got = tqc.circuit_level_memory(d, R, P, T, basis=basis, decoder=decoder,
                                   two_qubit_depol=two, code=code,
                                   device="cpu", uniforms=u,
                                   ref_uniforms=ref)
    assert got == want


def test_record_decoding_matches_jax():
    _, lay = tqc.surface_extraction_circuit(3, 3, "z")
    _, jlay = jqc.surface_extraction_circuit(3, 3, "z")
    M = lay.n_rounds * (lay.n_z + lay.n_x) + lay.n_data
    outs = np.random.default_rng(0).integers(0, 2, (200, M)).astype(np.uint8)
    assert np.array_equal(tqc.detection_events(lay, outs),
                          jqc.detection_events(jlay, outs))
    for a, b in zip(tqc.decode_memory_record(lay, outs),
                    jqc.decode_memory_record(jlay, outs)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cfg", [CONFIG_X, CONFIG_REP])
def test_engines_agree_under_one_seed(cfg):
    """The port's three samplers on its own default draws (the tableau
    walk is JAX's, ``test_samplers_match_jax_under_jax_draws`` and
    ``tests/test_torch_clifford.py``; here the linear sampler's
    two-qubit Pauli bits and the x basis are held to it)."""
    d, R, basis, two, code = cfg
    reports = [tqc.circuit_level_memory(d, R, 0.03, 200, seed=4,
                                        basis=basis, two_qubit_depol=two,
                                        code=code, engine=e, device="cpu")
               for e in ("linear", "frame", "clifford")]
    assert reports[0] == reports[1] == reports[2]


def test_linear_sampler_batches_and_frame_measurement():
    """Cut into trial batches by bytes, the linear sampler gives the same
    outcomes; the frame measurement clears the z bit (no phantom flip
    at the next round's H)."""
    circ, _ = tqc._extraction_circuit("surface", 3, 2, "z")
    codes, qa, qb, pp, _ = tqc._lower(circ, tqc._noise_model(0.05, False),
                                      collapse_measures=True)
    ref = tqc.reference_sample(circ, "cpu")
    u = torch.rand((50, len(codes)), generator=torch.Generator()
                   .manual_seed(1))
    whole = tqc._linear_sampler_fn(codes, qa, qb, pp, ref, circ.num_qubits)
    want = whole(u)
    old = tqc.TRAJECTORY_MEMORY_BYTES
    try:
        tqc.TRAJECTORY_MEMORY_BYTES = 1
        cut = tqc._linear_sampler_fn(codes, qa, qb, pp, ref, circ.num_qubits)
    finally:
        tqc.TRAJECTORY_MEMORY_BYTES = old
    assert torch.equal(cut(u), want)
    assert torch.equal(tqc.frame_walk(circ.num_qubits, codes, qa, qb, pp, u,
                                      ref), want)
    x = torch.zeros((1, 2), dtype=torch.int8)
    z = torch.ones((1, 2), dtype=torch.int8)
    tqc._frame_op(x, z, 9, 0, 0, None, np.float32(0))
    assert z.tolist() == [[0, 1]]


# --- matching ---------------------------------------------------------------

def _graphs():
    z, _, _, _ = _rotated_surface_geometry(5)
    H = _checks_matrix(z, 25)
    rep = np.zeros((6, 7), np.uint8)
    for i in range(6):
        rep[i, i] = rep[i, i + 1] = 1
    dem = tqd.extract_dem(3, 2, "z", device="cpu")
    return [("surface5", tqm.MatchingGraph.from_checks(H),
             jqm.MatchingGraph.from_checks(H)),
            ("space_time", tqm.space_time_graph(H, 3),
             jqm.space_time_graph(H, 3)),
            ("diagonal", tqm.space_time_graph(rep, 2, [None] + [
                (q, q - 1) for q in range(1, 6)] + [None]),
             jqm.space_time_graph(rep, 2, [None] + [
                 (q, q - 1) for q in range(1, 6)] + [None])),
            ("dem_weighted", dem.graph(0.01, 1.0), dem.graph(0.01, 1.0))]


@pytest.mark.parametrize("k", range(4))
def test_decoders_bit_identical_and_equal_jax(k):
    name, tg, jg = _graphs()[k]
    assert np.array_equal(tg.edges, jg.edges)
    assert (tg.n_checks, tg.n_qubits, tg.boundary) == \
        (jg.n_checks, jg.n_qubits, jg.boundary)
    syn = np.random.default_rng(k).integers(
        0, 2, (100, tg.n_checks)).astype(np.uint8)
    if not tg.has_boundary:
        syn[:, 0] ^= syn.sum(1) % 2
    before = dict(tqm.DECODE_CALLS)
    c_out = tqm.decode_batch(tg, syn)
    assert tqm.DECODE_CALLS["native"] == before["native"] + 1
    assert np.array_equal(c_out, tqm.decode_batch(tg, syn,
                                                  force_python=True))
    assert np.array_equal(c_out, jqm.decode_batch(jg, syn))
    if name == "surface5":
        H = surface_code_frame_spec(5).comp_checks
        assert np.array_equal((c_out.astype(int) @ H.T) % 2, syn)


def test_decode_fns_on_tensors_and_space_time():
    spec = surface_code_frame_spec(7)
    syn_c = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (40, spec.comp_checks.shape[0])).astype(np.int32))
    syn_h = torch.zeros((40, spec.h_checks.shape[0]), dtype=torch.int32)
    cx, cz = spec.decode(syn_c, syn_h)
    hx, hz = spec.host_decode(syn_c.numpy(), syn_h.numpy())
    assert cx.device == syn_c.device and cx.dtype == torch.int32
    assert np.array_equal(cx.numpy(), hx) and not cz.any()
    jx, _ = jqm.union_find_host_decode_fn(spec.comp_checks, spec.h_checks)(
        syn_c.numpy(), syn_h.numpy())
    assert np.array_equal(hx, jx)
    z, _, _, _ = _rotated_surface_geometry(3)
    H = _checks_matrix(z, 9)
    det = np.random.default_rng(1).integers(0, 2, (50, 4 * 4)).astype(
        np.uint8)
    assert np.array_equal(tqm.space_time_decode_fn(H, 3)(det),
                          jqm.space_time_decode_fn(H, 3)(det))
    with pytest.raises(ValueError, match="must be"):
        tqm.decode_batch(tqm.MatchingGraph.from_checks(H), det)


# --- native -----------------------------------------------------------------

def test_native_source_build_and_helpers():
    """The port builds its own copy of the JAX package's C source into
    ``build/native/<hash>/`` (no temporary file left behind), and the
    module's other methods equal the JAX package's."""
    src = native.SOURCE.read_bytes()
    jax_src = (native.SOURCE.parents[2] / "quantum_simulator_tpu" / "native"
               / "qsim_native.c").read_bytes()
    assert src == jax_src
    mod = native.native_module(required=True)
    lib = native.build()
    assert lib.parent == native.build_dir()
    assert lib.parent.parent == native.BUILD_ROOT
    assert mod.__file__ == str(lib)
    assert not [p for p in lib.parent.iterdir() if p != lib]
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 5, 64)
    assert mod.counts_from_array(memoryview(counts), 6) == \
        counts_from_array_native(counts, 6)
    idx = rng.integers(0, 64, 500)
    assert mod.histogram_from_indices(memoryview(idx), 6) == \
        histogram_from_indices_native(idx, 6)
    bits = rng.integers(0, 2, (20, 6)).astype(np.uint8)
    assert mod.pack_bits(memoryview(bits.reshape(-1)), 20, 6) == \
        pack_bits_native(bits, 6)
