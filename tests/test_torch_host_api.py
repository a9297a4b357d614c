"""The port's host-side API against the JAX package's: circuit editing,
``StateVector`` / ``MeasurementEngine`` methods, ``ops.apply`` primitives
with leading batches, registry listings, OpenQASM 2.0 import / export
(``qasm.py``, the counterpart of ``quantum_simulator_tpu/interop.py``) and
the ``utils`` modules.

The same edits, the same NumPy states and the same seeded generators go
through both packages: structures and texts must be equal, amplitudes
agree within 1e-6 (complex64 on both sides), and measurement outcomes are
equal because both draw them from NumPy.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import quantum_simulator_tpu as jq
import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu import interop as jqasm
from quantum_simulator_tpu.registry import GateRegistry as JRegistry
from quantum_simulator_tpu.utils import appconfig as jappconfig
from quantum_simulator_tpu.utils import experiment as jexperiment
from quantum_simulator_tpu.utils import profiling as jprofiling
from quantum_simulator_tpu.utils import serialization as jserial
from quantum_simulator_tpu_torch import qasm as tqasm
from quantum_simulator_tpu_torch.models import brickwork_circuit
from quantum_simulator_tpu_torch.ops import apply as tapply
from quantum_simulator_tpu_torch.registry import GateRegistry
from quantum_simulator_tpu_torch.utils import appconfig as tappconfig
from quantum_simulator_tpu_torch.utils import experiment as texperiment
from quantum_simulator_tpu_torch.utils import profiling as tprofiling
from quantum_simulator_tpu_torch.utils import serialization as tserial
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

AMP_TOL = 1e-6


def random_psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return psi / np.linalg.norm(psi)


# ---------------------------------------------------------------------------
# Circuit editing
# ---------------------------------------------------------------------------

def edited(pkg):
    """One run of circuit edits, the same calls in either package."""
    c = pkg.QuantumCircuit(4, initial_states=[0, 1])
    g_h = c.add("H", [0])
    g_cx = c.add("CNOT", [0, 1])
    c.add("Rz", [3], [0.25], column=1)
    g_x = c.add("X", [2], column=0)
    log = [c.gate_count(), c.depth(), c.get_column_count(),
           [g.gate_name for g in c.get_gates_at_column(1)]]
    c.move_gate(g_cx, 4, [2, 3])
    c.remove_gate(g_x)
    c.remove_gate(pkg.GateInstance("Y", [0]))        # not in the circuit
    c.move_gate(pkg.GateInstance("Y", [0]), 9, [1])  # ignored likewise
    c.toggle_qubit_initial_state(0)
    c.toggle_qubit_initial_state(7)                  # out of range: ignored
    c.set_qubit_initial_state(3, 1)
    c.set_qubit_initial_state(3, 2)                  # not a bit: ignored
    log += [c.gate_count(), c.depth(), c.get_column_count(), g_h.column]
    c.set_num_qubits(3)                              # drops gates on qubit 3
    log += [c.gate_count(), list(c.initial_states), c.to_dict()]
    c.set_num_qubits(5)
    log += [list(c.initial_states), c.compute_layers()]
    c2 = c.copy()
    c.clear()
    log += [c.gate_count(), c.depth(), c2.gate_count()]
    return log


def test_circuit_editing_matches_jax():
    assert edited(tq) == edited(jq)


def test_set_num_qubits_validates():
    for pkg in (tq, jq):
        c = pkg.QuantumCircuit(2)
        with pytest.raises(ValueError):
            c.set_num_qubits(0)


# ---------------------------------------------------------------------------
# ops.apply primitives, StateVector, MeasurementEngine
# ---------------------------------------------------------------------------

def test_make_basis_state_and_batches():
    s = tapply.make_basis_state(3, 5)
    assert s.dtype == torch.complex64 and tuple(s.shape) == (8,)
    assert s[5] == 1 and s.abs().sum() == 1
    b = tapply.make_basis_state(3, [0, 7, 2], torch.complex128)
    assert tuple(b.shape) == (3, 8) and b.dtype == torch.complex128
    assert b[1, 7] == 1 and b[2, 2] == 1 and b.abs().sum() == 3


def test_apply_primitives_index_the_last_dimension():
    """``apply_gate_host`` and ``reduced_density_matrix_1q`` on a batch
    equal the per-row calls (and ``apply_cphase`` too: a batch used to
    read ``shape[0]``)."""
    n = 4
    batch = torch.tensor(np.stack([random_psi(n, s) for s in range(3)]),
                         dtype=torch.complex64)
    u = np.array([[0, 1], [1, 0]]) @ np.diag([1, 1j])
    cx = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])
    got = tapply.apply_gate_host(batch, u, np.array([2]), np.int64(n))
    got2 = tapply.apply_gate_host(batch, cx.tolist(), [3, 1], n)
    got3 = tapply.apply_cphase(batch, (0, 2), -1.0, n)
    rdm = tapply.reduced_density_matrix_1q(batch, 1, n)
    assert tuple(rdm.shape) == (3, 2, 2)
    for r in range(3):
        np.testing.assert_allclose(
            got[r].numpy(), tapply.apply_gate(batch[r], u, (2,), n).numpy(),
            atol=1e-7)
        np.testing.assert_allclose(
            got2[r].numpy(),
            tapply.apply_gate(batch[r], cx, (3, 1), n).numpy(), atol=1e-7)
        np.testing.assert_allclose(
            got3[r].numpy(),
            tapply.apply_cphase(batch[r], (0, 2), -1.0, n).numpy(),
            atol=1e-7)
        np.testing.assert_allclose(
            rdm[r].numpy(),
            tapply.reduced_density_matrix_1q(batch[r], 1, n).numpy(),
            atol=1e-7)
        psi = batch[r].numpy().reshape(2, 2, 4)
        want = np.einsum("aib,ajb->ij", psi, psi.conj())
        np.testing.assert_allclose(rdm[r].numpy(), want, atol=1e-6)


def both_states(n, seed):
    psi = random_psi(n, seed)
    js = jq.StateVector(n)
    js.data = psi
    ts = tq.StateVector(n, device="cpu")
    ts.data = psi
    return js, ts


def test_statevector_methods_match_jax():
    n = 4
    js, ts = both_states(n, 0)
    np.testing.assert_allclose(ts.data, js.data, atol=AMP_TOL)
    u = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    cz = np.diag([1, 1, 1, -1]).astype(complex)
    for sv in (js, ts):
        sv.apply_gate(u, [1])
        sv.apply_gate(cz, [3, 0])
    np.testing.assert_allclose(ts.data, js.data, atol=AMP_TOL)
    np.testing.assert_allclose(ts.probabilities, js.probabilities,
                               atol=AMP_TOL)
    for q in range(n):
        np.testing.assert_allclose(ts.get_reduced_density_matrix(q),
                                   js.get_reduced_density_matrix(q),
                                   atol=AMP_TOL)
        np.testing.assert_allclose(ts.get_bloch_coordinates(q),
                                   js.get_bloch_coordinates(q), atol=AMP_TOL)
    np.testing.assert_allclose(ts.get_density_matrix(),
                               js.get_density_matrix(), atol=AMP_TOL)
    assert ts.get_density_matrix().dtype == np.complex128
    tc = ts.copy()
    ts.reset([1, 0, 1, 1])
    js.reset([1, 0, 1, 1])
    np.testing.assert_allclose(ts.data, js.data, atol=0)
    assert ts.data[0b1011] == 1
    assert abs(tc.data[0b1011]) < 1          # the copy kept the old state
    ts.reset()
    assert ts.data[0] == 1
    for sv in (js, ts):
        with pytest.raises(ValueError):
            sv.apply_gate(u, [4])
        with pytest.raises(ValueError):
            sv.data = np.zeros(3)
        with pytest.raises(ValueError):
            sv.measure_qubit(9)
        with pytest.raises(ValueError):
            sv.get_reduced_density_matrix(-1)


def test_bloch_coordinates_of_known_states():
    sv = tq.StateVector(1, device="cpu")
    assert sv.get_bloch_coordinates(0) == pytest.approx((0, 0, 1), abs=1e-6)
    sv.data = np.array([1, 1]) / np.sqrt(2)
    assert sv.get_bloch_coordinates(0) == pytest.approx((1, 0, 0), abs=1e-6)
    sv.data = np.array([1, 1j]) / np.sqrt(2)
    assert sv.get_bloch_coordinates(0) == pytest.approx((0, 1, 0), abs=1e-6)
    bell = tq.StateVector(2, device="cpu")
    bell.data = np.array([1, 0, 0, 1]) / np.sqrt(2)
    assert bell.get_bloch_coordinates(1) == pytest.approx((0, 0, 0),
                                                          abs=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_measurements_draw_the_same_outcomes(seed):
    """Same rng, same outcomes, same collapsed states: ``measure_qubit``
    and ``measure_all`` draw from NumPy in both packages."""
    n = 3
    js, ts = both_states(n, 10 + seed)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for q in (1, 0):
        assert ts.measure_qubit(q, tr) == js.measure_qubit(q, jr)
        np.testing.assert_allclose(ts.data, js.data, atol=AMP_TOL)
    assert ts.measure_all(tr) == js.measure_all(jr)
    np.testing.assert_allclose(ts.data, js.data, atol=0)
    # the engine's versions leave the input as it was
    js, ts = both_states(n, 20 + seed)
    before = ts.data
    jo, jcol = jq.MeasurementEngine.measure_qubit(
        js, 2, np.random.default_rng(seed))
    to, tcol = tq.MeasurementEngine.measure_qubit(
        ts, 2, np.random.default_rng(seed))
    assert to == jo
    np.testing.assert_allclose(tcol.data, jcol.data, atol=AMP_TOL)
    np.testing.assert_allclose(ts.data, before, atol=0)
    jb, jcol = jq.MeasurementEngine.measure_all(
        js, np.random.default_rng(seed))
    tb, tcol = tq.MeasurementEngine.measure_all(
        ts, np.random.default_rng(seed))
    assert tb == jb and len(tb) == n
    np.testing.assert_allclose(tcol.data, jcol.data, atol=0)
    np.testing.assert_allclose(ts.data, before, atol=0)


# ---------------------------------------------------------------------------
# Registry listings
# ---------------------------------------------------------------------------

def test_registry_listings_match_jax():
    GateRegistry.reset()
    JRegistry.reset()
    try:
        treg, jreg = GateRegistry.instance(), JRegistry.instance()
        for name in ("MCZ3", "MCZ12", "ExpP[XZ]"):
            treg.get(name)
            jreg.get(name)

        def names(gates):
            return [g.name for g in gates]

        assert treg.gate_names() == jreg.gate_names()
        assert names(treg.all_gates()) == names(jreg.all_gates())
        assert names(treg.single_qubit_gates()) == \
            names(jreg.single_qubit_gates())
        assert names(treg.multi_qubit_gates()) == \
            names(jreg.multi_qubit_gates())
        assert names(treg.parameterized_gates()) == \
            names(jreg.parameterized_gates())
        assert "ExpP[XZ]" in names(treg.parameterized_gates())
        assert "CNOT" in names(treg.multi_qubit_gates())
        for tg, jg in zip(treg.all_gates(), jreg.all_gates()):
            assert (tg.display_name, tg.gate_type.value, tg.num_qubits,
                    tg.num_params, tg.param_names, tg.symbol, tg.color,
                    tg.num_controls, tg.num_targets) == (
                jg.display_name, jg.gate_type.value, jg.num_qubits,
                jg.num_params, jg.param_names, jg.symbol, jg.color,
                jg.num_controls, jg.num_targets)
        for bad in ("Nope", "ExpP[]", "ExpP[" + "Z" * 9 + "]", "MCZ1"):
            with pytest.raises(KeyError):
                treg.get(bad)
    finally:
        GateRegistry.reset()
        JRegistry.reset()


# ---------------------------------------------------------------------------
# OpenQASM 2.0
# ---------------------------------------------------------------------------

def export_circuits(pkg):
    out = {}
    c = pkg.QuantumCircuit(3)
    for col, (name, tg) in enumerate([
            ("I", [0]), ("H", [0]), ("X", [1]), ("Y", [2]), ("Z", [0]),
            ("S", [1]), ("S_DAG", [2]), ("T", [0]), ("T_DAG", [1]),
            ("CNOT", [0, 1]), ("CZ", [1, 2]), ("SWAP", [0, 2]),
            ("Toffoli", [0, 1, 2]), ("Fredkin", [2, 0, 1])]):
        c.add(name, tg, column=col)
    out["fixed"] = c
    c = pkg.QuantumCircuit(2)
    c.add("Rx", [0], [math.pi / 2])
    c.add("Ry", [1], [-3 * math.pi / 4])
    c.add("Rz", [0], [0.123456789])
    c.add("Phase", [1], [1e-5])
    c.add("U3", [0], [0.1, 0.2, 0.0])
    c.add("CPhase", [0, 1], [math.pi / 8])
    out["params"] = c
    c = pkg.QuantumCircuit(3, initial_states=[1, 0, 1])
    c.add("H", [1])
    c.add("Barrier", [0], column=1)
    c.add("Barrier", [2], column=1)
    c.add("Measure", [0], column=2)
    c.add("Measure", [2], column=2)
    c.add("MCZ2", [0, 1], column=3)
    c.add("MCZ3", [0, 1, 2], column=4)
    out["prep-measure-mcz"] = c
    return out


@pytest.mark.parametrize("name", ["fixed", "params", "prep-measure-mcz"])
def test_to_qasm_text_equals_jax_and_round_trips(name):
    tc, jc = export_circuits(tq)[name], export_circuits(jq)[name]
    text = tq.to_qasm(tc)
    assert text == jq.to_qasm(jc)
    back, jback = tq.from_qasm(text), jq.from_qasm(text)
    assert back.to_dict() == jback.to_dict()
    # exported-then-reimported gives the same state up to a global phase
    # (initial |1> qubits come back as a leading x column)
    def state(c):
        bare = tq.QuantumCircuit.from_dict(c.to_dict())
        return tq.Simulator(device="cpu").run(bare, shots=0).final_state.data

    s1, s2 = state(tc), state(back)
    k = int(np.argmax(np.abs(s1)))
    np.testing.assert_allclose(s1 * (s2[k] / s1[k]), s2, atol=1e-6)


def test_unexportable_gates_raise():
    for gate, targets in (("MCZ4", [0, 1, 2, 3]), ("ExpP[ZZ]", [0, 1])):
        for pkg, err in ((tq, tqasm.QasmError), (jq, jqasm.QasmError)):
            c = pkg.QuantumCircuit(4)
            c.add(gate, targets, [0.1] if gate.startswith("ExpP") else [])
            with pytest.raises(err):
                pkg.to_qasm(c)
    assert issubclass(tqasm.QasmError, ValueError)


QASM_SOURCES = {
    "bell": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[2];
        creg c[2];
        h q[0];
        cx q[0],q[1];
    """,
    "expressions": """
        qreg q[1];
        rx(pi/2) q[0];
        rz(-3*pi/4) q[0];
        u1(2*pi/8 + 0.5) q[0];
        ry(sin(0.3)*2) q[0];
        rz(2^3^2 * 1e-3 + .5e1 - ln(exp(1))) q[0];
    """,
    "broadcast": "qreg q[3]; h q; cx q[0],q[1];",
    "lockstep": "qreg a[2]; qreg b[2]; cx a,b;",
    "asap": "qreg q[3]; h q[0]; h q[2]; cx q[0],q[1]; x q[2];",
    "aliases": "qreg q[2]; u2(0.1,0.2) q[0]; u(1,2,3) q[0]; p(0.5) q[0]; "
               "U(1,2,3) q[1]; CX q[0],q[1]; cp(0.3) q[1],q[0]; id q[0];",
    "macro": """
        OPENQASM 2.0;
        gate bell a,b { h a; cx a,b; }
        gate rot(t) a { rx(t) a; barrier a; rz(t/2) a; }
        qreg q[2];
        bell q[0],q[1];
        rot(pi) q[1];
    """,
    "nested": """
        gate half(t) a { ry(t/2) a; }
        gate whole(t) a { half(t) a; half(t) a; }
        qreg q[1];
        whole(0.8) q[0];
    """,
    "measure": "qreg q[2]; creg c[2]; h q; barrier q; measure q -> c;",
    "comments": "// header\nqreg q[1]; /* block\ncomment */ h q[0];",
    "qft4": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[4];
        h q[0];
        cu1(pi/2) q[1],q[0];
        cu1(pi/4) q[2],q[0];
        cu1(pi/8) q[3],q[0];
        h q[1];
        cu1(pi/2) q[2],q[1];
        cu1(pi/4) q[3],q[1];
        h q[2];
        cu1(pi/2) q[3],q[2];
        h q[3];
        swap q[0],q[3];
        swap q[1],q[2];
        ccx q[0],q[1],q[2];
        cswap q[3],q[1],q[0];
    """,
}


@pytest.mark.parametrize("name", sorted(QASM_SOURCES))
def test_from_qasm_matches_jax(name):
    tc = tq.from_qasm(QASM_SOURCES[name])
    jc = jq.from_qasm(QASM_SOURCES[name])
    assert isinstance(tc, tq.QuantumCircuit)
    assert tc.to_dict() == jc.to_dict()


QASM_ERRORS = [
    "OPENQASM 2.0;", "qreg q[1]; zz q[0];", "qreg q[2]; h q[5];",
    "qreg q[1]; creg c[1]; if (c==1) x q[0];",
    "qreg q[1]; rx(__import__) q[0];", "qreg q[2]; cx q[0],q[0];",
    "qreg a[2]; qreg b[3]; cx a,b;", "qreg q[1]; opaque foo a;",
    "qreg q[1]; reset q[0];", "qreg q[1]; qreg q[2];",
    "qreg q[1]; rx(1,2) q[0];", "qreg q[1]; u2(1) q[0];",
    "qreg q[1]; h r[0];", "qreg q[1]; rx(9^9^9^9) q[0];",
    "qreg q[1]; rx(1/0) q[0];", "qreg q[1]; rx((1+2) q[0];",
    "qreg q[1]; rx(sin 3) q[0];", "qreg q[1]; rx(2*tau) q[0];",
    "gate g(t) a { rx(t) a; } qreg q[1]; g q[0];",
    "gate g a { h b; } qreg q[1]; g q[0];",
]


@pytest.mark.parametrize("source", QASM_ERRORS)
def test_from_qasm_errors_match_jax(source):
    with pytest.raises(jqasm.QasmError) as jerr:
        jq.from_qasm(source)
    with pytest.raises(tqasm.QasmError) as terr:
        tq.from_qasm(source)
    assert str(terr.value) == str(jerr.value)


def test_expression_parser_grammar():
    for text, env, want in [
            ("1e-05", {}, 1e-5), ("2.5E+3", {}, 2500.0), (".5e1", {}, 5.0),
            ("2+3*4", {}, 14.0), ("(2+3)*4", {}, 20.0),
            ("-pi/2", {}, -math.pi / 2), ("2^3^2", {}, 512.0),
            ("-2^2", {}, -4.0), ("sin(pi/6)", {}, 0.5),
            ("sqrt(2)*cos(0)", {}, math.sqrt(2)),
            ("theta/2", {"theta": 0.8}, 0.4)]:
        assert tqasm._eval_expr(text, env) == pytest.approx(want)
        assert tqasm._eval_expr(text, env) == jqasm._eval_expr(text, env)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def sample_circuit(pkg):
    c = pkg.QuantumCircuit(3, initial_states=[0, 1, 0])
    c.add("H", [0])
    c.add("Ry", [1], [0.3])
    c.add("CNOT", [0, 2])
    c.add("Measure", [2])
    return c


def test_circuit_serializer_files_equal_jax(tmp_path):
    for ext in (".qsim", ".json", ".qasm"):
        tpath, jpath = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
        tserial.CircuitSerializer.save(sample_circuit(tq), tpath)
        jserial.CircuitSerializer.save(sample_circuit(jq), str(jpath))
        assert tpath.read_text(encoding="utf-8") == \
            jpath.read_text(encoding="utf-8")
        # each package loads the other's file
        loaded = tserial.CircuitSerializer.load(jpath)
        assert isinstance(loaded, tq.QuantumCircuit)
        assert loaded.to_dict() == \
            jserial.CircuitSerializer.load(tpath).to_dict()
    assert (tserial.CircuitSerializer.FILE_VERSION,
            tserial.CircuitSerializer.FILE_EXTENSION,
            tserial.CircuitSerializer.QASM_EXTENSION) == ("1.0", ".qsim",
                                                          ".qasm")


def test_experiment_config_json_equals_jax(tmp_path):
    def snapshot(pkg, mod, device_kw):
        nm = pkg.NoiseModel()
        nm.add_global_noise(pkg.DepolarizingNoise(0.05))
        nm.set_readout_error(pkg.ReadoutError(0.01, 0.02))
        c = sample_circuit(pkg)
        res = pkg.Simulator(**device_kw).run(c, shots=64, seed=5)
        cfg = mod.ExperimentConfig.from_current(c, nm, seed=5, shots=64,
                                                result=res)
        cfg.timestamp = "2024-01-01T00:00:00+00:00"
        cfg.analysis = {"z": np.float32(0.5), "amp": 1 + 2j,
                        "vec": np.arange(3)}
        return cfg

    tcfg = snapshot(tq, texperiment, {"device": "cpu"})
    jcfg = snapshot(jq, jexperiment, {})
    # same seed, same NumPy multinomial: the counts are equal too
    assert tcfg.to_json() == jcfg.to_json()
    data = json.loads(tcfg.to_json())
    assert data["results"]["num_shots"] == 64
    assert data["analysis"]["amp"] == {"re": 1.0, "im": 2.0}
    path = tmp_path / "sub" / "exp.json"
    tcfg.save(path)
    back = texperiment.ExperimentConfig.load(path)
    assert back.circuit == tcfg.circuit and back.seed == 5
    assert jexperiment.ExperimentConfig.load(path).circuit == tcfg.circuit
    raw = texperiment.ExperimentConfig.from_current(
        sample_circuit(tq), result={"custom": 1})
    assert raw.results == {"custom": 1} and raw.noise_model is None
    with pytest.raises(TypeError):
        texperiment.ExperimentConfig(metadata={"x": object()}).to_json()


def test_app_config_matches_jax(tmp_path):
    tcfg = tappconfig.AppConfig(_config_dir=tmp_path / "t")
    jcfg = jappconfig.AppConfig(_config_dir=tmp_path / "j")
    for cfg in (tcfg, jcfg):
        cfg.theme = "light"
        cfg.default_qubits = 6
        for i in range(13):
            cfg.add_recent_file(f"circuits/f{i}.qsim")
        cfg.add_recent_file("circuits/f5.qsim")          # moves to the front
        cfg.save()
    assert tcfg.to_dict() == jcfg.to_dict()
    assert len(tcfg.recent_files) == 10
    assert tcfg.recent_files[0] == "circuits/f5.qsim"
    assert tcfg.config_path.read_text() == jcfg.config_path.read_text()

    raw = json.loads(tcfg.config_path.read_text())
    assert raw["theme"] == "light" and "_config_dir" not in raw
    defaults = {f.name: getattr(tappconfig.AppConfig(), f.name)
                for f in dataclasses.fields(tappconfig.AppConfig)
                if not f.name.startswith("_")}
    jdefaults = {f.name: getattr(jappconfig.AppConfig(), f.name)
                 for f in dataclasses.fields(jappconfig.AppConfig)
                 if not f.name.startswith("_")}
    assert defaults == jdefaults


def test_app_config_load_is_tolerant(tmp_path, monkeypatch):
    monkeypatch.setattr(tappconfig.Path, "home",
                        staticmethod(lambda: tmp_path))
    assert tappconfig.AppConfig.load().theme == "dark"      # no file
    cfg = tappconfig.AppConfig()
    cfg.theme = "light"
    cfg.step_delay_ms = 250
    cfg.save()
    loaded = tappconfig.AppConfig.load()
    assert (loaded.theme, loaded.step_delay_ms) == ("light", 250)
    cfg.config_path.write_text("{not json", encoding="utf-8")
    assert tappconfig.AppConfig.load().theme == "dark"
    cfg.config_path.write_text(json.dumps({"theme": "x", "unknown": 1}),
                               encoding="utf-8")
    loaded = tappconfig.AppConfig.load()
    assert loaded.theme == "x" and not hasattr(loaded, "unknown")


def test_time_compiled_and_trace(tmp_path):
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    x = torch.ones(8)
    res = tprofiling.time_compiled(fn, x, 2.0, repeats=4)
    assert isinstance(res, tprofiling.TimingResult)
    assert res.repeats == 4 and len(calls) == 5          # one warm-up
    assert 0 <= res.best_s <= res.mean_s
    assert res.mean_ms == pytest.approx(res.mean_s * 1000)
    chained = tprofiling.time_compiled(
        fn, x, 2.0, repeats=3, chain=lambda out, args: (out, args[1]))
    assert chained.repeats == 3
    # the result type is the JAX package's, field for field
    jres = jprofiling.TimingResult(mean_s=0.5, best_s=0.25, repeats=2)
    tres = tprofiling.TimingResult(mean_s=0.5, best_s=0.25, repeats=2)
    assert (tres.mean_ms, tres.best_s, tres.repeats) == \
        (jres.mean_ms, jres.best_s, jres.repeats)
    logdir = tmp_path / "trace"
    with tprofiling.trace(str(logdir)) as prof:
        torch.ones(16).square().sum()
    assert (logdir / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_package_exports_match_the_jax_package():
    for name in ("DensityMatrixResult", "DensityMatrixSimulator",
                 "LindbladResult", "LindbladSimulator", "from_qasm",
                 "to_qasm"):
        assert name in tq.__all__ and name in jq.__all__
        assert hasattr(tq, name)
    circuit = brickwork_circuit(3, 2, seed=0)
    assert tq.from_qasm(tq.to_qasm(circuit)).gate_count() == \
        circuit.gate_count()
