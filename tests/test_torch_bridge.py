"""The port's Live Bridge against the JAX package's, on the CPU.

Mirrors ``tests/test_bridge.py``. The port's server runs with
``BridgeCommandHandler(device="cpu")`` behind a real localhost socket
(``port=0``, a client timeout, so a hang fails a test instead of eating
the suite's limit); the JAX handler answers the same requests directly.

- Deterministic commands and every error message: the same response
  (the whole JSON message, or its ``data``) from both packages.
- States and analysis: within 1e-5 (complex64 on both sides).
- Counts: by total variation distance <= 0.03 at 8192 shots; the two
  packages' random streams differ by design.
- Sweep fidelity and purity: against a NumPy density matrix of the noisy
  circuit, within five standard errors of the trajectory mean.
- The sweep-purity fault of the JAX package: its ``purity`` is the mean
  squared norm of renormalised trajectories (1 whatever the noise); the
  port's is tr(rho^2) of the same trajectory states, within 1e-5 of NumPy.
- A reply larger than a socket buffer reaches a slow reader whole (the
  JAX server drops the connection).
"""

import json
import socket
import time

import numpy as np
import pytest

from quantum_simulator_tpu import bridge as jb
from quantum_simulator_tpu.circuit import QuantumCircuit as JCircuit
from quantum_simulator_tpu_torch import bridge as tb
from quantum_simulator_tpu_torch import state as tstate
from quantum_simulator_tpu_torch.bridge.client import BridgeError
from quantum_simulator_tpu_torch.circuit import GateInstance, QuantumCircuit
from quantum_simulator_tpu_torch.models import brickwork_circuit
from quantum_simulator_tpu_torch.noise import DepolarizingNoise, NoiseModel
from quantum_simulator_tpu_torch.ops import bigstate
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.simulator import Simulator

STATE_TOL = 1e-5
TVD_TOL = 0.03
CLIENT_TIMEOUT = 60.0


@pytest.fixture
def server():
    srv = tb.BridgeServer(tb.BridgeCommandHandler(device="cpu"), port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def client(server):
    with tb.SimulatorClient(port=server.port, timeout=CLIENT_TIMEOUT) as c:
        yield c


class JaxSide:
    """The JAX handler, asked directly; replies go through JSON as the
    wire would carry them."""

    def __init__(self):
        self.handler = jb.BridgeCommandHandler()

    def message(self, action, params=None) -> dict:
        resp = self.handler.handle(jb.BridgeMessage(
            action=action, id="t", params=params or {}))
        return json.loads(resp.to_json())

    def __call__(self, action, params=None) -> dict:
        msg = self.message(action, params)
        assert msg["status"] == "ok", msg["error"]
        return msg["data"]


def port_message(handler, action, params=None) -> dict:
    return json.loads(handler.handle(tb.BridgeMessage(
        action=action, id="t", params=params or {})).to_json())


def bell_dict():
    c = QuantumCircuit(2)
    c.add_gate(GateInstance("H", [0], [], column=0))
    c.add_gate(GateInstance("CNOT", [0, 1], [], column=1))
    return c.to_dict()


def ghz_dict(n):
    gates = [{"name": "H", "targets": [0], "params": [], "column": 0}]
    gates += [{"name": "CNOT", "targets": [q, q + 1], "params": [],
               "column": q + 1} for q in range(n - 1)]
    return {"version": "1.0", "num_qubits": n, "gates": gates}


def mixed_dict(n=6, seed=3):
    """Ry/Rz brickwork with an X on qubit 1: a complex state whose every
    amplitude is nonzero."""
    c = brickwork_circuit(n, 6, seed=seed)
    for g in c.gates:
        if g.gate_name == "Ry" and g.target_qubits[0] % 2:
            g.gate_name = "Rz"
    for q in range(n):
        c.add_gate(GateInstance("H" if q % 2 else "Ry", [q],
                                [] if q % 2 else [0.3 + q], column=6))
    c.add_gate(GateInstance("X", [1], [], column=7))
    return c.to_dict()


def amps(payload) -> np.ndarray:
    return np.array([a["re"] + 1j * a["im"] for a in payload["amplitudes"]])


def tvd(a: dict, b: dict) -> float:
    na, nb = sum(a.values()), sum(b.values())
    return 0.5 * sum(abs(a.get(k, 0) / na - b.get(k, 0) / nb)
                     for k in set(a) | set(b))


def assert_close_tree(got, want, tol=STATE_TOL):
    """Nested dicts of floats equal within ``tol``, the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close_tree(got[k], want[k], tol)
    else:
        assert got == pytest.approx(want, abs=tol)


# ---------------------------------------------------------------------------
# Protocol and direct handler
# ---------------------------------------------------------------------------

class TestProtocol:
    def test_message_roundtrip(self):
        kw = dict(type="request", id="abc", action="run",
                  params={"shots": 10, "label": "ĝ"})
        msg, jmsg = tb.BridgeMessage(**kw), jb.BridgeMessage(**kw)
        assert msg.to_bytes() == jmsg.to_bytes()
        again = tb.BridgeMessage.from_json(jmsg.to_json())
        assert again.action == "run" and again.params == kw["params"]
        assert msg.to_bytes().endswith(b"\n")

    def test_response_constructors(self):
        for name, args in (("ok_response", ("id1", {"x": 1})),
                           ("ok_response", ("id1",)),
                           ("error_response", ("id1", "boom"))):
            got = getattr(tb.BridgeMessage, name)(*args)
            want = getattr(jb.BridgeMessage, name)(*args)
            assert got.to_json() == want.to_json()


# (setup actions, the request whose reply both packages must give)
ERROR_CASES = {
    "unknown_action": ([], ("bogus", {})),
    "run_without_circuit": ([], ("run", {})),
    "get_circuit_without_circuit": ([], ("get_circuit", {})),
    "add_gate_without_circuit": ([], ("add_gate", {"gate_name": "X"})),
    "clear_without_circuit": ([], ("clear_circuit", {})),
    "sweep_without_circuit": ([], ("sweep_parameter", {})),
    "set_circuit_missing_param": ([], ("set_circuit", {})),
    "set_noise_missing_param": ([], ("set_noise", {})),
    "get_state_without_result": ([], ("get_state", {})),
    "get_result_without_result": ([], ("get_result", {})),
    "analysis_without_result": ([], ("get_analysis", {})),
    "unknown_engine": ([("set_circuit", {"circuit": bell_dict()})],
                       ("run", {"shots": 10, "engine": "tn-9000"})),
    "window_offset_out_of_range": (
        [("set_circuit", {"circuit": bell_dict()}), ("run", {"shots": 0})],
        ("get_state", {"offset": 99})),
    "negative_window_offset": (
        [("set_circuit", {"circuit": bell_dict()}), ("run", {"shots": 0})],
        ("get_state", {"offset": -1, "length": 2})),
    "state_after_mps_run": (
        [("set_circuit", {"circuit": bell_dict()}),
         ("run", {"shots": 8, "engine": "mps", "chi": 2, "seed": 1})],
        ("get_state", {})),
    "analysis_after_mps_run": (
        [("set_circuit", {"circuit": bell_dict()}),
         ("run", {"shots": 8, "engine": "mps", "chi": 2, "seed": 1})],
        ("get_analysis", {})),
    "result_after_circuit_change": (
        [("set_circuit", {"circuit": bell_dict()}), ("run", {"shots": 4}),
         ("add_gate", {"gate_name": "X", "target_qubits": [0],
                       "column": 3})],
        ("get_result", {})),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_replies_equal_jax(case):
    setup, (action, params) = ERROR_CASES[case]
    jax = JaxSide()
    port = tb.BridgeCommandHandler(device="cpu")
    for a, p in setup:
        jax(a, p)
        assert port_message(port, a, p)["status"] == "ok"
    got = port_message(port, action, params)
    want = jax.message(action, params)
    assert got["status"] == "error"
    assert got == want


def test_handler_defaults_to_the_configured_device(monkeypatch):
    """No device given means ``CONFIG.device``; a CUDA default is pinned
    to an index, and without a card that raises instead of falling back
    to the CPU."""
    from quantum_simulator_tpu_torch import config

    monkeypatch.setattr(config.CONFIG, "device", "cpu")
    assert tb.BridgeCommandHandler().device.type == "cpu"
    monkeypatch.setattr(config.CONFIG, "device", "cuda")
    if not config.torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tb.BridgeCommandHandler()


# ---------------------------------------------------------------------------
# Over the socket
# ---------------------------------------------------------------------------

class TestOverSocket:
    def test_ping(self, client):
        assert client.ping() is True
        assert JaxSide()("ping") == {"pong": True}

    def test_full_session(self, client):
        jax = JaxSide()
        info = client.set_circuit(bell_dict())
        assert info == jax("set_circuit", {"circuit": bell_dict()})
        assert info == {"num_qubits": 2, "gate_count": 2}

        result = client.run(shots=8192, seed=42)
        want = jax("run", {"shots": 8192, "seed": 42})
        assert sum(result["measurement_counts"].values()) == 8192
        assert set(result["measurement_counts"]) <= {"00", "11"}
        assert tvd(result["measurement_counts"],
                   want["measurement_counts"]) <= TVD_TOL
        assert (result["num_shots"], result["seed"]) == (8192, 42)

        state = client.get_state()
        jstate = jax("get_state")
        assert set(state) == set(jstate) == {"num_qubits", "amplitudes",
                                             "probabilities"}
        assert state["num_qubits"] == 2
        assert np.abs(amps(state) - amps(jstate)).max() <= STATE_TOL
        assert np.allclose(state["probabilities"], jstate["probabilities"],
                           atol=STATE_TOL, rtol=0)

        assert client.get_result() == result
        metrics = ["fidelity", "entropy", "purity"]
        analysis = client.get_analysis(metrics)
        assert_close_tree(analysis, jax("get_analysis",
                                        {"metrics": metrics}))
        assert analysis["fidelity"] == pytest.approx(1.0, abs=1e-5)

    def test_add_and_clear_gate(self, client):
        jax = JaxSide()
        steps = [("set_circuit", {"circuit": bell_dict()}),
                 ("add_gate", {"gate_name": "X", "target_qubits": [1],
                               "params": [], "column": 2}),
                 ("add_gate", {"gate_name": "Rz", "target_qubits": [0],
                               "params": [0.25], "column": 3}),
                 ("get_circuit", {}), ("clear_circuit", {}),
                 ("get_circuit", {})]
        for action, params in steps:
            assert client._send_request(action, params) == jax(action,
                                                               params)
        assert client.get_circuit()["gates"] == []

    def test_noise_session(self, client):
        jax = JaxSide()
        client.set_circuit(bell_dict())
        noise = {"global": [{"type": "DepolarizingNoise",
                             "probability": 0.1}],
                 "readout_error": {"p0_given_1": 0.02, "p1_given_0": 0.01}}
        assert client.set_noise(noise) == jax("set_noise",
                                              {"noise_model": noise}) == {}
        result = client.run(shots=200, seed=1)
        assert sum(result["measurement_counts"].values()) == 200
        assert result["num_shots"] == 200
        # a noisy run keeps no fidelity reference
        assert "fidelity" not in client.get_analysis(["fidelity"])
        assert client.clear_noise() == jax("clear_noise") == {}

    def test_pauli_analysis(self, client):
        jax = JaxSide()
        circuit = mixed_dict(5)
        client.set_circuit(circuit)
        jax("set_circuit", {"circuit": circuit})
        client.run(shots=0, seed=1)
        jax("run", {"shots": 0, "seed": 1})
        metrics = ["fidelity", "entropy", "purity", "pauli"]
        got = client.get_analysis(metrics)
        assert_close_tree(got, jax("get_analysis", {"metrics": metrics}))
        assert set(got["pauli"]) == {f"q{q}" for q in range(5)}

    def test_error_propagates_to_client(self, client):
        with pytest.raises(BridgeError, match="No simulation result"):
            client.get_result()  # no run yet
        with pytest.raises(BridgeError, match="Unknown action: bogus"):
            client._send_request("bogus")
        assert client.ping()  # the server lives on

    def test_two_clients(self, server):
        with tb.SimulatorClient(port=server.port,
                                timeout=CLIENT_TIMEOUT) as c1, \
                tb.SimulatorClient(port=server.port,
                                   timeout=CLIENT_TIMEOUT) as c2:
            assert c1.ping() and c2.ping()
            c1.set_circuit(bell_dict())
            # shared handler state: c2 sees c1's circuit
            assert len(c2.get_circuit()["gates"]) == 2


class TestChunkedState:
    """get_state windows: sliced on the device, only the window copied."""

    @pytest.fixture
    def session(self, client):
        jax = JaxSide()
        circuit = mixed_dict(6)
        client.set_circuit(circuit)
        client.run(shots=0, seed=1)
        jax("set_circuit", {"circuit": circuit})
        jax("run", {"shots": 0, "seed": 1})
        return client, jax

    @pytest.mark.parametrize("offset,length", [(0, 5), (17, 16), (60, 100),
                                               (63, None), (0, 0)])
    def test_window_fetch(self, session, offset, length):
        client, jax = session
        params = {"offset": offset}
        if length is not None:
            params["length"] = length
        win = client.get_state(offset=offset, length=length)
        want = jax("get_state", params)
        assert (win["total"], win["offset"], win["num_qubits"]) == (
            want["total"], want["offset"], want["num_qubits"]) == (
            64, offset, 6)
        assert len(win["amplitudes"]) == len(want["amplitudes"])
        if want["amplitudes"]:
            assert np.abs(amps(win) - amps(want)).max() <= STATE_TOL
            assert np.allclose(win["probabilities"], want["probabilities"],
                               atol=STATE_TOL, rtol=0)

    def test_iter_state_windows_reassembles(self, session):
        client, _ = session
        full = client.get_state()["amplitudes"]
        parts = []
        for off, window in client.iter_state_windows(window=7):
            assert off == len(parts)
            parts.extend(window)
        assert parts == full

    def test_window_never_copies_the_whole_state(self, monkeypatch,
                                                 session):
        client, jax = session
        want = jax("get_state", {"offset": 8, "length": 8})

        def whole_copy(self):
            raise AssertionError("a window copied the whole state")

        monkeypatch.setattr(tstate.StateVector, "data",
                            property(whole_copy))
        win = client.get_state(offset=8, length=8)
        assert np.abs(amps(win) - amps(want)).max() <= STATE_TOL
        with pytest.raises(BridgeError, match="copied the whole state"):
            client.get_state()  # the spy does catch a whole copy

    def test_large_state_route_answers_an_error(self, monkeypatch, client):
        """Like the JAX handler at n >= 30: a planar large-state result has
        no flat ``device_data``, so a window is an error reply."""
        monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 8)
        client.set_circuit(ghz_dict(8))
        client.run(shots=16, seed=1)
        with pytest.raises(BridgeError, match="device_data"):
            client.get_state(offset=0, length=4)
        assert client.ping()


class TestMPSEngineOverBridge:
    def test_wide_circuit_runs_on_mps_engine(self, client):
        # GHZ-40 over the wire: no dense state exists anywhere, yet the
        # bridge serves counts (+ the truncation ledger).
        n = 40
        jax = JaxSide()
        client.set_circuit(ghz_dict(n))
        jax("set_circuit", {"circuit": ghz_dict(n)})
        result = client.run(shots=200, seed=3, engine="mps", chi=4)
        want = jax("run", {"shots": 200, "seed": 3, "engine": "mps",
                           "chi": 4})
        counts = result["measurement_counts"]
        assert set(counts) <= {"0" * n, "1" * n}
        assert sum(counts.values()) == 200
        assert min(counts.values()) > 50
        del result["measurement_counts"], want["measurement_counts"]
        assert result == want == {"num_shots": 200, "seed": 3,
                                  "engine": "mps", "truncation_weight": 0.0}
        assert client.get_result()["num_shots"] == 200


# ---------------------------------------------------------------------------
# sweep_parameter
# ---------------------------------------------------------------------------

def _kraus_apply(rho, kraus, targets, n):
    """sum_K K rho K^+ with each K on ``targets`` (qubit 0 = MSB)."""
    k = len(targets)
    cols = [n + q for q in targets]
    t = rho.reshape((2,) * (2 * n))
    out = np.zeros_like(t)
    for K in kraus:
        g = np.asarray(K, np.complex128).reshape((2,) * (2 * k))
        a = np.tensordot(g, t, axes=(list(range(k, 2 * k)), targets))
        a = np.moveaxis(a, list(range(k)), targets)
        a = np.tensordot(a, g.conj(), axes=(cols, list(range(k, 2 * k))))
        out += np.moveaxis(a, list(range(2 * n - k, 2 * n)), cols)
    return out.reshape(rho.shape)


def numpy_noisy_rho(circuit: QuantumCircuit, p: float) -> np.ndarray:
    """rho of the circuit with depolarizing p after every gate on each of
    its qubits, in NumPy complex128 (Kraus sums gate by gate)."""
    n = circuit.num_qubits
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]]),
              np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
    kraus = [np.sqrt(1 - p) * paulis[0]] + [np.sqrt(p / 3) * s
                                            for s in paulis[1:]]
    program = tprog.compile_circuit(circuit)
    rho = np.zeros((1 << n, 1 << n), np.complex128)
    rho[program.initial_index, program.initial_index] = 1.0
    for op in program.ops:
        u = program.op_matrix(op, program.initial_params, np.complex128)
        rho = _kraus_apply(rho, [u], list(op.targets), n)
        for q in op.targets:
            rho = _kraus_apply(rho, kraus, [q], n)
    return rho


def test_sweep_fidelity_and_purity_follow_the_density_matrix(client):
    """GHZ-3: each point's mean fidelity estimates <ideal|rho|ideal> and
    its purity tr(rho^2) (plus the 1/T weight of the t = s terms); both
    within five standard errors of the T-trajectory mean."""
    trials = 1024
    client.set_circuit(ghz_dict(3))
    sweep = client.sweep_parameter("noise_p", [0.0, 0.05, 0.2],
                                   trials=trials, seed=7)["sweep"]
    assert sweep[0] == {"value": 0.0, "fidelity": 1.0, "purity": 1.0}
    circuit = QuantumCircuit.from_dict(ghz_dict(3))
    ideal = np.zeros(8, np.complex128)
    ideal[0] = ideal[7] = 2 ** -0.5
    for point, p in zip(sweep[1:], (0.05, 0.2)):
        rho = numpy_noisy_rho(circuit, p)
        fid = float(np.real(ideal.conj() @ rho @ ideal))
        pur = float(np.real(np.trace(rho @ rho)))
        assert point["trials"] == trials and point["value"] == p
        assert point["fidelity"] == pytest.approx(
            fid, abs=5 * 0.5 / np.sqrt(trials))
        assert point["purity"] == pytest.approx(
            pur + (1 - pur) / trials, abs=5 * 0.5 / np.sqrt(trials))
    assert 1.0 > sweep[1]["fidelity"] > sweep[2]["fidelity"]


def test_sweep_purity_is_tr_rho_squared_where_jax_reads_one(client):
    """The JAX sweep's ``purity`` is the mean squared norm of renormalised
    trajectories: 1 at any noise. The port's equals NumPy's tr(rho^2) of
    the same trajectory states (re-run from the sweep's seed stream)."""
    seed, trials, p = 42, 64, 0.2
    params = {"param": "noise_p", "values": [0.0, p], "trials": trials,
              "seed": seed, "shots": 0}
    jax = JaxSide()
    jax("set_circuit", {"circuit": ghz_dict(3)})
    jpoint = jax("sweep_parameter", params)["sweep"][1]
    assert jpoint["purity"] == pytest.approx(1.0, abs=1e-5)

    client.set_circuit(ghz_dict(3))
    point = client.sweep_parameter(**{k: v for k, v in params.items()
                                      if k != "shots"})["sweep"][1]
    rng = np.random.default_rng(seed)
    rng.integers(0, 2**63)                     # the ideal run's draw
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(p))
    states = Simulator(noise_model=nm, device="cpu").trajectory_states(
        QuantumCircuit.from_dict(ghz_dict(3)), trials,
        seed=int(rng.integers(0, 2**63))).numpy().astype(np.complex128)
    rho = states.T @ states.conj() / trials
    purity = float(np.real(np.trace(rho @ rho)))
    assert point["purity"] == pytest.approx(purity, abs=1e-5)
    assert point["purity"] < 0.5
    fid = float(np.mean(np.abs(states[:, [0, 7]].sum(1)) ** 2 / 2))
    assert point["fidelity"] == pytest.approx(fid, abs=1e-5)


# ---------------------------------------------------------------------------
# Socket framing
# ---------------------------------------------------------------------------

def blob_handler(mod, **kw):
    """A handler whose ``blob`` reply (20 MiB) is larger than the
    operating system's socket buffers."""

    class BlobHandler(mod.BridgeCommandHandler):
        def _cmd_blob(self, msg):
            return mod.BridgeMessage.ok_response(msg.id,
                                                 {"blob": "x" * (20 << 20)})

    return BlobHandler(**kw)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_large_reply_reaches_a_slow_reader(pkg):
    """The JAX server sends on a non-blocking connection, so a reply the
    socket buffers cannot hold fails part way and the server drops the
    client; the port's waits for the reader (``SEND_TIMEOUT_S``)."""
    mod = tb if pkg == "port" else jb
    handler = (blob_handler(tb, device="cpu") if pkg == "port"
               else blob_handler(jb))
    srv = mod.BridgeServer(handler, port=0)
    srv.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=CLIENT_TIMEOUT) as s:
            s.sendall(mod.BridgeMessage(action="blob", id="b").to_bytes())
            time.sleep(1.0)           # a reader that comes late
            buf = b""
            while b"\n" not in buf:
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
    finally:
        srv.stop()
    if pkg == "port":
        assert json.loads(buf)["data"]["blob"] == "x" * (20 << 20)
    else:
        assert b"\n" not in buf and len(buf) < (20 << 20)


def test_jax_circuit_dict_runs_on_the_port(client):
    """A circuit the JAX package built and serialised runs on the port's
    bridge to the same state."""
    jc = JCircuit(3)
    jc.add("H", [0], [], 0)
    jc.add("CNOT", [0, 2], [], 1)
    jc.add("Rz", [1], [0.4], 1)
    jax = JaxSide()
    assert client.set_circuit(jc.to_dict()) == jax(
        "set_circuit", {"circuit": jc.to_dict()})
    client.run(shots=0)
    jax("run", {"shots": 0})
    assert np.abs(amps(client.get_state())
                  - amps(jax("get_state"))).max() <= STATE_TOL
