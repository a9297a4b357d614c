"""Synchronous Live Bridge client.

A copy of ``quantum_simulator_tpu/bridge/client.py``: a context-manager
client with uuid request correlation and one method per server command
(all 12), plus ``iter_state_windows`` for large states.
"""

from __future__ import annotations

import socket
import uuid

from .protocol import DEFAULT_HOST, DEFAULT_PORT, BridgeMessage


class BridgeError(RuntimeError):
    """Raised when the server returns an error response."""


class SimulatorClient:
    """Blocking request/response client for the Live Bridge."""

    def __init__(self, host: str = DEFAULT_HOST, port: int = DEFAULT_PORT,
                 timeout: float = 30.0):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._sock: socket.socket | None = None
        self._buffer = b""

    def connect(self) -> None:
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "SimulatorClient":
        self.connect()
        return self

    def __exit__(self, *args) -> None:
        self.close()

    def _send_request(self, action: str,
                      params: dict | None = None) -> dict:
        if self._sock is None:
            raise RuntimeError("Client not connected; call connect()")
        request = BridgeMessage(type="request", id=str(uuid.uuid4()),
                                action=action, params=params or {})
        self._sock.sendall(request.to_bytes())
        while b"\n" not in self._buffer:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("Server closed connection")
            self._buffer += chunk
        line, self._buffer = self._buffer.split(b"\n", 1)
        response = BridgeMessage.from_json(line.decode("utf-8"))
        if response.status == "error":
            raise BridgeError(response.error)
        return response.data

    # -- high-level API (one method per server command) --

    def ping(self) -> bool:
        return bool(self._send_request("ping").get("pong"))

    def set_circuit(self, circuit_dict: dict) -> dict:
        return self._send_request("set_circuit", {"circuit": circuit_dict})

    def get_circuit(self) -> dict:
        return self._send_request("get_circuit")

    def add_gate(self, gate_name: str, target_qubits: list[int],
                 params: list[float] | None = None, column: int = 0) -> dict:
        return self._send_request("add_gate", {
            "gate_name": gate_name,
            "target_qubits": target_qubits,
            "params": params or [],
            "column": column,
        })

    def clear_circuit(self) -> dict:
        return self._send_request("clear_circuit")

    def run(self, shots: int = 1024, seed: int | None = None,
            engine: str | None = None, chi: int | None = None) -> dict:
        """``engine="mps"`` (+ optional ``chi``) runs wide circuits on
        the server's MPS engine — counts plus a truncation-weight
        ledger, no dense state."""
        params: dict = {"shots": shots}
        if seed is not None:
            params["seed"] = seed
        if engine is not None:
            params["engine"] = engine
        if chi is not None:
            params["chi"] = chi
        return self._send_request("run", params)

    def get_state(self, offset: int | None = None,
                  length: int | None = None) -> dict:
        """Full state by default; pass offset/length for a window of a
        large state (see the server's chunked get_state extension)."""
        params = {}
        if offset is not None:
            params["offset"] = offset
        if length is not None:
            params["length"] = length
        return self._send_request("get_state", params or None)

    def iter_state_windows(self, window: int = 65536):
        """Yield (offset, amplitudes) windows until the state is
        exhausted — streaming fetch for n > 20 states whose single-line
        JSON payload would be impractical."""
        offset = 0
        while True:
            data = self.get_state(offset=offset, length=window)
            yield offset, data["amplitudes"]
            offset += len(data["amplitudes"])
            if offset >= data["total"] or not data["amplitudes"]:
                return

    def get_result(self) -> dict:
        return self._send_request("get_result")

    def set_noise(self, noise_dict: dict) -> dict:
        return self._send_request("set_noise", {"noise_model": noise_dict})

    def clear_noise(self) -> dict:
        return self._send_request("clear_noise")

    def get_analysis(self, metrics: list[str] | None = None) -> dict:
        params = {"metrics": metrics} if metrics else {}
        return self._send_request("get_analysis", params)

    def sweep_parameter(self, param: str, values: list[float],
                        shots: int = 0, seed: int | None = None,
                        trials: int = 50) -> dict:
        return self._send_request("sweep_parameter", {
            "param": param,
            "values": values,
            "shots": shots,
            "seed": seed,
            "trials": trials,
        })
