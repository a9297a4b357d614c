"""Newline-delimited JSON message protocol for the Live Bridge.

A copy of ``quantum_simulator_tpu/bridge/protocol.py``: the same wire
format ({type, id, action, params, status, data, error}, newline-terminated
UTF-8 JSON) and ok/error response constructors, so a client of either
package talks to a server of either.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

DEFAULT_HOST = "127.0.0.1"
DEFAULT_PORT = 9876


@dataclass
class BridgeMessage:
    """One protocol message (request or response)."""

    type: str = "request"
    id: str = ""
    action: str = ""
    params: dict = field(default_factory=dict)
    status: str = ""
    data: dict = field(default_factory=dict)
    error: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), ensure_ascii=False)

    def to_bytes(self) -> bytes:
        return (self.to_json() + "\n").encode("utf-8")

    @classmethod
    def from_json(cls, raw: str) -> "BridgeMessage":
        d = json.loads(raw.strip())
        return cls(
            type=d.get("type", "request"),
            id=d.get("id", ""),
            action=d.get("action", ""),
            params=d.get("params", {}),
            status=d.get("status", ""),
            data=d.get("data", {}),
            error=d.get("error", ""),
        )

    @classmethod
    def ok_response(cls, request_id: str,
                    data: dict | None = None) -> "BridgeMessage":
        return cls(type="response", id=request_id, status="ok",
                   data=data or {})

    @classmethod
    def error_response(cls, request_id: str, error: str) -> "BridgeMessage":
        return cls(type="response", id=request_id, status="error",
                   error=error)
