"""Live Bridge: JSON-over-TCP control API for external scripts."""

from .client import SimulatorClient
from .protocol import DEFAULT_HOST, DEFAULT_PORT, BridgeMessage
from .server import BridgeCommandHandler, BridgeServer

__all__ = [
    "BridgeCommandHandler",
    "BridgeMessage",
    "BridgeServer",
    "DEFAULT_HOST",
    "DEFAULT_PORT",
    "SimulatorClient",
]
