"""Qt GUI layer of the port (requires PyQt6; all logic lives in the
toolkit-free viewmodels/controllers, so the GUI is a thin rendering
shell).

Counterpart of ``quantum_simulator_tpu/gui``: the same widgets over the
port's engine. Every engine a widget builds runs on the device the widget
was given (``MainWindow(device=...)``, default ``CONFIG.device``, the
card); nothing falls back to the host.

Import is gated: ``HAS_QT`` reports availability and importing widgets
without PyQt6 raises a clear error; the engine, bridge and command-line
twins stay fully usable headless.
"""

from __future__ import annotations

try:
    import PyQt6  # noqa: F401

    HAS_QT = True
except ImportError:  # pragma: no cover - environment without Qt
    HAS_QT = False

__all__ = ["HAS_QT"]
