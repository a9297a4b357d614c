"""GUI application entry point of the port.

The port's twin of the repository's ``main.py``: a QApplication with the
theme from the persisted config and a ``MainWindow`` whose every engine
runs on ``--device`` (default the port's ``CONFIG.device``, the card).
Without PyQt6 it prints the headless alternatives and returns 1; without
a card it returns 1 before it builds a window, unless the caller names
the host (``--device cpu``).

Usage:
    python -m quantum_simulator_tpu_torch.main [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from .utils.cli import add_device_argument, open_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Quantum simulator GUI (PyTorch / CUDA port)")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from .gui import HAS_QT

    if not HAS_QT:
        print("PyQt6 is not installed; the GUI is unavailable.\n"
              "Headless alternatives:\n"
              "  python -m quantum_simulator_tpu_torch.scripts.noise_sweep "
              "--circuit bell\n"
              "  python -m quantum_simulator_tpu_torch.scripts.vqe_benchmark "
              "--qubits 4\n"
              "  python -m quantum_simulator_tpu_torch.scripts.qec_threshold "
              "--codes bit_flip,steane\n"
              "  python -c 'from quantum_simulator_tpu_torch.bridge import "
              "BridgeServer; BridgeServer().start(); input()'  "
              "# TCP control API")
        return 1
    device = open_device(args.device, "main")
    if device is None:
        return 1

    from PyQt6.QtWidgets import QApplication

    from .gui.main_window import MainWindow
    from .gui.themes.theme_manager import ThemeManager
    from .utils.appconfig import AppConfig

    app = QApplication(sys.argv[:1])
    config = AppConfig.load()
    ThemeManager(config.theme).apply(app)
    window = MainWindow(config, device=device)
    window.show()
    return app.exec()


if __name__ == "__main__":
    raise SystemExit(main())
