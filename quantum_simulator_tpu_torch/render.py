"""Circuit diagram rendering and PNG/SVG export (headless matplotlib).

A copy of ``quantum_simulator_tpu/render.py`` over the port's circuit,
gate types and registry: wires with per-qubit initial-state kets, gate
boxes using the registry's symbols/colors, control dots, CNOT ⊕ targets,
CZ boxes, SWAP crosses, measurement meters, dashed barriers. It draws no
state, so nothing here touches the device.
"""

from __future__ import annotations

from pathlib import Path

import matplotlib

matplotlib.use("Agg", force=False)

import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Circle, FancyBboxPatch  # noqa: E402

from .circuit import QuantumCircuit  # noqa: E402
from .gates import GateType  # noqa: E402
from .registry import GateRegistry  # noqa: E402

COL_W = 1.0
ROW_H = 1.0
GATE_W = 0.62
GATE_H = 0.62


class CircuitRenderer:
    """Draws a QuantumCircuit onto a matplotlib Axes."""

    def __init__(self, theme: str = "dark"):
        self._registry = GateRegistry.instance()
        if theme == "dark":
            self.bg = "#1e1e2e"
            self.wire = "#9399b2"
            self.text = "#cdd6f4"
        else:
            self.bg = "#ffffff"
            self.wire = "#4c4f69"
            self.text = "#1e1e2e"

    def figure(self, circuit: QuantumCircuit):
        n = circuit.num_qubits
        cols = max(1, circuit.get_column_count())
        fig_w = 1.6 + cols * COL_W * 0.6
        fig_h = 0.6 + n * ROW_H * 0.5
        fig, ax = plt.subplots(figsize=(fig_w, fig_h))
        fig.patch.set_facecolor(self.bg)
        ax.set_facecolor(self.bg)
        self.draw(ax, circuit)
        return fig

    def draw(self, ax, circuit: QuantumCircuit) -> None:
        n = circuit.num_qubits
        cols = max(1, circuit.get_column_count())
        ax.set_xlim(-1.4, cols * COL_W + 0.4)
        ax.set_ylim(-(n - 0.4) * ROW_H - 0.6 * ROW_H, ROW_H * 0.6)
        ax.set_aspect("equal")
        ax.axis("off")

        # Wires + labels
        for q in range(n):
            y = -q * ROW_H
            ax.plot([-0.4, cols * COL_W + 0.2], [y, y],
                    color=self.wire, lw=1.2, zorder=1)
            ket = circuit.initial_states[q] if q < len(
                circuit.initial_states) else 0
            ax.text(-0.6, y, f"q{q}: |{ket}⟩", ha="right", va="center",
                    color=self.text, fontsize=9, family="monospace")

        for gate in circuit.gates:
            self._draw_gate(ax, gate)

    def _draw_gate(self, ax, gate) -> None:
        try:
            gd = self._registry.get(gate.gate_name)
        except KeyError:
            return
        x = gate.column * COL_W + 0.5 * COL_W
        ys = [-q * ROW_H for q in gate.target_qubits]

        if gd.gate_type == GateType.BARRIER:
            y = ys[0]
            ax.plot([x, x], [y - 0.4, y + 0.4], color=self.wire,
                    lw=1.5, ls="--", zorder=2)
            return

        if gd.gate_type == GateType.MEASUREMENT:
            self._box(ax, x, ys[0], "#FFC107", "M")
            return

        if gd.gate_type == GateType.SINGLE:
            label = gd.symbol
            if gate.params:
                label += f"\n{gate.params[0]:.2f}"
            self._box(ax, x, ys[0], gd.color, label)
            return

        # Multi-qubit: vertical connector spanning all targets
        ax.plot([x, x], [min(ys), max(ys)], color=gd.color, lw=1.8,
                zorder=2)
        n_ctrl = gd.num_controls
        controls = gate.target_qubits[:n_ctrl]
        targets = gate.target_qubits[n_ctrl:]

        for q in controls:
            ax.add_patch(Circle((x, -q * ROW_H), 0.09, color=gd.color,
                                zorder=3))

        if gate.gate_name == "CNOT" or gate.gate_name == "Toffoli":
            for q in targets:
                y = -q * ROW_H
                ax.add_patch(Circle((x, y), 0.22, fill=False,
                                    color=gd.color, lw=1.8, zorder=3))
                ax.plot([x - 0.22, x + 0.22], [y, y], color=gd.color,
                        lw=1.8, zorder=3)
                ax.plot([x, x], [y - 0.22, y + 0.22], color=gd.color,
                        lw=1.8, zorder=3)
        elif gate.gate_name == "SWAP" or gate.gate_name == "Fredkin":
            swap_qubits = (gate.target_qubits if gate.gate_name == "SWAP"
                           else targets)
            for q in swap_qubits:
                y = -q * ROW_H
                d = 0.16
                ax.plot([x - d, x + d], [y - d, y + d], color=gd.color,
                        lw=1.8, zorder=3)
                ax.plot([x - d, x + d], [y + d, y - d], color=gd.color,
                        lw=1.8, zorder=3)
        else:
            # CZ / CPhase / MCZ / generic controlled box on target
            for q in targets:
                label = gd.symbol
                if gate.params:
                    label += f"\n{gate.params[0]:.2f}"
                self._box(ax, x, -q * ROW_H, gd.color, label)

    def _box(self, ax, x: float, y: float, color: str, label: str) -> None:
        ax.add_patch(FancyBboxPatch(
            (x - GATE_W / 2, y - GATE_H / 2), GATE_W, GATE_H,
            boxstyle="round,pad=0.02,rounding_size=0.08",
            facecolor=color, edgecolor="none", zorder=3))
        ax.text(x, y, label, ha="center", va="center", color="white",
                fontsize=8, weight="bold", zorder=4)


class CircuitExporter:
    """PNG/SVG export of circuit diagrams (reference API shape, headless)."""

    @staticmethod
    def export_png(circuit: QuantumCircuit, filepath: str | Path,
                   scale: float = 2.0, theme: str = "dark") -> None:
        fig = CircuitRenderer(theme).figure(circuit)
        fig.savefig(str(filepath), dpi=int(100 * scale),
                    bbox_inches="tight",
                    facecolor=fig.get_facecolor())
        plt.close(fig)

    @staticmethod
    def export_svg(circuit: QuantumCircuit, filepath: str | Path,
                   theme: str = "dark") -> None:
        fig = CircuitRenderer(theme).figure(circuit)
        fig.savefig(str(filepath), format="svg", bbox_inches="tight",
                    facecolor=fig.get_facecolor())
        plt.close(fig)
