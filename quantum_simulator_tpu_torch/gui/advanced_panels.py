"""Advanced Qt panels: debugger, comparison, optimizer, QEC (panels 9-12).

Counterpart of ``quantum_simulator_tpu/gui/advanced_panels.py``: thin
views over the port's CircuitDebugger / CircuitComparator /
CircuitOptimizer / QECSimulator / FrameQECSimulator; long-running work
goes through worker threads so the GUI stays responsive.

Each panel takes ``device=`` (default ``CONFIG.device``, the card) and
fixes its index where the panel is built (``config.pinned_device``): every
engine it builds runs there, and each worker thread makes that device
current before it works (``config.device_scope``), since a bare ``"cuda"``
names the calling thread's current device and every thread starts on
device 0.
"""

from __future__ import annotations

import threading

import numpy as np
from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
from matplotlib.figure import Figure
from PyQt6.QtCore import pyqtSignal
from PyQt6.QtWidgets import (
    QComboBox,
    QDoubleSpinBox,
    QHBoxLayout,
    QLabel,
    QPushButton,
    QSlider,
    QSpinBox,
    QTabWidget,
    QTableWidget,
    QTableWidgetItem,
    QVBoxLayout,
    QWidget,
)
from PyQt6.QtCore import Qt

from ..comparison import CircuitComparator
from ..config import device_scope, pinned_device
from ..debugger import CircuitDebugger
from ..optimizer import (
    CircuitOptimizer,
    CostFunction,
    MPSParameterizedConfig,
    ParameterizedCircuitConfig,
)
from ..qec import AVAILABLE_CODES, QECSimulator
from ..qec_frame import (
    FrameQECSimulator,
    frame_spec_from_code,
    repetition_frame_spec,
    surface_code_frame_spec,
)


def _start_worker(device, work) -> None:
    """Run ``work`` on a daemon thread with ``device`` current on it."""
    def run():
        with device_scope(device):
            work()

    threading.Thread(target=run, daemon=True).start()


class _Canvas(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._layout = QVBoxLayout(self)
        self.controls = QHBoxLayout()
        self._layout.addLayout(self.controls)
        self.figure = Figure(figsize=(5, 3))
        self.canvas = FigureCanvasQTAgg(self.figure)
        self._layout.addWidget(self.canvas)

    def axes(self):
        self.figure.clear()
        return self.figure.add_subplot(111)

    def redraw(self):
        self.canvas.draw_idle()


class DebuggerPanel(QWidget):
    """Timeline stepping with three sub-tabs — Error Trace (fidelity +
    entropy curves, breakpoint marks), State Inspector (amplitude table
    with ideal-vs-actual probability bars), Noise Heatmap (per-qubit
    fidelity drop with attribution % overlay). Every number comes from
    the headless ``CircuitDebugger`` (on ``device``) +
    ``DebuggerInspectorModel``."""

    def __init__(self, parent=None, device=None):
        super().__init__(parent)
        from ..viewmodels import DebuggerInspectorModel

        self._device = pinned_device(device)
        self._inspector = DebuggerInspectorModel
        self.debugger = CircuitDebugger(device=self._device)
        self._attribution = None
        self._impacts = []
        self.breakpoints: set[int] = set()
        self.debug_ready.connect(self._on_debug_ready)

        layout = QVBoxLayout(self)
        self.controls = QHBoxLayout()
        layout.addLayout(self.controls)
        self.trials_spin = QSpinBox()
        self.trials_spin.setRange(10, 500)
        self.trials_spin.setValue(50)
        self.slider = QSlider(Qt.Orientation.Horizontal)
        self.slider.valueChanged.connect(self._on_slider)
        back = QPushButton("◀")
        back.clicked.connect(lambda: self._step(-1))
        fwd = QPushButton("▶")
        fwd.clicked.connect(lambda: self._step(1))
        self.status = QLabel("")
        for w in (QLabel("Trials:"), self.trials_spin, back, fwd,
                  self.status):
            self.controls.addWidget(w)
        self.controls.addStretch(1)
        layout.addWidget(self.slider)

        self.tabs = QTabWidget()
        layout.addWidget(self.tabs)

        # Tab 1: error trace
        self._trace_fig = Figure(figsize=(5, 3))
        self._trace_canvas = FigureCanvasQTAgg(self._trace_fig)
        self.tabs.addTab(self._trace_canvas, "Error Trace")

        # Tab 2: state inspector (table + bars)
        inspector = QWidget()
        ibox = QVBoxLayout(inspector)
        self.amp_table = QTableWidget(0, 6)
        self.amp_table.setHorizontalHeaderLabels(
            ["basis", "re", "im", "P(actual)", "P(ideal)", "Δ"])
        ibox.addWidget(self.amp_table)
        self._bars_fig = Figure(figsize=(5, 2))
        self._bars_canvas = FigureCanvasQTAgg(self._bars_fig)
        ibox.addWidget(self._bars_canvas)
        self.tabs.addTab(inspector, "State Inspector")

        # Tab 3: per-qubit noise heatmap
        self._heat_fig = Figure(figsize=(5, 3))
        self._heat_canvas = FigureCanvasQTAgg(self._heat_fig)
        self.tabs.addTab(self._heat_canvas, "Noise Heatmap")

    debug_ready = pyqtSignal()

    def run_debug(self, circuit, noise_model=None, seed: int = 42,
                  block: bool = False) -> None:
        """Snapshot + attribution + impact runs happen on a worker
        thread (up to 2x500 Monte-Carlo trials would otherwise freeze
        the event loop); pass block=True for synchronous use in tests
        or scripts."""
        def work():
            self.debugger.run_full_debug(circuit, noise_model, seed=seed)
            if noise_model is not None:
                trials = self.trials_spin.value()
                self._attribution = self.debugger.compute_noise_attribution(
                    circuit, noise_model, n_trials=trials, seed=seed)
                self._impacts = self.debugger.compute_noise_impact(
                    circuit, noise_model, n_trials=trials, seed=seed)
            else:
                self._attribution = None
                self._impacts = []
            self.debug_ready.emit()

        if block:
            with device_scope(self._device):
                work()
            return
        _start_worker(self._device, work)

    def _on_debug_ready(self) -> None:
        self.slider.setMaximum(max(0, self.debugger.num_steps - 1))
        self._refresh()
        self._draw_heatmap()

    def _step(self, direction: int) -> None:
        if direction > 0:
            self.debugger.step_forward()
        else:
            self.debugger.step_backward()
        self.slider.setValue(self.debugger.position)

    def _on_slider(self, value: int) -> None:
        self.debugger.goto_step(value)
        self._refresh()

    def _refresh(self) -> None:
        snap = self.debugger.current_snapshot
        if snap is None:
            return
        self._draw_trace(snap)
        self._fill_inspector(snap)
        self.status.setText(
            f"col {snap.column_index}: F={snap.fidelity:.4f} "
            f"{' '.join(snap.gate_labels)}")

    def _draw_trace(self, snap) -> None:
        self._trace_fig.clear()
        ax = self._trace_fig.add_subplot(111)
        fids = [s.fidelity for s in self.debugger.snapshots]
        ents = [s.entropy for s in self.debugger.snapshots]
        cols = [s.column_index for s in self.debugger.snapshots]
        ax.plot(cols, fids, "-o", color="#89b4fa", label="fidelity")
        ax.plot(cols, ents, "-s", color="#a6e3a1", ms=3, label="entropy")
        ax.axvline(snap.column_index, color="#f38ba8", alpha=0.6)
        for bp in sorted(self.breakpoints):
            ax.axvline(bp, color="#f38ba8", ls="--", alpha=0.4, lw=1)
        if self._attribution is not None:
            pct = self._attribution.column_attribution_pct
            ax.bar(range(len(pct)), [p / 100 for p in pct], alpha=0.3,
                   color="#fab387", label="noise attribution")
        ax.set_xlabel("Column")
        ax.legend(fontsize=8)
        self._trace_canvas.draw_idle()

    def _fill_inspector(self, snap) -> None:
        rows = self._inspector.amplitude_rows(snap, limit=32)
        self.amp_table.setRowCount(len(rows))
        for r, row in enumerate(rows):
            cells = [f"|{row.bitstring}⟩", f"{row.real:+.4f}",
                     f"{row.imag:+.4f}", f"{row.probability:.4f}",
                     "—" if row.ideal_probability is None
                     else f"{row.ideal_probability:.4f}",
                     "—" if row.delta is None else f"{row.delta:+.4f}"]
            for c, text in enumerate(cells):
                self.amp_table.setItem(r, c, QTableWidgetItem(text))
        self._bars_fig.clear()
        ax = self._bars_fig.add_subplot(111)
        top = rows[:12]
        xs = range(len(top))
        ax.bar([x - 0.2 for x in xs], [r.probability for r in top],
               width=0.4, color="#89b4fa", label="actual")
        if any(r.ideal_probability is not None for r in top):
            ax.bar([x + 0.2 for x in xs],
                   [r.ideal_probability or 0.0 for r in top],
                   width=0.4, color="#a6e3a1", label="ideal")
        ax.set_xticks(list(xs))
        ax.set_xticklabels([r.bitstring for r in top], rotation=60,
                           fontsize=6)
        ax.legend(fontsize=7)
        self._bars_canvas.draw_idle()

    def _draw_heatmap(self) -> None:
        self._heat_fig.clear()
        ax = self._heat_fig.add_subplot(111)
        mat = self._inspector.noise_heatmap(self._impacts)
        if mat.size == 0:
            ax.text(0.5, 0.5, "Run with a noise model for the\n"
                    "per-qubit fidelity-drop heatmap",
                    ha="center", va="center", fontsize=9)
        else:
            im = ax.imshow(mat, aspect="auto", cmap="magma",
                           interpolation="nearest")
            self._heat_fig.colorbar(im, ax=ax, label="1 − F(q)")
            overlay = self._inspector.heatmap_column_overlay(
                self._attribution)
            for c, text in enumerate(overlay[:mat.shape[1]]):
                ax.text(c, -0.7, text, ha="center", fontsize=7,
                        color="#fab387")
            ax.set_xlabel("Column")
            ax.set_ylabel("Qubit")
        self._heat_canvas.draw_idle()


class ComparisonPanel(QWidget):
    """Side-by-side circuit comparison: overlaid measurement histograms,
    resource bars, metrics table, JSON export (panel 10); both circuits
    run on ``device``."""

    def __init__(self, parent=None, device=None):
        super().__init__(parent)
        self._device = pinned_device(device)
        layout = QVBoxLayout(self)
        self._fig = Figure(figsize=(5, 2.4))
        self._canvas = FigureCanvasQTAgg(self._fig)
        layout.addWidget(self._canvas)
        self.table = QTableWidget(0, 2)
        self.table.setHorizontalHeaderLabels(["Metric", "Value"])
        layout.addWidget(self.table)
        export_btn = QPushButton("Export JSON report")
        layout.addWidget(export_btn)
        self._export_btn = export_btn
        self._last = None
        export_btn.clicked.connect(self._export)

    def _draw_plots(self, result) -> None:
        self._fig.clear()
        axh = self._fig.add_subplot(121)
        ca = result.result_a.measurement_counts or {}
        cb = result.result_b.measurement_counts or {}
        keys = sorted(set(ca) | set(cb))[:16]
        if keys:
            xs = np.arange(len(keys))
            na = max(1, sum(ca.values()))
            nb = max(1, sum(cb.values()))
            axh.bar(xs - 0.2, [ca.get(k, 0) / na for k in keys],
                    width=0.4, color="#89b4fa", label="A")
            axh.bar(xs + 0.2, [cb.get(k, 0) / nb for k in keys],
                    width=0.4, color="#fab387", label="B")
            axh.set_xticks(xs)
            axh.set_xticklabels(keys, rotation=60, fontsize=6)
            axh.legend(fontsize=7)
            axh.set_title("Measurement overlay", fontsize=8)
        axr = self._fig.add_subplot(122)
        labels = ["gates", "depth", "2q+"]
        va = [result.metrics_a.gate_count, result.metrics_a.depth,
              result.metrics_a.multi_qubit_gates]
        vb = [result.metrics_b.gate_count, result.metrics_b.depth,
              result.metrics_b.multi_qubit_gates]
        ys = np.arange(len(labels))
        axr.barh(ys - 0.2, va, height=0.4, color="#89b4fa", label="A")
        axr.barh(ys + 0.2, vb, height=0.4, color="#fab387", label="B")
        axr.set_yticks(ys)
        axr.set_yticklabels(labels, fontsize=7)
        axr.legend(fontsize=7)
        axr.set_title("Resources", fontsize=8)
        self._canvas.draw_idle()

    def compare(self, circuit_a, circuit_b, shots=1024, noise_model=None,
                seed=None) -> None:
        result = CircuitComparator(device=self._device).compare(
            circuit_a, circuit_b, shots=shots, noise_model=noise_model,
            seed=seed)
        self._last = result
        self._draw_plots(result)
        rows = [
            ("Output fidelity", f"{result.output_fidelity:.6f}"),
            ("Distribution TVD", f"{result.distribution_tvd:.4f}"),
            ("KL(A||B)", f"{result.distribution_kl_ab:.4f}"),
            ("KL(B||A)", f"{result.distribution_kl_ba:.4f}"),
            ("Gates A / B", f"{result.metrics_a.gate_count} / "
                            f"{result.metrics_b.gate_count}"),
            ("Depth A / B", f"{result.metrics_a.depth} / "
                            f"{result.metrics_b.depth}"),
            ("2q+ gates A / B", f"{result.metrics_a.multi_qubit_gates} / "
                                f"{result.metrics_b.multi_qubit_gates}"),
            ("Purity A / B", f"{result.purity_a:.4f} / "
                             f"{result.purity_b:.4f}"),
            ("Entropy A / B", f"{result.entropy_a:.4f} / "
                              f"{result.entropy_b:.4f}"),
        ]
        self.table.setRowCount(len(rows))
        for r, (k, v) in enumerate(rows):
            self.table.setItem(r, 0, QTableWidgetItem(k))
            self.table.setItem(r, 1, QTableWidgetItem(v))

    def _export(self) -> None:
        if self._last is None:
            return
        from PyQt6.QtWidgets import QFileDialog

        path, _ = QFileDialog.getSaveFileName(self, "Export report",
                                              "comparison.json",
                                              "JSON (*.json)")
        if path:
            CircuitComparator.export_report(self._last, path)


class OptimizerPanel(_Canvas):
    """VQE/QAOA optimization with live convergence plot (panel 11); costs
    and gradients run on ``device``."""

    progress = pyqtSignal(int, float)
    finished = pyqtSignal(object)

    def __init__(self, parent=None, circuit_supplier=None, device=None):
        super().__init__(parent)
        self._device = pinned_device(device)
        self._circuit_supplier = circuit_supplier
        self._busy = False
        self.cost_combo = QComboBox()
        self.cost_combo.addItems(["z_expectation", "zz_chain",
                                  "qaoa_maxcut"])
        self.lr_spin = QDoubleSpinBox()
        self.lr_spin.setRange(0.001, 2.0)
        self.lr_spin.setValue(0.1)
        self.iters_spin = QSpinBox()
        self.iters_spin.setRange(1, 2000)
        self.iters_spin.setValue(100)
        self.grad_combo = QComboBox()
        self.grad_combo.addItems(["autodiff", "parameter_shift",
                                  "finite_difference"])
        # Engine selector (mirrors the QEC panel's): "mps" evaluates
        # costs as bond-dimension-chi contractions, so wide circuits
        # optimize without a 2^n state (parameter-shift gradients).
        self.engine_combo = QComboBox()
        self.engine_combo.addItems(["statevector", "mps"])
        self.chi_spin = QSpinBox()
        self.chi_spin.setRange(2, 256)
        self.chi_spin.setValue(32)
        self.run_btn = QPushButton("Optimize")
        self.run_btn.clicked.connect(self._on_run_clicked)
        self.plateau_btn = QPushButton("Barren Plateau")
        self.plateau_btn.clicked.connect(self._on_plateau_clicked)
        self.view_combo = QComboBox()
        self.view_combo.addItems(["Convergence", "Parameters"])
        self.view_combo.currentIndexChanged.connect(lambda _: self._plot())
        for w in (QLabel("Cost:"), self.cost_combo, QLabel("LR:"),
                  self.lr_spin, QLabel("Iters:"), self.iters_spin,
                  QLabel("Grad:"), self.grad_combo,
                  QLabel("Engine:"), self.engine_combo,
                  QLabel("χ:"), self.chi_spin, self.run_btn,
                  self.plateau_btn, QLabel("View:"), self.view_combo):
            self.controls.addWidget(w)
        self.controls.addStretch(1)
        self._history: list[float] = []
        self._param_history: list[list[float]] = []
        self.progress.connect(self._on_progress)
        self.finished.connect(self._on_finished)
        self._optimizer: CircuitOptimizer | None = None

    def _cost_fn(self, circuit):
        name = self.cost_combo.currentText()
        n = circuit.num_qubits
        if name == "zz_chain":
            return CostFunction.vqe_hamiltonian(
                [(-1.0, "ZZ", [i, i + 1]) for i in range(n - 1)])
        if name == "qaoa_maxcut":
            return CostFunction.qaoa_maxcut(
                [(i, i + 1) for i in range(n - 1)])
        return CostFunction.z_expectation(0)

    def _on_run_clicked(self) -> None:
        if self._circuit_supplier is not None:
            self.optimize(self._circuit_supplier())

    def _on_plateau_clicked(self) -> None:
        if self._circuit_supplier is not None:
            self.show_plateau(self._circuit_supplier())

    def _make_config(self, circuit):
        """Config honoring the engine selector; "mps" evaluates the
        cost as bond-dimension-chi contractions (no 2^n state)."""
        if self.engine_combo.currentText() == "mps":
            return MPSParameterizedConfig.auto_detect(
                circuit, chi=self.chi_spin.value())
        return ParameterizedCircuitConfig.auto_detect(circuit)

    def _grad_method(self) -> str:
        grad = self.grad_combo.currentText()
        if grad == "autodiff" and self.engine_combo.currentText() == "mps":
            return "parameter_shift"  # no reverse-mode through SVDs
        return grad

    def optimize(self, circuit, seed: int = 42) -> None:
        if self._busy:
            self.stop()   # second click cancels the active run
            return
        config = self._make_config(circuit)
        if config.num_params == 0:
            self.axes().set_title("No parameterized gates in circuit")
            self.redraw()
            return
        self._busy = True
        self.run_btn.setText("Stop")
        self._history = []
        self._param_history = []
        self._optimizer = CircuitOptimizer(
            config, self._cost_fn(circuit),
            learning_rate=self.lr_spin.value(),
            max_iterations=self.iters_spin.value(),
            gradient_method=self._grad_method(), device=self._device)

        def on_iter(i, values, cost):
            self._param_history.append([float(v) for v in values])
            self.progress.emit(i, cost)

        def work():
            result = self._optimizer.run(callback=on_iter, seed=seed)
            self.finished.emit(result)

        _start_worker(self._device, work)

    def stop(self) -> None:
        if self._optimizer is not None:
            self._optimizer.request_stop()

    def _on_progress(self, i: int, cost: float) -> None:
        self._history.append(cost)
        if i % 5 == 0:
            self._plot()

    def _on_finished(self, result) -> None:
        self._busy = False
        self.run_btn.setText("Optimize")
        self._plot()
        ax = self.figure.gca()
        ax.set_title(f"optimal cost = {result.optimal_cost:.6f} "
                     f"({result.iterations} iters, "
                     f"converged={result.converged})", fontsize=9)
        self.redraw()

    def _plot(self) -> None:
        ax = self.axes()
        if (self.view_combo.currentText() == "Parameters"
                and self._param_history):
            arr = np.array(self._param_history)
            for j in range(min(arr.shape[1], 16)):
                ax.plot(arr[:, j], lw=1, label=f"p{j}"
                        if arr.shape[1] <= 8 else None)
            if arr.shape[1] <= 8:
                ax.legend(fontsize=7)
            ax.set_ylabel("Parameter value")
        else:
            ax.plot(self._history, color="#89b4fa")
            ax.set_ylabel("Cost")
        ax.set_xlabel("Iteration")
        self.redraw()

    def show_plateau(self, circuit, seed: int = 42) -> None:
        config = self._make_config(circuit)
        if config.num_params == 0:
            return
        opt = CircuitOptimizer(config, self._cost_fn(circuit),
                               device=self._device)
        bp = opt.detect_barren_plateau_layered(n_samples=25, seed=seed)
        ax = self.axes()
        layers = [d[0] for d in bp.depth_scaling]
        variances = [d[1] for d in bp.depth_scaling]
        ax.semilogy(layers, variances, "-o", color="#fab387")
        ax.axhline(bp.threshold, ls="--", color="#f38ba8")
        ax.set_xlabel("Layer")
        ax.set_ylabel("Gradient variance")
        ax.set_title(f"barren={bp.overall_is_barren} "
                     f"(mean var {bp.overall_mean_variance:.2e})",
                     fontsize=9)
        self.redraw()


class QECPanel(_Canvas):
    """QEC cycle + threshold curves (panel 12); every engine runs on
    ``device``."""

    sweep_done = pyqtSignal(object)
    memory_done = pyqtSignal(object)

    REPETITION_CODES = ("Repetition (distance d)",
                        "Phase-flip repetition (distance d)")
    SURFACE_CODE = "Surface (distance d, frame)"

    def __init__(self, parent=None, device=None):
        super().__init__(parent)
        self._device = pinned_device(device)
        self.code_combo = QComboBox()
        self.code_combo.addItems(list(AVAILABLE_CODES)
                                 + list(self.REPETITION_CODES)
                                 + [self.SURFACE_CODE])
        self.engine_combo = QComboBox()
        self.engine_combo.addItems(["statevector", "frame"])
        self.d_spin = QSpinBox()
        self.d_spin.setRange(3, 25)
        self.d_spin.setSingleStep(2)
        self.d_spin.setValue(5)
        self.noise_combo = QComboBox()
        self.noise_combo.addItems(["bit_flip", "phase_flip",
                                   "depolarizing"])
        self.p_spin = QDoubleSpinBox()
        self.p_spin.setRange(0.0, 0.5)
        self.p_spin.setSingleStep(0.01)
        self.p_spin.setValue(0.1)
        self.logical_combo = QComboBox()
        self.logical_combo.addItems(["|0>_L", "|1>_L"])
        cycle_btn = QPushButton("Run Cycle")
        cycle_btn.clicked.connect(self.run_cycle)
        sweep_btn = QPushButton("Threshold Sweep")
        sweep_btn.clicked.connect(self.run_sweep)
        memory_btn = QPushButton("Memory (ML)")
        memory_btn.clicked.connect(self.run_memory)
        circuit_btn = QPushButton("Memory (circuit)")
        circuit_btn.clicked.connect(self.run_circuit_memory)
        layout_btn = QPushButton("Code Layout")
        layout_btn.clicked.connect(self.show_layout)
        self.status = QLabel("")
        for w in (QLabel("Code:"), self.code_combo,
                  QLabel("Engine:"), self.engine_combo,
                  QLabel("d:"), self.d_spin, QLabel("Noise:"),
                  self.noise_combo, QLabel("p:"), self.p_spin,
                  self.logical_combo, cycle_btn, sweep_btn, memory_btn,
                  circuit_btn, layout_btn, self.status):
            self.controls.addWidget(w)
        self.controls.addStretch(1)
        self.sweep_done.connect(self._plot_sweep)
        self.memory_done.connect(self._plot_memory)

    def _repetition_kind(self) -> str | None:
        """'bit_flip' / 'phase_flip' when a repetition code is selected."""
        text = self.code_combo.currentText()
        if text == self.REPETITION_CODES[0]:
            return "bit_flip"
        if text == self.REPETITION_CODES[1]:
            return "phase_flip"
        return None

    def _distance(self) -> int:
        d = int(self.d_spin.value())
        return d if d % 2 else d + 1  # repetition specs require odd d

    def _surface_spec(self):
        """Frame spec for the surface entry at the spinbox distance
        ('auto' decoder: exact coset-leader tables at d<=5, union-find
        matching above)."""
        return surface_code_frame_spec(self._distance())

    def show_layout(self) -> None:
        """Code-layout diagram: data qubits (circles) in a row, one row
        per parity check below, with edges to the check's members
        (the Code Layout tab)."""
        kind = self._repetition_kind()
        if self.code_combo.currentText() == self.SURFACE_CODE:
            spec = self._surface_spec()
            nd = spec.data_qubits
            checks = ([("Z", list(np.nonzero(row)[0]))
                       for row in spec.comp_checks]
                      + [("X", list(np.nonzero(row)[0]))
                         for row in spec.h_checks])
            name = spec.name
            n_anc = 0
        elif kind is not None:
            spec = repetition_frame_spec(self._distance(), kind)
            nd = spec.data_qubits
            mat = spec.comp_checks if kind == "bit_flip" else spec.h_checks
            checks = [("Z" if kind == "bit_flip" else "X",
                       list(np.nonzero(row)[0])) for row in mat]
            name = spec.name
            n_anc = mat.shape[0]
        else:
            code = AVAILABLE_CODES[self.code_combo.currentText()]()
            nd = code.data_qubits
            checks = ([("Z", c) for c in code.comp_frame_checks()]
                      + [("X", c) for c in code.h_frame_checks()])
            name = code.name
            n_anc = code.ancilla_qubits
        ax = self.axes()
        for q in range(nd):
            ax.scatter(q, 0, s=600, c="#89b4fa", zorder=3)
            ax.text(q, 0, f"d{q}", ha="center", va="center", zorder=4,
                    fontsize=9, color="#11111b")
        for i, (kind_label, members) in enumerate(checks):
            y = -1.0 - i * 0.8
            color = "#a6e3a1" if kind_label == "Z" else "#fab387"
            ax.scatter(-1.2, y, s=450, marker="s", c=color, zorder=3)
            ax.text(-1.2, y, f"{kind_label}{i}", ha="center", va="center",
                    zorder=4, fontsize=8, color="#11111b")
            for q in members:
                ax.plot([-1.2, q], [y, 0], color=color, lw=1.2,
                        alpha=0.6, zorder=1)
        ax.set_title(f"{name}: {nd} data + {n_anc} ancilla, "
                     f"{len(checks)} stabilizer checks", fontsize=9)
        ax.set_axis_off()
        self.redraw()

    def _sim(self):
        """Simulator for sweeps, honoring the engine selector. The frame
        engine is draw-exact vs the statevector one for the four
        statevector codes and is the only engine that holds repetition
        codes."""
        kind = self._repetition_kind()
        dev = self._device
        if self.code_combo.currentText() == self.SURFACE_CODE:
            return FrameQECSimulator(self._surface_spec(), device=dev)
        if kind is not None:
            return FrameQECSimulator(
                repetition_frame_spec(self._distance(), kind), device=dev)
        code = AVAILABLE_CODES[self.code_combo.currentText()]()
        if self.engine_combo.currentText() == "frame":
            return FrameQECSimulator(frame_spec_from_code(code), device=dev)
        return QECSimulator(code, device=dev)

    def run_cycle(self) -> None:
        if (self._repetition_kind() is not None
                or self.code_combo.currentText() == self.SURFACE_CODE
                or self.engine_combo.currentText() == "frame"):
            self.status.setText(
                "Cycle view needs the statevector engine (state plots); "
                "use Threshold Sweep / Memory (ML) on the frame engine")
            return
        logical = self.logical_combo.currentIndex()
        result = self._sim().run_cycle(
            logical, self.noise_combo.currentText(), self.p_spin.value(),
            seed=42)
        self.status.setText(
            f"syndrome={result.syndrome} corr={result.correction_applied} "
            f"F={result.fidelity_after:.4f} <Z_L>="
            f"{result.logical_z_expectation:+.3f}")
        ax = self.axes()
        ax.bar(["before", "after"],
               [result.fidelity_before, result.fidelity_after],
               color=["#f38ba8", "#a6e3a1"])
        ax.set_ylabel("Fidelity vs ideal codeword")
        self.redraw()

    def run_sweep(self) -> None:
        sim = self._sim()
        noise = self.noise_combo.currentText()

        def work():
            points = sim.threshold_sweep(
                np.linspace(0.001, 0.3, 15).tolist(), n_trials=100,
                noise_type=noise, seed=42)
            self.sweep_done.emit(points)

        _start_worker(self._device, work)

    def run_memory(self) -> None:
        """R-round memory experiment with a space-time decoder:
        exact ML for repetition codes (``build_ml_memory_fn``) and the
        d=3 surface code (degenerate-ML ``build_ml_css_memory_fn``);
        union-find matching on the detection-event graph
        (``matching_memory_experiment``) for surface codes above d=3,
        where the 2^(d^2) ML posterior is impossible."""
        kind = self._repetition_kind()
        is_surface = self.code_combo.currentText() == self.SURFACE_CODE
        if kind is None and not is_surface:
            self.status.setText(
                "Memory (ML) runs on repetition or surface codes — "
                "select a '(distance d)' entry")
            return
        d = self._distance()
        p = self.p_spin.value()
        dev = self._device

        def work():
            if is_surface and d <= 3:
                res = FrameQECSimulator.ml_surface_memory_experiment(
                    noise_prob=p, n_rounds=10, n_trials=2048,
                    meas_error_prob=p, distance=3, seed=42, device=dev)
            elif is_surface:
                res = FrameQECSimulator.matching_memory_experiment(
                    noise_prob=p, n_rounds=10, n_trials=2048,
                    meas_error_prob=p, distance=d, code="surface",
                    seed=42, device=dev)
            else:
                res = FrameQECSimulator.ml_memory_experiment(
                    distance=d, noise_prob=p, n_rounds=10, n_trials=2048,
                    meas_error_prob=p, seed=42, device=dev)
            self.memory_done.emit(res)

        _start_worker(dev, work)

    def run_circuit_memory(self) -> None:
        """Circuit-level-noise memory (surface codes only): the real
        extraction circuit as noisy Clifford trajectories, decoded on
        the measured detector error model (``qec_circuit`` +
        ``qec_dem``).  The spinbox p is the per-gate depolarizing rate
        — circuit noise is ~an order harsher than phenomenological, so
        sensible values are 0.001-0.02."""
        if self.code_combo.currentText() != self.SURFACE_CODE:
            self.status.setText(
                "Circuit-level memory runs the surface extraction "
                "circuit — select the surface code entry")
            return
        d = min(self._distance(), 7)      # DEM extraction is cached but
        p = min(self.p_spin.value(), 0.05)  # enumerates O(d^2 R) faults
                                            # through a (2d^2-1)-qubit
                                            # tableau — d>7 is minutes+

        def work():
            from ..qec_circuit import circuit_level_memory
            res = circuit_level_memory(
                distance=d, n_rounds=3, noise_prob=p, n_trials=1000,
                seed=42, device=self._device)
            self.memory_done.emit(res)

        _start_worker(self._device, work)

    def _plot_memory(self, res) -> None:
        ax = self.axes()
        if "raw_failure_probability" in res:    # circuit-level result
            ax.bar(["DEM matching", "uncorrected"],
                   [res["logical_failure_probability"],
                    res["raw_failure_probability"]],
                   color=["#a6e3a1", "#f38ba8"])
            ax.set_ylabel(
                f"Logical failure ({res['n_rounds']} rounds, "
                f"d={res['distance']}, circuit-level p/gate)")
            self.status.setText(
                f"circuit-level {res['logical_failure_probability']:.4f}"
                f" vs uncorrected {res['raw_failure_probability']:.4f} "
                f"({res['n_trials']} trials, {res['n_qubits']} qubits)")
            self.redraw()
            return
        if "matching_failure_probability" in res:
            label, fail = "space-time UF", res["matching_failure_probability"]
        else:
            label, fail = "space-time ML", res["ml_failure_probability"]
        ax.bar([label, "single-shot"],
               [fail, res["final_syndrome_failure_probability"]],
               color=["#a6e3a1", "#f38ba8"])
        ax.set_ylabel(f"Logical failure ({res['n_rounds']} rounds, "
                      f"d={res['distance']}, p=q)")
        self.status.setText(
            f"{label} {fail:.4f} vs single-shot "
            f"{res['final_syndrome_failure_probability']:.4f} "
            f"({res['n_trials']} trials)")
        self.redraw()

    def _plot_sweep(self, points) -> None:
        ax = self.axes()
        ps = [p.physical_rate for p in points]
        ax.plot(ps, [p.logical_rate for p in points], "-o",
                label="logical (fidelity)", color="#89b4fa")
        ax.plot(ps, [1 - p.decoder_success_rate for p in points], "-s",
                label="logical (Z_L sign)", color="#fab387")
        ax.plot(ps, ps, "--", color="gray", label="no correction")
        ax.set_xlabel("Physical error rate")
        ax.set_ylabel("Logical error rate")
        ax.legend(fontsize=8)
        self.redraw()
