"""Built-in quantum algorithm circuit templates.

Counterpart of ``quantum_simulator_tpu/algorithms.py``: bell_state,
ghz_state, quantum_fourier_transform, inverse_qft, grover_search,
deutsch_jozsa, quantum_teleportation, bernstein_vazirani,
superdense_coding and tfim_quench, with ``list_templates`` metadata.
Circuits only: they run on whatever engine the caller picks.

As in the JAX package, the QFT uses true controlled-phase gates (CPhase),
and Grover's oracle and diffusion use an exact multi-controlled-Z gate
for any width: ``MCZ<k>`` gates are synthesized on demand by the
registry, so serialized Grover circuits load in a fresh process.
"""

from __future__ import annotations

import math

from .circuit import GateInstance, QuantumCircuit
from .registry import GateRegistry


def _ensure_mcz(num_qubits: int) -> str:
    """Return the name of the exact multi-controlled-Z gate on
    ``num_qubits`` qubits (the registry synthesizes MCZ_k on demand, so
    serialized Grover circuits also load in a fresh process)."""
    name = f"MCZ{num_qubits}"
    GateRegistry.instance().get(name)
    return name


class AlgorithmTemplate:
    """Factory for common quantum algorithm circuits."""

    @staticmethod
    def bell_state(qubit0: int = 0, qubit1: int = 1) -> QuantumCircuit:
        """|Phi+> = (|00> + |11>) / sqrt(2)."""
        n = max(qubit0, qubit1) + 1
        circuit = QuantumCircuit(num_qubits=n)
        circuit.add_gate(GateInstance("H", [qubit0], [], 0))
        circuit.add_gate(GateInstance("CNOT", [qubit0, qubit1], [], 1))
        circuit.add_gate(GateInstance("Measure", [qubit0], [], 2))
        circuit.add_gate(GateInstance("Measure", [qubit1], [], 2))
        return circuit

    @staticmethod
    def ghz_state(num_qubits: int) -> QuantumCircuit:
        """(|00...0> + |11...1>) / sqrt(2) via an H + CNOT fan-out chain."""
        circuit = QuantumCircuit(num_qubits=num_qubits)
        circuit.add_gate(GateInstance("H", [0], [], 0))
        for i in range(1, num_qubits):
            circuit.add_gate(GateInstance("CNOT", [0, i], [], i))
        for i in range(num_qubits):
            circuit.add_gate(GateInstance("Measure", [i], [], num_qubits))
        return circuit

    @staticmethod
    def quantum_fourier_transform(num_qubits: int) -> QuantumCircuit:
        """Exact QFT: H + controlled-phase ladder + bit-reversal SWAPs."""
        circuit = QuantumCircuit(num_qubits=num_qubits)
        col = 0
        for i in range(num_qubits):
            circuit.add_gate(GateInstance("H", [i], [], col))
            col += 1
            for j in range(i + 1, num_qubits):
                angle = math.pi / (2 ** (j - i))
                # control = j, target = i (CPhase is symmetric in its
                # control/target roles, both orderings are identical).
                circuit.add_gate(GateInstance("CPhase", [j, i], [angle], col))
                col += 1
        for i in range(num_qubits // 2):
            circuit.add_gate(
                GateInstance("SWAP", [i, num_qubits - 1 - i], [], col))
            col += 1
        return circuit

    @staticmethod
    def inverse_qft(num_qubits: int) -> QuantumCircuit:
        """Exact inverse QFT (adjoint gate order, negated angles)."""
        circuit = QuantumCircuit(num_qubits=num_qubits)
        col = 0
        for i in range(num_qubits // 2):
            circuit.add_gate(
                GateInstance("SWAP", [i, num_qubits - 1 - i], [], col))
            col += 1
        for i in range(num_qubits - 1, -1, -1):
            for j in range(num_qubits - 1, i, -1):
                angle = -math.pi / (2 ** (j - i))
                circuit.add_gate(GateInstance("CPhase", [j, i], [angle], col))
                col += 1
            circuit.add_gate(GateInstance("H", [i], [], col))
            col += 1
        return circuit

    @staticmethod
    def grover_search(num_qubits: int, marked_state: int = 0,
                      num_iterations: int | None = None) -> QuantumCircuit:
        """Grover search with an exact phase oracle and diffusion operator.

        Defaults to floor(pi/4 * sqrt(2^n)) iterations (the optimum);
        pass ``num_iterations`` for a bounded demonstration at large n,
        where the optimum is ~2^(n/2) circuits deep — the engine runs
        wide MCZs at any n (fused phase passes), so e.g. 3 iterations at
        n=30 amplify the marked amplitude to exactly sin(7*asin(2^-15)),
        checkable via ``PlanarStateVector.amplitude``. The oracle marks
        ``marked_state`` by X-conjugating an exact MCZ.
        """
        circuit = QuantumCircuit(num_qubits=num_qubits)
        col = 0
        if num_iterations is None:
            num_iterations = max(
                1, int(math.floor(math.pi / 4 * math.sqrt(2**num_qubits))))

        def mcz_at(col: int) -> int:
            if num_qubits == 1:
                circuit.add_gate(GateInstance("Z", [0], [], col))
            elif num_qubits == 2:
                circuit.add_gate(GateInstance("CZ", [0, 1], [], col))
            else:
                name = _ensure_mcz(num_qubits)
                circuit.add_gate(
                    GateInstance(name, list(range(num_qubits)), [], col))
            return col + 1

        for i in range(num_qubits):
            circuit.add_gate(GateInstance("H", [i], [], col))
        col += 1

        for _ in range(num_iterations):
            # Oracle: X on the 0-bits of marked_state, MCZ, undo the Xs.
            zero_bits = [i for i in range(num_qubits)
                         if not (marked_state >> (num_qubits - 1 - i)) & 1]
            for i in zero_bits:
                circuit.add_gate(GateInstance("X", [i], [], col))
            col += 1
            col = mcz_at(col)
            for i in zero_bits:
                circuit.add_gate(GateInstance("X", [i], [], col))
            col += 1

            # Diffusion: H^n X^n MCZ X^n H^n.
            for i in range(num_qubits):
                circuit.add_gate(GateInstance("H", [i], [], col))
            col += 1
            for i in range(num_qubits):
                circuit.add_gate(GateInstance("X", [i], [], col))
            col += 1
            col = mcz_at(col)
            for i in range(num_qubits):
                circuit.add_gate(GateInstance("X", [i], [], col))
            col += 1
            for i in range(num_qubits):
                circuit.add_gate(GateInstance("H", [i], [], col))
            col += 1

        for i in range(num_qubits):
            circuit.add_gate(GateInstance("Measure", [i], [], col))
        return circuit

    @staticmethod
    def deutsch_jozsa(num_qubits: int,
                      oracle_type: str = "balanced") -> QuantumCircuit:
        """Deutsch-Jozsa with n-1 input qubits + 1 ancilla."""
        circuit = QuantumCircuit(num_qubits=num_qubits)
        n = num_qubits - 1
        ancilla = num_qubits - 1
        col = 0

        circuit.add_gate(GateInstance("X", [ancilla], [], col))
        col += 1
        for i in range(num_qubits):
            circuit.add_gate(GateInstance("H", [i], [], col))
        col += 1

        if oracle_type == "balanced":
            for i in range(n):
                circuit.add_gate(GateInstance("CNOT", [i, ancilla], [], col))
                col += 1
        # constant oracle f(x) = 0: identity
        col += 1

        for i in range(n):
            circuit.add_gate(GateInstance("H", [i], [], col))
        col += 1
        for i in range(n):
            circuit.add_gate(GateInstance("Measure", [i], [], col))
        return circuit

    @staticmethod
    def quantum_teleportation() -> QuantumCircuit:
        """3-qubit teleportation with deferred-measurement corrections."""
        circuit = QuantumCircuit(num_qubits=3)
        circuit.add_gate(GateInstance("H", [0], [], 0))   # state to send: |+>
        circuit.add_gate(GateInstance("H", [1], [], 1))   # Bell pair q1-q2
        circuit.add_gate(GateInstance("CNOT", [1, 2], [], 2))
        circuit.add_gate(GateInstance("CNOT", [0, 1], [], 3))  # Bell measure
        circuit.add_gate(GateInstance("H", [0], [], 4))
        circuit.add_gate(GateInstance("Measure", [0], [], 5))
        circuit.add_gate(GateInstance("Measure", [1], [], 5))
        circuit.add_gate(GateInstance("CNOT", [1, 2], [], 6))  # corrections
        circuit.add_gate(GateInstance("CZ", [0, 2], [], 7))
        return circuit

    @staticmethod
    def bernstein_vazirani(secret: str) -> QuantumCircuit:
        """Recover ``secret`` in one oracle query."""
        n = len(secret)
        circuit = QuantumCircuit(num_qubits=n + 1)
        ancilla = n
        col = 0

        circuit.add_gate(GateInstance("X", [ancilla], [], col))
        col += 1
        for i in range(n + 1):
            circuit.add_gate(GateInstance("H", [i], [], col))
        col += 1
        for i, bit in enumerate(secret):
            if bit == "1":
                circuit.add_gate(GateInstance("CNOT", [i, ancilla], [], col))
                col += 1
        for i in range(n):
            circuit.add_gate(GateInstance("H", [i], [], col))
        col += 1
        for i in range(n):
            circuit.add_gate(GateInstance("Measure", [i], [], col))
        return circuit

    @staticmethod
    def superdense_coding() -> QuantumCircuit:
        """Superdense coding, encoding the classical bits '11'."""
        circuit = QuantumCircuit(num_qubits=2)
        circuit.add_gate(GateInstance("H", [0], [], 0))
        circuit.add_gate(GateInstance("CNOT", [0, 1], [], 1))
        circuit.add_gate(GateInstance("X", [0], [], 2))
        circuit.add_gate(GateInstance("Z", [0], [], 3))
        circuit.add_gate(GateInstance("CNOT", [0, 1], [], 4))
        circuit.add_gate(GateInstance("H", [0], [], 5))
        circuit.add_gate(GateInstance("Measure", [0], [], 6))
        circuit.add_gate(GateInstance("Measure", [1], [], 6))
        return circuit

    @staticmethod
    def tfim_quench(num_qubits: int, time: float = 1.0,
                    steps: int | None = None, j: float = -1.0,
                    h: float = -0.6) -> QuantumCircuit:
        """Domain-wall quench under the transverse-field Ising model
        (no reference analog): |0...0 1...1> evolved by second-order
        Trotter circuits (``models/trotter.py``).  Runs on every
        engine — at reference widths on the statevector engine, at
        100+ qubits on the MPS engine (``mps.MPSSimulator``)."""
        if num_qubits < 2:
            raise ValueError("tfim_quench needs at least 2 qubits")
        from .models.hamiltonians import tfim_chain
        from .models.trotter import trotter_circuit

        if steps is None:
            steps = max(2, int(round(4 * abs(time))))
        circuit = QuantumCircuit(num_qubits=num_qubits)
        for q in range(num_qubits // 2, num_qubits):
            circuit.add_gate(GateInstance("X", [q], [], 0))
        evo = trotter_circuit(num_qubits, tfim_chain(num_qubits, j=j, h=h),
                              time, steps=steps, order=2)
        for g in evo.gates:
            g.column += 1
            circuit.add_gate(g)
        return circuit

    @staticmethod
    def list_templates() -> list[dict[str, str]]:
        return [
            {"name": "bell_state", "display": "Bell State",
             "description": "Creates a Bell state |Phi+> = (|00> + |11>) / sqrt(2)"},
            {"name": "ghz_state", "display": "GHZ State",
             "description": "Creates a GHZ state (|00...0> + |11...1>) / sqrt(2)"},
            {"name": "qft", "display": "Quantum Fourier Transform",
             "description": "Quantum Fourier Transform circuit"},
            {"name": "inverse_qft", "display": "Inverse QFT",
             "description": "Inverse Quantum Fourier Transform"},
            {"name": "grover", "display": "Grover's Search",
             "description": "Grover's quantum search algorithm"},
            {"name": "deutsch_jozsa", "display": "Deutsch-Jozsa",
             "description": "Deutsch-Jozsa algorithm for function classification"},
            {"name": "teleportation", "display": "Quantum Teleportation",
             "description": "Quantum teleportation protocol"},
            {"name": "bernstein_vazirani", "display": "Bernstein-Vazirani",
             "description": "Bernstein-Vazirani algorithm for finding secret strings"},
            {"name": "superdense_coding", "display": "Superdense Coding",
             "description": "Superdense coding protocol"},
            # Beyond the reference's nine: Hamiltonian time evolution.
            {"name": "tfim_quench", "display": "TFIM Quench",
             "description": "Domain-wall quench under the transverse-"
                            "field Ising model (2nd-order Trotter)"},
        ]
