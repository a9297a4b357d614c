"""Trotterized Hamiltonian time evolution as ordinary circuits.

Counterpart of ``quantum_simulator_tpu/models/trotter.py``. Every Pauli
string satisfies ``P^2 = I``, so its evolution gate is the closed form
``exp(-i theta P) = cos(theta) I - i sin(theta) P``. Each Hamiltonian
term becomes one parameterized dense gate (``ExpP[<string>]``, angle =
coeff * dt), registered once per Pauli string with a NumPy
``param_builder`` (the host operand build of an ideal run) and a batched,
differentiable ``torch_matrix_func``, as the built-in gates of
``gates.py`` carry them. The angles are therefore ordinary gate
parameters: the circuits run through ``Simulator.run``, through parameter
batches (``plan.param_overrides``), through ``program.forward_body`` under
autograd and through the optimizer.

``_MAX_SITES`` is the JAX package's k-site dense-gate ceiling
(``mps._MAX_DENSE_SITES``, ``models/trotter.py:43``), carried as a
constant: it is also the bound of the registry's ``ExpP`` synthesis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit import GateInstance, QuantumCircuit
from ..gates import GateDefinition, GateType
from ..registry import GateRegistry

_PAULI = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.diag([1.0, -1.0]).astype(np.complex128),
}

# Widest Pauli string an ``ExpP`` gate takes.
_MAX_SITES = 8


def exp_pauli_gate(pauli_string: str) -> str:
    """Register (idempotently) the parameterized gate
    ``exp(-i theta P)`` for a Pauli string and return its name.

    ``target_qubits[0]`` is the most significant bit of the matrix index:
    ``P = kron(P_0, P_1, ...)`` in string order."""
    pstr = str(pauli_string).upper()
    if not pstr or len(pstr) > _MAX_SITES:
        raise ValueError(f"Pauli string must be 1..{_MAX_SITES} chars, "
                         f"got {pauli_string!r}")
    if any(ch not in "IXYZ" for ch in pstr):
        raise ValueError(f"unsupported Pauli in {pauli_string!r}")
    name = f"ExpP[{pstr}]"
    registry = GateRegistry.instance()
    # Raw-table membership probe: registry.get() synthesizes ExpP names
    # by calling back into this function, so it must not be used here.
    if name in registry._gates:
        return name
    p = np.eye(1, dtype=np.complex128)
    for ch in pstr:
        p = np.kron(p, _PAULI[ch])
    eye = np.eye(p.shape[0], dtype=np.complex128)

    def matrix_func(theta):
        return np.cos(theta) * eye - 1j * np.sin(theta) * p

    # cos(t) I - i sin(t) (Pr + i Pi) = (cos(t) I + sin(t) Pi) - i sin(t) Pr
    eye_t = torch.from_numpy(eye.real.astype(np.float32))
    p_re = torch.from_numpy(p.real.astype(np.float32))
    p_im = torch.from_numpy(p.imag.astype(np.float32))

    def torch_matrix_func(theta):
        """Angles of any leading shape -> ``(..., d, d)`` complex64."""
        if not isinstance(theta, torch.Tensor):
            theta = torch.as_tensor(theta, dtype=torch.float32)
        c = torch.cos(theta)[..., None, None]
        s = torch.sin(theta)[..., None, None]
        dev = theta.device
        return torch.complex(c * eye_t.to(dev) + s * p_im.to(dev),
                             -s * p_re.to(dev))

    k = len(pstr)
    registry.register(GateDefinition(
        name=name, display_name=f"exp(-iθ {pstr})",
        gate_type=GateType.SINGLE if k == 1 else GateType.MULTI,
        num_qubits=k, num_params=1, param_names=("θ",),
        matrix_func=matrix_func, symbol=f"e^{pstr}", color="#607D8B",
        num_targets=k, param_builder=matrix_func,
        torch_matrix_func=torch_matrix_func))
    return name


def _validated(num_qubits: int, terms):
    out = []
    for coeff, pstr, qubits in terms:
        pstr = str(pstr).upper()
        qubits = [int(q) for q in qubits]
        if len(pstr) != len(qubits):
            raise ValueError(f"term {pstr!r} has {len(pstr)} Paulis for "
                             f"{len(qubits)} qubits")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"duplicate qubits in term {pstr!r}")
        if any(q < 0 or q >= num_qubits for q in qubits):
            raise ValueError(f"qubit out of range in term {pstr!r}")
        live = [(p, q) for p, q in zip(pstr, qubits) if p != "I"]
        if not live:
            continue  # identity terms are a global phase: drop
        out.append((float(coeff), "".join(p for p, _ in live),
                    [q for _, q in live]))
    return out


def trotter_circuit(num_qubits: int, terms, time: float, steps: int,
                    order: int = 2) -> QuantumCircuit:
    """Circuit approximating ``exp(-i H time)`` for ``H = sum c_k P_k``
    (the ``models.hamiltonians`` term format) by ``steps`` Trotter
    steps.

    ``order=1``: first-order product formula (error O(t^2/steps));
    ``order=2``: Strang splitting, a half-step in term order and a
    half-step reversed (error O(t^3/steps^2)); ``order=4``: Suzuki's
    triple-jump composition of Strang substeps with the fractal
    coefficients ``p, p, 1-4p, p, p`` where ``p = 1/(4 - 4^(1/3))`` (error
    O(t^5/steps^4), 5x the gates per step). Identity terms contribute
    only a global phase and are dropped. Every gate is ``ExpP[...]``
    with the angle as its single parameter, so the returned circuit
    serializes, optimizes and runs like any other."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if order not in (1, 2, 4):
        raise ValueError("order must be 1, 2 or 4")
    parsed = _validated(num_qubits, terms)
    c = QuantumCircuit(num_qubits)
    dt = float(time) / steps
    col = 0

    def emit(coeff, pstr, qubits, angle_scale):
        nonlocal col
        c.add_gate(GateInstance(exp_pauli_gate(pstr), qubits,
                                [coeff * dt * angle_scale], column=col))
        col += 1

    def strang(scale):
        for coeff, pstr, qubits in parsed:
            emit(coeff, pstr, qubits, 0.5 * scale)
        for coeff, pstr, qubits in reversed(parsed):
            emit(coeff, pstr, qubits, 0.5 * scale)

    p4 = 1.0 / (4.0 - 4.0 ** (1.0 / 3.0))
    for _ in range(steps):
        if order == 1:
            for coeff, pstr, qubits in parsed:
                emit(coeff, pstr, qubits, 1.0)
        elif order == 2:
            strang(1.0)
        else:
            for scale in (p4, p4, 1.0 - 4.0 * p4, p4, p4):
                strang(scale)
    return c
