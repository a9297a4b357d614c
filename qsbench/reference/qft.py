"""Plain statevector reference of the QFT circuits: the statevector
reference's ``Ry``, ``Rz`` and ``CNOT``, and the gates the quantum
Fourier transform adds, each written out from its definition:

* ``H``: the two halves of the qubit's axis become ``(a ± b) / √2``;
* ``CPhase(θ)``: the quarter where both bits are 1 is multiplied by
  ``e^{iθ}``;
* ``SWAP``: the quarters ``|01>`` and ``|10>`` of the two bits are
  exchanged.

Planes, bit order and precisions as ``statevector.py``: qubit 0 is the
most significant bit of the basis index, where it is the least in
Qiskit's ``QFT``; that is the one departure from the published circuit,
and it reverses the bitstrings, not the transform (the result is the DFT
of the index read with qubit 0 first). Runs gate by gate from ``|0...0>``
in float64, float32 or TF32 (``precision.Arith``).
"""

from __future__ import annotations

import math

from . import statevector as sv
from .precision import Arith


def _quarters(x, n: int, p: int, q: int):
    """Views of the four quarters of ``x`` by the bits of qubits ``p``
    and ``q``, keyed ``(bit p, bit q)``."""
    lo, hi = sorted((p, q))
    v = x.view(x.shape[0], 1 << lo, 2, 1 << (hi - lo - 1), 2,
               1 << (n - hi - 1))
    out = {}
    for a in (0, 1):
        for b in (0, 1):
            bits = (a, b) if p < q else (b, a)
            out[bits] = v[:, :, a, :, b]
    return out


def h(re, im, n, q, ar: Arith):
    r = 1.0 / math.sqrt(2.0)
    for x in (re, im):
        a, b = sv._halves(x, n, q)
        t = a.clone()
        ar.lin_(a, r, b, r)           # a' = (a + b) / √2
        ar.lin_(b, -r, t, r)          # b' = (a - b) / √2


def cphase(re, im, n, p, q, theta, ar: Arith):
    c, s = math.cos(theta), math.sin(theta)
    r = _quarters(re, n, p, q)[(1, 1)]
    i = _quarters(im, n, p, q)[(1, 1)]
    t = r.clone()
    ar.lin_(r, c, i, -s)              # re' = c re - s im
    ar.lin_(i, c, t, s)               # im' = c im + s re


def swap(re, im, n, p, q):
    for x in (re, im):
        qs = _quarters(x, n, p, q)
        a, b = qs[(0, 1)], qs[(1, 0)]
        t = a.clone()
        a.copy_(b)
        b.copy_(t)


def apply_gate(re, im, n: int, gate: dict, ar: Arith) -> None:
    name, tg = gate["name"], list(gate["targets"])
    if name == "H":
        h(re, im, n, tg[0], ar)
    elif name == "CPhase":
        cphase(re, im, n, tg[0], tg[1], float(gate["params"][0]), ar)
    elif name == "SWAP":
        swap(re, im, n, tg[0], tg[1])
    else:
        sv.apply_gate(re, im, n, gate, ar)


def simulate(circuit: dict, device, precision: str = "float64"):
    """``(re, im)`` flat planes of the circuit's final state from
    ``|0...0>``."""
    n = int(circuit["num_qubits"])
    if any(circuit.get("initial_states", [])):
        raise ValueError("the reference starts from |0...0> only")
    ar = Arith(precision)
    re, im = sv.basis_state(n, 1, device, precision)
    for g in sv.ordered_gates(circuit):
        apply_gate(re, im, n, g, ar)
    return re[0], im[0]
