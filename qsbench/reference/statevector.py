"""Plain statevector reference: a circuit dict applied gate by gate.

The state is two planes (re, im) of shape ``(B, 2^n)``: ``B`` states side
by side (1 for one circuit, more for the trajectory reference). Qubit 0 is
the most significant bit of the basis index, as in the circuit dicts.
Each gate is written out from its definition (``Ry``, ``Rz``, ``CNOT``
with control first): the one-qubit gates update the two halves of the
qubit's axis in place, ``CNOT`` swaps two quarters.
Gates run in the dict's order sorted by column, stably.
"""

from __future__ import annotations

import math

import torch

from .precision import Arith


def ordered_gates(circuit: dict) -> list[dict]:
    return sorted(circuit["gates"], key=lambda g: g.get("column", 0))


def basis_state(n: int, batch: int, device, precision: str):
    """``(re, im)`` planes of ``batch`` copies of ``|0...0>``."""
    dtype = Arith(precision).dtype
    re = torch.zeros((batch, 1 << n), dtype=dtype, device=device)
    im = torch.zeros_like(re)
    re[:, 0] = 1.0
    return re, im


def _halves(x: torch.Tensor, n: int, q: int):
    v = x.view(x.shape[0], 1 << q, 2, 1 << (n - q - 1))
    return v[:, :, 0], v[:, :, 1]


def ry(re, im, n, q, theta, ar: Arith):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    for x in (re, im):
        a, b = _halves(x, n, q)
        t = a.clone()
        ar.lin_(a, c, b, -s)          # a' = c a - s b
        ar.lin_(b, c, t, s)           # b' = s a + c b


def rz(re, im, n, q, theta, ar: Arith):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    for sign, half in ((-1.0, 0), (1.0, 1)):   # phase c + sign * i s
        r = _halves(re, n, q)[half]
        i = _halves(im, n, q)[half]
        t = r.clone()
        ar.lin_(r, c, i, -sign * s)   # re' = c re - sign s im
        ar.lin_(i, c, t, sign * s)    # im' = c im + sign s re


def cnot(re, im, n, control, target):
    lo, hi = sorted((control, target))
    for x in (re, im):
        v = x.view(x.shape[0], 1 << lo, 2, 1 << (hi - lo - 1), 2,
                   1 << (n - hi - 1))
        if control < target:
            a, b = v[:, :, 1, :, 0], v[:, :, 1, :, 1]
        else:
            a, b = v[:, :, 0, :, 1], v[:, :, 1, :, 1]
        t = a.clone()
        a.copy_(b)
        b.copy_(t)


def apply_gate(re, im, n: int, gate: dict, ar: Arith) -> None:
    name, tg = gate["name"], list(gate["targets"])
    params = gate.get("params", [])
    if name == "Ry":
        ry(re, im, n, tg[0], float(params[0]), ar)
    elif name == "Rz":
        rz(re, im, n, tg[0], float(params[0]), ar)
    elif name == "CNOT":
        cnot(re, im, n, tg[0], tg[1])
    else:
        raise ValueError(f"the reference has no gate {name!r}")


def simulate(circuit: dict, device, precision: str = "float64"):
    """``(re, im)`` flat planes of the circuit's final state from
    ``|0...0>``."""
    n = int(circuit["num_qubits"])
    if any(circuit.get("initial_states", [])):
        raise ValueError("the reference starts from |0...0> only")
    ar = Arith(precision)
    re, im = basis_state(n, 1, device, precision)
    for g in ordered_gates(circuit):
        apply_gate(re, im, n, g, ar)
    return re[0], im[0]


def probabilities(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``|amp|^2`` in float64."""
    return re.double().square() + im.double().square()
