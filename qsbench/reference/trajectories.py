"""Plain trajectory reference: noisy trajectories of a circuit dict.

A trajectory is the circuit with a Pauli after every gate on each of its
target qubits, for every channel of the noise spec (``{"channel":
"DepolarizingNoise", "p": p}``: I with probability 1 - p, X, Y or Z with
p / 3 each), then measured once in Z. Its Paulis are its branch row: one
index 0-3 (I, X, Y, Z) per site, the sites in the order gate (sorted by
column, stably), channel, target qubit. ``sample`` draws the rows from the
caller's ``torch.Generator``, never from the program under test;
``replay`` runs given rows, so that a program's own draws can be followed.
"""

from __future__ import annotations

import torch

from . import statevector as sv
from .precision import Arith

_PAULI_CHANNELS = {
    # channel name -> probabilities of (I, X, Y, Z) at strength p
    "DepolarizingNoise": lambda p: (1 - p, p / 3, p / 3, p / 3),
}


def pauli_tables(noise: list[dict]) -> list[tuple[float, float, float,
                                                  float]]:
    out = []
    for ch in noise:
        make = _PAULI_CHANNELS.get(ch["channel"])
        if make is None:
            raise ValueError(f"the reference has no channel "
                             f"{ch['channel']!r}")
        out.append(make(float(ch["p"])))
    return out


def site_tables(circuit: dict, noise: list[dict]) -> list[tuple]:
    """The (I, X, Y, Z) probabilities of every site, in branch-row order."""
    tables = pauli_tables(noise)
    return [probs for g in sv.ordered_gates(circuit) for probs in tables
            for _ in g["targets"]]


def draw(circuit: dict, noise: list[dict], batch: int,
         gen: torch.Generator, device) -> torch.Tensor:
    """(batch, sites) branch rows by inverse CDF, one uniform per site."""
    tables = site_tables(circuit, noise)
    if not tables:
        return torch.zeros((batch, 0), dtype=torch.long, device=device)
    cdf = torch.tensor(tables, dtype=torch.float64,
                       device=device).cumsum(1)
    u = torch.rand((batch, len(tables)), dtype=torch.float64, device=device,
                   generator=gen) * cdf[:, -1]
    return (u[:, :, None] >= cdf[None, :, :]).sum(-1).clamp_(max=3)


def _apply_paulis(re, im, n: int, q: int, which: torch.Tensor) -> None:
    """Per row, the Pauli ``which`` (0-3: I, X, Y, Z) on qubit ``q``: Z
    negates ``|1>``, X swaps the halves, Y is ``i X Z`` (its phase ``i``
    turns the row's (re, im) into (-im, re))."""
    flip = ((which == 1) | (which == 2)).view(-1, 1, 1)
    sign = torch.where((which == 2) | (which == 3), -1.0, 1.0).to(re.dtype)
    for x in (re, im):
        a, b = sv._halves(x, n, q)
        b.mul_(sign.view(-1, 1, 1))
        t = torch.where(flip, b, a)
        b.copy_(torch.where(flip, a, b))
        a.copy_(t)
    y = (which == 2).view(-1, 1)
    t = torch.where(y, -im, re)
    im.copy_(torch.where(y, re, im))
    re.copy_(t)


def replay(circuit: dict, noise: list[dict], branch: torch.Tensor, device,
           precision: str = "float64"):
    """``(re, im)`` planes ``(B, 2^n)`` of the trajectories of the ``B``
    branch rows."""
    n = int(circuit["num_qubits"])
    ntab = len(pauli_tables(noise))
    gates = sv.ordered_gates(circuit)
    sites = sum(ntab * len(g["targets"]) for g in gates)
    if branch.shape[1] != sites:
        raise ValueError(f"{branch.shape[1]} branch columns for {sites} "
                         f"sites")
    branch = branch.to(device)
    ar = Arith(precision)
    re, im = sv.basis_state(n, branch.shape[0], device, precision)
    k = 0
    for g in gates:
        sv.apply_gate(re, im, n, g, ar)
        for _ in range(ntab):
            for q in g["targets"]:
                _apply_paulis(re, im, n, q, branch[:, k])
                k += 1
    return re, im


def sample(circuit: dict, noise: list[dict], shots: int,
           gen: torch.Generator, device, precision: str = "float64",
           block: int = 1024) -> torch.Tensor:
    """``shots`` basis indices, one from each of ``shots`` independent
    trajectories, run ``block`` at a time."""
    out = []
    for start in range(0, shots, block):
        b = min(block, shots - start)
        re, im = replay(circuit, noise, draw(circuit, noise, b, gen, device),
                        device, precision)
        p = sv.probabilities(re, im)
        del re, im
        out.append(torch.multinomial(p, 1, generator=gen).view(-1))
        del p
    return torch.cat(out)
