"""Plain general-Kraus trajectory reference: noisy trajectories of a circuit
dict under a noise model given per gate name.

The noise is a list of channels, each ``{"channel": name, "gates": [gate
names], ...its parameters}`` (the circuit dicts of
``families/efficient_su2_noise.py`` carry it as ``noise``). After every
gate, each channel that lists the gate's name acts on each of the gate's
target qubits in turn, through one of its Kraus operators. A site is one
such (gate, channel, target qubit); the sites run in the order gate
(sorted by column, stably), channel (as listed), target qubit (as listed).
A trajectory's branches are one Kraus index per site, in that order.

* ``replay(circuit, noise, branches)``: for each gate in order, the gate,
  then at each of its sites the Kraus operator the branch names;
  normalized once at the end (or left unnormalized: its squared norm is
  then the probability of the whole branch row). It follows a program's
  own draws.
* ``sample(circuit, noise, trajectories, shots, gen)``: independent
  sequential stochastic-Kraus trajectories: at each site the branch ``m``
  is drawn with probability ``p_m = ||K_m psi||^2`` (``psi`` of norm 1)
  from the caller's ``torch.Generator``, never from the program under
  test, and the state becomes ``K_m psi / sqrt(p_m)``; then ``shots``
  basis indices from each trajectory's final state.
* ``no_jump_path(circuit, noise)``: the no-jump row's trajectory with, at
  each of its sites, the sampler's probability of a jump there: the law of
  a trajectory's first jump, against which a program's draws are held.

Channels (written out from their definitions):

* ``ThermalRelaxationNoise`` (``t1``, ``t2``, ``time`` in one unit, ``t2
  <= 2 t1``): amplitude damping with ``gamma = 1 - exp(-time / t1)``
  composed with the pure dephasing ``lam = 1 - exp(-time (2 / t2 - 1 /
  t1))`` that makes the coherence decay by ``exp(-time / t2)``: ``K0 =
  diag(1, sqrt((1 - gamma)(1 - lam)))``, ``K1 = sqrt(gamma) |0><1|``,
  ``K2 = sqrt((1 - gamma) lam) |1><1|``. A trajectory's law depends on
  the Kraus set and not only on the channel, so this set is the one a
  program under comparison must unravel.

Departures from the published settings (Qiskit Aer's "Building Noise
Models", T1/T2 section): qubit 0 is the most significant bit of the basis
index (Qiskit's least), so bitstrings read reversed; one T1 and one T2
for every qubit, where the tutorial draws them per qubit; relaxation at
zero temperature, as the tutorial's.

Arithmetic is ``precision.Arith``'s: float64 for the reference, and the
TF32 control's rounded factors. Every product on a state is an elementwise
one; the one matrix product (``K^+ K`` of a 2 x 2 stack) is complex128,
and TF32 is off for float32 matrix products besides.
"""

from __future__ import annotations

import math

import torch

from . import statevector as sv
from .precision import Arith, round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def thermal_kraus(t1: float, t2: float, time: float) -> list[list[list]]:
    """The three 2 x 2 Kraus operators of T1/T2 relaxation over ``time``."""
    if not (t1 > 0 and t2 > 0 and time >= 0 and t2 <= 2 * t1 + 1e-12):
        raise ValueError(f"thermal relaxation needs t1, t2 > 0, t2 <= 2 t1 "
                         f"and time >= 0 (t1={t1}, t2={t2}, time={time})")
    gamma = 1.0 - math.exp(-time / t1)
    lam = 1.0 - math.exp(-time * max(2.0 / t2 - 1.0 / t1, 0.0))
    return [[[1.0, 0.0], [0.0, math.sqrt((1 - gamma) * (1 - lam))]],
            [[0.0, math.sqrt(gamma)], [0.0, 0.0]],
            [[0.0, 0.0], [0.0, math.sqrt((1 - gamma) * lam)]]]


_CHANNELS = {
    "ThermalRelaxationNoise": lambda ch: thermal_kraus(
        float(ch["t1"]), float(ch["t2"]), float(ch["time"])),
}


def channel_kraus(ch: dict) -> list:
    make = _CHANNELS.get(ch["channel"])
    if make is None:
        raise ValueError(f"the reference has no channel {ch['channel']!r}")
    return make(ch)


def site_channels(circuit: dict, noise: list[dict]) -> list[tuple[int, int]]:
    """``(channel index, qubit)`` of every site, in branch order."""
    return [(c, q) for g in sv.ordered_gates(circuit)
            for c, ch in enumerate(noise) if g["name"] in ch["gates"]
            for q in g["targets"]]


def _walk(circuit: dict, noise: list[dict], re, im, ar: Arith):
    """Apply the circuit's gates to the planes in order and yield each
    site as ``(site index, channel index, qubit)`` after its gate, before
    its Kraus operator, which the caller applies."""
    n = int(circuit["num_qubits"])
    s = 0
    for g in sv.ordered_gates(circuit):
        sv.apply_gate(re, im, n, g, ar)
        for c, ch in enumerate(noise):
            if g["name"] not in ch["gates"]:
                continue
            for q in g["targets"]:
                yield s, c, q
                s += 1


def _stacks(noise: list[dict], device, dtype) -> list[tuple]:
    """Each channel's Kraus operators as ``(m, 2, 2)`` real and imaginary
    parts on the device."""
    out = []
    for ch in noise:
        k = torch.tensor(channel_kraus(ch), dtype=torch.complex128)
        out.append((k.real.to(device, dtype), k.imag.to(device, dtype)))
    return out


def _row_scale(x: torch.Tensor, c: torch.Tensor, ar: Arith) -> torch.Tensor:
    """``c[b] * x[b]`` for a half ``(B, pre, post)`` and ``(B,)`` factors,
    as a new tensor."""
    if ar.tf32:
        return round_tf32(x) * round_tf32(c).view(-1, 1, 1)
    return x * c.view(-1, 1, 1)


def _apply_kraus(re, im, n: int, q: int, k_re: torch.Tensor,
                 k_im: torch.Tensor, ar: Arith) -> None:
    """Per row ``b``, the 2 x 2 operator ``k[b]`` on qubit ``q``, in place.
    Entries that are zero in every row are left out; a diagonal operator
    scales each half in place."""
    halves = (sv._halves(re, n, q), sv._halves(im, n, q))
    live_re = [[bool(k_re[:, r, c].any()) for c in (0, 1)] for r in (0, 1)]
    live_im = [[bool(k_im[:, r, c].any()) for c in (0, 1)] for r in (0, 1)]
    if not any(live_im[0] + live_im[1]) and not (
            live_re[0][1] or live_re[1][0]):
        for r in (0, 1):                        # real diagonal: in place
            c = k_re[:, r, r]
            if bool((c == 1).all()):
                continue
            for h in halves:
                if ar.tf32:
                    h[r].copy_(_row_scale(h[r], c, ar))
                else:
                    h[r].mul_(c.view(-1, 1, 1))
        return
    out = []
    for r in (0, 1):
        acc_re = torch.zeros_like(halves[0][0])
        acc_im = torch.zeros_like(halves[1][0])
        for c in (0, 1):
            x_re, x_im = halves[0][c], halves[1][c]
            if live_re[r][c]:
                acc_re += _row_scale(x_re, k_re[:, r, c], ar)
                acc_im += _row_scale(x_im, k_re[:, r, c], ar)
            if live_im[r][c]:
                acc_re -= _row_scale(x_im, k_im[:, r, c], ar)
                acc_im += _row_scale(x_re, k_im[:, r, c], ar)
        out.append((acc_re, acc_im))
    for r in (0, 1):
        halves[0][r].copy_(out[r][0])
        halves[1][r].copy_(out[r][1])


def norm_sq(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``(B,)`` float64: each row's squared norm."""
    return (torch.linalg.vector_norm(re.double(), dim=-1).square()
            + torch.linalg.vector_norm(im.double(), dim=-1).square())


def replay(circuit: dict, noise: list[dict], branches: torch.Tensor, device,
           precision: str = "float64", normalize: bool = True):
    """``(re, im)`` planes ``(B, 2^n)`` of the trajectories of the ``B``
    branch rows ``(B, sites)``, each normalized once at the end. With
    ``normalize=False`` the rows are left as the Kraus operators made them:
    a row's squared norm is then the probability that the sequential
    sampler draws that whole row."""
    n = int(circuit["num_qubits"])
    sites = len(site_channels(circuit, noise))
    if branches.ndim != 2 or branches.shape[1] != sites:
        raise ValueError(f"branch rows {tuple(branches.shape)} for {sites} "
                         f"sites")
    ar = Arith(precision)
    stacks = _stacks(noise, device, ar.dtype)
    branches = branches.to(device)
    re, im = sv.basis_state(n, branches.shape[0], device, precision)
    for s, c, q in _walk(circuit, noise, re, im, ar):
        m = branches[:, s]
        _apply_kraus(re, im, n, q, stacks[c][0][m], stacks[c][1][m], ar)
    if normalize:
        inv = norm_sq(re, im).rsqrt().to(re.dtype).view(-1, 1)
        re.mul_(inv)
        im.mul_(inv)
    return re, im


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x is y:
        return torch.linalg.vector_norm(x.double(), dim=(1, 2)).square()
    return (x.double() * y.double()).sum((1, 2))


def branch_probabilities(re, im, n: int, q: int,
                         kraus: torch.Tensor) -> torch.Tensor:
    """``(B, m)`` float64: ``||K_m psi||^2`` for each row's state and each
    operator of the ``(m, 2, 2)`` complex128 stack ``kraus``: ``sum_cc'
    (K^+ K)[c, c'] G[c, c']`` with ``G[c, c'] = <x_c, x_c'>`` the Gram of
    the halves of qubit ``q``. ``G``'s off-diagonal entry is computed only
    where some ``K^+ K`` has one."""
    (a_re, b_re), (a_im, b_im) = sv._halves(re, n, q), sv._halves(im, n, q)
    m = kraus.conj().transpose(-1, -2) @ kraus               # (m, 2, 2)
    g00 = _dot(a_re, a_re) + _dot(a_im, a_im)
    g11 = _dot(b_re, b_re) + _dot(b_im, b_im)
    d = m.to(g00.device)
    p = d[None, :, 0, 0].real * g00[:, None] + d[None, :, 1, 1].real * \
        g11[:, None]
    if bool((m[:, 0, 1] != 0).any()):
        g01 = torch.complex(_dot(a_re, b_re) + _dot(a_im, b_im),
                            _dot(a_re, b_im) - _dot(a_im, b_re))
        p = p + 2.0 * (d[None, :, 0, 1] * g01[:, None]).real
    return p.clamp(min=0.0)


def no_jump_path(circuit: dict, noise: list[dict], device,
                 precision: str = "float64"):
    """The trajectory of the no-jump row (every site's first Kraus
    operator): ``(hazard, re, im)``. ``hazard[s]`` (``(sites,)`` float64 on
    the host) is the probability that the sequential sampler, having drawn
    the first operator at every site before ``s``, draws another one at
    ``s``: ``sum_{m > 0} p_m`` with ``p_m = ||K_m psi||^2 / ||psi||^2`` of
    the state before the site. ``(re, im)`` is the row's final state,
    normalized: the state of a trajectory that drew no jump."""
    n = int(circuit["num_qubits"])
    ar = Arith(precision)
    stacks = _stacks(noise, device, ar.dtype)
    exact = [torch.tensor(channel_kraus(ch), dtype=torch.complex128)
             for ch in noise]
    re, im = sv.basis_state(n, 1, device, precision)
    hazard = []
    for _, c, q in _walk(circuit, noise, re, im, ar):
        p = branch_probabilities(re, im, n, q, exact[c])[0]
        hazard.append(p[1:].sum() / p.sum())
        _apply_kraus(re, im, n, q, stacks[c][0][:1], stacks[c][1][:1], ar)
    inv = norm_sq(re, im).rsqrt().to(re.dtype).view(-1, 1)
    re.mul_(inv)
    im.mul_(inv)
    out = (torch.stack(hazard).cpu() if hazard
           else torch.zeros(0, dtype=torch.float64))
    return out, re[0], im[0]


def sample(circuit: dict, noise: list[dict], trajectories: int, shots: int,
           gen: torch.Generator, device, precision: str = "float64",
           with_branches: bool = False):
    """``(trajectories, shots)`` basis indices: ``shots`` from each of
    ``trajectories`` independent stochastic-Kraus trajectories, run one
    at a time. With ``with_branches`` also their ``(trajectories,
    sites)`` branch rows."""
    n = int(circuit["num_qubits"])
    ar = Arith(precision)
    stacks = _stacks(noise, device, ar.dtype)
    exact = [torch.tensor(channel_kraus(ch), dtype=torch.complex128)
             for ch in noise]
    out, rows = [], []
    for _ in range(trajectories):
        re, im = sv.basis_state(n, 1, device, precision)
        drawn = []
        for _, c, q in _walk(circuit, noise, re, im, ar):
            p = branch_probabilities(re, im, n, q, exact[c])[0]
            cdf = p.cumsum(0)
            u = torch.rand((), dtype=torch.float64, device=device,
                           generator=gen) * cdf[-1]
            m = int((u >= cdf).sum().clamp(max=len(p) - 1))
            drawn.append(m)
            scale = 1.0 / math.sqrt(max(float(p[m]), 1e-300))
            k_re, k_im = stacks[c]
            _apply_kraus(re, im, n, q, k_re[m:m + 1] * scale,
                         k_im[m:m + 1] * scale, ar)
        out.append(sample_indices(re[0], im[0], shots, gen))
        rows.append(drawn)
        del re, im
    idx = torch.stack(out)
    if with_branches:
        return idx, torch.tensor(rows, dtype=torch.long).view(
            trajectories, -1)
    return idx


def sample_indices(re: torch.Tensor, im: torch.Tensor, shots: int,
                   gen: torch.Generator) -> torch.Tensor:
    """``shots`` basis indices of the flat state ``re + i im`` by inverse
    CDF over ``|amp|^2``, float64."""
    cdf = sv.probabilities(re, im).cumsum_(0)
    u = torch.rand(shots, dtype=torch.float64, device=re.device,
                   generator=gen) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
    del cdf
    return idx
