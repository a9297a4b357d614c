"""The numbers that decide ``correct``, from the program's answers and the
plain reference's.

* ``state_gap``: ``||psi - psi_ref|| / ||psi_ref||`` over the whole state,
  the program's final state against the float64 reference, worst answer.
* ``counts_absz``: whether the counts are a sample of the reference's law.
  The score of an outcome x is ``log p_ref(x)``; over a sample of p_ref
  its mean is ``sum p log p`` with variance ``sum p (log p)^2 - (sum p log
  p)^2`` per shot. The answers' summed scores less their expectation, over
  their standard deviation, is N(0, 1) for a sound sampler; a sample of
  another law moves it (Gibbs' inequality: a flipped bit or a wrong state
  lowers the mean score). The number is its absolute value.
* ``law_absz``: the same score for noisy counts, against the scores of an
  independent sample of the plain trajectory reference (two samples of
  one law): the difference of the summed scores over its standard
  deviation, absolute.
* ``shots_missing``: how far the counts' total is from the shots asked.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_CHUNK = 1 << 26


def planes_gap(p_re, p_im, r_re, r_im) -> float:
    """``||p - r|| / ||r||`` of two states given as flat planes (``p_im``
    may be None for a real state), chunk by chunk in float64."""
    diff = torch.zeros((), dtype=torch.float64, device=r_re.device)
    norm = torch.zeros((), dtype=torch.float64, device=r_re.device)
    for s in range(0, r_re.numel(), _CHUNK):
        e = s + _CHUNK
        rr, ri = r_re[s:e].double(), r_im[s:e].double()
        dr = p_re[s:e].double() - rr
        di = (p_im[s:e].double() if p_im is not None else 0.0) - ri
        diff += dr.square().sum() + di.square().sum()
        norm += rr.square().sum() + ri.square().sum()
    return math.sqrt(float(diff) / float(norm))


def score_moments(r_re, r_im) -> tuple[float, float]:
    """``(sum p log p, sum p (log p)^2)`` of the reference's law."""
    m1 = torch.zeros((), dtype=torch.float64, device=r_re.device)
    m2 = torch.zeros_like(m1)
    total = torch.zeros_like(m1)
    for s in range(0, r_re.numel(), _CHUNK):
        p = r_re[s:s + _CHUNK].double().square() \
            + r_im[s:s + _CHUNK].double().square()
        total += p.sum()
        lp = torch.log(p.clamp(min=1e-300))
        m1 += (p * lp).sum()
        m2 += (p * lp.square()).sum()
    t = float(total)
    m1, m2 = float(m1) / t, float(m2) / t
    # moments of log(p / t): the law normalized
    lt = math.log(t)
    return m1 - lt, m2 - 2 * lt * m1 + lt * lt


def log_scores(idx: torch.Tensor, r_re, r_im) -> torch.Tensor:
    """``log p_ref`` (normalized by the reference's norm) at the basis
    indices ``idx``, float64 on the reference's device."""
    idx = idx.to(r_re.device)
    p = r_re[idx].double().square() + r_im[idx].double().square()
    norm = sum(float((r_re[s:s + _CHUNK].double().square()
                      + r_im[s:s + _CHUNK].double().square()).sum())
               for s in range(0, r_re.numel(), _CHUNK))
    return torch.log(p.clamp(min=1e-300)) - math.log(norm)


def counts_indices(counts: dict[str, int]) -> torch.Tensor:
    """One basis index per shot (qubit 0 is the bitstring's first
    character and the index's most significant bit)."""
    if not counts:
        return torch.zeros(0, dtype=torch.long)
    keys = np.array([int(k, 2) for k in counts], dtype=np.int64)
    reps = np.array(list(counts.values()), dtype=np.int64)
    return torch.from_numpy(np.repeat(keys, reps))


class Pooled:
    """A z statistic summed over answers: numerator and variance."""

    def __init__(self):
        self.num = 0.0
        self.var = 0.0

    def add(self, num: float, var: float) -> None:
        self.num += num
        self.var += var

    def absz(self) -> float:
        if self.var <= 0.0:
            return math.inf
        return abs(self.num) / math.sqrt(self.var)


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit; a missing or non-finite number
    fails."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
