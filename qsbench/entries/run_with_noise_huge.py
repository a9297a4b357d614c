"""``Simulator(noise_model).run_with_noise(circuit, shots, seed,
trajectories)`` at n >= 30: T trajectories one after the other, each an
8 GiB state through the n >= 30 trajectory engine, counts on the host.

The circuit dict carries its noise model (``families/
efficient_su2_noise.py``): channels by gate name, which the entry turns
into the port's ``NoiseModel`` (``add_gate_noise``) and strips before
``QuantumCircuit.from_dict``. For a request the check keeps, the entry
records, from the timed path itself, each trajectory's shot indices and
its window record (the basis indices and site branches of every window of
the monomial splice), and keeps the final state of one trajectory: the one
with the most jumps (branches other than 0) among the kept requests so
far, so that a fault in a jump's operator shows. At most one kept state
lives beside the running trajectory.

The check holds:

* ``traj_gap``: the kept state against the float64 reference replaying the
  same branches (``reference/kraus.replay``), ``||psi - psi_ref|| /
  ||psi_ref||``. The window record is mapped to the reference's site order
  by each site's draw slot; a trajectory from another route of the
  engine, or with another count of sites, reads infinite.
* ``law_absz``: the law of the draws. For each kept circuit the plain
  reference walks the no-jump row (every site's first Kraus operator) and
  gives at each site the sequential sampler's probability of a jump there,
  given no jump before (``reference/kraus.no_jump_path``). Every kept
  trajectory, up to and including its first jump (or to its end), is a
  run of such sites: the count of trajectories that jumped, less the sum
  of those probabilities over the sites they ran, over the root of the
  summed variances ``p (1 - p)``, is a sum of martingale increments, about
  N(0, 1) for draws of the reference's law. The number is its absolute
  value. It costs one walk a circuit, and tests the law of the first jump
  only: the sites after it would need a walk a trajectory.
* ``shots_absz``: the shots of the kept trajectories that drew no jump,
  whose state is the no-jump row's final state: their summed ``log p(x)``
  under that state less its mean, over its standard deviation
  (``check.counts_absz``'s score), absolute; 0 where every kept
  trajectory jumped.
* ``shots_missing``: the counts' total against the shots.
"""

from __future__ import annotations

import json
import math

import torch

from qsbench import check
from qsbench.reference import kraus

def noise_model(port, noise: list[dict]):
    nm = port.NoiseModel()
    for ch in noise:
        args = {k: v for k, v in ch.items() if k not in ("channel", "gates")}
        channel = getattr(port, ch["channel"])(**args)
        for gate in ch["gates"]:
            nm.add_gate_noise(gate, channel)
    return nm


class _Kept:
    """The kept requests' trajectory with the most jumps so far: its jump
    count and the row that holds its state."""

    def __init__(self):
        self.jumps = -1
        self.row: dict | None = None


def serve_fn(port, traffic: dict, device):
    from quantum_simulator_tpu_torch.ops import bigtraj, monomial_traj

    shots = int(traffic["shots"])
    T = int(traffic["trajectories"])
    sims: dict[str, object] = {}
    kept = _Kept()

    def simulator(noise):
        key = json.dumps(noise, sort_keys=True)
        if key not in sims:
            sims[key] = port.Simulator(noise_model=noise_model(port, noise),
                                       device=device)
        return sims[key]

    def serve(circuit: dict, seed: int, keep: bool = False):
        sim = simulator(circuit["noise"])
        c = port.QuantumCircuit.from_dict(
            {k: v for k, v in circuit.items() if k != "noise"})
        if not keep:
            return sim.run_with_noise(c, shots=shots, seed=seed,
                                      trajectories=T), None
        rows: list[dict] = []
        sample_fn = bigtraj.huge_trajectory_sample_fn
        state_body = bigtraj.huge_trajectory_state_body
        last: dict = {}

        def body(*args, **kwargs):
            x, planar, draws = state_body(*args, **kwargs)
            last["state"] = (x[0], planar)
            return x, planar, draws

        def sampled(program, noise, *args, **kwargs):
            run, planar = sample_fn(program, noise, *args, **kwargs)
            route = bigtraj.trajectory_evolve_route(program, noise)
            spec = (monomial_traj.monomial_spec(program, noise)
                    if route == "monomial" else None)

            def traced(*a, **k):
                out = run(*a, **k)
                row = {"route": route, "indices": out.indices.clone(),
                       "slots": _slots(spec), "draws": out.draws,
                       "state": None}
                jumps = _jumps(route, out.draws)
                if jumps > kept.jumps:
                    if kept.row is not None:
                        kept.row["state"] = None
                    kept.jumps, kept.row = jumps, row
                    row["state"] = last["state"]
                rows.append(row)
                last.clear()
                return out
            return traced, planar

        bigtraj.huge_trajectory_sample_fn = sampled
        bigtraj.huge_trajectory_state_body = body
        try:
            result = sim.run_with_noise(c, shots=shots, seed=seed,
                                        trajectories=T)
        finally:
            bigtraj.huge_trajectory_sample_fn = sample_fn
            bigtraj.huge_trajectory_state_body = state_body
        return result, rows
    return serve


def _slots(spec) -> list[list[int]] | None:
    """Per window, the draw slot of each of its sites (-1: no noise)."""
    if spec is None:
        return None
    return [[s.key_index for s in window] for window in spec.windows]


def _jumps(route: str, draws) -> int:
    if route != "monomial":
        return 0
    return int(sum(int(br.count_nonzero()) for _, br in draws))


def trajectories(traffic: dict) -> int:
    return int(traffic["trajectories"])


def answer(served) -> dict:
    result, rows = served
    return {"counts": dict(result.measurement_counts), "rows": rows or []}


def branch_row(row: dict) -> torch.Tensor | None:
    """The trajectory's branches in the reference's site order, ``(1,
    sites)``; None where its route or record cannot be mapped."""
    if row["route"] != "monomial" or row["slots"] is None:
        return None
    slots = row["slots"]
    n = sum(1 for w in slots for k in w if k >= 0)
    out = torch.full((1, n), -1, dtype=torch.long)
    if len(row["draws"]) != len(slots):
        return None
    for (_, br), window in zip(row["draws"], slots):
        br = br.cpu()
        for si, k in enumerate(window):
            if k >= 0:
                out[0, k] = br[0, si]
    return None if bool((out < 0).any()) else out


def state_gap(circuit: dict, row: dict, device) -> float:
    branch = branch_row(row)
    if branch is None:
        return math.inf
    try:
        r_re, r_im = kraus.replay(circuit, circuit["noise"], branch, device)
    except ValueError:
        return math.inf
    x, planar = row["state"]
    p_re = x[0].reshape(-1) if planar else x.reshape(-1)
    p_im = x[1].reshape(-1) if planar else None
    gap = check.planes_gap(p_re.to(device), None if p_im is None
                           else p_im.to(device), r_re[0], r_im[0])
    del r_re, r_im
    return gap


class FirstJumpLaw:
    """The kept trajectories' first jumps against the reference's
    probabilities along the no-jump row of their circuit."""

    def __init__(self):
        self.jumps = 0
        self.mean = 0.0
        self.var = 0.0
        self.unread = False
        # the sums over whole rows: what a draw of no jump at all reads
        self.whole_mean = 0.0
        self.whole_var = 0.0

    def add(self, branch: torch.Tensor | None, hazard: torch.Tensor):
        """``branch``: one trajectory's ``(1, sites)`` branch row in the
        reference's site order, or None where it cannot be mapped."""
        if branch is None or branch.shape[1] != len(hazard):
            self.unread = True
            return
        hit = torch.nonzero(branch[0]).view(-1)
        stop = int(hit[0]) + 1 if len(hit) else len(hazard)
        h = hazard[:stop]
        self.whole_mean += float(hazard.sum())
        self.whole_var += float((hazard * (1.0 - hazard)).sum())
        self.jumps += int(len(hit) > 0)
        self.mean += float(h.sum())
        self.var += float((h * (1.0 - h)).sum())

    def absz(self) -> float:
        if self.unread or self.var <= 0.0:
            return math.inf
        return abs(self.jumps - self.mean) / math.sqrt(self.var)


class NoJumpShots:
    """The shots of the trajectories that drew no jump, scored against the
    no-jump state."""

    def __init__(self):
        self.dev = 0.0
        self.var = 0.0

    def add(self, idx: torch.Tensor, r_re, r_im, moments):
        m1, m2 = moments
        self.dev += (float(check.log_scores(idx, r_re, r_im).sum())
                     - len(idx) * m1)
        self.var += len(idx) * max(m2 - m1 * m1, 0.0)

    def absz(self) -> float:
        if self.var <= 0.0:
            return 0.0
        return abs(self.dev) / math.sqrt(self.var)


class Check:
    """The check's sums over kept answers, fed one circuit at a time."""

    def __init__(self, traffic: dict, device):
        self.shots = int(traffic["shots"])
        self.device = device
        self.missing, self.gap, self.found = 0, 0.0, False
        self.law, self.scores = FirstJumpLaw(), NoJumpShots()

    def add(self, circuit: dict, ans: dict, draws: bool = True
            ) -> list[dict]:
        """One kept answer; its rows, whose draws a caller that passes
        ``draws=False`` adds later (``add_draws``)."""
        rows = ans.pop("rows")
        self.missing += abs(sum(ans["counts"].values()) - self.shots)
        self.add_states(circuit, rows)
        if rows and draws:
            self.add_draws(circuit, rows)
        return rows

    def add_states(self, circuit: dict, rows: list[dict]) -> None:
        """``traj_gap`` of the rows' kept state, which goes."""
        for row in rows:
            if row["state"] is not None:
                self.found = True
                self.gap = max(self.gap,
                               state_gap(circuit, row, self.device))
                row["state"] = None

    def add_draws(self, circuit: dict, rows: list[dict], path=None) -> None:
        """The rows' draws and no-jump shots; ``path``: the circuit's
        ``kraus.no_jump_path``, where the caller has it."""
        hazard, r_re, r_im = path or kraus.no_jump_path(
            circuit, circuit["noise"], self.device)
        moments = None
        for row in rows:
            branch = branch_row(row)
            self.law.add(branch, hazard)
            if branch is not None and not bool(branch.any()):
                moments = moments or check.score_moments(r_re, r_im)
                self.scores.add(row["indices"], r_re, r_im, moments)

    def numbers(self) -> dict[str, float]:
        return {"traj_gap": self.gap if self.found else math.inf,
                "law_absz": self.law.absz(),
                "shots_absz": self.scores.absz(),
                "shots_missing": float(self.missing)}


def check_answers(answers: list[tuple[dict, dict]], traffic: dict, device,
                  seed: int = 0) -> dict[str, float]:
    """``answers``: (circuit dict, answer) pairs, freed one by one; the
    check draws nothing, so ``seed`` is unused."""
    chk = Check(traffic, device)
    while answers:
        circuit, ans = answers.pop(0)
        chk.add(circuit, ans)
    return chk.numbers()
