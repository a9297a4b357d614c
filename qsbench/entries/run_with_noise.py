"""``Simulator(noise_model).run_with_noise(circuit, shots, seed)``: one
trajectory per shot through the trajectory engine, counts on the host.

The traffic's ``noise`` lists one-qubit channels added globally (on every
gate and target qubit), as the GUI's noisy Run does. An answer is the
counts and, for a request the check keeps, ``check["trajectories"]`` rows
of every batch of trajectory states the engine returned (rows drawn from
the request's seed) with the branch rows that the engine drew for them.

The check holds:

* ``traj_gap``: each kept trajectory state against the float64 reference
  replaying the same branch row (``reference.trajectories.replay``),
  ``||psi - psi_ref|| / ||psi_ref||``, the worst row. The branch rows are
  the engine's own draws, read as one Pauli index (I, X, Y, Z, the order
  of ``DepolarizingNoise``'s Kraus operators) per site in the reference's
  site order; a batch from another route of the engine, or with another
  count of sites, reads infinite. The draws' law is held by:
* ``law_absz``: an independent sample of as many shots from the plain
  trajectory reference, and the counts, compared by their score under the
  ideal float64 reference state;
* ``shots_missing``: the counts' total against the shots.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qsbench import check
from qsbench.reference import statevector as ref
from qsbench.reference import trajectories as ref_traj


def noise_model(port, traffic: dict):
    nm = port.NoiseModel()
    for ch in traffic["noise"]:
        nm.add_global_noise(getattr(port, ch["channel"])(float(ch["p"])))
    return nm


def serve_fn(port, traffic: dict, device):
    from quantum_simulator_tpu_torch.ops import program as prog

    nm = noise_model(port, traffic)
    sim = port.Simulator(noise_model=nm, device=device)
    shots = int(traffic["shots"])
    per_batch = int(traffic["check"]["trajectories"])

    def serve(circuit: dict, seed: int, keep: bool = False):
        c = port.QuantumCircuit.from_dict(circuit)
        if not keep:
            return sim.run_with_noise(c, shots=shots, seed=seed), None
        rows: list[tuple] = []
        pick = np.random.default_rng([seed, 1])
        batched = prog.batched_trajectories

        def kept(program, noise, *args, **kwargs):
            states, draws = batched(program, noise, *args, **kwargs)
            take = np.sort(pick.choice(states.shape[0], replace=False,
                                       size=min(per_batch, states.shape[0])))
            at = torch.as_tensor(take, device=states.device)
            rows.append((prog.trajectory_route(program, noise),
                         states[at].clone(), draws[at].clone()))
            return states, draws

        prog.batched_trajectories = kept
        try:
            result = sim.run_with_noise(c, shots=shots, seed=seed)
        finally:
            prog.batched_trajectories = batched
        return result, rows
    return serve


def trajectories(traffic: dict) -> int:
    return int(traffic["shots"])


def answer(served) -> dict:
    result, rows = served
    return {"counts": dict(result.measurement_counts), "rows": rows}


def rows_gap(circuit: dict, noise: list[dict], rows, device) -> float:
    """The worst kept trajectory's gap to the float64 replay of its branch
    row; infinite where none was kept or a batch cannot be replayed."""
    if not rows:
        return math.inf
    gap = 0.0
    for route, states, branch in rows:
        if route != "unitary":
            return math.inf
        try:
            r_re, r_im = ref_traj.replay(circuit, noise, branch, device)
        except ValueError:
            return math.inf
        s = states.to(device)
        d = ((s.real.double() - r_re).square()
             + (s.imag.double() - r_im).square()).sum(-1)
        norm = (r_re.square() + r_im.square()).sum(-1)
        gap = max(gap, float((d / norm).sqrt().max()))
        del r_re, r_im, s
    return gap


def check_answers(answers: list[tuple[dict, dict]], traffic: dict, device,
                  seed: int = 0) -> dict[str, float]:
    shots = int(traffic["shots"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    missing, z, gap = 0, check.Pooled(), 0.0
    while answers:
        circuit, ans = answers.pop(0)
        gap = max(gap, rows_gap(circuit, traffic["noise"], ans.pop("rows"),
                                device))
        counts = ans["counts"]
        missing += abs(sum(counts.values()) - shots)
        r_re, r_im = ref.simulate(circuit, device)
        mine = check.log_scores(check.counts_indices(counts), r_re, r_im)
        theirs = check.log_scores(
            ref_traj.sample(circuit, traffic["noise"], shots, gen, device),
            r_re, r_im)
        del r_re, r_im
        z.add(float(mine.sum()) / max(len(mine), 1)
              - float(theirs.sum()) / len(theirs),
              float(mine.var()) / max(len(mine), 1)
              + float(theirs.var()) / len(theirs))
    return {"traj_gap": gap, "law_absz": z.absz(),
            "shots_missing": float(missing)}
