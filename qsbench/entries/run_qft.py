"""``Simulator.run(circuit, shots, seed)`` for the QFT cells: the ideal
entry point of ``run.py``, its answers checked against the QFT reference
(``reference/qft.py``), which knows ``H``, ``CPhase`` and ``SWAP``.

The check holds each kept answer's final state to the float64 reference
(``state_gap``), its counts to the reference's law (``counts_absz``) and
their total to the shots (``shots_missing``), as ``run.py`` does.

The cells' per-layer metrics time the port's pair-diagonal and bit-pair
steps as whole functions (``ops.plan.apply_diag_pair_step``,
``apply_bitpair_step``); a port without them cannot be measured in these
cells, and its runs stop before the first request.
"""

from __future__ import annotations

from qsbench import check
from qsbench.entries import run
from qsbench.reference import qft as ref

STEP_FUNCTIONS = ("apply_diag_pair_step", "apply_bitpair_step")

trajectories = run.trajectories
answer = run.answer


def serve_fn(port, traffic: dict, device):
    from quantum_simulator_tpu_torch.ops import plan

    missing = [f for f in STEP_FUNCTIONS if not hasattr(plan, f)]
    if missing:
        raise RuntimeError(
            f"the port has no {', '.join(missing)} in ops.plan, which this "
            "cell's metrics time")
    return run.serve_fn(port, traffic, device)


def check_answers(answers: list[tuple[dict, dict]], traffic: dict, device,
                  seed: int = 0) -> dict[str, float]:
    """``answers``: (circuit dict, answer) pairs, freed one by one; the
    check draws nothing, so ``seed`` is unused."""
    shots = int(traffic["shots"])
    gap, missing, z = 0.0, 0, check.Pooled()
    while answers:
        circuit, ans = answers.pop(0)
        r_re, r_im = ref.simulate(circuit, device)
        p_re, p_im = ans.pop("state")
        gap = max(gap, check.planes_gap(p_re, p_im, r_re, r_im))
        del p_re, p_im
        counts = ans["counts"]
        missing += abs(sum(counts.values()) - shots)
        idx = check.counts_indices(counts)
        m1, m2 = check.score_moments(r_re, r_im)
        z.add(float(check.log_scores(idx, r_re, r_im).sum())
              - len(idx) * m1, len(idx) * (m2 - m1 * m1))
        del r_re, r_im
    return {"state_gap": gap, "counts_absz": z.absz(),
            "shots_missing": float(missing)}
