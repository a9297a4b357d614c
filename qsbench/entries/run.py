"""``Simulator.run(circuit, shots, seed)``: the ideal entry point, from the
circuit dict to the counts on the host, measured in Z.

An answer keeps the final state the run returned (``StateVector`` below
n = 30, the executor's grouped ``PlanarStateVector`` from n = 30 on) and
its counts. The check holds each kept answer to the float64 reference
(``state_gap``), its counts to the reference's law (``counts_absz``) and their total to the shots (``shots_missing``).
"""

from __future__ import annotations

from qsbench import check
from qsbench.reference import statevector as ref


def serve_fn(port, traffic: dict, device):
    sim = port.Simulator(device=device)
    shots = int(traffic["shots"])

    def serve(circuit: dict, seed: int, keep: bool = False):
        """``keep`` changes nothing: every run returns its whole answer."""
        c = port.QuantumCircuit.from_dict(circuit)
        return sim.run(c, shots=shots, seed=seed)
    return serve


def trajectories(traffic: dict) -> int:
    return 0


def planes(state):
    """Flat ``(re, im)`` views of a returned state, no copy; ``im`` is
    None for a real grouped state."""
    if hasattr(state, "state_data"):          # PlanarStateVector
        x = state.state_data
        if state.is_planar:
            return x[0].reshape(-1), x[1].reshape(-1)
        return x.reshape(-1), None
    v = state.device_data                      # StateVector, complex
    return v.real, v.imag


def answer(result) -> dict:
    return {"state": planes(result.final_state),
            "counts": dict(result.measurement_counts)}


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
