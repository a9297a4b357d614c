"""Error mitigation: zero-noise extrapolation and readout-error inversion.

Counterpart of ``quantum_simulator_tpu/mitigation.py`` (NumPy and the
circuit IR only): the standard NISQ workflow is noisy-run → mitigate →
report, and this module completes the loop:

* **Zero-noise extrapolation (ZNE)**: evaluate an observable at
  amplified noise levels via unitary gate folding ``G → G G† G`` (the
  circuit-level identity that multiplies every channel application
  count by the odd scale factor while leaving the ideal unitary fixed),
  then Richardson-extrapolate to the zero-noise limit. Folding is a
  pure circuit-IR transform — the folded circuit runs on any engine
  (statevector trajectories, density matrix) unchanged.
* **Readout mitigation**: per-qubit confusion matrices (tensored
  model — 2×2 per qubit, so calibration is O(n) circuits and inversion
  is n small solves applied along bit axes of the 2^n distribution,
  never a 2^n×2^n matrix). Calibrates either analytically from a
  :class:`~.noise.ReadoutError` or empirically from prepare-and-measure
  counts.

Qubit 0 = MSB of the basis index throughout (engine convention).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .circuit import GateInstance, QuantumCircuit

__all__ = [
    "inverse_gate", "inverse_circuit", "fold_circuit",
    "richardson_extrapolate", "zne_expectation", "ZNEResult",
    "ReadoutMitigator",
    "quasi_inverse_pauli", "pec_expectation", "PECResult",
]


# ---------------------------------------------------------------------------
# Unitary folding
# ---------------------------------------------------------------------------

_SELF_INVERSE = {"I", "H", "X", "Y", "Z", "CNOT", "CZ", "SWAP",
                 "Toffoli", "Fredkin", "Barrier"}
_DAG_SWAP = {"S": "S_DAG", "S_DAG": "S", "T": "T_DAG", "T_DAG": "T"}
_NEGATE_PARAM = {"Rx", "Ry", "Rz", "Phase", "CPhase"}


def inverse_gate(gate: GateInstance) -> GateInstance:
    """The inverse of one placed gate (column left to the caller)."""
    name, params = gate.gate_name, list(gate.params)
    if name in _SELF_INVERSE or name.startswith("MCZ"):
        pass  # diagonal ±1 / involution: its own inverse
    elif name in _DAG_SWAP:
        name = _DAG_SWAP[name]
    elif name in _NEGATE_PARAM:
        params = [-p for p in params]
    elif name == "U3":
        # U3(θ,φ,λ)† = U3(-θ,-λ,-φ)
        t, p, l = params
        params = [-t, -l, -p]
    else:
        raise ValueError(f"no inverse rule for gate {name!r} "
                         "(measurement or custom gate?)")
    return GateInstance(name, list(gate.target_qubits), params, gate.column)


def inverse_circuit(circuit: QuantumCircuit) -> QuantumCircuit:
    """C† as a circuit: columns reversed, every gate inverted."""
    inv = QuantumCircuit(num_qubits=circuit.num_qubits)
    columns = circuit.get_ordered_gates()
    for new_col, column in enumerate(reversed(columns)):
        for g in column:
            ig = inverse_gate(g)
            ig.column = new_col
            inv.add_gate(ig)
    return inv


def fold_circuit(circuit: QuantumCircuit, scale: int) -> QuantumCircuit:
    """Global unitary folding: ``C → C (C† C)^((scale-1)/2)``.

    ``scale`` must be an odd positive integer; the returned circuit is
    the same unitary with every gate (hence every per-gate noise
    application) repeated ``scale`` times. Measurement gates are not
    foldable — strip them first (they sit at circuit end in this IR, so
    engines ignore them for forward evolution anyway).

    Inverse passes emit S↔S_DAG / T↔T_DAG: per-gate noise added with
    ``add_gate_noise("S", ...)`` does NOT fire on the emitted
    ``S_DAG`` unless also registered there, breaking the
    noise∝scale assumption ZNE rests on — register channels on both a
    gate and its dagger (``zne_expectation(noise_model=...)`` warns).
    """
    if scale < 1 or scale % 2 == 0:
        raise ValueError(f"fold scale must be odd and >= 1, got {scale}")
    if any(g.gate_name == "Measure" for g in circuit.gates):
        raise ValueError("cannot fold a circuit containing Measure gates; "
                         "remove them (folding preserves the pre-measurement "
                         "unitary)")
    if scale == 1:
        return circuit.copy()
    folded = QuantumCircuit(num_qubits=circuit.num_qubits,
                            initial_states=list(circuit.initial_states))
    forward = circuit.get_ordered_gates()
    backward = inverse_circuit(circuit).get_ordered_gates()
    col = 0

    def _append(columns: list[list[GateInstance]]) -> None:
        nonlocal col
        for column in columns:
            for g in column:
                folded.add_gate(GateInstance(
                    g.gate_name, list(g.target_qubits), list(g.params), col))
            col += 1

    _append(forward)
    for _ in range((scale - 1) // 2):
        _append(backward)
        _append(forward)
    return folded


# ---------------------------------------------------------------------------
# Richardson extrapolation
# ---------------------------------------------------------------------------

def richardson_extrapolate(scales, values) -> float:
    """Extrapolate ``values = f(scales)`` to ``f(0)``.

    Uses the degree-(k-1) polynomial through all k points — for k
    points this is exactly the classic Richardson estimator
    ``sum_i v_i * prod_{j!=i} s_j/(s_j - s_i)`` (Lagrange basis at 0).
    """
    s = np.asarray(scales, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    if s.shape != v.shape or s.ndim != 1 or s.size == 0:
        raise ValueError("scales and values must be equal-length 1-D")
    if len(set(s.tolist())) != s.size:
        raise ValueError("scales must be distinct")
    total = 0.0
    for i in range(s.size):
        term = v[i]
        for j in range(s.size):
            if j != i:
                term *= s[j] / (s[j] - s[i])
        total += term
    return float(total)


@dataclass
class ZNEResult:
    """Zero-noise-extrapolated estimate with its raw noise-curve points."""

    value: float
    scales: list[int] = field(default_factory=list)
    raw_values: list[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"value": self.value, "scales": self.scales,
                "raw_values": self.raw_values}


def zne_expectation(evaluate, circuit: QuantumCircuit,
                    scales=(1, 3, 5), noise_model=None) -> ZNEResult:
    """Zero-noise extrapolation of ``evaluate(folded_circuit) -> float``.

    ``evaluate`` runs the circuit on whatever noisy engine the caller
    has (e.g. ``DensityMatrixSimulator`` for exact values, trajectory
    averages for sampled ones) and returns the observable; this
    function folds to each scale, collects the noise curve, and
    Richardson-extrapolates to scale 0.

    Folding assumes noise strength scales linearly with the fold
    factor, which requires every gate's channels to also fire on its
    inverse (folding emits S↔S_DAG, T↔T_DAG swaps). Global channels
    always satisfy this; per-gate noise added via ``add_gate_noise``
    may not. Pass ``noise_model`` to get a ``UserWarning`` when a gate
    in the circuit has channels its dagger lacks (the under-amplified
    case that silently breaks the extrapolation).
    """
    scales = list(scales)
    if noise_model is not None:
        def _specs(name):
            # Sorted: this heuristic intentionally targets MISSING or
            # EXTRA channels only, so registration order is ignored.
            # Ordering differences between non-commuting channels (e.g.
            # AmplitudeDamping vs a Pauli channel) are out of scope —
            # they amplify approximately, not exactly, under folding.
            return tuple(sorted(
                ch.spec_key()
                for ch in noise_model.channels_for_gate(name)))

        asymmetric = sorted({
            g.gate_name for g in circuit.gates
            if g.gate_name in _DAG_SWAP
            and _specs(g.gate_name) != _specs(_DAG_SWAP[g.gate_name])})
        if asymmetric:
            import warnings
            warnings.warn(
                f"ZNE folding emits the daggers of {asymmetric} but the "
                "noise model registers different channels on the dagger "
                "names — noise will not scale with the fold factor. "
                "Register the same channels on both names.",
                UserWarning, stacklevel=2)
    raw = [float(evaluate(fold_circuit(circuit, s))) for s in scales]
    return ZNEResult(value=richardson_extrapolate(scales, raw),
                     scales=scales, raw_values=raw)


# ---------------------------------------------------------------------------
# Readout mitigation
# ---------------------------------------------------------------------------

class ReadoutMitigator:
    """Tensored readout-error inversion.

    Holds one 2×2 column-stochastic confusion matrix per qubit
    (``C[q][measured, true]``) and applies the inverse along each bit
    axis of a measured distribution: O(n·2^n) work, no 2^n×2^n matrix.
    Inverted quasi-probabilities are clipped to the simplex and
    renormalized (the standard least-norm projection for finite-shot
    negativity).
    """

    def __init__(self, confusions: np.ndarray):
        confusions = np.asarray(confusions, dtype=np.float64)
        if confusions.ndim != 3 or confusions.shape[1:] != (2, 2):
            raise ValueError("confusions must have shape (n, 2, 2)")
        cols = confusions.sum(axis=1)
        if not np.allclose(cols, 1.0, atol=1e-6):
            raise ValueError("each confusion matrix must be "
                             "column-stochastic (columns sum to 1)")
        self.confusions = confusions
        self.num_qubits = confusions.shape[0]
        self._inverses = np.stack([np.linalg.inv(c) for c in confusions])

    # --- constructors ---------------------------------------------------

    @classmethod
    def from_readout_error(cls, error, num_qubits: int) -> "ReadoutMitigator":
        """Analytic calibration from a :class:`~.noise.ReadoutError`
        (same p01/p10 on every qubit — the model the engine corrupts
        with, so inversion is exact in expectation)."""
        c = np.asarray(error.confusion_matrix, dtype=np.float64)
        return cls(np.broadcast_to(c, (num_qubits, 2, 2)).copy())

    @classmethod
    def from_calibration_counts(cls, zeros_counts: dict[str, int],
                                ones_counts: dict[str, int]
                                ) -> "ReadoutMitigator":
        """Empirical tensored calibration from two prepare-and-measure
        experiments: all-|0…0⟩ and all-|1…1⟩ preparations.

        Per qubit q: P(read 1 | true 0) is qubit q's marginal 1-rate in
        ``zeros_counts``; P(read 0 | true 1) its 0-rate in
        ``ones_counts``. Two circuits calibrate every qubit (the
        tensored model has 2n parameters, and the two basis columns
        measure them all independently).
        """
        def _marginals(counts: dict[str, int]) -> np.ndarray:
            n = len(next(iter(counts)))
            total = sum(counts.values())
            ones = np.zeros(n)
            for bits, c in counts.items():
                bit_arr = (np.frombuffer(bits.encode(), np.uint8)
                           - ord("0")).astype(np.float64)
                ones += c * bit_arr
            return ones / total

        p01 = _marginals(zeros_counts)          # read-1 rate, true 0
        p10 = 1.0 - _marginals(ones_counts)     # read-0 rate, true 1
        n = p01.shape[0]
        conf = np.zeros((n, 2, 2))
        conf[:, 0, 0] = 1 - p01
        conf[:, 1, 0] = p01
        conf[:, 0, 1] = p10
        conf[:, 1, 1] = 1 - p10
        return cls(conf)

    # --- application ------------------------------------------------------

    def apply_to_probs(self, probs) -> np.ndarray:
        """Mitigate a length-2^n measured distribution (qubit 0 = MSB)."""
        n = self.num_qubits
        p = np.asarray(probs, dtype=np.float64)
        if p.shape != (2 ** n,):
            raise ValueError(f"expected shape ({2**n},), got {p.shape}")
        t = p.reshape((2,) * n)
        for q in range(n):
            t = np.moveaxis(
                np.tensordot(self._inverses[q], np.moveaxis(t, q, 0),
                             axes=([1], [0])), 0, q)
        out = np.clip(t.reshape(-1), 0.0, None)
        s = out.sum()
        return out / s if s > 0 else np.full_like(out, 1.0 / out.size)

    def apply_to_counts(self, counts: dict[str, int]) -> np.ndarray:
        """Counts dict → mitigated probability vector."""
        n = self.num_qubits
        p = np.zeros(2 ** n)
        total = sum(counts.values())
        for bits, c in counts.items():
            if len(bits) != n:
                raise ValueError(f"bitstring {bits!r} is not {n} bits")
            p[int(bits, 2)] = c / total
        return self.apply_to_probs(p)

    def expectation_z(self, counts: dict[str, int], qubit: int) -> float:
        """Mitigated ⟨Z_qubit⟩ from a counts dict."""
        probs = self.apply_to_counts(counts)
        n = self.num_qubits
        idx = np.arange(2 ** n)
        bit = (idx >> (n - 1 - qubit)) & 1
        return float(np.sum(probs * (1.0 - 2.0 * bit)))


# ---------------------------------------------------------------------------
# Probabilistic error cancellation (PEC)
# ---------------------------------------------------------------------------

# Pauli commutation character table, basis order (I, X, Y, Z):
# _CHAR[Q][P] = +1 if P and Q commute, -1 otherwise. Symmetric, and
# _CHAR @ _CHAR = 4 I, so it diagonalizes every Pauli channel:
# eigenvalues lam = _CHAR @ q, inverse quasi-probs eta = _CHAR @ (1/lam) / 4.
_CHAR = np.array([
    [1, 1, 1, 1],
    [1, 1, -1, -1],
    [1, -1, 1, -1],
    [1, -1, -1, 1],
], dtype=np.float64)

_PAULI_NAMES = ("I", "X", "Y", "Z")


def _pauli_probs(channel) -> np.ndarray | None:
    """(q_I, q_X, q_Y, q_Z) for single-qubit Pauli channels, else None."""
    kind = type(channel).__name__
    if kind == "BitFlipNoise":
        p = channel.probability
        return np.array([1 - p, p, 0.0, 0.0])
    if kind == "PhaseFlipNoise":
        p = channel.probability
        return np.array([1 - p, 0.0, 0.0, p])
    if kind == "DepolarizingNoise":
        p = channel.probability
        return np.array([1 - p, p / 3, p / 3, p / 3])
    return None


def quasi_inverse_pauli(channel):
    """Quasi-probability representation of a Pauli channel's inverse.

    Returns ``(paulis, etas)``: for 1-qubit channels ``paulis`` is
    ``("I","X","Y","Z")``; for :class:`~.noise.TwoQubitDepolarizingNoise`
    it is the 16 two-letter labels ``("II","IX",...,"ZZ")``. ``etas``
    sum to 1 but carry negative entries — applying Pauli ``P`` with
    probability ``|eta_P|/gamma`` and weighting by ``gamma*sign(eta_P)``
    implements the exact channel inverse (Temme-Bravyi-Gambetta PEC).
    Raises for non-Pauli channels (amplitude damping has no Pauli
    quasi-inverse).
    """
    q = _pauli_probs(channel)
    if q is not None:
        lam = _CHAR @ q
        if np.any(np.abs(lam) < 1e-12):
            raise ValueError("channel is singular (eigenvalue 0); "
                             "no quasi-inverse exists")
        etas = _CHAR @ (1.0 / lam) / 4.0
        return _PAULI_NAMES, etas
    if type(channel).__name__ == "TwoQubitDepolarizingNoise":
        # lam = 1 - 16 p / 15 on every non-identity two-qubit Pauli.
        lam = 1.0 - 16.0 * channel.probability / 15.0
        if abs(lam) < 1e-12:
            raise ValueError("channel is singular (eigenvalue 0); "
                             "no quasi-inverse exists")
        p_inv = (15.0 / 16.0) * (1.0 - 1.0 / lam)
        labels = tuple(a + b for a in _PAULI_NAMES for b in _PAULI_NAMES)
        etas = np.full(16, p_inv / 15.0)
        etas[0] = 1.0 - p_inv
        return labels, etas
    raise ValueError(
        f"{type(channel).__name__} is not a Pauli channel; PEC needs a "
        "Pauli quasi-inverse (use ZNE for general channels)")


@dataclass
class PECResult:
    """PEC estimate with its sampling-cost factor."""

    value: float
    gamma: float                 # total quasi-probability 1-norm
    n_locations: int
    samples: int | None = None   # None = exact enumeration

    def to_dict(self) -> dict:
        return {"value": self.value, "gamma": self.gamma,
                "n_locations": self.n_locations, "samples": self.samples}


def _noise_locations(circuit: QuantumCircuit, noise_model):
    """Every (insert_after_index, qubits, paulis, etas) the model's
    channels create, in execution order. 1-qubit channels fire once per
    target qubit (matching ``NoiseModel.apply``); 2-qubit depolarizing
    fires once per 2-qubit gate."""
    order = [g for col in circuit.get_ordered_gates() for g in col]
    locations = []
    for idx, g in enumerate(order):
        for ch in noise_model.channels_for_gate(g.gate_name):
            if type(ch).__name__ == "TwoQubitDepolarizingNoise":
                if len(g.target_qubits) == 2:
                    paulis, etas = quasi_inverse_pauli(ch)
                    locations.append((idx, tuple(g.target_qubits),
                                      paulis, etas))
                continue
            paulis, etas = quasi_inverse_pauli(ch)
            for q in g.target_qubits:
                locations.append((idx, (q,), paulis, etas))
    return order, locations


def _insert_recoveries(order, circuit: QuantumCircuit,
                       choices) -> QuantumCircuit:
    """Rebuild the circuit one gate per column, splicing chosen recovery
    Paulis right after their location's gate. ``initial_states`` carry
    over from the source circuit (a |1⟩-prepared qubit must stay
    prepared in every recovery variant)."""
    out = QuantumCircuit(num_qubits=circuit.num_qubits,
                         initial_states=list(circuit.initial_states))
    col = 0
    by_gate: dict[int, list[tuple[tuple[int, ...], str]]] = {}
    for (idx, qubits, _p, _e), label in choices:
        by_gate.setdefault(idx, []).append((qubits, label))
    for idx, g in enumerate(order):
        out.add_gate(GateInstance(g.gate_name, list(g.target_qubits),
                                  list(g.params), col))
        col += 1
        for qubits, label in by_gate.get(idx, ()):
            for q, letter in zip(qubits, label):
                if letter != "I":
                    out.add_gate(GateInstance(letter, [q], [], col))
            col += 1
    return out


def pec_expectation(evaluate, circuit: QuantumCircuit, noise_model,
                    samples: int | None = None,
                    seed: int | None = None,
                    max_enumeration: int = 4096) -> PECResult:
    """Probabilistic error cancellation of ``evaluate``'s observable.

    ``evaluate(circuit) -> float`` must run the circuit on the SAME
    noisy engine the quasi-inverse was built for (per-gate Pauli
    channels via ``noise_model.add_gate_noise``). Recovery Paulis are
    spliced in as ordinary X/Y/Z gates, so the noise model must not
    attach channels to them (global channels would re-corrupt the
    recovery operations — rejected with a pointer to ZNE).

    ``samples=None`` exactly enumerates all recovery combinations
    (product of per-location supports; capped at ``max_enumeration``) —
    the estimator's zero-variance limit, exact up to the engine's own
    accuracy. With ``samples=N`` it Monte-Carlo samples the standard
    gamma-weighted sign estimator.
    """
    if noise_model.global_channels:
        raise ValueError(
            "PEC requires gate-specific noise (add_gate_noise); global "
            "channels would also corrupt the recovery Paulis — use "
            "zne_expectation for global noise")
    order, locations = _noise_locations(circuit, noise_model)
    if not locations:
        return PECResult(value=float(evaluate(circuit.copy())), gamma=1.0,
                         n_locations=0, samples=samples)
    noisy_recovery = [p for p in ("X", "Y", "Z")
                      if noise_model.channels_for_gate(p)]
    if noisy_recovery:
        raise ValueError(
            f"noise model attaches channels to {noisy_recovery}, which PEC "
            "splices in as noiseless recovery operations — those channels "
            "would fire on the recoveries and bias the estimate. Register "
            "noise on other gate names, or use zne_expectation")
    gamma = float(np.prod([np.abs(e).sum() for *_x, e in locations]))

    if samples is None:
        supports = []
        total = 1
        for idx, qubits, paulis, etas in locations:
            nz = [(paulis[k], etas[k]) for k in range(len(etas))
                  if abs(etas[k]) > 1e-15]
            supports.append((idx, qubits, paulis, etas, nz))
            total *= len(nz)
        if total > max_enumeration:
            raise ValueError(
                f"exact PEC would enumerate {total} circuits "
                f"(> {max_enumeration}); pass samples=N")

        def _recurse(k: int, weight: float, choices) -> float:
            if k == len(supports):
                circ = _insert_recoveries(order, circuit, choices)
                return weight * float(evaluate(circ))
            idx, qubits, paulis, etas, nz = supports[k]
            return sum(
                _recurse(k + 1, weight * eta,
                         choices + [((idx, qubits, paulis, etas), label)])
                for label, eta in nz)

        return PECResult(value=_recurse(0, 1.0, []), gamma=gamma,
                         n_locations=len(locations), samples=None)

    rng = np.random.default_rng(seed)
    acc = 0.0
    for _ in range(samples):
        sign = 1.0
        choices = []
        for loc in locations:
            etas = loc[3]
            probs = np.abs(etas) / np.abs(etas).sum()
            k = int(rng.choice(len(etas), p=probs))
            sign *= np.sign(etas[k]) or 1.0
            choices.append((loc, loc[2][k]))
        circ = _insert_recoveries(order, circuit, choices)
        acc += sign * float(evaluate(circ))
    return PECResult(value=gamma * acc / samples, gamma=gamma,
                     n_locations=len(locations), samples=samples)
