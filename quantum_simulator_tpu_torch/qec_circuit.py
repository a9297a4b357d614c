"""Circuit-level-noise QEC memory on the Clifford tableau engine.

Counterpart of ``quantum_simulator_tpu/qec_circuit.py``. The other QEC
engines draw phenomenological noise (``qec_frame``); this module runs the
REAL syndrome-extraction circuit (ancilla qubits, H / CNOT ladders,
mid-circuit measurements) as noisy Clifford trajectories, so every fault
location the hardware has exists in the simulation. Decoding matches on
the circuit's own measured detector error model (``qec_dem``, default) or
on the hand-built space-time graph with schedule diagonals
(``qec_matching.space_time_graph``).

No mid-circuit resets: ancillas are measured and reused, so round r's
outcome obeys ``o_r = o_{r-1} XOR s_r`` and per-round syndromes are
consecutive-outcome differences (an ancilla flip after its readout
cancels telescopically, one measurement-error edge).

Three samplers, all identical in every outcome under the same draws
(``uniforms[T, L]``, one float32 per trial and schedule step, JAX's
``uniform(k_t, (L,))``):

* ``"clifford"``: the batched tableau walk of ``clifford.walk``;
* ``"frame"``: the Pauli-frame walk (stim's trick), one (x, z) bit pair
  per qubit and trial, against a reference sample from one clean tableau
  run (its random outcomes from ``ref_uniforms[1, L_clean]``);
* ``"linear"`` (default): frame propagation is GF(2)-linear, so every
  noise site's unit faults have fixed measurement-flip signatures, probed
  once by ONE batched frame walk over 4S injected rows; sampling is then
  the per-site Pauli bits times the ``(4S, M)`` signature matrix mod 2,
  a float32 product with TF32 off (exact below 2^24), in batches of
  trials cut by bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .circuit import GateInstance, QuantumCircuit
from .clifford import (_OP_CNOT, _OP_H, _OP_MEASURE, _OP_NOISE_DEPOL2,
                       _OP_NOISE_BF, _OP_NOISE_DEPOL, _OP_NOISE_PF, _OP_S,
                       _OP_SDAG, _OP_SWAP, _lower, _pauli_bits,
                       _walk_batches, identity_tableau, walk)
from .config import CONFIG
from .noise import DepolarizingNoise, NoiseModel
from .qec import _rotated_surface_geometry
from .qec_matching import space_time_decode_fn
from .simulator import TRAJECTORY_MEMORY_BYTES


def _check_schedule(checks: list[list[int]], d: int,
                    order: tuple[int, ...]) -> list[dict[int, int]]:
    """Per-check ``{step: data_qubit}`` CNOT schedule.

    Each check's support qubits sit in fixed SLOTS of its (possibly
    boundary-clipped) 2x2 cell — 0=NW 1=NE 2=SW 3=SE — and ``order``
    maps step k to the slot read at step k.  Two rules make the
    schedule sound, both test-locked:

    - **Slot-true steps for boundary half-cells.**  A weight-2 check
      keeps its qubits' full-cell slots (a top-row X half-cell holds
      SW/SE, a left-column Z half-cell NE/SE, etc.).  Compressing them
      to the first free steps breaks the even-overlap commutation rule
      with neighboring full cells: mid-round, exactly one of the two
      shared qubits would see the X-check's CNOT before the Z-check's,
      entangling the two ancillas and randomizing the Z syndrome
      (measured: the d=3 top-boundary X check made Z-check 0's outcome
      a coin flip at p=0).
    - **Hook orientation.**  An ancilla fault after step k propagates
      to the remaining targets, so the last two slots read are the
      weight-2 data hook; X hooks must land perpendicular to X_L
      (column 0) and Z hooks perpendicular to Z_L (row 0) — hence the
      two different zigzags chosen by the caller.
    """
    out = []
    for sup in checks:
        coords = sorted((q // d, q % d) for q in sup)
        rows = {rc[0] for rc in coords}
        cols = {rc[1] for rc in coords}
        if len(sup) == 4:
            r0, c0 = min(rows), min(cols)
        elif len(rows) == 1:        # horizontal pair: row-edge half-cell
            r0 = -1 if next(iter(rows)) == 0 else d - 1
            c0 = min(cols)
        else:                       # vertical pair: col-edge half-cell
            c0 = -1 if next(iter(cols)) == 0 else d - 1
            r0 = min(rows)
        sched: dict[int, int] = {}
        for rr, cc in coords:
            slot = (rr - r0) * 2 + (cc - c0)
            sched[order.index(slot)] = rr * d + cc
        out.append(sched)
    return out


@dataclass(frozen=True)
class ExtractionLayout:
    """Index bookkeeping for one extraction circuit's measurement record
    (outcome positions are schedule order: per round all Z ancillas then
    all X ancillas, finally the data qubits)."""

    distance: int
    n_rounds: int
    n_data: int
    n_z: int
    n_x: int
    basis: str                  # "z" (|0>_L vs X errors) | "x" (|+>_L)
    sector_matrix: np.ndarray   # decoded sector's (nc, n_data) checks
    sector_support: np.ndarray  # (n_data,) decoded logical's support
    sector_diagonals: tuple     # per data qubit: None | (early, late)
                                # check rows by CNOT step order — the
                                # circuit-aware diagonal edges

    def sector_outcomes(self, outcomes: np.ndarray) -> np.ndarray:
        """(T, M) full record -> (T, R, nc) decoded-sector ancilla
        outcomes (Z ancillas come first in each round's block)."""
        per_round = self.n_z + self.n_x
        o = outcomes[:, :self.n_rounds * per_round]
        o = o.reshape(-1, self.n_rounds, per_round)
        return (o[:, :, :self.n_z] if self.basis == "z"
                else o[:, :, self.n_z:])

    def data_outcomes(self, outcomes: np.ndarray) -> np.ndarray:
        """(T, M) full record -> (T, n_data) final transversal readout
        (Z basis for the z memory, X basis for the x memory)."""
        start = self.n_rounds * (self.n_z + self.n_x)
        return outcomes[:, start:start + self.n_data]


def repetition_extraction_circuit(
        distance: int,
        n_rounds: int) -> tuple[QuantumCircuit, ExtractionLayout]:
    """R-round bit-flip repetition-chain extraction circuit.

    ``d`` data qubits in a line, one ancilla per adjacent pair; each
    round is two CNOT steps (check i reads data i then data i+1 —
    all-Z-type, so there is no commutation constraint) and an ancilla
    measurement column (no reset, same outcome-chain convention as the
    surface circuit).  The logical readout is data bit 0, matching
    ``qec_frame.build_ml_memory_fn``; only the z memory exists (the
    code has no X checks).  With the linear sampler this makes
    circuit-level bit-flip memories at d=25+ a single small matmul.
    """
    if n_rounds < 1:
        raise ValueError("need n_rounds >= 1")
    d = distance
    if d < 3 or d % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    nd, nz = d, d - 1
    anc = [nd + i for i in range(nz)]
    circ = QuantumCircuit(nd + nz)
    col = 0
    for _ in range(n_rounds):
        for step in range(2):
            for i, a in enumerate(anc):
                circ.add_gate(GateInstance("CNOT", [i + step, a], [],
                                           col))
            col += 1
        for a in anc:
            circ.add_gate(GateInstance("Measure", [a], [], col))
        col += 1
    for q in range(nd):
        circ.add_gate(GateInstance("Measure", [q], [], col))

    matrix = np.zeros((nz, nd), dtype=np.uint8)
    for i in range(nz):
        matrix[i, i] = matrix[i, i + 1] = 1
    support = np.zeros(nd, dtype=np.uint8)
    support[0] = 1
    # Interior data qubit q: check q reads it at step 0 (early), check
    # q-1 at step 1 (late) — the circuit-aware diagonal orientation.
    diagonals = [None] + [(q, q - 1) for q in range(1, nd - 1)] + [None]
    return circ, ExtractionLayout(
        distance=d, n_rounds=n_rounds, n_data=nd, n_z=nz, n_x=0,
        basis="z", sector_matrix=matrix, sector_support=support,
        sector_diagonals=tuple(diagonals))


def surface_extraction_circuit(
        distance: int, n_rounds: int,
        basis: str = "z") -> tuple[QuantumCircuit, ExtractionLayout]:
    """R-round rotated-surface-code syndrome-extraction circuit.

    Qubits: ``d^2`` data (index = row * d + col, the framework-wide
    qubit-0-is-MSB grid), then one ancilla per Z check, then one per X
    check.  Per round: H on X ancillas; four CNOT steps (data->ancilla
    for Z checks, ancilla->data for X checks); H on X ancillas; measure
    every ancilla (no reset — see module docstring).  After the last
    round every data qubit is measured (the perfect-readout layer; gate
    noise models measurement faults on the mid-circuit rounds, the
    final transversal readout is taken fault-free as in
    ``qec_frame.build_matching_memory_fn``).

    ``basis`` picks the memory experiment: ``"z"`` prepares ``|0...0>``
    (a ``+Z_L`` eigenstate, decode the Z sector against X errors);
    ``"x"`` prepares ``|+...+>`` via a transversal H column and reads
    the data out in the X basis (H before the final measures), decoding
    the X sector against Z errors — the same extraction rounds serve
    both, only the data-qubit boundary columns differ.
    """
    if n_rounds < 1:
        raise ValueError("need n_rounds >= 1")
    if basis not in ("z", "x"):
        raise ValueError(f"basis must be 'z' or 'x', got {basis!r}")
    d = distance
    z_checks, x_checks, z_logical, x_logical = \
        _rotated_surface_geometry(d)
    nd, nz, nx = d * d, len(z_checks), len(x_checks)
    z_anc = [nd + i for i in range(nz)]
    x_anc = [nd + nz + j for j in range(nx)]
    # Zigzag choice (see _check_schedule): X hooks end on the SW-SE row
    # (perpendicular to X_L = column 0), Z hooks end on the NE-SE
    # column (perpendicular to Z_L = row 0).  Measured: the swapped
    # assignment costs ~1.4x in d=5 logical rate at p=0.002.
    z_sched = _check_schedule(z_checks, d, (0, 2, 1, 3))   # "N" zigzag
    x_sched = _check_schedule(x_checks, d, (0, 1, 2, 3))   # "Z" zigzag

    circ = QuantumCircuit(nd + nz + nx)
    col = 0
    if basis == "x":                        # transversal |+...+> prep
        for q in range(nd):
            circ.add_gate(GateInstance("H", [q], [], col))
        col += 1
    for _ in range(n_rounds):
        for j, a in enumerate(x_anc):
            circ.add_gate(GateInstance("H", [a], [], col))
        col += 1
        for step in range(4):
            for i, a in enumerate(z_anc):
                if step in z_sched[i]:
                    circ.add_gate(GateInstance(
                        "CNOT", [z_sched[i][step], a], [], col))
            for j, a in enumerate(x_anc):
                if step in x_sched[j]:
                    circ.add_gate(GateInstance(
                        "CNOT", [a, x_sched[j][step]], [], col))
            col += 1
        for j, a in enumerate(x_anc):
            circ.add_gate(GateInstance("H", [a], [], col))
        col += 1
        for a in z_anc + x_anc:                         # Z first, X second
            circ.add_gate(GateInstance("Measure", [a], [], col))
        col += 1
    if basis == "x":                        # transversal X-basis readout
        for q in range(nd):                 # (the H column carries gate
            circ.add_gate(GateInstance("H", [q], [], col)) # noise: the
        col += 1                            # x memory's final layer is a
                                            # ~2p/3 noisy readout, unlike
                                            # the z memory's noise-free
                                            # one — see module docstring)
    for q in range(nd):
        circ.add_gate(GateInstance("Measure", [q], [], col))

    sec_checks = z_checks if basis == "z" else x_checks
    sec_sched = z_sched if basis == "z" else x_sched
    sec_logical = z_logical if basis == "z" else x_logical
    matrix = np.zeros((len(sec_checks), nd), dtype=np.uint8)
    for i, sup in enumerate(sec_checks):
        matrix[i, sup] = 1
    support = np.zeros(nd, dtype=np.uint8)
    support[sec_logical] = 1
    # Circuit-aware diagonals: qubit q's two sector checks read it at
    # different steps; a fault in the window between them is seen by
    # the later check this round and the earlier one next round.
    read_at: dict[int, list[tuple[int, int]]] = {}
    for i, sched in enumerate(sec_sched):
        for step, q in sched.items():
            read_at.setdefault(q, []).append((step, i))
    diagonals = []
    for q in range(nd):
        reads = sorted(read_at.get(q, []))
        if len(reads) == 2 and reads[0][0] != reads[1][0]:
            diagonals.append((reads[0][1], reads[1][1]))
        else:
            diagonals.append(None)
    return circ, ExtractionLayout(
        distance=d, n_rounds=n_rounds, n_data=nd, n_z=nz, n_x=nx,
        basis=basis, sector_matrix=matrix, sector_support=support,
        sector_diagonals=tuple(diagonals))


def detection_events(lay: ExtractionLayout,
                     outcomes: np.ndarray) -> np.ndarray:
    """Measurement record -> detection tensor ``det[T, R+1, nc]``:
    per-round sector syndromes recovered from the no-reset outcome
    chains (``s_r = o_r XOR o_{r-1}``), differenced between consecutive
    rounds and closed by the final transversal readout's syndrome."""
    R = lay.n_rounds
    T = outcomes.shape[0]
    o = lay.sector_outcomes(outcomes)                  # (T, R, nc)
    syn = o.copy()                                     # no-reset chain
    syn[:, 1:] = o[:, 1:] ^ o[:, :-1]
    data = lay.data_outcomes(outcomes)                 # (T, nd)
    final = (data @ lay.sector_matrix.T) % 2
    det = np.empty((T, R + 1, lay.sector_matrix.shape[0]), dtype=np.uint8)
    det[:, 0] = syn[:, 0]
    if R > 1:
        det[:, 1:R] = syn[:, 1:] ^ syn[:, :-1]
    det[:, R] = final ^ syn[:, R - 1]
    return det


def decode_memory_record(lay: ExtractionLayout,
                         outcomes: np.ndarray) -> tuple:
    """Measurement record -> ``(fail, raw, det)`` per trial.

    Recovers the decoded sector's per-round syndromes from the no-reset
    outcome chains (``s_r = o_r XOR o_{r-1}``), forms the R+1 detection
    layers (closed by the final transversal readout's syndrome), decodes
    with space-time union-find matching, and returns the corrected
    logical parity ``fail``, the uncorrected readout parity ``raw``, and
    the detection-event tensor ``det[T, R+1, nc]``.
    """
    R = lay.n_rounds
    T = outcomes.shape[0]
    det = detection_events(lay, outcomes)
    data = lay.data_outcomes(outcomes)                 # (T, nd)
    corr = space_time_decode_fn(
        lay.sector_matrix, R, diagonals=list(lay.sector_diagonals))(
        det.reshape(T, -1)).astype(np.uint8)
    raw = ((data @ lay.sector_support) % 2).astype(np.int32)
    fail = (raw ^ (corr @ lay.sector_support) % 2).astype(np.int32)
    return fail, raw, det


# ---------------------------------------------------------------------------
# Pauli-frame sampler
# ---------------------------------------------------------------------------

_NOISE_CODES = (_OP_NOISE_BF, _OP_NOISE_PF, _OP_NOISE_DEPOL,
                _OP_NOISE_DEPOL2)


def _frame_op(x, z, code: int, a: int, b: int, u, p):
    """One schedule op on the error frames ``x, z[T, n]``, in place: the
    frame twin of ``clifford._apply_op`` (Paulis of the circuit itself
    are frame identities). A measurement reports the qubit's x bit (the
    flip of the reference outcome) and clears its z bit: a phase on a
    collapsed computational state is gone, and must not become a phantom
    bit flip at the next round's H."""
    if code == _OP_H:
        xa = x[:, a].clone()
        x[:, a] = z[:, a]
        z[:, a] = xa
    elif code in (_OP_S, _OP_SDAG):
        z[:, a] ^= x[:, a]
    elif code == _OP_CNOT:
        x[:, b] ^= x[:, a]
        z[:, a] ^= z[:, b]
    elif code == _OP_SWAP:
        for t in (x, z):
            ta = t[:, a].clone()
            t[:, a] = t[:, b]
            t[:, b] = ta
    elif code == _OP_MEASURE:
        out = x[:, a].clone()
        z[:, a] = 0
        return out
    elif code in _NOISE_CODES:
        xa, za, xb, zb = _pauli_bits(code, u, p)
        for q, xbit, zbit in ((a, xa, za), (b, xb, zb)):
            if xbit is not None:
                x[:, q] ^= xbit
            if zbit is not None:
                z[:, q] ^= zbit
    return None


def frame_walk(n: int, codes, qa, qb, pp, uniforms, ref, inject=None,
               rows: int | None = None):
    """The Pauli-frame sampler over ``uniforms[T, L]`` (or ``rows``
    trials of a noise-free schedule): -> ``ref ^ flips`` (T, M) int8.
    ``inject(i, x, z)`` runs after step i. A noise op at p = 0 never
    fires (u < 0 is false), so it is skipped."""
    T = uniforms.shape[0] if uniforms is not None else rows
    device = ref.device
    x = torch.zeros((T, n), dtype=torch.int8, device=device)
    z = torch.zeros_like(x)
    outs = []
    for i, code in enumerate(np.asarray(codes).tolist()):
        p = np.float32(pp[i])
        if code in _NOISE_CODES and p == 0:
            pass
        else:
            u = uniforms[:, i] if code in _NOISE_CODES else None
            out = _frame_op(x, z, code, int(qa[i]), int(qb[i]), u, p)
            if out is not None:
                outs.append(out)
        if inject is not None:
            inject(i, x, z)
    flips = (torch.stack(outs, dim=1) if outs
             else torch.zeros((T, 0), dtype=torch.int8, device=device))
    return ref[None, :] ^ flips


def _signatures(n: int, codes, qa, qb, noise_idx, ref) -> torch.Tensor:
    """Unit-fault signatures ``(4S, M)`` float32: one batched frame walk
    with all noise probabilities at zero and one frame bit injected per
    row, (x, z) on each of a site's two schedule targets (the b
    components of a one-qubit site are inert: their bits never fire)."""
    S = len(noise_idx)
    site_of = {int(s): k for k, s in enumerate(noise_idx)}
    pp0 = np.zeros(len(codes), np.float32)

    def inject(i, x, z):
        k = site_of.get(i)
        if k is None:
            return
        a, b = int(qa[i]), int(qb[i])
        x[4 * k, a] ^= 1
        z[4 * k + 1, a] ^= 1
        x[4 * k + 2, b] ^= 1
        z[4 * k + 3, b] ^= 1

    flips = frame_walk(n, codes, qa, qb, pp0, None, ref, inject,
                       rows=4 * S) ^ ref[None, :]
    return flips.to(torch.float32)


_sig_cache: dict[tuple, torch.Tensor] = {}


def _linear_sampler_fn(codes, qa, qb, pp, ref, n: int,
                       sig_key: tuple | None = None):
    """The frame sampler LINEARIZED: ``run(uniforms[T, L]) -> outcomes``
    from the per-site Pauli bits times the signature matrix mod 2, the
    draws sliced to the noise sites (so identical to the walking
    engines under the same rows). Signatures depend only on the circuit
    structure: ``sig_key`` caches them across noise rates."""
    noise_idx = np.asarray([i for i, c in enumerate(codes)
                            if int(c) in _NOISE_CODES], np.int64)
    S = len(noise_idx)
    M = ref.shape[0]
    device = ref.device
    key = None if sig_key is None else sig_key + (str(device),)
    sig = _sig_cache.get(key) if key is not None else None
    if sig is None:
        sig = _signatures(n, codes, qa, qb, noise_idx, ref)
        if key is not None:
            _sig_cache[key] = sig
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    kinds = t(np.asarray(codes)[noise_idx].astype(np.int32))
    probs = np.asarray(pp, np.float32)[noise_idx]
    p = t(probs)
    p_div = t(np.where(probs > 0, probs, np.float32(1)))
    two_thirds = t(np.float32(2) * probs / np.float32(3))
    third = t(probs / np.float32(3))
    idx = t(noise_idx)
    per_trial = 4 * (len(codes) + 16 * S + 2 * M) + 1
    step = max(1, TRAJECTORY_MEMORY_BYTES // per_trial)

    def bits_of(u):
        fire2 = (kinds == _OP_NOISE_DEPOL2) & (u < p)
        pid = torch.where(
            fire2, 1 + torch.clamp((u * 15 / p_div).to(torch.int32), 0, 14),
            0)
        ia, ja = pid >> 2, pid & 3
        xa = (((kinds == _OP_NOISE_BF) & (u < p))
              | ((kinds == _OP_NOISE_DEPOL) & (u < two_thirds))
              | (ia == 1) | (ia == 2))
        za = (((kinds == _OP_NOISE_PF) & (u < p))
              | ((kinds == _OP_NOISE_DEPOL) & (u >= third) & (u < p))
              | (ia == 2) | (ia == 3))
        xb = (ja == 1) | (ja == 2)
        zb = (ja == 2) | (ja == 3)
        return torch.stack([xa, za, xb, zb], dim=2).reshape(
            u.shape[0], 4 * S).to(torch.float32)

    def run(uniforms):
        parts = []
        for lo in range(0, uniforms.shape[0], step):
            u = uniforms[lo:lo + step].index_select(1, idx)
            flips = (bits_of(u) @ sig).to(torch.int32) & 1
            parts.append(ref[None, :] ^ flips.to(torch.int8))
        return (torch.cat(parts) if parts else
                torch.zeros((0, M), dtype=torch.int8, device=device))

    return run


_traj_cache: dict[tuple, tuple] = {}


def _extraction_circuit(code: str, distance: int, n_rounds: int,
                        basis: str):
    if code == "surface":
        return surface_extraction_circuit(distance, n_rounds, basis)
    if code == "repetition":
        if basis != "z":
            raise ValueError("repetition chains have no X checks; only "
                             "the z memory exists")
        return repetition_extraction_circuit(distance, n_rounds)
    raise ValueError(f"unknown code: {code!r}")


def _noise_model(noise_prob: float, two_qubit_depol: bool):
    nm = NoiseModel()
    if two_qubit_depol:
        # The literature's standard depolarizing circuit noise:
        # correlated 15-Pauli depolarizing after every CNOT, 1q
        # depolarizing after every 1q gate.
        from .noise import TwoQubitDepolarizingNoise
        nm.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(noise_prob))
        nm.add_gate_noise("H", DepolarizingNoise(noise_prob))
    else:
        nm.add_global_noise(DepolarizingNoise(noise_prob))
    return nm


def reference_sample(circ: QuantumCircuit, device, ref_uniforms=None
                     ) -> torch.Tensor:
    """One clean tableau run's outcomes (M,) int8: the frame engines'
    reference. Its random outcomes read ``ref_uniforms[1, L_clean]``
    (JAX: ``uniform(PRNGKey(0), (L_clean,))``), by default a generator
    seeded with 0 on ``device``."""
    codes, qa, qb, pp, _ = _lower(circ, collapse_measures=True)
    if ref_uniforms is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        ref_uniforms = torch.rand((1, len(codes)), generator=gen,
                                  device=device)
    u = torch.as_tensor(ref_uniforms, dtype=torch.float32, device=device)
    _, outs = walk(identity_tableau(circ.num_qubits, device, 1), codes,
                   qa, qb, pp, u.reshape(1, -1))
    return outs[0]


def _trajectory_fn(distance: int, n_rounds: int, noise_prob: float,
                   basis: str = "z", engine: str = "linear",
                   two_qubit_depol: bool = False, code: str = "surface",
                   device=None, ref_uniforms=None):
    """``run(uniforms[T, L]) -> outcomes[T, M]`` int8 on ``device`` for
    one (d, R, p) point and the layout, cached per structure (p is part
    of the key; ``run.schedule_length`` is L). The three engines give
    identical outcomes under the same uniforms and reference."""
    device = device or CONFIG.device
    ref_key = (None if ref_uniforms is None
               else np.asarray(ref_uniforms, np.float32).tobytes())
    key = (distance, n_rounds, float(noise_prob), basis, engine,
           two_qubit_depol, code, str(device), ref_key)
    hit = _traj_cache.get(key)
    if hit is not None:
        return hit
    circ, lay = _extraction_circuit(code, distance, n_rounds, basis)
    nm = _noise_model(noise_prob, two_qubit_depol) if noise_prob > 0.0 \
        else None
    codes, qa, qb, pp, _ = _lower(circ, noise_model=nm,
                                  collapse_measures=True)
    n = circ.num_qubits
    if engine == "clifford":
        def run(uniforms):
            return _walk_batches(n, (codes, qa, qb, pp), uniforms,
                                 device)[1]
    elif engine in ("frame", "linear"):
        ref = reference_sample(circ, device, ref_uniforms)
        if engine == "frame":
            def run(uniforms):
                return frame_walk(n, codes, qa, qb, pp, uniforms, ref)
        else:
            run = _linear_sampler_fn(
                codes, qa, qb, pp, ref, n,
                sig_key=(distance, n_rounds, basis, two_qubit_depol, code,
                         ref_key) if noise_prob > 0.0 else None)
    else:
        raise ValueError(f"unknown engine: {engine!r}")
    run.schedule_length = len(codes)
    _traj_cache[key] = (run, lay)
    return run, lay


def circuit_level_memory(distance: int, n_rounds: int, noise_prob: float,
                         n_trials: int = 1000, seed: int = 0,
                         basis: str = "z",
                         decoder: str = "dem",
                         engine: str = "linear",
                         two_qubit_depol: bool = False,
                         code: str = "surface",
                         mesh=None, device=None, uniforms=None,
                         ref_uniforms=None) -> dict:
    """Memory experiment under circuit-level depolarizing noise.

    ``basis="z"`` prepares ``|0...0>``, runs ``n_rounds`` of real
    extraction with depolarizing ``noise_prob`` after every gate on each
    target, measures the data transversally, and decodes the Z sector's
    detection events; ``"x"`` is the mirror (``|+...+>``, X sector, X_L).
    ``decoder``: ``"dem"`` (matching on the circuit's measured detector
    error model, the logical predicted from matched edges' flags) or
    ``"phenomenological"`` (hand-built graph + schedule diagonals).
    ``engine``: ``"linear"``, ``"frame"`` or ``"clifford"``.
    ``two_qubit_depol``: correlated 15-Pauli depolarizing after every
    CNOT + 1q depolarizing after every 1q gate.

    Draws: ``uniforms[T, L]`` (JAX: ``uniform(k_t, (L,))`` over
    ``split(PRNGKey(seed), T)``) and ``ref_uniforms[1, L_clean]`` for the
    frame engines' reference; by default a generator seeded with
    ``seed`` on ``device`` draws the ``(T, L)`` block. Given uniforms set
    the number of trials. ``mesh=`` (a ``parallel.ShardMesh``) splits the
    trials over its ranks, each sampling its contiguous block, and
    gathers the outcomes for the host decode: on the same draws the
    result is the one without a mesh."""
    device = device or CONFIG.device
    run, lay = _trajectory_fn(distance, n_rounds, noise_prob, basis,
                              engine, two_qubit_depol, code, device,
                              ref_uniforms)
    if uniforms is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        uniforms = torch.rand((n_trials, run.schedule_length),
                              generator=gen, device=device)
    uniforms = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
    if mesh is None:
        outcomes = run(uniforms)
    else:
        from .parallel.distributed import check_mesh
        outcomes = check_mesh(mesh).map_trials(run, uniforms)
    outcomes = outcomes.cpu().numpy().astype(np.uint8)
    n_trials = outcomes.shape[0]
    if decoder == "phenomenological":
        fail, raw, det = decode_memory_record(lay, outcomes)
    elif decoder == "dem":
        from .qec_dem import extract_dem
        dem = extract_dem(distance, n_rounds, basis,
                          two_qubit_depol=two_qubit_depol, code=code,
                          device=device)
        det = detection_events(lay, outcomes)
        raw = ((lay.data_outcomes(outcomes) @ lay.sector_support) % 2
               ).astype(np.int32)
        pred = dem.decode(det.reshape(n_trials, -1), noise_prob)
        fail = raw ^ pred
    else:
        raise ValueError(f"unknown decoder: {decoder!r}")
    p_fail = float(fail.mean())
    R = n_rounds
    return {
        "logical_failure_probability": p_fail,
        "per_round_logical_rate":
            1.0 - (1.0 - min(p_fail, 1.0 - 1e-12)) ** (1.0 / R),
        "raw_failure_probability": float(raw.mean()),
        "detection_fraction": float(det.mean()),
        "n_rounds": R,
        "n_trials": n_trials,
        "distance": distance,
        "basis": basis,
        "code": code,
        "decoder": decoder,
        "noise_prob": float(noise_prob),
        "n_qubits": lay.n_data + lay.n_z + lay.n_x,
    }
