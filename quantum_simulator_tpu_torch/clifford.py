"""Clifford / stabilizer tableau engine: hundreds of qubits, no 2^n state.

Counterpart of ``quantum_simulator_tpu/clifford.py``. Circuits of Clifford
gates (H, S, S_DAG, X, Y, Z, CNOT, CZ, SWAP) evolve stabilizer states,
which the Aaronson-Gottesman CHP tableau tracks in O(n^2) bits: 2n
generator rows (n destabilizers, then n stabilizers) of X / Z bits plus a
sign (Aaronson & Gottesman, quant-ph/0406196).

JAX lowers a circuit to schedule arrays (``_lower``) and runs them as one
``lax.scan`` with a ``lax.switch`` over 14 op kinds. Here the same host
schedule is walked on the host, one Python branch per op, over a BATCH of
tableaus on the device: ``x`` and ``z`` are ``(B, 2n, n)`` int8 0/1
tensors, ``r`` is ``(B, 2n)``, and ``B`` is shots or trajectories. Qubit
indices are host integers, so a gate is a few in-place column updates
over the whole batch; every draw comparison is batched over ``B``; no
value goes back to the host inside the walk.

Measurement (``_measure_z``) is branchless like JAX's: both the random
and the deterministic outcome are computed for every row and
``torch.where`` selects. JAX's deterministic branch is a ``fori_loop`` of
n sequential rowsums; here it is O(1) launches: stabilizers commute, so
each step's phase total is even and the outcome is
``sum_i use_i (r_i + G_i / 2) mod 2``, with ``G_i`` taken against the
exclusive prefix XOR of the earlier used rows (a ``cumsum`` mod 2 over
the row axis). ``_deterministic_outcome_sequential`` keeps the sequential
form as the plain version; the tests hold the two equal on random
stabilizer tableaus.

Draws: every random op reads one float32 uniform per row and schedule
step (``uniforms[B, L]``, positional like JAX's ``uniform(key, (L,))``),
and sampling reads one random bit per shot and qubit. Every entry point
takes them as an optional argument, so JAX's own draws can be fed in;
thresholds are float32 arithmetic as in JAX (``2 p / 3`` rounded in
float32), so boundary draws split the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG
from .gates import GateType
from .registry import GateRegistry
from .simulator import TRAJECTORY_MEMORY_BYTES
from .utils.seeding import generator_from_rng

CLIFFORD_GATES = frozenset(
    {"I", "H", "X", "Y", "Z", "S", "S_DAG", "CNOT", "CZ", "SWAP"})

# Device bytes per tableau row a walk or a measurement cascade may hold
# (x, z and the measurement's temporaries): ~48 n^2. Batches of shots,
# trajectories and faults are cut so that rows * this <= the budget.
_BYTES_PER_N2 = 48


def is_clifford_circuit(circuit: QuantumCircuit) -> bool:
    """True when every (non-measurement, non-barrier) gate is Clifford."""
    registry = GateRegistry.instance()
    for g in circuit.gates:
        try:
            gdef = registry.get(g.gate_name)
        except KeyError:
            return False
        if gdef.gate_type in (GateType.MEASUREMENT, GateType.BARRIER):
            continue
        if g.gate_name not in CLIFFORD_GATES:
            return False
    return True


class Tableau(NamedTuple):
    """CHP tableau: rows 0..n-1 destabilizers, n..2n-1 stabilizers.
    Unbatched ``(2n, n)`` / ``(2n,)`` or batched ``(B, 2n, n)`` /
    ``(B, 2n)``, int8 0/1."""

    x: torch.Tensor
    z: torch.Tensor
    r: torch.Tensor


def identity_tableau(n: int, device=None, batch: int | None = None
                     ) -> Tableau:
    """|0...0>: destabilizer i = X_i, stabilizer i = Z_i; ``batch`` rows
    of it (independent copies) when given."""
    device = device or CONFIG.device
    eye = torch.eye(n, dtype=torch.int8, device=device)
    zero = torch.zeros((n, n), dtype=torch.int8, device=device)
    x = torch.cat([eye, zero])
    z = torch.cat([zero, eye])
    r = torch.zeros(2 * n, dtype=torch.int8, device=device)
    if batch is None:
        return Tableau(x, z, r)
    return Tableau(x.expand(batch, -1, -1).clone(),
                   z.expand(batch, -1, -1).clone(),
                   r.expand(batch, -1).clone())


def tableau_rows(n: int) -> int:
    """Rows of a batch that fit ``simulator.TRAJECTORY_MEMORY_BYTES``."""
    return max(1, TRAJECTORY_MEMORY_BYTES // (_BYTES_PER_N2 * n * n + 1))


# --- measurement ------------------------------------------------------------

def _g_phase(x1, z1, x2, z2):
    """Aaronson-Gottesman g(): phase exponent (mod 4 contribution) of
    multiplying single-qubit Paulis (x1, z1) * (x2, z2); elementwise,
    broadcasting, signed."""
    b1, c1 = x1.bool(), z1.bool()
    return torch.where(
        b1 & c1, z2 - x2,
        torch.where(b1, z2 * (2 * x2 - 1),
                    torch.where(c1, x2 * (1 - 2 * z2), 0)))


def _rowsum_phase(xs, zs, xh, zh, rs, rh):
    """Sign bit of (row h) * (row s), batched over leading dims; floor
    modulo (``torch.remainder``) as JAX's ``%``."""
    gsum = _g_phase(xs, zs, xh, zh).sum(-1, dtype=torch.int32)
    tot = 2 * rh.to(torch.int32) + 2 * rs.to(torch.int32) + gsum
    return torch.remainder(tot, 4) // 2


def _deterministic_outcome(x, z, r, use):
    """Outcome of a deterministic Z measurement, O(1) launches: the
    product of the stabilizers whose destabilizer partner has x = 1 at
    the qubit (``use[B, n]``), its sign from the prefix-XOR form."""
    n = use.shape[-1]
    xs, zs, rs = x[:, n:], z[:, n:], r[:, n:]
    u = use[..., None]
    ux, uz = xs * u, zs * u
    px = (torch.cumsum(ux, dim=1, dtype=torch.int32) - ux) & 1
    pz = (torch.cumsum(uz, dim=1, dtype=torch.int32) - uz) & 1
    g = _g_phase(xs, zs, px, pz).sum(-1, dtype=torch.int32)
    tot = (use.to(torch.int32) * (rs.to(torch.int32) + g // 2)).sum(-1)
    return torch.remainder(tot, 2).to(torch.int8)


def _deterministic_outcome_sequential(x, z, r, use):
    """The plain version of ``_deterministic_outcome``: JAX's
    ``fori_loop`` of n sequential rowsums into a scratch row."""
    B, _, n = x.shape
    sx = torch.zeros((B, n), dtype=torch.int8, device=x.device)
    sz = torch.zeros_like(sx)
    sr = torch.zeros(B, dtype=torch.int32, device=x.device)
    for i in range(n):
        on = use[:, i].bool()
        xs, zs, rs = x[:, n + i], z[:, n + i], r[:, n + i]
        sr = torch.where(on, _rowsum_phase(xs, zs, sx, sz, rs, sr), sr)
        sx = torch.where(on[:, None], sx ^ xs, sx)
        sz = torch.where(on[:, None], sz ^ zs, sz)
    return sr.to(torch.int8)


def _measure_z(x, z, r, q: int, rand_bit):
    """Measure Z on qubit ``q`` of every row of a batched tableau, in
    place. ``rand_bit`` (B,) or (1,) is the outcome wherever it is random.
    -> outcome (B,) int8."""
    B, two_n, n = x.shape
    dev = x.device
    xq = x[:, :, q]
    stab = xq[:, n:].bool()
    first = torch.where(stab, torch.arange(n, device=dev), n).amin(dim=1)
    exists = first < n
    p = n + torch.where(exists, first, 0)
    det = _deterministic_outcome(x, z, r, xq[:, :n])
    rand = rand_bit.to(torch.int8).expand(B)

    # Random branch: rowsum every other x-having row with row p, then
    # destabilizer p-n := old row p; row p := Z_q with sign = outcome.
    bidx = torch.arange(B, device=dev)
    xp, zp, rp = x[bidx, p], z[bidx, p], r[bidx, p]
    rows = torch.arange(two_n, device=dev)
    fix = (xq == 1) & (rows != p[:, None]) & exists[:, None]
    new_r = _rowsum_phase(xp[:, None], zp[:, None], x, z, rp[:, None], r)
    r.copy_(torch.where(fix, new_r.to(torch.int8), r))
    f = fix.to(torch.int8)[..., None]
    x ^= f * xp[:, None]
    z ^= f * zp[:, None]
    e = exists[:, None]
    dest = p - n
    x[bidx, dest] = torch.where(e, xp, x[bidx, dest])
    z[bidx, dest] = torch.where(e, zp, z[bidx, dest])
    r[bidx, dest] = torch.where(exists, rp, r[bidx, dest])
    zq_row = torch.zeros(n, dtype=torch.int8, device=dev)
    zq_row[q] = 1
    x[bidx, p] = torch.where(e, 0, x[bidx, p])
    z[bidx, p] = torch.where(e, zq_row, z[bidx, p])
    r[bidx, p] = torch.where(exists, rand, r[bidx, p])
    return torch.where(exists, rand, det)


def sample_bits(tab: Tableau, rand_bits: torch.Tensor) -> torch.Tensor:
    """``rand_bits[S, n]`` (0/1) -> ``bits[S, n]`` int8: S shots of a full
    computational-basis measurement cascade, qubit 0 first. An unbatched
    tableau serves every shot; a batched one has one row per shot. The
    shots run in batches cut by the byte budget; ``tab`` is not changed."""
    S, n = rand_bits.shape
    step = tableau_rows(n)
    out = []
    for lo in range(0, S, step):
        hi = min(S, lo + step)
        if tab.x.dim() == 2:
            x = tab.x.expand(hi - lo, -1, -1).clone()
            z = tab.z.expand(hi - lo, -1, -1).clone()
            r = tab.r.expand(hi - lo, -1).clone()
        else:
            x, z, r = (t[lo:hi].clone() for t in tab)
        rb = rand_bits[lo:hi].to(device=x.device, dtype=torch.int8)
        out.append(torch.stack([_measure_z(x, z, r, q, rb[:, q])
                                for q in range(n)], dim=1))
    if not out:
        return torch.zeros((0, n), dtype=torch.int8, device=tab.x.device)
    return torch.cat(out)


# --- schedule-as-data engine ------------------------------------------------
#
# The whole circuit lowers to four arrays (opcode, qubit a, qubit b,
# channel probability), as in JAX; ``walk`` runs them op by op.

_OP_I, _OP_H, _OP_S, _OP_SDAG, _OP_X, _OP_Y, _OP_Z = range(7)
_OP_CNOT, _OP_SWAP, _OP_MEASURE = 7, 8, 9
_OP_NOISE_BF, _OP_NOISE_PF, _OP_NOISE_DEPOL = 10, 11, 12
_OP_NOISE_DEPOL2 = 13
_RANDOM_OPS = frozenset({_OP_MEASURE, _OP_NOISE_BF, _OP_NOISE_PF,
                         _OP_NOISE_DEPOL, _OP_NOISE_DEPOL2})

_GATE_OPCODES = {"I": _OP_I, "H": _OP_H, "S": _OP_S, "S_DAG": _OP_SDAG,
                 "X": _OP_X, "Y": _OP_Y, "Z": _OP_Z, "CNOT": _OP_CNOT,
                 "SWAP": _OP_SWAP}
_NOISE_OPCODES = {"BitFlipNoise": _OP_NOISE_BF,
                  "PhaseFlipNoise": _OP_NOISE_PF,
                  "DepolarizingNoise": _OP_NOISE_DEPOL}


def _i8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int8)


def _pauli_bits(code: int, u: torch.Tensor, p: np.float32):
    """Noise op + uniforms -> (xa, za, xb, zb) int8 bit columns (xb, zb
    None for one-qubit channels). float32 thresholds as JAX's."""
    if code == _OP_NOISE_BF:
        return _i8(u < p), None, None, None
    if code == _OP_NOISE_PF:
        return None, _i8(u < p), None, None
    if code == _OP_NOISE_DEPOL:
        two_thirds = np.float32(2) * p / np.float32(3)
        third = p / np.float32(3)
        return (_i8(u < two_thirds), _i8((u >= third) & (u < p)),
                None, None)
    # Correlated two-qubit depolarizing: u < p picks one of the 15
    # non-identity Pauli pairs (id >> 2 on qubit a, id & 3 on b; 0=I 1=X
    # 2=Y 3=Z).
    fire = (u < p).to(torch.int32)
    pid = (1 + torch.clamp((u * 15 / float(p)).to(torch.int32), 0, 14)) \
        * fire
    ia, ja = pid >> 2, pid & 3
    return (_i8((ia == 1) | (ia == 2)), _i8((ia == 2) | (ia == 3)),
            _i8((ja == 1) | (ja == 2)), _i8((ja == 2) | (ja == 3)))


def _apply_op(x, z, r, code: int, a: int, b: int, u, p):
    """One schedule op on a batched tableau, in place. -> the outcome
    (B,) for a measurement, else None."""
    if code == _OP_I:
        return None
    if code == _OP_H:
        xa = x[..., a].clone()
        za = z[..., a]
        r ^= xa & za
        x[..., a] = za
        z[..., a] = xa
    elif code == _OP_S:
        r ^= x[..., a] & z[..., a]
        z[..., a] ^= x[..., a]
    elif code == _OP_SDAG:
        r ^= x[..., a] & (z[..., a] ^ 1)
        z[..., a] ^= x[..., a]
    elif code == _OP_X:
        r ^= z[..., a]
    elif code == _OP_Y:
        r ^= x[..., a] ^ z[..., a]
    elif code == _OP_Z:
        r ^= x[..., a]
    elif code == _OP_CNOT:
        r ^= x[..., a] & z[..., b] & (x[..., b] ^ z[..., a] ^ 1)
        x[..., b] ^= x[..., a]
        z[..., a] ^= z[..., b]
    elif code == _OP_SWAP:
        for t in (x, z):
            ta = t[..., a].clone()
            t[..., a] = t[..., b]
            t[..., b] = ta
    elif code == _OP_MEASURE:
        return _measure_z(x, z, r, a, u < 0.5)
    else:
        xa, za, xb, zb = _pauli_bits(code, u, p)
        for q, xbit, zbit in ((a, xa, za), (b, xb, zb)):
            if xbit is not None:
                r ^= xbit[:, None] & z[..., q]
            if zbit is not None:
                r ^= zbit[:, None] & x[..., q]
    return None


def walk(tab: Tableau, codes, qa, qb, pp, uniforms=None, inject=None):
    """Run a schedule over a batched tableau, IN PLACE.

    ``uniforms[B or 1, L]`` float32 (positional per step, one row per
    tableau or one row for all) feeds the random ops; it may be None for
    a schedule without them. ``inject(i, x, z, r)``, when given, runs
    after step i (the fault-injection hook of ``qec_dem``).
    -> (tab, outcomes[B, M] int8 in schedule order)."""
    x, z, r = tab
    outs = []
    for i, code in enumerate(np.asarray(codes).tolist()):
        u = None
        if code in _RANDOM_OPS:
            if uniforms is None:
                raise ValueError("this schedule has random ops: pass "
                                 "uniforms[B, L]")
            u = uniforms[:, i]
        out = _apply_op(x, z, r, code, int(qa[i]), int(qb[i]), u,
                        np.float32(pp[i]))
        if out is not None:
            outs.append(out)
        if inject is not None:
            inject(i, x, z, r)
    if outs:
        return tab, torch.stack(outs, dim=1)
    return tab, torch.zeros((x.shape[0], 0), dtype=torch.int8,
                            device=x.device)


def _apply_gate(tab: Tableau, name: str, qubits: list[int]) -> Tableau:
    """One Clifford gate on a (batched or not) tableau -> a new tableau
    (the unit-testable wrapper over the walk's op algebra)."""
    if name in ("I", "Barrier", "Measure"):
        return tab
    if name == "CZ":
        c, t = qubits
        tab = _apply_gate(tab, "H", [t])
        tab = _apply_gate(tab, "CNOT", [c, t])
        return _apply_gate(tab, "H", [t])
    if name not in _GATE_OPCODES:
        raise ValueError(f"not a Clifford gate: {name}")
    x, z, r = (t.clone() for t in tab)
    a = qubits[0]
    b = qubits[1] if len(qubits) > 1 else 0
    _apply_op(x, z, r, _GATE_OPCODES[name], a, b, None, np.float32(0))
    return Tableau(x, z, r)


def _lower(circuit: QuantumCircuit, noise_model=None,
           collapse_measures: bool = False):
    """Circuit (+ optional Pauli noise) -> static schedule arrays
    (codes, qa, qb, pp) and the (column, qubit) site per Measure.
    CZ lowers to H CNOT H."""
    if not is_clifford_circuit(circuit):
        raise ValueError(
            "circuit contains non-Clifford gates; use Simulator instead")
    registry = GateRegistry.instance()
    codes: list[int] = []
    qa: list[int] = []
    qb: list[int] = []
    pp: list[float] = []
    sites: list[tuple[int, int]] = []

    def emit(code, a, b=0, p=0.0):
        codes.append(code)
        qa.append(a)
        qb.append(b)
        pp.append(p)

    # Per-qubit initial states: |1> preps lower to X ops, noise-free.
    for q, bit in enumerate(circuit.initial_states):
        if bit:
            emit(_OP_X, q)

    for column in circuit.get_ordered_gates():
        for g in column:
            gdef = registry.get(g.gate_name)
            if gdef.gate_type == GateType.BARRIER:
                continue
            if gdef.gate_type == GateType.MEASUREMENT:
                if collapse_measures:
                    emit(_OP_MEASURE, g.target_qubits[0])
                    sites.append((g.column, g.target_qubits[0]))
                continue
            if g.gate_name == "CZ":
                c, t = g.target_qubits
                emit(_OP_H, t)
                emit(_OP_CNOT, c, t)
                emit(_OP_H, t)
            else:
                ts = list(g.target_qubits)
                emit(_GATE_OPCODES[g.gate_name], ts[0],
                     ts[1] if len(ts) > 1 else 0)
            if noise_model is not None:
                for ch in noise_model.channels_for_gate(g.gate_name):
                    kind = type(ch).__name__
                    if kind == "TwoQubitDepolarizingNoise":
                        if len(g.target_qubits) != 2:
                            raise ValueError(
                                "TwoQubitDepolarizingNoise is registered "
                                f"on {g.gate_name}, a "
                                f"{len(g.target_qubits)}-qubit gate; "
                                "register it per 2-qubit gate name")
                        emit(_OP_NOISE_DEPOL2, g.target_qubits[0],
                             g.target_qubits[1], ch.probability)
                        continue
                    if kind not in _NOISE_OPCODES:
                        raise ValueError(
                            f"{kind} is not a Pauli channel; the Clifford "
                            "engine supports bit_flip/phase_flip/"
                            "depolarizing (1- and 2-qubit)")
                    for q in g.target_qubits:
                        emit(_NOISE_OPCODES[kind], q, 0, ch.probability)

    return (np.asarray(codes, np.int32), np.asarray(qa, np.int32),
            np.asarray(qb, np.int32), np.asarray(pp, np.float32), sites)


def _walk_batches(n: int, schedule, uniforms: torch.Tensor, device,
                  finish=None):
    """The schedule over ``uniforms.shape[0]`` fresh |0..0> tableaus, in
    batches by bytes. ``finish(tab, outcomes)`` may post-process each
    batch. -> (Tableau[T, ...], outcomes[T, M])."""
    codes, qa, qb, pp = schedule
    T = uniforms.shape[0]
    step = tableau_rows(n)
    parts = []
    for lo in range(0, max(T, 1), step):
        hi = min(T, lo + step)
        tab, outs = walk(identity_tableau(n, device, hi - lo), codes, qa,
                         qb, pp, uniforms[lo:hi])
        if finish is not None:
            tab = finish(tab, outs)
        parts.append((tab, outs))
    tab = Tableau(*(torch.cat([p[0][k] for p in parts]) for k in range(3)))
    return tab, torch.cat([p[1] for p in parts])


def compile_clifford(circuit: QuantumCircuit, device=None):
    """Circuit -> ``() -> Tableau`` on ``device`` (MEASUREMENT / BARRIER
    skipped, the reference simulator's semantics)."""
    codes, qa, qb, pp, _ = _lower(circuit)
    n = circuit.num_qubits
    device = device or CONFIG.device

    def evolve() -> Tableau:
        tab, _ = walk(identity_tableau(n, device, 1), codes, qa, qb, pp)
        return Tableau(tab.x[0], tab.z[0], tab.r[0])

    return evolve


def compile_clifford_monitored(circuit: QuantumCircuit, feedforward=None,
                               device=None):
    """Circuit -> ``(evolve, sites)`` where ``evolve(uniforms[T, L])``
    runs T trajectories in which every MEASUREMENT gate COLLAPSES its
    qubit at its column, -> ``(Tableau[T, ...], outcomes[T, M])``
    (``outcomes[:, i]`` is the i-th Measure gate's result in column
    order; ``sites`` its (column, qubit)).

    ``feedforward``: optional ``[(measure_index, 'X'|'Y'|'Z', qubit)]``
    classical corrections applied AFTER the circuit, conditioned on the
    recorded outcome (for Clifford circuits an end-applied conditional
    Pauli is exact)."""
    codes, qa, qb, pp, sites = _lower(circuit, collapse_measures=True)
    n = circuit.num_qubits
    device = device or CONFIG.device
    rules = []
    for mi, pauli, q in feedforward or []:
        if not 0 <= mi < len(sites):
            raise ValueError(f"feedforward references measurement {mi}; "
                             f"circuit has {len(sites)}")
        if pauli not in ("X", "Y", "Z"):
            raise ValueError(f"not a Pauli correction: {pauli}")
        if not 0 <= q < n:
            raise ValueError(f"feedforward qubit {q} out of range")
        rules.append((int(mi), pauli, int(q)))

    def correct(tab, outcomes):
        x, z, r = tab
        for mi, pauli, q in rules:
            bit = outcomes[:, mi:mi + 1]
            if pauli in ("X", "Y"):
                r ^= bit & z[..., q]
            if pauli in ("Z", "Y"):
                r ^= bit & x[..., q]
        return tab

    def evolve(uniforms: torch.Tensor):
        return _walk_batches(n, (codes, qa, qb, pp), uniforms.to(device),
                             device, correct if rules else None)

    evolve.schedule_length = len(codes)
    return evolve, sites


def compile_clifford_noisy(circuit: QuantumCircuit, noise_model,
                           device=None):
    """Circuit + Pauli noise -> ``evolve(uniforms[T, L]) -> Tableau[T]``:
    T stochastic trajectories. A Pauli channel's Kraus draw is an iid
    Pauli insertion (state-independent branch norms), i.e. two sign
    updates, so the noisy walk stays tensor algebra. Channels fire after
    every gate on its targets (the reference semantics); AmplitudeDamping
    is not a Pauli channel and is rejected."""
    codes, qa, qb, pp, _ = _lower(circuit, noise_model=noise_model)
    n = circuit.num_qubits
    device = device or CONFIG.device

    def evolve(uniforms: torch.Tensor) -> Tableau:
        return _walk_batches(n, (codes, qa, qb, pp), uniforms.to(device),
                             device)[0]

    evolve.schedule_length = len(codes)
    return evolve


def _counts(bits: np.ndarray) -> dict[str, int]:
    """Row-wise unique (integer packing would overflow past n = 63)."""
    if bits.shape[0] == 0:
        return {}
    uniq, cnts = np.unique(bits.astype(np.uint8), axis=0,
                           return_counts=True)
    return {"".join("1" if b else "0" for b in row): int(c)
            for row, c in zip(uniq, cnts)}


class CliffordSimulator:
    """Run Clifford circuits on the tableau engine at any width, on
    ``device`` (default ``CONFIG.device``).

    ``run`` mirrors ``Simulator.run``'s sampling surface (counts keyed by
    MSB-first bitstrings); ``stabilizers`` renders the generator strings;
    ``expectation_z_string`` reduces a Z-string against the group exactly
    (+1 / -1 / 0). Draws (``rand_bits``, ``uniforms``) may be passed in;
    by default they come from a ``torch.Generator`` seeded from one
    ``rng.integers(0, 2**63)`` draw of ``default_rng(seed)``."""

    def __init__(self, device=None):
        self._device = device or CONFIG.device
        self._compiled: dict = {}

    @property
    def device(self):
        return self._device

    def _final_tableau(self, circuit: QuantumCircuit) -> Tableau:
        key = circuit.structure_hash()
        fn = self._compiled.get(key)
        if fn is None:
            fn = compile_clifford(circuit, self._device)
            self._compiled[key] = fn
        return fn()

    def run(self, circuit: QuantumCircuit, shots: int = 1000,
            seed: int | None = None, rand_bits=None):
        """-> (counts, Tableau). ``rand_bits[shots, n]`` (0/1) are the
        measurement cascade's coin flips (JAX: ``bernoulli(key, 0.5,
        (shots, n))``)."""
        n = circuit.num_qubits
        tab = self._final_tableau(circuit)
        counts: dict[str, int] = {}
        if shots > 0:
            if rand_bits is None:
                gen = generator_from_rng(np.random.default_rng(seed),
                                         self._device)
                rand_bits = torch.randint(0, 2, (shots, n), generator=gen,
                                          device=self._device,
                                          dtype=torch.int8)
            bits = sample_bits(tab, torch.as_tensor(rand_bits,
                                                    device=self._device))
            counts = _counts(bits.cpu().numpy())
        return counts, tab

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               feedforward=None, uniforms=None):
        """Run T monitored trajectories (Measure gates collapse
        mid-circuit, ``compile_clifford_monitored``); ``uniforms[T, L]``
        are the per-step draws (JAX: ``uniform(k_t, (L,))`` over
        ``split(key, T)``).

        -> (outcomes[T, M] int32 array in Measure column order,
            sites [(column, qubit)] * M,
            a list of T ``Tableau``s)."""
        key = ("monitored", circuit.structure_hash(),
               tuple(map(tuple, feedforward)) if feedforward else None)
        entry = self._compiled.get(key)
        if entry is None:
            entry = compile_clifford_monitored(circuit, feedforward,
                                               self._device)
            self._compiled[key] = entry
        evolve, sites = entry
        if uniforms is None:
            gen = generator_from_rng(np.random.default_rng(seed),
                                     self._device)
            uniforms = torch.rand((n_trajectories, evolve.schedule_length),
                                  generator=gen, device=self._device)
        tabs, outs = evolve(torch.as_tensor(uniforms, dtype=torch.float32))
        tableaus = [Tableau(tabs.x[t], tabs.z[t], tabs.r[t])
                    for t in range(tabs.x.shape[0])]
        return (outs.cpu().numpy().astype(np.int32), list(sites),
                tableaus)

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1000, seed: int | None = None,
                       uniforms=None, rand_bits=None):
        """Noisy counts: one stochastic Pauli trajectory per shot and its
        measurement cascade, batched over shots (cut by bytes).
        ``uniforms[shots, L]`` drive the trajectories (JAX:
        ``uniform(k_traj, (L,))``), ``rand_bits[shots, n]`` the cascades
        (JAX: ``bernoulli(k_meas, 0.5, (1, n))``). Readout error (shot
        mode) applies if configured, from the same NumPy stream."""
        n = circuit.num_qubits
        key = (circuit.structure_hash(), str(noise_model.spec_key()))
        evolve = self._compiled.get(key)
        if evolve is None:
            evolve = compile_clifford_noisy(circuit, noise_model,
                                            self._device)
            self._compiled[key] = evolve
        rng = np.random.default_rng(seed)
        gen = generator_from_rng(rng, self._device)
        if uniforms is None:
            uniforms = torch.rand((shots, evolve.schedule_length),
                                  generator=gen, device=self._device)
        if rand_bits is None:
            rand_bits = torch.randint(0, 2, (shots, n), generator=gen,
                                      device=self._device, dtype=torch.int8)
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32,
                                   device=self._device)
        rand_bits = torch.as_tensor(rand_bits, device=self._device)
        step = tableau_rows(n)
        bits = [sample_bits(evolve(uniforms[lo:lo + step]),
                            rand_bits[lo:lo + step])
                for lo in range(0, shots, step)]
        counts = _counts(torch.cat(bits).cpu().numpy()) if bits else {}
        ro = getattr(noise_model, "readout_error", None)
        if ro is not None:
            counts = ro.corrupt_counts(counts, rng)
        return counts

    @staticmethod
    def _host(tab: Tableau):
        return tuple(np.asarray(t.cpu().numpy(), dtype=np.int64)
                     for t in tab)

    @staticmethod
    def stabilizers(tab: Tableau) -> list[str]:
        """Stabilizer generator strings, e.g. '+XXI', qubit 0 first."""
        x, z, r = CliffordSimulator._host(tab)
        n = x.shape[1]
        out = []
        for i in range(n, 2 * n):
            chars = ["IXZY"[x[i, q] + 2 * z[i, q]] for q in range(n)]
            out.append(("-" if r[i] else "+") + "".join(chars))
        return out

    @staticmethod
    def entanglement_entropy(tab: Tableau, subsystem: list[int]) -> float:
        """Exact entanglement entropy (in bits) of a stabilizer state:
        rank_GF2 of the stabilizer generators restricted to A minus |A|
        (Fattal et al., quant-ph/0406168); a host GF(2) elimination."""
        x, z, _ = CliffordSimulator._host(tab)
        n = x.shape[1]
        A = sorted(set(subsystem))
        if any(q < 0 or q >= n for q in A):
            raise ValueError(f"subsystem out of range for n={n}")
        if not A or len(A) == n:
            return 0.0
        m = np.concatenate([x[n:, A], z[n:, A]], axis=1).astype(np.uint8)
        rows, cols = m.shape
        rank = 0
        for c in range(cols):
            pivot = next((i for i in range(rank, rows) if m[i, c]), None)
            if pivot is None:
                continue
            m[[rank, pivot]] = m[[pivot, rank]]
            hit = m[:, c].astype(bool)
            hit[rank] = False
            m[hit] ^= m[rank]
            rank += 1
        return float(rank - len(A))

    @staticmethod
    def expectation_pauli_string(tab: Tableau,
                                 paulis: list[tuple[int, str]]) -> float:
        """<P> for a Pauli string P = prod (q, 'X'|'Y'|'Z'): exactly +1,
        -1 or 0 on a stabilizer state (the measurement's mod-4 ``g``
        bookkeeping over the stabilizers paired to P-anticommuting
        destabilizers)."""
        x, z, r = CliffordSimulator._host(tab)
        n = x.shape[1]
        seen = set()
        x_mask = np.zeros(n, dtype=np.int64)
        z_mask = np.zeros(n, dtype=np.int64)
        for q, p in paulis:
            if q in seen:
                raise ValueError("duplicate qubits in Pauli string")
            if q < 0 or q >= n:
                raise ValueError(f"qubit {q} out of range for n={n}")
            seen.add(q)
            if p in ("X", "Y"):
                x_mask[q] = 1
            if p in ("Z", "Y"):
                z_mask[q] = 1
            if p not in ("X", "Y", "Z"):
                raise ValueError(f"not a Pauli: {p}")
        sel = (z[:n] @ x_mask + x[:n] @ z_mask) % 2
        sx = np.zeros(n, np.int64)
        sz = np.zeros(n, np.int64)
        sr = 0
        for i in range(n):
            if sel[i]:
                xs, zs, rs = x[i + n], z[i + n], r[i + n]
                g = np.where((xs == 1) & (zs == 1), sz - sx,
                             np.where((xs == 1) & (zs == 0),
                                      sz * (2 * sx - 1),
                                      np.where((xs == 0) & (zs == 1),
                                               sx * (1 - 2 * sz), 0)))
                sr = ((2 * sr + 2 * rs + int(g.sum())) % 4) // 2
                sx ^= xs
                sz ^= zs
        if (sx != x_mask).any() or (sz != z_mask).any():
            return 0.0
        return -1.0 if sr else 1.0

    @staticmethod
    def expectation_z_string(tab: Tableau, qubits: list[int]) -> float:
        """<prod_q Z_q>, the Z-only case of ``expectation_pauli_string``."""
        if len(set(qubits)) != len(qubits):
            raise ValueError("duplicate qubits in Z string")
        return CliffordSimulator.expectation_pauli_string(
            tab, [(q, "Z") for q in qubits])
