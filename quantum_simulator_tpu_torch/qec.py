"""Quantum error correction: bit-flip, phase-flip, Steane [[7,1,3]],
rotated surface code [[9,1,3]].

Counterpart of ``quantum_simulator_tpu/qec.py``: the ``QECCode``
interface, the four codes with their layouts, codewords and decode
tables, maximum-likelihood parity syndrome extraction, ``run_cycle``
semantics, the three logical-error metrics of ``threshold_sweep``,
alternating |0>_L / |1>_L trials and ``AVAILABLE_CODES``.

The cycle is batched over trials (JAX ``vmap``s one trial's body): every
function below takes ``(T, 2^n)`` states and ``(T, dq)`` uniforms and
indexes the last axis.

* Pauli noise, X corrections and Z corrections are index arithmetic: an
  X-mask is an XOR gather ``psi[i ^ mask]``, a Z-mask a popcount sign
  ``(-1)^{|i & mask|}`` (Y = XZ up to a global phase, irrelevant for every
  reported metric).
* Syndrome bits are ML parity decisions: {0,1} parity vectors times the
  probabilities, one float32 product (TF32 off, ``config.py``).
* ``encode`` of the bit-flip and phase-flip codes runs the port's
  ``Simulator`` on ``device``, i.e. the ``dense_axis`` kernel on a card.

Draws: a trial reads ``dq`` float32 uniforms (JAX: ``uniform(key,
(dq,))``), compared with float32 thresholds as JAX does. Every entry
point takes them as an optional argument; by default each ``p`` of a
sweep draws its ``(T, dq)`` rows from one ``generator_from_rng(rng,
device)`` stream, exactly as ``qec_frame.FrameQECSimulator`` does, so the
two engines give identical per-trial outcomes under one seed.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np
import torch

from .analysis import StateAnalysis
from .circuit import GateInstance, QuantumCircuit
from .config import CONFIG
from .gates import H_MATRIX, X_MATRIX, Z_MATRIX
from .ops.apply import apply_gate
from .simulator import TRAJECTORY_MEMORY_BYTES, Simulator
from .state import StateVector
from .utils.seeding import generator_from_rng


@dataclass
class QECResult:
    """Result of a single QEC cycle."""

    encoded_state: StateVector
    noisy_state: StateVector
    syndrome: list[int]
    corrected_state: StateVector
    fidelity_before: float
    fidelity_after: float
    correction_applied: list[tuple[str, int]]
    logical_z_expectation: float = 0.0
    logical_error_detected: bool = False


@dataclass
class ThresholdPoint:
    """Result at one physical error rate in a threshold sweep."""

    physical_rate: float
    logical_rate: float
    success_rate: float
    avg_fidelity: float
    logical_z_fidelity: float = 0.0
    decoder_success_rate: float = 0.0
    projection_logical_rate: float = 0.0


def _parity_vector(qubits: list[int], n: int) -> np.ndarray:
    """Static {0,1}^(2^n) vector: parity of the given qubits per index."""
    idx = np.arange(2**n, dtype=np.int64)
    parity = np.zeros(2**n, dtype=np.int64)
    for q in qubits:
        parity ^= (idx >> (n - 1 - q)) & 1
    return parity.astype(np.float32)


def _qubit_bit(q: int, n: int) -> int:
    return 1 << (n - 1 - q)


class QECCode(ABC):
    """Abstract base for quantum error correcting codes."""

    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    @abstractmethod
    def data_qubits(self) -> int: ...

    @property
    @abstractmethod
    def ancilla_qubits(self) -> int: ...

    @property
    def total_qubits(self) -> int:
        return self.data_qubits + self.ancilla_qubits

    @property
    @abstractmethod
    def code_distance(self) -> int: ...

    @abstractmethod
    def encode(self, logical_state: int, device=None) -> StateVector: ...

    @abstractmethod
    def decode_syndrome(self, syndrome: list[int]) -> list[tuple[str, int]]:
        """Syndrome -> [(gate_name, qubit)] correction list (host lookup)."""
        ...

    @abstractmethod
    def logical_z_operators(self) -> list[int]: ...

    # --- compiled-cycle hooks (code-specific static structure) ------------

    @abstractmethod
    def comp_frame_checks(self) -> list[list[int]]:
        """Parity checks evaluated on the computational-frame state."""
        ...

    def h_frame_checks(self) -> list[list[int]]:
        """Parity checks evaluated after H on the data qubits."""
        return []

    def logical_z_in_h_frame(self) -> bool:
        """True when Z_L must be read in the H-rotated frame."""
        return False

    @abstractmethod
    def decode_masks(self, syn_comp, syn_h, n: int):
        """Batched decode: syndrome bits ``(..., checks)`` int tensors ->
        ``(xor_mask, z_mask)`` int64 tensors of shape ``(...)``."""
        ...

    # --- shared host API ---------------------------------------------------

    def extract_syndrome(self, state: StateVector,
                         rng: np.random.Generator | None = None
                         ) -> list[int]:
        """Maximum-likelihood parity syndrome (p_odd vs p_even per check)."""
        n = state.num_qubits
        probs = state.probabilities
        syndrome = []
        for check in self.comp_frame_checks():
            p_odd = float(probs @ _parity_vector(check, n))
            syndrome.append(1 if p_odd > 0.5 else 0)
        h_checks = self.h_frame_checks()
        if h_checks:
            temp = state.copy()
            for q in range(self.data_qubits):
                temp.apply_gate(H_MATRIX, [q])
            h_probs = temp.probabilities
            for check in h_checks:
                p_odd = float(h_probs @ _parity_vector(check, n))
                syndrome.append(1 if p_odd > 0.5 else 0)
        return syndrome

    def apply_correction(self, state: StateVector,
                         corrections: list[tuple[str, int]]) -> None:
        gate_map = {"X": X_MATRIX, "Z": Z_MATRIX}
        for gate_name, qubit in corrections:
            if gate_name in gate_map and qubit < state.num_qubits:
                state.apply_gate(gate_map[gate_name], [qubit])

    def logical_fidelity(self, state: StateVector,
                         logical_state: int) -> float:
        ideal = self.encode(logical_state, state.device_data.device)
        return StateAnalysis.process_fidelity(ideal, state)

    def logical_z_expectation(self, state: StateVector) -> float:
        """<Z_L> as a precomputed ±1 parity vector dotted with probs."""
        n = state.num_qubits
        if self.logical_z_in_h_frame():
            temp = state.copy()
            for q in range(self.data_qubits):
                temp.apply_gate(H_MATRIX, [q])
            probs = temp.probabilities
        else:
            probs = state.probabilities
        parity = _parity_vector(self.logical_z_operators(), n)
        return float(probs @ (1.0 - 2.0 * parity))


# ---------------------------------------------------------------------------
# Bit-flip [3,1,1]
# ---------------------------------------------------------------------------

class BitFlipCode(QECCode):
    """|0>_L = |000>, |1>_L = |111>; corrects single X errors.

    Layout: data 0-2, ancilla 3-4; checks Z0Z1 and Z1Z2."""

    @property
    def name(self) -> str:
        return "Bit-Flip [3,1,1]"

    @property
    def data_qubits(self) -> int:
        return 3

    @property
    def ancilla_qubits(self) -> int:
        return 2

    @property
    def code_distance(self) -> int:
        return 1

    def _encoding_circuit(self, logical_state: int) -> QuantumCircuit:
        """The circuit ``encode`` runs on the statevector Simulator."""
        qc = QuantumCircuit(5)
        if logical_state == 1:
            qc.add_gate(GateInstance("X", [0], [], 0))
        qc.add_gate(GateInstance("CNOT", [0, 1], [], 1))
        qc.add_gate(GateInstance("CNOT", [0, 2], [], 2))
        return qc

    def encode(self, logical_state: int, device=None) -> StateVector:
        return Simulator(device=device).run(
            self._encoding_circuit(logical_state), shots=0).final_state

    def comp_frame_checks(self) -> list[list[int]]:
        return [[0, 1], [1, 2]]

    def decode_syndrome(self, syndrome: list[int]) -> list[tuple[str, int]]:
        table = {(0, 0): [], (1, 0): [("X", 0)],
                 (1, 1): [("X", 1)], (0, 1): [("X", 2)]}
        return table.get((syndrome[0], syndrome[1]), [])

    def decode_masks(self, syn_comp, syn_h, n: int):
        s0, s1 = syn_comp[..., 0].long(), syn_comp[..., 1].long()
        xor_mask = (s0 * (1 - s1) * _qubit_bit(0, n)
                    + s0 * s1 * _qubit_bit(1, n)
                    + (1 - s0) * s1 * _qubit_bit(2, n))
        return xor_mask, torch.zeros_like(xor_mask)

    def logical_z_operators(self) -> list[int]:
        return [0, 1, 2]


# ---------------------------------------------------------------------------
# Phase-flip [3,1,1]
# ---------------------------------------------------------------------------

class PhaseFlipCode(QECCode):
    """|0>_L = |+++>, |1>_L = |--->; corrects single Z errors.

    Syndrome read in the H-rotated frame; corrections are Z gates; the
    logical operator is X_L, measured by rotating to the X basis."""

    @property
    def name(self) -> str:
        return "Phase-Flip [3,1,1]"

    @property
    def data_qubits(self) -> int:
        return 3

    @property
    def ancilla_qubits(self) -> int:
        return 2

    @property
    def code_distance(self) -> int:
        return 1

    def _encoding_circuit(self, logical_state: int) -> QuantumCircuit:
        """The circuit ``encode`` runs on the statevector Simulator."""
        qc = BitFlipCode()._encoding_circuit(logical_state)
        for q in range(3):
            qc.add_gate(GateInstance("H", [q], [], 3))
        return qc

    def encode(self, logical_state: int, device=None) -> StateVector:
        return Simulator(device=device).run(
            self._encoding_circuit(logical_state), shots=0).final_state

    def comp_frame_checks(self) -> list[list[int]]:
        return []

    def h_frame_checks(self) -> list[list[int]]:
        return [[0, 1], [1, 2]]

    def logical_z_in_h_frame(self) -> bool:
        return True

    def decode_syndrome(self, syndrome: list[int]) -> list[tuple[str, int]]:
        table = {(0, 0): [], (1, 0): [("Z", 0)],
                 (1, 1): [("Z", 1)], (0, 1): [("Z", 2)]}
        return table.get((syndrome[0], syndrome[1]), [])

    def decode_masks(self, syn_comp, syn_h, n: int):
        s0, s1 = syn_h[..., 0].long(), syn_h[..., 1].long()
        z_mask = (s0 * (1 - s1) * _qubit_bit(0, n)
                  + s0 * s1 * _qubit_bit(1, n)
                  + (1 - s0) * s1 * _qubit_bit(2, n))
        return torch.zeros_like(z_mask), z_mask

    def logical_z_operators(self) -> list[int]:
        return [0, 1, 2]


# ---------------------------------------------------------------------------
# Steane [[7,1,3]]
# ---------------------------------------------------------------------------

class SteaneCode(QECCode):
    """Steane [[7,1,3]] CSS code: 7 data + 6 ancilla = 13 qubits.

    Codewords are superpositions of the [7,4,3] Hamming code's even-weight
    (|0>_L) and odd-weight (|1>_L) words, built directly into the amplitude
    array. Corrects any single-qubit error."""

    # Hamming [7,4,3] parity checks: qubit q participates in check i iff
    # bit i of (q+1) is set — so a single bit flip's syndrome integer IS
    # its 1-indexed position. (The reference hardcodes a generator matrix
    # inconsistent with these checks, ``qec.py:363-368``; here the
    # codewords are derived from the checks' null space directly.)
    _CHECKS = [[0, 2, 4, 6], [1, 2, 5, 6], [3, 4, 5, 6]]

    @property
    def name(self) -> str:
        return "Steane [[7,1,3]]"

    @property
    def data_qubits(self) -> int:
        return 7

    @property
    def ancilla_qubits(self) -> int:
        return 6

    @property
    def code_distance(self) -> int:
        return 3

    def _codewords(self) -> list[tuple[int, ...]]:
        """All 16 words in the null space of the Hamming checks."""
        words = []
        for v in range(128):
            bits = tuple((v >> (6 - q)) & 1 for q in range(7))
            if all(sum(bits[q] for q in check) % 2 == 0
                   for check in self._CHECKS):
                words.append(bits)
        assert len(words) == 16
        return words

    def encode(self, logical_state: int, device=None) -> StateVector:
        n_total = 13
        codewords = self._codewords()
        wanted = [cw for cw in codewords
                  if sum(cw) % 2 == (logical_state & 1)]
        amp = 1.0 / np.sqrt(len(wanted))
        data = np.zeros(2**n_total, dtype=np.complex128)
        for cw in wanted:
            idx = 0
            for qi, bit in enumerate(cw):
                if bit:
                    idx |= 1 << (n_total - 1 - qi)
            data[idx] = amp
        return StateVector.from_numpy(data, device)

    def comp_frame_checks(self) -> list[list[int]]:
        return list(self._CHECKS)

    def h_frame_checks(self) -> list[list[int]]:
        return list(self._CHECKS)

    def decode_syndrome(self, syndrome: list[int]) -> list[tuple[str, int]]:
        """Computational-frame syndrome (bits 0-2, Z-stabilizer parities)
        locates X errors; H-frame syndrome (bits 3-5, X-stabilizer
        parities) locates Z errors. The syndrome integer is the 1-indexed
        error position. (The reference swaps these roles, ``qec.py:419-439``
        — a decoder bug; this is the physically correct mapping.)"""
        corrections = []
        x_pos = syndrome[0] + 2 * syndrome[1] + 4 * syndrome[2]
        if 0 < x_pos <= 7:
            corrections.append(("X", x_pos - 1))
        z_pos = syndrome[3] + 2 * syndrome[4] + 4 * syndrome[5]
        if 0 < z_pos <= 7:
            corrections.append(("Z", z_pos - 1))
        return corrections

    def decode_masks(self, syn_comp, syn_h, n: int):
        def mask(syn):
            pos = (syn[..., 0] + 2 * syn[..., 1] + 4 * syn[..., 2]).long()
            return torch.where(pos > 0, torch.ones_like(pos) << (n - pos),
                               0)

        xor_mask, z_mask = mask(syn_comp), mask(syn_h)
        return xor_mask, z_mask

    def logical_z_operators(self) -> list[int]:
        return list(range(7))


# ---------------------------------------------------------------------------
# Rotated surface code [[d^2, 1, d]]
# ---------------------------------------------------------------------------

def _rotated_surface_geometry(distance: int):
    """Stabilizer geometry of the rotated surface code on a d x d grid.

    Data qubit (row, col) -> index ``row * d + col``.  A cell anchored at
    (r, c) covers the grid points {(r,c), (r,c+1), (r+1,c), (r+1,c+1)}
    clipped to the lattice; interior cells checkerboard Z/X by (r+c)
    parity (Z when even), and the weight-2 boundary half-cells keep only
    the X-type cells on the top/bottom rows and the Z-type cells on the
    left/right columns — the standard rotated layout with (d^2-1)/2
    stabilizers per sector.  Logical operators: Z_L = Z on row 0,
    X_L = X on column 0 (each crosses between its pair of boundaries and
    overlaps the other in exactly one qubit).

    Returns ``(z_checks, x_checks, z_logical, x_logical)`` as qubit-index
    lists.  Correctness (commutation, ranks, logical algebra) is locked
    by ``tests/test_surface_code.py``.
    """
    d = distance
    if d < 3 or d % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    z_checks: list[list[int]] = []
    x_checks: list[list[int]] = []
    for r in range(-1, d):
        for c in range(-1, d):
            cell = [(rr, cc) for rr in (r, r + 1) for cc in (c, c + 1)
                    if 0 <= rr < d and 0 <= cc < d]
            if len(cell) < 2:
                continue  # corner half-cells are never stabilizers
            is_z = (r + c) % 2 == 0
            qubits = [rr * d + cc for rr, cc in cell]
            if len(cell) == 2:
                on_row_edge = r == -1 or r == d - 1
                if on_row_edge and not is_z:
                    x_checks.append(qubits)
                elif not on_row_edge and is_z:
                    z_checks.append(qubits)
                continue
            (z_checks if is_z else x_checks).append(qubits)
    z_logical = list(range(d))
    x_logical = [r * d for r in range(d)]
    return z_checks, x_checks, z_logical, x_logical


def _coset_leader_lut(checks: np.ndarray) -> np.ndarray:
    """Exact minimum-weight decode table for one CSS error sector.

    ``checks`` is the (n_checks, dq) GF(2) parity-check matrix; the
    returned (2^n_checks, dq) 0/1 int32 table maps each syndrome to a
    minimum-weight error producing it (a coset leader).  Built by BFS
    over the syndrome graph whose edges are single-qubit toggles: a
    syndrome first reached at BFS layer w has minimum error weight
    exactly w, so every representative is minimal.  Memory is
    O(2^n_checks * dq) — callers cap the check count accordingly.
    """
    nch, dq = checks.shape
    n_syn = 1 << nch
    col_syn = np.zeros(dq, dtype=np.int64)
    for c in range(nch):
        col_syn |= checks[c].astype(np.int64) << c
    lut = np.zeros((n_syn, dq), dtype=np.int32)
    seen = np.zeros(n_syn, dtype=bool)
    seen[0] = True
    frontier = [0]
    found = 1
    while frontier and found < n_syn:
        nxt = []
        for s in frontier:
            for q in range(dq):
                s2 = s ^ int(col_syn[q])
                if not seen[s2]:
                    seen[s2] = True
                    lut[s2] = lut[s]
                    lut[s2, q] ^= 1
                    nxt.append(s2)
                    found += 1
        frontier = nxt
    if found < n_syn:
        raise ValueError("parity checks do not span the syndrome space")
    return lut


class RotatedSurfaceCode(QECCode):
    """Rotated surface code [[d^2, 1, d]] — a 2D topological code.

    A capability beyond the reference (its QEC zoo stops at Steane).
    Syndrome extraction is ML-parity like the other codes here, so no
    ancilla circuit is needed (``ancilla_qubits = 0``, total = d^2
    qubits) and the batched cycle serves it unchanged.  Decoding is exact
    minimum-weight per CSS sector via host-built coset-leader tables
    (``_coset_leader_lut``) — for surface codes this is the decoder
    MWPM approximates, computed exactly.

    The statevector realization is capped at d=3 (2^9 amplitudes per
    trial); larger distances run 2^n-free on the Pauli-frame engine
    (``qec_frame.surface_code_frame_spec``), which shares this geometry
    and is draw-exact against this class under the same seed.
    """

    def __init__(self, distance: int = 3):
        if distance != 3:
            raise ValueError(
                "statevector surface code is capped at d=3 (the cycle "
                "kernel materializes 2^(d^2) amplitudes per trial); use "
                "qec_frame.surface_code_frame_spec for d=5")
        self._d = distance
        z_checks, x_checks, z_log, x_log = \
            _rotated_surface_geometry(distance)
        self._z_checks = z_checks
        self._x_checks = x_checks
        self._z_logical = z_log
        self._x_logical = x_log
        dq = distance * distance
        comp = np.zeros((len(z_checks), dq), dtype=np.uint8)
        for i, qs in enumerate(z_checks):
            comp[i, qs] = 1
        h = np.zeros((len(x_checks), dq), dtype=np.uint8)
        for i, qs in enumerate(x_checks):
            h[i, qs] = 1
        self._lut_x = _coset_leader_lut(comp)   # comp syndrome -> X corr
        self._lut_z = _coset_leader_lut(h)      # h syndrome -> Z corr

    @property
    def name(self) -> str:
        return f"Surface [[{self._d * self._d},1,{self._d}]]"

    @property
    def data_qubits(self) -> int:
        return self._d * self._d

    @property
    def ancilla_qubits(self) -> int:
        return 0

    @property
    def code_distance(self) -> int:
        return self._d

    def encode(self, logical_state: int, device=None) -> StateVector:
        """|b>_L = X_L^b applied to the uniform X-stabilizer orbit of
        |0...0> (the CSS codeword construction, built directly into the
        amplitude array like SteaneCode.encode)."""
        n = self.data_qubits
        base = 0
        if logical_state & 1:
            for q in self._x_logical:
                base |= 1 << (n - 1 - q)
        masks = []
        for check in self._x_checks:
            m = 0
            for q in check:
                m |= 1 << (n - 1 - q)
            masks.append(m)
        indices = set()
        for sub in range(1 << len(masks)):
            idx = base
            for i, m in enumerate(masks):
                if (sub >> i) & 1:
                    idx ^= m
            indices.add(idx)
        amp = 1.0 / np.sqrt(len(indices))
        data = np.zeros(2 ** n, dtype=np.complex128)
        data[sorted(indices)] = amp
        return StateVector.from_numpy(data, device)

    def comp_frame_checks(self) -> list[list[int]]:
        return [list(qs) for qs in self._z_checks]

    def h_frame_checks(self) -> list[list[int]]:
        return [list(qs) for qs in self._x_checks]

    def decode_syndrome(self, syndrome: list[int]) -> list[tuple[str, int]]:
        nc = len(self._z_checks)
        ic = sum(int(b) << i for i, b in enumerate(syndrome[:nc]))
        ih = sum(int(b) << i
                 for i, b in enumerate(syndrome[nc:nc + len(self._x_checks)]))
        corrections = [("X", int(q)) for q in np.nonzero(self._lut_x[ic])[0]]
        corrections += [("Z", int(q)) for q in np.nonzero(self._lut_z[ih])[0]]
        return corrections

    def decode_masks(self, syn_comp, syn_h, n: int):
        dq = self.data_qubits
        w = np.asarray([1 << (n - 1 - q) for q in range(dq)], dtype=np.int64)
        dev = syn_comp.device
        mask_x = torch.from_numpy(self._lut_x.astype(np.int64) @ w).to(dev)
        mask_z = torch.from_numpy(self._lut_z.astype(np.int64) @ w).to(dev)
        pow_c = 1 << torch.arange(len(self._z_checks), device=dev)
        pow_h = 1 << torch.arange(len(self._x_checks), device=dev)
        return (mask_x[(syn_comp.long() * pow_c).sum(-1)],
                mask_z[(syn_h.long() * pow_h).sum(-1)])

    def logical_z_operators(self) -> list[int]:
        return list(self._z_logical)

    def logical_x_operators(self) -> list[int]:
        return list(self._x_logical)


# ---------------------------------------------------------------------------
# Batched cycle
# ---------------------------------------------------------------------------

def _thresholds(p) -> tuple[np.float32, np.float32, np.float32]:
    """(p, 2p/3, p/3) rounded in float32, as JAX computes them."""
    p32 = np.float32(p)
    return p32, np.float32(2) * p32 / np.float32(3), p32 / np.float32(3)


def _error_bits(r: torch.Tensor, p, noise_type: str):
    """Uniform draws -> (x_bits, z_bits) bool; r < p/3 -> X,
    p/3 <= r < 2p/3 -> Y (X and Z), 2p/3 <= r < p -> Z (depolarizing)."""
    p32, two_thirds, third = _thresholds(p)
    if noise_type == "bit_flip":
        x = r < p32
        return x, torch.zeros_like(x)
    if noise_type == "phase_flip":
        z = r < p32
        return torch.zeros_like(z), z
    if noise_type == "depolarizing":
        return r < two_thirds, (r >= third) & (r < p32)
    raise ValueError(f"Unknown noise type: {noise_type}")


def _pauli_masks_from_draws(r, p, noise_type: str, data_qubits: int,
                            n: int):
    """Per-qubit uniforms ``(..., dq)`` -> (xor_mask, z_mask) int64 of
    shape ``(...)``."""
    x_bits, z_bits = _error_bits(r, p, noise_type)
    weights = torch.tensor([_qubit_bit(q, n) for q in range(data_qubits)],
                           dtype=torch.int64, device=r.device)
    return ((x_bits.long() * weights).sum(-1),
            (z_bits.long() * weights).sum(-1))


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Popcount parity of non-negative int64 entries."""
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def _apply_masks(psi, xor_mask, z_mask, dim: int):
    """X-mask (XOR gather) and Z-mask (popcount sign) on ``(..., dim)``
    states, one mask per leading index."""
    idx = torch.arange(dim, device=psi.device)
    xor_mask = torch.as_tensor(xor_mask, device=psi.device)[..., None]
    z_mask = torch.as_tensor(z_mask, device=psi.device)[..., None]
    flipped = torch.gather(psi, -1, (idx ^ xor_mask).expand(psi.shape))
    sign = 1.0 - 2.0 * _parity(idx & z_mask).to(torch.float32)
    return flipped * sign


def _h_rotate_data(psi, data_qubits: int, n: int):
    for q in range(data_qubits):
        psi = apply_gate(psi, H_MATRIX, (q,), n)
    return psi


def _parities(checks: list[list[int]], n: int, device) -> torch.Tensor:
    dim = 2**n
    mat = (np.stack([_parity_vector(c, n) for c in checks]) if checks
           else np.zeros((0, dim), np.float32))
    return torch.from_numpy(mat).to(device)


def _syndrome(probs: torch.Tensor, parities: torch.Tensor) -> torch.Tensor:
    """ML parity decisions ``(T, checks)`` int32 from ``(T, dim)``
    probabilities."""
    return (probs @ parities.T > 0.5).to(torch.int32)


def _noise_syndrome_correct(code: "QECCode", noise_type: str,
                            comp_parities, h_parities, p, ideal, r):
    """Inject noise, extract the ML parity syndrome, decode, correct, on
    a batch: ``ideal (T, dim)``, ``r (T, dq)`` uniforms. Returns (noisy,
    corrected, syn_comp, syn_h, xor_corr, z_corr)."""
    n = code.total_qubits
    dim = 2**n
    dq = code.data_qubits
    xor_noise, z_noise = _pauli_masks_from_draws(r, p, noise_type, dq, n)
    noisy = _apply_masks(ideal, xor_noise, z_noise, dim)
    probs_comp = noisy.real.square() + noisy.imag.square()
    syn_comp = _syndrome(probs_comp, comp_parities)
    if code.h_frame_checks():
        rot = _h_rotate_data(noisy, dq, n)
        probs_h = rot.real.square() + rot.imag.square()
    else:
        probs_h = probs_comp
    syn_h = _syndrome(probs_h, h_parities)
    xor_corr, z_corr = code.decode_masks(syn_comp, syn_h, n)
    corrected = _apply_masks(noisy, xor_corr, z_corr, dim)
    return noisy, corrected, syn_comp, syn_h, xor_corr, z_corr


def build_cycle_fn(code: QECCode, noise_type: str, device=None):
    """``f(p, ideal_states[T, dim], uniforms[T, dq]) -> metrics``, batched
    over trials; ``p`` is a host scalar, so one build serves a sweep.
    Returns per-trial (fid_before, fid_after, z_exp, syndrome, xor, z)."""
    n = code.total_qubits
    dq = code.data_qubits
    device = device or CONFIG.device
    comp_parities = _parities(code.comp_frame_checks(), n, device)
    h_parities = _parities(code.h_frame_checks(), n, device)
    zl_parity = torch.from_numpy(
        1.0 - 2.0 * _parity_vector(code.logical_z_operators(), n)).to(device)
    zl_in_h = code.logical_z_in_h_frame()

    def cycle(p, ideal, uniforms):
        noisy, corrected, syn_comp, syn_h, xor_corr, z_corr = \
            _noise_syndrome_correct(code, noise_type, comp_parities,
                                    h_parities, p, ideal, uniforms)
        fid_before = (ideal.conj() * noisy).sum(-1).abs().square()
        fid_after = (ideal.conj() * corrected).sum(-1).abs().square()
        read = _h_rotate_data(corrected, dq, n) if zl_in_h else corrected
        z_exp = ((read.real.square() + read.imag.square()) * zl_parity
                 ).sum(-1)
        return (fid_before, fid_after, z_exp,
                torch.cat([syn_comp, syn_h], dim=-1), xor_corr, z_corr)

    return cycle


def _build_states_fn(code, noise_type: str, device=None):
    """``(p, ideal[T, dim], uniforms[T, dq]) -> (noisy, corrected)``,
    the same pipeline as ``build_cycle_fn``."""
    n = code.total_qubits
    device = device or CONFIG.device
    comp_par = _parities(code.comp_frame_checks(), n, device)
    h_par = _parities(code.h_frame_checks(), n, device)

    def states(p, ideal, uniforms):
        noisy, corrected, *_ = _noise_syndrome_correct(
            code, noise_type, comp_par, h_par, p, ideal, uniforms)
        return noisy, corrected

    return states


# ---------------------------------------------------------------------------
# QEC simulator
# ---------------------------------------------------------------------------

def trial_uniforms(rng: np.random.Generator, n_trials: int, dq: int,
                   device) -> torch.Tensor:
    """The sweeps' per-p draws: ``(T, dq)`` float32 rows from one
    ``generator_from_rng(rng, device)`` stream (shared with
    ``qec_frame``)."""
    gen = generator_from_rng(rng, device)
    return torch.rand((n_trials, dq), generator=gen, device=device)


class QECSimulator:
    """Run QEC cycles and threshold sweeps, batched over trials on
    ``device`` (default ``CONFIG.device``)."""

    def __init__(self, code: QECCode, device=None):
        self._code = code
        self._device = device or CONFIG.device
        self._cycle_fns: dict[str, callable] = {}
        self._states_fns: dict[str, callable] = {}
        self._encoded_cache: dict[int, StateVector] = {}

    @property
    def code(self) -> QECCode:
        return self._code

    @property
    def device(self):
        return self._device

    def _cycle_fn(self, noise_type: str):
        fn = self._cycle_fns.get(noise_type)
        if fn is None:
            fn = build_cycle_fn(self._code, noise_type, self._device)
            self._cycle_fns[noise_type] = fn
        return fn

    def _encoded(self, logical_state: int) -> StateVector:
        sv = self._encoded_cache.get(logical_state)
        if sv is None:
            sv = self._code.encode(logical_state, self._device)
            self._encoded_cache[logical_state] = sv
        return sv

    def _uniforms(self, rng, n_trials: int, uniforms) -> torch.Tensor:
        if uniforms is None:
            return trial_uniforms(rng, n_trials, self._code.data_qubits,
                                  self._device)
        return torch.as_tensor(uniforms, dtype=torch.float32,
                               device=self._device)

    def cycles(self, noise_type: str, noise_prob: float, ideals, uniforms):
        """Per-trial cycle metrics of ``ideals[T, dim]`` under
        ``uniforms[T, dq]``, in batches cut by bytes: -> (fid_before,
        fid_after, z_exp, syndrome, xor_corr, z_corr) tensors."""
        fn = self._cycle_fn(noise_type)
        dim = ideals.shape[-1]
        step = max(1, TRAJECTORY_MEMORY_BYTES // (16 * 8 * dim))
        parts = [fn(noise_prob, ideals[lo:lo + step],
                    uniforms[lo:lo + step])
                 for lo in range(0, ideals.shape[0], step)]
        return tuple(torch.cat([p[k] for p in parts]) for k in range(6))

    def run_cycle(self, logical_state: int = 0,
                  noise_type: str = "bit_flip", noise_prob: float = 0.1,
                  seed: int | None = None, uniforms=None) -> QECResult:
        """One encode -> noise -> syndrome -> correct cycle;
        ``uniforms[1, dq]`` (or ``[dq]``) replaces the seeded draw."""
        rng = np.random.default_rng(seed)
        ideal = self._encoded(logical_state)
        u = self._uniforms(rng, 1, uniforms).reshape(1, -1)
        ideal_b = ideal.device_data[None, :]
        fb, fa, z_exp, syndrome, _, _ = self._cycle_fn(noise_type)(
            noise_prob, ideal_b, u)
        syndrome_list = [int(b) for b in syndrome[0].tolist()]
        corrections = self._code.decode_syndrome(syndrome_list)

        states_fn = self._states_fns.get(noise_type)
        if states_fn is None:
            states_fn = _build_states_fn(self._code, noise_type,
                                         self._device)
            self._states_fns[noise_type] = states_fn
        noisy_arr, corrected_arr = states_fn(noise_prob, ideal_b, u)
        n = self._code.total_qubits
        expected_sign = 1.0 if logical_state == 0 else -1.0
        z_val = float(z_exp[0])
        return QECResult(
            encoded_state=ideal,
            noisy_state=StateVector.from_tensor(noisy_arr[0], n),
            syndrome=syndrome_list,
            corrected_state=StateVector.from_tensor(corrected_arr[0], n),
            fidelity_before=float(fb[0]),
            fidelity_after=float(fa[0]),
            correction_applied=corrections,
            logical_z_expectation=z_val,
            logical_error_detected=(z_val * expected_sign) < 0,
        )

    def _ideals(self, n_trials: int) -> torch.Tensor:
        """|0>_L / |1>_L alternating per trial, ``(T, dim)``."""
        even = torch.arange(n_trials, device=self._device) % 2 == 0
        return torch.where(even[:, None],
                           self._encoded(0).device_data[None, :],
                           self._encoded(1).device_data[None, :])

    def threshold_sweep(self, noise_probs: list[float], n_trials: int = 100,
                        noise_type: str = "bit_flip",
                        seed: int | None = None,
                        uniforms=None) -> list[ThresholdPoint]:
        """Physical vs logical error rate: all trials at each p run as one
        batch; |0>_L / |1>_L alternate per trial. ``uniforms[k]`` (T, dq)
        replaces the draws of ``noise_probs[k]``."""
        rng = np.random.default_rng(seed)
        logicals = np.arange(n_trials) % 2
        ideals = self._ideals(n_trials)
        expected_signs = np.where(logicals == 0, 1.0, -1.0)

        results = []
        for k, p in enumerate(noise_probs):
            u = self._uniforms(rng, n_trials,
                               None if uniforms is None else uniforms[k])
            _, fa, z_exp, _, _, _ = self.cycles(noise_type, p, ideals, u)
            fa = fa.cpu().numpy().astype(np.float64)
            z_exp = z_exp.cpu().numpy().astype(np.float64)
            successes = int((fa > 0.5).sum())
            z_sign_correct = int(((z_exp * expected_signs) >= 0).sum())
            results.append(ThresholdPoint(
                physical_rate=float(p),
                logical_rate=1.0 - successes / n_trials,
                success_rate=successes / n_trials,
                avg_fidelity=float(fa.mean()),
                logical_z_fidelity=float(np.abs(z_exp).mean()),
                decoder_success_rate=z_sign_correct / n_trials,
                projection_logical_rate=float(1.0 - fa.mean()),
            ))
        return results

    def projection_logical_error(self, logical_state: int, noise_type: str,
                                 noise_prob: float, n_trials: int = 100,
                                 seed: int | None = None,
                                 uniforms=None) -> dict:
        """1 - mean F(corrected, ideal) plus the Z_L-sign error rate."""
        rng = np.random.default_rng(seed)
        ideal = self._encoded(logical_state).device_data
        ideals = ideal.expand(n_trials, -1)
        u = self._uniforms(rng, n_trials, uniforms)
        _, fa, z_exp, _, _, _ = self.cycles(noise_type, noise_prob, ideals,
                                            u)
        fa = fa.cpu().numpy().astype(np.float64)
        z_exp = z_exp.cpu().numpy().astype(np.float64)
        expected_sign = 1.0 if logical_state == 0 else -1.0
        mean_fid = float(fa.mean())
        return {
            "mean_fidelity": mean_fid,
            "logical_error_rate": 1.0 - mean_fid,
            "z_sign_error_rate": float(((z_exp * expected_sign) < 0).mean()),
            "n_trials": n_trials,
        }


AVAILABLE_CODES = {
    "Bit-Flip [3,1,1]": BitFlipCode,
    "Phase-Flip [3,1,1]": PhaseFlipCode,
    "Steane [[7,1,3]]": SteaneCode,
    "Surface [[9,1,3]]": RotatedSurfaceCode,
}
