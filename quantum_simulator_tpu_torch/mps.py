"""Matrix-product-state (MPS) engine: low-entanglement circuits at 100+ qubits.

Counterpart of ``quantum_simulator_tpu/mps.py``. An MPS tracks arbitrary
gates on hundreds of qubits exactly while the entanglement across every
cut fits the bond dimension ``chi``, and reports the squared Schmidt
weight it discards when it does not (``MPSState.truncation_weight``;
0.0 means the run was exact).

The JAX package traces the circuit walk into one jitted program per
circuit and ``vmap``s it over shots, trajectories and parameter rows. The
port walks the same sequence eagerly over a *batch* of MPS: every site
tensor is ``(B, l, 2, r)``, and the leading ``B`` is what ``vmap`` was
(the shots of ``run_with_noise``, the trajectories of
``monitored_trajectories`` and of ``lindblad_mps``, the parameter rows of
``build_batched_cost_fn``). The bond profile follows the gate sequence
only, so it is the same in every row and the batch stays rectangular;
each gate is one batched contraction and one batched SVD
(``torch.linalg.svd`` on the device), each centre move one thin QR, or on
a batch on the card one batched SVD (``_isometry_split``: cuSOLVER's
batched QR is one solver call per row). Per-row gate matrices (the
variational rows) are ``(B, d, d)``.

* The orthogonality-centre discipline (left-canonical left of the gate,
  right-canonical right of it) makes every SVD truncation optimal for
  its bond; the discarded weight is summed per row.
* Sampling is the conditional cascade over the right-canonical tensors,
  one uniform per site and shot (``uniforms=``, the JAX package's
  ``jax.random.uniform`` per site). It walks the ragged tensors as they
  are: the padded ``(chi, 2, chi)`` stack of the JAX package exists for
  ``lax.scan`` and is not needed eagerly.
* A Kraus or projector draw is ``argmax(log w + g)`` with one Gumbel row
  ``g`` per draw (``jax.random.categorical``): ``gumbels=`` takes them.
* Non-adjacent gates route by adjacent SWAPs and un-route afterwards;
  ``target_qubits[0]`` is the most significant bit of a gate matrix.

Qubit 0 is the most significant bit of every bitstring; MEASUREMENT and
BARRIER gates are skipped during evolution and sampling happens at the
end. Every entry point runs on ``device`` (default ``CONFIG.device``)
in ``CONFIG.dtype``: complex64, or complex128 under
``config.enable_complex128``. The gate, Pauli, basis-rotation and
projector matrices are exact complex128 constants cast to the state's
dtype where they are used; the discarded weight, the energies and the
reductions that decide a draw (branch weights, ``pr0``) follow the
state's precision (JAX keeps its energies and discarded weights float32
in its mode). The draws themselves (uniforms, Gumbel rows) are float32,
as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG
from .gates import GateType
from .registry import GateRegistry
from .utils.seeding import generator_from_rng

# Widest dense gate the k-site contraction path accepts: theta holds
# 2^k * chi^2 amplitudes and the split SVDs touch (2*chi, 2^(k-1)*chi)
# matrices.
_MAX_DENSE_SITES = 8

# Rows of a batched evolution are cut so that one batch's site tensors at
# full bond dimension stay within this many bytes (the factorisations'
# work space is a few times that).
MPS_BATCH_BYTES = 8 * 2**30

# Widest matrix cuSOLVER's batched Jacobi SVD takes (``gesvdjBatched``):
# up to it a batch of SVDs is one solver call, past it PyTorch loops over
# the batch. Its batched QR loops over the batch at every size.
BATCHED_SVD_MAX = 32

# Host constants in complex128, each cast to the state's dtype where it is
# used (1/sqrt(2) rounded to float32 would be 1e-8 off in complex128).
_PAULI_2X2 = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], np.complex128),
    "Z": np.array([[1, 0], [0, -1]], np.complex128),
}

_H_2X2 = np.array([[1, 1], [1, -1]], np.complex128) / np.sqrt(2.0)
_SDG_2X2 = np.array([[1, 0], [0, -1j]], np.complex128)
_SWAP_4X4 = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                      [0, 0, 0, 1]], np.complex128)
_PROJECTORS = np.stack([np.diag([1, 0]), np.diag([0, 1])]).astype(
    np.complex128)


class MPSState(NamedTuple):
    """Final MPS: ragged ``(l, 2, r)`` site tensors on the device with the
    orthogonality centre at site 0 (everything right of it is
    right-canonical), plus the total squared Schmidt weight discarded by
    truncation during the run."""

    tensors: tuple
    num_qubits: int
    chi: int
    truncation_weight: float


# --------------------------------------------------------------------------
# Batched MPS with an orthogonality centre
# --------------------------------------------------------------------------


def _left_mul(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``g`` (d, d) shared or (B, d, d) per row on the middle index of
    ``t`` (B, l, d, r)."""
    return torch.matmul(g if g.dim() == 2 else g[:, None], t)


def flush_tiny(m: torch.Tensor) -> torch.Tensor:
    """Entries below eps^2 (1.4e-14 in float32, 4.9e-32 in float64) of
    their matrix's largest one set to 0 before a factorisation. They are
    rounding residue of earlier products (1e-18 next to O(1) entries in
    float32), below the precision of every sum they enter, and a column
    of them makes both MKL's complex64 Householder QR (PyTorch's CPU
    LAPACK) and cuBLAS's batched one on the card return NaN."""
    eps = torch.finfo(m.real.dtype).eps
    mag = m.abs()
    return m.masked_fill(
        mag < eps * eps * mag.amax(dim=(-2, -1), keepdim=True), 0)


def thin_svd(m: torch.Tensor, values_only: bool = False):
    """The thin SVD of ``m`` (..., rows, cols). On the card one matrix,
    or the correlator's pair, takes cuSOLVER's QR-iteration driver
    (``gesvd``): PyTorch's default there, Jacobi (``gesvdj``), leaves
    ``U^H U - I`` at 1e-5 to 1e-4 on normalised 8-128 wide matrices,
    which put the card's DMRG energy of the n = 64 TFIM chain 6.3e-5
    (relative) from the exact one against 7.4e-7 with ``gesvd``. A larger
    batch keeps the default: ``gesvd`` loops over the rows (0.9 ms a
    32 x 32 row), the batched Jacobi solver takes 1024 of them in
    2.4 ms."""
    kw = ({"driver": "gesvd"} if m.is_cuda and m[..., 0, 0].numel() <= 2
          else {})
    if values_only:
        return torch.linalg.svdvals(m, **kw)
    return torch.linalg.svd(m, full_matrices=False, **kw)


def _batched_svd_route(m: torch.Tensor) -> bool:
    """Whether a centre move of the (B, rows, cols) batch ``m`` takes the
    batched SVD: on the card, for a batch, up to ``BATCHED_SVD_MAX``."""
    return (m.is_cuda and m.shape[0] > 1
            and max(m.shape[-2:]) <= BATCHED_SVD_MAX)


def _finite_rows(*ts) -> torch.Tensor:
    """(B,) whether every entry of each batch row of ``ts`` is finite."""
    ok = None
    for t in ts:
        t = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
        row = torch.isfinite(t).flatten(1).all(1)
        ok = row if ok is None else ok & row
    return ok


def _isometry_split(m: torch.Tensor):
    """``m = q @ rest`` with ``q`` (B, rows, k) having orthonormal
    columns, k = min(rows, cols): the thin QR, or on a batch on the card
    up to ``BATCHED_SVD_MAX`` the thin SVD (``q = U``, ``rest = S V^H``).
    Both are exact factorisations and differ only in the gauge of the
    bond; the batched SVD is one solver call where the batched QR is one
    per row. A batched QR on the card that returns non-finite rows (its
    batched Householder step does, on rank-deficient rows of a noisy
    trajectory batch) is redone row by row."""
    m = flush_tiny(m)
    if _batched_svd_route(m):
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        return u, s[..., None].to(vh.dtype) * vh
    q, rest = torch.linalg.qr(m)
    if m.is_cuda and m.shape[0] > 1:
        for b in (~_finite_rows(q, rest)).nonzero().flatten().tolist():
            q[b], rest[b] = torch.linalg.qr(m[b])
    return q, rest


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel draws from uniforms in [0, 1): ``-log(-log(max(u, tiny)))``,
    the form of ``jax.random.gumbel`` (``mode="low"``)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


class _BatchMPS:
    """B MPS with one bond profile and one centre. Shape arithmetic (bond
    growth, centre position, routing) is host Python; every tensor
    operation is batched over the leading axis."""

    def __init__(self, tensors: list, chi: int):
        """Site tensors (B, l, 2, r) with the centre at site 0."""
        self.tensors = list(tensors)
        self.chi = chi
        self.center = 0
        t0 = self.tensors[0]
        self.discarded = torch.zeros(t0.shape[0], dtype=t0.dtype.to_real(),
                                     device=t0.device)
        self._swap = None

    @classmethod
    def product(cls, bits, chi: int, batch: int, device, dtype):
        """The computational basis state ``bits`` in every row."""
        n = len(bits)
        onehot = np.zeros((n, 2), np.complex64)
        onehot[np.arange(n), np.asarray(bits, dtype=np.int64)] = 1.0
        dev = torch.from_numpy(onehot).to(device=device, dtype=dtype)
        return cls([dev[i].reshape(1, 1, 2, 1).expand(batch, 1, 2, 1)
                    for i in range(n)], chi)

    # --- canonical-form maintenance ------------------------------------

    def _shift_right(self, i: int) -> None:
        """Centre i -> i+1 (site i becomes left-canonical)."""
        t = self.tensors[i]
        B, l, _, r = t.shape
        q, rm = _isometry_split(t.reshape(B, l * 2, r))
        k = q.shape[-1]
        self.tensors[i] = q.reshape(B, l, 2, k)
        nxt = self.tensors[i + 1]
        self.tensors[i + 1] = torch.matmul(
            rm, nxt.reshape(B, r, -1)).reshape(B, k, 2, nxt.shape[3])
        self.center = i + 1

    def _shift_left(self, i: int) -> None:
        """Centre i -> i-1 (site i becomes right-canonical): the split of
        ``M^H = Q R`` gives ``M = R^H Q^H`` (an LQ)."""
        t = self.tensors[i]
        B, l, _, r = t.shape
        q, rm = _isometry_split(t.reshape(B, l, 2 * r).mH)
        k = q.shape[-1]
        self.tensors[i] = q.mH.reshape(B, k, 2, r)
        prev = self.tensors[i - 1]
        self.tensors[i - 1] = torch.matmul(
            prev.reshape(B, -1, l), rm.mH).reshape(B, prev.shape[1], 2, k)
        self.center = i - 1

    def move_center_to(self, j: int) -> None:
        while self.center < j:
            self._shift_right(self.center)
        while self.center > j:
            self._shift_left(self.center)

    # --- gate application -----------------------------------------------

    def apply_1q(self, site: int, g: torch.Tensor) -> None:
        """A one-site unitary commutes with the canonical form."""
        self.tensors[site] = _left_mul(g, self.tensors[site])

    def _truncated_split(self, m: torch.Tensor, l: int, r: int):
        """SVD-split (B, l*2, 2*r) matrices at the centre bond, keep at
        most ``chi`` Schmidt vectors, renormalise, ledger the rest."""
        u, s, vh = thin_svd(flush_tiny(m))
        k = min(m.shape[1], m.shape[2], self.chi)
        w_all = (s * s).sum(-1)
        sk = s[:, :k]
        w_kept = (sk * sk).sum(-1)
        self.discarded = self.discarded + (w_all - w_kept).clamp_min(0.0)
        sk = sk / w_kept.clamp_min(1e-30).sqrt()[:, None]
        B = m.shape[0]
        left = u[:, :, :k].reshape(B, l, 2, k)
        right = (sk[:, :, None].to(m.dtype) * vh[:, :k, :]).reshape(
            B, k, 2, r)
        return left, right

    def apply_2site(self, i: int, g4: torch.Tensor) -> None:
        """A 4x4 gate (shared or per row) on adjacent sites (i, i+1); the
        centre ends on i+1. ``g4``'s MSB is site i."""
        self.move_center_to(i if self.center <= i else i + 1)
        a, b = self.tensors[i], self.tensors[i + 1]
        B, l, _, m = a.shape
        r = b.shape[3]
        theta = torch.matmul(a.reshape(B, l * 2, m),
                             b.reshape(B, m, 2 * r)).reshape(B, l, 4, r)
        theta = _left_mul(g4, theta)
        left, right = self._truncated_split(
            theta.reshape(B, l * 2, 2 * r), l, r)
        self.tensors[i] = left
        self.tensors[i + 1] = right
        self.center = i + 1

    def apply_ksite(self, start: int, k: int, g: torch.Tensor) -> None:
        """A 2^k x 2^k gate on the contiguous sites start..start+k-1 (MSB
        = leftmost), split back with k-1 truncated SVDs; the centre ends
        on the rightmost site."""
        if k == 1:
            self.apply_1q(start, g)
            return
        if k == 2:
            self.apply_2site(start, g)
            return
        self.move_center_to(start)
        theta = self.tensors[start]                       # (B, l, 2, r0)
        B, l = theta.shape[0], theta.shape[1]
        for j in range(1, k):
            nxt = self.tensors[start + j]
            theta = torch.matmul(theta.reshape(B, -1, nxt.shape[1]),
                                 nxt.reshape(B, nxt.shape[1], -1))
            theta = theta.reshape(B, l, -1, nxt.shape[3])
        r = theta.shape[3]
        theta = _left_mul(g, theta)
        # Peel sites off the left one truncated SVD at a time.
        for j in range(k - 1):
            rem = 2 ** (k - j - 1)  # physical dims right of site start+j
            left, carry = self._truncated_split(
                theta.reshape(B, l * 2, rem * r), l, (rem * r) // 2)
            kk = left.shape[3]
            self.tensors[start + j] = left
            theta = carry.reshape(B, kk, rem, r)
            l = kk
        self.tensors[start + k - 1] = theta
        self.center = start + k - 1

    def apply_kraus_1q(self, site: int, kstack: torch.Tensor,
                       gumbel: torch.Tensor) -> torch.Tensor:
        """One stochastic one-qubit Kraus draw per row: with the centre on
        ``site``, each branch weight ``||K_m psi||^2`` is the norm of
        ``K_m`` applied to the centre tensor alone. The drawn branch
        (``argmax(log w + gumbel)``, ``gumbel`` (B, M)) applies in place
        and renormalises. Returns the (B,) branch indices (for projector
        stacks, the measurement outcomes)."""
        self.move_center_to(site)
        t = self.tensors[site]
        B = t.shape[0]
        branches = torch.matmul(kstack[None, :, None], t[:, None])
        w = branches.abs().square().sum((2, 3, 4))
        m = torch.argmax(torch.log(w.clamp_min(1e-30)) + gumbel, dim=1)
        chosen = branches[torch.arange(B, device=t.device), m]
        norm = chosen.abs().square().sum((1, 2, 3)).clamp_min(1e-30).sqrt()
        self.tensors[site] = chosen / norm[:, None, None, None].to(
            chosen.dtype)
        return m

    def swap_adjacent(self, i: int) -> None:
        if self._swap is None:
            t = self.tensors[0]
            self._swap = torch.from_numpy(_SWAP_4X4).to(t.device, t.dtype)
        self.apply_2site(i, self._swap)

    def route_and_apply(self, positions, g: torch.Tensor) -> None:
        """A dense k-site gate on arbitrary distinct positions: permute
        the gate into sorted-position order, bubble the targets into one
        contiguous block with adjacent SWAPs (order preserved), apply,
        un-route."""
        kq = len(positions)
        order = sorted(range(kq), key=lambda t: positions[t])
        if order != list(range(kq)):
            lead = tuple(g.shape[:-2])
            gt = g.reshape(lead + (2,) * (2 * kq))
            perm = tuple(order) + tuple(kq + t for t in order)
            nl = len(lead)
            g = gt.permute(tuple(range(nl)) + tuple(nl + p for p in perm)
                           ).reshape(lead + (2 ** kq, 2 ** kq))
        pos = sorted(positions)
        swaps = []
        for idx in range(kq - 2, -1, -1):
            while pos[idx] < pos[idx + 1] - 1:
                swaps.append(pos[idx])
                self.swap_adjacent(pos[idx])
                pos[idx] += 1
        self.apply_ksite(pos[0], kq, g)
        for site in reversed(swaps):
            self.swap_adjacent(site)

    def apply(self, positions, g: torch.Tensor) -> None:
        """A gate matrix on ``positions``: one-site in place, else routed."""
        if len(positions) == 1:
            self.apply_1q(positions[0], g)
        else:
            self.route_and_apply(list(positions), g)

    def row(self, b: int) -> tuple:
        """Row ``b``'s site tensors, each (l, 2, r)."""
        return tuple(t[b] for t in self.tensors)


# --------------------------------------------------------------------------
# Circuit lowering
# --------------------------------------------------------------------------


def draw_branches(circuit: QuantumCircuit, noise_model=None,
                  collapse_measures: bool = False) -> list[int]:
    """Branch counts of a trajectory's draws, in the order ``_evolve``
    takes them: one per (channel, target) after each gate and one (2)
    per collapsing ``Measure``. The JAX package splits one key per draw
    (``jax.random.split(key, len(...))``; its ``_count_noise_sites``
    counts the first kind)."""
    registry = GateRegistry.instance()
    out = []
    for column in circuit.get_ordered_gates():
        for gate in column:
            gdef = registry.get(gate.gate_name)
            if gdef.gate_type == GateType.MEASUREMENT:
                if collapse_measures:
                    out.append(2)
                continue
            if gdef.gate_type == GateType.BARRIER or noise_model is None:
                continue
            for ch in noise_model.channels_for_gate(gate.gate_name):
                out.extend([len(ch.kraus_stack())] * len(gate.target_qubits))
    return out


def draw_gumbels(n_rows: int, branches: list[int], gen: torch.Generator,
                 device) -> torch.Tensor:
    """(n_rows, len(branches), max branches) float32 Gumbel draws."""
    width = max(branches, default=1)
    u = torch.rand((n_rows, len(branches), width), generator=gen,
                   device=device)
    return gumbel_from_uniform(u)


class _Matrices:
    """Host gate matrices moved to the device once per width."""

    def __init__(self):
        self._host: dict[int, list] = {}
        self._dev: dict[int, torch.Tensor] = {}

    def add(self, mat: np.ndarray) -> tuple:
        rows = self._host.setdefault(mat.shape[0], [])
        rows.append(mat)
        return (mat.shape[0], len(rows) - 1)

    def to(self, device, dtype) -> None:
        self._dev = {d: torch.from_numpy(np.stack(m)).to(device=device,
                                                         dtype=dtype)
                     for d, m in self._host.items()}

    def __getitem__(self, key) -> torch.Tensor:
        return self._dev[key[0]][key[1]]


def _lower(circuit: QuantumCircuit, noise_model, collapse_measures: bool,
           param_overrides: dict | None):
    """Host walk of the circuit: (ops, matrices, measure_sites). Ops are
    ``("gate", targets, key or per-row tensor)``, ``("kraus", qubit,
    stack key)`` and ``("measure", qubit)``."""
    registry = GateRegistry.instance()
    mats = _Matrices()
    ops = []
    measure_sites = []
    kraus_keys: dict = {}
    for column in circuit.get_ordered_gates():
        for gate in column:
            gdef = registry.get(gate.gate_name)
            if gdef.gate_type == GateType.MEASUREMENT:
                if collapse_measures:
                    measure_sites.append((gate.column,
                                          gate.target_qubits[0]))
                    ops.append(("measure", gate.target_qubits[0]))
                continue
            if gdef.gate_type == GateType.BARRIER:
                continue
            kq = len(gate.target_qubits)
            if kq > _MAX_DENSE_SITES:
                raise ValueError(
                    f"{gate.gate_name} touches {kq} qubits; the MPS "
                    f"engine's dense-gate path stops at "
                    f"{_MAX_DENSE_SITES} (use the statevector engine "
                    f"or decompose the gate)")
            if kq > 1 and len(set(gate.target_qubits)) != kq:
                raise ValueError(
                    f"duplicate target qubits in {gate.gate_name}: "
                    f"{gate.target_qubits}")
            override = (param_overrides or {}).get(id(gate))
            if override is not None:
                g = gdef.torch_matrix_func(*override)
            else:
                g = mats.add(np.asarray(gdef.matrix_func(*gate.params),
                                        dtype=np.complex128))
            ops.append(("gate", list(gate.target_qubits), g))
            if noise_model is None:
                continue
            for ch in noise_model.channels_for_gate(gate.gate_name):
                ks = ch.kraus_stack()
                if ks.shape[1:] != (2, 2):
                    raise ValueError(
                        f"{type(ch).__name__} is not a 1-qubit "
                        "channel; the MPS engine applies Kraus "
                        "noise per target qubit")
                key = ch.spec_key()
                if key not in kraus_keys:
                    kraus_keys[key] = len(kraus_keys)
                for q in gate.target_qubits:
                    ops.append(("kraus", q, kraus_keys[key], ks))
    return ops, mats, measure_sites


def _evolve(circuit: QuantumCircuit, chi: int, batch: int, device,
            dtype=None, noise_model=None, gumbels=None,
            collapse_measures: bool = False, param_overrides=None):
    """Evolve ``batch`` rows of the circuit: -> (``_BatchMPS`` with the
    centre at site 0, (batch, M) int32 collapse outcomes in Measure
    order, measure sites). With a noise model each row is one stochastic
    Kraus trajectory; with ``collapse_measures`` Measure gates project
    mid-circuit through the same draw machinery. ``gumbels``
    (batch, draws, width) feeds draw i from row ``[:, i, :M_i]``
    (``draw_branches``). ``param_overrides`` maps ``id(gate)`` to a
    params list whose entries may be (batch,) tensors (the variational
    rows)."""
    dtype = dtype or CONFIG.dtype
    ops, mats, measure_sites = _lower(circuit, noise_model,
                                      collapse_measures, param_overrides)
    mats.to(device, dtype)
    mps = _BatchMPS.product(circuit.initial_states, chi, batch, device,
                            dtype)
    kstacks: dict = {}
    proj = None
    draw = 0
    outcomes = []
    for op in ops:
        if op[0] == "gate":
            g = op[2]
            g = mats[g] if isinstance(g, tuple) else g.to(device, dtype)
            mps.apply(op[1], g)
        elif op[0] == "kraus":
            ks = kstacks.get(op[2])
            if ks is None:
                ks = kstacks[op[2]] = torch.from_numpy(op[3]).to(device,
                                                                 dtype)
            mps.apply_kraus_1q(op[1], ks, gumbels[:, draw, :ks.shape[0]])
            draw += 1
        else:
            if proj is None:
                proj = torch.from_numpy(_PROJECTORS).to(device, dtype)
            outcomes.append(mps.apply_kraus_1q(op[1], proj,
                                               gumbels[:, draw, :2]))
            draw += 1
    mps.move_center_to(0)
    outs = (torch.stack(outcomes, dim=1).to(torch.int32) if outcomes
            else torch.zeros((batch, 0), dtype=torch.int32, device=device))
    return mps, outs, measure_sites


def rows_per_batch(n: int, chi: int, dtype=None) -> int:
    """Rows of a batched evolution whose site tensors fit
    ``MPS_BATCH_BYTES`` at full bond dimension."""
    itemsize = torch.empty((), dtype=dtype or CONFIG.dtype).element_size()
    per_row = n * 2 * chi * chi * itemsize
    return max(1, MPS_BATCH_BYTES // per_row)


# --------------------------------------------------------------------------
# Sampling / observables on a finished MPS
# --------------------------------------------------------------------------


def sample_cascade(tensors, uniforms: torch.Tensor,
                   rotations: torch.Tensor | None = None) -> torch.Tensor:
    """The conditional cascade over right-canonical site tensors (centre
    at site 0): ``tensors`` are (l, 2, r) shared by every shot or
    (S, l, 2, r) one per shot; ``uniforms`` (S, n) float32, one per shot
    and site (bit = u >= P(0 | earlier bits), compared in the tensors'
    precision); ``rotations`` optionally
    (S, n, 2, 2), a one-qubit rotation per shot and site before its
    readout (the shadows' bases). -> (S, n) uint8 bits."""
    S, n = uniforms.shape
    t0 = tensors[0]
    dtype, device = t0.dtype, t0.device
    v = torch.zeros((S, 1), dtype=dtype, device=device)
    v[:, 0] = 1.0
    bits = []
    for i, t in enumerate(tensors):
        if t.dim() == 3:
            y = torch.einsum("sl,lpr->spr", v, t)
        else:
            y = torch.einsum("sl,slpr->spr", v, t)
        if rotations is not None:
            y = torch.matmul(rotations[:, i], y)
        w0, w1 = y[:, 0], y[:, 1]
        p0 = w0.abs().square().sum(-1)
        p1 = w1.abs().square().sum(-1)
        pr0 = p0 / (p0 + p1).clamp_min(1e-30)
        bit = uniforms[:, i] >= pr0
        w = torch.where(bit[:, None], w1, w0)
        v = w / w.abs().square().sum(-1, keepdim=True).clamp_min(
            1e-30).sqrt().to(dtype)
        bits.append(bit)
    return torch.stack(bits, dim=1).to(torch.uint8)


def _counts(bits: np.ndarray) -> dict:
    uniq, cnts = np.unique(bits.astype(np.uint8), axis=0,
                           return_counts=True)
    return {"".join("1" if b else "0" for b in row): int(c)
            for row, c in zip(uniq, cnts)}


def _transfer(env: torch.Tensor, bra: torch.Tensor,
              ket: torch.Tensor) -> torch.Tensor:
    """One site of a transfer contraction: ``env[..., l, m]`` with
    ``conj(bra[..., l, p, a])`` and ``ket[..., m, p, b]`` ->
    ``[..., a, b]``."""
    x = torch.einsum("...lm,...mpb->...lpb", env, ket)
    return torch.einsum("...lpa,...lpb->...ab", bra.conj(), x)


def _parse_ops(n: int, paulis) -> dict:
    if isinstance(paulis, str):
        if len(paulis) != n:
            raise ValueError(f"Pauli string length {len(paulis)} != n={n}")
        ops = {q: p for q, p in enumerate(paulis.upper()) if p != "I"}
    else:
        ops = {int(q): str(p).upper() for q, p in paulis.items()}
    for q, p in ops.items():
        if q < 0 or q >= n:
            raise ValueError(f"qubit {q} out of range for n={n}")
        if p not in ("X", "Y", "Z"):
            raise ValueError(f"unsupported Pauli {p!r}")
    return ops


def _pauli_ops(ops: dict, like: torch.Tensor) -> dict:
    """{site: Pauli letter} -> {site: (2, 2) tensor} on ``like``'s device."""
    return {q: _device_const(_PAULI_2X2[p], like) for q, p in ops.items()}


def _device_const(mat: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A complex128 host constant in ``like``'s dtype on its device."""
    return torch.from_numpy(mat).to(like.device, like.dtype)


def expectation_pauli_string(state: MPSState, paulis: dict | str) -> float:
    """<P> for a Pauli string via one left-to-right transfer contraction,
    O(n chi^3). ``paulis`` is a length-n string over IXYZ or a
    {qubit: 'X'|'Y'|'Z'} dict (identity elsewhere)."""
    n = state.num_qubits
    ops = _pauli_ops(_parse_ops(n, paulis), state.tensors[0])
    t0 = state.tensors[0]
    env = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
    norm = env
    for i, t in enumerate(state.tensors):
        env = _transfer(env, t, t if i not in ops else ops[i] @ t)
        norm = _transfer(norm, t, t)
    return float(env[0, 0].real / norm[0, 0].real)


def _parse_terms(n: int, terms):
    """Validate ``(coeff, pauli_string, qubits)`` Hamiltonian terms into
    ``(coeff, {site: pauli}, min_site, max_site)`` tuples; identity-only
    terms parse to an empty ops dict (an energy offset)."""
    parsed = []
    for coeff, pstr, qubits in terms:
        if len(pstr) != len(qubits):
            raise ValueError(f"term {pstr!r} has {len(pstr)} Paulis for "
                             f"{len(qubits)} qubits")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"duplicate qubits in term {pstr!r}: {qubits}")
        ops = {}
        for q, p in zip(qubits, pstr.upper()):
            if q < 0 or q >= n:
                raise ValueError(f"qubit {q} out of range for n={n}")
            if p == "I":
                continue
            if p not in ("X", "Y", "Z"):
                raise ValueError(f"unsupported Pauli {p!r} in {pstr!r}")
            ops[int(q)] = p
        if ops:
            parsed.append((float(coeff), ops, min(ops), max(ops)))
        else:
            parsed.append((float(coeff), ops, 0, -1))
    return parsed


def _hamiltonian_energy(tensors, parsed, n: int) -> torch.Tensor:
    """<H>/<1> over tensors (l, 2, r) or (B, l, 2, r) whose centre is at
    site 0: everything right of it is right-canonical, so every term's
    right environment is the identity. One shared sweep of left
    environments, then O(support) transfers per term. -> the tensors'
    real dtype, of the batch shape."""
    t0 = tensors[0]
    lead = tuple(t0.shape[:-3])
    real = t0.dtype.to_real()
    scalar = np.float64 if real == torch.float64 else np.float32
    left = [torch.ones(lead + (1, 1), dtype=t0.dtype, device=t0.device)]
    for t in tensors:
        left.append(_transfer(left[-1], t, t))
    norm2 = left[n][..., 0, 0].real
    paulis = {p: _device_const(m, t0) for p, m in _PAULI_2X2.items()}
    total = torch.zeros(lead, dtype=real, device=t0.device)
    for coeff, ops, a, b in parsed:
        if not ops:
            total = total + scalar(coeff) * norm2
            continue
        env = left[a]
        for i in range(a, b + 1):
            t = tensors[i]
            env = _transfer(env, t, t if i not in ops
                            else paulis[ops[i]] @ t)
        trace = torch.diagonal(env, dim1=-2, dim2=-1).sum(-1).real
        total = total + scalar(coeff) * trace
    return total / norm2


def expectation_hamiltonian(state: MPSState, terms) -> float:
    """<H> for ``H = sum_k coeff_k * P_k`` in the ``models.hamiltonians``
    term format ``(coeff, pauli_string, qubits)``."""
    parsed = _parse_terms(state.num_qubits, terms)
    return float(_hamiltonian_energy(state.tensors, parsed,
                                     state.num_qubits))


# --------------------------------------------------------------------------
# Variational path: circuit with free parameters -> energy, batched
# --------------------------------------------------------------------------


def build_batched_cost_fn(circuit: QuantumCircuit, bindings, terms,
                          chi: int, constant: float = 0.0, device=None):
    """``f(values[B, P]) -> energies[B]`` (a ``CONFIG.real_dtype`` tensor,
    read when ``f`` is called): the
    MPS-evolved circuit's ``<H> + constant`` at every parameter row, the
    rows one batch (cut by ``rows_per_batch``), each bound gate's
    matrices built per row by its ``torch_matrix_func``.

    ``bindings`` are ``optimizer.ParameterBinding``-shaped objects
    (``gate_index`` / ``param_index``). Gradients pair this with the
    parameter-shift rule: reverse mode through the truncated-SVD splits
    is numerically unsafe (the SVD's derivative divides by
    ``s_i^2 - s_j^2``, and product-state starts make degenerate or zero
    Schmidt values the common case), so the optimizer refuses it."""
    registry = GateRegistry.instance()
    n = circuit.num_qubits
    device = device or CONFIG.device
    parsed = _parse_terms(n, terms)
    per_gate: dict[int, list] = {}
    for vi, b in enumerate(bindings):
        gate = circuit.gates[b.gate_index]
        gdef = registry.get(gate.gate_name)
        if gdef.torch_matrix_func is None:
            raise ValueError(
                f"{gate.gate_name} has no batched matrix builder; the "
                "MPS variational path needs torch_matrix_func on every "
                "bound gate (same contract as gradient_method='autodiff')")
        if not 0 <= b.param_index < len(gate.params):
            raise ValueError(
                f"binding {vi} indexes param {b.param_index} of "
                f"{gate.gate_name} which has {len(gate.params)}")
        per_gate.setdefault(b.gate_index, []).append((b.param_index, vi))

    def fn(values) -> torch.Tensor:
        values = torch.as_tensor(np.asarray(values, dtype=CONFIG.np_real)
                                 if not isinstance(values, torch.Tensor)
                                 else values, device=device)
        if CONFIG.dtype == torch.complex128:
            values = values.double()
        scalar = CONFIG.np_real
        rows = rows_per_batch(n, chi)
        out = []
        for lo in range(0, values.shape[0], rows):
            vals = values[lo:lo + rows]
            overrides = {}
            for gi, slots in per_gate.items():
                gate = circuit.gates[gi]
                params = [torch.tensor(float(p), dtype=CONFIG.real_dtype,
                                       device=vals.device)
                          for p in gate.params]
                for pi, vi in slots:
                    params[pi] = vals[:, vi]
                overrides[id(gate)] = params
            mps, _, _ = _evolve(circuit, chi, vals.shape[0], device,
                                param_overrides=overrides)
            out.append(_hamiltonian_energy(mps.tensors, parsed, n)
                       + scalar(constant))
        return torch.cat(out)

    return fn


def overlap(a: MPSState, b: MPSState) -> complex:
    """``<a|b>`` via one transfer contraction, any pair of bond profiles."""
    if a.num_qubits != b.num_qubits:
        raise ValueError("overlap needs equal qubit counts")
    t0 = a.tensors[0]
    env = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
    for x, y in zip(a.tensors, b.tensors):
        env = _transfer(env, x, y)
    return complex(env[0, 0].item())


def amplitude(state: MPSState, bits) -> complex:
    """Amplitude of one computational basis state (qubit 0 = MSB)."""
    if isinstance(bits, str):
        bits = [int(b) for b in bits]
    if len(bits) != state.num_qubits:
        raise ValueError("bitstring length != num_qubits")
    t0 = state.tensors[0]
    v = torch.ones((1, 1), dtype=t0.dtype, device=t0.device)
    for i, t in enumerate(state.tensors):
        v = torch.matmul(v, t[:, int(bits[i]), :])
    return complex(v[0, 0].item())


def to_statevector(state: MPSState) -> np.ndarray:
    """Contract the MPS to a dense 2^n vector (n <= 20), complex128."""
    n = state.num_qubits
    if n > 20:
        raise ValueError(f"to_statevector caps at n=20, got n={n}")
    psi = state.tensors[0].reshape(2, -1)
    for t in state.tensors[1:]:
        psi = torch.matmul(psi, t.reshape(t.shape[0], -1)).reshape(
            psi.shape[0] * 2, -1)
    return psi[:, 0].cpu().numpy().astype(np.complex128)


def entanglement_entropy(state: MPSState, bond: int) -> float:
    """Von Neumann entropy (bits) across the cut between sites ``bond``
    and ``bond+1``, from the Schmidt spectrum at that bond."""
    n = state.num_qubits
    if bond < 0 or bond >= n - 1:
        raise ValueError(f"bond must be in [0, {n - 2}], got {bond}")
    mps = _BatchMPS([t[None] for t in state.tensors],
                    max(t.shape[2] for t in state.tensors))
    mps.move_center_to(bond)
    t = mps.tensors[bond][0]
    l, _, r = t.shape
    s = thin_svd(t.reshape(l * 2, r), values_only=True)
    p = s * s
    p = p / p.sum()
    return float(-torch.where(p > 1e-12, p * torch.log2(p),
                              torch.zeros_like(p)).sum())


def basis_rotated(tensors, basis: str) -> list:
    """Site tensors rotated for an X (H) or Y (H S-dagger) readout: a
    one-site unitary on every site, which keeps the canonical form."""
    rot = _H_2X2 if basis == "X" else _H_2X2 @ _SDG_2X2
    r = _device_const(rot, tensors[0])
    return [r @ t for t in tensors]


# --------------------------------------------------------------------------
# Simulator facade
# --------------------------------------------------------------------------


class MPSSimulator:
    """Run arbitrary-gate circuits as a bond-dimension-``chi`` MPS on
    ``device`` (default ``CONFIG.device``).

    The sampling surface of ``Simulator.run`` / ``CliffordSimulator.run``:
    counts keyed by MSB-first bitstrings. ``truncation_weight`` on the
    returned state is the squared Schmidt weight the run discarded (0.0 ==
    exact). The stochastic entry points draw from a ``torch.Generator``
    seeded from ``seed``, or take their draws: ``uniforms=`` (S, n) for
    the cascade, ``gumbels=`` (T, draws, width) for Kraus and projector
    draws (``draw_branches``)."""

    def __init__(self, chi: int = 64, device=None):
        if chi < 1:
            raise ValueError("chi must be >= 1")
        self.chi = chi
        self.device = device or CONFIG.device

    def _final_state(self, circuit: QuantumCircuit,
                     chi: int | None) -> MPSState:
        chi = self.chi if chi is None else chi
        mps, _, _ = _evolve(circuit, chi, 1, self.device)
        return MPSState(mps.row(0), circuit.num_qubits, chi,
                        float(mps.discarded[0]))

    def run(self, circuit: QuantumCircuit, shots: int = 1000,
            seed: int | None = None, chi: int | None = None,
            basis: str = "Z", readout_error=None, uniforms=None):
        """-> (counts, MPSState).

        ``basis`` "X" rotates every site by H, "Y" by H S-dagger, before
        the cascade (one-site unitaries commute with the canonical form).
        ``readout_error`` applies shot-mode corruption (per-bit confusion
        draws from the NumPy stream of ``seed``)."""
        basis = str(getattr(basis, "value", basis)).upper()
        if basis not in ("Z", "X", "Y"):
            raise ValueError(f"unsupported basis {basis!r}")
        state = self._final_state(circuit, chi)
        counts: dict[str, int] = {}
        if shots > 0:
            rng = np.random.default_rng(seed)
            gen = generator_from_rng(rng, self.device)
            tensors = state.tensors
            if basis != "Z":
                tensors = basis_rotated(tensors, basis)
            if uniforms is None:
                uniforms = torch.rand((shots, circuit.num_qubits),
                                      generator=gen, device=self.device)
            bits = sample_cascade(tensors, torch.as_tensor(
                uniforms, dtype=torch.float32, device=self.device))
            counts = _counts(bits.cpu().numpy())
            if readout_error is not None:
                counts = readout_error.corrupt_counts(counts, rng)
        return counts, state

    def monitored_trajectories(self, circuit: QuantumCircuit,
                               n_trajectories: int = 16,
                               seed: int | None = None,
                               chi: int | None = None,
                               noise_model=None, gumbels=None):
        """T independent monitored trajectories as one batch: Measure
        gates collapse mid-circuit through projector draws (optionally
        interleaved with stochastic noise).

        -> (outcomes[T, M] int array in Measure column order,
            sites [(column, qubit)] * M,
            states: list of T final ``MPSState``s)."""
        chi = self.chi if chi is None else chi
        branches = draw_branches(circuit, noise_model, True)
        if gumbels is None:
            gen = generator_from_rng(np.random.default_rng(seed),
                                     self.device)
            gumbels = draw_gumbels(n_trajectories, branches, gen,
                                   self.device)
        gumbels = torch.as_tensor(gumbels, dtype=torch.float32,
                                  device=self.device)
        outs, states, sites = [], [], []
        rows = rows_per_batch(circuit.num_qubits, chi)
        for lo in range(0, n_trajectories, rows):
            g = gumbels[lo:lo + rows]
            mps, o, sites = _evolve(circuit, chi, g.shape[0], self.device,
                                    noise_model=noise_model, gumbels=g,
                                    collapse_measures=True)
            disc = mps.discarded.cpu().numpy()
            outs.append(o.cpu().numpy())
            states += [MPSState(mps.row(b), circuit.num_qubits, chi,
                                float(disc[b])) for b in range(g.shape[0])]
        return np.concatenate(outs), list(sites), states

    def run_with_noise(self, circuit: QuantumCircuit, noise_model,
                       shots: int = 1000, seed: int | None = None,
                       chi: int | None = None, gumbels=None,
                       uniforms=None):
        """Noisy counts at MPS scale: one stochastic Kraus trajectory per
        shot, evolved as one batch (cut by ``rows_per_batch``), each
        sampled by its own cascade. All four reference channels, amplitude
        damping included.

        -> (counts, mean discarded squared Schmidt weight per trajectory;
        0.0 means every trajectory was exact at this chi). Readout error
        (shot mode) applies if configured."""
        chi = self.chi if chi is None else chi
        n = circuit.num_qubits
        rng = np.random.default_rng(seed)
        gen = generator_from_rng(rng, self.device)
        branches = draw_branches(circuit, noise_model)
        if gumbels is None:
            gumbels = draw_gumbels(shots, branches, gen, self.device)
        if uniforms is None:
            uniforms = torch.rand((shots, n), generator=gen,
                                  device=self.device)
        gumbels = torch.as_tensor(gumbels, dtype=torch.float32,
                                  device=self.device)
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32,
                                   device=self.device)
        bits, disc = [], []
        rows = rows_per_batch(n, chi)
        for lo in range(0, shots, rows):
            hi = min(lo + rows, shots)
            mps, _, _ = _evolve(circuit, chi, hi - lo, self.device,
                                noise_model=noise_model,
                                gumbels=gumbels[lo:hi])
            bits.append(sample_cascade(mps.tensors, uniforms[lo:hi]))
            disc.append(mps.discarded)
        counts = _counts(torch.cat(bits).cpu().numpy())
        ro = getattr(noise_model, "readout_error", None)
        if ro is not None:
            counts = ro.corrupt_counts(counts, rng)
        return counts, float(torch.cat(disc).mean())

    # Observable surface re-exported on the class for discoverability.
    expectation_pauli_string = staticmethod(expectation_pauli_string)
    expectation_hamiltonian = staticmethod(expectation_hamiltonian)
    overlap = staticmethod(overlap)
    amplitude = staticmethod(amplitude)
    to_statevector = staticmethod(to_statevector)
    entanglement_entropy = staticmethod(entanglement_entropy)
