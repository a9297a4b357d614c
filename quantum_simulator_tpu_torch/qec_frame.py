"""Pauli-frame QEC engine: threshold sweeps as GF(2) bit algebra.

Counterpart of ``quantum_simulator_tpu/qec_frame.py``. For the workloads
a threshold sweep runs (stabilizer codewords, stochastic Pauli noise,
parity-check syndromes, Pauli corrections) the whole cycle is binary
linear algebra on the error bits: a trial is a row of X / Z error bits, a
syndrome a parity-check product, a decode a table gather (or a cumsum for
repetition codes), and a sweep over millions of trials one batch on the
device with no 2^n state.

Exactness contract (held by ``tests/test_torch_qec.py``):
``FrameQECSimulator.threshold_sweep`` consumes the same per-trial float32
rows ``(T, dq)`` as ``qec.QECSimulator.threshold_sweep`` (one
``generator_from_rng(rng, device)`` stream per p, identical X / Z
thresholds), so under one seed the two engines give identical per-trial
success flags and Z_L signs. Every entry point also takes the draws as an
argument, so JAX's own draws (its key schedule) can be fed in: the
per-trial results are then JAX's.

Why the 0/1 reduction is exact: the sweep's ideal states are
logical-basis stabilizer states, so the corrected state is
``X^rx Z^rz |ideal>`` for residual bits ``rx = ex ^ cx``, ``rz = ez ^
cz``, and ``|<ideal| X^rx Z^rz |ideal>|^2`` is 1 when the residual
stabilizes the ideal state (zero syndrome, trivial logical action on the
readout component) and 0 otherwise.

Parity products are 0/1 float32 products with TF32 off (``config.py``),
exact below 2^24. R-round memories run per-round decoding
(``build_memory_fn``), exact space-time maximum likelihood through the
Walsh-Hadamard transform (``build_ml_memory_fn``,
``build_ml_css_memory_fn``; float32 posteriors, so an ML decision may
differ from JAX's on a near-tie), or union-find matching on the
space-time graph (``build_matching_memory_fn``, host C). ``mesh=`` (a
``parallel.ShardMesh``) splits a batch's trials over the mesh's ranks,
each running its contiguous block, and gathers the per-trial results: on
the same draws a mesh run's results are those of one device, whatever
the decoder (a host decoder included: each rank calls the same sweep on
its block).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .config import CONFIG
from .qec import (QECCode, ThresholdPoint, _coset_leader_lut, _error_bits,
                  _rotated_surface_geometry, trial_uniforms)
from .qec_matching import (MatchingGraph, decode_batch,
                           space_time_decode_fn, union_find_decode_fn,
                           union_find_host_decode_fn)


def _on_mesh(mesh, fn, *inputs):
    """``fn(*inputs)``, split over the trials (dim 0) of a mesh's ranks
    when ``mesh`` is given (``ShardMesh.map_trials``)."""
    if mesh is None:
        return fn(*inputs)
    from .parallel.distributed import check_mesh
    return check_mesh(mesh).map_trials(fn, *inputs)


# ---------------------------------------------------------------------------
# Frame spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrameSpec:
    """Static GF(2) structure of a code, as consumed by the sweep.

    ``comp_checks`` rows are parity checks over the X-error bits (the
    computational-frame syndrome); ``h_checks`` rows are parity checks
    over the Z-error bits (the H-rotated-frame syndrome).
    ``logical_support`` is the logical readout operator's support;
    ``logical_in_h_frame`` selects which residual component flips it.

    ``decode`` is a batched decoder on tensors:
    ``(syn_comp[T, nc], syn_h[T, nh]) -> (x_corr[T, dq], z_corr[T, dq])``
    int32 0/1 on the syndromes' device. ``host_decode`` (optional) is the
    same contract as a NumPy function (the union-find specs).
    """

    name: str
    data_qubits: int
    comp_checks: np.ndarray          # (nc, dq) uint8
    h_checks: np.ndarray             # (nh, dq) uint8
    logical_support: np.ndarray      # (dq,) uint8
    logical_in_h_frame: bool
    decode: Callable = field(compare=False)
    host_decode: Callable | None = field(default=None, compare=False)

    def __post_init__(self):
        dq = self.data_qubits
        for mat, label in ((self.comp_checks, "comp_checks"),
                           (self.h_checks, "h_checks")):
            if mat.ndim != 2 or mat.shape[1] != dq:
                raise ValueError(f"{label} must be (n_checks, {dq}), "
                                 f"got {mat.shape}")
        if self.logical_support.shape != (dq,):
            raise ValueError("logical_support must be shape "
                             f"({dq},), got {self.logical_support.shape}")


def _checks_matrix(checks: list[list[int]], dq: int) -> np.ndarray:
    mat = np.zeros((len(checks), dq), dtype=np.uint8)
    for i, qubits in enumerate(checks):
        for q in qubits:
            if q >= dq:
                raise ValueError(f"check {qubits} touches non-data qubit {q}")
            mat[i, q] = 1
    return mat


def _table_decoder(lut_x: np.ndarray, lut_z: np.ndarray, pow_c: np.ndarray,
                   pow_h: np.ndarray, joint: bool):
    """Lookup-table decode (tables kept per device): ``idx_c = syn_comp @
    pow_c`` indexes ``lut_x`` and ``idx_h = syn_h @ pow_h`` ``lut_z``, or
    with ``joint`` their sum indexes both."""
    tables: dict = {}

    def decode(syn_comp, syn_h):
        dev = syn_comp.device
        if dev not in tables:
            tables[dev] = tuple(torch.from_numpy(np.asarray(a)).to(dev)
                                for a in (lut_x, lut_z, pow_c, pow_h))
        tx, tz, pc, ph = tables[dev]
        idx_c = (syn_comp.long() * pc).sum(-1)
        idx_h = (syn_h.long() * ph).sum(-1)
        if joint:
            idx_c = idx_h = idx_c + idx_h
        return tx[idx_c], tz[idx_h]

    return decode


def frame_spec_from_code(code: QECCode) -> FrameSpec:
    """Lift a statevector ``QECCode`` into a frame spec; the decoder is a
    lookup table built by enumerating every syndrome through the code's
    own ``decode_syndrome``, so frame decodes agree with statevector
    decodes by construction."""
    dq = code.data_qubits
    comp = _checks_matrix(code.comp_frame_checks(), dq)
    h = _checks_matrix(code.h_frame_checks(), dq)
    nc, nh = comp.shape[0], h.shape[0]
    n_syn = nc + nh
    lut_x = np.zeros((2 ** n_syn, dq), dtype=np.int32)
    lut_z = np.zeros((2 ** n_syn, dq), dtype=np.int32)
    for s in range(2 ** n_syn):
        bits = [(s >> i) & 1 for i in range(n_syn)]
        for gate_name, qubit in code.decode_syndrome(bits):
            if gate_name == "X":
                lut_x[s, qubit] = 1
            elif gate_name == "Z":
                lut_z[s, qubit] = 1
    decode = _table_decoder(
        lut_x, lut_z, np.asarray([1 << i for i in range(nc)], np.int64),
        np.asarray([1 << (nc + i) for i in range(nh)], np.int64), True)

    support = np.zeros(dq, dtype=np.uint8)
    for q in code.logical_z_operators():
        support[q] = 1
    return FrameSpec(
        name=code.name,
        data_qubits=dq,
        comp_checks=comp,
        h_checks=h,
        logical_support=support,
        logical_in_h_frame=code.logical_z_in_h_frame(),
        decode=decode,
    )


def repetition_frame_spec(distance: int,
                          kind: str = "bit_flip") -> FrameSpec:
    """Distance-``d`` repetition code, frame-native: ``"bit_flip"``
    (adjacent ZZ checks, corrects X errors; d = 3 is ``BitFlipCode``) or
    its H-conjugated twin ``"phase_flip"``. Decoding is maximum
    likelihood: the prefix-parity candidate consistent with the syndrome
    or its complement, whichever is lighter (odd d: never a tie)."""
    if distance < 3 or distance % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    if kind not in ("bit_flip", "phase_flip"):
        raise ValueError(f"unknown repetition kind: {kind}")
    d = distance
    checks = [[i, i + 1] for i in range(d - 1)]
    mat = _checks_matrix(checks, d)

    def _ml_error(syn):
        # Candidate error with bit 0 clear: e[i] = s[0] ^ ... ^ s[i-1].
        prefix = torch.cumsum(syn, dim=-1, dtype=torch.int32) & 1
        e0 = torch.cat([torch.zeros_like(prefix[..., :1]), prefix], dim=-1)
        weight = e0.sum(-1, keepdim=True)
        return torch.where(2 * weight > d, 1 - e0, e0)

    if kind == "bit_flip":
        def decode(syn_comp, syn_h):
            ex = _ml_error(syn_comp)
            return ex, torch.zeros_like(ex)
        comp, h = mat, np.zeros((0, d), np.uint8)
        in_h = False
    else:
        def decode(syn_comp, syn_h):
            ez = _ml_error(syn_h)
            return torch.zeros_like(ez), ez
        comp, h = np.zeros((0, d), np.uint8), mat
        in_h = True

    return FrameSpec(
        name=f"Repetition-{kind} [{d},1,{d}]",
        data_qubits=d,
        comp_checks=comp,
        h_checks=h,
        logical_support=np.ones(d, dtype=np.uint8),
        logical_in_h_frame=in_h,
        decode=decode,
    )


def surface_code_frame_spec(distance: int,
                            decoder: str = "auto") -> FrameSpec:
    """Rotated surface code [[d^2, 1, d]], frame-native, any odd d, with
    ``qec._rotated_surface_geometry``'s layout. ``"exact"`` (d <= 5):
    minimum weight per CSS sector through coset-leader tables;
    ``"union_find"`` (any d): the matching decoder on the host (C);
    ``"auto"``: exact when the tables fit (d <= 5)."""
    if decoder not in ("auto", "exact", "union_find"):
        raise ValueError(f"unknown decoder: {decoder!r}")
    if decoder == "auto":
        decoder = "exact" if distance <= 5 else "union_find"
    if decoder == "exact" and distance > 5:
        raise ValueError(
            "coset-leader tables are 2^((d^2-1)/2) rows; the exact "
            "surface decoder is capped at d=5 (use decoder='union_find')")
    z_checks, x_checks, z_logical, _ = _rotated_surface_geometry(distance)
    dq = distance * distance
    comp = _checks_matrix(z_checks, dq)
    h = _checks_matrix(x_checks, dq)
    if decoder == "union_find":
        decode = union_find_decode_fn(comp, h)
        host_decode = union_find_host_decode_fn(comp, h)
    else:
        host_decode = None
        nc, nh = comp.shape[0], h.shape[0]
        decode = _table_decoder(
            _coset_leader_lut(comp), _coset_leader_lut(h),
            np.asarray([1 << i for i in range(nc)], dtype=np.int64),
            np.asarray([1 << i for i in range(nh)], dtype=np.int64), False)

    support = np.zeros(dq, dtype=np.uint8)
    support[z_logical] = 1
    return FrameSpec(
        name=f"Surface [[{dq},1,{distance}]]",
        data_qubits=dq,
        comp_checks=comp,
        h_checks=h,
        logical_support=support,
        logical_in_h_frame=False,
        decode=decode,
        host_decode=host_decode,
    )


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def _draw_error_bits(r, p, noise_type: str):
    """Uniform draws -> (x_bits, z_bits) int32; thresholds as
    ``qec._pauli_masks_from_draws``."""
    x, z = _error_bits(r, p, noise_type)
    return x.to(torch.int32), z.to(torch.int32)


def _parity_product(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``bits[..., dq] @ mat[dq, k]`` mod 2 as int32 (0/1 float32
    product, exact below 2^24)."""
    return (bits.to(torch.float32) @ mat).to(torch.int32) & 1


class _SpecTensors:
    """A spec's check matrices and support as float32 tensors (k, dq)^T
    on one device."""

    def __init__(self, spec: FrameSpec, device):
        f = lambda a: torch.from_numpy(  # noqa: E731
            np.asarray(a, np.float32)).to(device)
        self.comp = f(spec.comp_checks).T
        self.h = f(spec.h_checks).T
        self.support = f(spec.logical_support)[:, None]

    def syndrome(self, bits, checks):
        return _parity_product(bits, checks)

    def logical(self, bits):
        return _parity_product(bits, self.support)[..., 0]


def _ok_fn(st: _SpecTensors, in_h: bool):
    def ok(x_bits, z_bits):
        """1 iff X^x Z^z fixes the logical-basis ideal up to phase."""
        syn_ok = ((st.syndrome(x_bits, st.comp) == 0).all(-1)
                  & (st.syndrome(z_bits, st.h) == 0).all(-1))
        readout = z_bits if in_h else x_bits
        return (syn_ok & (st.logical(readout) == 0)).to(torch.int32)
    return ok


def build_frame_sweep_fn(spec: FrameSpec, noise_type: str, device=None):
    """``(p, uniforms[T, dq]) -> (ok_before, ok_after, flip)`` per-trial
    int32 flags: ``ok_*`` the exact 0/1 fidelity of the noisy / corrected
    state against the logical-basis ideal, ``flip`` whether the corrected
    logical readout sign is inverted."""
    st = _SpecTensors(spec, device or CONFIG.device)
    in_h = spec.logical_in_h_frame
    ok = _ok_fn(st, in_h)

    def sweep(p, uniforms):
        ex, ez = _draw_error_bits(uniforms, p, noise_type)
        ok_before = ok(ex, ez)
        cx, cz = spec.decode(st.syndrome(ex, st.comp),
                             st.syndrome(ez, st.h))
        rx, rz = ex ^ cx, ez ^ cz
        return ok_before, ok(rx, rz), st.logical(rz if in_h else rx)

    return sweep


def build_frame_sweep_host_fn(spec: FrameSpec, noise_type: str,
                              device=None):
    """``(p, uniforms) -> (ok_before, ok_after, flip)`` NumPy: draws on
    ``device``, decoding through ``spec.host_decode``, parity algebra in
    exact NumPy integers (the split twin of ``build_frame_sweep_fn``)."""
    if spec.host_decode is None:
        raise ValueError("spec has no host_decode")
    comp = np.asarray(spec.comp_checks, np.int64)
    h = np.asarray(spec.h_checks, np.int64)
    support = np.asarray(spec.logical_support, np.int64)
    in_h = spec.logical_in_h_frame
    device = device or CONFIG.device

    def _syn(bits, checks):
        if checks.shape[0] == 0:
            return np.zeros((bits.shape[0], 0), np.int64)
        return (bits @ checks.T) & 1

    def _logical(bits):
        return (bits @ support) & 1

    def _ok(x_bits, z_bits):
        syn_ok = ((_syn(x_bits, comp) == 0).all(axis=1)
                  & (_syn(z_bits, h) == 0).all(axis=1))
        readout = z_bits if in_h else x_bits
        return (syn_ok & (_logical(readout) == 0)).astype(np.int32)

    def sweep(p, uniforms):
        u = torch.as_tensor(uniforms, device=device)
        ex, ez = (t.cpu().numpy().astype(np.int64)
                  for t in _draw_error_bits(u, p, noise_type))
        ok_before = _ok(ex, ez)
        cx, cz = spec.host_decode(_syn(ex, comp), _syn(ez, h))
        rx = ex ^ np.asarray(cx, np.int64)
        rz = ez ^ np.asarray(cz, np.int64)
        return (ok_before, _ok(rx, rz),
                _logical(rz if in_h else rx).astype(np.int32))

    return sweep


def round_uniforms(seed: int, n_trials: int, n_rounds: int, widths,
                   device) -> list[torch.Tensor]:
    """The memory experiments' default draws: one ``(T, R, w)`` float32
    block per width, in order, from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.rand((n_trials, n_rounds, w), generator=gen,
                       device=device) for w in widths]


def build_memory_fn(spec: FrameSpec, noise_type: str, n_rounds: int,
                    meas_error_prob: float = 0.0, device=None):
    """``(p, u_data[T, R, dq], u_meas_c[T, R, nc], u_meas_h[T, R, nh]) ->
    failed[T]`` — an R-round memory experiment with per-round decoding:
    each round injects fresh data errors (``u_data``), extracts the
    syndrome through a readout that flips each bit with
    ``meas_error_prob`` (``u_meas_*``; unused at 0), decodes and
    corrects; a final noiseless round closes it. ``failed`` is 1 when the
    surviving residual flips the logical readout. JAX's draws per trial
    and round r: ``uniform(fold_in(fold_in(k, r), 1), (dq,))`` and
    ``uniform(fold_in(fold_in(fold_in(k, r), 2), 0 | 1), (nc | nh,))``."""
    st = _SpecTensors(spec, device or CONFIG.device)
    decode = spec.decode
    in_h = spec.logical_in_h_frame
    q = np.float32(meas_error_prob)

    def memory(p, u_data, u_meas_c=None, u_meas_h=None):
        T = u_data.shape[0]
        dq = spec.data_qubits
        rx = torch.zeros((T, dq), dtype=torch.int32, device=u_data.device)
        rz = torch.zeros_like(rx)
        for r in range(n_rounds):
            ex, ez = _draw_error_bits(u_data[:, r], p, noise_type)
            rx, rz = rx ^ ex, rz ^ ez
            syn_c = st.syndrome(rx, st.comp)
            syn_h = st.syndrome(rz, st.h)
            if q > 0.0:
                if syn_c.shape[-1]:
                    syn_c = syn_c ^ (u_meas_c[:, r] < q).to(torch.int32)
                if syn_h.shape[-1]:
                    syn_h = syn_h ^ (u_meas_h[:, r] < q).to(torch.int32)
            cx, cz = decode(syn_c, syn_h)
            rx, rz = rx ^ cx, rz ^ cz
        cx, cz = decode(st.syndrome(rx, st.comp), st.syndrome(rz, st.h))
        rx, rz = rx ^ cx, rz ^ cz
        return st.logical(rz if in_h else rx)

    return memory


# ---------------------------------------------------------------------------
# Exact ML space-time decoders
# ---------------------------------------------------------------------------

def _wht(a, d: int):
    """Walsh-Hadamard transform over the trailing 2^d axis of (T, 2^d)."""
    T = a.shape[0]
    for q in range(d):
        a = a.reshape(T, 2 ** (d - q - 1), 2, 2 ** q)
        a0, a1 = a[:, :, 0, :], a[:, :, 1, :]
        a = torch.stack([a0 + a1, a0 - a1], dim=2)
    return a.reshape(T, 2 ** d)


def _forward(alpha, syndromes, decay, par, w_meas, d: int):
    """The WHT-diagonalized hidden-Markov forward pass over R rounds:
    ``syndromes[T, R, k]`` int32, ``par[dim, k]`` float32."""
    dim = 2 ** d
    par_sum = par.sum(dim=1)[None, :]
    for r in range(syndromes.shape[1]):
        s_r = syndromes[:, r].to(torch.float32)
        alpha = _wht(alpha, d) * decay
        alpha = _wht(alpha, d) / dim
        n_mis = s_r.sum(dim=1, keepdim=True) + par_sum - 2.0 * (s_r @ par.T)
        alpha = alpha * torch.pow(w_meas, n_mis)
        alpha = alpha / (alpha.sum(dim=1, keepdim=True) + 1e-30)
    return alpha


def _ml_scalars(p, q, popcount, device):
    """decay = (1 - 2p)^popcount and w = q / (1 - q), float32 as JAX."""
    p32, q32 = np.float32(p), np.float32(q)
    base = torch.tensor(np.float32(1) - np.float32(2) * p32, device=device)
    w = torch.tensor(q32 / (np.float32(1) - q32), device=device)
    return torch.pow(base, popcount), w


def build_ml_memory_fn(distance: int, n_rounds: int,
                       return_trace: bool = False,
                       return_masses: bool = False):
    """``(p, q, u_data[T, R, d], u_meas[T, R, d-1]) -> (fail_ml,
    fail_final)`` — a distance-``d`` repetition-code memory experiment
    decoded by EXACT maximum likelihood over the space-time history
    (rounds of data flips w.p. p and syndrome flips w.p. q, then a
    perfect readout), with the single-shot final-syndrome baseline.
    JAX's draws per round r: ``uniform(fold_in(fold_in(k, r), 1), (d,))``
    and ``uniform(fold_in(fold_in(k, r), 2), (d-1,))``.

    ``return_trace`` appends (syndromes[R, T, d-1], X_final[T, d]) as
    JAX does; ``return_masses`` appends the two candidates' posterior
    masses (a0, a1). Requires p < 0.5; memory O(T 2^d), d <= 16."""
    if distance < 3 or distance % 2 == 0:
        raise ValueError("distance must be odd and >= 3")
    if distance > 16:
        raise ValueError("ML decoder state is 2^d; distance capped at 16")
    d = distance
    dim = 2 ** d
    idx = np.arange(dim, dtype=np.int64)
    idx_bits = ((idx[:, None] >> np.arange(d)) & 1).astype(np.int8)
    par_np = (idx_bits[:, :-1] ^ idx_bits[:, 1:]).astype(np.float32)
    pop_np = idx_bits.sum(axis=1).astype(np.float32)

    def run(p, q, u_data, u_meas):
        dev = u_data.device
        T = u_data.shape[0]
        par = torch.from_numpy(par_np).to(dev)
        decay, w_meas = _ml_scalars(p, q, torch.from_numpy(pop_np).to(dev),
                                    dev)
        X = torch.zeros((T, d), dtype=torch.int32, device=dev)
        syns = []
        for r in range(n_rounds):
            X = X ^ (u_data[:, r] < np.float32(p)).to(torch.int32)
            meas = (u_meas[:, r] < np.float32(q)).to(torch.int32)
            syns.append((X[:, :-1] ^ X[:, 1:]) ^ meas)
        syndromes = torch.stack(syns, dim=1)            # (T, R, d-1)
        alpha = torch.zeros((T, dim), dtype=torch.float32, device=dev)
        alpha[:, 0] = 1.0
        alpha = _forward(alpha, syndromes, decay, par, w_meas, d)

        syn_final = X[:, :-1] ^ X[:, 1:]
        prefix = torch.cumsum(syn_final, dim=1, dtype=torch.int32) & 1
        e0 = torch.cat([torch.zeros_like(prefix[:, :1]), prefix], dim=1)
        e1 = 1 - e0
        pow2 = (1 << torch.arange(d, device=dev))
        i0 = (e0.long() * pow2).sum(1)
        i1 = (e1.long() * pow2).sum(1)
        a0 = alpha.gather(1, i0[:, None])[:, 0]
        a1 = alpha.gather(1, i1[:, None])[:, 0]
        pred_ml = torch.where(a0 >= a1, e0[:, 0], e1[:, 0])
        w0 = e0.sum(1)
        pred_final = torch.where(2 * w0 <= d, e0[:, 0], e1[:, 0])
        actual = X[:, 0]
        out = ((pred_ml != actual).to(torch.int32),
               (pred_final != actual).to(torch.int32))
        if return_trace:
            out += (syndromes.transpose(0, 1), X)
        if return_masses:
            out += (a0, a1)
        return out

    return run


def _gf2_nullspace(mat: np.ndarray) -> np.ndarray:
    """Basis of the GF(2) null space of an (m, n) 0/1 matrix, as rows."""
    a = (mat.astype(np.int8) % 2).copy()
    m, n = a.shape
    pivots: list[int] = []
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, m):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            continue
        a[[row, piv]] = a[[piv, row]]
        for r in range(m):
            if r != row and a[r, col]:
                a[r] ^= a[row]
        pivots.append(col)
        row += 1
        if row == m:
            break
    free = [c for c in range(n) if c not in pivots]
    basis = []
    for fc in free:
        v = np.zeros(n, np.int8)
        v[fc] = 1
        for i, pc in enumerate(pivots):
            v[pc] = a[i, fc]
        basis.append(v)
    return (np.asarray(basis, np.int8) if basis
            else np.zeros((0, n), np.int8))


def build_ml_css_memory_fn(checks: np.ndarray, logical_support: np.ndarray,
                           n_rounds: int, return_trace: bool = False,
                           return_masses: bool = False):
    """``(p, q, u_data[T, R, dq], u_meas[T, R, nch]) -> (fail_ml,
    fail_minw)`` — an R-round memory for ONE CSS sector of any code,
    decoded by exact (degenerate) maximum likelihood over the space-time
    history: the final decision integrates the posterior over the whole
    coset consistent with the exact final syndrome, split by logical
    class. ``fail_minw`` is the single-shot coset-leader baseline.
    Draws as ``build_ml_memory_fn``'s; ``return_masses`` appends the
    classes' masses (m0, m1). Memory O(T 2^dq); dq <= 14."""
    checks = np.asarray(checks, np.uint8)
    support_np = np.asarray(logical_support, np.uint8)
    nch, dq = checks.shape
    if dq > 14:
        raise ValueError("posterior state is 2^dq; data qubits capped at 14")
    dim = 1 << dq
    lut = _coset_leader_lut(checks)
    kernel = _gf2_nullspace(checks)
    kdim = kernel.shape[0]
    pow2 = (2 ** np.arange(dq)).astype(np.int64)
    basis_idx = kernel.astype(np.int64) @ pow2
    basis_par = (kernel.astype(np.int64) @ support_np.astype(np.int64)) % 2
    ker_idx = np.zeros(1 << kdim, np.int64)
    ker_par = np.zeros(1 << kdim, np.int32)
    for sub in range(1 << kdim):
        vi, vp = 0, 0
        for b in range(kdim):
            if (sub >> b) & 1:
                vi ^= int(basis_idx[b])
                vp ^= int(basis_par[b])
        ker_idx[sub] = vi
        ker_par[sub] = vp
    rep_idx = lut.astype(np.int64) @ pow2
    rep_par = ((lut.astype(np.int64) @ support_np.astype(np.int64)) % 2
               ).astype(np.int32)
    idx = np.arange(dim, dtype=np.int64)
    idx_bits = ((idx[:, None] >> np.arange(dq)) & 1).astype(np.int8)
    par_np = ((idx_bits.astype(np.int64) @ checks.T.astype(np.int64)) % 2
              ).astype(np.float32)
    pop_np = idx_bits.sum(axis=1).astype(np.float32)
    pow_syn = (2 ** np.arange(nch)).astype(np.int64)

    def run(p, q, u_data, u_meas):
        dev = u_data.device
        T = u_data.shape[0]
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        par = t(par_np)
        checks_f = t(checks.astype(np.float32)).T
        support_f = t(support_np.astype(np.float32))[:, None]
        decay, w_meas = _ml_scalars(p, q, t(pop_np), dev)

        X = torch.zeros((T, dq), dtype=torch.int32, device=dev)
        syns = []
        for r in range(n_rounds):
            X = X ^ (u_data[:, r] < np.float32(p)).to(torch.int32)
            meas = (u_meas[:, r] < np.float32(q)).to(torch.int32)
            syns.append(_parity_product(X, checks_f) ^ meas)
        syndromes = torch.stack(syns, dim=1)            # (T, R, nch)
        alpha = torch.zeros((T, dim), dtype=torch.float32, device=dev)
        alpha[:, 0] = 1.0
        alpha = _forward(alpha, syndromes, decay, par, w_meas, dq)

        s_int = (_parity_product(X, checks_f).long() * t(pow_syn)).sum(1)
        cand = t(rep_idx)[s_int][:, None] ^ t(ker_idx)[None, :]
        cand_par = (t(rep_par)[s_int][:, None] ^ t(ker_par)[None, :]
                    ).to(torch.float32)
        mass = alpha.gather(1, cand)
        m1 = (mass * cand_par).sum(1)
        m0 = (mass * (1.0 - cand_par)).sum(1)
        pred_ml = (m1 > m0).to(torch.int32)
        actual = _parity_product(X, support_f)[:, 0]
        resid = X ^ t(lut)[s_int]
        fail_minw = (_parity_product(resid, support_f)[:, 0] != 0
                     ).to(torch.int32)
        out = ((pred_ml != actual).to(torch.int32), fail_minw)
        if return_trace:
            out += (syndromes.transpose(0, 1), X)
        if return_masses:
            out += (m0, m1)
        return out

    return run


# ---------------------------------------------------------------------------
# Space-time matching memory (union-find, any matchable sector, any d)
# ---------------------------------------------------------------------------

def build_matching_memory_fn(checks: np.ndarray, logical_support: np.ndarray,
                             n_rounds: int):
    """``(p, q, u_data[T, R, dq], u_meas[T, R, nch]) -> (fail_st,
    fail_single)`` NumPy — the R-round memory of ``build_ml_css_memory_fn``
    (same protocol, same draws, so the syndromes and cumulative errors
    are identical) decoded by union-find matching over the space-time
    detection-event graph, with the single-shot baseline on the exact
    final syndrome. Syndromes are generated on the draws' device,
    decoding is the host C loop."""
    checks_np = np.asarray(checks, np.uint8)
    support_np = np.asarray(logical_support, np.uint8)
    nch, dq = checks_np.shape
    R = n_rounds
    st_decode = space_time_decode_fn(checks_np, R)
    base_graph = MatchingGraph.from_checks(checks_np)

    def run(p, q, u_data, u_meas):
        dev = u_data.device
        checks_f = torch.from_numpy(checks_np.astype(np.float32)).to(dev).T
        T = u_data.shape[0]
        X = torch.zeros((T, dq), dtype=torch.int32, device=dev)
        syns = []
        for r in range(R):
            X = X ^ (u_data[:, r] < np.float32(p)).to(torch.int32)
            meas = (u_meas[:, r] < np.float32(q)).to(torch.int32)
            syns.append(_parity_product(X, checks_f) ^ meas)
        syn = torch.stack(syns, dim=1).cpu().numpy().astype(np.uint8)
        X_final = X.cpu().numpy().astype(np.uint8)
        final = (X_final @ checks_np.T) % 2              # exact readout
        det = np.empty((T, R + 1, nch), np.uint8)
        det[:, 0] = syn[:, 0]
        if R > 1:
            det[:, 1:R] = syn[:, 1:] ^ syn[:, :-1]
        det[:, R] = final ^ syn[:, R - 1]
        corr = st_decode(det.reshape(T, (R + 1) * nch)).astype(np.uint8)
        resid = X_final ^ corr
        if ((resid @ checks_np.T) % 2).any():            # invariant
            raise RuntimeError("space-time correction left a nonzero "
                               "final syndrome")
        fail_st = ((resid @ support_np) % 2).astype(np.int32)
        resid1 = X_final ^ decode_batch(base_graph, final).astype(np.uint8)
        fail_single = ((resid1 @ support_np) % 2).astype(np.int32)
        return fail_st, fail_single

    return run


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

_ml_fn_cache: dict[tuple, Callable] = {}


def _surface_sector(distance: int):
    z_checks, _, z_logical, _ = _rotated_surface_geometry(distance)
    dq = distance * distance
    support = np.zeros(dq, dtype=np.uint8)
    support[z_logical] = 1
    return _checks_matrix(z_checks, dq), support


def _rate(p_fail: float, n_rounds: int) -> float:
    return 1.0 - (1.0 - min(p_fail, 1.0 - 1e-12)) ** (1.0 / n_rounds)


def _mean(a) -> float:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return float(np.asarray(a, dtype=np.float64).mean())


class FrameQECSimulator:
    """``QECSimulator``'s sweep surface on the Pauli-frame engine, on
    ``device`` (default ``CONFIG.device``): same API, same per-p draw
    stream and every ``ThresholdPoint`` field; arbitrary-distance codes
    and millions of trials per batch."""

    def __init__(self, spec: FrameSpec, device=None):
        self._spec = spec
        self._device = device or CONFIG.device
        self._sweep_fns: dict[str, Callable] = {}
        self._memory_fns: dict[tuple, Callable] = {}

    @classmethod
    def from_code(cls, code: QECCode, device=None) -> "FrameQECSimulator":
        return cls(frame_spec_from_code(code), device)

    @property
    def spec(self) -> FrameSpec:
        return self._spec

    @property
    def device(self):
        return self._device

    def _sweep(self, noise_type: str, p, u, mesh=None):
        fn = self._sweep_fns.get(noise_type)
        if fn is None:
            fn = build_frame_sweep_fn(self._spec, noise_type, self._device)
            self._sweep_fns[noise_type] = fn
        return _on_mesh(mesh, lambda uu: fn(p, uu), u)

    def _uniforms(self, rng, n_trials: int, uniforms) -> torch.Tensor:
        if uniforms is None:
            return trial_uniforms(rng, n_trials, self._spec.data_qubits,
                                  self._device)
        return torch.as_tensor(uniforms, dtype=torch.float32,
                               device=self._device)

    def sweep_raw(self, noise_prob: float, n_trials: int,
                  noise_type: str = "bit_flip", uniforms=None,
                  seed: int | None = None, mesh=None):
        """One batch -> per-trial (ok_before, ok_after, flip) int32
        tensors. ``uniforms[T, dq]`` overrides the seeded draws (those of
        ``threshold_sweep``'s first p)."""
        u = self._uniforms(np.random.default_rng(seed), n_trials, uniforms)
        return self._sweep(noise_type, noise_prob, u, mesh)

    def threshold_sweep(self, noise_probs: list[float], n_trials: int = 100,
                        noise_type: str = "bit_flip",
                        seed: int | None = None, mesh=None,
                        uniforms=None) -> list[ThresholdPoint]:
        """Physical vs logical error rate, |0>_L / |1>_L alternating;
        one ``(T, dq)`` draw per p from the seed's stream (as
        ``QECSimulator.threshold_sweep``), or ``uniforms[k]``."""
        rng = np.random.default_rng(seed)
        logicals = np.arange(n_trials) % 2
        expected_signs = np.where(logicals == 0, 1.0, -1.0)
        results = []
        for k, p in enumerate(noise_probs):
            u = self._uniforms(rng, n_trials,
                               None if uniforms is None else uniforms[k])
            _, ok_after, flip = self._sweep(noise_type, p, u, mesh)
            ok_after = ok_after.cpu().numpy().astype(np.float64)
            flip = flip.cpu().numpy().astype(np.float64)
            z_exp = expected_signs * (1.0 - 2.0 * flip)
            successes = int(ok_after.sum())
            z_sign_correct = int(((z_exp * expected_signs) >= 0).sum())
            results.append(ThresholdPoint(
                physical_rate=float(p),
                logical_rate=1.0 - successes / n_trials,
                success_rate=successes / n_trials,
                avg_fidelity=float(ok_after.mean()),
                logical_z_fidelity=float(np.abs(z_exp).mean()),
                decoder_success_rate=z_sign_correct / n_trials,
                projection_logical_rate=float(1.0 - ok_after.mean()),
            ))
        return results

    def projection_logical_error(self, logical_state: int, noise_type: str,
                                 noise_prob: float, n_trials: int = 100,
                                 seed: int | None = None,
                                 uniforms=None) -> dict:
        """Mirror of ``QECSimulator.projection_logical_error``: same draw
        stream, same report keys."""
        u = self._uniforms(np.random.default_rng(seed), n_trials, uniforms)
        _, ok_after, flip = self._sweep(noise_type, noise_prob, u)
        ok_after = ok_after.cpu().numpy().astype(np.float64)
        flip = flip.cpu().numpy().astype(np.float64)
        expected_sign = 1.0 if logical_state == 0 else -1.0
        z_exp = expected_sign * (1.0 - 2.0 * flip)
        mean_fid = float(ok_after.mean())
        return {
            "mean_fidelity": mean_fid,
            "logical_error_rate": 1.0 - mean_fid,
            "z_sign_error_rate": float(((z_exp * expected_sign) < 0).mean()),
            "n_trials": n_trials,
        }

    def memory_experiment(self, noise_prob: float, n_rounds: int,
                          n_trials: int = 1000,
                          noise_type: str = "bit_flip",
                          meas_error_prob: float = 0.0,
                          seed: int = 0, mesh=None, uniforms=None) -> dict:
        """R-round memory experiment (``build_memory_fn``): the logical
        failure probability and the per-round rate ``1 - (1 - P)**(1/R)``.
        ``uniforms = (u_data, u_meas_c, u_meas_h)`` overrides the draws
        of ``round_uniforms(seed, ...)``."""
        key = (n_rounds, noise_type, float(meas_error_prob))
        fn = self._memory_fns.get(key)
        if fn is None:
            fn = build_memory_fn(self._spec, noise_type, n_rounds,
                                 meas_error_prob, self._device)
            self._memory_fns[key] = fn
        if uniforms is None:
            spec = self._spec
            uniforms = round_uniforms(
                seed, n_trials, n_rounds,
                (spec.data_qubits, spec.comp_checks.shape[0],
                 spec.h_checks.shape[0]), self._device)
        u = [None if a is None else torch.as_tensor(a, device=self._device)
             for a in uniforms]

        def run(*given):
            it = iter(given)
            return fn(noise_prob, *[None if a is None else next(it)
                                    for a in u])

        p_fail = _mean(_on_mesh(mesh, run,
                                *[a for a in u if a is not None]))
        return {
            "logical_failure_probability": p_fail,
            "per_round_logical_rate": _rate(p_fail, n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def _ml_run(key, build, p, q, widths, n_trials, n_rounds, seed,
                device, uniforms, mesh=None):
        if mesh is not None:   # a bad mesh fails before the draws
            from .parallel.distributed import check_mesh
            check_mesh(mesh)
        fn = _ml_fn_cache.get(key)
        if fn is None:
            fn = build()
            _ml_fn_cache[key] = fn
        device = device or CONFIG.device
        if uniforms is None:
            uniforms = round_uniforms(seed, n_trials, n_rounds, widths,
                                      device)
        u = [torch.as_tensor(a, device=device) for a in uniforms]
        return _on_mesh(mesh, lambda *uu: fn(p, q, *uu), *u)

    @staticmethod
    def ml_memory_experiment(distance: int, noise_prob: float,
                             n_rounds: int, n_trials: int = 1000,
                             meas_error_prob: float = 0.0,
                             seed: int = 0, mesh=None, device=None,
                             uniforms=None) -> dict:
        """Repetition-code memory decoded by the exact space-time ML
        decoder (``build_ml_memory_fn``), with the single-shot
        final-syndrome baseline on the SAME trials. ``uniforms =
        (u_data[T, R, d], u_meas[T, R, d-1])``."""
        fail_ml, fail_final = FrameQECSimulator._ml_run(
            ("rep", distance, n_rounds),
            lambda: build_ml_memory_fn(distance, n_rounds),
            noise_prob, meas_error_prob, (distance, distance - 1),
            n_trials, n_rounds, seed, device, uniforms, mesh)
        p_ml = _mean(fail_ml)
        return {
            "ml_failure_probability": p_ml,
            "final_syndrome_failure_probability": _mean(fail_final),
            "per_round_ml_rate": _rate(p_ml, n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def ml_surface_memory_experiment(noise_prob: float, n_rounds: int,
                                     n_trials: int = 1000,
                                     meas_error_prob: float = 0.0,
                                     distance: int = 3,
                                     seed: int = 0, mesh=None,
                                     device=None, uniforms=None) -> dict:
        """d = 3 rotated-surface-code memory (X-error sector) decoded by
        the exact degenerate-ML space-time decoder
        (``build_ml_css_memory_fn``), with the single-shot coset-leader
        baseline on the same trials. ``uniforms = (u_data[T, R, 9],
        u_meas[T, R, 4])``."""
        if distance != 3:
            raise ValueError("ML surface memory is capped at d=3 "
                             "(posterior state is 2^(d^2))")
        checks, support = _surface_sector(distance)
        fail_ml, fail_minw = FrameQECSimulator._ml_run(
            ("surface", distance, n_rounds),
            lambda: build_ml_css_memory_fn(checks, support, n_rounds),
            noise_prob, meas_error_prob, checks.shape[::-1], n_trials,
            n_rounds, seed, device, uniforms, mesh)
        p_ml = _mean(fail_ml)
        return {
            "ml_failure_probability": p_ml,
            "final_syndrome_failure_probability": _mean(fail_minw),
            "per_round_ml_rate": _rate(p_ml, n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "meas_error_prob": float(meas_error_prob),
        }

    @staticmethod
    def matching_memory_experiment(noise_prob: float, n_rounds: int,
                                   n_trials: int = 1000,
                                   meas_error_prob: float = 0.0,
                                   distance: int = 3,
                                   code: str = "surface",
                                   seed: int = 0, device=None,
                                   uniforms=None) -> dict:
        """Memory decoded by space-time union-find matching
        (``build_matching_memory_fn``), any odd distance: ``code`` picks
        the X-error sector, ``"surface"`` (rotated, Z-checks) or
        ``"repetition"`` (the logical is data bit 0). Reports the
        single-shot union-find baseline on the same trials.
        ``uniforms = (u_data[T, R, dq], u_meas[T, R, nch])``."""
        if code == "surface":
            checks, support = _surface_sector(distance)
        elif code == "repetition":
            dq = distance
            checks = np.zeros((dq - 1, dq), dtype=np.uint8)
            for c in range(dq - 1):
                checks[c, c] = checks[c, c + 1] = 1
            support = np.zeros(dq, dtype=np.uint8)
            support[0] = 1
        else:
            raise ValueError(f"unknown code: {code!r}")
        fail_st, fail_single = FrameQECSimulator._ml_run(
            ("uf", code, distance, n_rounds),
            lambda: build_matching_memory_fn(checks, support, n_rounds),
            noise_prob, meas_error_prob, checks.shape[::-1], n_trials,
            n_rounds, seed, device, uniforms)
        p_st = _mean(fail_st)
        return {
            "matching_failure_probability": p_st,
            "final_syndrome_failure_probability": _mean(fail_single),
            "per_round_matching_rate": _rate(p_st, n_rounds),
            "n_rounds": n_rounds,
            "n_trials": n_trials,
            "distance": distance,
            "code": code,
            "meas_error_prob": float(meas_error_prob),
        }

    def throughput_sweep(self, noise_prob: float, n_trials: int,
                         noise_type: str = "bit_flip",
                         seed: int = 0, mesh=None, uniforms=None):
        """Max-rate variant for benchmarking: one ``(T, dq)`` draw on the
        device from a generator seeded with ``seed`` (or ``uniforms``).
        -> (logical_error_rate, success_count)."""
        if uniforms is None:
            gen = torch.Generator(device=self._device)
            gen.manual_seed(int(seed))
            uniforms = torch.rand((n_trials, self._spec.data_qubits),
                                  generator=gen, device=self._device)
        _, ok_after, _ = self._sweep(
            noise_type, noise_prob,
            torch.as_tensor(uniforms, device=self._device), mesh)
        successes = int(ok_after.sum())
        return 1.0 - successes / n_trials, successes
