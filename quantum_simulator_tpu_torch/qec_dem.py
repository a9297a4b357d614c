"""Detector-error-model (DEM) extraction for circuit-level QEC.

Counterpart of ``quantum_simulator_tpu/qec_dem.py``: the decoding graph
is derived from the extraction circuit itself, the way stim builds
detector error models. Every single-fault location (each Pauli on each
gate target, the support of the depolarizing noise model) is injected
into the clean schedule; each fault's detection signature (which decoded
sector detection events it flips) and logical flag (does it flip the
readout) are measured, not modeled.

The enumeration is a batched tableau walk (``clifford.walk``): each row
of a chunk carries one fault, injected as sign updates right after its
step, and the chunks are cut by bytes, so the host's per-op launches are
paid once per chunk. Every fault and the clean run read the same
uniform row (broadcast to all rows), so the random sector's projections
are identical and cancel in the signature diff; the result does not
depend on the cut.

Signatures with <= 2 events become matching-graph edges (weights from
the summed fault probability when asked for); heavier ones (hook faults)
are decomposed into existing edges, stim's ``decompose_errors``
strategy. Decoding XORs the matched edges' logical flags into the
readout prediction (host C union-find).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from .clifford import (_GATE_OPCODES, _OP_MEASURE, _lower, identity_tableau,
                       tableau_rows, walk)
from .config import CONFIG
from .qec_circuit import ExtractionLayout, detection_events
from .qec_matching import MatchingGraph, decode_batch


@dataclass(frozen=True)
class DetectorErrorModel:
    """Measured single-fault error model of one extraction circuit.

    ``edges[k]`` is a detection-event pair (site indices into the
    flattened ``(R+1) * nc`` grid; a single-event fault pairs with the
    boundary vertex), ``logicals[k]`` its logical flag, ``counts[k]`` the
    summed probability weight of the faults producing it in units of the
    physical rate p (1/3 per 1q-depolarizing fault, 1/15 per correlated
    CNOT fault; hook decomposition credits both parts). ``dropped`` is
    the weight whose signature could not be expressed."""

    lay: ExtractionLayout
    n_sites: int
    edges: np.ndarray           # (E, 2) int32; boundary = n_sites
    logicals: np.ndarray        # (E,) uint8
    counts: np.ndarray          # (E,) float64 probability weights / p
    n_faults: int
    dropped: int
    ambiguous: int

    def graph(self, noise_prob: float,
              scale: float = 0.0) -> MatchingGraph:
        """Matching graph at physical rate ``noise_prob``; ``scale > 0``
        turns on log-likelihood edge costs (round(scale * -ln(count p)),
        shifted so the cheapest edge costs 1). The default is unweighted,
        as in the JAX package (measured better for union-find there)."""
        if scale <= 0.0:
            weights = None
        else:
            p_edge = self.counts * max(noise_prob, 1e-12)
            cost = -np.log(np.clip(p_edge, 1e-30, 1.0 - 1e-9))
            w = np.round(scale * (cost - cost.min())).astype(np.int32) + 1
            weights = np.minimum(w, 31)
        return MatchingGraph(
            n_checks=self.n_sites, n_qubits=self.edges.shape[0],
            edges=self.edges, has_boundary=True, weights=weights)

    def decode(self, detections: np.ndarray,
               noise_prob: float) -> np.ndarray:
        """(T, (R+1)*nc) detection batches -> (T,) logical predictions
        (the XOR of matched edges' logical flags)."""
        corr = decode_batch(self.graph(noise_prob), detections)
        return ((corr @ self.logicals.astype(np.int64)) % 2).astype(
            np.int32)


_dem_cache: dict[tuple, DetectorErrorModel] = {}

_P = ((0, 0), (1, 0), (1, 1), (0, 1))          # I, X, Y, Z


def fault_list(codes, two_qubit_depol: bool):
    """(step, fxa, fza, fxb, fzb, weight) per elementary fault, in step
    order: X, Y, Z on each target of every H and CNOT at weight 1/3, or
    the 15 correlated pairs of a CNOT at 1/15 (``two_qubit_depol``)."""
    op_targets = {_GATE_OPCODES["H"]: 1, _GATE_OPCODES["CNOT"]: 2}
    faults = []
    for s, opc in enumerate(np.asarray(codes).tolist()):
        nt = op_targets.get(int(opc))
        if nt is None:
            continue
        if two_qubit_depol and nt == 2:
            for m in range(1, 16):
                (fxa, fza), (fxb, fzb) = _P[m >> 2], _P[m & 3]
                faults.append((s, fxa, fza, fxb, fzb, 1.0 / 15.0))
            continue
        for slot in range(nt):
            for fx, fz in _P[1:]:
                pa = (fx, fz) if slot == 0 else (0, 0)
                pb = (fx, fz) if slot == 1 else (0, 0)
                faults.append((s, *pa, *pb, 1.0 / 3.0))
    return faults


def fault_outcomes(n: int, schedule, faults, uniform_row: torch.Tensor,
                   rows: int | None = None) -> np.ndarray:
    """Outcomes ``(F, M)`` uint8 of the clean schedule with fault f's
    Pauli pair ``X^fxa Z^fza (x) X^fxb Z^fzb`` injected on its step's two
    targets right after the step; every row reads ``uniform_row[1, L]``.
    Chunks of ``rows`` faults (default: by bytes) walk as one batch."""
    codes, qa, qb, pp = schedule
    device = uniform_row.device
    F = len(faults)
    step = rows or tableau_rows(n)
    cols = np.asarray([f[:5] for f in faults], np.int64).reshape(-1, 5)
    parts = []
    for lo in range(0, F, step):
        hi = min(F, lo + step)
        steps = cols[lo:hi, 0]
        bits = torch.from_numpy(cols[lo:hi, 1:].astype(np.int8)).to(device)
        first = {}
        for k, s in enumerate(steps.tolist()):
            first.setdefault(s, [k, k])[1] = k + 1

        def inject(i, x, z, r, first=first, bits=bits):
            span = first.get(i)
            if span is None:
                return
            s, e = span
            a, b = int(qa[i]), int(qb[i])
            f = bits[s:e]
            r[s:e] ^= ((f[:, 0:1] & z[s:e, :, a]) ^ (f[:, 1:2] & x[s:e, :, a])
                       ^ (f[:, 2:3] & z[s:e, :, b])
                       ^ (f[:, 3:4] & x[s:e, :, b]))

        _, outs = walk(identity_tableau(n, device, hi - lo), codes, qa, qb,
                       pp, uniform_row, inject)
        parts.append(outs.cpu().numpy().astype(np.uint8))
    M = int((np.asarray(codes) == _OP_MEASURE).sum())
    return np.concatenate(parts) if parts else np.zeros((0, M), np.uint8)


def extract_dem(distance: int, n_rounds: int, basis: str = "z",
                two_qubit_depol: bool = False,
                code: str = "surface", device=None,
                uniforms=None) -> DetectorErrorModel:
    """Enumerate every single-fault location of the extraction circuit
    and build its detector error model (cached per (d, R, basis, noise
    model, device)). ``uniforms[1, L]`` is the row every run reads (JAX:
    ``uniform(PRNGKey(0), (L,))``; by default a generator seeded with 0).
    Faults walk in chunks sized by ``simulator.TRAJECTORY_MEMORY_BYTES``;
    the model does not depend on the cut."""
    device = device or CONFIG.device
    key_t = (distance, n_rounds, basis, two_qubit_depol, code, str(device))
    cacheable = uniforms is None
    hit = _dem_cache.get(key_t) if cacheable else None
    if hit is not None:
        return hit
    from .qec_circuit import _extraction_circuit
    circ, lay = _extraction_circuit(code, distance, n_rounds, basis)
    codes, qa, qb, pp, _ = _lower(circ, collapse_measures=True)
    if uniforms is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        uniforms = torch.rand((1, len(codes)), generator=gen, device=device)
    row = torch.as_tensor(uniforms, dtype=torch.float32,
                          device=device).reshape(1, -1)
    faults = fault_list(codes, two_qubit_depol)
    F = len(faults)
    fw = np.asarray([f[5] for f in faults], np.float64)
    schedule = (codes, qa, qb, pp)

    _, clean = walk(identity_tableau(circ.num_qubits, device, 1), codes, qa,
                    qb, pp, row)
    clean = clean.cpu().numpy().astype(np.uint8)
    det0 = detection_events(lay, clean)[0].reshape(-1)
    raw0 = int((lay.data_outcomes(clean)[0] @ lay.sector_support) % 2)

    outs = fault_outcomes(circ.num_qubits, schedule, faults, row)
    det = detection_events(lay, outs).reshape(F, -1) ^ det0
    raw = ((lay.data_outcomes(outs) @ lay.sector_support) % 2) ^ raw0
    sigs: dict[tuple, list] = {}
    ambiguous = 0
    for i in range(F):
        sites = tuple(np.flatnonzero(det[i]).tolist())
        if not sites:
            # A fault invisible to this sector must not flip the logical
            # either, or the circuit is sub-distance.
            if raw[i]:
                ambiguous += 1
            continue
        rec = sigs.setdefault(sites, [0.0, int(raw[i])])
        rec[0] += float(fw[i])
        if rec[1] != int(raw[i]):
            ambiguous += 1

    n_sites = (n_rounds + 1) * lay.sector_matrix.shape[0]
    bnd = n_sites
    edge_of: dict[tuple, int] = {}
    edges: list[tuple[int, int]] = []
    logicals: list[int] = []
    counts: list[float] = []
    for sites, (cnt, flag) in sorted(sigs.items()):
        if len(sites) > 2:
            continue
        pair = (sites[0], bnd) if len(sites) == 1 else (sites[0], sites[1])
        edge_of[sites] = len(edges)
        edges.append(pair)
        logicals.append(flag)
        counts.append(cnt)

    # Hook decomposition: a >2-event signature splits into two existing
    # edges (every bipartition tried); its weight is credited to both.
    dropped = 0.0
    for sites, (cnt, flag) in sorted(sigs.items()):
        if len(sites) <= 2:
            continue
        placed = False
        ss = list(sites)
        for k in (1, 2):
            for part in itertools.combinations(ss, k):
                a = tuple(sorted(part))
                b = tuple(sorted(set(ss) - set(part)))
                ia, ib = edge_of.get(a), edge_of.get(b)
                if ia is None or ib is None:
                    continue
                if (logicals[ia] ^ logicals[ib]) != flag:
                    continue
                counts[ia] += cnt
                counts[ib] += cnt
                placed = True
                break
            if placed:
                break
        if not placed:
            dropped += cnt

    dem = DetectorErrorModel(
        lay=lay, n_sites=n_sites,
        edges=np.asarray(edges, np.int32).reshape(-1, 2),
        logicals=np.asarray(logicals, np.uint8),
        counts=np.asarray(counts, np.float64),
        n_faults=F, dropped=dropped, ambiguous=ambiguous)
    if cacheable:
        _dem_cache[key_t] = dem
    return dem
