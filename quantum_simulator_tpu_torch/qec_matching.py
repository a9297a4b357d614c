"""Union-find matching decoder for CSS sector syndromes.

Counterpart of ``quantum_simulator_tpu/qec_matching.py``: host NumPy and
host C, no device code. The matching graph, the pure-Python decoder (the
reference twin, bit-identical to the C hot loop ``uf_decode`` of the
port's own ``native/qsim_native.c``), the space-time graph and the two
``FrameSpec`` decoder builders. ``union_find_decode_fn`` (a
``jax.pure_callback`` wrapper in JAX) takes device syndromes here, copies
them to the host once, decodes, and returns the corrections on the
syndromes' device.

Guarantee (test-locked): every returned correction reproduces the
observed syndrome exactly (``H @ c % 2 == s``). ``DECODE_CALLS`` counts
the batches decoded by each route (``"native"``, ``"python"``), so a
caller can show that the C module served them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .native import native_module

# Batches decoded by each route since the process started (or the last
# reset by the caller).
DECODE_CALLS = {"native": 0, "python": 0}


# ---------------------------------------------------------------------------
# Matching graph
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MatchingGraph:
    """One CSS sector's syndrome graph.

    ``edges[q] = (u, v)``: data qubit ``q`` toggles check vertices ``u``
    and ``v``; a qubit touching a single check connects it to the
    virtual ``boundary`` vertex (index ``n_checks``).  Requires every
    data qubit to touch 1 or 2 checks of the sector — true for
    repetition chains and the rotated surface code, and the defining
    property of "matchable" codes.

    ``weights`` (optional, default all-1) are integer edge costs
    (~ -log of the edge's fault probability, rescaled): cluster growth
    must deposit ``2 * weight`` units before an edge is traversable, so
    cheaper (likelier) edges are matched first — weighted union-find in
    the Huang-Newman-Brown sense (arXiv:2004.04693 uses real weights;
    integer rescaling keeps growth rounds exact and both decoder twins
    bit-identical).
    """

    n_checks: int
    n_qubits: int
    edges: np.ndarray          # (n_qubits, 2) int32, vertex indices
    has_boundary: bool
    weights: np.ndarray | None = None   # (n_qubits,) int8 >= 1, or None

    @property
    def n_vertices(self) -> int:
        return self.n_checks + (1 if self.has_boundary else 0)

    @property
    def boundary(self) -> int:
        return self.n_checks if self.has_boundary else -1

    @classmethod
    def from_checks(cls, checks: np.ndarray) -> "MatchingGraph":
        checks = np.asarray(checks)
        nc, dq = checks.shape
        weights = checks.sum(axis=0)
        if (weights < 1).any() or (weights > 2).any():
            bad = int(np.argmax((weights < 1) | (weights > 2)))
            raise ValueError(
                f"qubit {bad} touches {int(weights[bad])} checks of this "
                "sector; the matching decoder needs every column weight "
                "in {1, 2}")
        has_boundary = bool((weights == 1).any())
        boundary = nc
        edges = np.empty((dq, 2), dtype=np.int32)
        for q in range(dq):
            rows = np.flatnonzero(checks[:, q])
            if rows.size == 2:
                edges[q] = rows
            else:
                edges[q] = (rows[0], boundary)
        return cls(n_checks=nc, n_qubits=dq, edges=edges,
                   has_boundary=has_boundary)


# ---------------------------------------------------------------------------
# Pure-Python union-find + peeling (reference implementation / fallback)
# ---------------------------------------------------------------------------

def _decode_one_py(graph: MatchingGraph, syndrome: np.ndarray) -> np.ndarray:
    """Decode one syndrome.  Deterministic: edges scan in index order,
    unions always attach the second root under the first, BFS follows
    adjacency in edge-index order — the C twin replays the exact same
    choices, so both paths return bit-identical corrections."""
    nc = graph.n_checks
    nv = graph.n_vertices
    ne = graph.n_qubits
    edges = graph.edges
    bnd = graph.boundary
    cap = 2 * (np.ones(ne, np.int32) if graph.weights is None
               else np.asarray(graph.weights, np.int32))

    parent = list(range(nv))

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:
            parent[v], v = root, parent[v]
        return root

    defect = np.zeros(nv, dtype=np.uint8)
    defect[:nc] = syndrome
    occupied = defect.astype(bool).copy()
    parity = defect.astype(np.int8).copy()           # valid at roots
    on_bnd = np.zeros(nv, dtype=bool)                # valid at roots
    growth = np.zeros(ne, dtype=np.int32)

    def absorb(w: int) -> None:
        if not occupied[w]:
            occupied[w] = True
            if w == bnd:
                on_bnd[w] = True

    # --- growth rounds -----------------------------------------------
    for _ in range(int(cap.max(initial=2)) * nv + 4):
        active = np.zeros(nv, dtype=bool)
        for v in range(nv):
            if occupied[v]:
                r = find(v)
                active[v] = bool(parity[r] & 1) and not on_bnd[r]
        if not active.any():
            break
        grew = False
        newly_full = []
        for e in range(ne):
            if growth[e] >= cap[e]:
                continue
            u, v = int(edges[e, 0]), int(edges[e, 1])
            add = int(active[u]) + int(active[v])
            if add:
                grew = True
                growth[e] = min(int(cap[e]), growth[e] + add)
                if growth[e] == cap[e]:
                    newly_full.append(e)
        if not grew:
            raise ValueError("syndrome is not matchable on this graph "
                             "(odd defect parity in a boundary-free "
                             "component)")
        for e in newly_full:
            u, v = int(edges[e, 0]), int(edges[e, 1])
            absorb(u)
            absorb(v)
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[rv] = ru
                parity[ru] ^= parity[rv]
                on_bnd[ru] |= on_bnd[rv]
    else:
        raise RuntimeError("union-find growth failed to converge")

    # --- peeling -----------------------------------------------------
    corr = np.zeros(ne, dtype=np.uint8)
    # Adjacency over fully-grown edges, built in edge-index order.
    adj: list[list[tuple[int, int]]] = [[] for _ in range(nv)]
    for e in range(ne):
        if growth[e] == cap[e]:
            u, v = int(edges[e, 0]), int(edges[e, 1])
            adj[u].append((v, e))
            adj[v].append((u, e))

    visited = np.zeros(nv, dtype=bool)
    for start in range(nv):
        if not occupied[start] or visited[start]:
            continue
        # Root at the boundary vertex when the cluster contains it, so
        # leftover defect parity drains there.
        root = bnd if (bnd >= 0 and find(start) == find(bnd)
                       and occupied[bnd]) else start
        order = [root]
        tree_edge: dict[int, tuple[int, int]] = {}
        visited[root] = True
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for w, e in adj[u]:
                if not visited[w]:
                    visited[w] = True
                    tree_edge[w] = (u, e)
                    order.append(w)
        for u in reversed(order[1:]):      # leaves toward the root
            if defect[u]:
                par, e = tree_edge[u]
                corr[e] ^= 1
                defect[u] = 0
                defect[par] ^= 1
        if root != bnd and defect[root]:
            raise RuntimeError("peeling left an unmatched defect")
    return corr


def _decode_batch_py(graph: MatchingGraph,
                     syndromes: np.ndarray) -> np.ndarray:
    out = np.empty((syndromes.shape[0], graph.n_qubits), dtype=np.uint8)
    for t in range(syndromes.shape[0]):
        out[t] = _decode_one_py(graph, syndromes[t])
    return out


# ---------------------------------------------------------------------------
# Batched entry (C fast path, Python fallback)
# ---------------------------------------------------------------------------

def decode_batch(graph: MatchingGraph, syndromes: np.ndarray,
                 force_python: bool = False) -> np.ndarray:
    """(T, n_checks) 0/1 syndromes -> (T, n_qubits) 0/1 corrections."""
    syndromes = np.ascontiguousarray(
        np.asarray(syndromes, dtype=np.uint8) & 1)
    if syndromes.ndim != 2 or syndromes.shape[1] != graph.n_checks:
        raise ValueError(
            f"syndromes must be (T, {graph.n_checks}), "
            f"got {syndromes.shape}")
    native = None if force_python else native_module()
    if native is not None:
        T = syndromes.shape[0]
        out = np.zeros((T, graph.n_qubits), dtype=np.uint8)
        wts = (np.ones(graph.n_qubits, np.int32) if graph.weights is None
               else np.ascontiguousarray(graph.weights, dtype=np.int32))
        # int32 coercion is load-bearing: an int64 edge buffer passes the
        # C length check but each endpoint is read as two int32s.
        rc = native.uf_decode(
            np.ascontiguousarray(graph.edges, dtype=np.int32).data,
            graph.n_qubits, graph.n_checks,
            graph.boundary, wts.data, syndromes.data, T, out.data)
        if rc == 0:
            DECODE_CALLS["native"] += 1
            return out
        raise ValueError(
            "syndrome is not matchable on this graph (odd defect "
            "parity in a boundary-free component)")
    DECODE_CALLS["python"] += 1
    return _decode_batch_py(graph, syndromes)


# ---------------------------------------------------------------------------
# Space-time (phenomenological) matching: R noisy rounds + perfect readout
# ---------------------------------------------------------------------------

def space_time_graph(checks: np.ndarray, n_rounds: int,
                     diagonals: list | None = None) -> MatchingGraph:
    """Phenomenological space-time matching graph for one CSS sector.

    Vertices are *detection events*: layer 0 is round 0's syndrome,
    layers 1..R-1 are consecutive-round syndrome differences, layer R is
    the perfect final readout against round R-1 — ``(R+1) * n_checks``
    vertices plus the sector's virtual boundary.  Edges:

    - **horizontal** (first ``R * dq``, round-major): a data error in
      round r's noise window flips its qubit's two checks in layer r
      only (the flip telescopes out of every later difference);
    - **vertical** (next ``R * n_checks``): a syndrome-readout error in
      round r flips the same check in layers r and r+1.

    This is the standard decoding graph for phenomenological noise
    (Dennis et al., arXiv:quant-ph/0110143 §IV); the union-find decoder
    runs on it unchanged — ``decode_batch`` already takes an arbitrary
    1-or-2-endpoint edge list.

    ``diagonals`` upgrades the graph for CIRCUIT-level noise: under a
    real extraction schedule a data fault striking BETWEEN its two
    checks' CNOT steps is seen by the later-reading check this round
    and by the earlier-reading check only next round — a diagonal
    detection pair no phenomenological edge covers.  Pass a length-dq
    list with ``None`` (no diagonal; boundary qubits) or
    ``(early_check, late_check)`` row indices per qubit; each such
    qubit gains edges ``(r, late) - (r+1, early)`` for every r (layer
    R is the perfect readout, which always sees the data error, so the
    orientation also holds at the last round).  Diagonal edges are data
    corrections and fold into the per-qubit estimate exactly like
    horizontal ones (``space_time_decode_fn``).
    """
    if n_rounds < 1:
        raise ValueError("space-time graph needs n_rounds >= 1")
    base = MatchingGraph.from_checks(checks)
    nc, dq, R = base.n_checks, base.n_qubits, n_rounds
    nv_checks = (R + 1) * nc
    bnd = nv_checks
    diag_qubits = []
    if diagonals is not None:
        if len(diagonals) != dq:
            raise ValueError(f"diagonals must have one entry per data "
                             f"qubit ({dq}), got {len(diagonals)}")
        diag_qubits = [(q, int(e), int(l))
                       for q, pair in enumerate(diagonals)
                       if pair is not None
                       for e, l in [pair]]
        for q, e, l in diag_qubits:
            rows = set(np.flatnonzero(np.asarray(checks)[:, q]).tolist())
            if {e, l} != rows:
                raise ValueError(
                    f"diagonal for qubit {q} names checks {(e, l)}; its "
                    f"column touches {sorted(rows)}")
    edges = np.empty((R * dq + R * nc + R * len(diag_qubits), 2),
                     dtype=np.int32)
    for r in range(R):
        off = r * nc
        for q in range(dq):
            u, v = int(base.edges[q, 0]), int(base.edges[q, 1])
            edges[r * dq + q, 0] = off + u
            edges[r * dq + q, 1] = bnd if v == base.n_checks else off + v
    for r in range(R):
        for c in range(nc):
            edges[R * dq + r * nc + c] = (r * nc + c, (r + 1) * nc + c)
    off0 = R * (dq + nc)
    for r in range(R):
        for i, (q, e, l) in enumerate(diag_qubits):
            edges[off0 + r * len(diag_qubits) + i] = (
                r * nc + l, (r + 1) * nc + e)
    return MatchingGraph(n_checks=nv_checks, n_qubits=edges.shape[0],
                         edges=edges, has_boundary=base.has_boundary)


def space_time_decode_fn(checks: np.ndarray, n_rounds: int,
                         diagonals: list | None = None):
    """Host batch decoder over the space-time graph.

    Returns ``decode(detections[T, (R+1)*nc]) -> corrections[T, dq]``:
    the per-qubit XOR of the matched horizontal (and diagonal, when
    ``diagonals`` is given — both are data errors) edges across rounds
    — the decoder's estimate of the *cumulative* data error, guaranteed
    (by the telescoping of detection layers) to reproduce the exact
    final syndrome: ``H @ c % 2 == H @ X_final % 2`` always.
    """
    checks = np.asarray(checks)
    nc, dq = checks.shape
    graph = space_time_graph(checks, n_rounds, diagonals=diagonals)
    R = n_rounds
    diag_q = np.asarray([q for q, pair in enumerate(diagonals or [])
                         if pair is not None], dtype=np.int64)

    def decode(detections: np.ndarray) -> np.ndarray:
        corr = decode_batch(graph, detections)
        horiz = corr[:, :R * dq].reshape(-1, R, dq)
        total = np.bitwise_xor.reduce(horiz, axis=1)
        if diag_q.size:     # diag_q entries are unique: plain fancy XOR
            diag = corr[:, R * (dq + nc):].reshape(-1, R, diag_q.size)
            total[:, diag_q] ^= np.bitwise_xor.reduce(diag, axis=1)
        return total

    return decode


def union_find_host_decode_fn(comp_checks: np.ndarray,
                              h_checks: np.ndarray):
    """Build a numpy ``FrameSpec.host_decode`` from sector check matrices.

    Returns ``decode(syn_comp[T, nc], syn_h[T, nh]) -> (cx, cz)`` int32
    0/1 numpy batches; each sector decodes through the union-find batch
    (C fast path).  An empty sector (e.g. a repetition code's missing
    frame) yields zeros.
    """
    comp_checks = np.asarray(comp_checks)
    h_checks = np.asarray(h_checks)
    dq = comp_checks.shape[1] if comp_checks.size else h_checks.shape[1]
    graph_c = (MatchingGraph.from_checks(comp_checks)
               if comp_checks.shape[0] else None)
    graph_h = (MatchingGraph.from_checks(h_checks)
               if h_checks.shape[0] else None)

    def _sector(graph, syn):
        syn = np.asarray(syn)
        if graph is None:
            return np.zeros((syn.shape[0], dq), np.int32)
        return decode_batch(graph, syn).astype(np.int32)

    def decode(syn_comp, syn_h):
        return _sector(graph_c, syn_comp), _sector(graph_h, syn_h)

    return decode


def union_find_decode_fn(comp_checks: np.ndarray, h_checks: np.ndarray):
    """Build a ``FrameSpec.decode`` from sector check matrices.

    ``decode(syn_comp[T, nc], syn_h[T, nh]) -> (cx, cz)``: the syndromes
    are tensors on any device; they are copied to the host once, decoded
    through :func:`union_find_host_decode_fn` (C fast path), and the
    int32 corrections come back on the syndromes' device.
    """
    host = union_find_host_decode_fn(comp_checks, h_checks)

    def decode(syn_comp, syn_h):
        device = syn_comp.device
        cx, cz = host(syn_comp.cpu().numpy(), syn_h.cpu().numpy())
        return (torch.from_numpy(cx).to(device),
                torch.from_numpy(cz).to(device))

    return decode
