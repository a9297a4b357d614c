"""The float64 kernels' tile map, slab order and shared-memory layout,
emulated on the CPU.

``csrc/fiber_matmul_f64.cu`` runs only on a card. Here its index
arithmetic is repeated in PyTorch, in float64, and held against the plain
twins (``dense_axis_plain`` / ``cross_bit_axis_plain``) at 1e-12 x max |x|
(float64 sums of at most 256 terms in another order):

* the tile walk: tiles of ``tile_fibers_f64`` fibers in trajectory-major
  order, never spanning two trajectories, the ragged last tile of each
  trajectory zero-filled on the copy and skipped on the store; every state
  element is read and written by exactly one tile;
* the copy chunks of the float64 plan (``copy_plan(g, 8)``: 2 or 1 doubles
  along the contiguous dimension) land on the elements' own offsets;
* the product in the kernel's order: slabs of 16 contraction columns, each
  in two 8-deep DMMA steps, re += Wr Xr then (-Wi) Xi and im += Wi Xr then
  Wr Xi (K >= ``F64_MMA_MIN_K``), plain FMA per column below;
* inside a tile: the warps' m16n8 accumulators cover its K rows x F fibers
  once, and the swizzled / padded shared-memory slabs give conflict-free
  fragment loads.

The kernels themselves, and the DMMA in their SASS, are checked on the
card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from quantum_simulator_tpu_torch.ops import cuda_exec
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-12
KC = 16                          # contraction columns of a slab
THREADS = 256

# (F, WM, MT, NT) per depth: ``f64_shape`` of csrc/fiber_matmul_f64.cu.
MMA_SHAPES = {
    (256, False): (32, 8, 2, 4), (128, False): (64, 4, 2, 4),
    (64, False): (128, 2, 2, 4), (32, False): (256, 1, 2, 4),
    (16, False): (256, 1, 1, 4),
    (256, True): (64, 4, 4, 4), (128, True): (128, 2, 4, 4),
    (64, True): (256, 1, 4, 4), (32, True): (256, 1, 2, 4),
    (16, True): (256, 1, 1, 4)}


def _geometry_offsets(g: cuda_exec.Geometry):
    def base(f):
        om = f // g.n_inner
        return (om // g.n_mid) * g.so + (om % g.n_mid) * g.sm + f % g.n_inner

    def roff(r):
        return (r // g.S) * g.bit_stride + (r % g.S) * g.op_stride

    return base, roff


def _chunk_addresses(g: cuda_exec.Geometry, K: int) -> torch.Tensor:
    """(K, n_fib) offsets as ``issue_slab`` reaches them: the start of a
    copy chunk of ``vec`` doubles plus the position in it, along the rows
    of a fiber or along a run of fibers. Each must be the element's own
    offset (the chunk is contiguous)."""
    rows, vec = cuda_exec.copy_plan(g, 8)
    assert vec in (1, 2)
    base, roff = _geometry_offsets(g)
    n_fib = g.n_outer * g.n_mid * g.n_inner
    f = torch.arange(n_fib)
    r = torch.arange(K)
    exact = roff(r)[:, None] + base(f)[None, :]
    if rows:
        chunk = (roff(r - r % vec) + r % vec)[:, None] + base(f)[None, :]
    else:
        chunk = roff(r)[:, None] + (base(f - f % vec) + f % vec)[None, :]
    assert torch.equal(chunk, exact), "a copy chunk is not contiguous"
    return chunk


def _product(w: torch.Tensor, xs, K: int, real: bool):
    """The kernel's sums for a batch of tiles: ``w`` (T, [2,] K, K), ``xs``
    the (T, K, F) planes; returns the output planes."""
    if K >= cuda_exec.F64_MMA_MIN_K:
        if real:
            acc = torch.zeros_like(xs[0])
            for c0 in range(0, K, 8):                 # slabs of 2 steps
                acc += w[:, :, c0:c0 + 8] @ xs[0][:, c0:c0 + 8]
            return [acc]
        wr, wi = w[:, 0], w[:, 1]
        re, im = torch.zeros_like(xs[0]), torch.zeros_like(xs[0])
        for c0 in range(0, K, 8):
            c = slice(c0, c0 + 8)
            re += wr[:, :, c] @ xs[0][:, c]           # plane Xr first
            im += wi[:, :, c] @ xs[0][:, c]
            re += (-wi[:, :, c]) @ xs[1][:, c]        # then plane Xi
            im += wr[:, :, c] @ xs[1][:, c]
        return [re, im]
    # FMA path: per contraction column, re takes Wr Xr then -Wi Xi, im
    # takes Wr Xi then Wi Xr
    if real:
        acc = torch.zeros_like(xs[0])
        for c in range(K):
            acc += w[:, :, c:c + 1] * xs[0][:, c:c + 1]
        return [acc]
    wr, wi = w[:, 0], w[:, 1]
    re, im = torch.zeros_like(xs[0]), torch.zeros_like(xs[0])
    for c in range(K):
        xr, xi = xs[0][:, c:c + 1], xs[1][:, c:c + 1]
        re += wr[:, :, c:c + 1] * xr
        re += -wi[:, :, c:c + 1] * xi
        im += wr[:, :, c:c + 1] * xi
        im += wi[:, :, c:c + 1] * xr
    return [re, im]


def _emulate(x: torch.Tensor, w: torch.Tensor, g: cuda_exec.Geometry,
             K: int, real: bool, batched: bool):
    """What the float64 kernel computes, with its tile walk and order of
    sums; returns (result, ragged tiles seen)."""
    F = cuda_exec.tile_fibers_f64(K, real)
    rows, vec = cuda_exec.copy_plan(g, 8)
    assert F % vec == 0                       # a chunk never straddles tiles
    B = x.shape[0] if batched else 1
    xb = x[0].numel() if batched else 0
    n_fib = g.n_outer * g.n_mid * g.n_inner
    tpt = -(-n_fib // F)                      # tiles per trajectory
    addr = _chunk_addresses(g, K)
    poff = [0] if real else [0, g.plane_stride]
    flat = x.reshape(-1)

    # The walk: tile t is trajectory t // tpt, fibers (t % tpt) F + [0, F)
    t = torch.arange(B * tpt)
    traj = t // tpt
    fib = ((t % tpt) * F)[:, None] + torch.arange(F)[None, :]   # (T, F)
    valid = fib < n_fib
    idx = torch.stack([traj[:, None, None] * xb + p
                       + addr[:, fib.clamp(max=n_fib - 1)].permute(1, 0, 2)
                       for p in poff], 1)                       # (T, P, K, F)
    mask = valid[:, None, None, :].expand_as(idx)
    # every element is read (and then written) by exactly one tile
    owned = idx[mask]
    assert torch.equal(torch.sort(owned).values, torch.arange(flat.numel()))
    owner = t[:, None, None, None].expand_as(idx)[mask]
    tile_of = torch.full((flat.numel(),), -1)
    tile_of[owned] = owner
    assert torch.equal(tile_of[owned], owner)
    # copies of masked fibers are zero-filled, their stores skipped
    xs = torch.where(mask, flat[idx.clamp(max=flat.numel() - 1)],
                     torch.zeros((), dtype=flat.dtype))
    assert not xs[~mask].any()
    wt = (w if batched else w[None])[traj]   # each tile its trajectory's W
    ys = _product(wt, [xs[:, p] for p in range(len(poff))], K, real)
    y = flat.clone()
    y[owned] = torch.stack(ys, 1)[mask]
    return y.reshape(x.shape), int((~valid).any(1).sum())


def _bits(n: int) -> int:
    return n.bit_length() - 1


def _geometries(shape):
    """The kinds of 17a's cross geometries at a small layout: the first
    axis as the op axis, a wide op axis (the last bit of axis 1 sliced), a
    sliced bit inside the last axis, and the first axis as the sliced
    one."""
    last = len(shape) - 1
    return [(1, 0, 0), (1, _bits(shape[1]) - 1, 2),
            (last, _bits(shape[last]) // 2, 0), (0, _bits(shape[0]) - 1, 1)]


# n = 10, 13, 15: dense K = 2-128 and cross K = 4-256 between them
SHAPES = [(2, 16, 32), (4, 128, 16), (8, 32, 128)]
VARIANTS = [(False, True), (True, True), (True, False)]   # (planar, real)


def _data(shape, planar, real, op_shape, batch, seed):
    rng = np.random.default_rng(seed)
    lead = (() if batch is None else (batch,)) + ((2,) if planar else ())
    x = torch.from_numpy(rng.standard_normal(lead + tuple(shape)))
    wshape = (() if batch is None else (batch,)) + (
        () if real else (2,)) + tuple(op_shape)
    k = op_shape[-1] * (2 if len(op_shape) == 4 else 1)
    w = torch.from_numpy(rng.standard_normal(wshape) / np.sqrt(k))
    return x, w


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("planar,real", VARIANTS)
def test_dense_tile_map_matches_twin(shape, planar, real, batch):
    """Every axis; B = 3 with one operator per trajectory."""
    for axis, S in enumerate(shape):
        x, w = _data(shape, planar, real, (S, S), batch, axis)
        g = cuda_exec.dense_geometry(shape, axis, planar, real)
        got, _ = _emulate(x, w, g, S, real, batch is not None)
        want = cuda_exec.dense_axis_plain(x, w, axis, planar,
                                          batch is not None)
        tol = TOL * float(x.abs().max())
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("planar,real", VARIANTS)
def test_ragged_last_tile_of_each_trajectory_is_masked(planar, real):
    """(4, 128, 8), B = 3: the dense K = 128 step has 32 (64) fibers a
    trajectory against tiles of 64 (128), the cross K = 256 step 16 (32)
    against 32 (64): one ragged tile per trajectory, masked, and the
    result still the twin's."""
    shape, B = (4, 128, 8), 3
    x, w = _data(shape, planar, real, (128, 128), B, 1)
    g = cuda_exec.dense_geometry(shape, 1, planar, real)
    got, ragged = _emulate(x, w, g, 128, real, True)
    assert ragged == B
    want = cuda_exec.dense_axis_plain(x, w, 1, planar, True)
    assert float((got - want).abs().max()) <= TOL * float(x.abs().max())
    x, cop = _data(shape, planar, real, (2, 128, 2, 128), B, 2)
    g = cuda_exec.cross_geometry(shape, 0, 0, 1, planar, real)
    got, ragged = _emulate(
        x, cop.reshape((B,) + (() if real else (2,)) + (256, 256)), g, 256,
        real, True)
    assert ragged == B
    want = cuda_exec.cross_bit_axis_plain(x, cop, 0, 0, 1, planar, True)
    assert float((got - want).abs().max()) <= TOL * float(x.abs().max())


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("planar,real", VARIANTS)
def test_cross_tile_map_matches_twin(shape, planar, real, batch):
    """17a's four kinds of cross geometry; B = 3 with one operator per
    trajectory."""
    for s, pos, o in _geometries(shape):
        S = shape[o]
        x, cop = _data(shape, planar, real, (2, S, 2, S), batch, 10 + o)
        g = cuda_exec.cross_geometry(shape, s, pos, o, planar, real)
        w = cop.reshape(((batch,) if batch else ()) +
                        (() if real else (2,)) + (2 * S, 2 * S))
        got, _ = _emulate(x, w, g, 2 * S, real, batch is not None)
        want = cuda_exec.cross_bit_axis_plain(x, cop, s, pos, o, planar,
                                              batch is not None)
        tol = TOL * float(x.abs().max())
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("K", [2, 8, 16, 128, 256])
def test_complex_sign_convention(K):
    """W = i I rotates a planar state: re' = -im, im' = re, exactly; and
    W = I + 0 i leaves it as it is."""
    shape = (4, K, 8)
    S = K
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.standard_normal((2,) + shape))
    g = cuda_exec.dense_geometry(shape, 1, True, False)
    eye = torch.eye(S, dtype=torch.float64)
    zero = torch.zeros_like(eye)
    got, _ = _emulate(x, torch.stack([zero, eye]), g, S, False, False)
    assert torch.equal(got[0], -x[1]) and torch.equal(got[1], x[0])
    got, _ = _emulate(x, torch.stack([eye, zero]), g, S, False, False)
    assert torch.equal(got, x)


@pytest.mark.parametrize("K", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("real", [True, False])
def test_warp_fragments_cover_the_tile_once(K, real):
    """``F64MmaTile``'s warp grid: warp w is row group w % WM and fiber
    group w // WM; accumulator i of its (mt, nt) m16n8 tile in lane
    (gid, tig) is row m_base + 16 mt + gid + 8 (i >> 1), fiber n_base +
    8 nt + 2 tig + (i & 1). Together they cover the K x F tile once."""
    F, WM, MT, NT = MMA_SHAPES[(K, real)]
    assert F == cuda_exec.tile_fibers_f64(K, real)
    WN = THREADS // 32 // WM
    assert MT * 16 * WM == K and NT * 8 * WN == F and WM * WN == 8
    hit = torch.zeros(K, F, dtype=torch.long)
    for warp in range(8):
        m_base, n_base = (warp % WM) * MT * 16, (warp // WM) * NT * 8
        for lane in range(32):
            gid, tig = lane >> 2, lane & 3
            for mt in range(MT):
                for nt in range(NT):
                    for i in range(4):
                        hit[m_base + 16 * mt + gid + 8 * (i >> 1),
                            n_base + 8 * nt + 2 * tig + (i & 1)] += 1
    assert torch.equal(hit, torch.ones(K, F, dtype=torch.long))


def _kmajor(r: int, k: int) -> int:
    """``kmajor`` of csrc/fiber_matmul_f64.cu: (r, k) of 16-double rows,
    16-byte chunk c of row r at c ^ 4 (r & 1)."""
    return r * KC + (((k >> 1) ^ ((r & 1) << 2)) << 1) + (k & 1)


def _conflict_free(offsets, width: int) -> bool:
    """Shared-memory loads of ``width`` bytes a lane (offsets in doubles,
    one per lane): each phase (8 lanes for 16 bytes, 16 for 8 bytes) must
    touch each 4-byte bank at most once."""
    lanes = 128 // width
    for p in range(0, 32, lanes):
        banks = [(8 * o // 4 + j) % 32 for o in offsets[p:p + lanes]
                 for j in range(width // 4)]
        if len(set(banks)) != len(banks):
            return False
    return True


def test_kmajor_is_a_permutation_of_each_row():
    for r in range(4):
        row = sorted(_kmajor(r, k) - r * KC for k in range(KC))
        assert row == list(range(KC))
        # 16-byte chunks stay whole: k and k + 1 (k even) adjacent
        assert all(_kmajor(r, k + 1) == _kmajor(r, k) + 1
                   for k in range(0, KC, 2))


@pytest.mark.parametrize("F", [32, 64, 128, 256])
def test_fragment_loads_are_free_of_bank_conflicts(F):
    """A fragments (operator rows r, r + 8) and fiber-major B fragments:
    16-byte loads at ``kmajor``; row-major B fragments: two 8-byte loads
    at a pitch of F + 2."""
    XP = F + 2
    for kk in (0, 8):
        for base in (0, 16, 48):
            for h in (0, 8):
                a = [_kmajor(base + (l >> 2) + h, kk + 2 * (l & 3))
                     for l in range(32)]
                assert _conflict_free(a, 16)
            for nt in range(2):
                f = [8 * nt + (l >> 2) for l in range(32)]
                b = [_kmajor(f[l], kk + 2 * (l & 3)) for l in range(32)]
                assert _conflict_free(b, 16)
                for d in (0, 1):
                    b = [(kk + 2 * (l & 3) + d) * XP + f[l]
                         for l in range(32)]
                    assert _conflict_free(b, 8)


def test_tile_fibers_f64_split_the_two_paths():
    assert cuda_exec.F64_MMA_MIN_K == 16
    assert [cuda_exec.tile_fibers_f64(k, True)
            for k in (2, 4, 8, 16, 32, 64, 128, 256)] == \
        [1024, 1024, 512, 256, 256, 256, 128, 64]
    assert [cuda_exec.tile_fibers_f64(k, False)
            for k in (16, 32, 64, 128, 256)] == [256, 256, 128, 64, 32]
    # the float64 tiles at the n = 28 complex steps are twice the FMA
    # design's (4096 / K fibers): half the operator bytes from L2
    assert cuda_exec.tile_fibers_f64(128, False) == 2 * 4096 // 128
    assert cuda_exec.tile_fibers_f64(256, False) == 2 * 4096 // 256
