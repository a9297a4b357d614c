"""The port's kernel wrappers and plain twins vs the JAX package's Pallas
kernels (interpreter mode), and the kernels' strided view vs the twins.

``quantum_simulator_tpu_torch/ops/cuda_exec.py`` has two CUDA kernels
(``dense_axis``, ``cross_bit_axis``) that run only on a card; on a CPU
tensor each wrapper takes its plain PyTorch twin. Here:

* the twins are held against ``pallas_exec.lower_dense`` / ``lower_cross``
  run through the Pallas interpreter, exactly as
  ``tests/test_pallas_exec.py`` runs them (same shapes, cases and
  tolerances: 2e-4 dense, 2e-3 cross), and the sliced-bit-in-the-last-axis
  case Pallas declines against the JAX ``_cross_spec`` einsum;
* the kernels' 3xTF32 product (``csrc/fiber_matmul.cuh``) is emulated
  with TF32 rounding done on int32 bits and the kernel's order of adds,
  and held to float64 as tightly as an fp32 product;
* the fiber geometry the wrappers hand the kernels (``dense_geometry``,
  ``cross_geometry``), the tile map and the copy chunks (``copy_plan``)
  are emulated with index arithmetic identical to the kernel's and held
  against the twins; every state element must be read and written by
  exactly one tile.

The kernels themselves are checked on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulator_tpu.ops import pallas_exec
from quantum_simulator_tpu.ops.plan import _HI, _cross_spec, _split_axis_bit
from quantum_simulator_tpu_torch.ops import cuda_exec
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_exec.INTERPRET = True
    yield
    pallas_exec.INTERPRET = False


def rand_state(dshape, planar, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((2,) + dshape) if planar else dshape
    return rng.standard_normal(shape).astype(np.float32)


def _blocked_np(re, im):
    return np.stack([np.stack([re, -im]), np.stack([im, re])])


VARIANTS = [(False, True), (True, True), (True, False)]   # (planar, real)
CROSS_CASES = [(0, 1, 2), (0, 0, 1), (1, 2, 0), (1, 3, 2)]


class TestDenseTwin:
    @pytest.mark.parametrize("axis", [0, 1, 2])
    @pytest.mark.parametrize("planar,op_real", VARIANTS)
    def test_matches_pallas(self, axis, planar, op_real):
        dshape = (4, 16, 128)
        S = dshape[axis]
        rng = np.random.default_rng(1)
        x = rand_state(dshape, planar)
        fn = pallas_exec.lower_dense(dshape, axis, op_real, planar)
        if op_real:
            op = rng.standard_normal((S, S)).astype(np.float32)
            want = np.asarray(fn(jnp.asarray(x), jnp.asarray(op)))
            got = cuda_exec.dense_axis(torch.from_numpy(x),
                                       torch.from_numpy(op), axis, planar)
        else:
            re = rng.standard_normal((S, S)).astype(np.float32)
            im = rng.standard_normal((S, S)).astype(np.float32)
            want = np.asarray(fn(jnp.asarray(x),
                                 jnp.asarray(_blocked_np(re, im))))
            got = cuda_exec.dense_axis(torch.from_numpy(x),
                                       torch.from_numpy(np.stack([re, im])),
                                       axis, planar)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _cross_operand(S, op_real, rng):
    if op_real:
        c = rng.standard_normal((2, S, 2, S)).astype(np.float32)
        return c, c
    re = rng.standard_normal((2, S, 2, S)).astype(np.float32)
    im = rng.standard_normal((2, S, 2, S)).astype(np.float32)
    return _blocked_np(re, im), np.stack([re, im])


class TestCrossTwin:
    @pytest.mark.parametrize("s,pos,o", CROSS_CASES)
    @pytest.mark.parametrize("planar,op_real", [(False, True),
                                                (True, False)])
    def test_matches_pallas(self, s, pos, o, planar, op_real):
        dshape = (8, 16, 128)
        rng = np.random.default_rng(2)
        x = rand_state(dshape, planar, seed=s * 7 + o)
        jax_op, port_op = _cross_operand(dshape[o], op_real, rng)
        fn = pallas_exec.lower_cross(dshape, s, pos, o, op_real, planar)
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(jax_op)))
        got = cuda_exec.cross_bit_axis(torch.from_numpy(x),
                                       torch.from_numpy(port_op), s, pos, o,
                                       planar)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)

    @pytest.mark.parametrize("planar,op_real", [(False, True),
                                                (True, False)])
    def test_minor_slice_matches_einsum(self, planar, op_real):
        """Pallas declines a sliced bit inside the last axis; the port
        covers it, held against the JAX einsum form."""
        dshape, s, pos, o = (8, 16, 128), 2, 3, 0
        assert pallas_exec.lower_cross(dshape, s, pos, o, op_real,
                                       planar) is None
        rng = np.random.default_rng(3)
        x = rand_state(dshape, planar, seed=5)
        jax_op, port_op = _cross_operand(dshape[o], op_real, rng)
        new_shape, bit_axis = _split_axis_bit(dshape, s, pos)
        lead = (2,) if planar else ()
        want = np.asarray(jnp.einsum(
            _cross_spec(len(new_shape), bit_axis, o, op_real, planar),
            jnp.asarray(jax_op), jnp.asarray(x).reshape(lead + new_shape),
            precision=_HI)).reshape(x.shape)
        got = cuda_exec.cross_bit_axis(torch.from_numpy(x),
                                       torch.from_numpy(port_op), s, pos, o,
                                       planar)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


# ---------------------------------------------------------------------------
# The kernels' 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------

def _tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero (add half an ulp to the magnitude bits, mask)."""
    b = v.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _lo(v: torch.Tensor) -> torch.Tensor:
    """``v - hi`` as the tensor core reads it: a TF32 operand, i.e. the
    fp32 value without its low 13 bits."""
    b = (v - _tf32(v)).contiguous().view(torch.int32)
    return (b & -0x2000).view(torch.float32)


# Contraction groups per slab at K = 256 (``MmaTile::KS``): (real, complex).
K_GROUPS = {256: (2, 4)}


def _mma_emulated(pairs, K: int, groups: int = 1,
                  passes: int = 3) -> torch.Tensor:
    """The order of ``mma_kernel``'s adds: each of ``groups`` contiguous
    K ranges accumulates in fp32, in 8-deep steps; a step is a zeroed
    fragment that takes, for each (A, B) product in turn, A_lo B_hi,
    A_hi B_lo, A_hi B_hi; the groups' partials are summed in order.
    (``passes=1``: the single-pass A_hi B_hi the kernels never use.)"""
    split = [((_tf32(a), _lo(a)), (_tf32(b), _lo(b))) for a, b in pairs]
    out = None
    for g in range(groups):
        acc = torch.zeros(pairs[0][0].shape[0], pairs[0][1].shape[1])
        for k0 in range(g * K // groups, (g + 1) * K // groups, 8):
            s = slice(k0, k0 + 8)
            step = torch.zeros_like(acc)
            for (ah, al), (bh, bl) in split:
                if passes == 3:
                    step = step + al[:, s] @ bh[s]
                    step = step + ah[:, s] @ bl[s]
                step = step + ah[:, s] @ bh[s]
            acc = acc + step
        out = acc if out is None else out + acc
    return out


def _product_emulated(w: torch.Tensor, xs, K: int, real: bool,
                      passes: int = 3):
    """Planes of W X for a real (K, K) or complex (2, K, K) W, as the
    tensor-core path computes them: re += Wr Xr then (-Wi) Xi; im += Wr Xi
    then Wi Xr."""
    groups = K_GROUPS.get(K, (1, 1))[0 if real else 1]
    if real:
        return [_mma_emulated([(w, xs[0])], K, groups, passes)]
    wr, wi = w[0], w[1]
    xr, xi = xs
    return [_mma_emulated([(wr, xr), (-wi, xi)], K, groups, passes),
            _mma_emulated([(wr, xi), (wi, xr)], K, groups, passes)]


@pytest.mark.parametrize("K", [32, 128, 256])
@pytest.mark.parametrize("real", [True, False])
def test_3xtf32_is_as_accurate_as_fp32(K, real):
    """The kernels' split product against float64: at most 2x the error
    of the fp32 product (the plain twin's arithmetic); one TF32 pass
    misses the 2e-4 dense tolerance, so the test tells the two apart."""
    rng = np.random.default_rng(K + real)
    n = 2048
    w = rng.standard_normal((K, K) if real else (2, K, K)) / np.sqrt(K)
    x = rng.standard_normal((1 if real else 2, K, n))
    w32 = torch.from_numpy(w.astype(np.float32))
    x32 = [torch.from_numpy(p.astype(np.float32)) for p in x]
    w64 = w32.double().numpy()
    x64 = [p.double().numpy() for p in x32]
    if real:
        want = [w64 @ x64[0]]
        fp32 = [w32 @ x32[0]]
    else:
        want = [w64[0] @ x64[0] - w64[1] @ x64[1],
                w64[0] @ x64[1] + w64[1] @ x64[0]]
        fp32 = [w32[0] @ x32[0] - w32[1] @ x32[1],
                w32[0] @ x32[1] + w32[1] @ x32[0]]

    def err(planes):
        return max(float(np.abs(p.double().numpy() - q).max())
                   for p, q in zip(planes, want))

    e3 = err(_product_emulated(w32, x32, K, real))
    e32 = err(fp32)
    e1 = err(_product_emulated(w32, x32, K, real, passes=1))
    assert e3 <= 2 * e32, (e3, e32)
    assert e1 > 2e-4, e1


def test_tf32_rounding_is_round_to_nearest_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing at 1.0
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3], dtype=torch.float32)
    got = _tf32(v)
    assert got[0] == one + ulp and got[1] == -(one + ulp)
    assert got[2] == one and got[3] == one + ulp
    hi, lo = _tf32(v), _lo(v)
    torch.testing.assert_close(hi.double() + lo.double(), v.double(),
                               atol=0, rtol=2.0 ** -20)


# ---------------------------------------------------------------------------
# The kernels' tile map and strided view, emulated
# ---------------------------------------------------------------------------

def _chunk_addresses(g: cuda_exec.Geometry, K: int) -> torch.Tensor:
    """(K, n_fib) element offsets as the kernel reaches them: from the
    start of a copy chunk of ``vec`` floats plus the position in it
    (``issue_x`` / ``store_slab`` of ``csrc/fiber_matmul.cuh``), along the
    rows of one fiber or along a run of fibers (``copy_plan``). Asserts
    each chunk address is the element's own offset."""
    rows, vec = cuda_exec.copy_plan(g)
    n_fib = g.n_outer * g.n_mid * g.n_inner

    def base(f):
        om = f // g.n_inner
        return (om // g.n_mid) * g.so + (om % g.n_mid) * g.sm + f % g.n_inner

    def roff(r):
        return (r // g.S) * g.bit_stride + (r % g.S) * g.op_stride

    f = torch.arange(n_fib)
    r = torch.arange(K)
    exact = roff(r)[:, None] + base(f)[None, :]
    if rows:
        chunk = (roff(r - r % vec) + r % vec)[:, None] + base(f)[None, :]
    else:
        chunk = roff(r)[:, None] + (base(f - f % vec) + f % vec)[None, :]
    assert torch.equal(chunk, exact), "a copy chunk is not contiguous"
    return chunk


def _emulate_kernel(x: torch.Tensor, w: torch.Tensor, g: cuda_exec.Geometry,
                    K: int, real: bool) -> torch.Tensor:
    """What the kernel computes, with its index map and arithmetic:
    X[r, fib] <- sum_c W[r, c] X[c, fib] in place on the strided fiber
    view, tiles of ``tile_fibers`` fibers each owned by one block, the
    3xTF32 product for K >= MMA_MIN_K and fp32 below."""
    F = cuda_exec.tile_fibers(K, real)
    rows, vec = cuda_exec.copy_plan(g)
    assert F % vec == 0  # a chunk never straddles two tiles
    addr = _chunk_addresses(g, K)
    planes = [addr] if real else [addr, addr + g.plane_stride]
    flat = x.reshape(-1)
    # Every element is read (and then written) by exactly one tile: the
    # one that owns its fiber. So no block reads what another writes, and
    # the kernel may write in place.
    touched = torch.cat([p.reshape(-1) for p in planes])
    assert torch.equal(torch.sort(touched).values,
                       torch.arange(flat.numel()))
    owner = (torch.arange(addr.shape[1]) // F).expand(K, -1)
    tile_of = torch.empty(flat.numel(), dtype=torch.long)
    for p in planes:
        tile_of[p.reshape(-1)] = owner.reshape(-1)
    for p in planes:
        assert torch.equal(tile_of[p], owner)
    xs = [flat[p] for p in planes]
    if K >= cuda_exec.MMA_MIN_K:
        ys = _product_emulated(w.reshape((K, K) if real else (2, K, K)), xs,
                               K, real)
    elif real:
        ys = [w.reshape(K, K) @ xs[0]]
    else:
        wr, wi = w[0].reshape(K, K), w[1].reshape(K, K)
        ys = [wr @ xs[0] - wi @ xs[1], wr @ xs[1] + wi @ xs[0]]
    y = flat.clone()
    for p, v in zip(planes, ys):
        y[p] = v
    return y.reshape(x.shape)


EMU_SHAPES = [(4, 16, 128), (4, 128, 128), (2, 4, 8, 16)]


@pytest.mark.parametrize("shape", EMU_SHAPES)
@pytest.mark.parametrize("planar,op_real", VARIANTS)
def test_dense_geometry_matches_twin(shape, planar, op_real):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rand_state(shape, planar, seed=6))
    for axis in range(len(shape)):
        S = shape[axis]
        w = torch.from_numpy(rng.standard_normal(
            (S, S) if op_real else (2, S, S)).astype(np.float32))
        g = cuda_exec.dense_geometry(shape, axis, planar, op_real)
        got = _emulate_kernel(x, w, g, S, op_real)
        want = cuda_exec.dense_axis_plain(x, w, axis, planar)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def _all_geometries(shape):
    for s in range(len(shape)):
        for pos in range(shape[s].bit_length() - 1):
            for o in range(len(shape)):
                if o != s:
                    yield s, pos, o


@pytest.mark.parametrize("shape", EMU_SHAPES)
@pytest.mark.parametrize("planar,op_real", VARIANTS)
def test_cross_geometry_matches_twin(shape, planar, op_real):
    """Every (slice_axis, slice_pos, op_axis) of the layout, the sliced
    bit inside the last axis and the mirrored view included."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rand_state(shape, planar, seed=7))
    for s, pos, o in _all_geometries(shape):
        S = shape[o]
        w = torch.from_numpy(rng.standard_normal(
            (2, S, 2, S) if op_real else (2, 2, S, 2, S)).astype(np.float32))
        g = cuda_exec.cross_geometry(shape, s, pos, o, planar, op_real)
        got = _emulate_kernel(x, w, g, 2 * S, op_real)
        want = cuda_exec.cross_bit_axis_plain(x, w, s, pos, o, planar)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n,s,pos,o", [
    (16, 1, 0, 0), (16, 1, 6, 2), (28, 0, 6, 1), (28, 1, 6, 2),
    (28, 2, 6, 3), (30, 1, 0, 0), (30, 2, 6, 3), (30, 3, 6, 4)])
def test_main_path_cross_geometries_cover_the_state(n, s, pos, o):
    """The brickwork plans' cross geometries at full width: the fiber
    view is a bijection onto the state (checked by counting, not data)."""
    shape = {16: (4, 128, 128), 28: (128,) * 4,
             30: (4,) + (128,) * 4}[n]
    g = cuda_exec.cross_geometry(shape, s, pos, o, False, True)
    total = 1 << n
    assert g.n_outer * g.n_mid * g.n_inner * 2 * g.S == total
    # the largest offset reached is the last element, the smallest is 0
    last = ((g.n_outer - 1) * g.so + (g.n_mid - 1) * g.sm + g.n_inner - 1
            + g.bit_stride + (g.S - 1) * g.op_stride)
    assert last == total - 1


@pytest.mark.parametrize("kind,shape,geom,want", [
    ("dense", (4, 128, 128), 1, (False, 4)),      # fibers contiguous
    ("dense", (4, 128, 128), 2, (True, 4)),       # rows contiguous
    ("cross", (4, 128, 128), (1, 6, 2), (True, 4)),
    ("cross", (4, 128, 128), (2, 5, 1), (False, 2)),  # runs of 2 fibers
    ("cross", (4, 128, 128), (2, 6, 1), (False, 1)),  # only bit pairs
])
def test_copy_plan_follows_the_contiguous_dimension(kind, shape, geom, want):
    if kind == "dense":
        g = cuda_exec.dense_geometry(shape, geom, False, True)
    else:
        g = cuda_exec.cross_geometry(shape, *geom, False, True)
    assert cuda_exec.copy_plan(g) == want


def test_tile_fibers_split_the_two_paths():
    assert cuda_exec.MMA_MIN_K == 32
    assert [cuda_exec.tile_fibers(k, True) for k in (2, 16, 32, 64, 128, 256)] \
        == [2048, 256, 128, 64, 128, 64]
    assert [cuda_exec.tile_fibers(k, False) for k in (32, 64, 128, 256)] \
        == [64, 32, 32, 32]


def test_cpu_tensor_takes_the_twin_and_counts_no_launch():
    cuda_exec.reset_launch_counts()
    x = torch.from_numpy(rand_state((4, 16, 128), True))
    op = torch.eye(128)
    got = cuda_exec.dense_axis(x, op, 2, True)
    torch.testing.assert_close(got, x)
    cop = torch.zeros(2, 16, 2, 16)
    cop[0, :, 0, :] = torch.eye(16)
    cop[1, :, 1, :] = torch.eye(16)
    torch.testing.assert_close(
        cuda_exec.cross_bit_axis(x, cop, 0, 1, 1, True), x)
    assert cuda_exec.dense_axis.launches == 0
    assert cuda_exec.cross_bit_axis.launches == 0


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((2, 4, 16, 128), device="meta")
    with pytest.raises(ValueError, match="expected CUDA or CPU"):
        cuda_exec.dense_axis(x, torch.empty((128, 128), device="meta"), 2,
                             True)
    with pytest.raises(ValueError, match="expected CUDA or CPU"):
        cuda_exec.cross_bit_axis(
            x, torch.empty((2, 16, 2, 16), device="meta"), 0, 1, 1, True)


def test_complex_operator_needs_a_planar_state():
    x = torch.zeros(4, 16, 128)
    with pytest.raises(ValueError):
        cuda_exec.dense_axis(x, torch.zeros(2, 128, 128), 2, False)
    with pytest.raises(ValueError):
        cuda_exec.cross_bit_axis(x, torch.zeros(2, 2, 16, 2, 16), 0, 1, 1,
                                 False)
