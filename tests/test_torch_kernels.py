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
* the fiber geometry the wrappers hand the kernels (``dense_geometry``,
  ``cross_geometry``) is emulated with index arithmetic identical to the
  kernel's (``csrc/fiber_matmul.cuh``) and held against the twins; the
  view must visit every state element exactly once.

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
# The kernels' strided view, emulated
# ---------------------------------------------------------------------------

def _emulate_kernel(x: torch.Tensor, w: torch.Tensor, g: cuda_exec.Geometry,
                    K: int, real: bool) -> torch.Tensor:
    """What ``fiber_matmul_kernel`` computes, with its index arithmetic:
    Y[r, fib] = sum_c W[r, c] X[c, fib] on the strided fiber view."""
    fib = torch.arange(g.n_outer * g.n_mid * g.n_inner)
    t = fib % g.n_inner
    om = fib // g.n_inner
    base = (om // g.n_mid) * g.so + (om % g.n_mid) * g.sm + t
    r = torch.arange(K)
    roff = (r // g.S) * g.bit_stride + (r % g.S) * g.op_stride
    addr = roff[:, None] + base[None, :]
    flat = x.reshape(-1)
    y = torch.empty_like(flat)
    if real:
        y[addr] = w.reshape(K, K) @ flat[addr]
        touched = addr.reshape(-1)
    else:
        wr, wi = w[0].reshape(K, K), w[1].reshape(K, K)
        xr, xi = flat[addr], flat[addr + g.plane_stride]
        y[addr] = wr @ xr - wi @ xi
        y[addr + g.plane_stride] = wr @ xi + wi @ xr
        touched = torch.cat([addr.reshape(-1),
                             (addr + g.plane_stride).reshape(-1)])
    # the view visits every element of the state exactly once
    assert torch.equal(torch.sort(touched).values,
                       torch.arange(flat.numel()))
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
