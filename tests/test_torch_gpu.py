"""CUDA kernels of the PyTorch port vs their plain PyTorch twins, on a card.

Marked ``gpu``: they skip (with a reason) where no CUDA device exists.
The file imports torch and the port only, so it also runs where JAX is
not installed. Run on a machine with a card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.) These tests
are the port's one card check; the benchmark (``qsbench/``) times it.
Tolerances are those of ``tests/test_pallas_exec.py``: 2e-4 dense, 2e-3
cross, as the sums run in another order than cuBLAS's. The kernels write
in place, so every twin runs on the state before the kernel does.
"""

import contextlib
import os
import subprocess

import numpy as np
import pytest
import torch

from bench import build_circuit_dict
from quantum_simulator_tpu_torch import (NoiseChannel, QuantumCircuit,
                                         Simulator)
from quantum_simulator_tpu_torch.ops import cuda_exec
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@contextlib.contextmanager
def _precision(precision):
    """Run the block under ``enable_complex128`` for "complex128" (yields
    whether it does); complex64 is restored after either way."""
    from quantum_simulator_tpu_torch import config

    wide = precision == "complex128"
    if wide:
        config.enable_complex128()
    try:
        yield wide
    finally:
        config.enable_complex64()


def _launches(wide):
    """(dense, cross, the other precision's total) launches so far."""
    mine = cuda_exec.KERNELS_F64 if wide else cuda_exec.KERNELS
    other = cuda_exec.KERNELS if wide else cuda_exec.KERNELS_F64
    return (mine[0].launches, mine[1].launches,
            sum(k.launches for k in other))


def _grouped_max_diff(a, b):
    """max |a - b| of two states, chunk by chunk (no state-sized
    temporary)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    err = torch.zeros((), dtype=a.dtype, device=a.device)
    for s in range(0, fa.numel(), tplan.CHUNK_ELEMS):
        e = s + tplan.CHUNK_ELEMS
        err = torch.maximum(err, (fa[s:e] - fb[s:e]).abs().max())
    return float(err)


def _global_noise(channel):
    from quantum_simulator_tpu_torch import NoiseModel

    nm = NoiseModel()
    nm.add_global_noise(channel)
    return nm


def _state(shape, planar, device, seed=0):
    rng = np.random.default_rng(seed)
    full = ((2,) if planar else ()) + tuple(shape)
    return torch.from_numpy(
        rng.standard_normal(full).astype(np.float32)).to(device)


def _op(shape, real, device, seed=1):
    rng = np.random.default_rng(seed)
    full = tuple(shape) if real else (2,) + tuple(shape)
    return torch.from_numpy(
        rng.standard_normal(full).astype(np.float32)).to(device)


VARIANTS = [(False, True), (True, True), (True, False)]  # (planar, real)


# ---------------------------------------------------------------------------
# The build: what ptxas and the SASS say, and the tile sizes the wrapper
# assumes (the CPU tests' model of the tile walk rests on them)
# ---------------------------------------------------------------------------

def _built():
    """The kernel library, built if need be; skips where the CUDA toolkit
    is absent, as the build itself needs it."""
    from quantum_simulator_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return _build.build()


def test_no_kernel_spills(cuda):
    """``ptxas -v`` of every kernel instance: no spill store or load."""
    from quantum_simulator_tpu_torch.ops import _build

    _built()
    spills, entry = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split()
                    if t.isdigit()]
            spills[entry] = nums[1] + nums[2]   # stack, stores, loads
    names = " ".join(spills)
    for kernel in ("simt_kernel", "cluster_mma_kernel", "f64_fma_kernel",
                   "f64_mma_kernel", "diag_pair_kernel",
                   "swap_bits_kernel"):
        assert kernel in names
    assert {k: v for k, v in spills.items() if v} == {}


def test_f64_dmma_exactly_on_the_dmma_path(cuda):
    """``cuobjdump -sass``: DMMA in every float64 instance of the DMMA path
    (K >= ``F64_MMA_MIN_K``), none in the FP64 FMA ones."""
    from quantum_simulator_tpu_torch.ops import _build

    lib = _built()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        pytest.skip(f"needs {tool}")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    dmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if "f64_" in fn else None
            if fn:
                dmma[fn] = 0
        elif fn and "*/" in line:
            words = line.split("*/")[1].split()
            op = next((t for t in words if not t.startswith("@")), "")
            dmma[fn] += op.startswith("DMMA")
    mma = {k: v for k, v in dmma.items() if "f64_mma_kernel" in k}
    fma = {k: v for k, v in dmma.items() if "f64_mma_kernel" not in k}
    assert mma and fma
    assert all(mma.values()), mma
    assert not any(fma.values()), fma


def test_kernel_tile_sizes_agree_with_the_wrapper(cuda):
    """The kernels' fibers per tile and cluster rule, as the library
    reports them, equal ``tile_fibers``, ``tile_fibers_f64`` and
    ``takes_cluster``."""
    from quantum_simulator_tpu_torch.ops import _build

    _built()
    lib = _build.library()
    for k in (2, 4, 8, 16, 32, 64, 128, 256):
        for real in (True, False):
            assert lib.qs_tile_fibers(k, int(not real)) == \
                cuda_exec.tile_fibers(k, real), (k, real)
            assert lib.qs_tile_fibers_f64(k, int(not real)) == \
                cuda_exec.tile_fibers_f64(k, real), (k, real)
    assert lib.qs_cluster_tile_fibers() == cuda_exec.tile_fibers(
        256, False, cluster=True)
    for k in (128, 256):
        for real in (True, False):
            for op_stride in (0, 2 * k * k):
                for vec in (1, 2, 4):
                    assert bool(lib.qs_cross_path(
                        k, int(not real), op_stride, vec)) == \
                        cuda_exec.takes_cluster(k, real, op_stride, vec), \
                        (k, real, op_stride, vec)


@pytest.mark.parametrize("shape", [(4, 16, 128), (4, 128, 128)])
@pytest.mark.parametrize("planar,real", VARIANTS)
def test_dense_kernel_matches_twin(cuda, shape, planar, real):
    x = _state(shape, planar, cuda)
    for axis in range(len(shape)):
        S = shape[axis]
        op = _op((S, S), real, cuda, seed=axis)
        want = cuda_exec.dense_axis_plain(x, op, axis, planar)
        got = cuda_exec.dense_axis(x.clone(), op, axis, planar)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("shape,s,pos,o", [
    ((8, 16, 128), 0, 1, 2), ((8, 16, 128), 0, 0, 1),
    ((8, 16, 128), 1, 2, 0), ((8, 16, 128), 1, 3, 2),
    ((8, 16, 128), 2, 3, 0),            # sliced bit inside the last axis
    ((4, 128, 128), 1, 0, 0), ((4, 128, 128), 1, 6, 2),
    ((4, 128, 128), 2, 6, 1),
])
@pytest.mark.parametrize("planar,real", [(False, True), (True, False)])
def test_cross_kernel_matches_twin(cuda, shape, s, pos, o, planar, real):
    x = _state(shape, planar, cuda, seed=s * 7 + o)
    S = shape[o]
    cop = _op((2, S, 2, S), real, cuda, seed=2)
    want = cuda_exec.cross_bit_axis_plain(x, cop, s, pos, o, planar)
    got = cuda_exec.cross_bit_axis(x.clone(), cop, s, pos, o, planar)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def _scaled_op(shape, real, device, seed):
    """N(0, 1/K) entries: outputs stay O(1), like a unitary's."""
    k = shape[-1] * (2 if len(shape) == 4 else 1)
    return _op(shape, real, device, seed) / np.sqrt(k)


def _check_dense(x, op, axis, planar, tol=2e-4):
    want = cuda_exec.dense_axis_plain(x, op, axis, planar)
    got = cuda_exec.dense_axis(x, op, axis, planar)
    torch.cuda.synchronize()
    assert got is x
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def _check_cross(x, cop, s, pos, o, planar, tol=2e-3):
    want = cuda_exec.cross_bit_axis_plain(x, cop, s, pos, o, planar)
    got = cuda_exec.cross_bit_axis(x, cop, s, pos, o, planar)
    torch.cuda.synchronize()
    assert got is x
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("planar,real", VARIANTS)
def test_wrappers_write_in_place(cuda, planar, real):
    """Like Pallas's input_output_aliases: the result overwrites the
    input and the wrapper returns that same tensor."""
    x = _state((4, 128, 128), planar, cuda)
    ptr = x.data_ptr()
    op = _scaled_op((128, 128), real, cuda, seed=3)
    assert cuda_exec.dense_axis(x, op, 2, planar) is x
    assert x.data_ptr() == ptr
    if planar and real:
        return
    cop = _scaled_op((2, 128, 2, 128), real, cuda, seed=4)
    assert cuda_exec.cross_bit_axis(x, cop, 1, 6, 2, planar) is x
    assert x.data_ptr() == ptr


@pytest.mark.parametrize("planar,real", VARIANTS)
def test_ragged_last_tile(cuda, planar, real):
    """Fewer fibers than a tile holds: the tail is zero-filled on load
    and masked on store."""
    shape = (128, 16)                      # K = 128 on 16 or 32 fibers
    g = cuda_exec.dense_geometry(shape, 0, planar, real)
    assert g.n_outer * g.n_mid * g.n_inner < cuda_exec.tile_fibers(128, real)
    _check_dense(_state(shape, planar, cuda), _scaled_op((128, 128), real,
                                                         cuda, 5), 0, planar)
    if planar and real:
        return
    cop = _scaled_op((2, 128, 2, 128), real, cuda, seed=6)
    _check_cross(_state((2, 128), planar, cuda), cop, 0, 0, 1, planar)
    # one fiber of K = 256


@pytest.mark.parametrize("geom,width", [
    ((1, 6, 2), (True, 4)),     # rows contiguous: 16-byte copies
    ((0, 1, 2), (True, 4)),
    ((2, 3, 0), (False, 4)),    # runs of 8 fibers (K = 8: SIMT)
    ((1, 0, 0), (False, 4)),
    ((2, 6, 1), (False, 1)),    # only bit pairs adjacent: 4 bytes
    ((2, 5, 1), (False, 2)),    # runs of 2 fibers: 8 bytes
])
@pytest.mark.parametrize("planar,real", [(False, True), (True, False)])
def test_copy_widths(cuda, geom, width, planar, real):
    shape = (4, 128, 128)
    g = cuda_exec.cross_geometry(shape, *geom, planar, real)
    assert cuda_exec.copy_plan(g) == width
    S = shape[geom[2]]
    _check_cross(_state(shape, planar, cuda), _scaled_op(
        (2, S, 2, S), real, cuda, 7), *geom, planar)


# Every cross geometry of the brickwork plans at n = 16, 28 and 30, plus a
# sliced bit inside the last axis.
LAYOUTS = {16: (4, 128, 128), 28: (128,) * 4, 30: (4,) + (128,) * 4}
SMOKE_CROSS = [(16, 1, 0, 0), (16, 1, 6, 2), (28, 0, 6, 1), (28, 1, 6, 2),
               (28, 2, 6, 3), (30, 1, 0, 0), (30, 1, 6, 2), (30, 2, 6, 3),
               (30, 3, 6, 4), (16, 2, 3, 0), (28, 3, 0, 1)]


@pytest.mark.parametrize("n,s,pos,o", SMOKE_CROSS)
def test_cross_slab_loop_on_main_path_geometries(cuda, n, s, pos, o):
    """K = 256 streams a real operator in slabs of output rows (a shared
    complex one takes the cluster kernel); every main path geometry, real
    operator on a real state (complex at n = 16)."""
    shape = LAYOUTS[n]
    S = shape[o]
    variants = [(False, True)] + ([(True, False)] if n == 16 else [])
    for planar, real in variants:
        cop = _scaled_op((2, S, 2, S), real, cuda, seed=8)
        _check_cross(_state(shape, planar, cuda), cop, s, pos, o, planar)
        torch.cuda.empty_cache()


def _brick(n, depth, mix_rz=False, seed=42):
    return QuantumCircuit.from_dict(build_circuit_dict(n, depth, seed,
                                                       mix_rz))


def _noisy_plans(program, nm):
    """The group plans one batch of trajectories runs: the spliced
    program's (mixed-unitary noise) or every window's segment's
    (monomial noise)."""
    from quantum_simulator_tpu_torch.ops import monomial_traj as tmono
    from quantum_simulator_tpu_torch.ops import unitary_traj as tunit

    if tprog.trajectory_route(program, nm) == "unitary":
        return [tplan.get_group_plan(
            tunit.unitary_insert_spec(program, nm).aug)]
    return [tplan.get_group_plan(s)
            for s in tmono.monomial_spec(program, nm).segments]


def _cross_geometries(plans):
    return sorted({(s.slice_axis, s.slice_pos, s.op_axis) for p in plans
                   for s in p.steps if isinstance(s, tplan.CrossStep)})


def _brickwork_plans(n, depth=8, noisy=False):
    """The Ry+CNOT and Ry/Rz brickwork plans, or (``noisy``) the Ry+CNOT
    trajectory plans under depolarizing and amplitude damping noise."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DepolarizingNoise)

    if not noisy:
        return [tplan.get_group_plan(tprog.compile_circuit(
            _brick(n, depth, mix))) for mix in (False, True)]
    program = tprog.compile_circuit(_brick(n, depth))
    return [p for ch in (DepolarizingNoise(0.05), AmplitudeDampingNoise(0.05))
            for p in _noisy_plans(program, _global_noise(ch))]


def _step_cases(shape, geoms):
    """(kernel, twin, geometry, operator shape, axes touched, fp32
    tolerance) of every dense axis and of each cross geometry."""
    for a, S in enumerate(shape):
        yield (cuda_exec.dense_axis, cuda_exec.dense_axis_plain, (a,),
               (S, S), {a}, 2e-4)
    for s, pos, o in geoms:
        S = shape[o]
        yield (cuda_exec.cross_bit_axis, cuda_exec.cross_bit_axis_plain,
               (s, pos, o), (2, S, 2, S), {s, o}, 2e-3)


def _rand_op(op_shape, real, gen, dtype=torch.float32, batch=None,
             shared=True):
    """N(0, 1/K) entries, K the contraction depth; with ``batch``, one
    operator per trajectory or one shared with stride 0."""
    k = op_shape[-1] * (2 if len(op_shape) == 4 else 1)
    full = tuple(op_shape) if real else (2,) + tuple(op_shape)
    rows = 1 if batch is None or shared else batch
    a = torch.randn((rows,) + full, generator=gen, device=gen.device,
                    dtype=dtype) / k ** 0.5
    return a[0] if batch is None else a.expand((batch,) + full)


# (layout, batch, depth of the noisy plans whose cross steps are taken):
# the headline's and the n = 28 layout alone, and the noisy batches' n = 10
# and 16 layouts with 16 trajectories.
F64_REF_CASES = {"n16": ((4, 128, 128), None, None),
                 "n28": ((128,) * 4, None, None),
                 "n10-B16": ((8, 128), 16, 10),
                 "n16-B16": ((4, 128, 128), 16, 40)}


@pytest.mark.parametrize("case", list(F64_REF_CASES))
def test_kernel_error_against_float64_at_most_twice_the_twins(cuda, case):
    """Against the twin run in float64, a kernel's max error is at most
    twice the fp32 twin's (3xTF32 and SIMT fp32 keep fp32 accuracy): every
    dense axis in the three forms and every cross geometry of the layout's
    plans, batched with a shared and with a per-trajectory operator."""
    shape, B, depth = F64_REF_CASES[case]
    n = int(np.log2(np.prod(shape)))
    geoms = ([g[1:] for g in SMOKE_CROSS if g[0] == n] if B is None else
             _cross_geometries(_brickwork_plans(n, depth, noisy=True)))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    lead = () if B is None else (B,)
    for shared in ((True,) if B is None else (True, False)):
        for fn, twin, geom, op_shape, _, tol in _step_cases(shape, geoms):
            dense = fn is cuda_exec.dense_axis
            for planar, real in (VARIANTS if dense else VARIANTS[::2]):
                x = torch.randn(lead + ((2,) if planar else ()) + shape,
                                generator=gen, device=cuda)
                op = _rand_op(op_shape, real, gen, batch=B, shared=shared)
                args = geom + (planar, B is not None)
                want = twin(x, op, *args)
                ref = twin(x.double(), op.double(), *args)
                got = fn(x, op, *args)
                torch.cuda.synchronize()
                assert got is x
                torch.testing.assert_close(got, want, atol=tol, rtol=0)
                err = float((got.double() - ref).abs().max())
                twin_err = float((want.double() - ref).abs().max())
                assert err <= 2 * twin_err, (geom, planar, real, shared,
                                             err, twin_err)
                del x, op, want, ref, got
        torch.cuda.empty_cache()


# Layouts past 2^31 elements (the kernels' 64-bit offsets): (layout, dtype,
# batch). n = 30 - 32 as the large-state path holds them, a noisy batch of
# 64 planar trajectories at n = 24, and the mesh's 8 stacked planar shards
# of n = 30 in float64.
HUGE_KERNEL_CASES = {
    "n30": ((4,) + (128,) * 4, torch.float32, None),
    "n31": ((8,) + (128,) * 4, torch.float32, None),
    "n32": ((16,) + (128,) * 4, torch.float32, None),
    "n30-f64": ((4,) + (128,) * 4, torch.float64, None),
    "n31-f64": ((8,) + (128,) * 4, torch.float64, None),
    "n24-B64": ((8, 128, 128, 128), torch.float32, 64),
    "mesh-n30-f64": ((64, 128, 128, 128), torch.float64, 8),
}
SLICE_ELEMS = 1 << 28      # elements of one slice of a twin run slice-wise


def _sliced_max_err(got, x0, twin, planar, touched):
    """max |got - twin(x0)| with the twin run slice by slice along the
    widest data axis the step does not touch (two states and one slice's
    temporaries at the peak)."""
    lead = int(planar)
    shape = tuple(x0.shape[lead:])
    ax = max((a for a in range(len(shape)) if a not in touched),
             key=lambda a: shape[a])
    width = min(shape[ax], max(1, shape[ax] * SLICE_ELEMS // x0.numel()))
    err = 0.0
    for start in range(0, shape[ax], width):
        want = twin(x0.narrow(lead + ax, start, width))
        err = max(err, float((got.narrow(lead + ax, start, width)
                              - want).abs().max()))
        del want
    return err


@pytest.mark.parametrize("case", list(HUGE_KERNEL_CASES))
def test_kernels_match_twins_past_2_31_elements(cuda, case):
    """Every dense axis and every cross geometry of the brickwork plans at
    the layout (unbatched: the three forms; batched: a planar state with a
    shared and with a per-trajectory complex operator), against the twin
    run slice by slice (trajectory by trajectory when batched): 2e-4 dense
    and 2e-3 cross in float32, 1e-12 x max |x| in float64."""
    shape, dtype, B = HUGE_KERNEL_CASES[case]
    n = int(np.log2(np.prod(shape)))
    geoms = _cross_geometries(_brickwork_plans(n, noisy=B == 64))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    for fn, twin, geom, op_shape, touched, tol in _step_cases(shape, geoms):
        dense = fn is cuda_exec.dense_axis
        forms = ((VARIANTS if dense else VARIANTS[::2]) if B is None
                 else [(True, False)])
        for planar, real in forms:
            for shared in ((True,) if B is None else (True, False)):
                torch.cuda.empty_cache()
                lead = (() if B is None else (B,)) + ((2,) if planar else ())
                x = torch.randn(lead + shape, generator=gen, device=cuda,
                                dtype=dtype)
                x0 = x.clone()
                op = _rand_op(op_shape, real, gen, dtype, B, shared)
                got = fn(x, op, *geom, planar, B is not None)
                torch.cuda.synchronize()
                assert got is x
                if B is None:
                    err = _sliced_max_err(
                        got, x0, lambda v: twin(v, op, *geom, planar),
                        planar, touched)
                else:
                    err = max(float((got[b] - twin(x0[b], op[b], *geom,
                                                   planar)).abs().max())
                              for b in range(B))
                if dtype == torch.float64:
                    tol = 1e-12 * max(float(x0.max()), -float(x0.min()))
                assert err <= tol, (geom, planar, real, shared, err)
                del x, x0, op, got
    torch.cuda.empty_cache()


@pytest.mark.parametrize("planar,real", VARIANTS)
def test_both_sides_of_the_small_k_line(cuda, planar, real):
    """K < MMA_MIN_K runs the fp32 SIMT template, K >= it the 3xTF32
    tensor-core one."""
    assert cuda_exec.MMA_MIN_K == 32
    shape = (16, 32, 64)
    for axis in range(3):                  # K = 16 | K = 32, 64
        S = shape[axis]
        _check_dense(_state(shape, planar, cuda),
                     _scaled_op((S, S), real, cuda, 9 + axis), axis, planar)
    if planar and real:
        return
    for shape, geoms in (((4, 8, 16), ((2, 0, 0), (2, 0, 1), (0, 0, 2))),
                         ((16, 32, 64), ((1, 0, 0), (0, 0, 1)))):
        for s, pos, o in geoms:            # K = 8, 16 | K = 32 | 32, 64
            S = shape[o]
            _check_cross(_state(shape, planar, cuda),
                         _scaled_op((2, S, 2, S), real, cuda, 12), s, pos,
                         o, planar)


def test_a_step_allocates_no_second_state(cuda):
    """In place: a step's peak is the state plus at most 64 MiB."""
    x = _state((16, 128, 128, 128), True, cuda)      # 256 MiB planar
    ops = (_scaled_op((128, 128), False, cuda, 15),
           _scaled_op((2, 128, 2, 128), False, cuda, 16))
    for run in (lambda: cuda_exec.dense_axis(x, ops[0], 2, True),
                lambda: cuda_exec.cross_bit_axis(x, ops[1], 1, 6, 3, True)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= 64 * 2**20


def test_executor_holds_one_state(cuda):
    """The fault the in-place kernels repair: an out-of-place step held
    two states at its peak. A plan of dense and cross steps only now holds
    the state it was given and nothing close to a second one."""
    c = QuantumCircuit.from_dict(build_circuit_dict(28, 8, 5, True))
    p = tprog.compile_circuit(c)
    plan = tplan.build_group_plan(p)
    assert all(isinstance(s, (tplan.AxisMatmulStep, tplan.CrossStep))
               for s in plan.steps)
    ops = tplan.operands_to(
        tplan.build_group_operands(p, plan, p.initial_params), cuda)
    x = tplan.basis_state(plan, p.initial_index, cuda, True)   # 2 GiB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = tplan.execute_group_plan(plan, ops, p, p.initial_params, x, True)
    torch.cuda.synchronize()
    assert out.data_ptr() == x.data_ptr()
    assert torch.cuda.max_memory_allocated() - base <= 64 * 2**20


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _state((4, 128, 128), True, cuda)
    op = _op((128, 128), True, cuda)
    with pytest.raises(TypeError):   # a float64 state takes a float64 op
        cuda_exec.dense_axis(x.double(), op, 2, True)
    with pytest.raises(ValueError):
        cuda_exec.dense_axis(x.transpose(2, 3), op, 2, True)
    with pytest.raises(ValueError):
        cuda_exec.dense_axis(x, op[:64], 2, True)
    with pytest.raises(ValueError):
        cuda_exec.cross_bit_axis(x[0], _op((2, 128, 2, 128), False, cuda),
                                 1, 0, 2, False)


@pytest.mark.parametrize("mix_rz", [False, True])
def test_simulator_run_goes_through_the_kernels(cuda, mix_rz):
    c = QuantumCircuit.from_dict(build_circuit_dict(16, 12, 5, mix_rz))
    p = tprog.compile_circuit(c)
    plan = tplan.build_group_plan(p)
    n_dense = sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps)
    n_cross = sum(isinstance(s, tplan.CrossStep) for s in plan.steps)
    cuda_exec.reset_launch_counts()
    res = Simulator(device="cuda").run(c, shots=256, seed=3)
    assert cuda_exec.dense_axis.launches == n_dense > 0
    assert cuda_exec.cross_bit_axis.launches == n_cross > 0
    want = tplan.group_forward_body(p, p.initial_params, cuda, plain=True)
    got = res.final_state.device_data
    assert float((got - want).abs().max()) <= 1e-5
    assert sum(res.measurement_counts.values()) == 256


def _qft(n):
    """H + controlled-phase ladder + bit-reversal SWAPs."""
    c = QuantumCircuit(n)
    col = 0
    for i in range(n):
        c.add("H", [i], [], col)
        col += 1
        for j in range(i + 1, n):
            c.add("CPhase", [j, i], [np.pi / 2 ** (j - i)], col)
            col += 1
    for i in range(n // 2):
        c.add("SWAP", [i, n - 1 - i], [], col)
        col += 1
    return c


def _ghz(n):
    c = QuantumCircuit(n)
    c.add("H", [0], [], 0)
    for q in range(n - 1):
        c.add("CNOT", [q, q + 1], [], q + 1)
    return c


def test_qft_with_strided_steps_goes_through_the_kernels(cuda):
    """QFT's pair diagonals and swaps hand the kernels strided views."""
    p = tprog.compile_circuit(_qft(12))
    cuda_exec.reset_launch_counts()
    got = tplan.group_forward_body(p, p.initial_params, cuda)
    assert cuda_exec.dense_axis.launches > 0
    probs = got.abs().square()
    assert float((probs - 2.0 ** -12).abs().max()) <= 1e-9


def test_simulator_run_n28_samples_on_the_card_within_its_peak(cuda):
    """n = 28, the widest state below the large-state path: GHZ-28's 4096
    shots through the device sampler give only 0..0 and 1..1, each 40-60 %;
    the Ry/Rz brickwork (only dense and cross steps) peaks at one planar
    state in place plus the complex result, under 6.1 GiB."""
    from quantum_simulator_tpu_torch.measurement import MeasurementEngine

    assert 1 << 28 >= MeasurementEngine.DEVICE_SAMPLING_MIN_DIM
    counts = Simulator(device="cuda").run(
        _ghz(28), shots=4096, seed=42).measurement_counts
    zeros, ones = counts.get("0" * 28, 0), counts.get("1" * 28, 0)
    assert zeros + ones == 4096 and 0.4 <= zeros / 4096 <= 0.6, counts
    circuit = _brick(28, 8, mix_rz=True)
    plan = tplan.build_group_plan(tprog.compile_circuit(circuit))
    assert all(isinstance(s, (tplan.AxisMatmulStep, tplan.CrossStep))
               for s in plan.steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = Simulator(device="cuda").run(circuit, shots=0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() <= 6.1 * 2**30
    del res
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Trajectory batches: one launch, one operator per trajectory
# ---------------------------------------------------------------------------

def _batch_state(B, shape, planar, device, seed=0):
    return torch.stack([_state(shape, planar, device, seed + b)
                        for b in range(B)])


def _batch_op(B, shape, real, device, seed, shared):
    if shared:
        one = _scaled_op(shape, real, device, seed)
        return one[None].expand((B,) + tuple(one.shape))
    return torch.stack([_scaled_op(shape, real, device, seed + b)
                        for b in range(B)])


def _check_batched(kind, x, op, geom, planar, tol):
    fn = cuda_exec.dense_axis if kind == "dense" else cuda_exec.cross_bit_axis
    twin = (cuda_exec.dense_axis_plain if kind == "dense"
            else cuda_exec.cross_bit_axis_plain)
    geom = geom if isinstance(geom, tuple) else (geom,)
    want = twin(x, op, *geom, planar, True)
    loop = torch.stack([twin(x[b], op[b], *geom, planar)
                        for b in range(x.shape[0])])
    got = fn(x, op, *geom, planar, True)
    torch.cuda.synchronize()
    assert got is x
    torch.testing.assert_close(want, loop, atol=tol, rtol=0)
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [(8, 128), (4, 128, 128), (4, 16, 128)])
@pytest.mark.parametrize("planar,real", VARIANTS)
@pytest.mark.parametrize("shared", [True, False])
def test_batched_dense_matches_twin(cuda, shape, planar, real, shared):
    for axis in range(len(shape)):
        S = shape[axis]
        x = _batch_state(5, shape, planar, cuda, seed=axis)
        op = _batch_op(5, (S, S), real, cuda, 20 + axis, shared)
        _check_batched("dense", x, op, axis, planar, 2e-4)


@pytest.mark.parametrize("shape,s,pos,o", [
    ((8, 128), 1, 0, 0), ((8, 128), 0, 2, 1), ((8, 128), 1, 6, 0),
    ((4, 128, 128), 1, 0, 0), ((4, 128, 128), 1, 6, 2),
    ((4, 128, 128), 2, 6, 1), ((8, 16, 128), 2, 3, 0),
])
@pytest.mark.parametrize("planar,real", [(False, True), (True, False)])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_cross_matches_twin(cuda, shape, s, pos, o, planar, real,
                                    shared):
    S = shape[o]
    x = _batch_state(3, shape, planar, cuda, seed=s + o)
    cop = _batch_op(3, (2, S, 2, S), real, cuda, 40, shared)
    _check_batched("cross", x, cop, (s, pos, o), planar, 2e-3)


@pytest.mark.parametrize("planar,real", VARIANTS)
def test_batched_ragged_tile_per_trajectory(cuda, planar, real):
    """Each trajectory has fewer fibers than a tile: every trajectory's
    tail is masked and no tile reads into the next trajectory."""
    shape = (128, 16)
    g = cuda_exec.dense_geometry(shape, 0, planar, real)
    assert g.n_outer * g.n_mid * g.n_inner < cuda_exec.tile_fibers(128, real)
    x = _batch_state(7, shape, planar, cuda)
    _check_batched("dense", x, _batch_op(7, (128, 128), real, cuda, 60,
                                         False), 0, planar, 2e-4)
    if planar and real:
        return
    x = _batch_state(7, (2, 128), planar, cuda)
    _check_batched("cross", x, _batch_op(7, (2, 128, 2, 128), real, cuda,
                                         70, False), (0, 0, 1), planar, 2e-3)


@pytest.mark.parametrize("planar,real", [(False, True), (True, False)])
def test_batched_shared_operator_equals_full_stride(cuda, planar, real):
    """Op stride 0 (one operator shared) gives bit for bit what the same
    operator copied per trajectory gives."""
    x = _batch_state(4, (4, 128, 128), planar, cuda)
    for kind, shape, geom in (("dense", (128, 128), (2,)),
                              ("cross", (2, 128, 2, 128), (1, 6, 2))):
        fn = (cuda_exec.dense_axis if kind == "dense"
              else cuda_exec.cross_bit_axis)
        shared = _batch_op(4, shape, real, cuda, 80, True)
        assert shared.stride(0) == 0
        a = fn(x.clone(), shared, *geom, planar, True)
        b = fn(x.clone(), shared.contiguous(), *geom, planar, True)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _k256_served(cuda, shape, geom, B=None, shared=True, seed=0):
    """A complex K = 256 cross launch against the plain twin: at most 2x
    the twin's error against float64 (the kernels' 3xTF32 bound). Returns
    how many launches the cluster kernel served."""
    S = shape[geom[2]]
    if B is None:
        x = _state(shape, True, cuda, seed)
        cop = _scaled_op((2, S, 2, S), False, cuda, seed + 1)
    else:
        x = _batch_state(B, shape, True, cuda, seed)
        cop = _batch_op(B, (2, S, 2, S), False, cuda, seed + 1, shared)
    batched = B is not None
    want = cuda_exec.cross_bit_axis_plain(x, cop, *geom, True, batched)
    ref = cuda_exec.cross_bit_axis_plain(x.double(), cop.double(), *geom,
                                         True, batched)
    cuda_exec.reset_launch_counts()
    got = cuda_exec.cross_bit_axis(x.clone(), cop, *geom, True, batched)
    torch.cuda.synchronize()
    err = float((got.double() - ref).abs().max())
    twin = float((want.double() - ref).abs().max())
    assert err <= 2 * twin, (err, twin)
    assert cuda_exec.cross_bit_axis.launches == 1
    return cuda_exec.cross_bit_axis.cluster_launches


@pytest.mark.parametrize("shape,geom,rows", [
    ((4, 128, 128), (1, 6, 2), True),      # rows contiguous
    ((4, 128, 128), (2, 0, 1), False),     # runs of 64 fibers
    ((8, 128, 128), (1, 3, 2), True),
    ((8, 128, 128), (2, 1, 1), False),     # runs of 32 fibers
])
def test_cluster_kernel_matches_twin_in_both_layouts(cuda, shape, geom,
                                                     rows):
    g = cuda_exec.cross_geometry(shape, *geom, True, False)
    assert cuda_exec.copy_plan(g) == (rows, 4)
    assert _k256_served(cuda, shape, geom) == 1


def test_narrow_copies_take_the_streamed_kernel(cuda):
    """Copies narrower than 16 bytes keep a shared complex K = 256
    operator on the streamed kernel."""
    shape, geom = (4, 128, 128), (2, 5, 1)     # runs of 2 fibers: 8 bytes
    g = cuda_exec.cross_geometry(shape, *geom, True, False)
    assert cuda_exec.copy_plan(g) == (False, 2)
    assert _k256_served(cuda, shape, geom) == 0


@pytest.mark.parametrize("shape,geom,B", [
    ((4, 128, 128), (2, 0, 1), 5),   # 80 tiles over the card's clusters
    ((2, 128), (0, 0, 1), 7),        # one fiber a trajectory: ragged tiles
    ((4, 2, 128), (1, 0, 2), 9),     # 4 fibers a trajectory
])
def test_cluster_kernel_ragged_last_cluster(cuda, shape, geom, B):
    """Tile counts that leave the last clusters of the wave with one tile
    fewer, and trajectories with fewer fibers than a tile holds."""
    assert _k256_served(cuda, shape, geom, B) == 1


def test_batched_shared_operator_takes_the_cluster_kernel(cuda):
    assert _k256_served(cuda, (4, 128, 128), (1, 6, 2), B=3,
                        shared=True) == 1


def test_batched_per_trajectory_operators_take_the_streamed_kernel(cuda):
    assert _k256_served(cuda, (4, 128, 128), (1, 6, 2), B=3,
                        shared=False) == 0


def test_batched_launch_is_in_place_and_counted(cuda):
    x = _batch_state(6, (4, 128, 128), True, cuda)
    ptr = x.data_ptr()
    cuda_exec.reset_launch_counts()
    op = _batch_op(6, (128, 128), False, cuda, 90, False)
    cop = _batch_op(6, (2, 128, 2, 128), False, cuda, 91, False)
    assert cuda_exec.dense_axis(x, op, 1, True, True) is x
    assert cuda_exec.cross_bit_axis(x, cop, 1, 6, 2, True, True) is x
    assert x.data_ptr() == ptr
    assert cuda_exec.dense_axis.launches == 1
    assert cuda_exec.cross_bit_axis.launches == 1


def test_noisy_batches_go_through_the_kernels(cuda):
    """Kernel and plain-twin executors on the same draws, for the three
    trajectory bodies; every dense and cross step is one launch."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DepolarizingNoise, NoiseModel,
                                             ThermalRelaxationNoise)

    c = QuantumCircuit.from_dict(build_circuit_dict(12, 6, 5, True))
    p = tprog.compile_circuit(c)
    for ch in (DepolarizingNoise(0.05), AmplitudeDampingNoise(0.05)):
        nm = NoiseModel()
        nm.add_global_noise(ch)
        gen = torch.Generator(device="cuda").manual_seed(1)
        cuda_exec.reset_launch_counts()
        got, draws = tprog.batched_trajectories(p, nm, p.initial_params, 9,
                                                cuda, gen)
        assert cuda_exec.dense_axis.launches > 0
        want, _ = tprog.batched_trajectories(p, nm, p.initial_params, 9,
                                             cuda, draws=draws, plain=True)
        assert float((got - want).abs().max()) <= 1e-5
        norms = got.abs().square().sum(-1)
        assert float((norms - 1).abs().max()) <= 1e-4
    nm = NoiseModel()
    nm.add_global_noise(ThermalRelaxationNoise(30.0, 40.0, 8.0))
    got, draws = tplan.group_trajectory_body(
        p, nm, p.initial_params, 3, cuda,
        torch.Generator(device="cuda").manual_seed(2))
    want, _ = tplan.group_trajectory_body(p, nm, p.initial_params, 3, cuda,
                                          draws=draws, plain=True)
    assert float((got - want).abs().max()) <= 1e-5


class _XDamp(NoiseChannel):
    """Amplitude damping 0.05 conjugated by H: trace preserving, neither
    mixed-unitary nor monomial, so it takes the fold executor."""

    @property
    def probability(self):
        return 0.05

    def get_kraus_operators(self):
        from quantum_simulator_tpu_torch import AmplitudeDampingNoise

        h = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
        return [h @ np.asarray(k) @ h for k in
                AmplitudeDampingNoise(0.05).get_kraus_operators()]


def _route_noise(route):
    """A noise model each trajectory route serves."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DepolarizingNoise)

    if route == "unitary":
        return _global_noise(DepolarizingNoise(0.05))
    if route == "monomial":
        return _global_noise(AmplitudeDampingNoise(0.05))
    return _global_noise(_XDamp())


def _route_body(route):
    from quantum_simulator_tpu_torch.ops import bigtraj
    from quantum_simulator_tpu_torch.ops import monomial_traj as tmono
    from quantum_simulator_tpu_torch.ops import unitary_traj as tunit

    return {"unitary": tunit.unitary_insert_trajectory_body,
            "monomial": tmono.monomial_trajectory_body,
            "fold": bigtraj.fold_trajectory_body,
            "per-gate": tplan.group_trajectory_body}[route]


@pytest.mark.parametrize("route", ["unitary", "monomial", "fold"])
def test_trajectory_batches_launch_each_step_once_a_batch(cuda, route,
                                                          monkeypatch):
    """``trajectory_states`` cut into batches (the memory budget lowered):
    each batch launches its plans' dense and cross steps once, the fold
    body one kernel per gate for the whole batch; norms 1 +- 1e-4; the
    route's body through the kernels within 1e-5 of its twins on the same
    draws; ``run_with_noise`` with readout error returns its shots."""
    from quantum_simulator_tpu_torch import ReadoutError
    from quantum_simulator_tpu_torch import simulator as tsim

    circuit = _brick(12, 6)
    program = tprog.compile_circuit(circuit)
    nm = _route_noise(route)
    assert tprog.trajectory_route(program, nm) == route
    monkeypatch.setattr(tsim, "TRAJECTORY_MEMORY_BYTES", 32 << 20)
    T = 64
    batches = -(-T // tsim._chunk_size(program, nm, T))
    assert batches >= 2
    cuda_exec.reset_launch_counts()
    states = Simulator(noise_model=nm, device="cuda").trajectory_states(
        circuit, T, seed=1)
    torch.cuda.synchronize()
    assert tuple(states.shape) == (T, 1 << 12)
    if route == "fold":
        assert sum(k.launches for k in cuda_exec.KERNELS) == \
            batches * len(program.ops)
    else:
        n_dense, n_cross = _step_counts(*_noisy_plans(program, nm))
        assert cuda_exec.dense_axis.launches == batches * n_dense > 0
        assert cuda_exec.cross_bit_axis.launches == batches * n_cross
    norms = states.abs().square().sum(-1)
    assert float((norms - 1).abs().max()) <= 1e-4
    body = _route_body(route)
    gen = torch.Generator(device="cuda").manual_seed(2)
    got, draws = body(program, nm, program.initial_params, 9, "cuda", gen)
    want, _ = body(program, nm, program.initial_params, 9, "cuda", None,
                   draws, plain=True)
    assert float((got - want).abs().max()) <= 1e-5
    nm.set_readout_error(ReadoutError(0.01, 0.02))
    res = Simulator(noise_model=nm, device="cuda").run_with_noise(
        circuit, shots=1024, seed=3)
    assert sum(res.measurement_counts.values()) == 1024


@pytest.mark.parametrize("channel", ["depolarizing", "amplitude damping",
                                     "two-qubit depolarizing"])
def test_trajectory_ensemble_law_n4(cuda, channel):
    """2000 trajectories drawn on the card: the mean |psi|^2 within 0.05
    of the density matrix's diagonal (the CPU's dense route)."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DensityMatrixSimulator,
                                             DepolarizingNoise, NoiseModel,
                                             TwoQubitDepolarizingNoise)

    nm = NoiseModel()
    if channel == "two-qubit depolarizing":
        nm.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(0.3))
    else:
        nm.add_global_noise(DepolarizingNoise(0.1) if channel ==
                            "depolarizing" else AmplitudeDampingNoise(0.2))
    circuit = _brick(4, 6, mix_rz=True)
    states = Simulator(noise_model=nm, device="cuda").trajectory_states(
        circuit, 2000, seed=42)
    got = states.abs().square().mean(0).double().cpu().numpy()
    want = DensityMatrixSimulator(noise_model=nm, device="cpu").run(
        circuit, method="dense").probabilities
    assert float(np.abs(got - want).max()) <= 0.05


@pytest.mark.parametrize("route", ["unitary", "monomial", "fold", "per-gate",
                                   "monitored"])
def test_complex128_trajectory_routes_card_equal_cpu(cuda, route):
    """Under ``enable_complex128`` each trajectory body (and a monitored
    one) at n = 12 on the card and on the CPU with the card's draws:
    within 1e-12, every launch a float64 one, the outcomes equal."""
    from quantum_simulator_tpu_torch import AmplitudeDampingNoise
    from quantum_simulator_tpu_torch.ops import monomial_traj as tmono

    T = 4
    with _precision("complex128"):
        cuda_exec.reset_launch_counts()
        gen = torch.Generator(device="cuda").manual_seed(42)
        if route == "monitored":
            circuit = _monitored_brickwork(12, 6)
            program = tprog.compile_circuit(circuit)
            args = (program, _global_noise(AmplitudeDampingNoise(0.05)),
                    _monitored_events(circuit), program.initial_params, T)
            states, outs, draws = tmono.monomial_monitored_body(
                *args, "cuda", gen)
            cpu, cpu_outs, _ = tmono.monomial_monitored_body(
                *args, "cpu", None, _to_device(draws, "cpu"))
            assert torch.equal(outs.cpu(), cpu_outs)
        else:
            program = tprog.compile_circuit(_brick(12, 6, mix_rz=True))
            nm = _route_noise(route)
            if route != "per-gate":
                assert tprog.trajectory_route(program, nm) == route
            args = (program, nm, program.initial_params, T)
            states, draws = _route_body(route)(*args, "cuda", gen)
            cpu, _ = _route_body(route)(*args, "cpu", None,
                                        _to_device(draws, "cpu"))
        torch.cuda.synchronize()
    dense, cross, f32 = _launches(True)
    assert f32 == 0 and dense + cross > 0
    assert states.dtype == torch.complex128
    assert float((states.cpu() - cpu).abs().max()) <= 1e-12


def _to_device(draws, device):
    """A body's draws (a tensor, or lists and tuples of them) on
    ``device``."""
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    return type(draws)(_to_device(d, device) for d in draws)


def _monitored_brickwork(n, depth, seed=42):
    """Ry+CNOT brickwork with a ``Measure`` on every fourth qubit after
    each second layer; the first measurement of qubit 0 is repeated at
    once, with no gate between."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        if layer % 2 == 0:
            for q in range(n):
                c.add("Ry", [q], [float(rng.uniform(0, 2 * np.pi))], col)
        else:
            for q in range((layer // 2) % 2, n - 1, 2):
                c.add("CNOT", [q, q + 1], [], col)
            col += 1
            for q in range(0, n, 4):
                c.add("Measure", [q], [], col)
            if layer == 1:
                col += 1
                c.add("Measure", [0], [], col)
        col += 1
    return c


def _monitored_events(circuit):
    """``(op_position, qubit)`` of every ``Measure``, as
    ``Simulator.monitored_trajectories`` derives them."""
    events, pos = [], 0
    for column in circuit.get_ordered_gates():
        for g in column:
            if g.gate_name == "Measure":
                events.append((pos, g.target_qubits[0]))
            else:
                pos += 1
    return tuple(events)


# ---------------------------------------------------------------------------
# Parameter batches: the variational path
# ---------------------------------------------------------------------------

def _variational(kind):
    """(circuit, cost): a real plan (Ry + CNOT) or a planar one (QAOA)."""
    from quantum_simulator_tpu_torch import models
    from quantum_simulator_tpu_torch import optimizer as topt

    if kind == "real":
        return (models.hardware_efficient_ansatz(12, 2),
                topt.CostFunction.vqe_hamiltonian(
                    models.heisenberg_chain(12)))
    edges = models.maxcut_edges_ring(10)
    return (models.qaoa_maxcut_ansatz(10, 2, edges),
            topt.CostFunction.qaoa_maxcut(edges))


def _step_counts(*plans):
    """(dense, cross) steps of the plans together."""
    steps = [s for p in plans for s in p.steps]
    return (sum(isinstance(s, tplan.AxisMatmulStep) for s in steps),
            sum(isinstance(s, tplan.CrossStep) for s in steps))


@pytest.mark.parametrize("kind", ["real", "planar"])
def test_parameter_batch_goes_through_the_kernels(cuda, kind):
    """One batch of parameter rows: each dense and cross step is one
    launch, and the states equal the twins' and the per-gate body's."""
    circuit, _ = _variational(kind)
    p = tprog.compile_circuit(circuit)
    plan = tplan.get_group_plan(p)
    assert plan.all_real == (kind == "real")
    rng = np.random.default_rng(5)
    params = torch.from_numpy(rng.uniform(
        -np.pi, np.pi, (6, p.num_params)).astype(np.float32)).to(cuda)
    want = tplan.group_batched_forward(p, params, cuda, plain=True)
    cuda_exec.reset_launch_counts()
    got = tplan.group_batched_forward(p, params, cuda)
    torch.cuda.synchronize()
    n_dense, n_cross = _step_counts(plan)
    assert cuda_exec.dense_axis.launches == n_dense > 0
    assert cuda_exec.cross_bit_axis.launches == n_cross > 0
    assert got.shape == (6, 1 << p.num_qubits)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, tprog.forward_body(p, params),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["real", "planar"])
def test_gradients_on_cuda(cuda, kind):
    """Parameter shift through the kernels launches the plan's steps once
    per batch and matches the twins' costs (1e-4), which launch nothing;
    autodiff on the card matches it (1e-3)."""
    from quantum_simulator_tpu_torch import optimizer as topt
    from quantum_simulator_tpu_torch import simulator as tsim

    circuit, cost = _variational(kind)
    cfg = topt.ParameterizedCircuitConfig.auto_detect(circuit)
    program, offsets = cfg.compiled()
    values = np.random.default_rng(6).uniform(-np.pi, np.pi, cfg.num_params)
    rows = 2 * cfg.num_params
    batches = -(-rows // tsim.param_rows_per_batch(program, rows))
    cuda_exec.reset_launch_counts()
    grad = topt.GradientEstimator.parameter_shift(cfg, cost, values,
                                                  device="cuda")
    n_dense, n_cross = _step_counts(tplan.get_group_plan(program))
    assert cuda_exec.dense_axis.launches == n_dense * batches
    assert cuda_exec.cross_bit_axis.launches == n_cross * batches
    costs = topt._device_costs(program, cost, offsets,
                               topt._shift_matrix(values, np.pi / 2), "cuda",
                               plain=True)
    assert cuda_exec.dense_axis.launches == n_dense * batches   # the twins
    assert cuda_exec.cross_bit_axis.launches == n_cross * batches
    plain = (costs[:cfg.num_params] - costs[cfg.num_params:]) / 2.0
    np.testing.assert_allclose(grad, plain, atol=1e-4)
    _, ad = topt.GradientEstimator.autodiff(cfg, cost, values, device="cuda")
    np.testing.assert_allclose(ad, grad, atol=1e-3)


@pytest.mark.parametrize("kind", ["real", "planar"])
def test_optimizer_and_multi_start_on_cuda(cuda, kind):
    """``CircuitOptimizer.run`` (3 parameter-shift iterations) launches per
    iteration its gradient's batches and one cost row's, and never rises
    above its first cost; ``multi_start`` ends at or below the mean of its
    starts' first costs."""
    from quantum_simulator_tpu_torch import optimizer as topt
    from quantum_simulator_tpu_torch import simulator as tsim

    circuit, cost = _variational(kind)
    cfg = topt.ParameterizedCircuitConfig.auto_detect(circuit)
    program, _ = cfg.compiled()
    values = np.random.default_rng(7).uniform(-np.pi, np.pi, cfg.num_params)
    rows = 2 * cfg.num_params
    batches = -(-rows // tsim.param_rows_per_batch(program, rows)) + 1
    start = topt.ParameterizedCircuitConfig.auto_detect(
        cfg.bind_values(values))
    opt = topt.CircuitOptimizer(start, cost, max_iterations=3,
                                gradient_method="parameter_shift",
                                device="cuda")
    cuda_exec.reset_launch_counts()
    res = opt.run(seed=42)
    n_dense, n_cross = _step_counts(tplan.get_group_plan(program))
    assert res.iterations == 3
    assert cuda_exec.dense_axis.launches == 3 * batches * n_dense
    assert cuda_exec.cross_bit_axis.launches == 3 * batches * n_cross
    costs = [c for _, c in res.history]
    assert all(c <= costs[0] for c in costs), costs
    ms = topt.CircuitOptimizer.multi_start(cfg, cost, n_starts=4,
                                           max_iterations=10, seed=42,
                                           device="cuda")
    assert ms.cost_histories.shape == (4, 10)
    assert ms.optimal_cost <= float(ms.cost_histories[:, 0].mean())


# ---------------------------------------------------------------------------
# Large states (n >= 30)
# ---------------------------------------------------------------------------

def _x_rotated(circuit):
    """The circuit ``Simulator.run`` samples for the X basis at n >= 30."""
    rotated = circuit.copy()
    col = rotated.get_column_count()
    for q in range(circuit.num_qubits):
        rotated.add("H", [q], [], col)
    return rotated


@pytest.mark.parametrize("precision,basis", [
    ("complex64", "Z"), ("complex64", "X"), ("complex128", "Z"),
    ("complex128", "X")])
def test_simulator_run_n30_holds_under_two_states(cuda, precision, basis):
    """``Simulator.run`` at n = 30 returns the executor's planar state as
    it is: its peak stays under 1.75x the state, 8 GiB in float32 and
    16 GiB in float64 under ``enable_complex128`` (a complex copy, a full
    probability vector or a 2^n histogram would each break that). Each
    dense and cross step is one launch (in the X basis the rotated
    circuit's too). In the Z basis the complex64 state equals the
    plain-twin executor's within 1e-5, and the float64 one's per-axis
    marginals the complex64 run's within 1e-5 (the float64 twin executor
    holds more than the card: five 16 GiB states)."""
    from quantum_simulator_tpu_torch import MeasurementBasis, PlanarStateVector

    circuit = QuantumCircuit.from_dict(
        build_circuit_dict(30, 4, seed=1, mix_rz=True))
    program = tprog.compile_circuit(circuit)
    plan = tplan.get_group_plan(program)
    assert not plan.all_real
    plans = [plan] + ([tplan.get_group_plan(tprog.compile_circuit(
        _x_rotated(circuit)))] if basis == "X" else [])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    with _precision(precision) as wide:
        res = Simulator(device="cuda").run(
            circuit, shots=4096, seed=0,
            measurement_basis=getattr(MeasurementBasis, basis))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = _launches(wide)
        fs = res.final_state
        assert isinstance(fs, PlanarStateVector) and fs.is_planar
        assert fs.state_data.dtype == (torch.float64 if wide
                                       else torch.float32)
        size = (16 if wide else 8) << 30
        assert peak < 1.75 * size, peak / 2**30
        assert sum(res.measurement_counts.values()) == 4096
        assert abs(fs.norm_sq() - 1.0) < (1e-12 if wide else 1e-4)
        del res
        if basis == "Z" and wide:
            marginals = fs._get_marginals()
        elif basis == "Z":
            want, _ = tplan.group_forward_state_body(
                program, program.initial_params, "cuda", plain=True)
            assert _grouped_max_diff(fs.state_data, want) <= 1e-5
            del want
        del fs
        torch.cuda.empty_cache()
    assert launches == (*_step_counts(*plans), 0)
    if basis == "Z" and wide:
        fs = Simulator(device="cuda").run(circuit, shots=0).final_state
        m64 = fs._get_marginals()
        del fs
        torch.cuda.empty_cache()
        assert max(np.abs(a - b).max() for a, b in zip(marginals, m64)) \
            <= 1e-5


def test_sampler_returns_indices_beyond_int32(cuda):
    """A real n = 32 state (2^32 amplitudes, 16 GiB) whose weight sits in
    the upper half: every drawn index is above 2^31 - 1, lands on a
    weighted entry, and follows the weights."""
    from quantum_simulator_tpu_torch.ops import bigstate

    shape = (16, 128, 128, 128, 128)
    x = torch.zeros(shape, device=cuda)
    flat = x.reshape(-1)
    marks = torch.tensor([2**31, 2**31 + 12345, 3 * 2**30 + 7, 2**32 - 1],
                         device=cuda)
    flat[marks] = torch.tensor([1.0, -2.0, 0.5, 1.5], device=cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    idx = bigstate.sample_state_indices(x, 20000, False, gen)
    assert idx.dtype == torch.int64
    assert int(idx.min()) >= 2**31
    vals, counts = torch.unique(idx, return_counts=True)
    assert vals.tolist() == marks.tolist()
    want = torch.tensor([1.0, 4.0, 0.25, 2.25]) / 7.5
    assert float((counts.cpu() / 20000 - want).abs().max()) < 0.02
    assert bigstate.indices_to_counts(idx[:1], 32).popitem()[0][0] == "1"


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_ghz_30_strings_and_steps_on_the_large_state_path(cuda, precision):
    """GHZ-30's Z and Pauli strings take their values within 1e-5 (1e-12
    in float64), summed over 2^30 amplitudes; ``run_step_by_step`` at
    n = 30 yields marginal summaries (float64 marginals under
    ``enable_complex128``), the last one's qubit probabilities equal to the
    final state's."""
    from quantum_simulator_tpu_torch import MarginalStateSummary

    n, last = 30, 29
    with _precision(precision) as wide:
        tol = 1e-12 if wide else 1e-5
        fs = Simulator(device="cuda").run(_ghz(n), shots=0).final_state
        strings = [(fs.expectation_z(0), 0.0),
                   (fs.expectation_z_string([3, 4]), 1.0),
                   (fs.expectation_z_string([0, last]), 1.0),
                   (fs.expectation_z_string([0, 5, last]), 0.0),
                   (fs.expectation_pauli_string([0, 1], "XX"), 0.0),
                   (fs.expectation_pauli_string(list(range(n)), "X" * n),
                    1.0),
                   (fs.expectation_pauli_string(list(range(n)),
                                                "YY" + "X" * (n - 2)), -1.0)]
        del fs
        torch.cuda.empty_cache()
        circuit = _brick(n, 4, mix_rz=True)
        final = Simulator(device="cuda").run(circuit, shots=0).final_state
        qp = final.qubit_probabilities()
        del final
        torch.cuda.empty_cache()
        steps = list(Simulator(device="cuda").run_step_by_step(circuit))
    assert all(abs(got - want) <= tol for got, want in strings), strings
    assert [c for _, c in steps] == list(range(-1, 4))
    assert all(isinstance(s, MarginalStateSummary) for s, _ in steps)
    assert not wide or all(s.axis_marginals[0].dtype == torch.float64
                           for s, _ in steps)
    assert np.abs(steps[-1][0].qubit_probabilities() - qp).max() <= tol
    del steps
    torch.cuda.empty_cache()


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_qft_30_from_zero_is_flat_under_two_states(cuda, precision):
    """QFT-30 from |0..0> (pair diagonals and swaps in place): one launch
    per dense and cross step, 4096 shots, 2^n |a|^2 within 1e-3 of 1
    (1e-12 in float64), the peak under 1.75x the state."""
    circuit = _qft(30)
    plan = tplan.get_group_plan(tprog.compile_circuit(circuit))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    with _precision(precision) as wide:
        res = Simulator(device="cuda").run(circuit, shots=4096, seed=42)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = _launches(wide)
        p = res.final_state.probabilities_device
        dev = max(float((p[s:s + tplan.CHUNK_ELEMS] * 2.0 ** 30 - 1.0)
                        .abs().max())
                  for s in range(0, p.numel(), tplan.CHUNK_ELEMS))
        shots = sum(res.measurement_counts.values())
        del p, res
        torch.cuda.empty_cache()
    assert launches == (*_step_counts(plan), 0)
    assert peak < 1.75 * ((16 if wide else 8) << 30), peak / 2**30
    assert dev <= (1e-12 if wide else 1e-3), dev
    assert shots == 4096


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_fold_trajectory_n30_launches_one_kernel_per_gate(cuda, precision):
    """One fold-executor trajectory at n = 30 (a channel that is neither
    mixed-unitary nor monomial): every gate with its draws is one launch,
    on one real state of 4 GiB (8 GiB in float64 under
    ``enable_complex128``, every launch a float64 one)."""
    from quantum_simulator_tpu_torch import config
    from quantum_simulator_tpu_torch.ops import bigtraj

    nm = _route_noise("fold")
    program = tprog.compile_circuit(
        QuantumCircuit.from_dict(build_circuit_dict(30, 2, seed=2)))
    assert bigtraj.trajectory_evolve_route(program, nm) == "fold"
    wide = precision == "complex128"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    if wide:
        config.enable_complex128()
    try:
        x, planar, draws = bigtraj.huge_trajectory_state_body(
            program, nm, program.initial_params, 1, "cuda", gen)
        torch.cuda.synchronize()
    finally:
        config.enable_complex64()
    kernels = cuda_exec.KERNELS_F64 if wide else cuda_exec.KERNELS
    assert sum(k.launches for k in kernels) == len(program.ops)
    assert sum(k.launches for k in cuda_exec.KERNELS + cuda_exec.KERNELS_F64
               ) == len(program.ops)
    assert not planar and tuple(x.shape) == (1, 4, 128, 128, 128, 128)
    assert x.dtype == (torch.float64 if wide else torch.float32)
    size = (8 if wide else 4) << 30
    assert torch.cuda.max_memory_allocated() < 1.75 * size
    assert abs(float(bigtraj.batched_norm_sq(x)[0]) - 1.0) < \
        (1e-12 if wide else 1e-4)
    # one draw per gate target (one one-qubit channel on every gate)
    assert draws.shape == (1, sum(len(op.targets) for op in program.ops))


def _state_bytes(n, planar, wide):
    return (2 if planar else 1) * (8 if wide else 4) << n


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
@pytest.mark.parametrize("route", ["unitary", "monomial", "fold"])
def test_trajectory_n30_routes_match_their_twins(cuda, route, precision):
    """One noisy ``Simulator.run`` trajectory at n = 30 on each evolution
    route: a grouped final state of norm 1, the shots, one launch per
    dense and cross step of the spliced plans (one per gate on the fold
    route), all in the mode's precision; then one trajectory through the
    kernels against the twins on the same draws, 1e-5 (1e-12 in
    float64)."""
    from quantum_simulator_tpu_torch import PlanarStateVector
    from quantum_simulator_tpu_torch.ops import bigtraj

    circuit = _brick(30, 4)
    program = tprog.compile_circuit(circuit)
    nm = _route_noise(route)
    assert bigtraj.trajectory_evolve_route(program, nm) == route
    planar = not bigtraj.trajectory_is_real(program, nm)
    torch.cuda.empty_cache()
    cuda_exec.reset_launch_counts()
    with _precision(precision) as wide:
        res = Simulator(noise_model=nm, device="cuda").run(
            circuit, shots=1024, seed=42)
        torch.cuda.synchronize()
        dense, cross, other = _launches(wide)
        fs = res.final_state
        assert isinstance(fs, PlanarStateVector) and fs.is_planar == planar
        assert abs(fs.norm_sq() - 1.0) <= (1e-12 if wide else 1e-4)
        assert sum(res.measurement_counts.values()) == 1024
        del res, fs
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(42)
        x, _, draws = bigtraj.huge_trajectory_state_body(
            program, nm, program.initial_params, 1, "cuda", gen)
        want, _, _ = bigtraj.huge_trajectory_state_body(
            program, nm, program.initial_params, 1, "cuda", None, draws,
            plain=True)
        assert x.dtype == (torch.float64 if wide else torch.float32)
        err = _grouped_max_diff(x, want)
        del x, want, draws
        torch.cuda.empty_cache()
    assert other == 0
    if route == "fold":
        assert dense + cross == len(program.ops)
    else:
        assert (dense, cross) == _step_counts(*_noisy_plans(program, nm))
    assert err <= (1e-12 if wide else 1e-5), err


def test_run_with_noise_and_ensemble_n30(cuda):
    """n = 30 with depolarizing noise: ``run_with_noise`` spreads 256 shots
    over 4 trajectories and ``ensemble_qubit_density_matrices`` averages 2,
    each trajectory one launch per step of the spliced plan; the
    one-qubit density matrices Hermitian with trace 1 +- 1e-4."""
    circuit = _brick(30, 4)
    program = tprog.compile_circuit(circuit)
    nm = _route_noise("unitary")
    n_dense, n_cross = _step_counts(_noisy_plans(program, nm)[0])
    sim = Simulator(noise_model=nm, device="cuda")
    torch.cuda.empty_cache()
    cuda_exec.reset_launch_counts()
    res = sim.run_with_noise(circuit, shots=256, seed=42, trajectories=4)
    assert res.final_state is None
    assert sum(res.measurement_counts.values()) == 256
    assert _launches(False) == (4 * n_dense, 4 * n_cross, 0)
    cuda_exec.reset_launch_counts()
    rhos = sim.ensemble_qubit_density_matrices(circuit, n_trials=2, seed=42)
    assert _launches(False) == (2 * n_dense, 2 * n_cross, 0)
    assert rhos.shape == (30, 2, 2)
    assert np.abs(np.trace(rhos, axis1=1, axis2=2) - 1.0).max() <= 1e-4
    assert np.abs(rhos - rhos.conj().transpose(0, 2, 1)).max() <= 1e-6


@pytest.mark.parametrize("n,T,final_shots,precision", [
    (20, 64, None, "complex64"), (30, 2, 256, "complex64"),
    (30, 2, 256, "complex128")])
def test_monitored_trajectories_on_the_card(cuda, n, T, final_shots,
                                            precision):
    """``Simulator.monitored_trajectories`` on a brickwork measured every
    second layer: outcomes in {0, 1}, a measurement repeated at once gives
    the same bit, each batch one launch per step of the segment plans (at
    n = 20 all T trajectories in one batch, of norm 1; at n = 30 one at a
    time with their final shots, the peak under 1.75x the state); at
    n = 30 the kernels against the twins replayed on the same draws, 1e-5
    (1e-12 in float64), the outcomes equal."""
    from quantum_simulator_tpu_torch.ops import monomial_traj as tmono

    mc = _monitored_brickwork(n, 4)
    program = tprog.compile_circuit(mc)
    events = _monitored_events(mc)
    spec = tmono.monomial_spec(program, tprog._NoNoise, events)
    n_dense, n_cross = _step_counts(*map(tplan.get_group_plan,
                                         spec.segments))
    batches = 1 if final_shots is None else T
    repeat = len(range(0, n, 4))      # slot of the repeated measurement
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    with _precision(precision) as wide:
        outcomes, sites, third = Simulator(
            device="cuda").monitored_trajectories(mc, T, seed=42,
                                                  final_shots=final_shots)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        assert _launches(wide) == (batches * n_dense, batches * n_cross, 0)
        if final_shots is None:
            assert len(third) == T
            assert all(abs(float(s.device_data.abs().square().sum()) - 1.0)
                       <= 1e-4 for s in third[:4])
        else:
            assert all(sum(d.values()) == final_shots for d in third)
            assert peak < 1.75 * _state_bytes(n, not spec.real, wide)
            del third
            layout = tplan.GroupLayout.for_qubits(n)
            gen = torch.Generator(device="cuda").manual_seed(42)
            x = tplan.layout_basis_state(layout, program.initial_index,
                                         "cuda", not spec.real, 1)
            x, outs, record = tmono.monomial_monitored_evolve(
                program, tprog._NoNoise, events, program.initial_params, x,
                gen)
            x0 = tplan.layout_basis_state(layout, program.initial_index,
                                          "cuda", not spec.real, 1)
            ref, ref_outs, _ = tmono.monomial_monitored_evolve(
                program, tprog._NoNoise, events, program.initial_params, x0,
                None, record, plain=True)
            assert torch.equal(outs, ref_outs)
            assert _grouped_max_diff(x, ref) <= (1e-12 if wide else 1e-5)
            del x, x0, ref
            torch.cuda.empty_cache()
    assert outcomes.shape == (T, len(events)) and len(sites) == len(events)
    assert set(np.unique(outcomes)) <= {0, 1}
    assert sites[0][1] == 0 and sites[repeat][1] == 0
    assert (outcomes[:, 0] == outcomes[:, repeat]).all()


def test_monitored_law_n4(cuda):
    """Ry on every qubit, measure 0, CNOT(0, 1), measure 1: over 4000
    trajectories on the card the outcome frequencies within 0.05 of the
    exact ones."""
    theta = [0.9, 2.1, 0.4, 1.3]
    c = QuantumCircuit(4)
    for q, t in enumerate(theta):
        c.add("Ry", [q], [t], 0)
    c.add("Measure", [0], [], 1)
    c.add("CNOT", [0, 1], [], 2)
    c.add("Measure", [1], [], 3)
    a, b = np.sin(theta[0] / 2) ** 2, np.sin(theta[1] / 2) ** 2
    outcomes, _, _ = Simulator(device="cuda").monitored_trajectories(
        c, 4000, seed=42)
    want = np.array([a, a * (1 - b) + (1 - a) * b])
    assert np.abs(outcomes.mean(axis=0) - want).max() <= 0.05


# ---------------------------------------------------------------------------
# The exact open-system path (density matrices, Lindblad)
# ---------------------------------------------------------------------------

def _open_noise():
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DepolarizingNoise, NoiseModel)

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nm.add_gate_noise("CNOT", AmplitudeDampingNoise(0.05))
    return nm


@pytest.mark.parametrize("mix_rz,noisy", [(False, True), (True, True),
                                          (True, False)])
def test_superop_program_goes_through_the_kernels(cuda, mix_rz, noisy):
    """vec(rho) at 2n = 24 through ``DensityMatrixSimulator``: one launch
    per dense and cross step of the vec(rho) plan, within 1e-5 of the
    twin executor and 2e-5 of the dense route; mixed with noise, pure
    (1 +- 1e-4) without."""
    from quantum_simulator_tpu_torch import DensityMatrixSimulator
    from quantum_simulator_tpu_torch.density import superop_program

    circuit = QuantumCircuit.from_dict(
        build_circuit_dict(12, 4, seed=3, mix_rz=mix_rz))
    nm = _open_noise() if noisy else None
    program2 = superop_program(tprog.compile_circuit(circuit), nm)
    plan = tplan.get_group_plan(program2)
    assert plan.all_real == (not mix_rz)
    sim = DensityMatrixSimulator(noise_model=nm, device="cuda")
    cuda_exec.reset_launch_counts()
    res = sim.run(circuit, method="superop")
    n_dense = sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps)
    n_cross = sum(isinstance(s, tplan.CrossStep) for s in plan.steps)
    assert cuda_exec.dense_axis.launches == n_dense
    assert cuda_exec.cross_bit_axis.launches == n_cross
    want = tplan.group_forward_body(program2, program2.initial_params,
                                    "cuda", plain=True)
    assert float((res.device_rho.reshape(-1) - want).abs().max()) <= 1e-5
    dense = sim.run(circuit, method="dense")
    assert float((res.device_rho - dense.device_rho).abs().max()) <= 2e-5
    assert abs(res.trace() - 1.0) <= 1e-4
    if noisy:
        assert res.purity() < 0.999
    else:
        assert abs(res.purity() - 1.0) <= 1e-4


@pytest.mark.parametrize("precision,noisy", [
    ("complex64", True), ("complex64", False), ("complex128", True)])
def test_superop_n15_is_a_grouped_state_under_two_states(cuda, precision,
                                                         noisy):
    """n = 15: vec(rho) is a 30-qubit real grouped state (4 GiB; 8 GiB in
    float64) that is never copied, its peak under 1.75x; ``.rho`` raises.
    With noise its <Z_q> lie within 0.05 of the mean over 2000
    trajectories, and under ``enable_complex128`` its trace is 1 +- 1e-12
    and its diagonal and purity within 1e-5 of the complex64 run's;
    without noise it is pure and its diagonal is ``Simulator.run``'s
    within 1e-5."""
    from quantum_simulator_tpu_torch import DensityMatrixSimulator
    from quantum_simulator_tpu_torch.density import SuperopDensityResult

    n = 15
    circuit = QuantumCircuit.from_dict(build_circuit_dict(n, 4, seed=4))
    nm = _open_noise() if noisy else None
    sim = DensityMatrixSimulator(noise_model=nm, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _precision(precision) as wide:
        res = sim.run(circuit)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        assert isinstance(res, SuperopDensityResult) and not res.is_planar
        assert res.state_data.dtype == (torch.float64 if wide
                                        else torch.float32)
        with pytest.raises(MemoryError):
            res.rho
        trace, purity, diag = res.trace(), res.purity(), res.probabilities
        z = np.array([res.expectation_z(q) for q in range(n)])
        counts = sim.sample(res, 1000, rng=np.random.default_rng(0))
        del res
        torch.cuda.empty_cache()
    assert peak < 1.75 * _state_bytes(2 * n, False, wide)
    assert abs(trace - 1.0) <= (1e-12 if wide else 1e-4)
    assert sum(counts.values()) == 1000
    if not noisy:
        assert abs(purity - 1.0) <= 1e-4
        psi = Simulator(device="cuda").run(circuit, shots=0).final_state
        assert np.abs(diag - psi.probabilities).max() <= 1e-5
    elif wide:
        r64 = sim.run(circuit)
        assert np.abs(diag - r64.probabilities).max() <= 1e-5
        assert abs(purity - r64.purity()) <= 1e-5
    else:
        assert 0.0 < purity < 0.999
        states = Simulator(noise_model=nm, device="cuda").trajectory_states(
            circuit, 2000, seed=42)
        p = states.abs().square().double().mean(0).cpu().numpy()
        del states
        bits = (np.arange(1 << n)[:, None] >> (n - 1 - np.arange(n))) & 1
        assert np.abs(z - p @ (1.0 - 2.0 * bits)).max() <= 0.05


def test_lindblad_step_on_cuda(cuda):
    """One qubit's decay among 8 on the card against exp(-gamma t)."""
    from quantum_simulator_tpu_torch import LindbladSimulator

    n, gamma = 8, 0.7
    psi = np.zeros(1 << n, np.complex128)
    psi[1 << (n - 1)] = 1.0
    out = LindbladSimulator(n, [(0.3, "ZZ", [0, 1])],
                            [(gamma, "sigma_minus", 0)],
                            device="cuda").evolve(
        1.0, 20, initial=psi, observables=[("Z", [0])], record_every=5)
    assert out.final.device_rho.is_cuda
    want = 1.0 - 2.0 * np.exp(-gamma * out.times)
    assert np.abs(out.expectations[0] - want).max() <= 1e-3
    assert abs(out.final.trace() - 1.0) <= 1e-4


# ---------------------------------------------------------------------------
# The analysis layer: debugger, quantum volume, shadows
# ---------------------------------------------------------------------------

def _depol(p):
    from quantum_simulator_tpu_torch import DepolarizingNoise, NoiseModel

    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(p))
    return nm


def test_debugger_noisy_stack_kernels_match_twins(cuda):
    """The column stack of noisy trials at n = 16 (per-gate body, one
    operator per trial for every draw) through the kernels and through
    the twins on the same draws, in every snapshot."""
    c = QuantumCircuit.from_dict(build_circuit_dict(16, 8, 42, False))
    p = tprog.compile_circuit(c)
    nm = _depol(0.01)
    u = tplan.draw_uniforms(p, nm, 6, cuda,
                            torch.Generator(device="cuda").manual_seed(3))
    cuda_exec.reset_launch_counts()
    got, draws = tplan.group_trajectory_body(
        p, nm, p.initial_params, 6, cuda, record_columns=True, uniforms=u)
    assert cuda_exec.dense_axis.launches > 0
    assert cuda_exec.cross_bit_axis.launches > 0
    want, _ = tplan.group_trajectory_body(
        p, nm, p.initial_params, 6, cuda, draws=draws, record_columns=True,
        plain=True)
    assert got.shape == (6, p.num_columns + 1, 1 << 16)
    assert float((got - want).abs().max()) <= 1e-5
    norms = got.abs().square().sum(-1)
    assert float((norms - 1).abs().max()) <= 1e-4


def test_qv_chunk_with_param_rows_and_splice_kernels_match_twins(cuda):
    """One quantum-volume chunk at width 16: a (B, P) parameter batch with
    unitary-splice draws through the kernels and the twins on the same
    draws, states and heavy-output values."""
    from quantum_simulator_tpu_torch import analysis as tan

    p = tprog.compile_circuit(tan.qv_model_circuit(16))
    nm = _depol(0.002)
    rows = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 2 * np.pi, (4, p.num_params)).astype(np.float32)).to(cuda)
    gen = torch.Generator(device="cuda").manual_seed(8)
    cuda_exec.reset_launch_counts()
    states, draws = tan.noisy_param_rows(p, nm, rows, cuda, gen)
    assert cuda_exec.dense_axis.launches > 0
    assert cuda_exec.cross_bit_axis.launches > 0
    want, _ = tan.noisy_param_rows(p, nm, rows, cuda, draws=draws,
                                   plain=True)
    assert float((states - want).abs().max()) <= 1e-5
    hi, hn, d = tan.heavy_output_chunk(p, nm, rows, cuda, 1, gen)
    hi2, hn2, _ = tan.heavy_output_chunk(p, nm, rows, cuda, 1, draws=d,
                                         plain=True)
    assert float((hn - hn2).abs().max()) <= 1e-5
    assert float((hi - hi2).abs().max()) <= 1e-5


def test_shadows_basis_layer_n20_kernels_match_twins(cuda):
    from quantum_simulator_tpu_torch import shadows as tsh

    n = 20
    rng = np.random.default_rng(9)
    psi = torch.from_numpy((rng.standard_normal(1 << n)
                            + 1j * rng.standard_normal(1 << n)).astype(
                                np.complex64)).to(cuda)
    psi = psi / psi.abs().square().sum().sqrt()
    bases = rng.integers(0, 3, size=(128, n)).astype(np.int8)
    want = tsh.rotate_snapshots(psi, n, bases, plain=True)
    cuda_exec.reset_launch_counts()
    got = tsh.rotate_snapshots(psi, n, bases)
    torch.cuda.synchronize()
    layout = tplan.GroupLayout.for_qubits(n)
    assert cuda_exec.dense_axis.launches == len(layout.axis_sizes)
    assert float((got - want).abs().max()) <= 1e-5
    bits = tsh.sample_rotated(got, n, torch.Generator(device="cuda"))
    assert bits.shape == (128, n) and set(np.unique(bits)) <= {0, 1}


def test_chunked_attribution_peak_n20(cuda, monkeypatch):
    """The trials' reduction at n = 20 runs batch by batch: with the
    budget cut to 512 MiB, 64 trials of a depth-4 brickwork take ten
    batches and the peak stays within one batch's reckoning plus 1 GiB
    (1.5 GiB); the whole stack alone would be 2.5 GiB."""
    from quantum_simulator_tpu_torch import simulator as tsim
    from quantum_simulator_tpu_torch.debugger import CircuitDebugger

    monkeypatch.setattr(tsim, "TRAJECTORY_MEMORY_BYTES", 512 << 20)
    c = QuantumCircuit.from_dict(build_circuit_dict(20, 4, 42, False))
    p = tprog.compile_circuit(c)
    chunk = tsim.record_rows_per_batch(p, 64)
    assert -(-64 // chunk) >= 3
    dbg = CircuitDebugger(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fids, pq = dbg._trial_reductions(c, _depol(0.01), 64, seed=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per = (p.num_columns + 5) * (8 << 20)
    assert peak <= chunk * per + (1 << 30), (peak, chunk, per)
    assert peak < 64 * (p.num_columns + 1) * (8 << 20)
    assert fids.shape == (64, p.num_columns + 1)
    assert pq.shape == (p.num_columns, 20)
    assert np.all((fids >= 0) & (fids <= 1 + 1e-5))


# --- the bit engines: the card against the CPU on the same draws ----------

def _clifford_circuit(n, depth, seed, measure=False):
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add(str(rng.choice(["H", "S", "S_DAG", "X", "Y", "Z"])), [q],
                  [], col)
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add(str(rng.choice(["CNOT", "CZ", "SWAP"])), [q, q + 1], [],
                  col)
        col += 1
        if measure:
            c.add("Measure", [int(rng.integers(n))], [], col)
            col += 1
    return c


def _rows(shape, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=gen).to(device)


def test_clifford_sampler_card_equals_cpu(cuda):
    from quantum_simulator_tpu_torch import clifford
    from quantum_simulator_tpu_torch.noise import (DepolarizingNoise,
                                                   NoiseModel,
                                                   TwoQubitDepolarizingNoise)
    c = _clifford_circuit(20, 8, 1)
    card, cpu = (clifford.CliffordSimulator(device=d)
                 for d in ("cuda", "cpu"))
    gen = torch.Generator().manual_seed(2)
    rb = torch.randint(0, 2, (512, 20), generator=gen, dtype=torch.int8)
    counts_g, tab_g = card.run(c, 512, rand_bits=rb.cuda())
    counts_c, tab_c = cpu.run(c, 512, rand_bits=rb)
    assert counts_g == counts_c
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tab_g, tab_c))
    cm = _clifford_circuit(24, 8, 3, measure=True)
    L = clifford.compile_clifford_monitored(cm)[0].schedule_length
    u = _rows((64, L), 4)
    og, _, tg = card.monitored_trajectories(cm, uniforms=u.cuda(),
                                            feedforward=[(0, "Y", 1)])
    oc, _, tc = cpu.monitored_trajectories(cm, uniforms=u,
                                           feedforward=[(0, "Y", 1)])
    assert np.array_equal(og, oc)
    assert all(torch.equal(a.cpu(), b) for t1, t2 in zip(tg, tc)
               for a, b in zip(t1, t2))
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nm.add_gate_noise("CNOT", TwoQubitDepolarizingNoise(0.05))
    L = len(clifford._lower(c, noise_model=nm)[0])
    u = _rows((256, L), 5)
    rb = rb[:256]
    assert (card.run_with_noise(c, nm, 256, uniforms=u.cuda(),
                                rand_bits=rb.cuda())
            == cpu.run_with_noise(c, nm, 256, uniforms=u, rand_bits=rb))


def test_frame_sweeps_card_equal_cpu(cuda):
    from quantum_simulator_tpu_torch import qec, qec_frame as qf
    specs = [qf.frame_spec_from_code(qec.SteaneCode()),
             qf.repetition_frame_spec(9, "phase_flip"),
             qf.surface_code_frame_spec(5),
             qf.surface_code_frame_spec(7, "union_find")]
    for spec in specs:
        dq = spec.data_qubits
        u = _rows((4096, dq), 6)
        for nt in ("bit_flip", "phase_flip", "depolarizing"):
            got = qf.build_frame_sweep_fn(spec, nt, "cuda")(0.08, u.cuda())
            want = qf.build_frame_sweep_fn(spec, nt, "cpu")(0.08, u)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        nc, nh = spec.comp_checks.shape[0], spec.h_checks.shape[0]
        us = [_rows((1024, 3, w), 7 + w) for w in (dq, nc, nh)]
        fns = [qf.build_memory_fn(spec, "depolarizing", 3, 0.02, d)
               for d in ("cuda", "cpu")]
        assert torch.equal(fns[0](0.03, *[a.cuda() for a in us]).cpu(),
                           fns[1](0.03, *us))
    # float32 posteriors: at d = 7, R = 4, p = q = 0.05 each device's
    # masses are within 1.1e-4 of the larger mass against float64 (CPU
    # measurement), so the two devices agree within 5e-4 of it, and the
    # decisions wherever the margin exceeds that.
    run = qf.build_ml_memory_fn(7, 4, return_masses=True)
    ud, um = _rows((2048, 4, 7), 8), _rows((2048, 4, 6), 9)
    fg = run(0.05, 0.05, ud.cuda(), um.cuda())
    fc = run(0.05, 0.05, ud, um)
    a0, a1 = fc[2].numpy(), fc[3].numpy()
    top = np.maximum(a0, a1)
    for k in (2, 3):
        assert np.all(np.abs(fg[k].cpu().numpy() - fc[k].numpy())
                      <= 5e-4 * top)
    clear = np.abs(a0 - a1) > 5e-4 * top
    assert clear.mean() > 0.9
    assert np.array_equal(fg[0].cpu().numpy()[clear], fc[0].numpy()[clear])
    assert torch.equal(fg[1].cpu(), fc[1])


def test_linear_sampler_and_dem_card_equal_cpu(cuda):
    from quantum_simulator_tpu_torch import qec_circuit as qc, qec_dem
    ref = _rows((1, 200), 10)
    outs = {}
    for dev in ("cuda", "cpu"):
        run, lay = qc._trajectory_fn(3, 2, 0.02, "z", "linear", device=dev,
                                     ref_uniforms=ref[:, :qc._lower(
                                         qc._extraction_circuit(
                                             "surface", 3, 2, "z")[0],
                                         collapse_measures=True)[0].size])
        u = _rows((512, run.schedule_length), 11)
        outs[dev] = run(u.to(dev)).cpu()
    assert torch.equal(outs["cuda"], outs["cpu"])
    dg = qec_dem.extract_dem(3, 3, "z", device="cuda")
    dc = qec_dem.extract_dem(3, 3, "z", device="cpu")
    assert np.array_equal(dg.edges, dc.edges)
    assert np.array_equal(dg.logicals, dc.logicals)
    assert np.array_equal(dg.counts, dc.counts)


def test_native_module_loads_on_the_card_machine(cuda):
    from quantum_simulator_tpu_torch import native, qec_matching as qm
    from quantum_simulator_tpu_torch.qec_frame import surface_code_frame_spec
    assert native.native_module(required=True) is not None
    g = qm.MatchingGraph.from_checks(surface_code_frame_spec(9).comp_checks)
    syn = np.random.default_rng(0).integers(
        0, 2, (500, g.n_checks)).astype(np.uint8)
    before = qm.DECODE_CALLS["native"]
    c_out = qm.decode_batch(g, syn)
    assert qm.DECODE_CALLS["native"] == before + 1
    assert np.array_equal(c_out, qm.decode_batch(g, syn, force_python=True))


@pytest.mark.parametrize("code", ["BitFlipCode", "PhaseFlipCode",
                                  "SteaneCode", "RotatedSurfaceCode"])
def test_statevector_qec_equals_frame_on_the_card(cuda, code):
    """``QECSimulator`` (encodes through ``Simulator``, cycles on the card)
    against ``FrameQECSimulator.from_code`` on the same 512 trials'
    uniforms: per-trial flags identical, the threshold sweeps equal under
    one seed; each encode one launch per plan step, its state within 1e-5
    of the plain-twin executor and the state the cycles use."""
    from quantum_simulator_tpu_torch import qec, qec_frame as qf

    code = getattr(qec, code)()
    trials = 512
    sv = qec.QECSimulator(code, device="cuda")
    for b in ((0, 1) if hasattr(code, "_encoding_circuit") else ()):
        c = code._encoding_circuit(b)
        p = tprog.compile_circuit(c)
        cuda_exec.reset_launch_counts()
        got = Simulator(device="cuda").run(c, shots=0).final_state.device_data
        assert _launches(False) == (*_step_counts(tplan.build_group_plan(p)),
                                    0)
        want = tplan.group_forward_body(p, p.initial_params, "cuda",
                                        plain=True)
        assert float((got - want).abs().max()) <= 1e-5
        assert torch.equal(sv._encoded(b).device_data, got)
    ideals = sv._ideals(trials)
    frs = qf.FrameQECSimulator.from_code(code, device="cuda")
    u = qec.trial_uniforms(np.random.default_rng(42), trials,
                           code.data_qubits, "cuda")
    fb, fa, z_exp, *_ = sv.cycles("depolarizing", 0.05, ideals, u)
    ok_b, ok_a, flip = frs.sweep_raw(0.05, trials, "depolarizing",
                                     uniforms=u)
    signs = np.where(np.arange(trials) % 2 == 0, 1.0, -1.0)
    assert torch.equal((fb > 0.5).int(), ok_b)
    assert torch.equal((fa > 0.5).int(), ok_a)
    assert np.array_equal((z_exp.cpu().numpy() * signs < 0).astype(np.int32),
                          flip.cpu().numpy())
    a = sv.threshold_sweep([0.05], trials, "depolarizing", 42)[0]
    b = frs.threshold_sweep([0.05], trials, "depolarizing", 42)[0]
    assert a.success_rate == b.success_rate
    assert a.decoder_success_rate == b.decoder_success_rate


@pytest.mark.parametrize("engine", ["frame", "clifford"])
def test_circuit_level_engines_agree_on_the_card(cuda, engine):
    """The surface code at d = 3, R = 3: the engine's detection events on
    256 rows of uniforms on the card equal the linear engine's."""
    from quantum_simulator_tpu_torch import qec_circuit as qc

    events = {}
    for name in ("linear", engine):
        run, lay = qc._trajectory_fn(3, 3, 0.01, "z", name, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(42)
        u = torch.rand((256, run.schedule_length), generator=gen,
                       device="cuda")
        events[name] = qc.detection_events(
            lay, run(u).cpu().numpy().astype(np.uint8))
    assert np.array_equal(events["linear"], events[engine])


def _pauli_string_np(psi, pauli, qubits, n):
    mats = {"X": np.array([[0, 1], [1, 0]], complex),
            "Y": np.array([[0, -1j], [1j, 0]]),
            "Z": np.array([[1, 0], [0, -1]], complex)}
    phi = psi.reshape((2,) * n)
    for p, q in zip(pauli, qubits):
        phi = np.moveaxis(np.tensordot(mats[p], phi, axes=([1], [q])), 0, q)
    return float(np.vdot(psi, phi.reshape(-1)).real)


def test_flip_mask_cost_holds_per_string_cost_n20(cuda):
    """The Hamiltonian cost (flip masks, ``optimizer._pauli_terms_device``)
    against a per-string complex128 NumPy cost, with Y terms and strings
    of 6-10 qubits, at n = 20 on the card."""
    from quantum_simulator_tpu_torch.optimizer import CostFunction
    n = 20
    rng = np.random.default_rng(12)
    terms = []
    for _ in range(24):
        k = int(rng.integers(6, 11))
        qubits = [int(q) for q in rng.choice(n, k, replace=False)]
        pauli = "".join(rng.choice(list("XYZ"), k))
        if "Y" not in pauli:
            pauli = "Y" + pauli[1:]
        terms.append((float(rng.normal()), pauli, qubits))
    terms.append((0.7, "ZZ", [3, 4]))
    # A product state with every Bloch vector at (+-1, +-1, +-1) / sqrt 3
    # (so each term's value is far from 0), plus an entangled remainder.
    psi = np.ones(1)
    for b in rng.choice([-1.0, 1.0], (n, 3)) / np.sqrt(3):
        theta, phi = np.arccos(b[2]), np.arctan2(b[1], b[0])
        psi = np.kron(psi, [np.cos(theta / 2),
                            np.exp(1j * phi) * np.sin(theta / 2)])
    noise = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi = psi + 0.2 * noise / np.linalg.norm(noise)
    psi /= np.linalg.norm(psi)
    want = sum(c * _pauli_string_np(psi, p, qs, n) for c, p, qs in terms)
    cost = CostFunction.vqe_hamiltonian(terms)
    got = float(cost.device_fn(torch.from_numpy(psi.astype(np.complex64))
                               .cuda(), n))
    assert abs(want) > 0.1
    assert abs(got - want) <= 1e-5


# --- the MPS family: the card against the CPU on the same draws ------------

def _mps_brick(n, depth, seed, measure=False):
    """Ry/Rz + CNOT brickwork; ``measure``: a Measure on every fourth
    qubit after every second layer."""
    rng = np.random.default_rng(seed)
    c = QuantumCircuit(n)
    col = 0
    for layer in range(depth):
        for q in range(n):
            c.add("Ry" if (q + layer) % 2 else "Rz", [q],
                  [float(rng.uniform(0, 2 * np.pi))], col)
        col += 1
        for q in range(layer % 2, n - 1, 2):
            c.add("CNOT", [q, q + 1], [], col)
        col += 1
        if measure and layer % 2:
            for q in range(layer % 4, n, 4):
                c.add("Measure", [q], [], col)
            col += 1
    return c


def _mps_on(dev, chi=16):
    from quantum_simulator_tpu_torch import mps as tm
    return tm.MPSSimulator(chi, device=dev)


def test_mps_ideal_card_equals_cpu(cuda):
    """A truncating n = 24 run: the same truncation weight and <Z_q>, and
    a state the statevector engine holds at n = 12."""
    from quantum_simulator_tpu_torch import mps as tm
    c = _mps_brick(24, 8, 1)
    states = {dev: _mps_on(dev, 8).run(c, shots=0)[1]
              for dev in ("cuda", "cpu")}
    assert states["cuda"].truncation_weight == pytest.approx(
        states["cpu"].truncation_weight, abs=1e-6)
    for q in range(0, 24, 5):
        assert tm.expectation_pauli_string(states["cuda"], {q: "Z"}) == \
            pytest.approx(tm.expectation_pauli_string(states["cpu"],
                                                      {q: "Z"}), abs=1e-5)
    c12 = _mps_brick(12, 8, 2)
    psi = Simulator(device="cuda").run(c12, shots=0).final_state.data
    _, st = _mps_on("cuda", 64).run(c12, shots=0)
    np.testing.assert_allclose(tm.to_statevector(st), psi, atol=2e-5)


def test_mps_noisy_and_monitored_card_equal_cpu(cuda):
    """The same Gumbel rows and uniforms: identical counts (batched SVD
    centre moves on the card, QR on the CPU: another gauge, the same
    draws), identical monitored outcomes."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             DepolarizingNoise, NoiseModel)
    from quantum_simulator_tpu_torch import mps as tm
    c = _mps_brick(16, 4, 3)
    nm = NoiseModel()
    nm.add_global_noise(AmplitudeDampingNoise(0.05))
    nm.add_global_noise(DepolarizingNoise(0.02))
    gen = torch.Generator().manual_seed(5)
    g = tm.draw_gumbels(64, tm.draw_branches(c, nm), gen, "cpu")
    u = torch.rand((64, 16), generator=gen)
    out = {dev: _mps_on(dev).run_with_noise(c, nm, shots=64, seed=1,
                                            gumbels=g, uniforms=u)
           for dev in ("cuda", "cpu")}
    assert out["cuda"][0] == out["cpu"][0]
    cm = _mps_brick(16, 4, 4, measure=True)
    gm = tm.draw_gumbels(32, tm.draw_branches(cm, nm, True), gen, "cpu")
    outs = {dev: _mps_on(dev).monitored_trajectories(
        cm, 32, noise_model=nm, gumbels=gm)[0] for dev in ("cuda", "cpu")}
    assert np.array_equal(outs["cuda"], outs["cpu"])


def test_mps_dmrg_correlator_lindblad_card_equal_cpu(cuda):
    from quantum_simulator_tpu_torch import correlators as tc
    from quantum_simulator_tpu_torch import dmrg as td
    from quantum_simulator_tpu_torch import lindblad_mps as tl
    from quantum_simulator_tpu_torch import mps as tm
    from quantum_simulator_tpu_torch.models import tfim_chain
    # Both exact (chi covers every bond) and converged: intermediate
    # sweeps keep zero-singular-value columns neither solver defines.
    terms = tfim_chain(8, j=-1.0, h=-0.8)
    res = {dev: td.dmrg_ground_state(terms, 8, chi=16, sweeps=4,
                                     lanczos_k=10, device=dev)
           for dev in ("cuda", "cpu")}
    assert res["cuda"].energy == pytest.approx(res["cpu"].energy, abs=1e-5)
    corr = {dev: tc.mps_two_point_correlator(
        10, tfim_chain(10), 1.0, 20, 4, 5, pauli_j="X", pauli_i="X",
        chi=32, record_every=5, device=dev)[1] for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(corr["cuda"], corr["cpu"], atol=1e-5)
    jumps = [(0.2, "sigma_minus", q) for q in range(8)]
    g = tm.gumbel_from_uniform(torch.rand(
        (32, 10, 8, 2), generator=torch.Generator().manual_seed(3)))
    recs = {dev: tl.MPSLindbladSimulator(8, tfim_chain(8), jumps, chi=8,
                                         device=dev).evolve(
        1.0, 10, n_trajectories=32, observables=[("Z", [3]), ("XX", [1, 2])],
        record_every=5, gumbels=g) for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(recs["cuda"].expectations,
                               recs["cpu"].expectations, atol=1e-5)


def test_mps_gradient_through_looped_svd(cuda):
    """A 2P-row gradient whose bonds reach 64 (two-site splits of 128 x
    128, past the batched solver's 32: the looped SVD path), exact at
    chi = 64, against the statevector gradient."""
    from quantum_simulator_tpu_torch import models
    from quantum_simulator_tpu_torch import optimizer as topt
    c = models.hardware_efficient_ansatz(12, 6)
    cost = topt.CostFunction.vqe_hamiltonian(models.tfim_chain(12))
    v = np.random.default_rng(2).uniform(-np.pi, np.pi, 12 * 7)
    g_mps = topt.GradientEstimator.parameter_shift(
        topt.MPSParameterizedConfig.auto_detect(c, chi=64), cost, v,
        device="cuda")
    g_sv = topt.GradientEstimator.parameter_shift(
        topt.ParameterizedCircuitConfig.auto_detect(c), cost, v,
        device="cuda")
    np.testing.assert_allclose(g_mps, g_sv, atol=1e-4)


def test_mps_amplitude_and_entropy_hold_float64(cuda):
    """``amplitude`` and ``entanglement_entropy`` of a random n = 10 MPS
    on the card against a float64 NumPy contraction of its tensors."""
    from quantum_simulator_tpu_torch import mps as tm
    _, st = _mps_on("cuda", 32).run(_mps_brick(10, 10, 6), shots=0)
    psi = np.ones((1, 1), complex)
    for t in st.tensors:
        a = t.cpu().numpy().astype(np.complex128)
        psi = np.einsum("dl,lpr->dpr", psi, a).reshape(-1, a.shape[2])
    psi = psi[:, 0]
    for bits in ("0000000000", "1011001110", "1111111111", "0101010101"):
        assert abs(tm.amplitude(st, bits) - psi[int(bits, 2)]) <= 1e-6
    for bond in (2, 4, 6):
        s = np.linalg.svd(psi.reshape(2 ** (bond + 1), -1),
                          compute_uv=False)
        p = s ** 2 / np.sum(s ** 2)
        p = p[p > 1e-12]
        want = float(-np.sum(p * np.log2(p)))
        assert tm.entanglement_entropy(st, bond) == pytest.approx(
            want, abs=1e-5)


def test_mps_samples_in_the_x_basis_on_cuda(cuda):
    """The MPS sampler on the card in the Z and the X basis: every shot a
    full-width bit string."""
    c = _mps_brick(24, 6, 7)
    sim = _mps_on("cuda")
    for basis in ("Z", "X"):
        counts, _ = sim.run(c, shots=256, seed=1, basis=basis)
        assert sum(counts.values()) == 256
        assert all(len(k) == 24 for k in counts)


def test_mps_shadows_of_ghz_on_cuda(cuda):
    """Classical shadows of GHZ-16 on the MPS engine on the card: wherever
    two neighbours were both read in Z they agree; the nearest-neighbour
    <ZZ> estimates average within 0.1 of 1, each within 5 standard
    errors."""
    from quantum_simulator_tpu_torch import shadows as tsh

    n, S = 16, 2048
    data = tsh.collect_shadows(_ghz(n), S, seed=4, engine="mps", chi=16,
                               chunk=512, device="cuda")
    both_z = (data.bases[:, :-1] == 2) & (data.bases[:, 1:] == 2)
    agree = data.outcomes[:, :-1] == data.outcomes[:, 1:]
    assert bool(agree[both_z].all())
    zz = np.array([data.estimate_pauli("ZZ", [q, q + 1])
                   for q in range(n - 1)])
    assert abs(zz.mean() - 1.0) <= 0.1
    assert np.abs(zz - 1.0).max() <= 5 * np.sqrt(8.0 / S)


def _dense_ham(n, terms):
    from quantum_simulator_tpu_torch import lindblad

    h = np.zeros((1 << n, 1 << n), complex)
    for coeff, pstr, qubits in terms:
        full = ["I"] * n
        for p, q in zip(pstr, qubits):
            full[q] = p
        h += coeff * lindblad._pauli_term_matrix("".join(full))
    return h


def test_dmrg_excited_states_on_cuda(cuda):
    """Three TFIM levels at n = 8 by DMRG on the card within 5e-4 of
    ``eigvalsh``."""
    from quantum_simulator_tpu_torch import dmrg as td
    from quantum_simulator_tpu_torch.models import tfim_chain

    terms = tfim_chain(8, j=-1.0, h=-0.9)
    res = td.dmrg_excited_states(terms, 8, n_states=3, chi=8, sweeps=5,
                                 device="cuda")
    want = np.linalg.eigvalsh(_dense_ham(8, terms))[:3]
    assert np.abs(np.array([r.energy for r in res]) - want).max() <= 5e-4


def test_complex128_mps_gradient_matches_statevector(cuda):
    """Under ``enable_complex128`` the exact (chi = 32) MPS parameter-shift
    gradient of ``hardware_efficient_ansatz(10, 2)`` on ``tfim_chain(10)``
    within 1e-10 of the statevector gradient, both on the card."""
    from quantum_simulator_tpu_torch import models
    from quantum_simulator_tpu_torch import optimizer as topt

    c = models.hardware_efficient_ansatz(10, 2)
    with _precision("complex128"):
        cost = topt.CostFunction.vqe_hamiltonian(models.tfim_chain(10))
        mcfg = topt.MPSParameterizedConfig.auto_detect(c, chi=32)
        scfg = topt.ParameterizedCircuitConfig.auto_detect(c)
        v = np.random.default_rng(43).uniform(-np.pi, np.pi,
                                              mcfg.num_params)
        g_mps = topt.GradientEstimator.parameter_shift(mcfg, cost, v,
                                                       device="cuda")
        g_sv = topt.GradientEstimator.parameter_shift(scfg, cost, v,
                                                      device="cuda")
    assert np.abs(g_mps - g_sv).max() <= 1e-10


# ---------------------------------------------------------------------------
# The parallel layer: a shard mesh on the card
# ---------------------------------------------------------------------------

def _mesh_brick(n, depth, seed=5):
    return QuantumCircuit.from_dict(build_circuit_dict(n, depth, seed,
                                                       mix_rz=True))


def test_mesh_card_equals_cpu_mesh_n12(cuda):
    """The per-gate route (9 local qubits over 8 shards): the card's
    stacked shards against the CPU mesh, every exchange in place."""
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    c = _mesh_brick(12, 8)
    got = DistributedSimulator(make_mesh(8, device="cuda")).run(c).data
    want = DistributedSimulator(make_mesh(8, device="cpu")).run(c).data
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mesh_grouped_equals_single_device_n20(cuda):
    """n = 20 over 8 shards (17 local qubits): mini plans, each dense and
    cross step one kernel launch for all shards, against one device."""
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    c = _mesh_brick(20, 8)
    cuda_exec.reset_launch_counts()
    got = DistributedSimulator(make_mesh(8, device="cuda")).run(c).data
    assert cuda_exec.dense_axis.launches > 0
    want = Simulator(device="cuda").run(c, shots=0).final_state.data
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n", [31, 32])
def test_mesh_exchange_in_place_equals_twin_on_a_slice(cuda, n):
    """The in-place chunked exchange on the 8-shard stacks of n = 31 and
    32 (8 / 32 GiB planar) against its transpose twin on the slice of
    the innermost 64 amplitudes of every (shard, plane, bit) row: a
    shard bit with the top local bit and with one in the middle."""
    from quantum_simulator_tpu_torch.parallel import distributed as tdist
    from quantum_simulator_tpu_torch.parallel import make_mesh
    mesh = make_mesh(8, device="cuda")
    N = 1 << (n - 3)
    torch.cuda.empty_cache()
    x = torch.empty((1, 8, 2, N), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    for l in range(8):
        x[0, l].normal_(generator=gen)
    W = 64
    for g_pos, l_pos in ((0, 3), (2, 17)):
        a = 1 << (l_pos - 3)
        before = x.reshape(1, 8, 2, a, 2, -1)[..., :W].clone()
        tdist._swap_global_local(x, g_pos, l_pos, 3, mesh)
        after = x.reshape(1, 8, 2, a, 2, -1)[..., :W]
        want = tdist.swap_global_local_plain(
            before.reshape(1, 8, 2, -1), g_pos, l_pos, 3)
        assert torch.equal(after.reshape(1, 8, 2, -1), want)
        del before, after, want
    del x
    torch.cuda.empty_cache()


def _random_ansatz(n, layers):
    """``hardware_efficient_ansatz(n, layers)`` at seeded random angles."""
    from quantum_simulator_tpu_torch import models

    d = models.hardware_efficient_ansatz(n, layers).to_dict()
    rng = np.random.default_rng(42)
    for gd in d["gates"]:
        gd["params"] = [float(rng.uniform(-np.pi, np.pi))
                        for _ in gd.get("params", [])]
    return QuantumCircuit.from_dict(d)


def _mini_plan_launches(body):
    """Dense and cross steps of a shard body's mini plans: one launch each
    for all the shards."""
    return _step_counts(*(tplan.build_group_plan(seg[1])
                          for seg in body.segments if seg[0] == "run"))


def _count_exchanges(monkeypatch):
    """The list that grows by one at each mesh exchange."""
    from quantum_simulator_tpu_torch.parallel import distributed as tdist

    calls, swap = [], tdist._swap_global_local

    def counted(*args):
        calls.append(None)          # a mark: the args hold the state
        return swap(*args)

    monkeypatch.setattr(tdist, "_swap_global_local", counted)
    return calls


def _mesh_vs_single(stack, single, planar):
    """max |mesh - one device| of an ``(L, 2, N)`` shard stack and the
    grouped state, planar ``(2, *axes)`` or real ``(*axes,)`` (whose
    evolution leaves the mesh's imaginary plane 0), shard by shard."""
    L = stack.shape[0]
    if planar:
        flat = single.reshape(2, L, -1)
        return max(_grouped_max_diff(stack[l], flat[:, l]) for l in range(L))
    flat = single.reshape(L, -1)
    return max(max(_grouped_max_diff(stack[l, 0], flat[l]),
                   float(stack[l, 1].abs().max())) for l in range(L))


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
@pytest.mark.parametrize("kind", ["brickwork", "ansatz"])
def test_mesh_n30_matches_one_device_under_two_states(cuda, kind, precision,
                                                      monkeypatch):
    """n = 30 over 8 stacked shards (27 local qubits: mini plans, each
    dense and cross step one launch for all shards): the Ry/Rz brickwork
    and ``hardware_efficient_ansatz(30, 4)`` within 2e-5 of
    ``Simulator.run`` (1e-12 in float64), shard by shard, and (complex64)
    within 1e-5 of the same body through the twins; exchanges as the
    schedule's, launches as the mini plans', the peak under 1.75x the
    state."""
    from quantum_simulator_tpu_torch import PlanarStateVector
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    from quantum_simulator_tpu_torch.parallel import distributed as tdist

    c = (_brick(30, 8, mix_rz=True) if kind == "brickwork"
         else _random_ansatz(30, 4))
    program = tprog.compile_circuit(c)
    calls = _count_exchanges(monkeypatch)
    torch.cuda.empty_cache()
    with _precision(precision) as wide:
        mesh = make_mesh(8, device="cuda")
        body = tdist._ShardBody(program, mesh)
        assert body.grouped
        fs = Simulator(device="cuda").run(c, shots=0).final_state
        assert isinstance(fs, PlanarStateVector)
        single, planar = fs.state_data, fs.is_planar
        del fs
        calls.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda_exec.reset_launch_counts()
        st = DistributedSimulator(mesh).run(c)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches, exchanges = _launches(wide), len(calls)
        err = _mesh_vs_single(st.device_data, single, planar)
        del single
        twin_err = 0.0
        if not wide:
            twin = body.forward(program.initial_params, plain=True)
            twin_err = max(_grouped_max_diff(st.device_data[l], twin[l])
                           for l in range(8))
            del twin
        del st
        torch.cuda.empty_cache()
    assert peak <= 1.75 * _state_bytes(30, True, wide), peak / 2**30
    assert err <= (1e-12 if wide else 2e-5), err
    assert twin_err <= 1e-5, twin_err
    assert exchanges == body.swaps
    assert launches == (*_mini_plan_launches(body), 0)
    assert launches[0] > 0 and (kind == "brickwork" or launches[1] > 0)


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_mesh_qft_on_a_basis_input(cuda, precision):
    """QFT-20 on a basis input over 8 shards (whole in complex64, by
    ``run_segmented(4)`` in float64): no CPhase schedules an exchange,
    launches as the mini plans', fidelity against the analytic DFT row
    above 1 - 1e-4 (1 - 1e-12), every <Z_q> within 1e-4 of 0, 1000
    shots that a seed repeats; an n = 32 mesh is refused in float64."""
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    from quantum_simulator_tpu_torch.parallel import distributed as tdist
    from quantum_simulator_tpu_torch.scripts import mesh_stretch_check

    n, cols = 20, 4
    b = int(np.random.default_rng(42).integers(0, 1 << n))
    c = _qft(n)
    c.initial_states = [(b >> (n - 1 - q)) & 1 for q in range(n)]
    bare = QuantumCircuit.from_dict({**c.to_dict(), "gates": [
        gd for gd in c.to_dict()["gates"] if gd["name"] != "CPhase"]})
    with _precision(precision) as wide:
        mesh = make_mesh(8, device="cuda")
        sim = DistributedSimulator(mesh)
        kinds = [it[0] for it in tdist._ShardBody(
            tprog.compile_circuit(c), mesh).schedule]
        assert "cphase" in kinds
        assert kinds.count("swap") == tdist._ShardBody(
            tprog.compile_circuit(bare), mesh).swaps <= 4 * 3
        cuda_exec.reset_launch_counts()
        st = sim.run_segmented(c, cols) if wide else sim.run(c)
        torch.cuda.synchronize()
        launches = _launches(wide)
        ov = mesh_stretch_check.dft_overlap(st.device_data, mesh, b, n)
        fid = abs(ov) ** 2 / st.norm()
        rho = sim.qubit_density_matrices(st)
        counts = [sim.sample(st, 1000, np.random.default_rng(7))
                  for _ in range(2)]
        if wide:
            with pytest.raises(ValueError, match="64 GiB"):
                sim.run(_brick(32, 1, mix_rz=True))
    assert launches[0] > 0 and launches[2] == 0
    if not wide:
        body = tdist._ShardBody(tprog.compile_circuit(c), mesh)
        assert launches == (*_mini_plan_launches(body), 0)
    assert 1.0 - fid <= (1e-12 if wide else 1e-4), fid
    assert np.abs((rho[:, 0, 0] - rho[:, 1, 1]).real).max() <= 1e-4
    assert counts[0] == counts[1] and sum(counts[0].values()) == 1000


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_mesh_noisy_card_equals_cpu_on_the_same_draws(cuda, precision):
    """The mesh's noisy trajectories on the card and on the CPU mesh from
    the same Gumbel rows: within 1e-5 (1e-12 in float64) wherever no draw
    sits nearer a tie than 1e-4 (1e-9), at least half of them;
    ``run_with_noise`` on the card returns its shots."""
    from quantum_simulator_tpu_torch import DepolarizingNoise
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    from quantum_simulator_tpu_torch.parallel import distributed as tdist

    T = 16
    nm = _global_noise(DepolarizingNoise(0.05))
    with _precision(precision) as wide:
        n = 12 if wide else 10
        prog_s = tprog.compile_circuit(_brick(n, 8, mix_rz=True))
        draws, width = tdist.noisy_draw_shape(prog_s, nm)
        g = tdist.draw_gumbels((T, draws, width),
                               torch.Generator().manual_seed(42), "cpu")
        rec = []
        want = tdist.sharded_trajectory_fn(
            prog_s, nm, make_mesh(8, device="cpu"))(
                prog_s.initial_params, g, rec)
        got = tdist.sharded_trajectory_fn(
            prog_s, nm, make_mesh(8, device="cuda"))(
                prog_s.initial_params, g.cuda()).cpu()
        counts = DistributedSimulator(make_mesh(8, device="cuda")) \
            .run_with_noise(_brick(n, 4), nm, 256, trajectories=4, seed=42)
    assert got.dtype == want.dtype == (torch.float64 if wide
                                       else torch.float32)
    margins = torch.stack([m for _, m in rec], 1).min(1).values
    clear = margins > (1e-9 if wide else 1e-4)
    assert int(clear.sum()) >= T // 2
    err = float((got - want).abs().amax((1, 2, 3))[clear].max())
    assert err <= (1e-12 if wide else 1e-5), err
    assert sum(counts.values()) == 256


def test_sharded_vqe_step_matches_one_device_parameter_shift(cuda):
    """The sharded VQE step (traj 2 x amp 4) on
    ``hardware_efficient_ansatz(12, 3)`` with a ZZ chain: its cost and its
    gradient (Adam's first moment over 0.1 after one step) within 1e-4 of
    the one-device parameter-shift rows; three more steps stay finite."""
    from quantum_simulator_tpu_torch.parallel import (make_vqe_mesh,
                                                      sharded_vqe_step)

    n = 12
    c = _random_ansatz(n, 3)
    ham = [(1.0, [i, i + 1]) for i in range(n - 1)]
    mesh = make_vqe_mesh(8, device="cuda")
    assert mesh.shape["traj"] == 2 and mesh.shape["amp"] == 4
    step = sharded_vqe_step(c, mesh, observable=ham)
    state, cost = step.step(step.init)
    grad = (state.m / 0.1).cpu().numpy()
    program = tprog.compile_circuit(c)
    P = program.num_params
    v = torch.as_tensor(program.initial_params, dtype=torch.float32,
                        device="cuda")
    eye = torch.eye(P, device="cuda") * (np.pi / 2)
    rows = torch.cat([v[None], v[None] + eye, v[None] - eye])
    psi = tplan.group_batched_forward(program, rows, "cuda")
    probs = psi.real.square() + psi.imag.square()
    idx = torch.arange(1 << n, device="cuda")
    costs = torch.zeros(rows.shape[0], dtype=torch.float64, device="cuda")
    for coeff, qs in ham:
        sign = torch.ones(1 << n, device="cuda")
        for q in qs:
            sign = sign * (1 - 2 * ((idx >> (n - 1 - q)) & 1)).float()
        costs += coeff * (probs * sign).sum(1, dtype=torch.float64)
    want = ((costs[1:1 + P] - costs[1 + P:]) / 2).cpu().numpy()
    assert abs(float(cost) - float(costs[0])) <= 1e-4
    assert np.abs(grad - want).max() <= 1e-4
    for _ in range(3):
        state, cost = step.step(state)
        assert np.isfinite(float(cost))


@pytest.mark.parametrize("precision", ["complex64", "complex128"])
def test_mesh_checkpoint_resume_equals_uninterrupted(cuda, precision,
                                                     tmp_path):
    """A checkpointed ``run_segmented`` stopped from its progress callback
    after segment 1 and resumed (rerunning that segment, whose progress
    call comes before its checkpoint) equals an uninterrupted run (1e-6;
    1e-12 in float64, whose manifest says "complex128" and whose save and
    load round trip is bit for bit)."""
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh)
    from quantum_simulator_tpu_torch.parallel import checkpoint as tckpt

    depth, cols, stop = 8, 2, 1
    c = _brick(12, depth, mix_rz=True)

    class Stop(Exception):
        pass

    def stopper(i, ns, w):
        if i == stop:
            raise Stop()

    root = str(tmp_path / "run")
    done = []
    with _precision(precision) as wide:
        sim = DistributedSimulator(make_mesh(8, device="cuda"))
        whole = sim.run_segmented(c, cols)
        with pytest.raises(Stop):
            sim.run_segmented(c, cols, progress=stopper, checkpoint_dir=root)
        dtype = tckpt.load_manifest(tckpt.read_latest(root))["dtype"]
        res = sim.run_segmented(c, cols, checkpoint_dir=root,
                                progress=lambda i, ns, w: done.append(i))
        saved = str(tmp_path / "saved")
        tckpt.save_sharded_state(whole.device_data, saved, sim.mesh)
        again = tckpt.load_sharded_state(saved, sim.mesh)
    assert done == list(range(stop, -(-depth // cols)))
    assert dtype == precision
    assert torch.equal(again, whole.device_data)
    err = max(_grouped_max_diff(whole.device_data[l], res.device_data[l])
              for l in range(8))
    assert err <= (1e-12 if wide else 1e-6), err


def test_mesh_engines_equal_mesh_none(cuda):
    """The ``mesh=`` engines on one rank reach the same engine and repeat
    it: the Steane frame sweep, the surface-code circuit-level memory and
    the MPS Lindblad trajectories (their Gumbel rows drawn up front)
    identical to ``mesh=None``."""
    from quantum_simulator_tpu_torch import lindblad_mps as tl
    from quantum_simulator_tpu_torch import qec, qec_circuit as qc
    from quantum_simulator_tpu_torch import qec_frame as qf
    from quantum_simulator_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, device="cuda")
    fr = qf.FrameQECSimulator.from_code(qec.SteaneCode(), "cuda")
    a = fr.sweep_raw(0.05, 4096, "depolarizing", seed=42)
    b = fr.sweep_raw(0.05, 4096, "depolarizing", seed=42, mesh=mesh)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    kw = dict(n_trials=2000, seed=42, device="cuda")
    assert qc.circuit_level_memory(3, 3, 0.003, **kw) == \
        qc.circuit_level_memory(3, 3, 0.003, mesh=mesh, **kw)
    n = 8
    lsim = tl.MPSLindbladSimulator(
        n, [(1.0, "ZZ", [i, i + 1]) for i in range(n - 1)]
        + [(0.7, "X", [i]) for i in range(n)],
        [(0.1, "sigma_minus", q) for q in range(n)], chi=16, device="cuda")
    kw = dict(n_trajectories=16, observables=[("Z", [0]), ("Z", [n // 2])],
              seed=42)
    r0 = lsim.evolve(1.0, 10, **kw)
    r1 = lsim.evolve(1.0, 10, mesh=mesh, **kw)
    assert np.array_equal(r0.expectations, r1.expectations)
    assert r0.truncation_weight == r1.truncation_weight


def _front_end_circuit(n=16, depth=8):
    """Ry/Rz brickwork (seed 42): a planar complex state."""
    d = build_circuit_dict(n, depth, 42)
    for g in d["gates"]:
        if g["name"] == "Ry" and (g["targets"][0] + g["column"]) % 2:
            g["name"] = "Rz"
    return d


def test_bridge_card_equals_cpu_over_a_socket(cuda):
    """The bridge on the card answers as the bridge on the CPU at n = 16:
    deterministic replies equal, states and analysis within 1e-5."""
    from quantum_simulator_tpu_torch.bridge import (BridgeCommandHandler,
                                                    BridgeServer,
                                                    SimulatorClient)
    circuit = _front_end_circuit()
    replies = []
    for device in ("cuda", "cpu"):
        srv = BridgeServer(BridgeCommandHandler(device=device), port=0)
        srv.start()
        try:
            with SimulatorClient(port=srv.port, timeout=120) as c:
                info = c.set_circuit(circuit)
                run = c.run(shots=0, seed=7)
                state = c.get_state()
                window = c.get_state(offset=1000, length=64)
                analysis = c.get_analysis(["fidelity", "entropy", "purity",
                                           "pauli"])
                replies.append((c.ping(), info, c.get_circuit(), run, state,
                                window, analysis))
        finally:
            srv.stop()
    card, cpu = replies
    assert card[:4] == cpu[:4]

    def amps(d):
        return np.array([a["re"] + 1j * a["im"] for a in d["amplitudes"]])

    for i in (4, 5):
        assert np.abs(amps(card[i]) - amps(cpu[i])).max() <= 1e-5
    a, b = card[6], cpu[6]
    assert set(a) == set(b)
    for k in ("fidelity", "entropy", "purity"):
        assert abs(a[k] - b[k]) <= 1e-5
    for q, paulis in b["pauli"].items():
        for p, v in paulis.items():
            assert abs(a["pauli"][q][p] - v) <= 1e-5


def test_simulation_controller_card_equals_cpu(cuda):
    """SimulationController(device="cuda") runs on its worker thread to
    the CPU controller's states (final and every step) within 1e-5."""
    from quantum_simulator_tpu_torch.controller import SimulationController
    circuit = QuantumCircuit.from_dict(_front_end_circuit())
    out = []
    for device in ("cuda", "cpu"):
        ctl = SimulationController(device=device)
        seen, errors, steps = [], [], []
        ctl.on_finished = seen.append
        ctl.on_error = errors.append
        ctl.run_simulation(circuit, shots=1024, seed=3)
        ctl.join(120)
        ctl.on_step_updated = lambda s, col: steps.append((col, s.data))
        ctl.run_step_by_step(circuit, shots=0)
        ctl.join(120)
        assert not errors and not ctl.is_running and len(seen) == 2
        assert seen[0].final_state.device_data.device.type == device
        out.append((seen[0].final_state.data, steps))
    (card, card_steps), (cpu, cpu_steps) = out
    assert np.abs(card - cpu).max() <= 1e-5
    assert [c for c, _ in card_steps] == [c for c, _ in cpu_steps]
    for (_, a), (_, b) in zip(card_steps, cpu_steps):
        assert np.abs(a - b).max() <= 1e-5


def _batch_launches(program, nm, T):
    """(dense, cross) launches of T trajectories: the plans of one batch
    times the batches ``simulator._chunk_size`` cuts."""
    from quantum_simulator_tpu_torch import simulator as tsim

    batches = -(-T // tsim._chunk_size(program, nm, T))
    return tuple(batches * k
                 for k in _step_counts(*_noisy_plans(program, nm)))


def test_bridge_noise_sweep_and_mps_requests_on_the_card(cuda):
    """The bridge's handler on the card: ``set_noise`` (depolarizing +
    readout) then ``run`` (1024 shots, the trajectory batches' plans
    launched); ``sweep_parameter`` (the ideal plan and each noisy point's
    batches launched, fidelity in (0, 1] and falling with p, each point's
    fidelity and purity within 1e-5 of the same trajectories from the
    sweep's seed stream in float64); the MPS engine (no kernel launch,
    shots adding up, a finite truncation); an unknown action answered
    with an error, and the server answering on."""
    from quantum_simulator_tpu_torch import DepolarizingNoise, ReadoutError
    from quantum_simulator_tpu_torch.bridge import (BridgeCommandHandler,
                                                    BridgeServer,
                                                    SimulatorClient)
    from quantum_simulator_tpu_torch.bridge.client import BridgeError

    circuit = _brick(12, 8)
    program = tprog.compile_circuit(circuit)
    nm = _global_noise(DepolarizingNoise(0.05))
    nm.set_readout_error(ReadoutError(0.01, 0.02))
    values, trials = (0.0, 0.01, 0.05), 256
    srv = BridgeServer(BridgeCommandHandler(device="cuda"), port=0)
    srv.start()
    try:
        with SimulatorClient(port=srv.port, timeout=600) as c:
            c.set_circuit(circuit.to_dict())
            assert c.set_noise(nm.to_dict()) == {}
            cuda_exec.reset_launch_counts()
            run = c.run(shots=1024, seed=42)
            assert _launches(False) == (*_batch_launches(program, nm, 1024),
                                        0)
            assert sum(run["measurement_counts"].values()) == 1024
            assert c.clear_noise() == {}
            cuda_exec.reset_launch_counts()
            sweep = c.sweep_parameter("noise_p", list(values), trials=trials,
                                      seed=42)["sweep"]
            want = [_step_counts(tplan.get_group_plan(program))] + [
                _batch_launches(program, _global_noise(DepolarizingNoise(p)),
                                trials) for p in values if p]
            assert _launches(False) == (*map(sum, zip(*want)), 0)
            c.set_circuit(_mps_brick(24, 4, 1).to_dict())
            cuda_exec.reset_launch_counts()
            mps = c.run(shots=64, seed=42, engine="mps", chi=16)
            assert _launches(False) == (0, 0, 0)
            with pytest.raises(BridgeError, match="Unknown action"):
                c._send_request("no_such_action")
            assert c.ping()
    finally:
        srv.stop()
    assert mps["engine"] == "mps" and np.isfinite(mps["truncation_weight"])
    assert sum(mps["measurement_counts"].values()) == 64
    fids = [pt["fidelity"] for pt in sweep]
    assert all(0 < f <= 1 for f in fids)
    assert all(a > b for a, b in zip(fids, fids[1:]))
    assert sweep[0] == {"value": 0.0, "fidelity": 1.0, "purity": 1.0}
    rng = np.random.default_rng(42)
    ideal = Simulator(device="cuda").run(
        circuit, shots=0, rng=np.random.default_rng(rng.integers(0, 2**63))
    ).final_state.device_data.to(torch.complex128)
    for pt, p in zip(sweep[1:], values[1:]):
        states = Simulator(noise_model=_global_noise(DepolarizingNoise(p)),
                           device="cuda").trajectory_states(
            circuit, trials, seed=int(rng.integers(0, 2**63))
        ).to(torch.complex128)
        purity = float((states.conj() @ states.T).abs().square().mean())
        fid = float((states @ ideal.conj()).abs().square().mean())
        assert abs(pt["purity"] - purity) <= 1e-5
        assert abs(pt["fidelity"] - fid) <= 1e-5
    assert sweep[-1]["purity"] < 1 - 1e-3


def test_view_models_on_the_card(cuda):
    """``FidelitySweepModel.sweep`` on the card: fidelity in (0, 1] and
    falling with p, purity below 1 - 1e-3 at p = 0.05;
    ``DensityMatrixModel(device="cuda")``: the exact rho within 2e-5 of
    the CPU model's, the 1000-trial ensemble within 0.05 of it."""
    from quantum_simulator_tpu_torch import DepolarizingNoise
    from quantum_simulator_tpu_torch.viewmodels import (DensityMatrixModel,
                                                        FidelitySweepModel)

    points = FidelitySweepModel.sweep(_brick(12, 8), [0.0, 0.01, 0.05],
                                      trials=64, seed=42, device="cuda")
    fids = [pt.fidelity for pt in points]
    assert all(0 < f <= 1 for f in fids)
    assert all(a > b for a, b in zip(fids, fids[1:]))
    assert 0 < points[-1].purity < 1 - 1e-3

    def matrix(view):
        return np.asarray(view.real) + 1j * np.asarray(view.imag)

    circuit = _brick(6, 8, mix_rz=True)
    nm = _global_noise(DepolarizingNoise(0.05))
    model = DensityMatrixModel(device="cuda")
    exact = matrix(model.exact(circuit, nm))
    want = matrix(DensityMatrixModel(device="cpu").exact(circuit, nm))
    assert np.abs(exact - want).max() <= 2e-5
    ens = matrix(model.ensemble(circuit, nm, n_trials=1000, seed=42))
    assert np.abs(ens - want).max() <= 0.05


def test_entry_card_equals_cpu(cuda):
    """``entry()`` on the card (both kernels through the group plan)
    against the same forward on the CPU within 1e-5."""
    from quantum_simulator_tpu_torch import entry
    cuda_exec.reset_launch_counts()
    fn, args = entry.entry("cuda")
    got = fn(*args)
    assert args[0].device.type == "cuda" and got.device.type == "cuda"
    assert all(k.launches > 0 for k in cuda_exec.KERNELS)
    cpu_fn, cpu_args = entry.entry("cpu")
    want = cpu_fn(*cpu_args)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def _twin_json(module, argv, device, tmp_path):
    import json
    out = tmp_path / f"{device}.json"
    assert module.main(argv + ["--device", device, "--output",
                               str(out)]) == 0
    return json.loads(out.read_text())


def test_noise_sweep_card_equals_cpu_in_law(cuda, tmp_path):
    """The noise-sweep twin on the card and on the CPU: each mean
    fidelity within 5 standard errors of the other ([0, 1]-bounded
    per-trajectory values), the p = 0 point 1 within 1e-5."""
    from quantum_simulator_tpu_torch.scripts import noise_sweep
    argv = ["--circuit", "ghz3", "--steps", "4", "--trials", "500"]
    card = _twin_json(noise_sweep, argv, "cuda", tmp_path)
    cpu = _twin_json(noise_sweep, argv, "cpu", tmp_path)
    T = 500
    for a, b in zip(card["results"], cpu["results"]):
        fa, fb = a["mean_fidelity"], b["mean_fidelity"]
        assert abs(fa - fb) <= 5 * np.sqrt(
            (fa * (1 - fa) + fb * (1 - fb)) / T) + 1e-12
        assert abs(a["mean_purity"] - 1.0) <= 1e-5
    assert abs(card["results"][0]["mean_fidelity"] - 1.0) <= 1e-5


def test_vqe_benchmark_card_equals_cpu(cuda, tmp_path):
    """The VQE twin's cost trajectory on the card within 1e-4 of the
    CPU's, for autodiff and for parameter shift (the kernels)."""
    from quantum_simulator_tpu_torch.scripts import vqe_benchmark
    for grad in ("autodiff", "parameter_shift"):
        argv = ["--qubits", "6", "--layers", "2", "--hamiltonian",
                "heisenberg", "--iters", "10", "--grad", grad]
        card = _twin_json(vqe_benchmark, argv, "cuda", tmp_path)
        cpu = _twin_json(vqe_benchmark, argv, "cpu", tmp_path)
        np.testing.assert_allclose(card["result"]["cost_trace"],
                                   cpu["result"]["cost_trace"], atol=1e-4)


# Every command-line twin (module under quantum_simulator_tpu_torch, argv)
# at its default arguments, the full width of its path. Two are cut where
# their defaults repeat other cases at length: ``mesh_stretch_check`` runs
# QFT-32 alone, ``error_mitigation`` n = 2 with one Trotter step (its
# defaults draw 2000 samples of n = 4 density matrices); ``quickstart``
# skips its PNG.
ENTRY_TWINS = (
    ("entry", []),
    ("scripts.noise_sweep", []),
    ("scripts.vqe_benchmark", []),
    ("scripts.qec_threshold", []),
    ("scripts.dmrg_solve", []),
    ("scripts.circuit_threshold", []),
    ("scripts.quantum_volume_check", []),
    ("scripts.monitored_check", []),
    ("scripts.huge_state_check", []),
    ("scripts.sharded_run", []),
    ("scripts.mesh_stretch_check", ["--config", "qft"]),
    ("examples.quickstart", ["--no-export"]),
    ("examples.error_mitigation", ["--n", "2", "--steps", "1"]),
    ("examples.monitored_circuit", []),
    ("examples.open_system", []),
    ("examples.qec_memory", []),
    ("examples.quench_dynamics", []),
    ("examples.quench_spectroscopy", []),
    ("examples.vqe_at_scale", []),
)


@pytest.mark.parametrize("module,argv", ENTRY_TWINS,
                         ids=[m for m, _ in ENTRY_TWINS])
def test_command_line_twin_on_the_card(cuda, module, argv):
    """The twin's ``main`` on the card returns 0, its own checks deciding
    (the QFT-32 fidelity against the DFT row, the Grover-30 amplitude,
    norms, shot counts, GHZ correlations)."""
    import gc
    import importlib

    gc.collect()
    torch.cuda.empty_cache()
    twin = importlib.import_module(f"quantum_simulator_tpu_torch.{module}")
    assert twin.main(argv) == 0


@pytest.fixture
def gui_stubs(cuda, monkeypatch):
    """The port's GUI over the display stand-ins of
    ``tests/torch_gui_stubs.py`` (the card's machine has neither PyQt6
    nor, perhaps, matplotlib); every engine call still runs on its
    device."""
    from tests import qt_stub, torch_gui_stubs

    if not torch_gui_stubs.install_qt(monkeypatch):
        pytest.skip("real PyQt6 present: the stand-in tests do not apply")
    torch_gui_stubs.install_matplotlib(monkeypatch)
    yield qt_stub
    torch_gui_stubs.purge(torch_gui_stubs.PORT_RENDER)


def test_main_window_card_equals_cpu(gui_stubs):
    """One Run click of ``MainWindow(device="cuda")`` at n = 10 (both
    kernels launched) against ``MainWindow(device="cpu")``: final and
    reference states within 1e-5, no error box."""
    from quantum_simulator_tpu_torch.gui.main_window import MainWindow
    from quantum_simulator_tpu_torch.utils.appconfig import AppConfig

    states = []
    for device in ("cuda", "cpu"):
        win = MainWindow(AppConfig(), device=device)
        win.circuit_controller.circuit = QuantumCircuit.from_dict(
            _front_end_circuit(n=10, depth=8))
        cuda_exec.reset_launch_counts()
        win._run_with_shots(1024)
        assert not gui_stubs.QMessageBox.shown
        launches = [k.launches for k in cuda_exec.KERNELS]
        assert all(v > 0 for v in launches) == (device == "cuda")
        res = win.last_result
        assert res.final_state.device_data.device.type == device
        assert sum(res.measurement_counts.values()) == 1024
        states.append((res.final_state.data,
                       win.reference_manager.reference.state.data))
    (card, card_ref), (cpu, cpu_ref) = states
    assert np.abs(card - cpu).max() <= 1e-5
    assert np.abs(card_ref - cpu_ref).max() <= 1e-5


def test_advanced_panel_worker_keeps_results_on_the_pinned_device(
        gui_stubs, monkeypatch):
    """``DebuggerPanel(device="cuda")`` pins the card where it is built;
    its worker runs on a real thread, makes that device current, and
    leaves every snapshot on it (within 1e-5 of the CPU panel's)."""
    import threading

    from quantum_simulator_tpu_torch.gui.advanced_panels import (
        DebuggerPanel)

    started = []

    class _Recorded(threading.Thread):
        def start(self):
            started.append(self)
            super().start()

    monkeypatch.setattr(threading, "Thread", _Recorded)
    circuit = QuantumCircuit.from_dict(_front_end_circuit(n=10, depth=8))
    panel = DebuggerPanel(device="cuda")
    pinned = panel._device
    assert pinned == torch.device("cuda", torch.cuda.current_device())
    seen = []
    panel.debug_ready.connect(
        lambda: seen.append((threading.current_thread(),
                             torch.cuda.current_device())))
    panel.run_debug(circuit, None, seed=7)
    assert len(started) == 1
    started[0].join(300)
    assert not started[0].is_alive()
    assert seen == [(started[0], pinned.index)]
    snaps = panel.debugger.snapshots
    assert len(snaps) == 9
    assert all(s.state.device_data.device == pinned for s in snaps)
    cpu = DebuggerPanel(device="cpu")
    cpu.run_debug(circuit, None, seed=7, block=True)
    for a, b in zip(snaps, cpu.debugger.snapshots):
        assert np.abs(a.state.data - b.state.data).max() <= 1e-5


def test_main_window_actions_on_the_card(gui_stubs, monkeypatch):
    """``MainWindow(device="cuda")`` through its actions at n = 10: a Run
    click (the ideal pass and the shots run, twice the plan's launches;
    final and reference states within 1e-5 of the plain-twin executor; the
    panels fed); noise built in ``NoiseConfigDialog`` and a noisy Run click
    (the ideal plan plus the trajectory batches' plans); step mode over
    every column; the debugger (noisy), the comparison (fidelity within
    1e-5 of the twins' overlap), the optimizer and the QEC sweep on worker
    threads that enter the window's device, the QEC cycle and the
    benchmark suite (every benchmark passes); the bridge toggled on, one
    client run (the plan's launches), toggled off. No critical message
    box, no exception on a worker thread."""
    import functools
    import threading

    from quantum_simulator_tpu_torch import DepolarizingNoise
    from quantum_simulator_tpu_torch.bridge import SimulatorClient
    from quantum_simulator_tpu_torch.gui import advanced_panels as ap
    from quantum_simulator_tpu_torch.gui import main_window as mw
    from quantum_simulator_tpu_torch.gui.dialogs import NoiseConfigDialog
    from quantum_simulator_tpu_torch.utils.appconfig import AppConfig

    started, errors, scopes = [], [], []

    class _Recorded(threading.Thread):
        def start(self):
            started.append(self)
            super().start()

    real_scope = ap.device_scope

    def recorded_scope(device):
        scopes.append((threading.current_thread(), device))
        return real_scope(device)

    monkeypatch.setattr(threading, "Thread", _Recorded)
    monkeypatch.setattr(threading, "excepthook", lambda a: errors.append(
        f"{a.exc_type.__name__}: {a.exc_value}"))
    monkeypatch.setattr(ap, "device_scope", recorded_scope)
    boxes = gui_stubs.QMessageBox.shown
    boxes.clear()

    def launches(fn):
        cuda_exec.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return _launches(False)[:2]

    def join_workers():
        for t in list(started):
            t.join(600)
            assert not t.is_alive()

    def status():
        bar = win.statusBar()
        return (bar.messages[-1] if hasattr(bar, "messages")
                else bar.currentMessage())

    win = mw.MainWindow(AppConfig(), device="cuda")
    assert win.device == torch.device("cuda", torch.cuda.current_device())
    circuit = _brick(10, 8)
    program = tprog.compile_circuit(circuit)
    steps = _step_counts(tplan.get_group_plan(program))
    want = tplan.group_forward_body(program, program.initial_params, "cuda",
                                    plain=True)
    win.circuit_controller.circuit = circuit
    assert launches(lambda: win._run_with_shots(4096)) == tuple(
        2 * k for k in steps)
    res, ref = win.last_result, win.reference_manager.reference
    assert sum(res.measurement_counts.values()) == 4096
    assert ref.circuit_hash == circuit.circuit_hash()
    assert float((res.final_state.device_data - want).abs().max()) <= 1e-5
    assert float((ref.state.device_data - want).abs().max()) <= 1e-5
    assert win.histogram_panel._last_counts == res.measurement_counts
    assert win.statevector_panel._last_state is not None
    assert status().startswith("Run complete")

    dialog = NoiseConfigDialog()
    dialog._rows[2][0].setChecked(True)          # Depolarizing
    dialog._rows[2][1].setValue(0.01)
    dialog.readout_check.setChecked(True)
    dialog.p01_spin.setValue(0.01)
    dialog.p10_spin.setValue(0.02)
    dialog.exec = lambda: 1
    monkeypatch.setattr(mw, "NoiseConfigDialog",
                        lambda current, parent: dialog)
    win._configure_noise()
    nm = win.noise_model
    assert [type(c) for c in nm.global_channels] == [DepolarizingNoise]
    assert nm.readout_error is not None
    assert "Depolarizing" in win.noise_indicator.text()
    traj = _batch_launches(program, nm, 4096)
    assert launches(lambda: win._run_with_shots(4096)) == tuple(
        a + b for a, b in zip(steps, traj))
    assert sum(win.last_result.measurement_counts.values()) == 4096
    assert float((win.reference_manager.reference.state.device_data
                  - want).abs().max()) <= 1e-5

    def step_mode():
        win._on_step_mode()
        for _ in range(program.num_columns + 2):   # the columns, then stop
            win._advance_step()

    assert sum(launches(step_mode)) > 0
    assert status() == "Step mode complete"
    assert len(win.entropy_panel.model.steps) == program.num_columns + 1

    dp = win.debugger_panel
    dp.breakpoints = set(win.editor_model.breakpoints)
    dp.run_debug(circuit, nm, seed=42, block=True)
    snaps = dp.debugger.snapshots
    assert len(snaps) == circuit.get_column_count() + 1
    assert dp._attribution is not None and len(dp._impacts) > 0
    assert all(-1e-6 <= s.fidelity <= 1 + 1e-5 for s in snaps)
    assert float((snaps[-1].ideal_state.device_data
                  - want).abs().max()) <= 1e-5

    circuit_b = _brick(10, 8, mix_rz=True)
    program_b = tprog.compile_circuit(circuit_b)
    cp = win.comparison_panel
    cp.compare(circuit, circuit_b, shots=1024, seed=42)
    want_b = tplan.group_forward_body(program_b, program_b.initial_params,
                                      "cuda", plain=True)
    fid = float((want.conj() * want_b).sum().abs().square())
    assert abs(cp._last.output_fidelity - fid) <= 1e-5
    assert cp.table.rowCount() == 9

    op = win.optimizer_panel
    op.iters_spin.setValue(3)
    op.cost_combo.setCurrentText("zz_chain")
    op.grad_combo.setCurrentText("parameter_shift")
    first = len(started)
    assert launches(lambda: (op._on_run_clicked(), join_workers()))[0] > 0
    workers = [(t, d) for t, d in scopes if t in started[first:]]
    assert workers and all(d == win.device for _, d in workers)
    assert not op._busy and len(op._history) >= 1
    assert "optimal cost" in str(op.figure.gca().get_title())

    qp = win.qec_panel
    qp.p_spin.setValue(0.05)
    qp.run_cycle()
    assert "F=" in qp.status.text()
    first = len(started)
    qp.run_sweep()
    join_workers()
    assert qp.figure.gca().get_xlabel() == "Physical error rate"
    assert any(t in started[first:] for t, _ in scopes)

    win.noise_model = None
    win._refresh_noise_indicator()
    win._run_benchmarks()
    info = [b for b in boxes if b[:2] == ("information", "Benchmarks")]
    lines = info[-1][2].splitlines() if info else []
    assert lines and all(ln.startswith("\u2714") for ln in lines), lines

    monkeypatch.setattr(mw, "BridgeServer",
                        functools.partial(mw.BridgeServer, port=0))
    win._toggle_bridge()
    srv = win.bridge_server
    try:
        assert srv.is_running and srv.port > 0
        reply = {}
        with SimulatorClient(port=srv.port, timeout=600) as c:
            assert launches(lambda: reply.update(
                c.run(shots=1024, seed=42))) == steps
        assert sum(reply["measurement_counts"].values()) == 1024
        win._toggle_bridge()
        assert not srv.is_running
    finally:
        srv.stop()
    assert [b for b in boxes if b[0] == "critical"] == []
    assert errors == []


def test_validation_harness_card_33_of_33(cuda):
    """The acceptance harness on the card: all 33 assertions, the four
    ``[perf]`` bounds included, with dense launches from groups 8 and 9."""
    from quantum_simulator_tpu_torch import validation
    cuda_exec.reset_launch_counts()
    records = validation.run_groups("cuda")
    assert len(records) == validation.N_ASSERTIONS
    assert [r.line() for r in records if not r.ok] == []
    assert cuda_exec.dense_axis.launches >= 2 + 3


def test_parity_card_equals_cpu(cuda):
    """The parity twin's engine half on the card against the CPU, through
    the script's own ``compare``: all 8 checks pass."""
    from quantum_simulator_tpu_torch.scripts import parity_check
    card = parity_check.run_ours(200, "cuda")
    cpu = parity_check.run_ours(200, "cpu")
    checks = parity_check.compare(cpu, card, 200)
    assert len(checks) == 8 and all(c["passed"] for c in checks), checks


def test_interactive_latency_card_meets_edit_target(cuda, tmp_path):
    """The latency twin at n = 16, depth 8 on the card: every edit rerun
    (ideal 1-gate, realness flip, noisy 1-gate) under 2 s, and a second
    process finds the kernel library already built."""
    from quantum_simulator_tpu_torch.scripts import interactive_latency_check
    got = _twin_json(interactive_latency_check,
                     ["-n", "16", "--depth", "8"], "cuda", tmp_path)
    assert got["platform"] == "gpu" and got["edit_under_2s"]
    assert got["device"] == torch.cuda.get_device_name(0)
    assert got["second_process_library_prebuilt"] is True


# ---------------------------------------------------------------------------
# Complex128 verification mode: the float64 kernels
# ---------------------------------------------------------------------------

def _f64(shape, device, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(device)


# shape -> (cross geometries, batch, operator shared): between them every
# dense depth K from 2 to 128 and every cross depth from 4 to 256, both
# sides of the FMA / DMMA line (K = 16); (2, 8, 16, 64) and (4, 128, 8) run
# a batch of B = 3 with one operator per trajectory, (2, 128, 128) one of
# B = 8 with one operator shared at stride 0, and (4, 128, 8) leaves each
# trajectory a ragged tile (the dense K = 128 and cross K = 256 steps have
# fewer fibers than a tile).
F64_CASES = {(4, 128, 128): ([(1, 0, 0), (1, 6, 2), (2, 3, 0)], None, False),
             (32, 128, 128): ([(1, 0, 0), (1, 6, 2), (2, 3, 0)], None,
                              False),
             (2, 8, 16, 64): ([(1, 0, 0), (2, 1, 1), (3, 2, 2), (1, 2, 3)],
                              3, False),
             (4, 128, 8): ([(0, 0, 1), (2, 1, 0), (1, 3, 2)], 3, False),
             (2, 128, 128): ([(1, 0, 0), (1, 6, 2), (2, 3, 0)], 8, True)}


@pytest.mark.parametrize("shape", list(F64_CASES))
@pytest.mark.parametrize("planar,real", VARIANTS)
def test_f64_kernels_match_twins(cuda, shape, planar, real):
    """Every dense axis and the case's cross geometries of a layout,
    float64 against the float64 twin: 1e-12 x max |x| (sums of at most 256
    terms in another order)."""
    geoms, batch, shared = F64_CASES[shape]
    batched = batch is not None
    lead = ((batch,) if batched else ()) + ((2,) if planar else ())

    def operator(op_shape, seed, scale):
        if shared:
            return _f64((1,) + op_shape, cuda, seed, scale).expand(
                (batch,) + op_shape)
        return _f64(((batch,) if batched else ()) + op_shape, cuda, seed,
                    scale)

    x = _f64(lead + shape, cuda, 0)
    tol = 1e-12 * float(x.abs().max())
    for axis, S in enumerate(shape):
        op = operator((S, S) if real else (2, S, S), axis, S ** -0.5)
        want = cuda_exec.dense_axis_plain(x, op, axis, planar, batched)
        cuda_exec.reset_launch_counts()
        got = cuda_exec.dense_axis(x.clone(), op, axis, planar, batched)
        torch.cuda.synchronize()
        assert cuda_exec.dense_axis_f64.launches == 1
        assert cuda_exec.dense_axis.launches == 0
        assert float((got - want).abs().max()) <= tol
    for s, pos, o in geoms:
        S = shape[o]
        cop = operator((2, S, 2, S) if real else (2, 2, S, 2, S), 9,
                       (2 * S) ** -0.5)
        want = cuda_exec.cross_bit_axis_plain(x, cop, s, pos, o, planar,
                                              batched)
        cuda_exec.reset_launch_counts()
        got = cuda_exec.cross_bit_axis(x.clone(), cop, s, pos, o, planar,
                                       batched)
        torch.cuda.synchronize()
        assert cuda_exec.cross_bit_axis_f64.launches == 1
        assert float((got - want).abs().max()) <= tol


def test_f64_state_with_f32_operator_raises(cuda):
    x = torch.zeros((2, 4, 128, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        cuda_exec.dense_axis(x, torch.zeros((128, 128), device=cuda), 2,
                             True)
    with pytest.raises(TypeError):
        cuda_exec.cross_bit_axis_f64(
            x.float(), torch.zeros((2, 4, 2, 4), device=cuda), 1, 0, 0, True)


@pytest.mark.parametrize("mix_rz", [False, True])
def test_complex128_run_card_equals_cpu(cuda, mix_rz):
    """``Simulator.run`` at n = 12 under ``enable_complex128``: the card's
    complex128 state within 1e-12 of the CPU's, every dense and cross
    step a float64 launch."""
    from quantum_simulator_tpu_torch import config
    circuit = QuantumCircuit.from_dict(build_circuit_dict(12, 16, 3, mix_rz))
    plan = tplan.build_group_plan(tprog.compile_circuit(circuit))
    config.enable_complex128()
    try:
        cuda_exec.reset_launch_counts()
        card = Simulator(device="cuda").run(circuit, shots=0) \
            .final_state.device_data
        torch.cuda.synchronize()
        cpu = Simulator(device="cpu").run(circuit, shots=0) \
            .final_state.device_data
    finally:
        config.enable_complex64()
    assert card.dtype == torch.complex128
    assert cuda_exec.dense_axis_f64.launches == sum(
        isinstance(s, tplan.AxisMatmulStep) for s in plan.steps)
    assert cuda_exec.cross_bit_axis_f64.launches == sum(
        isinstance(s, tplan.CrossStep) for s in plan.steps)
    assert cuda_exec.dense_axis.launches == 0
    assert float((card.cpu() - cpu).abs().max()) <= 1e-12


@pytest.mark.parametrize("mix_rz", [False, True])
def test_complex128_chunked_route_card_equals_cpu(cuda, mix_rz, monkeypatch):
    """The large-state path under ``enable_complex128``, forced at n = 10
    with every pass chunked (``tests/test_torch_complex128_huge.py``'s
    forcing): ``Simulator.run``'s float64 planes, the axis marginals and a
    Pauli string, ``run_step_by_step``'s last snapshot, a monomial-splice
    trajectory on the card's draws and vec(rho) at 2n = 10, card against
    CPU within 1e-12, every kernel launch a float64 one."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise, config,
                                             DensityMatrixSimulator,
                                             DepolarizingNoise, NoiseModel)
    from quantum_simulator_tpu_torch.ops import bigstate, bigtraj

    monkeypatch.setattr(bigstate, "HUGE_MIN_QUBITS", 10)
    monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
    monkeypatch.setattr(tplan, "CHUNK_ELEMS", 512)
    circuit = QuantumCircuit.from_dict(build_circuit_dict(10, 8, 3, mix_rz))
    program = tprog.compile_circuit(circuit)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.05))
    nm.add_global_noise(AmplitudeDampingNoise(0.1))
    config.enable_complex128()
    try:
        cuda_exec.reset_launch_counts()
        out = {}
        for dev in ("cuda", "cpu"):
            fs = Simulator(device=dev).run(circuit, shots=0).final_state
            assert fs.state_data.dtype == torch.float64
            steps = list(Simulator(device=dev).run_step_by_step(circuit))
            out[dev] = (fs.state_data.cpu(),
                        fs._get_marginals(),
                        fs.expectation_pauli_string([0, 5, 9], "XYZ"),
                        steps[-1][0].qubit_probabilities())
        assert bigtraj.trajectory_evolve_route(program, nm) == "monomial"
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        xs, planar, draws = bigtraj.huge_trajectory_state_body(
            program, nm, program.initial_params, 2, "cuda", gen)
        xc, _, _ = bigtraj.huge_trajectory_state_body(
            program, nm, program.initial_params, 2, "cpu", None,
            [(a.cpu(), b.cpu()) for a, b in draws])
        small = QuantumCircuit.from_dict(build_circuit_dict(5, 4, 2, mix_rz))
        rho = [DensityMatrixSimulator(nm, device=dev).run(
            small, method="superop") for dev in ("cuda", "cpu")]
        torch.cuda.synchronize()
    finally:
        config.enable_complex64()
    assert cuda_exec.dense_axis.launches == 0
    assert cuda_exec.cross_bit_axis.launches == 0
    assert cuda_exec.dense_axis_f64.launches > 0
    card, cpu = out["cuda"], out["cpu"]
    assert float((card[0] - cpu[0]).abs().max()) <= 1e-12
    assert all(np.abs(a - b).max() <= 1e-12 for a, b in zip(card[1], cpu[1]))
    assert abs(card[2] - cpu[2]) <= 1e-12
    assert np.abs(card[3] - cpu[3]).max() <= 1e-12
    assert xs.dtype == torch.float64
    assert float((xs.cpu() - xc).abs().max()) <= 1e-12
    assert rho[0].state_data.dtype == torch.float64
    assert np.abs(rho[0].probabilities - rho[1].probabilities).max() <= 1e-12
    assert abs(rho[0].purity() - rho[1].purity()) <= 1e-12


@pytest.mark.parametrize("route", ["grouped", "per-gate"])
def test_complex128_mesh_card_equals_cpu(cuda, route, monkeypatch):
    """The 8-shard mesh under ``enable_complex128`` at n = 17 (14 local
    qubits: the grouped route's mini plans, with cross steps; the
    per-gate route forced by raising the threshold), card against the
    CPU mesh within 1e-12: a run, ``run_segmented`` and a sharded VQE
    step, every kernel launch a float64 one, as many as the mini plans'
    dense and cross steps."""
    from quantum_simulator_tpu_torch import config, models
    from quantum_simulator_tpu_torch.parallel import (DistributedSimulator,
                                                      make_mesh,
                                                      make_vqe_mesh,
                                                      sharded_vqe_step)
    from quantum_simulator_tpu_torch.parallel import distributed as tdist

    if route == "per-gate":
        monkeypatch.setattr(tdist, "_GROUPED_SHARD_MIN_QUBITS", 15)
    c = models.hardware_efficient_ansatz(17, 3, initial_angle=0.4)
    out = {}
    config.enable_complex128()
    try:
        for dev in ("cuda", "cpu"):
            mesh = make_mesh(8, device=dev)
            body = tdist._ShardBody(tprog.compile_circuit(c), mesh)
            assert body.grouped == (route == "grouped")
            cuda_exec.reset_launch_counts()
            sim = DistributedSimulator(mesh)
            st = sim.run(c)
            torch.cuda.synchronize()
            launches = (cuda_exec.dense_axis_f64.launches,
                        cuda_exec.cross_bit_axis_f64.launches,
                        cuda_exec.dense_axis.launches
                        + cuda_exec.cross_bit_axis.launches)
            step = sharded_vqe_step(c, make_vqe_mesh(8, device=dev),
                                    observable=[(1.0, [0, 16]), (0.5, [8])])
            out[dev] = (st.device_data.cpu(), launches,
                        sim.run_segmented(c, 3).device_data.cpu(),
                        float(step.step(step.init)[1]),
                        [seg for seg in body.segments or []
                         if seg[0] == "run"])
    finally:
        config.enable_complex64()
    card, cpu = out["cuda"], out["cpu"]
    assert card[0].dtype == torch.float64
    assert float((card[0] - cpu[0]).abs().max()) <= 1e-12
    assert float((card[2] - card[0]).abs().max()) <= 1e-12
    assert abs(card[3] - cpu[3]) <= 1e-12
    dense, cross, f32 = card[1]
    assert f32 == 0
    if route == "grouped":
        runs = [tplan.build_group_plan(seg[1]) for seg in card[4]]
        assert dense == sum(isinstance(s, tplan.AxisMatmulStep)
                            for p in runs for s in p.steps) > 0
        assert cross == sum(isinstance(s, tplan.CrossStep)
                            for p in runs for s in p.steps) > 0
    else:
        assert dense == cross == 0


def test_complex128_mps_family_card_equals_cpu(cuda):
    """The MPS family under ``enable_complex128``, card against CPU: a
    state against the statevector (1e-12), noisy counts on the same
    draws, DMRG, the MPS Lindblad records and the correlator (1e-10), no
    NaN in any factorisation's output."""
    from quantum_simulator_tpu_torch import (DepolarizingNoise, NoiseModel,
                                             config, models)
    from quantum_simulator_tpu_torch import correlators as tc
    from quantum_simulator_tpu_torch import dmrg as td
    from quantum_simulator_tpu_torch import lindblad_mps as tl
    from quantum_simulator_tpu_torch import mps as tm

    c = _mps_brick(12, 6, 2)
    cn = _mps_brick(16, 4, 3)
    nm = NoiseModel()
    nm.add_global_noise(DepolarizingNoise(0.02))
    gen = torch.Generator().manual_seed(5)
    g = tm.draw_gumbels(64, tm.draw_branches(cn, nm), gen, "cpu")
    u = torch.rand((64, 16), generator=gen)
    gl = tm.gumbel_from_uniform(torch.rand((4, 6, 6, 2), generator=gen))
    h6 = models.tfim_chain(6)
    out = {}
    config.enable_complex128()
    try:
        psi = Simulator(device="cuda").run(c, shots=0).final_state.data
        for dev in ("cuda", "cpu"):
            _, st = _mps_on(dev, 64).run(c, shots=0)
            assert st.tensors[0].dtype == torch.complex128
            counts, disc = _mps_on(dev).run_with_noise(
                cn, nm, shots=64, gumbels=g, uniforms=u)
            e = td.dmrg_ground_state(h6, 6, chi=8, sweeps=4,
                                     device=dev).energy
            lind = tl.MPSLindbladSimulator(
                6, h6, [(0.2, "sigma_minus", q) for q in range(6)], chi=8,
                device=dev).evolve(0.6, 6, n_trajectories=4,
                                   observables=[("Z", [0]), ("XX", [2, 3])],
                                   gumbels=gl)
            _, corr = tc.mps_two_point_correlator(6, h6, 0.5, 8, 1, 4,
                                                  chi=8, device=dev)
            out[dev] = (tm.to_statevector(st), counts, disc, e,
                        lind.expectations, corr)
    finally:
        config.enable_complex64()
    card, cpu = out["cuda"], out["cpu"]
    for a in (card[0], card[4], card[5]):
        assert np.isfinite(a).all()
    assert np.abs(card[0] - psi).max() <= 1e-12
    assert card[1] == cpu[1] and np.isfinite(card[2])
    assert abs(card[3] - cpu[3]) <= 1e-10
    assert np.abs(card[4] - cpu[4]).max() <= 1e-10
    assert np.abs(card[5] - cpu[5]).max() <= 1e-10


# ---------------------------------------------------------------------------
# The pair-diagonal kernel (csrc/diag_pair.cu)
# ---------------------------------------------------------------------------

DIAG_FORMS = [(True, False), (True, True), (False, True)]  # (planar, real)
# Each output is one complex (or real) product of two numbers of the
# state's dtype: the kernel's FMA and the twin's K = 2 GEMM round it
# differently by a few ulp of |x d| <= ~30 for N(0, 1) inputs.
DIAG_TOL = {torch.float32: 2e-5, torch.float64: 1e-13}


def _diag_table(shape, axis_a, axis_b, real, device, seed, dtype,
                batch=None, shared=False):
    rng = np.random.default_rng(seed)
    tab = ((1 if real else 2), shape[axis_a], shape[axis_b])
    rows = 1 if (batch is None or shared) else batch
    d = torch.from_numpy(rng.standard_normal((rows,) + tab)).to(
        device=device, dtype=dtype)
    if real:
        d = d[:, 0]
    if batch is None:
        return d[0]
    return d.expand((batch,) + tuple(d.shape[1:])) if shared else d


def _check_diag(x, d, axis_a, axis_b, planar, batched=False):
    want = cuda_exec.diag_pair_plain(x, d, axis_a, axis_b, planar, batched)
    ptr = x.data_ptr()
    before = cuda_exec.diag_pair.launches
    got = cuda_exec.diag_pair(x, d, axis_a, axis_b, planar, batched)
    torch.cuda.synchronize()
    assert got is x and x.data_ptr() == ptr
    assert cuda_exec.diag_pair.launches == before + 1
    tol = DIAG_TOL[x.dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planar,real", DIAG_FORMS)
def test_diag_pair_matches_twin_on_every_axis_pair(cuda, planar, real,
                                                   dtype):
    """Every axis pair of a 5-axis layout, both orders: the table read
    one entry a pack, the next entries (axis_b innermost) or entries S_b
    apart (axis_a innermost); in place, each launch counted."""
    shape = (4, 8, 8, 8, 8)
    for a in range(5):
        for b in range(5):
            if a == b:
                continue
            x = _state(shape, planar, cuda, seed=5 * a + b).to(dtype)
            d = _diag_table(shape, a, b, real, cuda, 10 * a + b, dtype)
            _check_diag(x, d, a, b, planar)


@pytest.mark.parametrize("shape,pairs", [((8, 2), [(0, 1), (1, 0)]),
                                         ((2, 16, 2), [(0, 2), (1, 2),
                                                       (0, 1)])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planar,real", DIAG_FORMS)
def test_diag_pair_innermost_axis_under_a_pack(cuda, shape, pairs, planar,
                                               real, dtype):
    """An innermost axis of 2 holds no 16-byte pack of float32 (nor, with
    (8, 2), past one of float64): one amplitude a thread."""
    for a, b in pairs:
        x = _state(shape, planar, cuda, seed=a + 3 * b).to(dtype)
        d = _diag_table(shape, a, b, real, cuda, a * 7 + b, dtype)
        _check_diag(x, d, a, b, planar)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planar,real", DIAG_FORMS)
def test_diag_pair_batched_matches_twin(cuda, planar, real, dtype, shared):
    """One launch for a batch of trajectories: one table each, or one
    shared with stride 0, which gives bit for bit what its copies give."""
    shape = (4, 16, 128)
    for a, b in ((0, 2), (1, 2), (0, 1)):
        x = _batch_state(5, shape, planar, cuda, seed=a + b).to(dtype)
        d = _diag_table(shape, a, b, real, cuda, 30 + a + b, dtype, batch=5,
                        shared=shared)
        assert (d.stride(0) == 0) == shared
        loop = torch.stack([cuda_exec.diag_pair_plain(x[t], d[t], a, b,
                                                      planar)
                            for t in range(5)])
        torch.testing.assert_close(
            cuda_exec.diag_pair_plain(x, d, a, b, planar, True), loop)
        copied = cuda_exec.diag_pair(x.clone(), d.contiguous(), a, b, planar,
                                     True)
        _check_diag(x, d, a, b, planar, True)
        if shared:
            assert torch.equal(x, copied)


def test_diag_pair_strided_and_unaligned_inputs(cuda):
    """A transposed view (what an einsum or a swap below 4 GiB may leave)
    is refused by the wrapper and taken as ``.contiguous()`` by the step;
    a state 4 bytes off a 16-byte boundary takes the one-amplitude path."""
    shape = (4, 16, 16, 8)
    x = _state(shape, True, cuda, seed=3).transpose(2, 3)
    assert not x.is_contiguous()
    d = _diag_table(shape, 1, 3, False, cuda, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_exec.diag_pair(x, d, 1, 3, True)
    p = tprog.compile_circuit(QuantumCircuit.from_dict({
        "version": "1.0", "num_qubits": 14,
        "gates": [{"name": "H", "targets": [q], "params": [], "column": 0}
                  for q in range(14)]
        + [{"name": "CPhase", "targets": [4, 13], "params": [0.3],
            "column": 1},
           {"name": "SWAP", "targets": [5, 12], "params": [],
            "column": 2},
           {"name": "CPhase", "targets": [5, 12], "params": [0.7],
            "column": 3}]}))
    plan = tplan.build_group_plan(p)
    ops = tplan.operands_to(
        tplan.build_group_operands(p, plan, p.initial_params), cuda)
    kinds = [type(s).__name__ for s in plan.steps]
    assert "DiagPairStep" in kinds and "BitPairStep" in kinds
    x0 = tplan.basis_state(plan, p.initial_index, cuda, True)
    want = tplan.execute_group_plan(plan, ops, p, p.initial_params,
                                    x0.clone(), True, plain=True)
    cuda_exec.reset_launch_counts()
    got = tplan.execute_group_plan(plan, ops, p, p.initial_params, x0, True)
    torch.cuda.synchronize()
    assert cuda_exec.diag_pair.launches == kinds.count("DiagPairStep")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    flat = torch.empty(2 * 4 * 16 * 16 * 8 + 1, device=cuda)
    xu = flat[1:].view((2,) + shape)
    assert xu.data_ptr() % 16 == 4
    xu.copy_(_state(shape, True, cuda, seed=5))
    _check_diag(xu, d, 1, 3, True)


def _qft_30_circuit():
    from qsbench.families import qft as qft_family

    return QuantumCircuit.from_dict(qft_family.circuit(
        {"num_qubits": 30, "approximation_degree": 0, "do_swaps": True},
        np.random.default_rng(11)))


def test_diag_pair_n30_qft_first_diagonal_matches_chunked_twin(cuda):
    """The QFT-30 plan's first pair diagonal, on an 8 GiB planar state:
    the kernel over the whole state in one launch against the chunked
    einsum twin (``plain=True``, 32 chunks), compared chunk by chunk. One
    fp32 complex product an amplitude on both sides: 2e-5 for N(0, 1)
    amplitudes and a unit-modulus table."""
    p = tprog.compile_circuit(_qft_30_circuit())
    plan = tplan.get_group_plan(p)
    step = next(s for s in plan.steps if isinstance(s, tplan.DiagPairStep))
    ops = tplan.operands_to(
        tplan.build_group_operands(p, plan, p.initial_params), cuda)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((2,) + tuple(plan.layout.axis_sizes), generator=gen,
                    device=cuda)
    want = tplan.apply_diag_pair_step(x.clone(), plan, step, ops[2], True,
                                      plain=True)
    cuda_exec.reset_launch_counts()
    got = tplan.apply_diag_pair_step(x, plan, step, ops[2], True)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr()
    assert cuda_exec.diag_pair.launches == 1
    worst = max(float((got[:, i] - want[:, i]).abs().max())
                for i in range(got.shape[1]))
    del got, want, x
    torch.cuda.empty_cache()
    assert worst <= 2e-5, worst


def test_qft_30_request_counts_one_diag_launch_a_step(cuda):
    """A QFT-30 ``Simulator.run``: one ``diag_pair`` launch per
    ``DiagPairStep`` (10), each step's pass record one chunk, the fiber
    kernels' launch records untouched by them, and one ``swap_bits``
    launch serving the 14 swaps."""
    from quantum_simulator_tpu_torch.utils import profiling

    c = _qft_30_circuit()
    plan = tplan.get_group_plan(tprog.compile_circuit(c))
    n_diag = sum(isinstance(s, tplan.DiagPairStep) for s in plan.steps)
    n_fiber = sum(isinstance(s, (tplan.AxisMatmulStep, tplan.CrossStep))
                  for s in plan.steps)
    assert n_diag == 10
    torch.cuda.empty_cache()
    cuda_exec.reset_launch_counts()
    with profiling.recording() as rec:
        res = Simulator(device="cuda").run(c, shots=256, seed=1)
        torch.cuda.synchronize()
    assert sum(res.measurement_counts.values()) == 256
    del res
    torch.cuda.empty_cache()
    assert cuda_exec.diag_pair.launches == n_diag
    diag = [ps for ps in rec.passes if ps.kind == "diag"]
    assert len(diag) == n_diag and all(ps.chunks == 1 for ps in diag)
    assert len(rec.launches) == n_fiber
    # the 14 swaps: one run, one swap_bits launch, one pass of one chunk
    assert (cuda_exec.swap_bits.launches, cuda_exec.swap_bits.swaps) == (
        1, 14)
    assert [(ps.chunks, ps.swap) for ps in rec.passes
            if ps.kind == "bitpair"] == [(1, True)]


# ---------------------------------------------------------------------------
# The swap kernel (csrc/swap_bits.cu)
# ---------------------------------------------------------------------------

def _swap_circuit(n, swaps):
    c = QuantumCircuit(n)
    for q in range(n):
        c.add("H", [q], [], 0)
    for col, (a, b) in enumerate(swaps, 1):
        c.add("SWAP", [a, b], [], col)
    return c


# Runs the kernel serves on its three paths: the QFT's (the tile's column
# bits against the top bits: tiles permuted through shared memory), one
# with no bit in the tile's columns (tiles exchanged in 16-byte packs) and
# one touching bits 5-6 of the innermost axis (the last float32 column bit
# and the first bit past it; both past the float64 columns).
SWAP_CASES = {
    "qft12": (12, None), "qft20": (20, None), "qft28": (28, None),
    "high20": (20, [(0, 7), (1, 8), (2, 9)]),
    "bits5-6_20": (20, [(13, 0), (14, 1)]),
}


def _swap_plan(case):
    n, swaps = SWAP_CASES[case]
    c = _qft(n) if swaps is None else _swap_circuit(n, swaps)
    plan = tplan.build_group_plan(tprog.compile_circuit(c))
    runs = tplan.swap_runs(plan)
    assert runs
    return plan, [tuple(plan.steps[i] for i in r) for r in runs]


# Batched: 3 trajectories, at n <= 20 (a batch of n = 28 states is the
# n = 20 geometry with a longer outer loop).
SWAP_FORMS = [(case, planar, batched) for case in SWAP_CASES
              for planar, batched in ((True, False), (False, False),
                                      (True, True))
              if not (batched and SWAP_CASES[case][0] > 20)]


@pytest.mark.parametrize("case,planar,batched", SWAP_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_swap_bits_run_equals_the_plain_steps_bit_for_bit(cuda, case, dtype,
                                                          planar, batched):
    """Each run of the plan in one launch, in place, against its swap
    steps one by one as the ``plain=True`` executor runs them (chunked
    from 4 GiB): the same bits."""
    plan, runs = _swap_plan(case)
    shape = ((3,) if batched else ()) + ((2,) if planar else ()) + tuple(
        plan.layout.axis_sizes)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    for run in runs:
        x = torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
        want = x.clone()
        for s in run:
            want = tplan.apply_bitpair_step(want, plan, s, None, planar,
                                            batched)
        cuda_exec.reset_launch_counts()
        ptr = x.data_ptr()
        got = tplan.apply_bitpair_step(x, plan, run[0], None, planar,
                                       batched, run=run)
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr
        assert (cuda_exec.swap_bits.launches,
                cuda_exec.swap_bits.swaps) == (1, len(run))
        assert torch.equal(got, want)
        del x, got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("pairs", [[(0, 2), (1, 9), (5, 12)], [(3, 4)],
                                   [(q, 12 - q) for q in range(6)],
                                   [(6, 11), (7, 9)]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_swap_bits_matches_the_index_map(cuda, pairs, dtype):
    """Pairs no plan emits too (two bits inside the tile's columns, one
    lone pair inside them), on a batch of planar states, and a state 4
    bytes off a 16-byte boundary (the exchange path one element a
    thread): the kernel equals the plain twin's gather."""
    x = _batch_state(3, (4, 16, 128), True, cuda, seed=4).to(dtype)
    want = cuda_exec.swap_bits_plain(x, pairs, True, True)
    got = cuda_exec.swap_bits(x, pairs, True, True)
    torch.cuda.synchronize()
    assert got is x and torch.equal(got, want)
    flat = torch.empty(2 * 8192 + 1, device=cuda, dtype=dtype)
    xu = flat[1:].view(2, 8192)
    assert xu.data_ptr() % 16
    xu.copy_(_state((8192,), True, cuda, seed=9).to(dtype))
    want = cuda_exec.swap_bits_plain(xu, pairs, True)
    assert torch.equal(cuda_exec.swap_bits(xu, pairs, True), want)


def test_swap_bits_rejects_what_the_kernel_does_not_take(cuda):
    """A strided view, a qubit two swaps of the run share, a half-precision
    state: refused before any launch."""
    x = _state((4, 128, 128), True, cuda)
    cuda_exec.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_exec.swap_bits(x.transpose(2, 3), [(0, 15)], True)
    with pytest.raises(ValueError, match="shares a bit"):
        cuda_exec.swap_bits(x, [(0, 15), (15, 3)], True)
    with pytest.raises(TypeError):
        cuda_exec.swap_bits(x.half(), [(0, 15)], True)
    assert cuda_exec.swap_bits.launches == 0


def test_swap_bits_n30_qft_run_in_place_in_one_launch(cuda):
    """The QFT-30 plan's 14 swaps on an 8 GiB planar state: one launch,
    the state's own memory and under 64 MiB more at the peak, and the
    bits of the chunked transposes one step at a time, compared chunk by
    chunk."""
    p = tprog.compile_circuit(_qft_30_circuit())
    plan = tplan.get_group_plan(p)
    (run,) = tplan.swap_runs(plan)
    steps = tuple(plan.steps[i] for i in run)
    assert len(steps) == 14
    torch.cuda.empty_cache()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((2,) + tuple(plan.layout.axis_sizes), generator=gen,
                    device=cuda)
    want = x.clone()
    for s in steps:
        want = tplan.apply_bitpair_step(want, plan, s, None, True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    got = tplan.apply_bitpair_step(x, plan, steps[0], None, True, run=steps)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr()
    assert torch.cuda.max_memory_allocated() - base <= 64 * 2**20
    assert (cuda_exec.swap_bits.launches, cuda_exec.swap_bits.swaps) == (
        1, 14)
    worst = _grouped_max_diff(got, want)
    del got, want, x
    torch.cuda.empty_cache()
    assert worst == 0.0


def test_esu2_30_thermal_trajectory_follows_its_kraus_replay(cuda):
    """One n = 30 trajectory of the thermal-relaxation configuration
    (``qsbench/configs/esu2_30_thermal.json``) through
    ``Simulator.run_with_noise``, the cell's own entry recording it: the
    monomial splice serves 91 windows and 294 sites, and the 8 GiB
    trajectory state lies within 1e-5 of the float64 replay of its own
    branches (``qsbench/reference/kraus.py``): complex64 products and
    sums over 327 gates and 294 sites, a few 1e-6."""
    import quantum_simulator_tpu_torch as tq
    from qsbench.cell import Manifest
    from quantum_simulator_tpu_torch.ops import monomial_traj

    m = Manifest()
    cfg = m.config("esu2_30_thermal")
    family = m.module("families", cfg["family"])
    traffic = m.traffic(m.workload("esu2_30_thermal.noisy")["traffic"])
    entry = m.module("entries", traffic["entry"])
    c = family.circuit(cfg, np.random.default_rng(3))
    torch.cuda.empty_cache()
    serve = entry.serve_fn(tq, dict(traffic, trajectories=1), "cuda")
    windows = monomial_traj._run_windows.windows
    sites = monomial_traj._run_windows.sites
    (row,) = entry.answer(serve(c, 5, keep=True))["rows"]
    assert row["route"] == "monomial"
    assert monomial_traj._run_windows.windows - windows == 91
    assert monomial_traj._run_windows.sites - sites == 294
    gap = entry.state_gap(c, row, "cuda")
    del row
    torch.cuda.empty_cache()
    assert gap < 1e-5, gap
