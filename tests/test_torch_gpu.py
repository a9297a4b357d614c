"""CUDA kernels of the PyTorch port vs their plain PyTorch twins, on a card.

Marked ``gpu``: they skip (with a reason) where no CUDA device exists.
The file imports torch and the port only, so it also runs where JAX is
not installed. Run on a machine with a card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)
Tolerances are those of ``tests/test_pallas_exec.py``: 2e-4 dense, 2e-3
cross, as the sums run in another order than cuBLAS's. The kernels write
in place, so every twin runs on the state before the kernel does.
"""

import numpy as np
import pytest
import torch

from bench import build_circuit_dict
from quantum_simulator_tpu_torch import QuantumCircuit, Simulator
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


# chip_smoke.py's CROSS_CASES: every cross geometry of the brickwork plans
# at n = 16, 28 and 30, plus a sliced bit inside the last axis.
LAYOUTS = {16: (4, 128, 128), 28: (128,) * 4, 30: (4,) + (128,) * 4}
SMOKE_CROSS = [(16, 1, 0, 0), (16, 1, 6, 2), (28, 0, 6, 1), (28, 1, 6, 2),
               (28, 2, 6, 3), (30, 1, 0, 0), (30, 1, 6, 2), (30, 2, 6, 3),
               (30, 3, 6, 4), (16, 2, 3, 0), (28, 3, 0, 1)]


@pytest.mark.parametrize("n,s,pos,o", SMOKE_CROSS)
def test_cross_slab_loop_on_main_path_geometries(cuda, n, s, pos, o):
    """K = 256 streams the operator in slabs of output rows; every main
    path geometry, real operator on a real state (complex at n = 16)."""
    shape = LAYOUTS[n]
    S = shape[o]
    variants = [(False, True)] + ([(True, False)] if n == 16 else [])
    for planar, real in variants:
        cop = _scaled_op((2, S, 2, S), real, cuda, seed=8)
        _check_cross(_state(shape, planar, cuda), cop, s, pos, o, planar)
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
    with pytest.raises(TypeError):
        cuda_exec.dense_axis(x.double(), op.double(), 2, True)
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


def test_qft_with_strided_steps_goes_through_the_kernels(cuda):
    """QFT's pair diagonals and swaps hand the kernels strided views."""
    c = QuantumCircuit(12)
    col = 0
    for i in range(12):
        c.add("H", [i], [], col)
        col += 1
        for j in range(i + 1, 12):
            c.add("CPhase", [j, i], [np.pi / 2 ** (j - i)], col)
            col += 1
    for i in range(6):
        c.add("SWAP", [i, 11 - i], [], col)
        col += 1
    p = tprog.compile_circuit(c)
    cuda_exec.reset_launch_counts()
    got = tplan.group_forward_body(p, p.initial_params, cuda)
    assert cuda_exec.dense_axis.launches > 0
    probs = got.abs().square()
    assert float((probs - 2.0 ** -12).abs().max()) <= 1e-9


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


def _step_counts(plan):
    return (sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps),
            sum(isinstance(s, tplan.CrossStep) for s in plan.steps))


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


# ---------------------------------------------------------------------------
# Large states (n >= 30)
# ---------------------------------------------------------------------------

def test_simulator_run_n30_holds_under_two_states(cuda):
    """``Simulator.run`` at n = 30 returns the executor's planar state as
    it is: its peak stays under 1.75x the 8 GiB state (a complex copy, a
    full probability vector or a 2^n histogram would each break that)."""
    from quantum_simulator_tpu_torch import PlanarStateVector

    circuit = QuantumCircuit.from_dict(
        build_circuit_dict(30, 4, seed=1, mix_rz=True))
    program = tprog.compile_circuit(circuit)
    plan = tplan.get_group_plan(program)
    assert not plan.all_real
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    res = Simulator(device="cuda").run(circuit, shots=4096, seed=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fs = res.final_state
    assert isinstance(fs, PlanarStateVector) and fs.is_planar
    assert peak < 1.75 * (8 << 30), peak / 2**30
    assert sum(res.measurement_counts.values()) == 4096
    assert abs(fs.norm_sq() - 1.0) < 1e-4
    n_dense = sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps)
    n_cross = sum(isinstance(s, tplan.CrossStep) for s in plan.steps)
    assert cuda_exec.dense_axis.launches == n_dense
    assert cuda_exec.cross_bit_axis.launches == n_cross


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


def test_fold_trajectory_n30_launches_one_kernel_per_gate(cuda):
    """One fold-executor trajectory at n = 30 (a channel that is neither
    mixed-unitary nor monomial): every gate with its draws is one launch,
    on one 4 GiB real state."""
    from quantum_simulator_tpu_torch import (AmplitudeDampingNoise,
                                             NoiseChannel, NoiseModel)
    from quantum_simulator_tpu_torch.ops import bigtraj

    class XDamp(NoiseChannel):
        @property
        def probability(self):
            return 0.05

        def get_kraus_operators(self):
            h = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
            return [h @ np.asarray(k) @ h for k in
                    AmplitudeDampingNoise(0.05).get_kraus_operators()]

    nm = NoiseModel()
    nm.add_global_noise(XDamp())
    program = tprog.compile_circuit(
        QuantumCircuit.from_dict(build_circuit_dict(30, 2, seed=2)))
    assert bigtraj.trajectory_evolve_route(program, nm) == "fold"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_exec.reset_launch_counts()
    x, planar, draws = bigtraj.huge_trajectory_state_body(
        program, nm, program.initial_params, 1, "cuda", gen)
    torch.cuda.synchronize()
    launches = cuda_exec.dense_axis.launches + \
        cuda_exec.cross_bit_axis.launches
    assert launches == len(program.ops)
    assert not planar and tuple(x.shape) == (1, 4, 128, 128, 128, 128)
    assert torch.cuda.max_memory_allocated() < 1.75 * (4 << 30)
    assert abs(float(bigtraj.batched_norm_sq(x)[0]) - 1.0) < 1e-4
    # one draw per gate target (one one-qubit channel on every gate)
    assert draws.shape == (1, sum(len(op.targets) for op in program.ops))


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


@pytest.mark.parametrize("mix_rz", [False, True])
def test_superop_program_goes_through_the_kernels(cuda, mix_rz):
    """vec(rho) at 2n = 24 through ``DensityMatrixSimulator``: one launch
    per dense and cross step of the vec(rho) plan, within 1e-5 of the
    twin executor and 2e-5 of the dense route."""
    from quantum_simulator_tpu_torch import DensityMatrixSimulator
    from quantum_simulator_tpu_torch.density import superop_program

    circuit = QuantumCircuit.from_dict(
        build_circuit_dict(12, 4, seed=3, mix_rz=mix_rz))
    nm = _open_noise()
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
    assert res.purity() < 0.999


def test_superop_n15_is_a_grouped_state_under_two_states(cuda):
    """n = 15: vec(rho) is a 30-qubit real grouped state (4 GiB) that is
    never copied; ``.rho`` raises."""
    from quantum_simulator_tpu_torch import DensityMatrixSimulator
    from quantum_simulator_tpu_torch.density import SuperopDensityResult

    circuit = QuantumCircuit.from_dict(build_circuit_dict(15, 4, seed=4))
    sim = DensityMatrixSimulator(noise_model=_open_noise(), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = sim.run(circuit)
    torch.cuda.synchronize()
    assert isinstance(res, SuperopDensityResult) and not res.is_planar
    assert torch.cuda.max_memory_allocated() < 1.75 * (4 << 30)
    with pytest.raises(MemoryError):
        res.rho
    assert abs(res.trace() - 1.0) <= 1e-4
    assert 0.0 < res.purity() < 0.999
    counts = sim.sample(res, 1000, rng=np.random.default_rng(0))
    assert sum(counts.values()) == 1000


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
    (ideal 1-gate, realness flip, noisy 1-gate) under 2 s."""
    from quantum_simulator_tpu_torch.scripts import interactive_latency_check
    got = _twin_json(interactive_latency_check,
                     ["-n", "16", "--depth", "8", "--skip-subprocess"],
                     "cuda", tmp_path)
    assert got["platform"] == "gpu" and got["edit_under_2s"]
    assert got["device"] == torch.cuda.get_device_name(0)
