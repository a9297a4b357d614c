"""CUDA kernels of the PyTorch port vs their plain PyTorch twins, on a card.

Marked ``gpu``: they skip (with a reason) where no CUDA device exists.
The file imports torch and the port only, so it also runs where JAX is
not installed. Run on a machine with a card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)
Tolerances are those of ``tests/test_pallas_exec.py``: 2e-4 dense, 2e-3
cross, as the sums run in another order than cuBLAS's.
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
        got = cuda_exec.dense_axis(x, op, axis, planar)
        torch.cuda.synchronize()
        want = cuda_exec.dense_axis_plain(x, op, axis, planar)
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
    got = cuda_exec.cross_bit_axis(x, cop, s, pos, o, planar)
    torch.cuda.synchronize()
    want = cuda_exec.cross_bit_axis_plain(x, cop, s, pos, o, planar)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


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
