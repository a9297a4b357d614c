"""Exact density-matrix simulation: deterministic noisy evolution.

Counterpart of ``quantum_simulator_tpu/density.py``. rho evolves as

    rho -> U rho U^dag                 per gate
    rho -> sum_m K_m rho K_m^dag       per noise channel per target

on one of two routes.

**Dense route** (n <= ``MAX_DM_QUBITS``): rho is a ``(2^n, 2^n)`` complex
tensor on the device, viewed as a flat 2n-qubit state whose first n
qubits are the row index and whose last n are the column index. ``U rho``
is then ``ops.apply.apply_gate`` on the row targets and ``rho U^dag`` is
``apply_gate`` with ``conj(U)`` on the mirrored column targets
(``targets + n``): no transposed copy and no loop over columns (the JAX
package vmaps ``apply_gate`` over them). Memory is O(4^n): a 16384^2
complex64 rho is 2 GiB. No hand-written kernel is involved on this route:
every contraction is a ``torch.einsum`` over a strided view.

**Superoperator route** (n <= ``MAX_SUPEROP_QUBITS``):
``superop_program`` lowers the circuit and its noise model to a 2n-qubit
vec(rho) program that rides the statevector group executor
(``ops/plan.py``), so each of its dense and cross steps is one launch of
the ``dense_axis`` / ``cross_bit_axis`` CUDA kernels. At n = 15 vec(rho)
is a 30-qubit state and takes the large-state path
(``ops/bigstate.is_huge``): the grouped tensor (float32 planes, float64
under ``enable_complex128``) is kept as it is and wrapped in a
``SuperopDensityResult``.

The port runs eagerly and has no per-structure compile, so the JAX
package's jit cache (``_cache_get``), its entry layout plumbing
(``entry_format``) and its complex transfer helper (``to_host_complex``)
have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG
from .ops import bigstate
from .ops import program as prog
from .ops.apply import apply_gate

#: Exact DM state is O(4^n); the dense rho path caps here.
MAX_DM_QUBITS = 14
#: The vectorized-superoperator path treats vec(rho) as a 2n-qubit state
#: on the statevector executor: n = 15 is a 2^30 state, where the
#: large-state regime (``bigstate.HUGE_MIN_QUBITS``) starts.
MAX_SUPEROP_QUBITS = 15


def _flat(rho: torch.Tensor) -> torch.Tensor:
    """rho ``(..., 2^n, 2^n)`` as a ``(..., 4^n)`` 2n-qubit state (a view
    of a contiguous rho)."""
    return rho.reshape(tuple(rho.shape[:-2]) + (-1,))


def _apply_left(rho: torch.Tensor, u, targets, n: int) -> torch.Tensor:
    """rho -> U rho (contract the ROW index)."""
    return apply_gate(_flat(rho), u, tuple(targets), 2 * n).reshape(rho.shape)


def _apply_right_dag(rho: torch.Tensor, u, targets, n: int) -> torch.Tensor:
    """rho -> rho U^dag (contract the COLUMN index with conj(U))."""
    cu = torch.as_tensor(u, dtype=rho.dtype, device=rho.device).conj()
    return apply_gate(_flat(rho), cu, tuple(q + n for q in targets),
                      2 * n).reshape(rho.shape)


def _apply_unitary(rho: torch.Tensor, u, targets, n: int) -> torch.Tensor:
    return _apply_right_dag(_apply_left(rho, u, targets, n), u, targets, n)


def _apply_channel(rho: torch.Tensor, kraus, targets, n: int) -> torch.Tensor:
    """rho -> sum_m K_m rho K_m^dag on ``targets`` (kraus: (M, 2^k, 2^k)
    for a k-qubit channel: one-qubit (M,2,2) and correlated two-qubit
    (M,4,4) stacks both route here). The terms are accumulated one at a
    time, so the pass holds rho, the sum and one term, not M rhos."""
    acc = None
    for k in kraus:
        term = _apply_unitary(rho, k, tuple(targets), n)
        acc = term if acc is None else acc.add_(term)
    return acc


def _dm_body(program: prog.CircuitProgram, channels_for, params, dtype,
             device) -> torch.Tensor:
    n = program.num_qubits
    dim = 1 << n
    rho = torch.zeros((dim, dim), dtype=dtype, device=device)
    rho[program.initial_index, program.initial_index] = 1.0
    for op in program.ops:
        if op.cphase_value is not None:
            # Matrix-less controlled phase (MCZ_k, k > 10): D rho D^dag
            # for a product-form diagonal D is one elementwise pass:
            # rho[i, j] *= d_i * conj(d_j) with d = 1 + (v-1) * mask.
            mask = 0
            for q in op.targets:
                mask |= 1 << (n - 1 - q)  # qubit 0 = MSB
            idx = torch.arange(dim, dtype=torch.int64, device=device)
            d = torch.ones(dim, dtype=dtype, device=device)
            d[(idx & mask) == mask] = op.cphase_value
            rho.mul_(d[:, None]).mul_(d.conj()[None, :])
        else:
            u = program.op_matrix(op, params, np.complex128)
            rho = _apply_unitary(rho, u, op.targets, n)
        for kraus_np in channels_for(op.gate_name):
            kraus = torch.as_tensor(np.asarray(kraus_np), dtype=dtype,
                                    device=device)
            if kraus.shape[-1] == 4:
                # correlated two-qubit stack: fires once on the pair
                if len(op.targets) != 2:
                    raise ValueError(
                        "two-qubit Kraus channel configured for "
                        f"{len(op.targets)}-qubit gate {op.gate_name!r}")
                rho = _apply_channel(rho, kraus, op.targets, n)
            else:
                for q in op.targets:
                    rho = _apply_channel(rho, kraus, (q,), n)
    return rho


# ---------------------------------------------------------------------------
# Vectorized-superoperator route: vec(rho) as a 2n-qubit statevector
# ---------------------------------------------------------------------------
#
# vec(rho)[i * 2^n + j] = rho[i, j]: the row bits are qubits 0..n-1 of a
# 2n-qubit register (most significant, as qubit 0 is the MSB) and the
# column bits are qubits n..2n-1. Then
#
#   rho -> U rho U^dag        ==  U on the row targets  AND
#                                 conj(U) on the mirrored column targets
#   rho -> sum_m K_m rho K_m^dag  ==  ONE static 4x4 superoperator
#                                 S = sum_m kron(K_m, conj(K_m)) acting on
#                                 the (q, q+n) qubit pair
#
# so exact noisy evolution goes through the SAME group-matmul plan,
# composition windows, realness analysis and (at 2n >= 30) the in-place
# large-state executor as pure states. Real circuits with real Kraus
# superoperators evolve a REAL vec(rho): n = 15 exact DM = a 4 GiB f32
# tensor on one card.


def superop_program(program: prog.CircuitProgram,
                    noise_model=None) -> prog.CircuitProgram:
    """Lower an n-qubit circuit program (+ optional noise model) to the
    equivalent 2n-qubit vec(rho) program.

    A parameterized op's column twin keeps the gate name (realness and
    diagonality are read from names and survive conjugation) and takes
    conjugated builders, NumPy and torch. There is one conjugated wrapper
    PER DISTINCT original builder: the operand build groups parameterized
    ops by ``(gate_name, builder)`` (``plan._GateMatrixPool``,
    ``plan.param_overrides``), so the row ops and the column twins of a
    gate kind must differ in their builders, and all twins share one."""
    n = program.num_qubits
    ops2: list[prog.ProgramOp] = []
    super_cache: dict = {}
    conj_builders: dict = {}

    def _conj_builder_for(builder, conj):
        if builder is None:
            return None
        cb = conj_builders.get(builder)
        if cb is None:
            def cb(*p, _b=builder, _conj=conj):
                return _conj(_b(*p))
            conj_builders[builder] = cb
        return cb

    for op in program.ops:
        col_targets = tuple(q + n for q in op.targets)
        ops2.append(op)
        if op.cphase_value is not None:
            ops2.append(replace(op, targets=col_targets,
                                cphase_value=np.conj(op.cphase_value)))
        elif op.static_matrix is not None:
            ops2.append(replace(op,
                                static_matrix=np.conj(op.static_matrix),
                                targets=col_targets))
        else:
            ops2.append(replace(
                op, targets=col_targets,
                builder=_conj_builder_for(op.builder, np.conj),
                torch_builder=_conj_builder_for(op.torch_builder,
                                                torch.conj_physical)))
        if noise_model is not None:
            for ci, st in enumerate(
                    noise_model.kraus_stacks_for_gate(op.gate_name)):
                ck = (op.gate_name, ci)
                S = super_cache.get(ck)
                if S is None:
                    S = sum(np.kron(K, np.conj(K))
                            for K in np.asarray(st, np.complex128))
                    super_cache[ck] = S
                if S.shape[0] == 16:
                    # correlated two-qubit channel: one 16x16 superop on
                    # (q1, q2, q1+n, q2+n); the kron order matches the
                    # row-major target significance convention
                    if len(op.targets) != 2:
                        raise ValueError(
                            "two-qubit Kraus channel configured for "
                            f"{len(op.targets)}-qubit gate "
                            f"{op.gate_name!r}")
                    q1, q2 = op.targets
                    ops2.append(prog.ProgramOp(
                        "__superop__", (q1, q2, q1 + n, q2 + n), 0, 0,
                        op.column_index, S, None, -1))
                else:
                    for q in op.targets:
                        ops2.append(prog.ProgramOp(
                            "__superop__", (q, q + n), 0, 0,
                            op.column_index, S, None, -1))
    noise_key = noise_model.spec_key() if noise_model is not None else ()
    return prog.CircuitProgram(
        num_qubits=2 * n,
        initial_index=(program.initial_index << n) | program.initial_index,
        ops=tuple(ops2),
        num_columns=program.num_columns,
        num_params=program.num_params,
        initial_params=program.initial_params,
        compile_key=("superop", program.compile_key, noise_key))


def _expectation_z(probs: np.ndarray, num_qubits: int, qubit: int) -> float:
    idx = np.arange(1 << num_qubits)
    sign = 1.0 - 2.0 * ((idx >> (num_qubits - 1 - qubit)) & 1)
    return float(np.sum(probs * sign))


class SuperopDensityResult:
    """Result view for the 2n >= 30 vec(rho) path over the executor's
    grouped tensor in ``CONFIG.real_dtype``, planar ``(2, *axis_sizes)``
    or real ``(*axis_sizes,)``: diagonal-derived quantities
    (probabilities, trace, <Z>, sampling) plus purity, in float64. The full 2^n x 2^n rho would be a
    multi-GiB host copy and raises; no complex copy and no second state
    is made."""

    def __init__(self, num_qubits: int, state: torch.Tensor, planar: bool):
        self.num_qubits = num_qubits
        self._state = state
        self._planar = planar
        self._diag = None

    @property
    def state_data(self) -> torch.Tensor:
        """The grouped device tensor of vec(rho)."""
        return self._state

    @property
    def is_planar(self) -> bool:
        return self._planar

    def _diagonal(self) -> np.ndarray:
        """(2^n,) complex host diagonal via ONE device gather."""
        if self._diag is not None:
            return self._diag
        from .ops.plan import GroupLayout

        n = self.num_qubits
        layout = GroupLayout.for_qubits(2 * n)
        d = torch.arange(1 << n, dtype=torch.int64,
                         device=self._state.device)
        rem = (d << n) | d
        coords = []
        for size in reversed(layout.axis_sizes):
            coords.append(rem % size)
            rem = rem // size
        coords = tuple(reversed(coords))
        if self._planar:
            out = self._state[(slice(None),) + coords].double().cpu().numpy()
            self._diag = out[0] + 1j * out[1]
        else:
            self._diag = self._state[coords].double().cpu().numpy().astype(
                np.complex128)
        return self._diag

    @property
    def rho(self):
        raise MemoryError(
            f"the dense rho at n={self.num_qubits} is "
            f"{(1 << (2 * self.num_qubits)) * 8 / 2**30:.0f} GiB; use "
            ".probabilities/.purity()/.expectation_z()/sampling")

    @property
    def probabilities(self) -> np.ndarray:
        return np.maximum(np.real(self._diagonal()), 0.0)

    def purity(self) -> float:
        """tr(rho^2) = ||vec(rho)||^2: one chunked reduction of the
        grouped state, planar or real."""
        return float(bigstate.planar_norm_sq(self._state))

    def trace(self) -> float:
        return float(np.real(self._diagonal()).sum())

    def expectation_z(self, qubit: int) -> float:
        probs = self.probabilities
        return _expectation_z(probs, self.num_qubits, qubit) \
            / max(probs.sum(), 1e-30)


@dataclass
class DensityMatrixResult:
    """Host-facing view over the device-resident density matrix."""

    num_qubits: int
    device_rho: torch.Tensor

    @property
    def rho(self) -> np.ndarray:
        """Host copy as complex128."""
        return self.device_rho.cpu().numpy().astype(np.complex128)

    @property
    def probabilities(self) -> np.ndarray:
        return torch.diagonal(self.device_rho).real.double().cpu().numpy()

    def purity(self) -> float:
        """tr(rho^2) = sum |rho_ij|^2 for a Hermitian rho, reduced chunk
        by chunk in float64 over the real view (no rho-sized temporary)."""
        r = self.device_rho
        return float(bigstate.planar_norm_sq(
            torch.view_as_real(r) if r.is_complex() else r))

    def trace(self) -> float:
        return float(torch.diagonal(self.device_rho).real.sum(
            dtype=torch.float64))

    def expectation_z(self, qubit: int) -> float:
        return _expectation_z(self.probabilities, self.num_qubits, qubit)


class DensityMatrixSimulator:
    """Exact (non-stochastic) noisy simulation on ``device`` (default
    ``CONFIG.device``): dense rho to n <= 14, vectorized-superoperator
    vec(rho) through the group executor and its kernels to n <= 15."""

    def __init__(self, noise_model=None, device=None):
        self.noise_model = noise_model
        self._device = device or CONFIG.device

    def run(self, circuit: QuantumCircuit, dtype=None,
            method: str = "auto"):
        """``method``: 'auto' (dense to n<=14, superop at n=15),
        'dense', or 'superop'. Returns DensityMatrixResult, or
        SuperopDensityResult when vec(rho) takes the 2n >= 30 large-state
        path. ``dtype`` is the complex dtype of the returned rho; the
        superoperator route computes in ``CONFIG.real_dtype`` planes
        whatever it is (float64 under ``enable_complex128``, the 2n >= 30
        path included)."""
        n = circuit.num_qubits
        if method == "auto":
            method = "dense" if n <= MAX_DM_QUBITS else "superop"
        if method == "superop":
            if n > MAX_SUPEROP_QUBITS:
                raise ValueError(
                    f"vec(rho) at n={n} is a {2 * n}-qubit state — past "
                    f"the single-chip ceiling (cap {MAX_SUPEROP_QUBITS}); "
                    "run the superop program on the sharded engine or use "
                    "Simulator.ensemble_qubit_density_matrices")
            return self._run_superop(circuit, dtype)
        if n > MAX_DM_QUBITS:
            raise ValueError(
                f"exact dense-rho simulation is O(4^n); n={n} exceeds "
                f"the cap of {MAX_DM_QUBITS} — method='superop' reaches "
                f"{MAX_SUPEROP_QUBITS}, Monte-Carlo "
                "(Simulator.ensemble_density_matrix) beyond")
        dtype = dtype or CONFIG.dtype
        program = prog.compile_circuit(circuit)
        if self.noise_model is not None:
            channels_for = self.noise_model.kraus_stacks_for_gate
        else:
            channels_for = lambda name: []  # noqa: E731
        rho = _dm_body(program, channels_for, program.initial_params, dtype,
                       self._device)
        return DensityMatrixResult(num_qubits=n, device_rho=rho)

    def _run_superop(self, circuit: QuantumCircuit, dtype=None):
        """vec(rho) through the statevector group executor. Below the
        large-state regime this returns the full DensityMatrixResult (rho
        reshaped from the 2n-qubit vector); at 2n >= 30 the executor's
        grouped state is kept as it is, never complex, and wrapped in a
        SuperopDensityResult."""
        from .ops.plan import group_forward_body, group_forward_state_body

        dtype = dtype or CONFIG.dtype
        n = circuit.num_qubits
        program2 = superop_program(prog.compile_circuit(circuit),
                                   self.noise_model)
        params = program2.initial_params
        if bigstate.is_huge(2 * n):
            x, planar = group_forward_state_body(program2, params,
                                                 self._device)
            return SuperopDensityResult(n, x, planar)
        vec = group_forward_body(program2, params, self._device)
        return DensityMatrixResult(
            num_qubits=n, device_rho=vec.reshape(1 << n, 1 << n).to(dtype))

    def sample(self, result, shots: int,
               rng: np.random.Generator | None = None,
               readout_error=None) -> dict[str, int]:
        """Measurement counts from the exact diagonal (optionally pushed
        through a readout confusion transform)."""
        from .measurement import counts_from_array

        rng = rng or np.random.default_rng()
        probs = result.probabilities
        probs = np.maximum(probs, 0.0)
        probs = probs / probs.sum()
        ro = readout_error
        if ro is None and self.noise_model is not None:
            ro = self.noise_model.readout_error
        if ro is not None:
            probs = np.asarray(
                ro.apply_to_distribution(probs, result.num_qubits))
        counts = rng.multinomial(shots, probs)
        return counts_from_array(counts, result.num_qubits)
