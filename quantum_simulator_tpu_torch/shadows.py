"""Classical shadows: randomized-measurement estimation of many
observables (Huang-Kueng-Preskill random single-qubit Pauli protocol).

Counterpart of ``quantum_simulator_tpu/shadows.py``. Each
snapshot draws a uniform basis in {X, Y, Z} per qubit, rotates by the
single-qubit Clifford that maps that basis to Z (X -> H, Y -> H S^dag, the
rotations of ``MeasurementEngine`` basis sampling), and records one joint
bit sample. The inverse of the single-qubit shadow channel gives the
unbiased estimator for a k-local Pauli string P:

    est(P) = 3^k * prod_q sign(outcome_q)   when every basis matches P,
             0                              otherwise,

with variance <= 9^k, so one pool of snapshots estimates many low-weight
observables. Estimation is NumPy over the (S, n) snapshot table
(``ShadowData``, the JAX package's code).

The statevector collector runs the basis layer of ``chunk`` snapshots as
one batched program: a one-column circuit of n one-qubit ops whose
matrices are per-row operand overrides (``plan.OperandOverrides``), so
the layer is one ``dense_axis`` launch per group axis with one operator
per row, on ``chunk`` real copies of the state (the kernels write in
place). Each row then draws one basis index (``plan.categorical``, qubit
0 = MSB). Peak memory: the state, the batch (``chunk x 2^n x 8`` bytes,
4 GiB at n = 20 with ``chunk = 512``) and 1 GiB of sampling temporaries.

The MPS collector evolves the circuit once (``mps.MPSSimulator``) and
folds each snapshot's per-site rotation into the right-canonical sampling
cascade (one-site unitaries commute with the canonical form), ``chunk``
snapshots per cascade: O(n chi^2) per snapshot, no 2^n anywhere, so
shadows run at 100+ qubits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .circuit import QuantumCircuit
from .config import CONFIG
from .state import StateVector

#: Basis codes in snapshot tables.
BASIS_X, BASIS_Y, BASIS_Z = 0, 1, 2
_LETTER_TO_CODE = {"X": BASIS_X, "Y": BASIS_Y, "Z": BASIS_Z}

_H = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
_SDG = np.array([[1, 0], [0, -1j]], np.complex64)
#: Rotation applied before a Z-readout, indexed by basis code.
_ROTATIONS = np.stack([_H, _H @ _SDG, np.eye(2, dtype=np.complex64)])

#: A batch of snapshots holds one 2^n state per row: statevector shadows
#: stop at this width.
MAX_STATEVECTOR_SHADOW_QUBITS = 20

# Probabilities a sampling step takes at once: its float64 copy and CDF
# are 1 GiB.
_SAMPLE_ELEMS = 1 << 26

# Classification dummy of the basis ops: complex (H S^dag is), not
# diagonal, so the plan is planar and each axis one dense step.
_DUMMY_C1 = np.array([[1.0, 1.0], [1.0j, -1.0j]]) / np.sqrt(2)


@dataclass
class ShadowData:
    """A pool of snapshots: ``bases[s, q]`` in {0=X, 1=Y, 2=Z} and
    ``outcomes[s, q]`` in {0, 1} (bit 0 = +1 eigenvalue)."""

    num_qubits: int
    bases: np.ndarray
    outcomes: np.ndarray

    @property
    def n_snapshots(self) -> int:
        return self.bases.shape[0]

    def _pauli_values(self, pauli_string: str, qubits) -> np.ndarray:
        pstr = str(pauli_string).upper()
        qubits = [int(q) for q in qubits]
        if len(pstr) != len(qubits):
            raise ValueError(f"{pstr!r} has {len(pstr)} Paulis for "
                             f"{len(qubits)} qubits")
        live = [(p, q) for p, q in zip(pstr, qubits) if p != "I"]
        if len({q for _, q in live}) != len(live):
            raise ValueError("duplicate qubits in Pauli string")
        if any(q < 0 or q >= self.num_qubits for _, q in live):
            raise ValueError("qubit index out of range")
        if not live:
            return np.ones(self.n_snapshots)
        try:
            codes = np.asarray([_LETTER_TO_CODE[p] for p, _ in live])
        except KeyError:
            raise ValueError(f"unsupported Pauli in {pstr!r}") from None
        qs = np.asarray([q for _, q in live])
        match = np.all(self.bases[:, qs] == codes[None, :], axis=1)
        signs = np.prod(1 - 2 * self.outcomes[:, qs].astype(np.int64),
                        axis=1)
        return np.where(match, float(3 ** len(live)) * signs, 0.0)

    def estimate_pauli(self, pauli_string: str, qubits,
                       median_of_means: int | None = None) -> float:
        """Estimate <P> from the pool.  ``median_of_means=K`` splits the
        snapshots into K chunks and returns the median of chunk means
        (the HKP concentration construction); default is the plain
        mean (minimum-variance, unbiased)."""
        vals = self._pauli_values(pauli_string, qubits)
        if median_of_means is None:
            return float(vals.mean())
        k = int(median_of_means)
        if k < 1 or k > vals.shape[0]:
            raise ValueError("median_of_means must be in 1..n_snapshots")
        usable = (vals.shape[0] // k) * k
        return float(np.median(vals[:usable].reshape(k, -1).mean(axis=1)))

    def estimate_hamiltonian(self, terms,
                             median_of_means: int | None = None) -> float:
        """sum_k c_k <P_k> for ``(coeff, pauli_string, qubits)`` terms
        (the shared Hamiltonian format)."""
        return float(sum(
            coeff * self.estimate_pauli(pstr, qubits, median_of_means)
            for coeff, pstr, qubits in terms))


# ---------------------------------------------------------------------------
# Statevector collector
# ---------------------------------------------------------------------------

def basis_program(n: int):
    """The basis layer as a program: one column of n one-qubit ops, each
    classified by a complex dummy and given its matrices per row."""
    from .ops import program as prog

    ops = tuple(prog.ProgramOp("__SHADOW_BASIS__", (q,), 0, 0, 0,
                               _DUMMY_C1, None, -1) for q in range(n))
    return prog.CircuitProgram(
        num_qubits=n, initial_index=0, ops=ops, num_columns=1,
        num_params=0, initial_params=np.zeros(0),
        compile_key=("shadow-basis", n))


def rotate_snapshots(psi: torch.Tensor, n: int, bases: np.ndarray,
                     plain: bool = False) -> torch.Tensor:
    """``(B, 2, *axis_sizes)`` float32 planar states: the ``(2^n,)``
    complex state ``psi`` rotated on every row b into the bases of
    ``bases[b]`` ((B, n) codes), through the group executor with one
    dense operator per row and axis (``plain``: the kernels' twins)."""
    from .ops import plan as gplan

    program = basis_program(n)
    plan = gplan.get_group_plan(program)
    B = bases.shape[0]
    device = psi.device
    rots = torch.from_numpy(_ROTATIONS).to(device)
    codes = torch.from_numpy(np.asarray(bases, dtype=np.int64)).to(device)
    overrides = gplan.OperandOverrides(pool_rows=rots[codes],
                                       pool_map={q: q for q in range(n)},
                                       per_op={})
    operands = gplan.build_group_operands_batched(
        program, plan, program.initial_params, B, device, overrides)
    base = torch.stack([psi.real, psi.imag]).reshape(
        (2,) + tuple(plan.layout.axis_sizes))
    x = base.expand((B,) + tuple(base.shape)).contiguous()
    return gplan.execute_group_plan(plan, operands, program,
                                    program.initial_params, x, True, plain,
                                    batched=True)


def sample_rotated(x: torch.Tensor, n: int,
                   generator: torch.Generator | None) -> np.ndarray:
    """One basis sample per row of a planar batch from ``rotate_snapshots``
    (which it overwrites with the probabilities): ``(B, n)`` int8 bits,
    qubit 0 the most significant."""
    from .ops.plan import categorical

    B = x.shape[0]
    probs = x[:, 0].reshape(B, -1)
    probs.mul_(probs).addcmul_(x[:, 1].reshape(B, -1),
                               x[:, 1].reshape(B, -1))
    rows = max(1, _SAMPLE_ELEMS // probs.shape[1])
    idx = torch.cat([categorical(probs[r:r + rows], generator)
                     for r in range(0, B, rows)])
    shifts = torch.arange(n - 1, -1, -1, device=idx.device)
    return ((idx[:, None] >> shifts) & 1).to(torch.int8).cpu().numpy()


def _mps_outcomes(circuit: QuantumCircuit, bases: np.ndarray,
                  rng: np.random.Generator, chi: int, chunk: int, device,
                  uniforms) -> np.ndarray:
    """The MPS collector: one evolution, then ``chunk`` snapshots per
    cascade, each site rotated into its snapshot's basis."""
    from .mps import MPSSimulator, sample_cascade
    from .utils.seeding import generator_from_rng

    state = MPSSimulator(chi, device=device)._final_state(circuit, chi)
    gen = generator_from_rng(rng, device)
    t0 = state.tensors[0]
    rots = torch.from_numpy(_ROTATIONS).to(t0.device, t0.dtype)
    codes = torch.from_numpy(bases.astype(np.int64)).to(t0.device)
    outs = []
    for lo in range(0, bases.shape[0], chunk):
        hi = min(lo + chunk, bases.shape[0])
        u = (torch.rand((hi - lo, bases.shape[1]), generator=gen,
                        device=t0.device) if uniforms is None
             else torch.as_tensor(uniforms[lo:hi], dtype=torch.float32,
                                  device=t0.device))
        outs.append(sample_cascade(state.tensors, u, rots[codes[lo:hi]])
                    .to(torch.int8).cpu().numpy())
    return np.concatenate(outs, axis=0)


def collect_shadows(circuit: QuantumCircuit | StateVector,
                    n_snapshots: int,
                    seed: int | None = None,
                    engine: str = "auto",
                    chi: int = 32,
                    chunk: int = 256,
                    device=None, uniforms=None) -> ShadowData:
    """Collect a classical-shadow pool from a circuit (or a prepared
    ``StateVector``, on its device; a circuit runs on ``device``, default
    ``CONFIG.device``).

    ``engine``: "statevector" (n <= 20), "mps" (any width the bond
    dimension ``chi`` supports), or "auto" (statevector when it fits).
    ``chunk`` bounds device memory: snapshots run ``chunk`` rows at a
    time. The bases are the JAX package's for the same seed; the outcomes
    are drawn from a ``torch.Generator`` seeded where it forks its key,
    or, on the MPS engine, from ``uniforms`` ((n_snapshots, n) float32,
    one per snapshot and site, as the JAX cascade draws them).
    """
    from .utils.seeding import generator_from_rng

    rng = np.random.default_rng(seed)
    if isinstance(circuit, StateVector):
        n = circuit.num_qubits
        if engine == "mps":
            raise ValueError("a prepared StateVector collects on the "
                             "statevector engine")
        engine = "statevector"
    else:
        n = circuit.num_qubits
        if engine == "auto":
            engine = ("statevector"
                      if n <= MAX_STATEVECTOR_SHADOW_QUBITS else "mps")
    if engine not in ("statevector", "mps"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "statevector" and n > MAX_STATEVECTOR_SHADOW_QUBITS:
        raise ValueError(
            f"statevector shadows cap at n={MAX_STATEVECTOR_SHADOW_QUBITS} "
            "(each chunk row holds a 2^n state); use engine='mps'")
    if n_snapshots < 1:
        raise ValueError("n_snapshots must be >= 1")

    bases = rng.integers(0, 3, size=(n_snapshots, n)).astype(np.int8)
    if engine == "mps":
        return ShadowData(num_qubits=n, bases=bases, outcomes=_mps_outcomes(
            circuit, bases, rng, chi, chunk, device or CONFIG.device,
            uniforms))
    if isinstance(circuit, StateVector):
        sv = circuit
    else:
        from .simulator import Simulator

        sv = Simulator(device=device or CONFIG.device).run(
            circuit, shots=0).final_state
    psi = sv.device_data.to(torch.complex64)
    gen = generator_from_rng(rng, psi.device)

    outs = []
    for lo in range(0, n_snapshots, chunk):
        x = rotate_snapshots(psi, n, bases[lo:lo + chunk])
        outs.append(sample_rotated(x, n, gen))
        del x
    return ShadowData(num_qubits=n, bases=bases,
                      outcomes=np.concatenate(outs, axis=0))
