"""The quantum Fourier transform (Qiskit circuit library ``QFT`` with
``approximation_degree=0``, ``do_swaps=True``, ``inverse=False``;
Coppersmith, IBM RC19642 (1994); Nielsen & Chuang, Fig. 5.1) on a fresh
product state, as a circuit dict, NumPy only.

The input layer is ``Ry`` then ``Rz`` on every qubit, each angle uniform
on [0, 2π) from ``rng``, one column each: the transform of ``|0...0>``
is flat, so without it the counts would say nothing of the state. The
transform is gate for gate ``AlgorithmTemplate.quantum_fourier_transform``:
for each qubit i in turn, H(i), then ``CPhase(π / 2^(j - i))`` on (j, i)
for every j > i; then SWAP(i, n - 1 - i) for i < n / 2; every gate in a
column of its own. Qubit 0 is the most significant bit of the
simulator's basis index, where Qiskit's qubit 0 is the least: the
transform is the same DFT on the index read in this order.
"""

from __future__ import annotations

import math

import numpy as np


def transform(n: int) -> list[tuple[str, tuple[int, ...], list[float]]]:
    """(gate, targets, params) of the exact QFT with its swaps."""
    out = []
    for i in range(n):
        out.append(("H", (i,), []))
        for j in range(i + 1, n):
            out.append(("CPhase", (j, i), [math.pi / 2 ** (j - i)]))
    for i in range(n // 2):
        out.append(("SWAP", (i, n - 1 - i), []))
    return out


def circuit(config: dict, rng: np.random.Generator) -> dict:
    """The input layer with fresh angles from ``rng``, then the QFT."""
    n = int(config["num_qubits"])
    if config["approximation_degree"] != 0 or not config["do_swaps"]:
        raise ValueError("only the exact QFT with its swaps is built")
    angles = rng.uniform(0.0, 2.0 * np.pi, 2 * n)
    gates = [{"name": name, "targets": [q],
              "params": [float(angles[k * n + q])], "column": k}
             for k, name in enumerate(("Ry", "Rz")) for q in range(n)]
    gates += [{"name": name, "targets": list(t), "params": p,
               "column": 2 + c}
              for c, (name, t, p) in enumerate(transform(n))]
    return {"version": "1.0", "num_qubits": n, "gates": gates}
