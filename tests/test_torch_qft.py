"""The QFT configuration of the benchmark (``qsbench/configs/qft_30.json``)
on the CPU: the port's ``Simulator.run`` against the plain QFT reference
(``qsbench/reference/qft.py``), the reference against the DFT, and the
benchmark's circuit against the port's own QFT template.

Tolerances and why:

* the port's final state against the float64 reference: 1e-5 relative in
  the 2-norm, the executor tolerance (complex64 products and sums in
  another order, a few hundred gates: the error is about 1e-7 here);
* the reference's float64 basis-state transforms against ``numpy.fft``:
  1e-12 absolute (float64 rounding over at most a few dozen gates).
"""

import numpy as np
import pytest
import torch

import quantum_simulator_tpu_torch as tq
from qsbench.cell import Manifest
from qsbench.reference import qft as ref
from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
from quantum_simulator_tpu_torch.ops import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FAMILY = Manifest().module("families", "qft")


def config(n):
    return {"num_qubits": n, "approximation_degree": 0, "do_swaps": True}


@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunked(request, monkeypatch):
    """``chunked``: every state counts as big and a chunk is 512
    elements, so from three axes on (n = 16: 4 x 128 x 128) the
    pair-diagonal and swap steps run over several pieces, each copied
    back over its view, as at n >= 30."""
    if request.param:
        monkeypatch.setattr(tplan, "INPLACE_MIN_BYTES", 0)
        monkeypatch.setattr(tplan, "CHUNK_ELEMS", 512)
    return request.param


@pytest.mark.parametrize("n", [6, 9, 12, 16])
def test_port_matches_the_reference(n, chunked):
    d = FAMILY.circuit(config(n), np.random.default_rng(100 + n))
    res = tq.Simulator(device="cpu").run(tq.QuantumCircuit.from_dict(d),
                                         shots=0, seed=1)
    psi = res.final_state.device_data
    assert psi.dtype == torch.complex64
    r_re, r_im = ref.simulate(d, "cpu")
    want = torch.complex(r_re, r_im)
    gap = torch.linalg.vector_norm(psi.to(torch.complex128) - want)
    assert float(gap / torch.linalg.vector_norm(want)) < 1e-5


@pytest.mark.parametrize("n,x", [(1, 1), (3, 5), (4, 0), (5, 19), (6, 42),
                                 (6, 63)])
def test_reference_of_a_basis_state_is_its_dft(n, x):
    """``|x>`` prepared with ``Ry(π)`` on its set bits (qubit 0 the most
    significant), then the bare transform: ``N^-1/2 e^{2πi xk/N}``."""
    prep = [{"name": "Ry", "targets": [q], "params": [np.pi], "column": 0}
            for q in range(n) if (x >> (n - 1 - q)) & 1]
    gates = [{"name": name, "targets": list(t), "params": p,
              "column": 1 + c}
             for c, (name, t, p) in enumerate(FAMILY.transform(n))]
    re, im = ref.simulate({"num_qubits": n, "gates": prep + gates}, "cpu")
    e = np.zeros(1 << n)
    e[x] = 1.0
    want = np.fft.ifft(e) * np.sqrt(1 << n)
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), want,
                               atol=1e-12)


@pytest.mark.parametrize("n", [2, 5, 30])
def test_benchmark_circuit_is_the_template(n):
    d = FAMILY.circuit(config(n), np.random.default_rng(n))
    head, rest = d["gates"][:2 * n], d["gates"][2 * n:]
    assert [(g["name"], g["targets"], g["column"]) for g in head] == \
        [(name, [q], k) for k, name in enumerate(("Ry", "Rz"))
         for q in range(n)]
    tmpl = AlgorithmTemplate.quantum_fourier_transform(n)
    assert [(g["name"], g["targets"], g["params"], g["column"] - 2)
            for g in rest] == \
        [(g.gate_name, list(g.target_qubits), list(g.params), g.column)
         for g in tmpl.gates]
    assert len(rest) == n + n * (n - 1) // 2 + n // 2
