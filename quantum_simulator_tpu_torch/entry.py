"""Forward step on the flagship model: the port's ``__graft_entry__.entry``.

    python -m quantum_simulator_tpu_torch.entry [--device cpu]

``entry()`` returns ``(fn, example_args)``: ``fn(params)`` is |psi|^2 of
the 16-qubit, 4-layer Ry + CNOT brickwork at the parameters ``params``,
computed through the group-plan forward (``ops/plan.group_forward_body``),
whose dense and cross steps launch the two CUDA kernels on the card;
``example_args`` holds the circuit's own parameters as a float32 tensor
on the entry's device. The multi-device dry run of the JAX entry is
``torch_dryrun_multichip.py``.
"""

from __future__ import annotations

import argparse

import torch

from .circuit import GateInstance, QuantumCircuit
from .ops import plan as gplan
from .ops import program as prog
from .utils.cli import add_device_argument, open_device


def flagship_circuit(n_qubits: int = 16, layers: int = 4) -> QuantumCircuit:
    """``__graft_entry__._flagship_circuit``: Ry layers at angles
    0.1 (q + layer + 1), each followed by a CNOT brick."""
    c = QuantumCircuit(n_qubits)
    col = 0
    for layer in range(layers):
        for q in range(n_qubits):
            c.add_gate(GateInstance("Ry", [q], [0.1 * (q + layer + 1)],
                                    column=col))
        col += 1
        for q in range(layer % 2, n_qubits - 1, 2):
            c.add_gate(GateInstance("CNOT", [q, q + 1], [], column=col))
        col += 1
    return c


def entry(device=None, plain: bool = False):
    """(fn, example_args) on ``device`` (default ``CONFIG.device``, the
    card, which must be present). ``plain`` runs the kernels' PyTorch
    twins instead (the reference the card is held against)."""
    dev = open_device(device, "entry")
    if dev is None:
        raise RuntimeError("entry(): no CUDA device; pass device='cpu'")
    program = prog.compile_circuit(flagship_circuit())

    def forward(params: torch.Tensor) -> torch.Tensor:
        values = params.detach().double().cpu().numpy()
        psi = gplan.group_forward_body(program, values, dev, plain)
        return psi.real.square() + psi.imag.square()

    example_args = (torch.as_tensor(program.initial_params,
                                    dtype=torch.float32, device=dev),)
    return forward, example_args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if open_device(args.device, "entry") is None:
        return 1
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry() OK:", tuple(out.shape), float(out.sum()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
