"""On the card: a short run of a cell is correct, and the control (the
plain reference in TF32 in the program's place) is not, at the cells'
own sizes. Run with
``python -m pytest -p no:cacheprovider qsbench/tests -m gpu``."""

import pytest
import torch

from qsbench import control
from qsbench.cell import Manifest
from qsbench.check import judge
from qsbench.harness import run_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def test_edit_cell_runs_correct(card):
    out = run_cell(Manifest(), "esu2_16.edit", 2**31 + 99, 2.0, False,
                   card, 0.0)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["esu2_16.edit", "esu2_30.sweep",
                                  "esu2_16.noisy"])
def test_control_is_not_correct(card, cell):
    import quantum_simulator_tpu_torch as port

    m = Manifest()
    traffic, requests, seed = control.checked_requests(m, cell, 4242)
    entry = m.module("entries", traffic["entry"])
    answers = control.answers_of("control", port, entry, traffic, requests,
                                 card, seed + 1)
    numbers = entry.check_answers(answers, traffic, card, seed=seed)
    assert not judge(numbers, m.limits(cell)), numbers
    torch.cuda.empty_cache()
