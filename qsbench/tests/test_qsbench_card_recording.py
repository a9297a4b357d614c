"""On the card: the program's own launch records equal the benchmark's
wrapper's (``instrument.py``) on a short window of the sweep cell, and
every device operation of the window is matched to its launch. Run with
``python -m pytest -p no:cacheprovider qsbench/tests -m gpu``."""

import pytest
import torch

from qsbench.cell import Manifest
from qsbench.devtrace import FIBER_KERNEL
from qsbench.instrument import Instruments
from qsbench.program_trace import LaunchedTrace
from qsbench.roofline import Launch

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def test_program_launch_records_equal_the_wrapper(card):
    import numpy as np

    import quantum_simulator_tpu_torch as port
    from quantum_simulator_tpu_torch.utils import profiling

    m = Manifest()
    w = m.workload("esu2_30.sweep")
    cfg = m.config(w["config"])
    traffic = m.traffic(w["traffic"])
    family = m.module("families", cfg["family"])
    serve = m.module("entries", traffic["entry"]).serve_fn(port, traffic,
                                                           card)
    rng = np.random.default_rng(2**31 + 41)
    serve(family.circuit(cfg, rng), 1)       # build and warm
    torch.cuda.synchronize()
    inst = Instruments(card)
    inst.install({}, True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with profiling.recording() as rec:
            with torch.profiler.profile(activities=acts) as prof:
                for seed in (2, 3):
                    serve(family.circuit(cfg, rng), seed)
                torch.cuda.synchronize()
    finally:
        inst.remove()
    mine = [Launch(*ln[:6]) for ln in rec.launches]
    assert len(mine) >= 40 and mine == inst.launches
    steps = {i for i, s in enumerate(rec.spans)
             if s.name in ("step.dense", "step.cross")}
    assert all(ln.span in steps for ln in rec.launches)
    trace = LaunchedTrace.from_profiler(prof)
    assert trace.unlaunched == 0
    fiber = [op for op in trace.launched if FIBER_KERNEL.search(op.name)]
    inside = [op for op in trace.launched_in(trace.ranges(
        ("step.dense", "step.cross"))) if FIBER_KERNEL.search(op.name)]
    assert len(fiber) == len(inside) == len(mine)
    torch.cuda.empty_cache()
