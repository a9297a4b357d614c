"""Profiling and tracing utilities.

Counterpart of ``quantum_simulator_tpu/utils/profiling.py``:

* ``trace(logdir)``: context manager around ``torch.profiler`` (CPU and,
  with a card, CUDA activities); writes a Chrome / Perfetto trace of every
  launch into ``logdir`` and yields the profiler, whose ``key_averages()``
  gives the device time by kernel name;
* ``time_compiled(fn, *args)``: device-synchronized time of a callable
  with one warm-up call excluded, on CUDA events when the result lies on
  the card and on the host clock otherwise. PyTorch runs eagerly and
  elides no repeated launch, so the repeats need no chain of outputs into
  inputs (the JAX package's ``lax.scan`` chain); ``chain`` is still
  honoured for callables that consume their input;
* ``hbm_traffic_estimate`` / ``roofline_fraction``: bytes a circuit's
  forward pass must move at least, against the memory rate of
  ``ROOFLINE_DEVICE``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable

import torch

#: The card the default roofline rate below belongs to (NVIDIA's data
#: sheet, SXM part, at the full 700 W power limit).
ROOFLINE_DEVICE = "NVIDIA H100 80GB HBM3"
#: HBM3 bytes per second of ``ROOFLINE_DEVICE``.
HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(logdir: str = "qsim-trace"):
    """Capture a trace viewable in Perfetto / chrome://tracing: yields
    the ``torch.profiler.profile`` object and writes
    ``<logdir>/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        yield profiler
    profiler.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class TimingResult:
    mean_s: float
    best_s: float
    repeats: int

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1000


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def time_compiled(fn, *args, repeats: int = 10,
                  chain: "Callable | None" = None) -> TimingResult:
    """Time a callable, its first (warm-up) call excluded.

    When the result lies on the card each repeat is bracketed by CUDA
    events and read after one synchronize; otherwise the host clock is
    used. ``chain(out, args) -> args`` feeds a repeat's output into the
    next call, for callables that overwrite their input."""
    out = fn(*args)
    cuda = _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if chain is not None:
            args = tuple(chain(out, args))
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1000.0)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            times.append(time.perf_counter() - t0)
    return TimingResult(mean_s=sum(times) / len(times), best_s=min(times),
                        repeats=repeats)


def hbm_traffic_estimate(num_qubits: int, num_passes: int,
                         bytes_per_amp: int = 8) -> int:
    """Minimum HBM bytes for ``num_passes`` full-state read+write sweeps."""
    return num_passes * 2 * (2**num_qubits) * bytes_per_amp


def roofline_fraction(num_qubits: int, num_passes: int, measured_s: float,
                      hbm_bytes_per_s: float = HBM_BYTES_PER_S,
                      bytes_per_amp: int = 8) -> float:
    """Fraction of the HBM-bandwidth roofline achieved (1.0 = at the
    floor; above 1 the state stayed in cache). The default rate is
    ``ROOFLINE_DEVICE``'s; a card set below its full power limit runs
    slower. ``bytes_per_amp`` is 8 for planar complex64 evolution, 4 when
    the executor's all-real path carries a single f32 plane
    (``GroupPlan.all_real``)."""
    floor_s = hbm_traffic_estimate(num_qubits, num_passes,
                                   bytes_per_amp) / hbm_bytes_per_s
    return floor_s / measured_s if measured_s > 0 else float("inf")
