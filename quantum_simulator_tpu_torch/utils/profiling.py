"""Profiling and tracing utilities.

Counterpart of ``quantum_simulator_tpu/utils/profiling.py``, with the
port's own recorder:

* ``recording()``: context manager that turns the recorder on and yields
  a ``Recording``, which keeps in memory, until it closes, the program's
  spans (``span(name)`` at its layer boundaries: the entry points, host
  preparation, the trajectory engine, each executor step, the
  reductions), one record per kernel launch (``launch``, from
  ``ops/cuda_exec._launch``) and its gauges (``gauge(name, value)``).
  Nothing is written to disk. Off, the default, a span is one check of a
  module-level variable: no record, no clock read, no profiler range.
  On, each span is also a ``torch.profiler.record_function`` range, so it
  lands in a profiler's trace as a ``user_annotation`` on the trace's own
  clock; no span synchronizes the device, so a span's device time is read
  from the trace afterwards, by the device operations launched inside
  it. Spans are kept for one thread of the host;
* ``trace(logdir)``: context manager around ``torch.profiler`` (CPU and,
  with a card, CUDA activities) that also opens ``recording()``; writes a
  Chrome / Perfetto trace of every launch, carrying the program's spans
  as ranges, into ``logdir`` and yields the profiler, whose
  ``key_averages()`` gives the device time by kernel name;
* ``time_compiled(fn, *args)``: device-synchronized time of a callable
  with one warm-up call excluded, on CUDA events when the result lies on
  the card and on the host clock otherwise. PyTorch runs eagerly and
  elides no repeated launch, so the repeats need no chain of outputs into
  inputs (the JAX package's ``lax.scan`` chain); ``chain`` is still
  honoured for callables that consume their input.

An operator records a run with either::

    with profiling.trace("qsim-trace"):     # trace.json with the spans
        Simulator(device="cuda").run(circuit)

    with profiling.recording() as rec:      # spans in memory only
        Simulator(device="cuda").run(circuit)
    for s in rec.spans:
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms")
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


class Span(NamedTuple):
    """One entry into a span, on the host's ``time.perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    parent: int     # index in ``Recording.spans`` of the enclosing span
    request: int    # shared by every span under one root span


class Launch(NamedTuple):
    """One kernel launch: ``state_elems`` real elements of the state
    (planes and batch included), ``op_elems`` distinct real elements of
    the operator (one block when it is shared with stride 0), the depth
    ``K``, whether the operator is complex, the precision, and the
    innermost span open at the launch (-1 outside any)."""

    kernel: str
    state_elems: int
    op_elems: int
    K: int
    complex_op: bool
    precision: str
    span: int


class Gauge(NamedTuple):
    name: str
    value: float


class Recording:
    """Spans (in the order they were entered), launches and gauges of
    one ``recording()``."""

    def __init__(self):
        self.spans: list[Span] = []
        self.launches: list[Launch] = []
        self.gauges: list[Gauge] = []
        self._open: list[int] = []
        self._requests = 0

    def _innermost(self) -> int:
        return self._open[-1] if self._open else -1

    def _enter(self, name: str, start_ns: int) -> int:
        parent = self._innermost()
        if parent < 0:
            request = self._requests
            self._requests += 1
        else:
            request = self.spans[parent].request
        index = len(self.spans)
        self.spans.append(Span(name, start_ns, start_ns, parent, request))
        self._open.append(index)
        return index

    def _exit(self, index: int, end_ns: int) -> None:
        self._open.remove(index)
        self.spans[index] = self.spans[index]._replace(end_ns=end_ns)

    def self_ns(self) -> list[int]:
        """Each span's self time: its duration less its child spans'
        (which, on one thread, never overlap)."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end_ns - s.start_ns
        return out


# The open Recording; None (the default) turns every span off.
_recording: Recording | None = None


class _Off:
    """The span of a run that is not recorded: enters and leaves as is."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("_name", "_rec", "_range", "_index")

    def __init__(self, name: str, rec: Recording):
        self._name = name
        self._rec = rec

    def __enter__(self):
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._index = self._rec._enter(self._name, time.perf_counter_ns())
        return None

    def __exit__(self, *exc):
        self._rec._exit(self._index, time.perf_counter_ns())
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """``with span("plan.execute"): ...``: one span per entry while a
    ``recording()`` is open; otherwise nothing at all."""
    if _recording is None:
        return _OFF
    return _On(name, _recording)


def gauge(name: str, value: float) -> None:
    """Record a value while a ``recording()`` is open."""
    if _recording is None:
        return
    _recording.gauges.append(Gauge(name, float(value)))


def launch(kernel: str, x: torch.Tensor, op: torch.Tensor, K: int,
           complex_op: bool, batched: bool) -> None:
    """Record a kernel launch over the state ``x`` with the operator
    ``op`` (a batch of operators, or one repeated with stride 0, when
    ``batched``) while a ``recording()`` is open."""
    if _recording is None:
        return
    shared = batched and op.stride(0) == 0
    _recording.launches.append(Launch(
        kernel, x.numel(), (op[0] if shared else op).numel(), int(K),
        complex_op, "float64" if x.dtype == torch.float64 else "float32",
        _recording._innermost()))


@contextlib.contextmanager
def recording():
    """Turn the recorder on and yield its ``Recording``; inside an open
    one, yield that."""
    global _recording
    if _recording is not None:
        yield _recording
        return
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None


@contextlib.contextmanager
def trace(logdir: str = "qsim-trace"):
    """Capture a trace viewable in Perfetto / chrome://tracing, with the
    program's spans as ranges: yields the ``torch.profiler.profile``
    object and writes ``<logdir>/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording(), \
            torch.profiler.profile(activities=activities) as profiler:
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
