"""Spans and launch records around calls into the program, for traced runs.

A span target is ``"module:attr"`` or ``"module:Class.attr"`` of the
program. ``Instruments.install`` replaces the function in every loaded
module of the program that binds it, so names taken by ``from ... import``
are wrapped too, and puts every original back on ``remove``. A ``device``
span synchronizes the device before it starts and before it ends, so its
time is its own work; a ``host`` span does not. Each span is also a
``torch.profiler.record_function`` range, which labels the device trace.

Launch records come from ``cuda_exec._launch``, the one call through which
every fiber-kernel launch of the program passes: its state, operator, depth
and precision give each launch's least time (``roofline.py``).
"""

from __future__ import annotations

import functools
import importlib
import sys
import time
from typing import Callable, NamedTuple

import torch

from .roofline import Launch

PROGRAM = "quantum_simulator_tpu_torch"
LAUNCH_TARGET = f"{PROGRAM}.ops.cuda_exec:_launch"


class Span(NamedTuple):
    name: str
    start: float       # host clock, seconds
    end: float
    request: int       # index of the request it ran in, -1 outside


def _resolve(target: str):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def _bindings(owner, attr: str):
    """Every (namespace, name) in the program's loaded modules that holds
    the same function as ``owner.attr``; for a class attribute, the class
    alone."""
    if isinstance(owner, type):
        return [(owner, attr)]
    fn = getattr(owner, attr)
    out = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PROGRAM
                               or name.startswith(PROGRAM + ".")):
            continue
        for key, val in list(vars(mod).items()):
            if val is fn:
                out.append((mod, key))
    return out


class Instruments:
    """Spans and launch records of one traced window."""

    def __init__(self, device):
        self.spans: list[Span] = []
        self.launches: list[Launch] = []
        self.request = -1
        cuda = torch.device(device).type == "cuda"
        self._sync: Callable[[], None] = (torch.cuda.synchronize if cuda
                                          else (lambda: None))
        self._restore: list[tuple] = []

    def _span_wrapper(self, fn, name: str, sync: bool):
        spans, sync_fn = self.spans, self._sync

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if sync:
                sync_fn()
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    sync_fn()
                t1 = time.perf_counter()
            spans.append(Span(name, t0, t1, self.request))
            return out
        return wrapper

    def _launch_wrapper(self, fn):
        launches = self.launches

        @functools.wraps(fn)
        def wrapper(fn_name, x, op, K, real, view, batched):
            shared = batched and op.stride(0) == 0
            launches.append(Launch(
                fn_name.removeprefix("qs_"), x.numel(),
                (op[0] if shared else op).numel(), int(K), not real,
                "float64" if x.dtype == torch.float64 else "float32"))
            return fn(fn_name, x, op, K, real, view, batched)
        return wrapper

    def install(self, spans: dict[str, bool], launches: bool) -> None:
        """``spans``: target -> whether it synchronizes (a device span)."""
        for target, sync in spans.items():
            owner, attr = _resolve(target)
            raw = vars(owner).get(attr) if isinstance(owner, type) \
                else getattr(owner, attr)
            if isinstance(raw, staticmethod):
                wrapped = staticmethod(self._span_wrapper(
                    raw.__func__, attr, sync))
            else:
                wrapped = self._span_wrapper(raw, attr, sync)
            self._patch(owner, attr, raw, wrapped)
        if launches:
            owner, attr = _resolve(LAUNCH_TARGET)
            raw = getattr(owner, attr)
            self._patch(owner, attr, raw, self._launch_wrapper(raw))

    def _patch(self, owner, attr, raw, wrapped) -> None:
        for ns, key in _bindings(owner, attr):
            self._restore.append((ns, key, raw, wrapped))
            setattr(ns, key, wrapped)

    def remove(self) -> None:
        """Put every original back; counters the program keeps on its
        functions (``dense_axis.launches``) carry over from the wrapper."""
        for ns, key, raw, wrapped in reversed(self._restore):
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            w = wrapped.__func__ if isinstance(wrapped, staticmethod) \
                else wrapped
            for k, v in vars(w).items():
                if k != "__wrapped__" and k in vars(fn):
                    setattr(fn, k, v)
            setattr(ns, key, raw)
        self._restore.clear()
