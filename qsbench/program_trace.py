"""Device operations of a traced window matched to the calls that launched
them.

The port records its own spans (``quantum_simulator_tpu_torch.utils.
profiling.recording()``), and each of them is a ``torch.profiler.
record_function`` range, so it reaches the exported trace as a
``user_annotation`` on the trace's own clock. ``LaunchedTrace`` keeps what
``DeviceTrace`` keeps and, besides, when each device operation was
launched: the host time of the CUDA runtime call that carries the
operation's ``correlation`` id. The device operations of a span are then
those launched while it was open, whenever they ran: a span need not
synchronize for its device time to be read.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from .devtrace import DEVICE_CATEGORIES, DeviceTrace

# Host-side events of the calls that launch device work.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Launched(NamedTuple):
    name: str
    start: float      # microseconds, the trace's clock
    end: float
    launch: float     # host time of the call that launched it


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


class LaunchedTrace(DeviceTrace):
    def __init__(self, device, annotations, launched=(), unlaunched=0):
        super().__init__(device, annotations)
        self.launched = sorted(launched, key=lambda op: op.start)
        self.unlaunched = unlaunched    # device operations with no launch

    @classmethod
    def from_chrome(cls, data) -> "LaunchedTrace":
        base = DeviceTrace.from_chrome(data)
        events = data["traceEvents"] if isinstance(data, dict) else data
        launch_at: dict = {}
        ops = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            corr = (e.get("args") or {}).get("correlation")
            if corr is None:
                continue
            cat = str(e.get("cat", "")).lower()
            if cat in LAUNCH_CATEGORIES:
                launch_at.setdefault(corr, float(e["ts"]))
            elif cat in DEVICE_CATEGORIES:
                ops.append((str(e.get("name", "")), float(e["ts"]),
                            float(e["ts"]) + float(e["dur"]), corr))
        launched = [Launched(n, a, b, launch_at[c]) for n, a, b, c in ops
                    if c in launch_at]
        return cls(base.device, base.annotations, launched,
                   len(ops) - len(launched))

    def ranges(self, names) -> list[tuple[float, float]]:
        """The trace's ranges of the spans named ``names``."""
        return [(a.start, a.end) for a in self.annotations
                if a.name in names]

    def launched_in(self, ranges) -> list[Launched]:
        """The device operations launched inside any of ``ranges``."""
        spans = union(ranges)
        starts = [a for a, _ in spans]
        out = []
        for op in self.launched:
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                out.append(op)
        return out
