"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

The profiler traces host and device (``ProfilerActivity.CPU``, ``CUDA``)
from the start of the window to its end; the trace is exported in Chrome's
format and read back here. Device operations are the events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host ranges named by
``instrument.py`` are ``user_annotation`` events on the same clock.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import NamedTuple

from .roofline import Launch, least_time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Device names of the program's fiber kernels (``csrc/``): one template
# serves dense_axis and cross_bit_axis alike, so launches are matched to
# these events by order, which one stream keeps.
FIBER_KERNEL = re.compile(r"(simt_kernel|mma_kernel|f64_fma_kernel|"
                          r"f64_mma_kernel)")


class Event(NamedTuple):
    name: str
    start: float      # microseconds, the trace's clock
    end: float


class DeviceTrace:
    def __init__(self, device: list[Event], annotations: list[Event]):
        self.device = sorted(device, key=lambda e: e.start)
        self.annotations = annotations

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls.from_chrome(data)

    @classmethod
    def from_chrome(cls, data) -> "DeviceTrace":
        events = data["traceEvents"] if isinstance(data, dict) else data
        device, notes = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            ev = Event(str(e.get("name", "")), float(e["ts"]),
                       float(e["ts"]) + float(e["dur"]))
            if cat in DEVICE_CATEGORIES:
                device.append(ev)
            elif cat == "user_annotation":
                notes.append(ev)
        return cls(device, notes)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[float]] = []
        for e in self.device:
            if out and e.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e.end)
            else:
                out.append([e.start, e.end])
        return [tuple(iv) for iv in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_ops(self, k: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e.name] += (e.end - e.start) / 1e6
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def _labels(self, times: list[float]) -> list[str]:
        """The innermost host range open at each of ``times`` (ascending):
        the open range that started last, or ``harness`` outside all."""
        notes = sorted(self.annotations, key=lambda a: a.start)
        heap: list[tuple[float, float, str]] = []
        out, i = [], 0
        for t in times:
            while i < len(notes) and notes[i].start <= t:
                heapq.heappush(heap, (-notes[i].start, notes[i].end,
                                      notes[i].name))
                i += 1
            while heap and heap[0][1] < t:
                heapq.heappop(heap)
            out.append(heap[0][2] if heap else "harness")
        return out

    def idle_by_label(self, k: int = 10) -> list[list]:
        """Idle time between device operations, summed by the host range
        open in the middle of each gap; the ``k`` largest."""
        busy = self.busy_intervals()
        gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
        total: dict[str, float] = defaultdict(float)
        for (a, b), name in zip(gaps, self._labels([(a + b) / 2
                                                    for a, b in gaps])):
            total[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def fiber_kernel_times(self, launches: list[Launch]
                           ) -> list[tuple[Launch, float]]:
        """Each recorded launch with its device time in seconds. Raises
        when the trace and the records disagree on the count."""
        events = [e for e in self.device if FIBER_KERNEL.search(e.name)]
        if len(events) != len(launches):
            raise RuntimeError(
                f"{len(launches)} fiber-kernel launches recorded but "
                f"{len(events)} fiber kernels in the device trace")
        return [(ln, (e.end - e.start) / 1e6)
                for ln, e in zip(launches, events)]


def roofline_share(timed: list[tuple[Launch, float]], kernel: str
                   ) -> float | None:
    """Percent: the launches' summed least time over their summed device
    time, for one kernel; None when it did not run."""
    mine = [(ln, t) for ln, t in timed if ln.kernel == kernel]
    if not mine:
        return None
    spent = sum(t for _, t in mine)
    return 100.0 * sum(least_time(ln)[0] for ln, _ in mine) / spent
