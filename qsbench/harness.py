"""One run of one cell: set-up, the measured window, the readers, the check.

The window is a closed loop with one client: the next request goes out
when the last one's counts are on the host. It opens once set-up (the
port's import, the kernel library's load or first build, one warm request
of the cell's own shapes) is done, and closes at the end of the first
request that ends ``seconds`` or more after it opened, so every request
in it is whole. Each request is a fresh circuit dict from the cell's
family, drawn from the seed, with a program seed drawn beside it; the
program gets only those.

A traced run (``trace=True``) wraps the window in ``torch.profiler`` and
the program's layers in the spans its per-layer readers ask for
(``instrument.py``); an untraced run has neither, and reports the cell's
end-to-end metrics.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .cell import Manifest
from .check import judge
from .devtrace import DeviceTrace
from .instrument import Instruments

# Top-level modules that no run may load: JAX and the JAX package. Whole
# names are compared: the port's own name begins with the JAX package's.
BANNED_MODULES = ("jax", "jaxlib", "flax", "quantum_simulator_tpu")


def banned_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED_MODULES))


class Request(NamedTuple):
    latency_s: float
    trajectories: int


class Context:
    """What a metric reader reads (``metrics/<name>.py``: ``read(ctx)``)."""

    def __init__(self, setup_s, window_s, requests, spans=(), launches=(),
                 trace: DeviceTrace | None = None):
        self.setup_s = setup_s
        self.window_s = window_s
        self.requests: list[Request] = list(requests)
        self.spans = list(spans)
        self.launches = list(launches)
        self.trace = trace
        self._timed = None

    def spans_named(self, name: str):
        return [s for s in self.spans if s.name == name]

    def kernel_times(self):
        """Each fiber-kernel launch with its device time (trace order)."""
        if self._timed is None:
            self._timed = self.trace.fiber_kernel_times(self.launches)
        return self._timed


class MissingMetric(RuntimeError):
    pass


def _streams(seed: int):
    """Independent NumPy streams of one seed: requests, warm-up, the
    choice of answers to check, the check's own draws."""
    base = int(seed) % 2**64
    return [np.random.default_rng([base, k]) for k in range(4)]


def checked_indices(spec: dict, pick_rng) -> set[int]:
    """The requests whose answers the check keeps: ``spec["requests"]``
    of the first ``spec["among_first"]``, drawn from the seed. With
    ``spec["closing"]`` the check keeps, besides, the request that closes
    the window, whose answer is still live when the window ends, so that
    keeping it adds nothing to the run's peak."""
    if "requests" not in spec:
        return set()
    return {int(i) for i in pick_rng.choice(
        spec["among_first"], size=spec["requests"], replace=False)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(manifest: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    w = manifest.workload(workload)
    cfg = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    limits = manifest.limits(workload)
    family = manifest.module("families", cfg["family"])
    entry = manifest.module("entries", traffic["entry"])
    metrics = manifest.metrics(workload, trace)
    readers = {m["name"]: manifest.module("metrics", m["name"])
               for m in metrics}
    req_rng, warm_rng, pick_rng, check_rng = _streams(seed)

    import quantum_simulator_tpu_torch as port

    serve = entry.serve_fn(port, traffic, device)
    warm = serve(family.circuit(cfg, warm_rng),
                 int(warm_rng.integers(2**31)))
    del warm
    _sync(device)
    setup_s = time.monotonic() - t_start

    spec = traffic["check"]
    chosen = checked_indices(spec, pick_rng)
    closing = bool(spec.get("closing", False))
    inst = prof = None
    if trace:
        inst = Instruments(device)
        spans: dict[str, bool] = {}
        for r in readers.values():
            for target, kind in getattr(r, "SPANS", {}).items():
                spans[target] = spans.get(target, False) or kind == "device"
        inst.install(spans, any(getattr(r, "LAUNCHES", False)
                                for r in readers.values()))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    kept: list[tuple[dict, dict]] = []
    records: list[Request] = []
    failed = 0
    work = entry.trajectories(traffic)
    _sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        i = len(records)
        circuit = family.circuit(cfg, req_rng)
        program_seed = int(req_rng.integers(2**31))
        if inst is not None:
            inst.request = i
        label = (torch.profiler.record_function("qsbench.request") if trace
                 else contextlib.nullcontext())
        ts = time.perf_counter()
        try:
            with label:
                result = serve(circuit, program_seed, keep=i in chosen)
        except Exception as exc:   # an answer that never comes
            result = None
            failed += 1
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
        te = time.perf_counter()
        records.append(Request(te - ts, work if result is not None else 0))
        if result is not None and (i in chosen
                                   or (closing and te >= deadline)):
            kept.append((circuit, entry.answer(result)))
        del result
        if te >= deadline:
            break
    _sync(device)
    window_s = time.perf_counter() - t0

    dtrace = None
    if trace:
        prof.__exit__(None, None, None)
        inst.remove()
        dtrace = DeviceTrace.from_profiler(prof)
        del prof
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ctx = Context(setup_s, window_s, records,
                  inst.spans if inst else (), inst.launches if inst else (),
                  dtrace)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is None:
            if "workloads" in m:
                raise MissingMetric(
                    f"metric {m['name']} found nothing to read in "
                    f"{workload}: a span or a kernel it reads never ran")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    lat = sorted(1e3 * r.latency_s for r in records)
    print(f"window {window_s:.3f} s, {len(records)} requests; ms per "
          f"request min {lat[0]:.2f} median {lat[len(lat) // 2]:.2f} max "
          f"{lat[-1]:.2f}; first five "
          f"{[round(1e3 * r.latency_s, 2) for r in records[:5]]}",
          file=sys.stderr)
    n_checked = len(kept)
    t_check = time.monotonic()
    numbers = entry.check_answers(kept, traffic, device,
                                  seed=int(check_rng.integers(2**63)))
    print(f"check of {n_checked} answers {time.monotonic() - t_check:.1f} s",
          file=sys.stderr)
    correct = failed == 0 and n_checked > 0 and judge(numbers, limits)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": int(w["chips"]),
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": failed, "metrics": values, "device": device_info}
    if trace:
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(),
                            "idle_gaps": dtrace.idle_by_label()}
    out["answers_checked"] = n_checked
    out["checks"] = {k: {"value": _finite(numbers.get(k)), "limit": lim}
                     for k, lim in limits.items()}
    return out


def _finite(v):
    return v if v is not None and math.isfinite(v) else None
