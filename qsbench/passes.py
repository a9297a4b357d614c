"""The least time of one whole-state pass of the executor that no kernel
serves: a pair-diagonal step or a bit-pair step of ``ops.plan``.

Such a pass reads every element of the state once and writes it once, so
its least time is twice the state's bytes at the HBM bandwidth
(``roofline.HBM_BYTES_PER_S``); its few operations per element are far
below any compute peak. The state's bytes come from the configuration the
cell runs: ``2^num_qubits`` amplitudes in two planes of the precision's
real type (a complex configuration's state is planar).
"""

from __future__ import annotations

from pathlib import Path

from .cell import Manifest
from .roofline import HBM_BYTES_PER_S

ITEM_BYTES = {"complex64": 4}


def state_bytes(config: dict) -> int:
    return 2 * (1 << int(config["num_qubits"])) * ITEM_BYTES[
        config["precision"]]


def least_pass_s(config: dict) -> float:
    return 2 * state_bytes(config) / HBM_BYTES_PER_S


def listed_config(root: Path, metric: str) -> dict:
    """The configuration of the cells that the per-layer ``metric`` lists
    under ``workloads`` in the checkout at ``root``: one for all of them,
    so that one state size holds wherever the metric is read."""
    m = Manifest(root)
    entry = next(p for p in m.data["per_layer"] if p["name"] == metric)
    configs = {m.workload(w)["config"] for w in entry["workloads"]}
    sizes = {(m.config(c)["num_qubits"], m.config(c)["precision"])
             for c in configs}
    if len(sizes) != 1:
        raise ValueError(f"{metric} lists cells of {len(sizes)} state sizes")
    return m.config(configs.pop())


def pass_roofline(ctx, span: str, config: dict) -> float | None:
    """Percent: the least time of the passes timed by the device spans
    named ``span`` over their summed time; None when none ran."""
    spans = ctx.spans_named(span)
    if not spans:
        return None
    spent = sum(s.end - s.start for s in spans)
    return 100.0 * len(spans) * least_pass_s(config) / spent
