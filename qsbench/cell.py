"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names every configuration, cell
and metric. Everything else is a file of its own under the benchmark's
folder (the first of the manifest's ``paths``), found by name:

* ``configs/<config>.json``: the configuration (the manifest's ``file``);
* ``families/<family>.py``: the circuit builder a configuration names;
* ``traffic/<traffic>.json``: a traffic mix, which names its entry;
* ``entries/<entry>.py``: how a request is served and its answers checked;
* ``limits/<cell>.json``: the limit of each number a cell's check compares;
* ``metrics/<metric>.py``: the reader of one metric; a metric split by
  cell, ``<quantity>.<suffix>``, without a file of its own is read by
  ``metrics/<quantity>.py``.

A new configuration, mix, cell or metric is new files and a manifest
entry; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.data["paths"][0]
        self._modules: dict[Path, ModuleType] = {}

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file, as it is run."""
        return json.loads((self.root / self._named("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: each metric without a ``workloads`` list or with the cell in
        it."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if "workloads" not in m or workload in m["workloads"]]

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` loaded by path (names may hold dots); for a
        metric, ``<quantity>.py`` where ``<quantity>.<suffix>.py`` is
        missing."""
        path = self.bench / kind / f"{name}.py"
        if kind == "metrics" and not path.is_file() and "." in name:
            path = self.bench / kind / f"{name.rpartition('.')[0]}.py"
        mod = self._modules.get(path)
        if mod is None:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} file {path}")
            spec = importlib.util.spec_from_file_location(
                f"qsbench_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod
