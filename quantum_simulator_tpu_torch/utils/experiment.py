"""Full experiment snapshots for reproducibility.

Counterpart of ``quantum_simulator_tpu/utils/experiment.py``:
``ExperimentConfig`` (seed, circuit dict, noise dict, shots, ISO
timestamp, simulator_version, results, analysis, metadata), a NumPy- and
complex-safe JSON encoder, and the ``from_current`` factory that accepts
a ``SimulationResult``. The JSON is the JAX package's for the same
circuit, noise model and result.
"""

from __future__ import annotations

import datetime
import json
from dataclasses import asdict, dataclass, is_dataclass
from pathlib import Path

import numpy as np

from ..circuit import QuantumCircuit


@dataclass
class ExperimentConfig:
    """Snapshot of an experiment: everything needed to replay or review."""

    seed: int | None = None
    circuit: dict | None = None
    noise_model: dict | None = None
    num_shots: int = 1024
    timestamp: str = ""
    simulator_version: str = "1.0.0"
    results: dict | None = None
    analysis: dict | None = None
    metadata: dict | None = None

    @staticmethod
    def _json_default(obj):
        """Best-effort JSON conversion for NumPy / complex / dataclasses."""
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, complex):
            return {"re": float(obj.real), "im": float(obj.imag)}
        if hasattr(obj, "to_dict"):
            return obj.to_dict()
        if is_dataclass(obj):
            return asdict(obj)
        raise TypeError(
            f"Object of type {type(obj).__name__} is not JSON serializable")

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, default=self._json_default)

    def save(self, filepath: str | Path) -> None:
        path = Path(filepath)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json(), encoding="utf-8")

    @classmethod
    def from_json(cls, json_str: str) -> "ExperimentConfig":
        return cls(**json.loads(json_str))

    @classmethod
    def load(cls, filepath: str | Path) -> "ExperimentConfig":
        return cls.from_json(Path(filepath).read_text(encoding="utf-8"))

    @classmethod
    def from_current(cls, circuit: QuantumCircuit, noise_model=None,
                     seed: int | None = None, shots: int = 1024,
                     result=None) -> "ExperimentConfig":
        """Capture the full context right after a simulation run."""
        from ..simulator import SimulationResult

        result_payload = result
        if isinstance(result, SimulationResult):
            result_payload = {
                "measurement_counts": {
                    str(k): int(v)
                    for k, v in result.measurement_counts.items()
                },
                "num_shots": int(result.num_shots),
                "seed": result.seed,
            }

        return cls(
            seed=seed,
            circuit=circuit.to_dict(),
            noise_model=(noise_model.to_dict()
                         if noise_model is not None else None),
            num_shots=shots,
            timestamp=datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            results=result_payload,
        )
