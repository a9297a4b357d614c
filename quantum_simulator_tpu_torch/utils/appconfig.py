"""Persistent application configuration.

Counterpart of ``quantum_simulator_tpu/utils/appconfig.py``: the same
field names, defaults and ``~/.quantum_sim/config.json`` location, a
10-entry recent-file ring and a tolerant load of missing or corrupt
files, so a config written by either package round-trips unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from pathlib import Path

_RECENT_LIMIT = 10


@dataclass
class AppConfig:
    """Persistent app settings."""

    theme: str = "dark"
    default_qubits: int = 4
    default_shots: int = 1024
    step_delay_ms: int = 500
    max_qubits: int = 16
    window_width: int = 1400
    window_height: int = 900
    recent_files: list[str] = field(default_factory=list)
    last_directory: str = ""

    _config_dir: Path = field(
        default_factory=lambda: Path.home() / ".quantum_sim", repr=False)

    @classmethod
    def _persisted_fields(cls) -> list[str]:
        return [f.name for f in fields(cls) if not f.name.startswith("_")]

    @property
    def config_path(self) -> Path:
        return self._config_dir / "config.json"

    def to_dict(self) -> dict:
        data = {name: getattr(self, name)
                for name in self._persisted_fields()}
        data["recent_files"] = list(data["recent_files"])[-_RECENT_LIMIT:]
        return data

    def save(self) -> None:
        self._config_dir.mkdir(parents=True, exist_ok=True)
        self.config_path.write_text(
            json.dumps(self.to_dict(), indent=2), encoding="utf-8")

    @classmethod
    def load(cls) -> "AppConfig":
        config = cls()
        try:
            raw = config.config_path.read_text(encoding="utf-8")
        except OSError:
            return config
        try:
            data = json.loads(raw)
        except json.JSONDecodeError:
            return config
        known = set(cls._persisted_fields())
        for key in known & set(data):
            setattr(config, key, data[key])
        return config

    def add_recent_file(self, filepath: str) -> None:
        ring = [p for p in self.recent_files if p != filepath]
        ring.insert(0, filepath)
        del ring[_RECENT_LIMIT:]
        self.recent_files = ring
