"""Deterministic seed management: NumPy generator -> ``torch.Generator``.

Counterpart of ``quantum_simulator_tpu/utils/seeding.py``. ``SeedManager``
forks child seeds, NumPy generators and ``torch.Generator`` objects from
one master NumPy stream, so host and device randomness share one
reproducible seed hierarchy: every child is one ``rng.integers(0, 2**63)``
draw, the same draw the JAX package takes, so the child seeds and NumPy
streams equal the JAX package's for the same master seed. Where the JAX
package forks a PRNG key from a draw (``key_from_seed``), the port seeds a
``torch.Generator`` on the state's device from it; the two frameworks'
generators give different numbers from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CONFIG


def generator_from_rng(rng: np.random.Generator, device) -> torch.Generator:
    """Generator on ``device`` seeded from one ``rng.integers(0, 2**63)``
    draw (all 63 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63)))
    return gen


class SeedManager:
    """Single point of control for all randomness in a run.

    A fixed master seed makes the n-th child RNG (or generator) fully
    deterministic; ``reset()`` replays the child stream from the start.
    """

    def __init__(self, seed: int | None = None):
        self._master_seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def seed(self) -> int | None:
        return self._master_seed

    def set_seed(self, seed: int | None) -> None:
        self._master_seed = seed
        self._rng = np.random.default_rng(seed)

    def create_child_rng(self) -> np.random.Generator:
        """Fork an independent NumPy child generator."""
        child_seed = self._rng.integers(0, 2**63)
        return np.random.default_rng(child_seed)

    def create_child_seed(self) -> int:
        """Fork a raw child seed (advances the master stream)."""
        return int(self._rng.integers(0, 2**63))

    def create_child_generator(self, device=None) -> torch.Generator:
        """Fork a ``torch.Generator`` on ``device`` (default
        ``CONFIG.device``) from the same master stream."""
        return generator_from_rng(self._rng, device or CONFIG.device)

    def reset(self) -> None:
        """Rewind so the next child equals the first child ever created."""
        self._rng = np.random.default_rng(self._master_seed)
