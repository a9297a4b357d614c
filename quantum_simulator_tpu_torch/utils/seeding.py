"""Deterministic seeding: NumPy generator -> ``torch.Generator``.

Counterpart of ``key_from_seed`` in ``quantum_simulator_tpu/utils/
seeding.py``: where the JAX package forks a PRNG key from one
``rng.integers(0, 2**63)`` draw, the port seeds a ``torch.Generator`` on
the state's device from the same draw, so host and device randomness
share one reproducible seed stream. The two frameworks' generators give
different numbers from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch


def generator_from_rng(rng: np.random.Generator, device) -> torch.Generator:
    """Generator on ``device`` seeded from one ``rng.integers(0, 2**63)``
    draw (all 63 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63)))
    return gen
