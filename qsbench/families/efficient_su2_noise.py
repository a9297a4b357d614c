"""EfficientSU2 under a device noise model: ``efficient_su2``'s circuit dict
with the configuration's ``noise`` beside its gates, NumPy only.

The noise is the configuration's, the same for every request: a list of
channels, each ``{"channel": name, "gates": [gate names], ...}`` with the
channel's parameters under the port's argument names. An entry that
serves such a dict builds its noise model from ``noise`` and hands the
rest to ``QuantumCircuit.from_dict``; the reference reads ``noise`` to
place the same sites.
"""

from __future__ import annotations

import copy

import numpy as np

from qsbench.families import efficient_su2 as _base


def circuit(config: dict, rng: np.random.Generator) -> dict:
    """The ansatz with fresh angles from ``rng`` and the noise model."""
    out = _base.circuit(config, rng)
    out["noise"] = copy.deepcopy(config["noise"])
    return out
