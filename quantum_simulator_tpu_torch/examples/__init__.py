"""Twins of the repository's ``examples/``: each module has
``main(argv=None) -> int`` and runs as
``python -m quantum_simulator_tpu_torch.examples.<name>`` on the card by
default (``--device cpu`` for the host)."""
