"""Command-line twins of the repository's ``scripts/``: each module has
``main(argv=None) -> int`` and runs as
``python -m quantum_simulator_tpu_torch.scripts.<name>`` on the card by
default (``--device cpu`` for the host)."""
