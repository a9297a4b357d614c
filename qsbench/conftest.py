"""Widths of the cut copies of the configurations added to the benchmark
after ``tests/conftest.py``'s ``TINY_WIDTHS``: its ``tiny`` fixture cuts
every configuration of ``BENCHMARK.json`` and needs a width for each."""

LATER_WIDTHS = {"qft_30": 12}


def pytest_plugin_registered(plugin):
    widths = getattr(plugin, "TINY_WIDTHS", None)
    if isinstance(widths, dict):
        for name, n in LATER_WIDTHS.items():
            widths.setdefault(name, n)
