"""The share of the traced window in which no operation ran on the card,
percent: 1 - (the union of the device operations' intervals) / window."""

from qsbench.reduce import idle_percent


def read(ctx):
    return idle_percent(ctx)
