"""The card's idle share of the traced window, every slot's device work
merged, %."""
from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
