"""Each rank's card idle over the traced window, the mean over the four
cards, %: each slot's trace merged alone."""
from benchmark.collectives import idle_pct_each


def read(ctx):
    return idle_pct_each(ctx)
