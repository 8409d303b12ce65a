"""Seconds the ranks spent in the port's collectives a Mb of genome, every
rank summed: the outermost ``dist.*`` spans (nested helpers count once)."""
from benchmark.collectives import totals


def read(ctx):
    t = totals(ctx)
    return t["s"] / t["mb"] if t else None
