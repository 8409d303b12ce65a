"""Bytes the ranks received through the port's collectives a Mb of
genome, padding included, every rank summed (the ``bytes_in`` of the leaf
``dist.*`` spans, the only ones that carry it)."""
from benchmark.collectives import totals


def read(ctx):
    t = totals(ctx)
    return t["bytes_in"] / t["mb"] if t else None
