"""Seconds a Mb of draft in 3-unzip's overlap compute itself, on whichever
thread ran it (overlap.compute spans; the prefetch runs it beside 1-align
and 2-phasing)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "unzip", "overlap.compute")
