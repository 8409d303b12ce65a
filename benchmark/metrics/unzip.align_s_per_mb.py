"""Seconds a Mb of draft in 3-unzip's 1-align (its align_compute rows)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "unzip", "align_compute")
