"""Seconds a Mb of draft in 4-polish's 1-track raw-read alignment (its
align_compute rows)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "quiver", "align_compute")
