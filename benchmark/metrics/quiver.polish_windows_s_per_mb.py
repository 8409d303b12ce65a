"""Seconds a Mb of draft in 4-polish's window consensus (polish_windows
rows)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "quiver", "polish_windows")
