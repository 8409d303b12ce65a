"""Seconds a Mb of draft in 3-unzip's overlap join (hasm_overlaps rows)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "unzip", "hasm_overlaps")
