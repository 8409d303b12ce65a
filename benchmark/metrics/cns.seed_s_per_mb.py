"""Seconds a Mb of seed reads in FalconSense's seeding: the k-mer index
of the template, the reads' seeds and their clipped DP windows (cns.seed
spans)."""
from benchmark.spans import trace_s_per_mb


def read(ctx):
    return trace_s_per_mb(ctx, "cns.seed", "falconsense")
